"""Share of its roofline of one shadow cast (`render/pt.py`
`scene_occluded`) of N_RAYS shadow rays to the emitters, made from the
seed: the reckoner's least time over the measured time, in %."""
from harness.casts import roofline_pct

N_RAYS = 49152


def read(run):
    return roofline_pct(run, "any", N_RAYS)
