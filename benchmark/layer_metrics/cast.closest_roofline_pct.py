"""Share of its roofline of one closest-hit cast (`render/pt.py`
`scene_intersect`, prepare_cast included) of N_RAYS bounce-like rays made
from the seed: the reckoner's least time over the measured time, in %."""
from harness.casts import roofline_pct

N_RAYS = 49152


def read(run):
    return roofline_pct(run, "closest", N_RAYS)
