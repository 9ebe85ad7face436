"""Device milliseconds of the ray sort an iteration of the traced pass: the
program's `wavefront.sort` spans (key, argsort, the lanes' gathers),
summed, over the pass's `wavefront.iter` spans."""
from harness.program_spans import device_ms_per_iter


def read(run):
    return device_ms_per_iter(run, ("wavefront.sort",))
