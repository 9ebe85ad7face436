"""Device milliseconds of banking an iteration of the traced pass: the
program's `wavefront.bank` spans (the film's scatter-add, the claim's
prefix sum, fresh samples, the new lane state), summed, over the pass's
`wavefront.iter` spans."""
from harness.program_spans import device_ms_per_iter


def read(run):
    return device_ms_per_iter(run, ("wavefront.bank",))
