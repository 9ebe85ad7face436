"""Device milliseconds of the casts an iteration of the traced pass: the
program's spans `cast.closest` and `cast.shadow` (each from a CUDA event
at its entry to one at its exit on the current stream, `prepare_cast`
included), summed, over the pass's `wavefront.iter` spans."""
from harness.program_spans import device_ms_per_iter


def read(run):
    return device_ms_per_iter(run, ("cast.closest", "cast.shadow"))
