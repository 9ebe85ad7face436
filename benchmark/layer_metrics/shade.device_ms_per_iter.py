"""Device milliseconds of the shading an iteration of the traced pass: the
program's `wavefront.shade` spans (surface points, emission, the
environment, lobes, light samples, NEE, BSDF samples, roulette), summed,
over the pass's `wavefront.iter` spans."""
from harness.program_spans import device_ms_per_iter


def read(run):
    return device_ms_per_iter(run, ("wavefront.shade",))
