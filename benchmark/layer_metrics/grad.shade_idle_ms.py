"""Milliseconds of device idle a traced gradient step whose gap starts on
the host under the program's `pt.shade` spans (the fixed-depth tracer's
shading: lobes, light samples, NEE, BSDF samples, emission, roulette)."""
from harness.program_spans import idle_ms_per_step


def read(run):
    return idle_ms_per_step(run, lambda name: name == "pt.shade")
