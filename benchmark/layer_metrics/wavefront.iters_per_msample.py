"""Wavefront iterations per million samples of the traced pass: a count,
which repeats exactly for a seed; it shows the pass's tail and how full
the lanes are."""


def read(run):
    iters, samples = run.counters.get("iterations"), run.counters.get(
        "samples")
    if not iters or not samples:
        return None
    return iters[0] / samples * 1e6
