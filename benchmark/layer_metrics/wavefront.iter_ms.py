"""Milliseconds per wavefront iteration: the wall time of the window's
first pass, rendered without the profiler before the traced one (the span
`pass_untraced`), over its iterations. The profiler's own cost, which
grows with the device operations an iteration launches, is not in it."""


def read(run):
    passes = run.spans.get("pass_untraced")
    iters = run.counters.get("iterations_untraced")
    if not passes or not iters:
        return None
    return passes[0] * 1e3 / iters
