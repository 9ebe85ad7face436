"""Milliseconds of the forward render and loss of a gradient step (the
synchronised span `forward`), mean over the traced steps."""
import statistics


def read(run):
    v = run.spans.get("forward")
    return statistics.fmean(v) * 1e3 if v else None
