"""Milliseconds of `backward()` of a gradient step (the synchronised span
`backward`), mean over the traced steps."""
import statistics


def read(run):
    v = run.spans.get("backward")
    return statistics.fmean(v) * 1e3 if v else None
