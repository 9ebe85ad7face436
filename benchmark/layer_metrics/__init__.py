"""One reader per per-layer metric, found by the metric's name
(`<name>.py`). Each has `read(run) -> float | None`; None leaves the metric
out of the result line."""
