"""The program's own spans (`slr_tpu_torch/utils/metrics.py` `span`) in a
traced run: taken once from the program into `run.cache`, kept to the
traced window, summed by name, and the device's idle time in the window
summed by the innermost program span open on the host at each gap's start
(the spans' host stamps and the trace share `time.time_ns()`'s clock).

A program without spans gives none, and every reader then returns None;
so does a run without CUDA, whose spans carry no device time and whose
trace has no device activity."""
from __future__ import annotations

import numpy as np

from .trace import _union


def records(run) -> list | None:
    """The program's span records whose host interval lies in the traced
    window, in the order they opened; None where there are none."""
    if "program_spans" not in run.cache:
        run.cache["program_spans"] = _take(run)
    return run.cache["program_spans"]


def _take(run):
    from slr_tpu_torch.utils import metrics

    take = getattr(metrics, "spans", None)
    win = [iv for iv in run.intervals if iv[0] == "window"]
    if take is None or not win:
        return None
    ws, we = win[0][1], win[0][2]
    return [r for r in take() if ws <= r.start_ns and r.end_ns <= we] or None


def device_ms(run, names) -> float | None:
    """Device milliseconds of the spans named in `names`, summed."""
    recs = records(run)
    ms = [r.device_ms for r in recs or () if r.name in names]
    if not ms or any(v is None for v in ms):
        return None
    return float(sum(ms))


def iterations(run) -> int:
    """The traced pass's wavefront iterations: its `wavefront.iter` spans."""
    return sum(r.name == "wavefront.iter" for r in records(run) or ())


def device_ms_per_iter(run, names) -> float | None:
    ms, n = device_ms(run, names), iterations(run)
    return ms / n if ms is not None and n else None


def innermost(recs: list, points: np.ndarray) -> np.ndarray:
    """For each of the ascending host times `points` (ns), the index in
    `recs` of the innermost record whose host interval holds it, or -1.
    Spans nest, and the records are in the order they opened: the last
    one to claim a point is the innermost holding it."""
    owner = np.full(points.size, -1, np.int64)
    for i in sorted(range(len(recs)), key=lambda i: recs[i].start_ns):
        lo, hi = np.searchsorted(points, [recs[i].start_ns, recs[i].end_ns],
                                 side="left")
        owner[lo:hi] = i
    return owner


def gaps(run):
    """(start, end) ns of the device's idle gaps in the traced window,
    ascending; None without a window or device activity in it."""
    ev = run.events
    win = [iv for iv in run.intervals if iv[0] == "window"]
    if ev is None or not win:
        return None
    ws, we = win[0][1], win[0][2]
    dev = (ev.end > ws) & (ev.start < we)
    if not dev.any():
        return None
    us, ue = _union(np.clip(ev.start[dev], ws, we),
                    np.clip(ev.end[dev], ws, we))
    gs = np.concatenate([[ws], ue])       # ascending: the union is sorted
    ge = np.concatenate([us, [we]])
    keep = ge > gs
    return gs[keep], ge[keep]


def idle_by_span(run) -> dict | None:
    """Seconds of device idle in the traced window by the name of the
    innermost program span open at each gap's start ("" where none is);
    None without spans or device activity."""
    recs, g = records(run), gaps(run)
    if not recs or g is None:
        return None
    gs, ge = g
    code = {n: c + 1 for c, n in enumerate(sorted({r.name for r in recs}))}
    code_of = np.array([0] + [code[r.name] for r in recs])   # owner + 1
    idle = np.bincount(code_of[innermost(recs, gs) + 1],
                       weights=(ge - gs) / 1e9, minlength=len(code) + 1)
    return {"": float(idle[0]), **{n: float(idle[c])
                                   for n, c in code.items()}}


def idle_ms_per_step(run, under) -> float | None:
    """Milliseconds of device idle a traced step whose gap starts under a
    program span for which `under(name)` holds."""
    idle, steps = idle_by_span(run), len(run.spans.get("step", ()))
    if idle is None or not steps:
        return None
    return 1e3 * sum(v for n, v in idle.items() if n and under(n)) / steps
