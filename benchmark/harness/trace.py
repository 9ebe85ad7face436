"""The device trace of a traced window: torch.profiler's device activities,
read raw, and what the per-layer metrics take from them.

Only device activities (kernels, copies, sets) are recorded: the host's
operations would double the events and the profiler's read-back costs tens
of microseconds an event. The benchmark's own spans are taken on the host
with `time.time_ns()`, the clock the profiler stamps its events in, so the
window and the spans need no host events. Device time is the union of the
activities inside the window, so the idle share is 1 - union / the
window's own wall time.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Events:
    """Device activities: names, start and end in ns since the epoch."""

    names: list
    start: np.ndarray
    end: np.ndarray


class DeviceTrace:
    """`with DeviceTrace() as tr: ...`; then `tr.events`. Uses the
    profiler's low-level calls, which skip the per-event Python parse of
    `torch.profiler.profile`."""

    def __init__(self):
        self.events: Events | None = None

    def __enter__(self):
        from torch._C._profiler import (
            ProfilerConfig,
            ProfilerState,
            _ExperimentalConfig,
        )
        from torch.autograd import _enable_profiler, _prepare_profiler
        from torch.profiler import ProfilerActivity

        # (The CPU's activity on a host without CUDA, for the tests: it
        # records no device event.)
        acts = {ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU}
        cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                             False, False, _ExperimentalConfig())
        _prepare_profiler(cfg, acts)
        _enable_profiler(cfg, acts)
        return self

    def __exit__(self, *exc):
        from torch.autograd import _disable_profiler

        raw = [e for e in _disable_profiler().events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation()]
        start = np.fromiter((e.start_ns() for e in raw), np.int64, len(raw))
        self.events = Events(
            names=[e.name() for e in raw], start=start,
            end=start + np.fromiter((e.duration_ns() for e in raw), np.int64,
                                    len(raw)))
        return False


def _union(start: np.ndarray, end: np.ndarray):
    """Merged intervals of (start, end) pairs, sorted."""
    if start.size == 0:
        return start, end
    order = np.argsort(start, kind="stable")
    s, e = start[order], end[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.maximum.reduceat(e, idx)


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: int
    top_ops: list          # [[name, seconds]] by device time, at most 10
    idle_gaps: list        # [[span, length class, count], seconds], <= 10


# Idle gaps by length: launch overhead between back-to-back operations
# (under 20 us), short host work, host syncs and longer host work.
GAP_EDGES_NS = np.array([20_000, 100_000, 1_000_000, 10_000_000])
GAP_CLASSES = ["gaps <20us", "gaps 20-100us", "gaps 0.1-1ms", "gaps 1-10ms",
               "gaps >10ms"]


def summarise(ev: Events, intervals: list) -> Summary:
    """`intervals`: the benchmark's spans as (name, start ns, end ns), one
    of them `window`. The idle time is summed by the innermost span that
    holds each gap's start and by the gap's length class."""
    win = [iv for iv in intervals if iv[0] == "window"]
    if not win:
        raise RuntimeError("no window span was recorded")
    ws, we = win[0][1], win[0][2]
    dev = np.flatnonzero((ev.end > ws) & (ev.start < we))
    ds = np.clip(ev.start[dev], ws, we)
    de = np.clip(ev.end[dev], ws, we)
    us, ue = _union(ds, de)
    busy = float((ue - us).sum()) / 1e9

    codes: dict = {}
    code = np.fromiter((codes.setdefault(ev.names[i], len(codes))
                        for i in dev), np.int64, dev.size)
    per_op = np.bincount(code, weights=(de - ds) / 1e9,
                         minlength=len(codes)) if dev.size else np.zeros(0)
    names = list(codes)
    top = [[names[i], float(per_op[i])]
           for i in np.argsort(-per_op, kind="stable")[:10]]

    gs = np.concatenate([[ws], ue])
    ge = np.concatenate([us, [we]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    # Each gap is labelled by the innermost span holding its start (spans
    # nest, so the latest-starting one), then by its length's decade.
    inner = sorted((iv for iv in intervals if iv[0] != "window"),
                   key=lambda iv: iv[1])
    names = ["window"] + sorted({iv[0] for iv in inner})
    span_of = np.zeros(gs.size, np.int64)
    for name, s0, s1 in inner:
        span_of[(gs >= s0) & (gs < s1)] = names.index(name)
    length = ge - gs
    cls = np.searchsorted(GAP_EDGES_NS, length, side="right")
    idle = {}
    for k in np.unique(span_of):
        for c in np.unique(cls[span_of == k]):
            sel = (span_of == k) & (cls == c)
            label = f"{names[k]} {GAP_CLASSES[c]} x{int(sel.sum())}"
            idle[label] = float(length[sel].sum()) / 1e9
    gaps = [[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])]
    return Summary(window_s=float(we - ws) / 1e9, busy_s=busy,
                   device_ops=int(dev.size), top_ops=top,
                   idle_gaps=gaps[:10])
