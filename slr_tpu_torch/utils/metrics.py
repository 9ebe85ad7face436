"""Observability: build stats, program spans and device traces
(counterpart of slr_tpu/utils/metrics.py).

Build stats go through the standard `logging` module (logger
"slr_tpu_torch"), plus:

* `span(name, it=None, **counts)` — a named phase of the program. Spans
  record only while a torch profiler records (`torch.profiler.profile`, or
  the low-level `torch.autograd._enable_profiler`) or inside
  `record_spans()`; otherwise a span costs one test and is a shared no-op.
  A record (`SpanRecord`) keeps the name, the index of the enclosing
  record, an iteration id (the wavefront iteration or the bounce; children
  inherit it), host start and end from `time.time_ns()` — the clock the
  profiler stamps its events in, so a device gap can be matched to the
  span open on the host at that moment — the device-stream milliseconds
  between two CUDA events recorded on the current stream at enter and exit
  (None without CUDA), and the counts given. Records stay in memory:
  `spans()` returns them, `clear_spans()` drops them; `traced(name)`
  makes each call of a function a span. A span adds no device operation:
  CUDA events are not kernels, and no `record_function` annotation is
  made.
* `phase_table` — device and host milliseconds, calls and counts by span
  name, as text.
* `profile_trace` — a `torch.profiler` trace of a block, written as a
  Chrome trace into a directory, with the block's spans as a host track.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import logging
import os
import time

import torch

logger = logging.getLogger("slr_tpu_torch")

_profiling = torch._C._autograd._profiler_enabled


def log_build_stats(kind: str, **stats) -> None:
    """One structured line per build event (BVH, scene)."""
    parts = " ".join(f"{k}={v}" for k, v in stats.items())
    logger.info("[build] %s %s", kind, parts)


@dataclasses.dataclass
class SpanRecord:
    name: str
    parent: int | None      # index of the enclosing record, or None
    iter: int | None        # the iteration or bounce the span belongs to
    start_ns: int           # host, time.time_ns()
    end_ns: int
    device_ms: float | None  # current stream, enter to exit; None: no CUDA
    counts: dict


class _Recorder:
    """The process's records, the indices of the open ones (innermost
    last), the CUDA events of closed records not yet read, free events, and
    the depth of `record_spans()`."""

    def __init__(self):
        self.records: list[SpanRecord] = []
        self.open: list[int] = []
        self.pending: list = []
        self.pool: list = []
        self.forced = 0

    def event(self):
        return (self.pool.pop() if self.pool
                else torch.cuda.Event(enable_timing=True))


_REC = _Recorder()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "it", "counts", "idx", "events")

    def __init__(self, name: str, it: int | None, counts: dict):
        self.name, self.it, self.counts = name, it, counts

    def __enter__(self):
        rec = _REC
        parent = rec.open[-1] if rec.open else None
        it = self.it
        if it is None and parent is not None:
            it = rec.records[parent].iter
        self.idx = len(rec.records)
        rec.records.append(SpanRecord(self.name, parent, it, time.time_ns(),
                                      0, None, self.counts))
        rec.open.append(self.idx)
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (rec.event(), rec.event())
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        rec = _REC
        if self.events is not None:
            self.events[1].record()
            rec.pending.append((self.idx,) + self.events)
        rec.records[self.idx].end_ns = time.time_ns()
        rec.open.pop()
        return False


def span(name: str, it: int | None = None, **counts):
    """A context manager that records the phase `name` while spans are on
    (see the module's docstring); `it` sets the iteration id, which nested
    spans inherit; `counts` are kept with the record."""
    if _REC.forced or _profiling():
        return _Span(name, it, counts)
    return _OFF


def traced(name: str):
    """Decorator: each call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


@contextlib.contextmanager
def record_spans():
    """Record spans inside the block without a profiler."""
    _REC.forced += 1
    try:
        yield
    finally:
        _REC.forced -= 1


def spans() -> list[SpanRecord]:
    """The records so far, in the order their spans opened. Reading the
    device milliseconds of closed spans synchronises the device once."""
    rec = _REC
    if rec.pending:
        torch.cuda.synchronize()
        for idx, e0, e1 in rec.pending:
            rec.records[idx].device_ms = e0.elapsed_time(e1)
            rec.pool += (e0, e1)
        rec.pending.clear()
    return list(rec.records)


def clear_spans() -> None:
    """Drop every record; outside any open span."""
    rec = _REC
    if rec.open:
        raise RuntimeError("clear_spans() inside an open span")
    for _, e0, e1 in rec.pending:
        rec.pool += (e0, e1)
    rec.pending.clear()
    rec.records.clear()


def phase_table(records: list[SpanRecord]) -> str:
    """One line per span name, in the order the names first appear: calls,
    device ms and host ms summed, and each count summed."""
    rows: dict = {}
    for r in records:
        row = rows.setdefault(r.name, {"calls": 0, "device": 0.0,
                                       "host": 0.0, "counts": {}})
        row["calls"] += 1
        row["host"] += (r.end_ns - r.start_ns) / 1e6
        row["device"] = (None if row["device"] is None or r.device_ms is None
                         else row["device"] + r.device_ms)
        for k, v in r.counts.items():
            row["counts"][k] = row["counts"].get(k, 0) + v
    lines = [f"{'span':<20} {'calls':>7} {'device ms':>11} {'host ms':>11}"]
    for name, row in rows.items():
        dev = "-" if row["device"] is None else f"{row['device']:.3f}"
        counts = " ".join(f"{k}={v}" for k, v in row["counts"].items())
        lines.append(f"{name:<20} {row['calls']:>7} {dev:>11} "
                     f"{row['host']:>11.3f} {counts}".rstrip())
    return "\n".join(lines)


def _merge_spans(path: str, records: list[SpanRecord]) -> None:
    """Append `records` to the Chrome trace at `path` as one host track,
    in the trace's own time base."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                   "args": {"name": "slr_tpu_torch spans"}})
    for r in records:
        events.append({
            "ph": "X", "cat": "span", "name": r.name, "pid": pid, "tid": 0,
            "ts": (r.start_ns - base) / 1e3,
            "dur": (r.end_ns - r.start_ns) / 1e3,
            "args": dict(r.counts, iter=r.iter, device_ms=r.device_ms)})
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Trace a block with torch.profiler (host and, where there is one, the
    CUDA device) and write `trace.json` (Chrome trace format) into
    `log_dir`, with the block's span records merged in as a host track.
    Yields a list that receives those records when the block ends; they are
    taken out of `spans()`. No-op when log_dir is None."""
    taken: list[SpanRecord] = []
    if not log_dir:
        yield taken
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = len(_REC.records)
    with torch.profiler.profile(activities=acts) as prof:
        yield taken
    taken += spans()[first:]
    del _REC.records[first:]
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _merge_spans(path, taken)
    logger.info("[profile] trace written to %s", path)
