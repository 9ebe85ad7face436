#!/usr/bin/env python3
"""Where a benchmark cell's time goes, read from the program's own spans
(`slr_tpu_torch/utils/metrics.py`), on a CUDA device:

    python3 tools/torch_span_report.py --cell cornell_pt [--turns 3]
        [--steps 4] [--seed N] [--out FILE]

After the cell's own set-up (`benchmark/entries/`), for the cell's call (a
render pass, or `--steps` gradient steps):

1. the cost of recording spans: the call untraced, outside and inside
   `record_spans()`, in `--turns` alternating turns, host seconds each;
2. one traced call (a pass, or two steps, as the benchmark traces them)
   under the profiler's device activities and the CUDA runtime's launch
   records: calls and device ms by span name; the phases (children of a
   `wavefront.iter` or `pt.bounce` span) summed against the device's busy
   time and the window; each wavefront iteration's live lanes and the
   width it ran over, and the pass's cuts of that width (its
   `wavefront.compact` spans); the device's idle time by the innermost
   span open at each gap's start (for the gradient cell, of the gaps that
   start in the forward); and each kernel's device time and launches by
   the span that launched it, matched through the launch's correlation
   id.

Prints one JSON object per cell, appended to `--out` too.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import program_spans, spec  # noqa: E402
from harness.clock import sync  # noqa: E402
from harness.record import Run  # noqa: E402
from harness.trace import Events, summarise  # noqa: E402
from slr_tpu_torch.utils import metrics  # noqa: E402

ITERATION_SPANS = ("wavefront.iter", "pt.bounce")


def _calls(run, cell, steps: int):
    """(untraced call, traced call) of the cell after its set-up."""
    if cell.entry == "wavefront_passes":
        entry = importlib.import_module("entries.wavefront_passes")

        def untraced():
            entry._pass(run, 0)

        def traced():
            with run.span("window"):
                with run.span("pass"):
                    entry._pass(run, 0)
        return untraced, traced
    fit, k0 = run.state["fit"], run.state["next_step"]

    def untraced():
        for i in range(steps):
            fit.step(k0 + i)

    def traced():
        with run.span("window"):
            for i in range(2):
                with run.span("step"):
                    fit.step(k0 + i, run.span)
    return untraced, traced


def _seconds(call, device) -> float:
    sync(device)
    t0 = time.perf_counter()
    call()
    sync(device)
    return time.perf_counter() - t0


def tracing_cost(call, device, turns: int) -> dict:
    """Host seconds of the call outside and inside `record_spans()`, in
    turns that alternate which goes first."""
    out, inside = [], []
    for t in range(turns):
        for on in ((False, True) if t % 2 == 0 else (True, False)):
            if on:
                with metrics.record_spans():
                    inside.append(_seconds(call, device))
                metrics.clear_spans()
            else:
                out.append(_seconds(call, device))
    return {"off_s": out, "on_s": inside,
            "cost_pct": 100.0 * (np.median(inside) / np.median(out) - 1.0)}


def traced_call(run, call):
    """The call under the profiler: device events into `run.events`, and
    the launch records' host start by correlation id."""
    from torch._C._profiler import (
        ProfilerConfig,
        ProfilerState,
        _ExperimentalConfig,
    )
    from torch.autograd import (
        _disable_profiler,
        _enable_profiler,
        _prepare_profiler,
    )
    from torch.profiler import ProfilerActivity

    metrics.clear_spans()
    acts = {ProfilerActivity.CUDA}
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    call()
    raw = _disable_profiler().events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in raw if e.device_type() == cuda
           and not e.is_user_annotation()]
    start = np.fromiter((e.start_ns() for e in dev), np.int64, len(dev))
    run.events = Events(
        names=[e.name() for e in dev], start=start,
        end=start + np.fromiter((e.duration_ns() for e in dev), np.int64,
                                len(dev)))
    launch = {e.correlation_id(): e.start_ns() for e in raw
              if e.device_type() != cuda and e.name().startswith(("cuda",
                                                                  "cu"))}
    corr = [e.correlation_id() for e in dev]
    return launch, corr


def report(run, launch, corr) -> dict:
    recs = metrics.spans()          # the traced call's only
    summary = run.summary = summarise(run.events, run.intervals)
    window = program_spans.records(run)
    assert window is not None and len(window) == len(recs)
    by_name: dict = {}
    for r in recs:
        row = by_name.setdefault(r.name, [0, 0.0])
        row[0] += 1
        row[1] += r.device_ms
    phases = [r for r in recs if r.parent is not None
              and recs[r.parent].name in ITERATION_SPANS]
    iters = sum(r.name in ITERATION_SPANS for r in recs)
    out = {
        "window_s": summary.window_s, "busy_s": summary.busy_s,
        "device_ops": summary.device_ops, "iterations": iters,
        "spans": {n: {"calls": c, "device_ms": ms}
                  for n, (c, ms) in by_name.items()},
        "phases_device_s": sum(r.device_ms for r in phases) / 1e3,
    }
    if iters:
        out["device_ms_per_iter"] = {n: ms / iters
                                     for n, (_, ms) in by_name.items()}
    iter_recs = [r for r in recs if r.name == "wavefront.iter"]
    if iter_recs:
        out["live_lanes_pct"] = 100.0 * sum(
            r.counts["live"] for r in iter_recs) / sum(
            r.counts["lanes"] for r in iter_recs)
        out["live_by_iter"] = [r.counts["live"] for r in iter_recs]
        out["lanes_by_iter"] = [r.counts["lanes"] for r in iter_recs]
        cuts = [r for r in recs if r.name == "wavefront.compact"]
        out["compact"] = {
            "cuts": len(cuts),
            "iter_live_from_to": [[r.iter, r.counts["live"],
                                   r.counts["lanes_from"],
                                   r.counts["lanes_to"]] for r in cuts]}

    # Idle by the innermost span at each gap's start; for the gradient
    # cell, of the gaps that start inside the benchmark's forward spans.
    gs, ge = program_spans.gaps(run)
    owner = program_spans.innermost(window, gs)
    fwd = [(s, e) for n, s, e in run.intervals if n == "forward"]
    sel = np.ones(gs.size, bool)
    if fwd:
        sel = np.zeros(gs.size, bool)
        for s, e in fwd:
            sel |= (gs >= s) & (gs < e)
    idle: dict = {}
    for o, secs in zip(owner[sel].tolist(), ((ge - gs)[sel] / 1e9).tolist()):
        name = window[o].name if o >= 0 else ""
        idle[name] = idle.get(name, 0.0) + secs
    total = sum(idle.values())
    outside = idle.get("", 0.0) + sum(idle.get(n, 0.0)
                                      for n in ITERATION_SPANS)
    out.update(idle_s=idle, idle_total_s=total,
               idle_under_phase_pct=100.0 * (1.0 - outside / total)
               if total else None,
               idle_scope="forward" if fwd else "window")

    # Kernels by the span that launched them.
    host = np.array([launch.get(c, -1) for c in corr], np.int64)
    matched = host >= 0
    order = np.argsort(host, kind="stable")
    by_launch = np.full(host.size, -1, np.int64)
    by_launch[order] = program_spans.innermost(window, host[order])
    dur = (run.events.end - run.events.start) / 1e9
    kernels: dict = {}
    for k, name in enumerate(run.events.names):
        span = (window[by_launch[k]].name if matched[k] and by_launch[k] >= 0
                else "?" if not matched[k] else "")
        row = kernels.setdefault(name, {}).setdefault(span, [0, 0.0])
        row[0] += 1
        row[1] += float(dur[k])
    top = sorted(kernels.items(), key=lambda kv: -sum(v[1] for v in
                                                      kv[1].values()))
    out["launch_matched"] = int(matched.sum())
    out["kernels_by_span"] = [
        [name[:90], {s: [c, round(t, 6)] for s, (c, t) in rows.items()}]
        for name, rows in top[:16]]
    ops_by_span: dict = {}
    for k in range(host.size):
        span = window[by_launch[k]].name if by_launch[k] >= 0 else ""
        ops_by_span[span] = ops_by_span.get(span, 0) + 1
    out["device_ops_by_span"] = ops_by_span
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 1313)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_span_report.py: needs a CUDA device")
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.load_cell(args.cell)
    run = Run(cell=cell, seed=args.seed, device="cuda")
    importlib.import_module("entries." + cell.entry).setup(run)
    untraced, traced = _calls(run, cell, args.steps)
    result = {"cell": args.cell, "device": torch.cuda.get_device_name(0),
              "cost": tracing_cost(untraced, "cuda", args.turns)}
    launch, corr = traced_call(run, traced)
    result.update(report(run, launch, corr))
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
