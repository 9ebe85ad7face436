#!/usr/bin/env python3
"""One run of one cell of the benchmark of `slr_tpu_torch` on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell (an entry of BENCHMARK.json's
`workloads`) names a configuration (`configs/<config>.json`) and a traffic
mix (`traffic/<traffic>.json`), whose `entry` is the window driver
(`entries/<entry>.py`); its limits are `checks/<cell>.json`. Set-up loads
and warms up; `--trace 0` measures the window and reports the cell's
end-to-end metrics; `--trace 1` runs one traced window under the profiler
and reports the cell's per-layer metrics (`layer_metrics/<metric>.py`).
Then the program's state is freed and what the window produced is
compared with the plain reference (`reference/`).

The last line of standard output is one JSON object; the numbers compared
and their limits are also the last lines of standard error. Exits with 2,
printing no result, without enough CUDA devices, and with 3 if JAX or the
JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (BENCH_DIR, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# Keep libraries that can load JAX by themselves from doing so.
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import torch  # noqa: E402

from harness import guard, spec  # noqa: E402

# One process with one intra-op thread: the window's work is the device's
# and the host's launch thread's, and idle pool threads of a many-thread
# process only contend with that thread for the host's cores.
torch.set_num_threads(1)
from harness.record import Run  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def read_layer_metric(name: str, run):
    path = os.path.join(BENCH_DIR, "layer_metrics", name + ".py")
    sp = importlib.util.spec_from_file_location("layer_metric." + name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read(run)


def device_info(device: str, count: int, trace_summary=None) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    if trace_summary is not None:
        info["busy_s"] = trace_summary.busy_s
        info["window_s"] = trace_summary.window_s
    return info


def refuse_jax() -> None:
    bad = guard.forbidden_modules()
    if bad:
        print("run.py: JAX or the JAX package was loaded: " + ", ".join(bad),
              file=sys.stderr)
        sys.exit(3)


def main(argv=None, device: str | None = None, cell=None) -> dict:
    """One run; returns the result. `device` and `cell` let the tests run
    it on the CPU at a small size; the benchmark's own runs give neither."""
    args = parse(argv)
    cell = cell or spec.load_cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"run.py: the cell needs {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            sys.exit(2)
        device = "cuda"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    entry = importlib.import_module("entries." + cell.entry)
    run = Run(cell=cell, seed=args.seed, device=device)

    entry.setup(run)
    setup_s = time.perf_counter() - T0
    summary = None
    if args.trace:
        entry.traced(run)
        from harness.trace import summarise

        summary = run.summary = summarise(run.events, run.intervals)
        attempted = len(run.spans.get("step", run.spans.get("pass", [])))
        values = {}
    else:
        values, attempted = entry.window(run, args.seconds)
        values["setup_s"] = setup_s
    info = device_info(device, cell.chips, summary)
    refuse_jax()

    metrics = {}
    wanted = cell.per_layer if args.trace else cell.end_to_end
    for m in wanted:
        v = (read_layer_metric(m["name"], run) if args.trace
             else values.get(m["name"]))
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    t_closed = time.perf_counter()
    entry.release(run)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = entry.check(run)
    print(f"run.py: set-up {setup_s:.3f} s, window and readers "
          f"{t_closed - T0 - setup_s:.3f} s, comparison "
          f"{time.perf_counter() - t_closed:.3f} s; calls "
          f"{[round(x, 4) for x in run.spans.get('call', [])]}; "
          f"{run.counters.get('iterations', '')}; casts "
          f"{ {k: v for k, v in run.counters.items() if k.startswith('cast.')} }",
          file=sys.stderr)
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    refuse_jax()
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": info}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.top_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
