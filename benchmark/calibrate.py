#!/usr/bin/env python3
"""Readings that the limits of `checks/<cell>.json` are set from, at the
cell's own size, in one process (the scene is loaded once):

    python3 benchmark/calibrate.py --workload <cell> --first-seed <n> \
        [--seeds 12] [--control 3] [--faults 0]

For each of `--seeds` seeds the program's numbers compared (the lower
reading is their largest); for each of `--control` seeds the control's
(the reference in bfloat16 in the program's place; the upper reading is
their smallest); with `--faults` seeds, a cell whose entry can plant the
fault of half the batch left out reads it. One JSON line per reading.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]

import torch  # noqa: E402

from harness import spec  # noqa: E402
from harness.record import Run  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("calibrate.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload)
    entry = importlib.import_module("entries." + cell.entry)
    base = Run(cell=cell, seed=args.first_seed, device="cuda")
    entry.setup(base)

    def fresh(seed):
        run = Run(cell=cell, seed=seed, device="cuda")
        run.state["scene"] = base.state["scene"]
        run.kept.update(scene_path=base.kept["scene_path"],
                        render_seed=base.kept["render_seed"])
        run.cache = base.cache
        return run

    jobs = ([("program", i, {}) for i in range(args.seeds)]
            + [("control", i, {}) for i in range(args.control)]
            + [("fault_half_batch", i, {"loss_rows": 2})
               for i in range(args.faults)])
    for kind, i, kw in jobs:
        seed = args.first_seed + 7919 * (i + 1)
        t0 = time.perf_counter()
        run = fresh(seed)
        fn = entry.control if kind == "control" else entry.calibrate
        numbers = fn(run, **kw)
        print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                          "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
