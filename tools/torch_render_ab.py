#!/usr/bin/env python3
"""Alternating end-to-end renders of two trees of the repository on one
NVIDIA GPU, in one call.

    python3 tools/torch_render_ab.py PARENT_TREE [--rounds 1]

PARENT_TREE is a checkout of the parent commit (e.g. `git archive <commit> |
tar -x -C _parent/tree`); the other tree is the one this script lies in.
Each turn is a fresh process in one tree that builds the kernels and runs
chip_smoke's two main-path phases there: the spectral Cornell box at
1024x768 and the grass field at 512x384, spp 4, depth 100, each after its
warm-up render, with that tree's own gates (launch counts, image sanity).
The turns go parent, change, change, parent per round, so that drift of the
machine falls on both. Prints each turn's seconds, iterations and image
means, then each tree's mean seconds.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

TURN = r"""
import json, sys
import chip_smoke as cs
cs.log = lambda *a: None
cs.phase_device()
cs.cuda_build.build_library("traverse")
cornell = cs.phase_main_path(cs.cornell_box_spheres(spectral=True))
grass = cs.phase_grass_main_path(cs.grass_field(**cs.GRASS))
print("TURN " + json.dumps({
    "cornell_s": cornell["seconds"], "cornell_iters": cornell["iterations"],
    "cornell_mean": cornell["mean"], "grass_s": grass["seconds"],
    "grass_iters": grass["iterations"], "launches": grass["launches"]}))
"""


def turn(tree: str) -> dict:
    out = subprocess.run([sys.executable, "-c", TURN], cwd=tree, text=True,
                         capture_output=True, env=dict(os.environ,
                                                       PYTHONPATH=tree))
    if out.returncode != 0:
        raise RuntimeError(f"turn in {tree} failed:\n{out.stdout}\n"
                           f"{out.stderr}")
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("TURN "))
    return json.loads(line[5:])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent_tree")
    ap.add_argument("--rounds", type=int, default=1)
    opt = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"parent": os.path.abspath(opt.parent_tree), "change": here}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    results = {name: [] for name in trees}
    for _ in range(opt.rounds):
        for name in ("parent", "change", "change", "parent"):
            res = turn(trees[name])
            results[name].append(res)
            print(f"[render ab] {name}: {json.dumps(res)}", flush=True)
    for name, rs in results.items():
        print(f"[render ab] {name}: Cornell mean "
              f"{statistics.mean(r['cornell_s'] for r in rs):.3f} s, grass "
              f"mean {statistics.mean(r['grass_s'] for r in rs):.3f} s over "
              f"{len(rs)} turns", flush=True)


if __name__ == "__main__":
    main()
