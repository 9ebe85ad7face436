#!/usr/bin/env python3
"""Alternating comparison of builds of the traversal kernels on one NVIDIA
GPU, in one process, on identical inputs.

    PYTHONPATH=. python3 tools/torch_kernel_ab.py PARENT_TRAVERSE_CU \\
        [--also NAME=SOURCE.cu ...] [--variant NAME=-DFLAG[,-DFLAG] ...] \\
        [--pairs 10] [--launches 50]

PARENT_TRAVERSE_CU is the `traverse.cu` of the parent commit, e.g. unpacked
with `git archive <commit> | tar -x -C _parent`; its C entry points end at
the stream argument. It is compared with the package's
`slr_tpu_torch/csrc/traverse.cu` (`new`), whose entry points add `ran` and
the instanced flag after the stream, with every `--also` source (same
interface as `new`: an intermediate state of the file) and with every
`--variant` (the package's source compiled with extra nvcc flags, e.g.
`stage2=-DSLR_SCAN_W=1,-DSLR_RELIST=0` for per-entry scans, or
`relist_both=-DSLR_RELIST=2`).

All builds use the package's nvcc flags and are started together. The
inputs are chip_smoke's four Cornell casts (static tables) and four grass
casts (instanced tables, random shutter fractions), 49,152 rays each. Every
build's outputs must equal the parent's on every set. A turn times
`--launches` back-to-back launches of one build between two CUDA events;
the builds take turns `--pairs` times, the order rotating by one each
round. Prints every turn's ms per launch, each build's mean, and each
build's paired difference from `parent` (mean, range, rounds slower).
"""
import argparse
import ctypes
import os
import statistics
import subprocess
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from slr_tpu_torch.accel import traverse as tv
from slr_tpu_torch.accel.intersect import RAY_EPSILON
from slr_tpu_torch.core import cuda_build


def build_all(sources: dict, out_dir: str) -> dict:
    """nvcc on every (source, extra flags) at once; returns name -> loaded
    library, and prints each kernel's registers and shared memory."""
    procs = {}
    for name, (src, flags) in sources.items():
        out = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (out, subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o",
             out, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        kernel = ""
        for line in err.splitlines():
            if "Compiling entry function" in line:
                kernel = cs.kernel_label(line)
            if "Used" in line and kernel:
                cs.log(f"[build] {name} {kernel}: "
                       f"{line.split('Used', 1)[1].strip()}")
        libs[name] = ctypes.CDLL(out)
    return libs


def launcher(lib, parent: bool, kernel: str, args, pt, outs):
    """A closure that launches `kernel` of `lib` once on the current
    stream, through the parent's or the current C interface."""
    rays, wl, wtn, cnt = args
    nb, _, rb = rays.shape

    def P(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    head = [P(rays), P(wl), P(wtn), P(cnt), P(pt.boxes), P(pt.entry_chunk),
            P(pt.entry_inst), P(pt.inst_trs), P(pt.tri24)]
    head += [P(o) for o in outs] + [P(pt.n_valid), P(None), P(None)]
    head += [ctypes.c_int(v) for v in (nb, rb, pt.n_entries, pt.chunk)]
    head.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if not parent:
        head += [P(None), ctypes.c_int(int(pt.instanced))]
    fn = getattr(lib, "slr_" + kernel)
    fn.restype = ctypes.c_int

    def launch():
        code = fn(*head)
        if code != 0:
            raise RuntimeError(f"{kernel}: CUDA error {code}")
    return launch


def ms_per_launch(launch, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def compare(label, kernel, args, pt, libs, opt) -> None:
    nb, _, rb = args[0].shape
    n_out = 3 if kernel == "closest_hit" else 1
    outs, run = {}, {}
    for name, lib in libs.items():
        outs[name] = [torch.empty((nb, rb), dtype=torch.float32
                                  if (i == 0 and n_out == 3)
                                  else torch.int32, device=cs.DEV)
                      for i in range(n_out)]
        run[name] = launcher(lib, name == "parent", kernel, args, pt,
                             outs[name])
        run[name]()
    torch.cuda.synchronize()
    for name in libs:
        if not all(torch.equal(a, b) for a, b in
                   zip(outs[name], outs["parent"])):
            raise AssertionError(f"{label}: {name} differs from parent")
    names = list(libs)
    turns = {name: [] for name in names}
    for k in range(opt.pairs):
        for name in names[k % len(names):] + names[:k % len(names)]:
            turns[name].append(ms_per_launch(run[name], opt.launches))
    for name in names:
        ms = turns[name]
        diff = [a - b for a, b in zip(ms, turns["parent"])]
        rel = statistics.mean(diff) / statistics.mean(turns["parent"]) * 100
        cs.log(f"[ab] {label} {name}: mean {statistics.mean(ms):.4f} "
               f"ms per launch; against parent: mean "
               f"{statistics.mean(diff) * 1e3:+.1f} us ({rel:+.2f}%), "
               f"range {min(diff) * 1e3:+.1f} to "
               f"{max(diff) * 1e3:+.1f} us, slower in "
               f"{sum(x > 0 for x in diff)} of {len(diff)} rounds; "
               f"turns " + " ".join(f"{x:.4f}" for x in ms))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent_source")
    ap.add_argument("--also", action="append", default=[],
                    metavar="NAME=SOURCE")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=FLAGS")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--launches", type=int, default=50)
    opt = ap.parse_args()

    cs.phase_device()
    new_source = os.path.join(cuda_build.CSRC, "traverse.cu")
    sources = {"parent": (opt.parent_source, []), "new": (new_source, [])}
    for spec in opt.also:
        name, src = spec.split("=", 1)
        sources[name] = (src, [])
    for spec in opt.variant:
        name, flags = spec.split("=", 1)
        sources[name] = (new_source, flags.split(","))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(sources, tmp)
        cornell = cs.cornell_box_spheres(spectral=True)
        grass = cs.grass_field(**cs.GRASS)
        sets = [(cornell, "cornell " + k, v + (None,))
                for k, v in cs.cornell_ray_sets(cornell).items()]
        sets += [(grass, "grass " + k, v) for k, v in
                 cs.grass_ray_sets(grass, np.random.RandomState(1)).items()]
        for scene, label, (kernel, o, d, tmax, active, f) in sets:
            pt = scene.pallas_tris
            rays, wl, cnt, wtn, _ = tv.prepare_cast(
                pt, o, d, RAY_EPSILON, tmax, active, f=f)
            compare(label, kernel, (rays, wl, wtn, cnt), pt, libs, opt)


if __name__ == "__main__":
    main()
