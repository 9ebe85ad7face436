#!/usr/bin/env python3
"""Alternating comparison of builds of the traversal kernels on one NVIDIA
GPU, in one process, on identical inputs.

    PYTHONPATH=. python3 tools/torch_kernel_ab.py OLD_TRAVERSE_CU \\
        [--pairs 10] [--launches 50]

OLD_TRAVERSE_CU is an earlier `traverse.cu` whose C entry points predate
instancing (no `einst`, `inst_trs`, `nvalid`, `xforms` arguments), e.g.
unpacked with `git archive <commit> | tar -x -C _parent`. It is compared
with the package's `slr_tpu_torch/csrc/traverse.cu` and with two variants
derived from that file by text substitution, which separate what the
instancing support costs a static table:

  no_transform  the entry's instance is still read (the `einst` load, the
                branch, `best_inst`), but the local line is never derived:
                the transform's code and registers are gone;
  no_instances  the instance is the constant -1: neither the load nor the
                transform remain.

All builds use the package's nvcc flags and are started together. The
inputs are chip_smoke's four Cornell casts (49,152 rays, static tables). A
turn times `--launches` back-to-back launches of one build between two
CUDA events; the builds take turns `--pairs` times, the order rotating by
one each round. Prints every turn's ms per launch, each build's mean, and
each build's paired difference from `old` (mean, range, rounds slower).
"""
import argparse
import ctypes
import os
import statistics
import subprocess
import tempfile

import torch

import chip_smoke as cs
from slr_tpu_torch.accel import traverse as tv
from slr_tpu_torch.accel.intersect import RAY_EPSILON
from slr_tpu_torch.core import cuda_build

KERNELS = ("closest_hit_kernel", "any_hit_kernel")
VARIANTS = {
    "no_transform": ("const Line l = inst >= 0 ? xform_ray(strs, r.w, r.f) "
                     ": r.w;", "const Line l = r.w;"),
    "no_instances": ("const int inst = einst[e];", "const int inst = -1;"),
}


def build_all(sources: dict, out_dir: str) -> dict:
    """nvcc on every source at once; returns name -> loaded library, and
    prints each kernel's registers and shared memory."""
    procs = {}
    for name, src in sources.items():
        out = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (out, subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        kernel = ""
        for line in err.splitlines():
            if "Compiling entry function" in line:
                kernel = next((k for k in KERNELS if k in line), "")
            if "Used" in line and kernel:
                cs.log(f"[build] {name} {kernel}: "
                       f"{line.split('Used', 1)[1].strip()}")
        libs[name] = ctypes.CDLL(out)
    return libs


def launcher(lib, old: bool, kernel: str, args, pt, outs):
    """A closure that launches `kernel` of `lib` once on the current
    stream, through the old or the current C interface."""
    rays, wl, wtn, cnt = args
    nb, _, rb = rays.shape

    def P(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    head = [P(rays), P(wl), P(wtn), P(cnt), P(pt.boxes), P(pt.entry_chunk)]
    if not old:
        head += [P(pt.entry_inst), P(pt.inst_trs)]
    head += [P(pt.tri24)] + [P(o) for o in outs]
    head += [P(None)] if old else [P(pt.n_valid), P(None), P(None)]
    sizes = [ctypes.c_int(v) for v in (nb, rb, pt.n_entries, pt.chunk)]
    fn = getattr(lib, "slr_" + kernel)
    fn.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launch():
        code = fn(*head, *sizes, stream)
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_source")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--launches", type=int, default=50)
    opt = ap.parse_args()

    cs.phase_device()
    new_source = os.path.join(cuda_build.CSRC, "traverse.cu")
    with open(new_source) as f:
        text = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        sources = {"old": opt.old_source, "new": new_source}
        for name, (find, put) in VARIANTS.items():
            if text.count(find) != 2:
                raise RuntimeError(f"variant {name}: expected its line once "
                                   f"in each traversal kernel")
            sources[name] = os.path.join(tmp, name + ".cu")
            with open(sources[name], "w") as f:
                f.write(text.replace(find, put))
        libs = build_all(sources, tmp)

        scene = cs.cornell_box_spheres(spectral=True)
        pt = scene.pallas_tris
        for label, (kernel, o, d, tmax, active) in \
                cs.cornell_ray_sets(scene).items():
            args = tv.prepare_cast(pt, o, d, RAY_EPSILON, tmax, active)[:4]
            args = (args[0], args[1], args[3], args[2])  # rays wl wtn cnt
            nb, _, rb = args[0].shape
            n_out = 3 if kernel == "closest_hit" else 1
            outs, run = {}, {}
            for name, lib in libs.items():
                outs[name] = [torch.empty((nb, rb), dtype=torch.float32
                                          if (i == 0 and n_out == 3)
                                          else torch.int32, device=cs.DEV)
                              for i in range(n_out)]
                run[name] = launcher(lib, name == "old", kernel, args, pt,
                                     outs[name])
                run[name]()
            torch.cuda.synchronize()
            for name in libs:
                if not all(torch.equal(a, b) for a, b in
                           zip(outs[name], outs["old"])):
                    raise AssertionError(f"{label}: {name} differs from old")
            names = list(libs)
            turns = {name: [] for name in names}
            for k in range(opt.pairs):
                for name in names[k % len(names):] + names[:k % len(names)]:
                    turns[name].append(ms_per_launch(run[name],
                                                     opt.launches))
            for name in names:
                ms = turns[name]
                diff = [a - b for a, b in zip(ms, turns["old"])]
                cs.log(f"[ab] {label} {name}: mean {statistics.mean(ms):.4f} "
                       f"ms per launch; against old: mean "
                       f"{statistics.mean(diff) * 1e3:+.1f} us "
                       f"({statistics.mean(diff) / statistics.mean(turns['old']) * 100:+.2f}%), "
                       f"range {min(diff) * 1e3:+.1f} to "
                       f"{max(diff) * 1e3:+.1f} us, slower in "
                       f"{sum(x > 0 for x in diff)} of {len(diff)} rounds; "
                       f"turns " + " ".join(f"{x:.4f}" for x in ms))


if __name__ == "__main__":
    main()
