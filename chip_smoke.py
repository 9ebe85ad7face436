#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`slr_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero, and no phase's failure is
caught:

1. device: needs CUDA; prints the card's name and power limit.
2. build: compiles the hand-written kernels of slr_tpu_torch/csrc with nvcc.
3. kernels: each kernel against its plain PyTorch version on the card, on
   the port's own Cornell tables at the main path's 49,152 lanes (camera,
   in-box and shadow rays, with an active mask, in the main path's sorted
   lane order); times both with CUDA events and computes each kernel's
   bound from this run's inputs.
4. main path: the spectral Cornell box at 1024x768, spp 4, depth 100
   through `render_wavefront`; both launch counters must equal the
   iteration count (no alpha: one closest-hit and one any-hit cast each).
5. profile: a 256x192 render under torch.profiler (launches per
   iteration, the device's busy share, the kernels' share of it).
6. cross-check: the same scene at 64x48 on the card and on the CPU (plain
   versions), compared per pixel.
7. prints {"kernels": [...]}, then, as the last line, the device line.
"""
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from slr_tpu_torch.accel import traverse as tv
from slr_tpu_torch.accel.intersect import RAY_EPSILON
from slr_tpu_torch.camera.perspective import sample_camera_rays
from slr_tpu_torch.core import cuda_build
from slr_tpu_torch.render.film import develop
from slr_tpu_torch.render.pt import _ray_sort_key
from slr_tpu_torch.render.wavefront import DEFAULT_LANE_CAP, render_wavefront
from slr_tpu_torch.scene.presets import cornell_box_spheres
from slr_tpu_torch.spectrum.rgb import luminance

WIDTH, HEIGHT, SPP, DEPTH, SEED = 1024, 768, 4, 100, 1
CHECK_W, CHECK_H = 64, 48
LANES = DEFAULT_LANE_CAP
TIMING_RUNS = 25
DEV = "cuda"

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations per ray-triangle test, as the kernels compute them: three
# 6-term side products (11 each), n.d (5), d0 - n.o (6), then the divide
# (closest hit) or the two range terms and their product (any hit).
OPS_PER_TEST = {"closest_hit": 33 + 5 + 6 + 1, "any_hit": 33 + 5 + 6 + 5}
SOURCE = "slr_tpu_torch/csrc/traverse.cu"
REPLACES = {"closest_hit": "slr_tpu/accel/pallas_intersect.py:1127",
            "any_hit": "slr_tpu/accel/pallas_intersect.py:1205"}


def log(*args):
    print(*args, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the port on an NVIDIA GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    cuda_build.build_library("traverse")
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    for name, rec in cuda_build.BUILD_LOG.items():
        usage = [ln.strip() for ln in rec["ptxas"].splitlines()
                 if "Used" in ln or "spill" in ln]
        log(f"[build] {name}: nvcc {rec['seconds']:.2f} s; "
            + " | ".join(usage))


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _cuda_tensor(a):
    return torch.as_tensor(np.asarray(a, np.float32), device=DEV)


def camera_rays(scene, n, rs):
    pix = rs.choice(WIDTH * HEIGHT, n, replace=False)
    px = _cuda_tensor(pix % WIDTH + rs.rand(n))
    py = _cuda_tensor(pix // WIDTH + rs.rand(n))
    cam = sample_camera_rays(scene.camera, px, py, WIDTH, HEIGHT,
                             _cuda_tensor(rs.rand(n)), _cuda_tensor(rs.rand(n)))
    return cam.o, cam.d


def box_points(n, rs):
    lo = np.float32([-1.45, 0.05, -2.5])
    hi = np.float32([1.45, 2.45, 2.5])
    return lo + (hi - lo) * rs.rand(n, 3).astype(np.float32)


def box_rays(n, rs):
    """Bounce-like rays: origins inside the box, uniform directions."""
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _cuda_tensor(box_points(n, rs)), _cuda_tensor(d)


def shadow_rays(n, rs):
    """NEE-like rays: from points in the box to points on the area light,
    tmax just short of the light as the renderer sets it."""
    o = box_points(n, rs)
    tgt = np.stack([rs.uniform(-0.5, 0.5, n), np.full(n, 2.499),
                    rs.uniform(-0.5, 0.5, n)], axis=1).astype(np.float32)
    delta = tgt - o
    dist = np.linalg.norm(delta, axis=1)
    return (_cuda_tensor(o), _cuda_tensor(delta / dist[:, None]),
            _cuda_tensor(dist * (1.0 - 1e-3)))


def median_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(name, args, pt, outputs, tests) -> tuple[float, str]:
    """Least time for the same work: each input read once and each output
    written once over the memory rate, or this run's ray-triangle tests
    over the fp32 rate, whichever is larger."""
    rays, wl, wtn, cnt = args
    ins = (rays, wl, wtn, cnt, pt.boxes, pt.entry_chunk, pt.tri24)
    nbytes = sum(t.numel() * t.element_size() for t in ins + tuple(outputs))
    ops = int(tests.sum()) * OPS_PER_TEST[name]
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_closest(label, pt, o, d, tmax, active):
    rays, wl, cnt, wtn, _ = tv.prepare_cast(pt, o, d, RAY_EPSILON, tmax,
                                            active)
    tests = torch.zeros(rays.shape[0], dtype=torch.int32, device=DEV)
    t_k, i_k, inst_k = tv.closest_hit(rays, wl, wtn, cnt, pt, tests=tests)
    t_p, i_p, _ = tv.closest_hit_plain(rays, wl, cnt, pt)
    torch.cuda.synchronize()
    # tests/test_pallas.py criteria: equal hit masks; the same triangle or
    # t within 1e-4 on more than 99.5% of the rays hit.
    h_k, h_p = i_k >= 0, i_p >= 0
    n_mask = int((h_k != h_p).sum())
    both = h_k & h_p
    same = (i_k == i_p) | ((t_k - t_p).abs()
                           <= 1e-4 * torch.clamp(t_p.abs(), min=1.0))
    share = float(same[both].float().mean()) if bool(both.any()) else 1.0
    err = float((t_k - t_p)[h_k == h_p].abs().max())
    ms = median_ms(lambda: tv.closest_hit(rays, wl, wtn, cnt, pt))
    plain = median_ms(lambda: tv.closest_hit_plain(rays, wl, cnt, pt))
    bms, by = bound_ms("closest_hit", (rays, wl, wtn, cnt), pt,
                       (t_k, i_k, inst_k), tests)
    log(f"[kernel] closest_hit {label}: {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {bms:.4f} ms ({by}), tests {int(tests.sum())}, "
        f"entries/block {float(cnt.float().mean()):.2f}, hit rays "
        f"{int(h_p.sum())}, mask mismatches {n_mask}, same-or-close "
        f"{share:.6f}, max |dt| {err:.3g}, idx differ "
        f"{int((i_k != i_p).sum())}")
    if n_mask or share <= 0.995 or not (inst_k == -1).all():
        raise AssertionError(f"closest_hit disagrees with its plain version "
                             f"on {label} rays")
    return dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                max_abs_err=err)


def check_any(label, pt, o, d, tmax, active):
    rays, wl, cnt, wtn, _ = tv.prepare_cast(pt, o, d, RAY_EPSILON, tmax,
                                            active)
    tests = torch.zeros(rays.shape[0], dtype=torch.int32, device=DEV)
    occ_k = tv.any_hit(rays, wl, wtn, cnt, pt, tests=tests)
    occ_p = tv.any_hit_plain(rays, wl, cnt, pt)
    torch.cuda.synchronize()
    err = float((occ_k - occ_p).abs().max())
    ms = median_ms(lambda: tv.any_hit(rays, wl, wtn, cnt, pt))
    plain = median_ms(lambda: tv.any_hit_plain(rays, wl, cnt, pt))
    bms, by = bound_ms("any_hit", (rays, wl, wtn, cnt), pt, (occ_k,), tests)
    log(f"[kernel] any_hit {label}: {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {bms:.4f} ms ({by}), tests {int(tests.sum())}, "
        f"entries/block {float(cnt.float().mean()):.2f}, occluded "
        f"{int(occ_p.sum())}, mismatches {int((occ_k != occ_p).sum())}")
    if err != 0.0:
        raise AssertionError(f"any_hit disagrees with its plain version on "
                             f"{label} rays")
    return dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                max_abs_err=err)


def main_path_order(scene, active, *rays):
    """Lanes in the order the main path casts them: sorted by its coherence
    key (octant + Morton code of the contact point), inactive lanes last."""
    order = torch.argsort(_ray_sort_key(scene, rays[0], rays[1], active),
                          stable=True)
    return [x[order] for x in rays + (active,)]


def phase_kernels(scene) -> dict:
    pt = scene.pallas_tris
    rs = np.random.RandomState(0)
    active = torch.as_tensor(rs.rand(LANES) < 0.8, device=DEV)
    everyone = torch.ones(LANES, dtype=torch.bool, device=DEV)
    o_c, d_c, _ = main_path_order(scene, everyone,
                                  *camera_rays(scene, LANES, rs))
    o_b, d_b, act_b = main_path_order(scene, active, *box_rays(LANES, rs))
    o_s, d_s, tmax_s, act_s = main_path_order(scene, active,
                                              *shadow_rays(LANES, rs))
    log(f"[kernel] tables: {pt.n_chunks} chunks of {pt.chunk}, "
        f"{scene.geometry.num_tris} triangles, {LANES} rays, "
        f"{-(-LANES // tv._auto_rb(pt))} blocks of {tv._auto_rb(pt)}")
    closest = [check_closest("camera", pt, o_c, d_c, float("inf"), None),
               check_closest("in-box", pt, o_b, d_b, float("inf"), act_b)]
    anyhit = [check_any("shadow", pt, o_s, d_s, tmax_s, act_s),
              check_any("in-box", pt, o_b, d_b, 0.7, None)]
    # The main path's casts are mostly bounce and shadow rays: the in-box
    # closest-hit and the shadow any-hit sets give the reported times.
    out = {"closest_hit": dict(closest[1]), "any_hit": dict(anyhit[0])}
    out["closest_hit"]["max_abs_err"] = max(c["max_abs_err"]
                                            for c in closest)
    out["any_hit"]["max_abs_err"] = max(a["max_abs_err"] for a in anyhit)
    return out


# ---------------------------------------------------------------------------
# Phases 4-6: the main path, its profile, and the card against the CPU
# ---------------------------------------------------------------------------

def ascii_view(img, cols=48) -> str:
    lum = luminance(develop(img, device=img.device)).cpu().numpy()
    h, w = lum.shape
    step = max(w // cols, 1)
    rows = []
    for y in range(0, h, 2 * step):
        rows.append("".join(" .:-=+*#%@"[min(int(lum[y, x] * 10), 9)]
                            for x in range(0, w, step)))
    return "\n".join(rows)


def phase_main_path(scene) -> dict:
    render_wavefront(scene, 128, 96, spp=1, seed=SEED, max_depth=DEPTH)
    torch.cuda.synchronize()
    tv.reset_launches()
    t0 = time.perf_counter()
    img, iters = render_wavefront(scene, WIDTH, HEIGHT, spp=SPP, seed=SEED,
                                  max_depth=DEPTH, return_iters=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tv.LAUNCHES)
    lanes = min(WIDTH * HEIGHT, LANES)
    ksps = WIDTH * HEIGHT * SPP / secs / 1e3
    mrays = 2 * lanes * iters / secs / 1e6
    mean = float(img.mean())
    neg = float((img < 0).float().mean())
    log(f"[main] {WIDTH}x{HEIGHT} spp {SPP} depth {DEPTH} spectral Cornell: "
        f"{secs:.3f} s, {ksps:.1f} ksamples/s, {mrays:.2f} Mrays/s, "
        f"{iters} iterations, {lanes} lanes, launches {launches}, "
        f"image mean {mean:.5f}, negative values {neg:.5f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(ascii_view(img))
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(
            torch.isfinite(img).all()):
        raise AssertionError("main path image is not finite or has the "
                             "wrong shape")
    # Spectral strata -> sRGB gives negative channels on noisy pixels (the
    # reference does the same); the developed image must still be sane.
    if not (mean > 0.0 and neg < 0.05):
        raise AssertionError(f"implausible image: mean {mean}, negative "
                             f"share {neg}")
    if launches != {"closest_hit": iters, "any_hit": iters}:
        raise AssertionError(f"launch counts {launches} != {iters} "
                             f"iterations for each kernel")
    return dict(seconds=secs, ksamples_per_s=ksps, mrays_per_s=mrays,
                iterations=iters, lanes=lanes, mean=mean, launches=launches)


def phase_profile(scene) -> None:
    """Where the main path's time goes: one 256x192 (= 49,152 lanes) spp 1
    render under torch.profiler. Reports launches per iteration, the
    device's busy share and the traversal kernels' share of device time."""
    kw = dict(spp=1, seed=SEED, max_depth=DEPTH, return_iters=True)
    t0 = time.perf_counter()
    _, iters = render_wavefront(scene, 256, 192, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        render_wavefront(scene, 256, 192, **kw)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    if not dev or busy <= 0.0:
        raise AssertionError("the profiler recorded no device time")
    by_name = {}
    for e in dev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.self_device_time_total)
    syncs = sum(e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize")
                for e in prof.events())
    log(f"[profile] 256x192 spp 1: {iters} iterations, {wall:.3f} s "
        f"({wall / iters * 1e3:.2f} ms per iteration) unprofiled, "
        f"{pwall:.3f} s profiled; {len(dev) / iters:.0f} device ops and "
        f"{syncs / iters:.1f} host syncs per iteration; device busy "
        f"{busy:.3f} s = {busy / wall:.3f} of the unprofiled wall time")
    for kname in ("closest_hit_kernel", "any_hit_kernel"):
        n, us = next(v for k, v in by_name.items() if kname in k)
        log(f"[profile] {kname}: {n} launches, {us / n / 1e3:.4f} ms each, "
            f"{us / 1e6 / busy:.3f} of device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (n, us) in top:
        log(f"[profile]   {us / 1e3:9.3f} ms in {n:6d} launches: {name[:90]}")


def phase_cross_check(scene, main_mean: float) -> None:
    kw = dict(spp=SPP, seed=SEED, max_depth=DEPTH, return_iters=True)
    t0 = time.perf_counter()
    gpu, it_gpu = render_wavefront(scene, CHECK_W, CHECK_H, **kw)
    gpu = gpu.cpu().numpy()
    t1 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    cpu, it_cpu = render_wavefront(scene.to("cpu"), CHECK_W, CHECK_H,
                                   device="cpu", **kw)
    cpu = cpu.numpy()
    t2 = time.perf_counter()
    # The criterion of tests/test_torch_wavefront.py: a path whose decision
    # flips on rounding (libm differs between card and host, and the
    # film's atomics reorder sums) differs from there on; >= 98% of pixels
    # within rtol 1e-3 and the image means within 1%.
    close = (np.abs(gpu - cpu) <= 1e-3 * np.abs(cpu) + 1e-6).all(-1).mean()
    rel = abs(gpu.mean() / cpu.mean() - 1.0)
    log(f"[check] {CHECK_W}x{CHECK_H} spp {SPP} depth {DEPTH}: card "
        f"{t1 - t0:.2f} s ({it_gpu} iterations), CPU {t2 - t1:.2f} s "
        f"({it_cpu} iterations); pixels within rtol 1e-3 {close:.6f}, "
        f"means {gpu.mean():.6f} / {cpu.mean():.6f} (rel {rel:.2e}); "
        f"full-size mean {main_mean:.6f}")
    if close < 0.98 or rel >= 0.01 or abs(it_gpu - it_cpu) > 2:
        raise AssertionError("the card's render disagrees with the CPU's")
    # Both sizes estimate the same image plane, but caustic paths through
    # the glass sphere make the 4-spp mean of a small image noisy: a loose
    # plausibility bound.
    if not abs(main_mean / cpu.mean() - 1.0) < 0.35:
        raise AssertionError("the full-size image mean is implausible next "
                             "to the small render's")


def main() -> None:
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    t0 = time.perf_counter()
    scene = cornell_box_spheres(spectral=True)
    log(f"[scene] spectral Cornell box built on {scene.device} in "
        f"{time.perf_counter() - t0:.2f} s: {scene.geometry.num_tris} "
        f"triangles, lobe kinds {scene.lobe_kinds_present}")
    timings = phase_kernels(scene)
    main_path = phase_main_path(scene)
    phase_profile(scene)
    phase_cross_check(scene, main_path["mean"])
    kernels = []
    for name in ("closest_hit", "any_hit"):
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE,
            replaces=REPLACES[name], launches=main_path["launches"][name],
            library_ms=None, **timings[name]))
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
