"""Command line: render a scene file (counterpart of slr_tpu/__main__.py).

    python -m slr_tpu_torch <scene.txt> [--spp N] [--out DIR] [--spectral]
                            [--width W] [--height H] [--max-depth D]
                            [--renderer pt|debug] [--format png|bmp]
                            [--resume] [--check] [--profile DIR] [--cpu] [-v]

Renders progressive power-of-two exports (000.png, 001.png, ... at 1, 2,
4, ... spp) of the Kahan-summed film, scaled by the scene's brightness, and
after each export a checkpoint (`checkpoint.npz`) that `--resume` continues
from. Runs on the CUDA device, or raises without one; `--cpu` runs the
plain PyTorch versions on the host. The path tracer is `render_wavefront`.
The debug renderer (`--renderer debug`) writes the first hit's geometric
normal, shading normal, shading tangent and distance instead (gnormal,
snormal, stangent, distance), normals and tangents encoded as 0.5 n + 0.5
and distance over its largest value. The BPT and photon-mapping renderers
and scene sharding are not ported yet.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

# Renderers and options of the reference CLI that wait for their ROADMAP item.
_UNPORTED = {"bpt": "A14", "sppm": "A15", "amcmcppm": "A15"}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="slr_tpu_torch")
    ap.add_argument("scene", help="scene description file (SLR DSL)")
    ap.add_argument("--spp", type=int, default=None,
                    help="override sample count (default: from the scene file)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--spectral", action="store_true",
                    help="full spectral rendering (default RGB)")
    ap.add_argument("--renderer",
                    choices=("pt", "bpt", "debug", "sppm", "amcmcppm"),
                    default=None, help="override the scene's renderer "
                    "(pt and debug are ported)")
    ap.add_argument("--format", choices=("png", "bmp"), default="png",
                    help="image output format (bmp matches the reference)")
    ap.add_argument("--max-depth", type=int, default=100,
                    help="path cap; the reference path tracer caps at 100 "
                    "with Russian roulette")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--scene-shard", action="store_true",
                    help="partition the scene across devices (not ported)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the first pass to DIR")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="log build and render stats (SBVH, iterations, ...)")
    ap.add_argument("--check", action="store_true",
                    help="raise if the film holds a non-finite or negative "
                    "texel after a pass")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the checkpoint in --out (film and "
                    "sample counter)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI on `argv` (default: the process's arguments). Returns
    what it did: load seconds, lanes, and per pass (spp, seconds,
    iterations)."""
    args = _parser().parse_args(argv)
    if args.verbose:
        logging.basicConfig(level=logging.INFO, format="%(message)s")
        logging.getLogger("slr_tpu_torch").setLevel(logging.INFO)
    if args.scene_shard:
        raise NotImplementedError(
            "--scene-shard is not ported to slr_tpu_torch yet (ROADMAP A16)")
    if args.renderer in _UNPORTED:
        raise NotImplementedError(
            f"the {args.renderer} renderer is not ported to slr_tpu_torch yet "
            f"(ROADMAP {_UNPORTED[args.renderer]})")

    import numpy as np

    from .core.device import resolve_device
    from .render.film import develop, kahan_add, save_bmp, save_png
    from .render.wavefront import DEFAULT_LANE_CAP, render_wavefront
    from .scene.api import load_scene
    from .utils.checkpoint import load_checkpoint, save_checkpoint
    from .utils.metrics import RenderMeter, profile_trace

    device = resolve_device("cpu" if args.cpu else None)
    ext = args.format
    save_img = save_bmp if args.format == "bmp" else save_png

    t0 = time.perf_counter()
    scene, renderer_cfg, settings = load_scene(args.scene,
                                               spectral=args.spectral,
                                               device=device)
    load_s = time.perf_counter() - t0
    print(f"scene loaded: {scene.geometry.num_tris} tris, "
          f"{scene.materials.num} materials, {scene.lights.num} lights, "
          f"{scene.pallas_tris.n_chunks} chunks ({load_s:.2f}s)")

    width = args.width or settings["width"]
    height = args.height or settings["height"]
    brightness = settings["brightness"]
    method = (args.renderer or renderer_cfg.get("method", "PT")).lower()
    if method == "debug":
        os.makedirs(args.out, exist_ok=True)
        return _write_aovs(scene, width, height, args.out, ext, save_img,
                           device, load_s)
    if method != "pt":
        raise NotImplementedError(
            f"the scene's {method} renderer is not ported to slr_tpu_torch "
            f"yet (ROADMAP {_UNPORTED.get(method, 'A14-A15')})")
    spp = args.spp or int(renderer_cfg.get("samples", 16))
    rng_seed = int(settings.get("rngSeed", 0)) & 0xFFFFFFFF
    os.makedirs(args.out, exist_ok=True)

    ckpt_path = os.path.join(args.out, "checkpoint")
    accum = comp = None         # Kahan-compensated film on the host
    done = 0
    if args.resume:
        state = load_checkpoint(ckpt_path)
        if state is not None:
            accum = np.asarray(state["accum"])
            comp = np.asarray(state.get("comp", np.zeros_like(accum)))
            done = int(state["done"])
            print(f"resumed at {done} samples")
    img_idx = 0
    next_export = 1
    while next_export <= done:
        img_idx += 1
        next_export *= 2

    meter = RenderMeter(width, height, args.max_depth, has_env=scene.has_env)
    passes = []
    t0 = time.perf_counter()
    while done < spp:
        step = min(next_export, spp) - done
        before = meter.seconds
        meter.start()
        with profile_trace(args.profile if not passes else None):
            img, iters = render_wavefront(
                scene, width, height, spp=step, seed=rng_seed,
                max_depth=args.max_depth, sample_offset=done,
                return_iters=True, device=device)
            img = img.cpu().numpy()
        meter.stop(step)
        passes.append((step, meter.seconds - before, iters))
        if args.check:
            bad = ~np.isfinite(img) | (img < 0.0)
            if bad.any():
                raise RuntimeError(
                    f"--check: {int(bad.sum())} non-finite/negative film "
                    f"texels after pass at {done}+{step} spp")
        if accum is None:
            accum = np.zeros_like(img)
            comp = np.zeros_like(img)
        accum, comp = kahan_add(accum, comp, img * step)
        done += step
        out = os.path.join(args.out, f"{img_idx:03d}.{ext}")
        save_img(out, develop((accum + comp) / done, brightness,
                              device="cpu"))
        save_checkpoint(ckpt_path, {"accum": accum, "comp": comp,
                                    "done": done})
        print(f"{done} samples: {out}, {time.perf_counter() - t0:.1f}s "
              f"[{meter.mrays_per_s:.2f} Mrays/s]"
              + (f", {iters} iterations" if args.verbose else ""))
        img_idx += 1
        next_export *= 2
    print(meter.report())
    lanes = min(width * height, DEFAULT_LANE_CAP)
    if args.verbose and passes:
        # What the passes did, as against the meter's nominal casts: one
        # closest-hit and one shadow cast per lane per iteration.
        secs = sum(p[1] for p in passes)
        iters = sum(p[2] for p in passes)
        print(f"{sum(p[0] for p in passes)} spp in {len(passes)} passes: "
              f"{secs:.3f} s, {iters} iterations, "
              f"{width * height * sum(p[0] for p in passes) / secs / 1e3:.1f}"
              f" ksamples/s, {2 * lanes * iters / secs / 1e6:.3f} Mrays/s "
              f"cast (2 x {lanes} lanes x iterations)")
    return dict(load_seconds=load_s, width=width, height=height, spp=done,
                lanes=lanes, passes=passes)


def _write_aovs(scene, width, height, out, ext, save_img, device,
                load_s) -> dict:
    """The debug renderer's four images, encoded as the reference's CLI
    encodes them."""
    import numpy as np

    from .render.debug import render_aovs

    t0 = time.perf_counter()
    aov = render_aovs(scene, width, height, device=device)
    aov = type(aov)(*(x.cpu().numpy() for x in aov))
    seconds = time.perf_counter() - t0
    files = []
    for name, x in (("gnormal", aov.g_normal), ("snormal", aov.s_normal),
                    ("stangent", aov.s_tangent)):
        files.append(os.path.join(out, f"{name}.{ext}"))
        save_img(files[-1], x * 0.5 + 0.5)
    dist = aov.distance
    dmax = dist.max() or 1.0
    files.append(os.path.join(out, f"distance.{ext}"))
    save_img(files[-1], np.repeat((dist / dmax)[..., None], 3, axis=-1))
    print(f"AOVs written to {out} ({seconds:.2f}s)")
    return dict(load_seconds=load_s, width=width, height=height,
                seconds=seconds, files=files)


if __name__ == "__main__":
    main()
