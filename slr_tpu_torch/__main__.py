"""Command line: render a scene file (counterpart of slr_tpu/__main__.py).

    python -m slr_tpu_torch <scene.txt> [--spp N] [--out DIR] [--spectral]
                            [--width W] [--height H] [--max-depth D]
                            [--renderer pt|bpt|debug|sppm|amcmcppm]
                            [--format png|bmp] [--resume] [--check]
                            [--profile DIR] [--cpu] [-v]

The path tracer (`render_wavefront`) and the bidirectional path tracer
(`render_bpt`) render progressive power-of-two exports (000.png, 001.png,
... at 1, 2, 4, ... spp) of the Kahan-summed film, scaled by the scene's
brightness, and after each export a checkpoint (`checkpoint.npz`) that
`--resume` continues from. The photon mappers (`sppm`, and `amcmcppm` with
its MCMC photon chains) run `--spp` progressive waves of 32,768 photon paths
each and write `ppm.<format>`. The debug renderer (`--renderer debug`)
writes the first hit's geometric normal, shading normal, shading tangent
and distance instead (gnormal, snormal, stangent, distance), normals and
tangents encoded as 0.5 n + 0.5 and distance over its largest value.
Without `--renderer` the scene file's method decides. Runs on the CUDA
device, or raises without one; `--cpu` runs the plain PyTorch versions on
the host.

Under torchrun (`torchrun --nproc_per_node N -m slr_tpu_torch ...`) the
ranks join one process group (NCCL on CUDA, gloo with `--cpu`) and `pt`
renders across them through `render_wavefront_sharded`; `--scene-shard`
renders `pt` with the scene's chunk tables, shading rows and image atlas
split by range over the ranks (`render_pt_scene_sharded`, the fixed-depth
tracer at depth min(--max-depth, 16)), at any world size, one included.
`bpt`, `debug`, `sppm` and `amcmcppm` run on rank 0 alone while the others
wait. Only rank 0 writes exports and checkpoints.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

_RENDERERS = ("pt", "bpt", "debug", "sppm", "amcmcppm")
# Photon paths per progressive photon-mapping wave, as the reference CLI.
PPM_PHOTON_PATHS = 1 << 15


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
                    choices=_RENDERERS, default=None,
                    help="override the scene's renderer (sppm/amcmcppm: "
                    "progressive photon mapping)")
    ap.add_argument("--format", choices=("png", "bmp"), default="png",
                    help="image output format (bmp matches the reference)")
    ap.add_argument("--max-depth", type=int, default=100,
                    help="path cap; the reference path tracer caps at 100 "
                    "with Russian roulette")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--scene-shard", action="store_true",
                    help="pt only: split the scene's chunk tables, shading "
                    "rows and images by range over the ranks (fixed-depth "
                    "tracer, depth <= 16)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the first pass, "
                    "with the program's spans as a host track, to DIR "
                    "(with -v also print the pass's spans by phase)")
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
    what it did: load seconds, and per pass (spp, seconds, iterations); for
    `bpt` a pass's third item is its `bpt_batch` calls, base and deep, and
    `deep_passes` counts the deep ones; under `--scene-shard` its render
    batches. Under torchrun, joins the process group first (and leaves it
    at the end); a rank that only waited returns its rank and world."""
    from .parallel.distributed import init_distributed, shutdown

    args = _parser().parse_args(argv)
    if args.verbose:
        logging.basicConfig(level=logging.INFO, format="%(message)s")
        logging.getLogger("slr_tpu_torch").setLevel(logging.INFO)
    joined = init_distributed(device="cpu" if args.cpu else None)
    try:
        return _main(args)
    finally:
        if joined:
            shutdown()


def _main(args) -> dict:
    from .parallel.mesh import make_mesh
    from .render.film import save_bmp, save_png
    from .scene.api import load_scene

    mesh = make_mesh("cpu" if args.cpu else None)
    device = mesh.device
    rank0 = mesh.rank == 0
    ext = args.format
    save_img = save_bmp if args.format == "bmp" else save_png

    t0 = time.perf_counter()
    # A sharded scene is loaded on the host: each rank moves only its
    # ranges onto its device.
    scene, renderer_cfg, settings = load_scene(
        args.scene, spectral=args.spectral,
        device="cpu" if args.scene_shard else device)
    load_s = time.perf_counter() - t0
    if rank0:
        print(f"scene loaded: {scene.geometry.num_tris} tris, "
              f"{scene.materials.num} materials, {scene.lights.num} lights, "
              f"{scene.pallas_tris.n_chunks} chunks ({load_s:.2f}s)")

    width = args.width or settings["width"]
    height = args.height or settings["height"]
    brightness = settings["brightness"]
    method = (args.renderer or renderer_cfg.get("method", "PT")).lower()
    if method not in _RENDERERS:
        raise ValueError(f"the scene's renderer {method!r} is none of "
                         f"{_RENDERERS}")
    if args.scene_shard and method != "pt":
        raise ValueError(f"--scene-shard renders the pt renderer, not "
                         f"{method}")
    spp = args.spp or int(renderer_cfg.get("samples", 16))
    rng_seed = int(settings.get("rngSeed", 0)) & 0xFFFFFFFF
    if method != "pt":
        # One device renders these, as in the reference; the other ranks
        # wait for rank 0.
        if not rank0:
            mesh.barrier()
            return dict(rank=mesh.rank, world=mesh.size, waited=method)
        os.makedirs(args.out, exist_ok=True)
        if method == "debug":
            result = _write_aovs(scene, width, height, args.out, ext,
                                 save_img, device, load_s)
        elif method in ("sppm", "amcmcppm"):
            result = _render_ppm(scene, method, width, height, spp,
                                 rng_seed, args, save_img, brightness,
                                 device, load_s)
        else:
            result = _render_passes(args, scene, method, width, height, spp,
                                    rng_seed, save_img, brightness, mesh,
                                    load_s)
        mesh.barrier()
        return result
    if rank0:
        os.makedirs(args.out, exist_ok=True)
    return _render_passes(args, scene, method, width, height, spp, rng_seed,
                          save_img, brightness, mesh, load_s)


def _ksamples_per_s(passes, width: int, height: int) -> float:
    """Thousands of pixel samples a second over the passes' own wall
    time; a pass is (spp, seconds, ...)."""
    secs = sum(p[1] for p in passes)
    return width * height * sum(p[0] for p in passes) / max(secs, 1e-9) / 1e3


def _render_passes(args, scene, method, width, height, spp, rng_seed,
                   save_img, brightness, mesh, load_s) -> dict:
    """`pt` and `bpt`: progressive power-of-two passes, an export and a
    checkpoint after each (rank 0 writes them)."""
    import numpy as np

    from .accel import traverse as tv
    from .parallel import mesh as pmesh
    from .render import bpt
    from .render import pt as fixed
    from .render.film import develop, kahan_add
    from .render.wavefront import DEFAULT_LANE_CAP, render_wavefront
    from .utils.checkpoint import load_checkpoint, save_checkpoint
    from .utils.metrics import phase_table, profile_trace

    device = mesh.device
    rank0 = mesh.rank == 0
    ext = args.format
    target = scene
    shard_depth = min(args.max_depth, 16)
    n_batches = -(-width * height // min(width * height, 65536))
    if args.scene_shard:
        from .parallel.scene_shard import render_pt_scene_sharded, shard_scene

        # Instanced scenes do not shard by range and render replicated.
        target = (shard_scene(scene, mesh) if scene.instances is None
                  else scene.to(device))

    def render_pass(step: int, offset: int):
        """(image on the host, iterations, bpt_batch calls or render
        batches)."""
        if args.scene_shard:
            img = render_pt_scene_sharded(
                target, mesh, width, height, spp=step, seed=rng_seed,
                sample_offset=offset, max_depth=shard_depth)
            return img.cpu().numpy(), step * n_batches
        if method == "bpt":
            before = dict(bpt.TIERS)
            img = bpt.render_bpt(scene, width, height, spp=step,
                                 seed=rng_seed, sample_offset=offset,
                                 device=device)
            deep = bpt.TIERS["deep_passes"] - before["deep_passes"]
            return img.cpu().numpy(), step * n_batches + deep
        if mesh.size > 1:
            img, iters = pmesh.render_wavefront_sharded(
                scene, width, height, spp=step, mesh=mesh, seed=rng_seed,
                max_depth=args.max_depth, sample_offset=offset,
                return_iters=True)
            return img.cpu().numpy(), iters
        img, iters = render_wavefront(
            scene, width, height, spp=step, seed=rng_seed,
            max_depth=args.max_depth, sample_offset=offset,
            return_iters=True, device=device)
        return img.cpu().numpy(), iters

    ckpt_path = os.path.join(args.out, "checkpoint")
    accum = comp = None         # Kahan-compensated film on the host
    done = 0
    if args.resume:
        state = load_checkpoint(ckpt_path)
        if state is not None:
            accum = np.asarray(state["accum"])
            comp = np.asarray(state.get("comp", np.zeros_like(accum)))
            done = int(state["done"])
            if rank0:
                print(f"resumed at {done} samples")
    img_idx = 0
    next_export = 1
    while next_export <= done:
        img_idx += 1
        next_export *= 2

    passes = []
    bpt.reset_tiers()
    counts0 = (dict(tv.LAUNCHES), dict(fixed.ALPHA_RECASTS),
               dict(pmesh.COLLECTIVES))
    t0 = time.perf_counter()
    while done < spp:
        step = min(next_export, spp) - done
        t_pass = time.perf_counter()
        with profile_trace(args.profile if not passes and rank0
                           else None) as phases:
            img, iters = render_pass(step, done)
        passes.append((step, time.perf_counter() - t_pass, iters))
        if args.verbose and phases:
            print(phase_table(phases))
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
        if rank0:
            save_img(out, develop((accum + comp) / done, brightness,
                                  device="cpu"))
            save_checkpoint(ckpt_path, {"accum": accum, "comp": comp,
                                        "done": done})
            unit = ("batches" if method == "bpt" or args.scene_shard
                    else "iterations")
            print(f"{done} samples: {out}, {time.perf_counter() - t0:.1f}s "
                  f"[{_ksamples_per_s(passes, width, height):.4g} "
                  f"ksamples/s]"
                  + (f", {iters} {unit}" if args.verbose else ""))
        img_idx += 1
        next_export *= 2
    counts = dict(
        launches={k: v - counts0[0][k] for k, v in tv.LAUNCHES.items()},
        alpha_recasts=fixed.ALPHA_RECASTS["casts"] - counts0[1]["casts"],
        collectives=pmesh.COLLECTIVES["calls"] - counts0[2]["calls"],
        collective_bytes=pmesh.COLLECTIVES["bytes"] - counts0[2]["bytes"])
    if not rank0:
        return dict(rank=mesh.rank, world=mesh.size, spp=done,
                    passes=passes, **counts)
    secs = sum(p[1] for p in passes)
    print(f"{sum(p[0] for p in passes)} spp in {secs:.2f} s of passes: "
          f"{_ksamples_per_s(passes, width, height):.4g} ksamples/s")
    if args.verbose and (mesh.size > 1 or args.scene_shard):
        import torch

        peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if device.type == "cuda" else float("nan"))
        print(f"rank 0 of {mesh.size}: kernel launches {counts['launches']}"
              f", alpha recasts {counts['alpha_recasts']}, collectives "
              f"{counts['collectives']} ({counts['collective_bytes']} B), "
              f"peak {peak:.3f} GiB")
    lanes = min(width * height, DEFAULT_LANE_CAP)
    if method == "bpt":
        if args.verbose and passes:
            print(f"lanes clipped at the base cap {bpt.TIERS['clipped']} "
                  f"of {bpt.TIERS['base_lanes']}, deep passes "
                  f"{bpt.TIERS['deep_passes']} of {bpt.TIERS['deep_lanes']}"
                  f" lanes")
        return dict(load_seconds=load_s, width=width, height=height, spp=done,
                    passes=passes, deep_passes=bpt.TIERS["deep_passes"],
                    tiers=dict(bpt.TIERS), world=mesh.size, **counts)
    if args.verbose and passes and args.scene_shard:
        print(f"{sum(p[2] for p in passes)} render batches of depth "
              f"{shard_depth} in {len(passes)} passes")
    elif args.verbose and passes:
        print(f"{sum(p[2] for p in passes)} iterations of {lanes} lanes in "
              f"{len(passes)} passes")
    return dict(load_seconds=load_s, width=width, height=height, spp=done,
                lanes=lanes, passes=passes, world=mesh.size, **counts)


def _render_ppm(scene, method, width, height, waves, rng_seed, args,
                save_img, brightness, device, load_s) -> dict:
    """SPPM or AMCMC-PPM: `waves` progressive passes of PPM_PHOTON_PATHS
    photon paths (twice that with the chains of amcmcppm), bounces capped
    at --max-depth."""
    import numpy as np

    from .render.film import develop
    from .render.ppm import render_ppm
    from .utils.metrics import profile_trace

    if scene.stex.spectral:
        raise ValueError(f"the {method} renderer is RGB only: render the "
                         f"scene without --spectral")
    t0 = time.perf_counter()
    with profile_trace(args.profile):
        img, state = render_ppm(
            scene, width, height, n_iterations=max(waves, 1),
            n_photon_paths=PPM_PHOTON_PATHS, max_bounces=args.max_depth,
            seed=rng_seed, use_mcmc=(method == "amcmcppm"), device=device,
            return_state=True)
        img = img.cpu().numpy()
    seconds = time.perf_counter() - t0
    if args.check:
        bad = ~np.isfinite(img) | (img < 0.0)
        if bad.any():
            raise RuntimeError(f"--check: {int(bad.sum())} non-finite/"
                               f"negative texels in the {method} image")
    out = os.path.join(args.out, f"ppm.{args.format}")
    save_img(out, develop(img, brightness, device="cpu"))
    paths = int(state.n_emitted)
    print(f"{method} ({max(waves, 1)} waves x {PPM_PHOTON_PATHS} photon "
          f"paths): {out}, {seconds:.1f}s"
          + (f", {paths / seconds:.0f} photon paths/s" if args.verbose
             else ""))
    return dict(load_seconds=load_s, width=width, height=height,
                waves=max(waves, 1), seconds=seconds, photon_paths=paths,
                n_uniform=float(state.n_uniform),
                n_visible=float(state.n_visible),
                mutation_size=float(state.mutation_size), file=out,
                image=img)


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
