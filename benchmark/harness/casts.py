"""The casts' roofline: the program's public cast entry points timed on the
benchmark's ray sets, against the least time the reckoner's work needs."""
from __future__ import annotations

import torch

from . import peaks, reckoner
from .clock import median_ms


def reference_scene(run):
    """The reference's own load of the cell's scene file (cached)."""
    if "ref_scene" not in run.cache:
        from reference.scene import load

        run.cache["ref_scene"] = load(run.kept["scene_path"], run.device)
    return run.cache["ref_scene"]


def roofline_pct(run, kind: str, n_rays: int) -> float | None:
    """100 x least time / measured time of one cast of `n_rays` rays:
    `scene_intersect` (kind "closest") or `scene_occluded` ("any"),
    prepare_cast included; median of CUDA-event timings after a warm-up."""
    scene = run.state.get("scene")
    if scene is None or torch.device(run.device).type != "cuda":
        return None
    from slr_tpu_torch.render import pt as ppt

    ref = reference_scene(run)
    key = ("rays", n_rays)
    if key not in run.cache:
        run.cache[key] = reckoner.ray_sets(ref.p, ref.lights, n_rays,
                                           run.generator(salt=7))
    o, d, tmin, tmax = run.cache[key][kind]
    if kind == "closest":
        ms = median_ms(lambda: ppt.scene_intersect(scene, o, d, tmin, tmax))
        tests = reckoner.closest_tests(ref.p, o, d, tmin, tmax)
    else:
        ms = median_ms(lambda: ppt.scene_occluded(scene, o, d, tmin, tmax))
        tests = reckoner.any_tests(ref.p, o, d, tmin, tmax)
    n_tests = int(tests.sum())
    nbytes = reckoner.cast_bytes(kind, n_rays, ref.p.shape[0])
    least = peaks.least_seconds(nbytes, n_tests * peaks.OPS_PER_TEST[kind])
    run.counters[f"cast.{kind}"] = dict(ms=ms, tests=n_tests, bytes=nbytes,
                                        least_ms=least * 1e3)
    return 100.0 * least * 1e3 / ms
