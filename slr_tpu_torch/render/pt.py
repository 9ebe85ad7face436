"""Scene casts, light selection and the ray sort key of the path tracer
(counterpart of the parts of slr_tpu/render/pt.py the wavefront renderer
uses).

Both casts go through the worklist traversal of accel/traverse.py: the
hand-written kernels on the card, their plain versions on the CPU. Alpha
cutouts, normal maps, instancing and the environment light are not ported
yet; scenes that need them raise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..accel.intersect import RAY_EPSILON, Hit, resolve_surface_point
from ..accel.traverse import T_FAR, anyhit_pallas, intersect_pallas, nearest_super_tn
from ..core.sampling import sample_discrete_1d
from ..scene.types import FlatScene

Tensor = torch.Tensor


def _refuse_unported(scene: FlatScene) -> None:
    for flag, what in ((scene.has_alpha, "alpha cutouts"),
                       (scene.has_normal_map, "normal maps"),
                       (scene.has_env, "environment lights"),
                       (scene.instances is not None, "instancing")):
        if flag:
            raise NotImplementedError(f"{what} are not ported yet")


def scene_intersect(scene: FlatScene, o: Tensor, d: Tensor,
                    tmin=RAY_EPSILON, tmax=float("inf"), f=None,
                    active: Tensor | None = None) -> Hit:
    """Closest hit against the scene's chunk tables."""
    _refuse_unported(scene)
    return intersect_pallas(scene.geometry, scene.pallas_tris, o, d, tmin,
                            tmax, active=active)


def scene_intersect_alpha(scene: FlatScene, o: Tensor, d: Tensor,
                          tmin=RAY_EPSILON, tmax=float("inf"), f=None,
                          active: Tensor | None = None) -> Hit:
    """Closest hit honoring alpha cutouts (none in the ported scenes)."""
    return scene_intersect(scene, o, d, tmin, tmax, f, active=active)


def resolve_sp(scene: FlatScene, hit: Hit, o: Tensor, d: Tensor, f=None):
    """Surface-point resolution at the hits."""
    _refuse_unported(scene)
    return resolve_surface_point(scene.geometry, hit, o, d)


def scene_occluded(scene: FlatScene, o: Tensor, d: Tensor, tmin, tmax,
                   f=None, active: Tensor | None = None) -> Tensor:
    """Occlusion-only query (bool per ray) through the any-hit traversal."""
    _refuse_unported(scene)
    return anyhit_pallas(scene.geometry, scene.pallas_tris, o, d, tmin, tmax,
                         active=active)


def _super_boxes(scene: FlatScene) -> Tensor:
    cached = getattr(scene, "_super_boxes_t", None)
    if cached is None or cached.device != scene.device:
        cached = torch.as_tensor(
            np.frombuffer(scene.super_boxes_blob, np.float32).reshape(-1, 8)
            .copy(), device=scene.device)
        scene._super_boxes_t = cached
    return cached


def _ray_sort_key(scene: FlatScene, o: Tensor, d: Tensor, active: Tensor,
                  contact: bool = True) -> Tensor:
    """Coherence key: direction octant (3 bits) + Morton code of the
    quantized estimated contact point (27 bits); inactive lanes key to
    0xFFFFFFFF so they pack into trailing ray blocks. uint32 values are
    held in int64."""
    lo = scene.world_center - scene.world_radius
    ext = torch.clamp(2.0 * scene.world_radius, min=1e-12)
    p_key = o
    if contact and scene.super_boxes_blob is not None:
        tn = nearest_super_tn(o, d, _super_boxes(scene))
        p_key = o + torch.where(tn < T_FAR, tn, 0.0)[:, None] * d
    q = torch.clamp((p_key - lo) / ext * 511.0, 0.0, 511.0).to(torch.int64)

    def expand9(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    morton = ((expand9(q[..., 0]) << 2) | (expand9(q[..., 1]) << 1)
              | expand9(q[..., 2]))
    octant = (((d[..., 0] < 0).to(torch.int64) << 2)
              | ((d[..., 1] < 0).to(torch.int64) << 1)
              | (d[..., 2] < 0).to(torch.int64))
    key = (octant << 27) | morton
    return torch.where(active, key, 0xFFFFFFFF)


def _select_light(scene: FlatScene, u: Tensor):
    """Two-level light pick. Returns (tri (R,), prob (R,), is_env)."""
    env_prob = scene.lights.env_prob
    is_env = u < env_prob
    u_area = torch.clamp((u - env_prob) / torch.clamp(1.0 - env_prob,
                                                       min=1e-12),
                         0.0, 1.0 - 1e-7)
    idx, pmf, _ = sample_discrete_1d(scene.lights.dist, u_area)
    tri = scene.lights.tri_idx.to(torch.int64)[idx]
    prob = torch.where(is_env, env_prob, (1.0 - env_prob) * pmf)
    return tri, prob, is_env


def _area_light_prob(scene: FlatScene) -> Tensor:
    """Probability of picking one given area light."""
    return (1.0 - scene.lights.env_prob) / scene.lights.tri_idx.shape[0]
