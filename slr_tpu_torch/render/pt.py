"""Scene casts, light selection and the ray sort key of the path tracer
(counterpart of the parts of slr_tpu/render/pt.py the wavefront renderer
uses).

Both casts go through the worklist traversal of accel/traverse.py: the
hand-written kernels on the card, their plain versions on the CPU. A scene
with instances passes each ray's shutter fraction `f` to the casts, whose
kernels take the ray into an instance's space themselves. In a scene with
alpha cutouts a hit whose alpha texture is 0 is cast past again (closest
hit, per-ray tmin, only the cut rays active) until no ray stops on a cut
texel, and shadow rays take the same closest-hit path instead of any hit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..accel.intersect import RAY_EPSILON, Hit, fetch_tri_row, resolve_surface_point
from ..accel.traverse import T_FAR, anyhit_pallas, intersect_pallas, nearest_super_tn
from ..core.math3d import cross, normalize
from ..core.sampling import sample_discrete_1d
from ..core.transform import trs_apply_normal, trs_apply_vector, trs_at
from ..scene.textures import eval_float_texture, eval_normal_texture, eval_stex, perturb_frame
from ..scene.types import FlatScene

Tensor = torch.Tensor


# Alpha recasts since the last reset: `casts` counts the recast loop's
# closest-hit casts, `rays` the cut rays they carried.
ALPHA_RECASTS = {"casts": 0, "rays": 0}


def reset_alpha_recasts() -> None:
    for k in ALPHA_RECASTS:
        ALPHA_RECASTS[k] = 0


def _shutter(o: Tensor, f) -> Tensor:
    """Per-ray shutter fraction; the shutter's opening when none is given."""
    if f is None:
        return torch.zeros(o.shape[:1], dtype=torch.float32, device=o.device)
    return f


def scene_intersect(scene: FlatScene, o: Tensor, d: Tensor,
                    tmin=RAY_EPSILON, tmax=float("inf"), f=None,
                    active: Tensor | None = None) -> Hit:
    """Closest hit against the scene's chunk tables: one traversal covers
    the static triangles and, at shutter fraction `f`, the instances."""
    if scene.instances is None:
        return intersect_pallas(scene.geometry, scene.pallas_tris, o, d, tmin,
                                tmax, active=active)
    return intersect_pallas(scene.geometry, scene.pallas_tris, o, d, tmin,
                            tmax, active=active, f=_shutter(o, f),
                            instances=scene.instances)


def scene_intersect_alpha(scene: FlatScene, o: Tensor, d: Tensor,
                          tmin=RAY_EPSILON, tmax=float("inf"), f=None,
                          active: Tensor | None = None) -> Hit:
    """Closest hit honoring alpha cutouts: hits whose alpha texture is 0
    are cast past, with tmin just beyond them and only the cut rays
    active, until none is left. The loop has no cap, as in the reference;
    each round costs one host sync. tmin advances from the cast's own t,
    not from the Möller-Trumbore t of the hit: on grazing rays the two
    differ by more than RAY_EPSILON, and a recast from the latter finds
    the same triangle again, forever (the reference's loop does)."""
    hit = scene_intersect(scene, o, d, tmin, tmax, f, active=active)
    if not scene.has_alpha:
        return hit
    tmin_b = torch.broadcast_to(
        torch.as_tensor(tmin, dtype=torch.float32, device=o.device),
        hit.t.shape)
    while True:
        cut = _alpha_zero(scene, hit)
        n_cut = int(cut.sum())
        if n_cut == 0:
            return hit
        ALPHA_RECASTS["casts"] += 1
        ALPHA_RECASTS["rays"] += n_cut
        tmin_b = torch.where(cut, hit.t_cast + RAY_EPSILON, tmin_b)
        rehit = scene_intersect(scene, o, d, tmin_b, tmax, f, active=cut)
        hit = Hit(*(None if h is None else torch.where(cut, r, h)
                    for h, r in zip(hit, rehit)))


def _alpha_zero(scene: FlatScene, h: Hit) -> Tensor:
    """Hits on a texel whose alpha texture evaluates to exactly 0."""
    row = fetch_tri_row(scene.geometry.tri_table, torch.clamp(h.tri, min=0))
    b2 = (1.0 - h.b0 - h.b1)[..., None]
    uv = h.b0[..., None] * row.uv0 + h.b1[..., None] * row.uv1 + b2 * row.uv2
    a = eval_float_texture(scene.ftex, row.alpha_id, uv, scene.stex.images,
                           scene.stex.image_hw)
    return h.mask & (row.alpha_id >= 0) & (a == 0.0)


def resolve_sp(scene: FlatScene, hit: Hit, o: Tensor, d: Tensor, f=None):
    """Surface-point resolution at the hits. A hit on an instance has its
    shading frame brought from the instance's local space to world space at
    the ray's shutter fraction; its position is world-space already (o + d*t
    with a world-parameter t). A normal map then perturbs the frame."""
    sp = resolve_surface_point(scene.geometry, hit, o, d)
    if scene.instances is not None and hit.inst is not None:
        sp = _instance_frame(scene, hit, sp, o, f)
    if scene.has_normal_map:
        ntex_id = scene.geometry.tri_ntex.to(torch.int64)[
            torch.clamp(hit.tri, min=0)]
        sp = perturb_frame(sp, eval_normal_texture(
            scene.ntex, scene.stex.images, scene.stex.image_hw, ntex_id,
            sp.uv))
    return sp


def _instance_frame(scene: FlatScene, hit: Hit, sp, o: Tensor, f):
    """The shading frame of hits on instances, in world space."""
    inst = scene.instances
    i = torch.clamp(hit.inst, min=0)
    T, R, S = trs_at(inst.t0_T[i], inst.t0_R[i], inst.t0_S[i],
                     inst.t1_T[i], inst.t1_R[i], inst.t1_S[i],
                     _shutter(o, f))
    on_inst = (hit.inst >= 0)[..., None]
    gn_w = normalize(trs_apply_normal(T, R, S, sp.gn))
    sn_w = normalize(trs_apply_normal(T, R, S, sp.sn))
    tan_w = normalize(trs_apply_vector(T, R, S, sp.tangent))
    return sp._replace(
        gn=torch.where(on_inst, gn_w, sp.gn),
        sn=torch.where(on_inst, sn_w, sp.sn),
        tangent=torch.where(on_inst, tan_w, sp.tangent),
        bitangent=torch.where(on_inst, cross(sn_w, tan_w), sp.bitangent))


def scene_occluded(scene: FlatScene, o: Tensor, d: Tensor, tmin, tmax,
                   f=None, active: Tensor | None = None) -> Tensor:
    """Occlusion-only query (bool per ray) through the any-hit traversal;
    in a scene with alpha cutouts through closest hit and its recasts, so
    that a cut-out surface casts no shadow."""
    if scene.has_alpha:
        return scene_intersect_alpha(scene, o, d, tmin, tmax, f=f,
                                     active=active).mask
    f_ = _shutter(o, f) if scene.instances is not None else None
    return anyhit_pallas(scene.geometry, scene.pallas_tris, o, d, tmin, tmax,
                         active=active, f=f_)


def _env_direction(phi: Tensor, theta: Tensor) -> Tensor:
    """(phi, theta) -> world direction (-sin phi sin theta, cos theta,
    cos phi sin theta)."""
    st = torch.sin(theta)
    return torch.stack([-torch.sin(phi) * st, torch.cos(theta),
                        torch.cos(phi) * st], dim=-1)


def _env_uv_from_direction(d: Tensor) -> tuple[Tensor, Tensor]:
    """Direction -> equirectangular (u, v) in [0, 1)^2."""
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(-d[..., 0], d[..., 2])
    phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
    return phi / (2 * math.pi), theta / math.pi


def _env_radiance(scene: FlatScene, u: Tensor, v: Tensor,
                  lambdas: Tensor | None) -> Tensor:
    """Le of the environment at (u, v): its texture x scale."""
    tex_id = torch.broadcast_to(scene.env.stex.to(torch.int64), u.shape)
    return eval_stex(scene.stex, tex_id, torch.stack([u, v], dim=-1),
                     lambdas) * scene.env.scale


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
