"""The path tracer's casts, light selection and ray sort key, and the
fixed-depth differentiable path tracer (counterpart of
slr_tpu/render/pt.py).

Both casts go through the worklist traversal of accel/traverse.py: the
hand-written kernels on the card, their plain versions on the CPU. A scene
with instances passes each ray's shutter fraction `f` to the casts, whose
kernels take the ray into an instance's space themselves. In a scene with
alpha cutouts a hit whose alpha texture is 0 is cast past again (closest
hit, per-ray tmin, only the cut rays active) until no ray stops on a cut
texel, and shadow rays take the same closest-hit path instead of any hit.

`trace_radiance` runs every path of a wavefront for exactly `max_depth`
bounces (NEE with power-heuristic MIS, BSDF sampling, Russian roulette):
the reference's `lax.fori_loop` is a Python loop here, and ended lanes ride
along inactive. `render` / `render_fused` build whole images on it. It is
the differentiable renderer: scene leaves that require grad (texture
values, images, spectral curves) get gradients through torch autograd,
with the sampled directions, their pdfs and the Russian-roulette
probability detached, as the reference stops gradients there. The casts
take detached rays and stay outside the graph: hits are discrete. Its
spans (utils/metrics.py): `pt.camera` (the camera rays' cast and
emission), then one `pt.bounce` a bounce holding the casts' spans,
`pt.sort` and `pt.shade` three times (before the shadow cast, between the
casts, after the closest hit).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..accel.intersect import (
    RAY_EPSILON,
    Hit,
    fetch_tri_row,
    resolve_surface_point,
    sample_triangle_point,
)
from ..accel.traverse import T_FAR, anyhit_pallas, intersect_pallas, nearest_super_tn
from ..bsdf.bsdf import (
    bsdf_evaluate,
    bsdf_has_nondelta,
    bsdf_pdf,
    bsdf_sample,
    emitted_radiance,
    gather_lobes,
    is_emissive,
)
from ..camera.perspective import sample_camera_rays, sample_camera_rays_equirect
from ..core import rng
from ..core.device import resolve_device
from ..core.math3d import cross, dot, frame_from_local, frame_to_local, normalize
from ..core.rng import Decision
from ..core.sampling import (
    pdf_continuous_2d,
    power_heuristic,
    sample_continuous_2d,
    sample_discrete_1d,
)
from ..core.transform import trs_apply_normal, trs_apply_vector, trs_at
from ..scene.textures import eval_float_texture, eval_normal_texture, eval_stex, perturb_frame
from ..scene.types import CameraKind, FlatScene
from ..spectrum.rgb import importance
from ..utils.metrics import span

Tensor = torch.Tensor


# Alpha recasts since the last reset: `casts` counts the recast loop's
# closest-hit casts, `rays` the cut rays they carried.
ALPHA_RECASTS = {"casts": 0, "rays": 0}


def reset_alpha_recasts() -> None:
    for k in ALPHA_RECASTS:
        ALPHA_RECASTS[k] = 0


# What the fixed-depth tracer cast since `track_rays(device)`, counted on
# the device: int64 [closest-hit rays, shadow rays, bounces that began with
# no active lane]; active lanes only. None: not tracked.
RAYS: Tensor | None = None


def track_rays(device=None) -> None:
    """Start (a device) or stop (None) counting into `RAYS`."""
    global RAYS
    RAYS = None if device is None else torch.zeros(3, dtype=torch.int64,
                                                   device=device)


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
    return recast_alpha(
        hit, tmin, lambda h: _alpha_zero(scene, h),
        lambda tmin_b, cut: scene_intersect(scene, o, d, tmin_b, tmax, f,
                                            active=cut))


def recast_alpha(hit: Hit, tmin, alpha_zero, recast) -> Hit:
    """The alpha recast loop: while some hit is on a cut-out texel
    (`alpha_zero(hit)`), cast those rays again (`recast(per-ray tmin, cut
    rays)`) from just beyond the cast's own t, and take the new hits."""
    tmin_b = torch.broadcast_to(
        torch.as_tensor(tmin, dtype=torch.float32, device=hit.t.device),
        hit.t.shape)
    while True:
        cut = alpha_zero(hit)
        n_cut = int(cut.sum())
        if n_cut == 0:
            return hit
        ALPHA_RECASTS["casts"] += 1
        ALPHA_RECASTS["rays"] += n_cut
        tmin_b = torch.where(cut, hit.t_cast + RAY_EPSILON, tmin_b)
        rehit = recast(tmin_b, cut)
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


def test_visibility(scene: FlatScene, p_from: Tensor, p_to: Tensor, f=None,
                    active: Tensor | None = None) -> Tensor:
    """Shadow test between point pairs: True where they see each other."""
    delta = p_to - p_from
    dist = torch.sqrt(torch.clamp(dot(delta, delta), min=1e-40))
    d = delta / torch.clamp(dist, min=1e-20)[..., None]
    return ~scene_occluded(scene, p_from, d, tmin=RAY_EPSILON,
                           tmax=dist * (1.0 - 1e-3), f=f, active=active)


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


# ---------------------------------------------------------------------------
# The fixed-depth path tracer
# ---------------------------------------------------------------------------

class PathState(NamedTuple):
    ray_o: Tensor        # (R, 3)
    ray_d: Tensor        # (R, 3)
    alpha: Tensor        # (R, S) throughput
    radiance: Tensor     # (R, S)
    active: Tensor       # (R,) bool
    hero: Tensor         # (R,) int64 hero channel
    wl_selected: Tensor  # (R,) bool
    prev_pdf: Tensor     # (R,) BSDF pdf of the ray (implicit MIS)
    prev_delta: Tensor   # (R,) bool: the previous bounce was delta
    init_y: Tensor       # (R,) initial importance for Russian roulette


class _Lanes(NamedTuple):
    """Per-lane streams the bounces draw from; a sort permutes them with
    the lanes, and `orig` un-permutes the radiance at the end."""

    pixel_id: Tensor
    sample_id: Tensor
    f_time: Tensor | None
    lambdas: Tensor | None
    orig: Tensor


def _camera_ray(scene: FlatScene, pid: Tensor, sid: Tensor, seed,
                width: int, height: int):
    """The camera ray of sample `sid` of pixel `pid`, jittered in the pixel
    (and on the lens of a perspective camera)."""
    px = (pid % width).to(torch.float32)
    py = (pid // width).to(torch.float32)
    jx = rng.uniform(seed, pid, sid, 0, Decision.PIXEL_X)
    jy = rng.uniform(seed, pid, sid, 0, Decision.PIXEL_Y)
    if scene.camera.kind == CameraKind.EQUIRECTANGULAR:   # no lens randoms
        return sample_camera_rays_equirect(scene.camera, px + jx, py + jy,
                                           width, height)
    lx = rng.uniform(seed, pid, sid, 0, Decision.LENS_U)
    ly = rng.uniform(seed, pid, sid, 0, Decision.LENS_V)
    return sample_camera_rays(scene.camera, px + jx, py + jy, width, height,
                              lx, ly)


def trace_radiance(scene: FlatScene, o: Tensor, d: Tensor, pixel_id: Tensor,
                   sample_id: Tensor, seed, max_depth: int = 16,
                   sort_rays: bool = False) -> Tensor:
    """Radiance (R, S) along a wavefront of camera rays, on the rays'
    device: S = 16 hero-wavelength samples in a spectral scene (see
    `trace_radiance_spectral` for their wavelengths), 3 in an RGB one.
    Random streams are keyed by (seed, pixel_id, sample_id, bounce), so a
    lane's estimate does not depend on the other lanes or their order."""
    radiance, _ = _trace_core(scene, o, d, pixel_id, sample_id, seed,
                              max_depth, sort_rays)
    return radiance


def trace_radiance_spectral(scene: FlatScene, o: Tensor, d: Tensor,
                            pixel_id: Tensor, sample_id: Tensor, seed,
                            max_depth: int = 16, cast_fns=None,
                            resolve_fn=None):
    """(radiance (R, N), lambdas (R, N)). `cast_fns=(intersect_fn,
    occluded_fn)` replaces the two casts (signatures of
    `scene_intersect_alpha` and `scene_occluded`) and `resolve_fn` the
    surface-point resolution (that of `resolve_sp`), for renderers that
    cast against a partitioned scene."""
    return _trace_core(scene, o, d, pixel_id, sample_id, seed, max_depth,
                       cast_fns=cast_fns, resolve_fn=resolve_fn)


def _trace_core(scene: FlatScene, o: Tensor, d: Tensor, pixel_id: Tensor,
                sample_id: Tensor, seed, max_depth: int,
                sort_rays: bool = False, cast_fns=None, resolve_fn=None):
    from ..spectrum.spectral import NUM_SPECTRAL_SAMPLES, sample_wavelengths

    isect_fn, occl_fn = (cast_fns if cast_fns is not None
                         else (scene_intersect_alpha, scene_occluded))
    resolve_fn = resolve_fn or resolve_sp
    scene = scene.to(o.device)
    r = o.shape[0]
    dev = o.device
    spectral = scene.stex.spectral
    s = NUM_SPECTRAL_SAMPLES if spectral else scene.stex.value.shape[-1]
    seed = rng.u32(seed)
    pixel_id = rng.u32(pixel_id)
    sample_id = rng.u32(sample_id)

    with span("pt.camera"):
        # Hero-wavelength sampling with equal offsets; in RGB mode the hero is
        # a channel index.
        u_wl = rng.uniform(seed, pixel_id, sample_id, 0, Decision.WL_SELECT)
        if spectral:
            u_off = rng.uniform(seed, pixel_id, sample_id, 0,
                                Decision.WAVELENGTH)
            wls = sample_wavelengths(u_off, u_wl)
            lambdas, hero = wls.lambdas, wls.hero
        else:
            lambdas = None
            hero = torch.clamp((u_wl * s).to(torch.int64), max=s - 1)
        # The shutter fraction; only scenes with instances trace at one.
        f_time = (rng.uniform(seed, pixel_id, sample_id, 0, Decision.TIME)
                  if scene.instances is not None else None)

        hit = isect_fn(scene, o, d, f=f_time)
        sp = resolve_fn(scene, hit, o, d, f=f_time)
        if RAYS is not None:
            RAYS[0] += r

        alpha = torch.ones((r, s), dtype=torch.float32, device=dev)
        # A first hit on an emitter counts without MIS; so does a camera ray
        # leaving the scene into the environment.
        le = emitted_radiance(scene, sp.mat_id, sp.uv, dot(-d, sp.sn), lambdas)
        radiance = torch.where(hit.mask[:, None], alpha * le, 0.0)
        if scene.has_env:
            eu, ev = _env_uv_from_direction(d)
            radiance = radiance + torch.where(
                ~hit.mask[:, None], _env_radiance(scene, eu, ev, lambdas), 0.0)

        false_ = torch.zeros((r,), dtype=torch.bool, device=dev)
        state = PathState(
            ray_o=o, ray_d=d, alpha=alpha, radiance=radiance, active=hit.mask,
            hero=hero, wl_selected=false_,
            prev_pdf=torch.zeros((r,), dtype=torch.float32, device=dev),
            prev_delta=false_, init_y=importance(alpha, hero))
        lanes = _Lanes(pixel_id, sample_id, f_time, lambdas,
                       torch.arange(r, device=dev))
    # Every lane runs all max_depth bounces, ended ones inactive, as the
    # reference's fixed-trip loop does: each bounce casts once closest hit
    # and once a shadow ray.
    for b in range(max_depth):
        with span("pt.bounce", it=b):
            state, sp, lanes = _bounce(scene, b, state, sp, lanes, seed, s,
                                       isect_fn, occl_fn, resolve_fn,
                                       sort_rays)
    radiance = state.radiance
    if sort_rays:
        radiance = torch.zeros_like(radiance).index_copy(0, lanes.orig,
                                                         radiance)
    return radiance, lambdas


def _permute(order: Tensor, *xs):
    return [None if x is None else
            type(x)(*(None if v is None else v[order] for v in x))
            if isinstance(x, tuple) else x[order] for x in xs]


def _bounce(scene: FlatScene, b: int, state: PathState, sp, lanes: _Lanes,
            seed, s: int, isect_fn, occl_fn, resolve_fn, sort_rays: bool):
    """One bounce of every lane: NEE at the current hits (area lights and
    the environment, one shadow ray), BSDF sampling, the next hit and its
    emission with MIS, then Russian roulette."""
    with span("pt.shade"):
        pixel_id, sample_id, f_time, lambdas, _ = lanes
        bounce_id = b + 1
        fx, fy, fz = sp.tangent, sp.bitangent, sp.sn
        wo = frame_to_local(fx, fy, fz, -state.ray_d)
        gn_sn = frame_to_local(fx, fy, fz, sp.gn)
        lobes = gather_lobes(scene, sp.mat_id, sp.uv, sp.p, lambdas)
        nondelta = bsdf_has_nondelta(lobes)

        # ---- next-event estimation: one light, one shadow ray -----------
        u_sel = rng.uniform(seed, pixel_id, sample_id, bounce_id,
                            Decision.LIGHT_SELECT)
        lu0 = rng.uniform(seed, pixel_id, sample_id, bounce_id,
                          Decision.LIGHT_POS_U)
        lu1 = rng.uniform(seed, pixel_id, sample_id, bounce_id,
                          Decision.LIGHT_POS_V)
        light_tri, light_prob, is_env = _select_light(scene, u_sel)
        lp = sample_triangle_point(scene.geometry, light_tri, lu0, lu1)
        delta_p = lp.p - sp.p
        dist2 = torch.clamp(dot(delta_p, delta_p), min=1e-12)
        dist = torch.sqrt(dist2)
        shadow_dir = delta_p / dist[:, None]
        shadow_tmax = dist * (1.0 - 1e-3)
        if scene.has_env:
            # Environment lanes aim at a direction from its importance map and
            # only need to clear the world's bounding sphere.
            ex, ey, uvpdf = sample_continuous_2d(scene.env.dist, lu0, lu1)
            e_theta = ey * math.pi
            e_dir = _env_direction(ex * 2 * math.pi, e_theta)
            env_area_pdf = uvpdf / torch.clamp(
                2.0 * math.pi ** 2 * torch.sin(e_theta), min=1e-8)
            shadow_dir = torch.where(is_env[:, None], e_dir, shadow_dir)
            shadow_tmax = torch.where(is_env, 4.0 * scene.world_radius,
                                      shadow_tmax)
        shadow_on = state.active & nondelta
    vis = ~occl_fn(scene, sp.p, shadow_dir, RAY_EPSILON, shadow_tmax,
                   f=f_time, active=shadow_on)
    if RAYS is not None:
        RAYS[1] += shadow_on.sum()
        RAYS[2] += ~state.active.any()
    with span("pt.shade"):
        shadow_dir_sn = frame_to_local(fx, fy, fz, shadow_dir)
        fs_nee = bsdf_evaluate(lobes, wo, shadow_dir_sn, gn_sn, state.hero)
        pdf_bsdf_w = bsdf_pdf(lobes, wo, shadow_dir_sn, gn_sn, state.hero)

        le_nee = emitted_radiance(scene, lp.mat_id, lp.uv,
                                  dot(-shadow_dir, lp.sn), lambdas)
        light_pdf = light_prob * lp.area_pdf
        cos_light = dot(-shadow_dir, lp.gn).abs()
        mis_w = power_heuristic(light_pdf, pdf_bsdf_w * cos_light / dist2)
        g = dot(shadow_dir_sn, gn_sn).abs() * cos_light / dist2
        contrib_nee = (state.alpha * le_nee * fs_nee
                       * (g * mis_w
                          / torch.clamp(light_pdf, min=1e-30))[:, None])
        nee_ok = (state.active & nondelta & vis & (light_pdf > 0) & ~is_env)
        radiance = state.radiance + torch.where(nee_ok[:, None],
                                                contrib_nee, 0.0)
        if scene.has_env:
            le_env = _env_radiance(scene, ex, ey, lambdas)
            env_light_pdf = light_prob * env_area_pdf
            mis_env = power_heuristic(env_light_pdf, pdf_bsdf_w)
            g_env = dot(shadow_dir_sn, gn_sn).abs()
            contrib_env = (state.alpha * le_env * fs_nee
                           * (g_env * mis_env / torch.clamp(
                               env_light_pdf, min=1e-30))[:, None])
            env_ok = (state.active & nondelta & vis & is_env
                      & (env_light_pdf > 0))
            radiance = radiance + torch.where(env_ok[:, None], contrib_env,
                                              0.0)

        # ---- BSDF sampling -----------------------------------------------
        uc = rng.uniform(seed, pixel_id, sample_id, bounce_id,
                         Decision.BSDF_COMPONENT)
        u0 = rng.uniform(seed, pixel_id, sample_id, bounce_id, Decision.BSDF_U)
        u1 = rng.uniform(seed, pixel_id, sample_id, bounce_id, Decision.BSDF_V)
        smp = bsdf_sample(lobes, wo, gn_sn, state.hero, state.wl_selected, uc,
                          u0, u1)
        # Gradients flow through fs, Le and the throughput only: the sampled
        # direction and its pdf are constants to autograd.
        smp = smp._replace(wi=smp.wi.detach(), pdf=smp.pdf.detach())
        wl_selected = state.wl_selected | smp.dispersive
        dir_pdf = torch.where(smp.dispersive, smp.pdf / s, smp.pdf)
        cos_sn = dot(smp.wi, gn_sn).abs()
        new_alpha = state.alpha * smp.fs * (
            cos_sn / torch.clamp(dir_pdf, min=1e-30))[:, None]
        sample_ok = state.active & (dir_pdf > 0) & ~(smp.fs == 0.0).all(-1)
        new_o = sp.p
        new_d = frame_from_local(fx, fy, fz, smp.wi)
        is_delta = smp.is_delta

    # ---- coherence re-sort: a permutation of the lanes -------------------
    if sort_rays:
        with span("pt.sort"):
            order = torch.argsort(
                _ray_sort_key(scene, new_o, new_d, sample_ok), stable=True)
            (state, new_o, new_d, sample_ok, new_alpha, radiance, dir_pdf,
             is_delta, wl_selected, lanes) = _permute(
                order, state, new_o, new_d, sample_ok, new_alpha, radiance,
                dir_pdf, is_delta, wl_selected, lanes)
            pixel_id, sample_id, f_time, lambdas, _ = lanes

    # ---- the next hit and its emission (MIS against light sampling) ------
    hit = isect_fn(scene, new_o, new_d, f=f_time, active=sample_ok)
    with span("pt.shade"):
        sp_next = resolve_fn(scene, hit, new_o, new_d, f=f_time)
        if RAYS is not None:
            RAYS[0] += sample_ok.sum()
        still = sample_ok & hit.mask
        le_hit = emitted_radiance(scene, sp_next.mat_id, sp_next.uv,
                                  dot(-new_d, sp_next.sn), lambdas)
        dp_next = sp_next.p - new_o
        d2 = torch.clamp(dot(dp_next, dp_next), min=1e-12)
        cos_g = dot(new_d, sp_next.gn).abs()
        light_pdf_hit = (_area_light_prob(scene) * sp_next.area_pdf * d2
                         / torch.clamp(cos_g, min=1e-12))
        mis_bsdf = torch.where(is_delta, 1.0,
                               power_heuristic(dir_pdf, light_pdf_hit))
        emissive_hit = still & is_emissive(scene.materials, sp_next.mat_id)
        radiance = radiance + torch.where(
            emissive_hit[:, None], new_alpha * le_hit * mis_bsdf[:, None], 0.0)
        if scene.has_env:
            # An escaped ray meets the environment, weighted against its
            # importance map.
            esc = sample_ok & ~hit.mask
            ieu, iev = _env_uv_from_direction(new_d)
            env_le_hit = _env_radiance(scene, ieu, iev, lambdas)
            env_pdf_hit = (scene.lights.env_prob
                           * pdf_continuous_2d(scene.env.dist, ieu, iev)
                           / torch.clamp(2.0 * math.pi ** 2
                                         * torch.sin(iev * math.pi), min=1e-8))
            mis_env_hit = torch.where(is_delta, 1.0,
                                      power_heuristic(dir_pdf, env_pdf_hit))
            radiance = radiance + torch.where(
                esc[:, None], new_alpha * env_le_hit * mis_env_hit[:, None],
                0.0)

        # ---- Russian roulette on the hero importance (no gradient) -------
        cont_p = torch.clamp(importance(new_alpha, state.hero)
                             / torch.clamp(state.init_y, min=1e-30),
                             max=1.0).detach()
        survive = rng.uniform(seed, pixel_id, sample_id, bounce_id,
                              Decision.RR) < cont_p
        new_alpha = torch.where(
            survive[:, None],
            new_alpha / torch.clamp(cont_p, min=1e-30)[:, None],
            new_alpha)
        active = still & survive
        new_state = PathState(
            ray_o=new_o, ray_d=new_d,
            alpha=torch.where(active[:, None], new_alpha, state.alpha),
            radiance=radiance, active=active, hero=state.hero,
            wl_selected=torch.where(active, wl_selected, state.wl_selected),
            prev_pdf=dir_pdf, prev_delta=is_delta, init_y=state.init_y)
    return new_state, sp_next, lanes


def render(scene: FlatScene, width: int, height: int, spp: int,
           seed: int = 0, max_depth: int = 16, ray_batch: int | None = None,
           sample_offset: int = 0, device=None, cast_fns=None,
           resolve_fn=None) -> Tensor:
    """Render `spp` samples per pixel in passes of `ray_batch` lanes
    (default min(pixels, 65536)). Returns the (H, W, S) mean linear
    radiance on `device` (default: the CUDA device), S = 3 (a spectral
    scene's strata are converted to linear sRGB). `cast_fns` and
    `resolve_fn` replace the casts and the surface-point resolution (see
    `trace_radiance_spectral`).

    Sample streams are keyed by (seed, sample_offset + i), so a render split
    into passes by `sample_offset` equals one render of all the samples bit
    for bit."""
    from ..spectrum.spectral import NUM_STRATA, strata_to_rgb

    scene = scene.to(resolve_device(device))
    dev = scene.device
    n_pix = width * height
    spectral = scene.stex.spectral
    s_film = NUM_STRATA if spectral else scene.stex.value.shape[-1]
    batch = int(ray_batch or min(n_pix, 65536))
    n_batches = -(-n_pix // batch)
    acc: list = [None] * n_batches
    for i in range(spp):
        sample_id = torch.full((batch,), sample_offset + i,
                               dtype=torch.int64, device=dev)
        for b in range(n_batches):
            pixel_id = torch.arange(b * batch, (b + 1) * batch, device=dev)
            out = render_batch(scene, pixel_id, sample_id, seed, width,
                               height, max_depth, cast_fns=cast_fns,
                               resolve_fn=resolve_fn)
            acc[b] = out if acc[b] is None else acc[b] + out
    film = (torch.cat(acc)[:n_pix] / spp).reshape(height, width, s_film)
    if spectral:
        film = strata_to_rgb(film)
    return film


def render_batch(scene: FlatScene, pixel_id: Tensor, sample_id: Tensor,
                 seed, width: int, height: int, max_depth: int,
                 cast_fns=None, resolve_fn=None) -> Tensor:
    """One sample pass over one lane batch -> the per-pixel film
    contributions ((B, 3) RGB or (B, 16) spectral strata). Pixel ids past
    the image repeat its last pixel; the caller drops them."""
    from ..spectrum.spectral import (
        NUM_SPECTRAL_SAMPLES,
        WL_HI,
        WL_LO,
        bin_to_strata,
    )

    pid_c = torch.clamp(pixel_id.to(torch.int64), max=width * height - 1)
    rays = _camera_ray(scene, pid_c, sample_id, seed, width, height)
    c, lambdas = _trace_core(scene, rays.o, rays.d, pid_c, sample_id, seed,
                             max_depth, sort_rays=True, cast_fns=cast_fns,
                             resolve_fn=resolve_fn)
    weight = rays.weight[:, None] * c
    if scene.stex.spectral:
        # The wavelength selection pdf, then the sensor's strata.
        return bin_to_strata(
            lambdas, weight / (NUM_SPECTRAL_SAMPLES / (WL_HI - WL_LO)))
    return weight


def render_fused(scene: FlatScene, width: int, height: int, spp: int,
                 seed: int = 0, max_depth: int = 16, device=None) -> Tensor:
    """The whole frame in one call: every sample pass traces all pixels at
    once (one batch), the estimator of `render`, and its result bit for bit
    where the image has at most 65,536 pixels. The reference fuses the
    passes into one device program to spare per-pass dispatch; here the
    passes are a Python loop either way, and this is the entry point to
    differentiate a whole image through."""
    return render(scene, width, height, spp, seed=seed, max_depth=max_depth,
                  ray_batch=width * height, device=device)
