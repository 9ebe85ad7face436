"""Persistent-wavefront path tracer with a dynamic global work queue
(counterpart of slr_tpu/render/wavefront.py).

Lanes are not pinned to pixels. A global counter enumerates (pixel, sample)
work items (work = sample * n_pix + pixel); when a lane's path ends it adds
its sample to the film and claims the next item through an exclusive prefix
sum over this iteration's finishers. Every iteration makes one closest-hit
cast and one shadow cast per lane. The random streams are keyed by
(pixel, sample, bounce, decision), so each work item's estimate does not
depend on which lane traces it.

The reference's `lax.while_loop` is a Python loop here, with one host sync
per iteration to test for remaining work, which counts the live lanes too.
Each iteration is a `wavefront.iter` span (utils/metrics.py) holding the
casts' spans and the phases `wavefront.shade` (twice), `wavefront.bank`,
`wavefront.sort` and `wavefront.sync`. Work counters are uint32 values held
in int64.

Once the queue has drained, the lanes are cut to the live ones between
iterations (`_cut_width`, `_compact`, each cut a `wavefront.compact`
span), so that the pass's long tail of a few deep paths runs every kernel
over a width near its live lanes, not over all of them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..accel.intersect import RAY_EPSILON, sample_triangle_point
from ..bsdf.bsdf import (
    bsdf_evaluate,
    bsdf_has_nondelta,
    bsdf_pdf,
    bsdf_sample,
    emitted_radiance,
    gather_lobes,
    is_emissive,
)
from ..core import rng
from ..core.device import resolve_device
from ..core.math3d import dot, frame_from_local, frame_to_local
from ..core.rng import Decision
from ..core.sampling import pdf_continuous_2d, power_heuristic, sample_continuous_2d
from ..scene.types import FlatScene
from ..spectrum.rgb import importance
from ..utils.metrics import span
from .pt import (
    _area_light_prob,
    _camera_ray,
    _env_direction,
    _env_radiance,
    _env_uv_from_direction,
    _ray_sort_key,
    _select_light,
    resolve_sp,
    scene_intersect_alpha,
    scene_occluded,
)

Tensor = torch.Tensor

DEFAULT_MAX_DEPTH = 100

# Lanes in flight. The reference's default, kept because results do not
# depend on it; tuning it for the card is separate work.
DEFAULT_LANE_CAP = 49152

# The narrowest width the lanes are cut to (accel/traverse.py's ray block,
# RB): a render of this many lanes or fewer is never cut.
COMPACT_MIN_LANES = 256


class LaneState(NamedTuple):
    """Per-lane persistent state; `work` >= total means the lane is drained."""

    work: Tensor        # (R,) int64 global work item (uint32 value)
    bounce: Tensor      # (R,) int64 casts completed for the current sample
    ray_o: Tensor
    ray_d: Tensor
    alpha: Tensor       # (R, S)
    radiance: Tensor    # (R, S)
    cam_weight: Tensor  # (R,)
    hero: Tensor        # (R,) int64
    lambdas: Tensor     # (R, S) (zeros in RGB mode)
    wl_selected: Tensor
    prev_pdf: Tensor
    prev_delta: Tensor
    last: Tensor        # in-flight segment is the path's last (RR killed it)
    rr_scale: Tensor    # 1/cont_p of the RR draw that allowed this segment
    init_y: Tensor
    f_time: Tensor


def _work_pixel_sample(work: Tensor, n_pix: int, sample_offset: int):
    return work % n_pix, sample_offset + work // n_pix


def _fresh_sample(scene: FlatScene, pid: Tensor, sid: Tensor, seed: int,
                  width: int, height: int, s: int, spectral: bool):
    """Everything a lane needs to start the sample (pid, sid)."""
    rays = _camera_ray(scene, pid, sid, seed, width, height)
    u_wl = rng.uniform(seed, pid, sid, 0, Decision.WL_SELECT)
    if spectral:
        from ..spectrum.spectral import sample_wavelengths

        u_off = rng.uniform(seed, pid, sid, 0, Decision.WAVELENGTH)
        wls = sample_wavelengths(u_off, u_wl)
        lambdas, hero = wls.lambdas, wls.hero
    else:
        lambdas = torch.zeros(pid.shape + (s,), dtype=torch.float32,
                              device=pid.device)
        hero = torch.clamp((u_wl * s).to(torch.int64), max=s - 1)
    if scene.instances is not None:
        f_time = rng.uniform(seed, pid, sid, 0, Decision.TIME)
    else:
        f_time = torch.zeros(pid.shape, dtype=torch.float32,
                             device=pid.device)
    return rays, hero, lambdas, f_time


def _sample_value(radiance: Tensor, cam_weight: Tensor, lambdas: Tensor,
                  spectral: bool) -> Tensor:
    """One finished sample -> film-space contribution (R, S_film)."""
    weighted = cam_weight[:, None] * radiance
    if spectral:
        from ..spectrum.spectral import NUM_SPECTRAL_SAMPLES, WL_HI, WL_LO, bin_to_strata

        return bin_to_strata(
            lambdas, weighted / (NUM_SPECTRAL_SAMPLES / (WL_HI - WL_LO)))
    return weighted


def _pick(cond: Tensor, a: Tensor, b: Tensor) -> Tensor:
    return torch.where(cond.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


def _cut_width(n_live: int) -> int:
    """The width to cut the lanes to while `n_live` of them hold work: the
    smallest power of two that is at least COMPACT_MIN_LANES and n_live.
    Powers of two keep the widths a pass runs at few: after the first cut
    each one at least halves the width."""
    return max(COMPACT_MIN_LANES, 1 << (n_live - 1).bit_length())


def _compact(lane: LaneState, ones: Tensor, total: int, n: int,
             sort_rays: bool) -> tuple[LaneState, Tensor]:
    """The lanes cut to their first `n` after the live ones are
    brought there in their order. Only valid once the queue has drained
    (some lane has work >= total): claims go out in rank order, so no lane
    takes work again, and the cut lanes were bound to stay idle.

    Sorted lanes hold the live ones as a prefix already (inactive lanes key
    last, the sort is stable, and the first lanes' work is ascending), so
    the cut is a view. Otherwise a stable sort of the drained flag gathers
    the live lanes first, in their order, and drained ones after them."""
    if sort_rays:
        return LaneState(*(x[:n] for x in lane)), ones[:n]
    keep = torch.argsort((lane.work >= total).to(torch.int8),
                         stable=True)[:n]
    return LaneState(*(x[keep] for x in lane)), ones[:n]


def _run_wavefront(scene: FlatScene, n_pix: int, spp_end: int, seed: int,
                   width: int, height: int, sample_offset: int,
                   max_depth: int, n_lanes: int | None = None,
                   sort_rays: bool = True, work_lo: int = 0,
                   work_hi: int | None = None) -> tuple[Tensor, int]:
    """Trace work items [0, (spp_end - sample_offset) * n_pix). Returns
    (film (n_pix, S_film), iterations).

    `work_lo` / `work_hi` restrict the queue to the items [work_lo,
    min(work_hi, total)): the ranged form, in which each rank drains its
    own contiguous slice of the work space with its own lanes and film
    (parallel/mesh.py `render_wavefront_sharded`). Each item's estimate is
    the same whichever range traces it."""
    from ..spectrum.spectral import NUM_SPECTRAL_SAMPLES, NUM_STRATA

    dev = scene.device
    spectral = scene.stex.spectral
    s = NUM_SPECTRAL_SAMPLES if spectral else scene.stex.value.shape[-1]
    s_film = NUM_STRATA if spectral else s
    r = n_lanes or n_pix
    total = (spp_end - sample_offset) * n_pix
    if total >= 2 ** 32:
        raise ValueError("the work queue counts in 32 bits")
    if work_hi is not None:
        total = min(work_hi, total)

    work0 = work_lo + torch.arange(r, dtype=torch.int64, device=dev)
    pid0, sid0 = _work_pixel_sample(work0, n_pix, sample_offset)
    rays, hero, lambdas, f_time = _fresh_sample(scene, pid0, sid0, seed,
                                                width, height, s, spectral)
    ones = torch.ones((r, s), dtype=torch.float32, device=dev)
    false_ = torch.zeros((r,), dtype=torch.bool, device=dev)
    lane = LaneState(
        work=work0, bounce=torch.zeros((r,), dtype=torch.int64, device=dev),
        ray_o=rays.o, ray_d=rays.d, alpha=ones,
        radiance=torch.zeros((r, s), dtype=torch.float32, device=dev),
        cam_weight=rays.weight, hero=hero, lambdas=lambdas,
        wl_selected=false_, prev_pdf=torch.zeros((r,), device=dev),
        prev_delta=false_, last=false_,
        rr_scale=torch.ones((r,), device=dev), init_y=importance(ones, hero),
        f_time=f_time)
    counter = torch.tensor(work_lo + r, dtype=torch.int64, device=dev)
    film = torch.zeros((n_pix + 1, s_film), dtype=torch.float32, device=dev)
    n_iters = 0
    # The loop's test for remaining work is its one host sync an
    # iteration; it counts the live lanes, which the iteration's span keeps
    # with the width it runs over. A live count below the width means the
    # queue has drained: the lanes are then cut to a power of two below
    # the width where one still holds the live ones.
    n_live = int((lane.work < total).sum())
    while n_live > 0:
        lanes = lane.work.shape[0]
        cut = _cut_width(n_live)
        if cut < lanes:
            with span("wavefront.compact", it=n_iters, live=n_live,
                      lanes_from=lanes, lanes_to=cut):
                lane, ones = _compact(lane, ones, total, cut, sort_rays)
            lanes = cut
        with span("wavefront.iter", it=n_iters, live=n_live, lanes=lanes):
            lane, counter = _iteration(
                scene, lane, counter, film, ones, total, n_pix, sample_offset,
                seed, width, height, s, spectral, max_depth, sort_rays)
            n_iters += 1
            with span("wavefront.sync"):
                n_live = int((lane.work < total).sum())

    return film[:n_pix], n_iters


def _iteration(scene: FlatScene, lane: LaneState, counter: Tensor,
               film: Tensor, ones: Tensor, total: int, n_pix: int,
               sample_offset: int, seed: int, width: int, height: int, s: int,
               spectral: bool, max_depth: int, sort_rays: bool):
    """One wavefront iteration: cast, shade, shadow cast, shade, bank the
    finished samples into `film` (in place) and claim new work, sort.
    `ones` is the lanes' (R, S) throughput of a fresh sample. Returns
    (lanes, work counter)."""
    lane_on = lane.work < total
    # A path keeps its sample's shutter fraction for all its casts.
    ft = lane.f_time if scene.instances is not None else None
    lam_s = lane.lambdas if spectral else None

    # ---- cast the in-flight ray -------------------------------------
    hit = scene_intersect_alpha(scene, lane.ray_o, lane.ray_d, f=ft,
                                active=lane_on)
    with span("wavefront.shade"):
        pixel_id, sample_id = _work_pixel_sample(lane.work, n_pix,
                                                 sample_offset)
        sp = resolve_sp(scene, hit, lane.ray_o, lane.ray_d, f=ft)
        hit_ok = lane_on & hit.mask
        first = lane.bounce == 0

        # ---- emission at the hit ----------------------------------------
        cos_out = dot(-lane.ray_d, sp.sn)
        le = emitted_radiance(scene, sp.mat_id, sp.uv, cos_out, lam_s)
        dp_ = sp.p - lane.ray_o
        d2 = torch.clamp(dot(dp_, dp_), min=1e-12)
        cos_g = dot(lane.ray_d, sp.gn).abs()
        l_prob = _area_light_prob(scene)
        light_pdf_hit = l_prob * sp.area_pdf * d2 / torch.clamp(cos_g,
                                                                min=1e-12)
        mis_b = torch.where(first | lane.prev_delta, 1.0,
                            power_heuristic(lane.prev_pdf, light_pdf_hit))
        emissive = hit_ok & is_emissive(scene.materials, sp.mat_id)
        radiance = lane.radiance + torch.where(
            emissive[:, None], lane.alpha * le * mis_b[:, None], 0.0)

        # ---- the environment on a miss -----------------------------------
        if scene.has_env:
            esc = lane_on & ~hit.mask
            eu, ev = _env_uv_from_direction(lane.ray_d)
            env_le = _env_radiance(scene, eu, ev, lam_s)
            env_pdf = (scene.lights.env_prob
                       * pdf_continuous_2d(scene.env.dist, eu, ev)
                       / torch.clamp(2.0 * math.pi ** 2
                                     * torch.sin(ev * math.pi), min=1e-8))
            mis_env = torch.where(first | lane.prev_delta, 1.0,
                                  power_heuristic(lane.prev_pdf, env_pdf))
            radiance = radiance + torch.where(
                esc[:, None], lane.alpha * env_le * mis_env[:, None], 0.0)

        # ---- shade: NEE + BSDF sample + RR -------------------------------
        # Shading sees the RR-divided alpha; the emission above saw the
        # undivided one.
        alpha_sh = lane.alpha * lane.rr_scale[:, None]
        bounce_id = lane.bounce + 1
        fx, fy, fz = sp.tangent, sp.bitangent, sp.sn
        wo = frame_to_local(fx, fy, fz, -lane.ray_d)
        gn_sn = frame_to_local(fx, fy, fz, sp.gn)
        lobes = gather_lobes(scene, sp.mat_id, sp.uv, sp.p, lam_s)
        nondelta = bsdf_has_nondelta(lobes)

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
            # An environment sample: a direction from its importance map
            # (same randoms as the area point), its solid-angle pdf through
            # the sin(theta) Jacobian, and a shadow ray leaving the scene.
            ex, ey, uvpdf = sample_continuous_2d(scene.env.dist, lu0, lu1)
            e_theta = ey * math.pi
            e_dir = _env_direction(ex * 2 * math.pi, e_theta)
            env_area_pdf = uvpdf / torch.clamp(
                2.0 * math.pi ** 2 * torch.sin(e_theta), min=1e-8)
            shadow_dir = torch.where(is_env[:, None], e_dir, shadow_dir)
            shadow_tmax = torch.where(is_env, 4.0 * scene.world_radius,
                                      shadow_tmax)

        # NEE at hit b contributes a path of b+1 segments, allowed iff
        # b < max_depth; the same condition gates extending.
        depth_ok = (lane.bounce < max_depth) & ~lane.last

    vis = ~scene_occluded(scene, sp.p, shadow_dir, RAY_EPSILON,
                          shadow_tmax, f=ft,
                          active=hit_ok & depth_ok & nondelta)
    with span("wavefront.shade"):
        shadow_dir_sn = frame_to_local(fx, fy, fz, shadow_dir)
        fs_nee = bsdf_evaluate(lobes, wo, shadow_dir_sn, gn_sn, lane.hero)
        pdf_bsdf_w = bsdf_pdf(lobes, wo, shadow_dir_sn, gn_sn, lane.hero)

        cos_light_s = dot(-shadow_dir, lp.sn)
        le_nee = emitted_radiance(scene, lp.mat_id, lp.uv, cos_light_s, lam_s)
        light_pdf = light_prob * lp.area_pdf
        cos_light = dot(-shadow_dir, lp.gn).abs()
        bsdf_pdf_sa = pdf_bsdf_w * cos_light / dist2
        mis_w = power_heuristic(light_pdf, bsdf_pdf_sa)
        g = dot(shadow_dir_sn, gn_sn).abs() * cos_light / dist2
        contrib_nee = (alpha_sh * le_nee * fs_nee
                       * (g * mis_w / torch.clamp(light_pdf, min=1e-30))[:, None])
        nee_ok = (hit_ok & depth_ok & nondelta & vis & (light_pdf > 0)
                  & ~is_env)
        radiance = radiance + torch.where(nee_ok[:, None], contrib_nee, 0.0)

        if scene.has_env:
            le_env = _env_radiance(scene, ex, ey, lam_s)
            env_light_pdf = light_prob * env_area_pdf
            mis_env2 = power_heuristic(env_light_pdf, pdf_bsdf_w)
            g_env = dot(shadow_dir_sn, gn_sn).abs()
            contrib_env = (alpha_sh * le_env * fs_nee
                           * (g_env * mis_env2 / torch.clamp(
                               env_light_pdf, min=1e-30))[:, None])
            env_ok = (hit_ok & depth_ok & nondelta & vis & is_env
                      & (env_light_pdf > 0))
            radiance = radiance + torch.where(env_ok[:, None], contrib_env,
                                              0.0)

        uc = rng.uniform(seed, pixel_id, sample_id, bounce_id,
                         Decision.BSDF_COMPONENT)
        u0 = rng.uniform(seed, pixel_id, sample_id, bounce_id, Decision.BSDF_U)
        u1 = rng.uniform(seed, pixel_id, sample_id, bounce_id, Decision.BSDF_V)
        smp = bsdf_sample(lobes, wo, gn_sn, lane.hero, lane.wl_selected,
                          uc, u0, u1)
        smp = smp._replace(wi=smp.wi.detach(), pdf=smp.pdf.detach())
        dir_pdf = torch.where(smp.dispersive, smp.pdf / s, smp.pdf)
        wl_sel_new = lane.wl_selected | smp.dispersive

        cos_sn = dot(smp.wi, gn_sn).abs()
        new_alpha = alpha_sh * smp.fs * (
            cos_sn / torch.clamp(dir_pdf, min=1e-30))[:, None]
        sample_ok = hit_ok & (dir_pdf > 0) & ~(smp.fs == 0.0).all(-1)

        cont_p = torch.clamp(
            importance(new_alpha, lane.hero)
            / torch.clamp(lane.init_y, min=1e-30), max=1.0).detach()
        u_rr = rng.uniform(seed, pixel_id, sample_id, bounce_id, Decision.RR)
        survive = u_rr < cont_p
        # RR-killed paths still cast this final segment (its Le is banked
        # with the undivided alpha) and are flagged `last`; the survivor
        # division is deferred through rr_scale.
        rr_next = torch.where(survive, 1.0 / torch.clamp(cont_p, min=1e-30),
                              1.0)
        extend = sample_ok & depth_ok
        dying = extend & ~survive

    with span("wavefront.bank"):
        # ---- bank finished samples & claim new work ----------------------
        finish = lane_on & ~extend
        values = _sample_value(radiance, lane.cam_weight, lane.lambdas,
                               spectral)
        bank_idx = torch.where(finish, pixel_id, n_pix)
        film.index_add_(0, bank_idx,
                        torch.where(finish[:, None], values, 0.0))

        fin = finish.to(torch.int64)
        rank = torch.cumsum(fin, 0) - fin      # exclusive prefix sum
        new_work = torch.where(finish, counter + rank, lane.work)
        counter = counter + fin.sum()

        regen = finish & (new_work < total)
        n_pid, n_sid = _work_pixel_sample(new_work, n_pix, sample_offset)
        n_rays, n_hero, n_lam, n_ft = _fresh_sample(
            scene, n_pid, n_sid, seed, width, height, s, spectral)

        lane = LaneState(
            work=new_work,
            bounce=torch.where(finish, 0, lane.bounce + 1),
            ray_o=_pick(regen, n_rays.o, sp.p),
            ray_d=_pick(regen, n_rays.d, frame_from_local(fx, fy, fz, smp.wi)),
            alpha=_pick(finish, ones, new_alpha),
            radiance=torch.where(finish[:, None], 0.0, radiance),
            cam_weight=_pick(regen, n_rays.weight, lane.cam_weight),
            hero=_pick(regen, n_hero, lane.hero),
            lambdas=_pick(regen, n_lam, lane.lambdas),
            wl_selected=torch.where(finish, False, wl_sel_new),
            prev_pdf=torch.where(finish, 0.0, dir_pdf),
            prev_delta=torch.where(finish, False, smp.is_delta),
            last=torch.where(finish, False, dying),
            rr_scale=torch.where(finish, 1.0, rr_next),
            init_y=_pick(regen, importance(ones, n_hero), lane.init_y),
            f_time=_pick(regen, n_ft, lane.f_time),
        )

    # ---- optional coherence re-sort (plain per-tensor indexing) ------
    if sort_rays:
        with span("wavefront.sort"):
            key = _ray_sort_key(scene, lane.ray_o, lane.ray_d,
                                lane.work < total)
            order = torch.argsort(key, stable=True)
            lane = LaneState(*(x[order] for x in lane))
    return lane, counter


def render_wavefront(scene: FlatScene, width: int, height: int, spp: int,
                     seed: int = 0, max_depth: int = DEFAULT_MAX_DEPTH,
                     sample_offset: int = 0, return_iters: bool = False,
                     sort_rays: bool = True, n_lanes: int | None = None,
                     device=None):
    """Render `spp` samples per pixel. Returns the (H, W, 3) mean linear
    radiance on `device` (default: the CUDA device; develop it with
    render/film.py), and the iteration count when `return_iters`."""
    from ..spectrum.spectral import strata_to_rgb

    scene = scene.to(resolve_device(device))
    n_pix = width * height
    if n_lanes is None:
        n_lanes = min(n_pix, DEFAULT_LANE_CAP)
    film, n_iters = _run_wavefront(scene, n_pix, spp + sample_offset, seed,
                                   width, height, sample_offset, max_depth,
                                   n_lanes=n_lanes, sort_rays=sort_rays)
    film = (film / spp).reshape(height, width, -1)
    if scene.stex.spectral:
        film = strata_to_rgb(film)
    if return_iters:
        return film, n_iters
    return film
