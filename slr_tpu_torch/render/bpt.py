"""Bidirectional path tracer (Veach BPT) over ray wavefronts (counterpart of
slr_tpu/render/bpt.py).

Every lane of a batch builds a light subpath (from an area light, or from
the environment sphere) and an eye subpath (from the lens) to static vertex
caps, then connects every (s, t) pair with a shadow ray and weights each
strategy with the power-heuristic MIS of the original renderer. The eye
subpath's emitter and environment hits are the s = 0 strategies, and t = 1
connections splat onto the pixel the light vertex projects to.

The reference's `lax.scan` over bounces is a Python loop here, and its
vertex tables are stacked along a leading vertex axis: (V, R, ...). The
connection stage works on one eye level t at a time, with the light-vertex
axis flattened s-major into the lane axis, so that one BSDF evaluation and
one any-hit cast (n_l * R shadow rays) cover every s of that level. MIS
weights come from the O(V) partial sums of `_mis_incremental`; the literal
walk survives as `_mis_weight_static`, used by the tests only.

`render_bpt` caps subpaths adaptively: every lane runs at `base_verts`
first; lanes whose subpath was still extending at that cap bank nothing and
run again at the full caps. The counter-based streams reproduce the short
prefix bit for bit, so the deep run is that lane's whole estimate.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..accel.intersect import RAY_EPSILON, sample_triangle_point
from ..bsdf.bsdf import (
    bsdf_evaluate,
    bsdf_pdf,
    bsdf_sample,
    emitted_radiance,
    gather_lobes,
    is_emissive,
)
from ..bsdf.lobes import LobeBatch
from ..camera.perspective import camera_derived
from ..core import rng
from ..core.device import resolve_device
from ..core.math3d import (
    cross,
    dot,
    frame_from_local,
    frame_to_local,
    normalize,
    transform_point,
    transform_vector,
)
from ..core.rng import Decision
from ..core.sampling import (
    concentric_sample_disk,
    cosine_sample_hemisphere,
    pdf_continuous_2d,
    sample_continuous_2d,
    sample_discrete_1d,
)
from ..scene.types import CameraKind, FlatScene
from ..spectrum.rgb import importance
from .pt import (
    _area_light_prob,
    _env_direction,
    _env_radiance,
    _env_uv_from_direction,
    _ray_sort_key,
    resolve_sp,
    scene_intersect_alpha,
    scene_occluded,
)

Tensor = torch.Tensor

_INV_PI = 1.0 / math.pi

# Offset of the light subpath's bounce ids, so that its streams never meet
# the eye subpath's (both draw from the same counter-based generator).
_LIGHT_BOUNCE_OFFSET = 64

# What `render_bpt`'s adaptive tiers did since the last reset: lanes of the
# base passes, lanes clipped at the base cap, lanes of the deep passes
# (padding included) and deep `bpt_batch` calls.
TIERS = {"base_lanes": 0, "clipped": 0, "deep_lanes": 0, "deep_passes": 0}


def reset_tiers() -> None:
    for k in TIERS:
        TIERS[k] = 0


class Vertices(NamedTuple):
    """Subpath vertex tables. Generation emits one (R, ...) row per bounce;
    the connection stage works on the vertex-major (V, R, ...) stack built
    by `_prepend_v0`. `_mis_weight_static` alone takes lane-major (R, V)."""

    valid: Tensor         # (V, R) bool
    p: Tensor             # (V, R, 3)
    gn: Tensor            # (V, R, 3) world geometric normal
    tangent: Tensor       # (V, R, 3) shading frame x
    bitangent: Tensor     # (V, R, 3)
    sn: Tensor            # (V, R, 3) shading frame z
    uv: Tensor            # (V, R, 2)
    mat_id: Tensor        # (V, R) int64
    dir_in_sn: Tensor     # (V, R, 3) direction toward the previous vertex
    alpha: Tensor         # (V, R, S)
    area_pdf: Tensor      # (V, R)
    rr_prob: Tensor       # (V, R)
    rev_area_pdf: Tensor  # (V, R)
    rev_rr_prob: Tensor   # (V, R)
    delta: Tensor         # (V, R) the creating sample was delta
    is_light0: Tensor     # (V, R) light-source vertex (EDF endpoint)
    wl_flag: Tensor       # (V, R) the hero wavelength collapsed on arrival
    at_inf: Tensor        # (V, R) environment-sphere vertex: p is a unit
                          # direction, dist2 = 1 in connections


def _tmap(fn, *trees):
    """`fn` over the tensor leaves of matching NamedTuples, tuples and
    LobeBatches (whose static `kinds` stays as it is)."""
    t0 = trees[0]
    if isinstance(t0, Tensor):
        return fn(*trees)
    if isinstance(t0, LobeBatch):
        return dataclasses.replace(t0, **{
            f.name: fn(*(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0) if f.name != "kinds"})
    if isinstance(t0, tuple):
        out = [_tmap(fn, *xs) for xs in zip(*trees)]
        return type(t0)(*out) if hasattr(t0, "_fields") else tuple(out)
    return t0


def _tree_at(tree, i: int):
    """Row i of a stacked tree."""
    return _tmap(lambda x: x[i], tree)


def _tree_prepend(first, stacked):
    """Prepend one (R, ...) tree as row 0 of a (V, R, ...) stacked tree."""
    return _tmap(lambda a, b: torch.cat([a[None], b], dim=0), first, stacked)


def _prepend_v0(v0: Vertices, steps: Vertices) -> Vertices:
    """Endpoint vertex + the per-bounce rows -> the (V + 1, R, ...) table
    whose leading axis the connection stage runs over."""
    return _tree_prepend(v0, steps)


def _stack(rows: list):
    return _tmap(lambda *xs: torch.stack(xs, dim=0), *rows)


def _flat(x: Tensor) -> Tensor:
    """(n_l, R, ...) -> (n_l * R, ...), s-major."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _rep(x: Tensor, n: int) -> Tensor:
    """(R, ...) -> (n * R, ...): the lane axis tiled n times, s-major."""
    return x.repeat((n,) + (1,) * (x.dim() - 1))


def _safe_div(a, b):
    return a / torch.where(b <= 0, 1e30, b)


def _mis_incremental(v: Vertices, n: int, min_idx: int) -> tuple:
    """Per-subpath recursive MIS quantities (calculateMISWeight,
    reorganised): the weight walk's inner ratio chains depend only on
    per-vertex pdf products, so the sum over all "shorten by >= 2"
    strategies collapses to one partial sum per endpoint index: O(V) per
    subpath instead of O(V) per (s, t) pair.

    For a walk that shortens this subpath from endpoint k - 1 down to vertex
    `min_idx` (1 on the eye side: the lens vertex is never a strategy; 0 on
    the light side) the literal walk accumulates
        rec += Zb[k-1] * c1^2 + (c1 c2)^2 * S[k]
    with c1, c2 the two connection-dependent boundary ratios and
        S[k] = Zfull[k-2] + (N[k-3] / D[k-3])^2 * S[k-1],
        S[min_idx + 2] = Zfull[min_idx],  S[<= min_idx + 1] = 0,
    D[i] = areaPDF[i] * RRProb[i], N[i] = revAreaPDF[i] * revRRProb[i],
    Zb[i] = !delta[i], Zfull[i] = !(delta[i] | delta[i+1]) (strategies next
    to a delta vertex are skipped).

    Returns (D (n, R), Zb (n, R) float, S (n + 1, R) stacked by k)."""
    d_ = v.area_pdf * v.rr_prob
    zb = (~v.delta).to(torch.float32)
    n_v = v.rev_area_pdf * v.rev_rr_prob
    zfull = (~(v.delta[:-1] | v.delta[1:])).to(torch.float32)
    r = d_.shape[1]
    zero = torch.zeros((r,), dtype=torch.float32, device=d_.device)
    s_list = [zero] * min(min_idx + 2, n + 1)
    if min_idx + 2 <= n:
        s_list.append(zfull[min_idx])
    for k in range(min_idx + 3, n + 1):
        f = _safe_div(n_v[k - 3], d_[k - 3])
        s_list.append(zfull[k - 2] + f * f * s_list[-1])
    return d_, zb, torch.stack(s_list, dim=0)


def _mis_weight_static(
    l_ext1, l_rr1, l_ext2, l_rr2, e_ext1, e_rr1, e_ext2, e_rr2,
    s: int, t: int,
    l_area, l_rrp, l_rev_area, l_rev_rrp, l_delta,
    e_area, e_rrp, e_rev_area, e_rev_rrp, e_delta,
):
    """calculateMISWeight with static s, t, walked literally: all operands
    are (R,) tensors or lane-major (R, V) tables indexed [:, i]. The tests
    hold `_mis_incremental` against it."""
    rec = torch.ones_like(l_ext1)
    min_eye, min_light = 1, 0

    def walk(rec, n, min_n, ext1, rr1, ext2, rr2, area, rrp, rev_area,
             rev_rrp, delta):
        ratio = _safe_div(ext1 * rr1, area[:, n - 1] * rrp[:, n - 1])
        shorten_delta = delta[:, n - 1]
        rec = rec + torch.where(shorten_delta, 0.0, ratio * ratio)
        prev_delta = shorten_delta
        if n - 1 > min_n:
            ratio = ratio * _safe_div(ext2 * rr2,
                                      area[:, n - 2] * rrp[:, n - 2])
            shorten_delta = delta[:, n - 2]
            rec = rec + torch.where(shorten_delta | prev_delta, 0.0,
                                    ratio * ratio)
            prev_delta = shorten_delta
            for k in range(n - 2, min_n, -1):
                ratio = ratio * _safe_div(
                    rev_area[:, k - 1] * rev_rrp[:, k - 1],
                    area[:, k - 1] * rrp[:, k - 1])
                shorten_delta = delta[:, k - 1]
                rec = rec + torch.where(shorten_delta | prev_delta, 0.0,
                                        ratio * ratio)
                prev_delta = shorten_delta
        return rec

    if t > min_eye:     # shorten the eye subpath, extend the light subpath
        rec = walk(rec, t, min_eye, l_ext1, l_rr1, l_ext2, l_rr2, e_area,
                   e_rrp, e_rev_area, e_rev_rrp, e_delta)
    if s > min_light:   # shorten the light subpath, extend the eye subpath
        rec = walk(rec, s, min_light, e_ext1, e_rr1, e_ext2, e_rr2, l_area,
                   l_rrp, l_rev_area, l_rev_rrp, l_delta)
    return 1.0 / rec


def _unsort(order: Tensor, x: Tensor) -> Tensor:
    return torch.empty_like(x).index_copy_(0, order, x)


def _sorted_cast(scene: FlatScene, o, d, active, f=None, isect_fn=None):
    """Closest hit with a coherence sort around the cast only: the rays are
    permuted by (active, octant, origin Morton code), cast, and the hit is
    put back in lane order (the vertex tables keep lane identity across
    bounces). `f` is the per-ray shutter fraction."""
    isect_fn = isect_fn or scene_intersect_alpha
    # contact=False: subpath and connection rays start on geometry.
    key = _ray_sort_key(scene, o, d, active, contact=False)
    order = torch.argsort(key, stable=True)
    hit = isect_fn(scene, o[order], d[order],
                   f=None if f is None else f[order], active=active[order])
    return type(hit)(*(None if h is None else _unsort(order, h)
                       for h in hit))


def _sorted_occluded(scene: FlatScene, o, d, tmax, active, f=None,
                     occl_fn=None):
    """The occlusion query with the same sort around the cast."""
    occl_fn = occl_fn or scene_occluded
    key = _ray_sort_key(scene, o, d, active, contact=False)
    order = torch.argsort(key, stable=True)
    occ = occl_fn(scene, o[order], d[order], RAY_EPSILON, tmax[order],
                  f=None if f is None else f[order], active=active[order])
    return _unsort(order, occ)


def _empty_subpath(scene: FlatScene, r: int, s_dim: int, adjoint: bool,
                   dev):
    """The (0, R, ...) tables of a subpath with no bounce."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros((0, r) + shape, dtype=dtype, device=dev)

    b = torch.bool
    steps = Vertices(
        valid=z(dtype=b), p=z(3), gn=z(3), tangent=z(3), bitangent=z(3),
        sn=z(3), uv=z(2), mat_id=z(dtype=torch.int64), dir_in_sn=z(3),
        alpha=z(s_dim), area_pdf=z(), rr_prob=z(), rev_area_pdf=z(),
        rev_rr_prob=z(), delta=z(dtype=b), is_light0=z(dtype=b),
        wl_flag=z(dtype=b), at_inf=z(dtype=b))
    n_lobes = scene.materials.lobe_kind.shape[1]
    lobes = LobeBatch(kind=z(n_lobes, dtype=torch.int64),
                      s0=z(n_lobes, s_dim), s1=z(n_lobes, s_dim),
                      s2=z(n_lobes, s_dim), f0=z(n_lobes), f1=z(n_lobes),
                      kinds=scene.lobe_kinds_present)
    s0 = None if adjoint else (z(dtype=b), z(s_dim), z(), z(), z(dtype=b))
    return steps, s0, lobes


def _generate_subpath(
    scene: FlatScene,
    o: Tensor,
    d: Tensor,
    alpha0: Tensor,
    dir_pdf0: Tensor,
    cos_last0: Tensor,
    delta0: Tensor,
    prev_p: Tensor,
    adjoint: bool,
    seed,
    pixel_id: Tensor,
    sample_id: Tensor,
    hero: Tensor,
    wl_selected0: Tensor,
    lambdas,
    max_verts: int,
    bounce_offset: int,
    f_time: Tensor | None = None,
    cast_fns=None,
):
    """Trace a subpath (generateSubPath): `max_verts` bounces, ended lanes
    riding along inactive.

    Returns (steps, s0_info, zero_step, lobes, alive): `steps` the Vertices
    of the bounces stacked (V, R, ...); `s0_info` the eye path's s = 0 terms
    stacked (V, ...) (None for light paths); `zero_step` the reverse-pdf
    update of the vertex before the first bounce; `lobes` each vertex's
    LobeBatch stacked (V, ...) for the connection stage; `alive` (R,) bool:
    the subpath was still extending at the cap (its estimate is clipped;
    `render_bpt` re-runs such lanes deeper). `f_time` is the per-lane
    shutter fraction of every cast."""
    r = o.shape[0]
    dev = o.device
    s_dim = alpha0.shape[-1]
    ones = torch.ones((r,), dtype=torch.float32, device=dev)
    false_ = torch.zeros((r,), dtype=torch.bool, device=dev)
    isect_fn = None if cast_fns is None else cast_fns[0]
    env_eye = scene.has_env and not adjoint

    if max_verts == 0:
        # A degenerate cap (max_eye_verts=1: the lens vertex alone).
        steps, s0_info, lobes = _empty_subpath(scene, r, s_dim, adjoint, dev)
        return steps, s0_info, (false_, ones, ones), lobes, dir_pdf0 > 0

    alpha, dir_pdf, cos_last, delta = alpha0, dir_pdf0, cos_last0, delta0
    active, wl_sel, ray_o, ray_d = dir_pdf0 > 0, wl_selected0, o, d
    prev, rr_prob = prev_p, ones
    step_rows, rev_rows, s0_rows, lobe_rows = [], [], [], []
    for b in range(max_verts):
        bounce_id = bounce_offset + b
        hit = _sorted_cast(scene, ray_o, ray_d, active, f=f_time,
                           isect_fn=isect_fn)
        sp = resolve_sp(scene, hit, ray_o, ray_d, f=f_time)
        ok = active & hit.mask
        # Escaped active eye rays become environment-sphere vertices: they
        # give the s = 0 environment term and end there.
        esc = active & ~hit.mask if env_eye else false_

        dsp_ = sp.p - prev
        dist2 = torch.clamp(dot(dsp_, dsp_), min=1e-12)
        wo = frame_to_local(sp.tangent, sp.bitangent, sp.sn, -ray_d)
        gn_sn = frame_to_local(sp.tangent, sp.bitangent, sp.sn, sp.gn)
        area_pdf = dir_pdf * dot(wo, gn_sn).abs() / dist2
        if env_eye:
            # An environment vertex: dist2 = 1, |cos| = 1.
            area_pdf = torch.where(esc, dir_pdf, area_pdf)

        step_rows.append(Vertices(
            valid=ok, p=sp.p, gn=sp.gn, tangent=sp.tangent,
            bitangent=sp.bitangent, sn=sp.sn, uv=sp.uv, mat_id=sp.mat_id,
            dir_in_sn=wo, alpha=torch.where(ok[:, None], alpha, 0.0),
            area_pdf=area_pdf, rr_prob=rr_prob, rev_area_pdf=ones,
            rev_rr_prob=ones, delta=delta, is_light0=false_, wl_flag=wl_sel,
            at_inf=false_))

        if not adjoint:
            # s = 0: the eye path hit an emitter, or escaped to the
            # environment sphere.
            le = emitted_radiance(scene, sp.mat_id, sp.uv, dot(-ray_d, sp.sn),
                                  lambdas)
            ext1 = _area_light_prob(scene) * sp.area_pdf
            # The EDF's pdf toward the previous vertex: cosine hemisphere.
            edf_pdf = torch.clamp(wo[..., 2], min=0.0) * _INV_PI
            ext2 = edf_pdf * cos_last / dist2
            emit_ok = ok & is_emissive(scene.materials, sp.mat_id)
            contrib = alpha * le
            if scene.has_env:
                eu, ev_ = _env_uv_from_direction(ray_d)
                env_le = _env_radiance(scene, eu, ev_, lambdas)
                env_uvpdf = pdf_continuous_2d(scene.env.dist, eu, ev_)
                env_area_pdf = env_uvpdf / torch.clamp(
                    2.0 * math.pi ** 2 * torch.sin(ev_ * math.pi), min=1e-8)
                disc_pdf = 1.0 / (math.pi * scene.world_radius
                                  * scene.world_radius)
                ext1 = torch.where(esc, scene.lights.env_prob * env_area_pdf,
                                   ext1)
                ext2 = torch.where(esc, disc_pdf * cos_last, ext2)
                contrib = torch.where(esc[:, None], alpha * env_le, contrib)
                emit_ok = emit_ok | esc
            s0_rows.append((emit_ok, contrib, ext1, ext2, wl_sel))

        # The BSDF sample that extends the path; light subpaths sample the
        # adjoint form. The gathered lobes are also this vertex's closure in
        # the connection stage.
        lobes = gather_lobes(scene, sp.mat_id, sp.uv, sp.p, lambdas)
        lobe_rows.append(lobes)
        uc = rng.uniform(seed, pixel_id, sample_id, bounce_id,
                         Decision.BSDF_COMPONENT)
        u0 = rng.uniform(seed, pixel_id, sample_id, bounce_id,
                         Decision.BSDF_U)
        u1 = rng.uniform(seed, pixel_id, sample_id, bounce_id,
                         Decision.BSDF_V)
        smp = bsdf_sample(lobes, wo, gn_sn, hero, wl_sel, uc, u0, u1,
                          adjoint=adjoint)
        # The raw pdf stays in the subpath weights and the MIS; the hero
        # collapse is accounted for at contribution time only (x N on the
        # s = 0 and t = 1 terms, 1/wlProb on connections).
        new_dir_pdf = smp.pdf
        wl_sel_next = wl_sel | smp.dispersive

        cos_in = dot(smp.wi, gn_sn).abs()
        weight = smp.fs * (cos_in
                           / torch.clamp(new_dir_pdf, min=1e-30))[:, None]
        new_rr = torch.clamp(importance(weight, hero), max=1.0)
        u_rr = rng.uniform(seed, pixel_id, sample_id, bounce_id, Decision.RR)
        survive = u_rr < new_rr
        weight = weight / torch.clamp(new_rr, min=1e-30)[:, None]
        sample_ok = ok & (new_dir_pdf > 0) & ~(smp.fs == 0.0).all(-1)

        # The reverse pdf and fs of this bounce, for the previous vertex. A
        # delta bounce takes the sampler's reverse info: the generic
        # evaluators are 0 at delta directions.
        rev_pdf = torch.where(smp.is_delta, smp.rev_pdf,
                              bsdf_pdf(lobes, smp.wi, wo, gn_sn, hero))
        rev_fs = torch.where(smp.is_delta[..., None], smp.rev_fs,
                             bsdf_evaluate(lobes, smp.wi, wo, gn_sn, hero,
                                           adjoint=not adjoint))
        rev_area = rev_pdf * cos_last / dist2
        rev_rr = torch.clamp(importance(
            rev_fs * (dot(wo, gn_sn).abs()
                      / torch.clamp(rev_pdf, min=1e-30))[:, None], hero),
            max=1.0)
        upd = sample_ok & survive
        rev_rows.append((upd, rev_area, rev_rr))

        alpha = alpha * weight
        dir_pdf = new_dir_pdf
        cos_last = cos_in
        delta = smp.is_delta
        active = upd
        wl_sel = wl_sel_next
        ray_o = sp.p
        ray_d = frame_from_local(sp.tangent, sp.bitangent, sp.sn, smp.wi)
        prev = sp.p
        rr_prob = new_rr

    steps = _stack(step_rows)
    upd_s, rev_area_s, rev_rr_s = _stack(rev_rows)
    # Each bounce's reverse pdf and fs belong to the PREVIOUS vertex: shift
    # them back by one row. Bounce 0's entry targets the vertex before the
    # loop (returned as zero_step); the last vertex keeps ones.
    ones_tail = torch.ones((1, r), dtype=torch.float32, device=dev)
    steps = steps._replace(
        rev_area_pdf=torch.cat(
            [torch.where(upd_s[1:], rev_area_s[1:], 1.0), ones_tail]),
        rev_rr_prob=torch.cat(
            [torch.where(upd_s[1:], rev_rr_s[1:], 1.0), ones_tail]))
    zero_step = (upd_s[0], rev_area_s[0], rev_rr_s[0])
    s0_info = _stack(s0_rows) if s0_rows else None
    return steps, s0_info, zero_step, _stack(lobe_rows), active


class _Film:
    """A batch's deferred film writes: own-pixel contributions accumulate
    in a per-lane buffer (one bin and one add at the end: all of a lane's
    contributions share its wavelengths), t = 1 splats queue for one
    scatter-add. `lane_mask` and `bank` gate every write; a splat batch is
    an s-major tiling of the lane axis."""

    def __init__(self, r, s_dim, lane_mask, dev):
        self.own = torch.zeros((r, s_dim), dtype=torch.float32, device=dev)
        self.splats = []
        self.lane_mask = lane_mask
        self.bank = None

    def _gate(self, valid):
        for m in (self.lane_mask, self.bank):
            if m is not None:
                valid = valid & m.repeat(valid.shape[0] // m.shape[0])
        return valid

    def add_own(self, contribution):
        valid = self._gate(torch.ones(contribution.shape[:1], dtype=torch.bool,
                                      device=contribution.device))
        self.own = self.own + torch.where(valid[:, None], contribution, 0.0)

    def add_splat(self, pix, contribution, valid):
        valid = self._gate(valid)
        self.splats.append((pix, torch.where(valid[:, None], contribution,
                                             0.0)))

    def flush(self, film, pid_c, lambdas, pid_start):
        from ..spectrum.spectral import bin_to_strata

        own = self.own
        if lambdas is not None:
            own = bin_to_strata(lambdas, own)
        if pid_start is not None:
            film[pid_start:pid_start + own.shape[0]] += own
        else:
            film.index_add_(0, pid_c, own)
        if self.splats:
            idx = torch.cat([p for p, _ in self.splats])
            vals = [v if lambdas is None else bin_to_strata(
                lambdas.repeat(v.shape[0] // lambdas.shape[0], 1), v)
                for _, v in self.splats]
            film.index_add_(0, idx, torch.cat(vals))
        return film


def bpt_batch(
    scene: FlatScene,
    pixel_id: Tensor,
    sample_id: Tensor,
    seed,
    width: int,
    height: int,
    film: Tensor,
    max_light_verts: int = 8,
    max_eye_verts: int = 8,
    pid_contiguous: bool = False,
    lane_mask: Tensor | None = None,
    clip_at_cap: bool = False,
    cast_fns=None,
):
    """One BPT sample pass over a pixel batch: adds its contributions, t = 1
    splats included, into `film` (H*W, S) in place and returns it (and,
    with `clip_at_cap`, the (R,) overflow mask: lanes whose subpath was
    still extending at a cap, which then bank nothing). `pid_contiguous`
    promises that pixel_id is an in-range arange, so the own-pixel add is a
    slice add. `lane_mask` (R,) drops padding lanes. `cast_fns =
    (intersect_fn, occluded_fn)` replaces the two casts (the signatures of
    `scene_intersect_alpha` and `scene_occluded`)."""
    from ..spectrum.spectral import (
        NUM_SPECTRAL_SAMPLES,
        WL_HI,
        WL_LO,
        sample_wavelengths,
    )

    dev = film.device
    r = pixel_id.shape[0]
    spectral = scene.stex.spectral
    s_dim = NUM_SPECTRAL_SAMPLES if spectral else scene.stex.value.shape[-1]
    seed = rng.u32(seed)
    pid_c = torch.clamp(rng.u32(pixel_id), max=width * height - 1)
    sample_id = rng.u32(sample_id)
    px = (pid_c % width).to(torch.float32)
    py = (pid_c // width).to(torch.float32)
    ones = torch.ones((r,), dtype=torch.float32, device=dev)
    false_ = torch.zeros((r,), dtype=torch.bool, device=dev)

    def u(decision):
        return rng.uniform(seed, pid_c, sample_id, 0, decision)

    u_wl = u(Decision.WL_SELECT)
    if spectral:
        wls = sample_wavelengths(u(Decision.WAVELENGTH), u_wl)
        lambdas, hero = wls.lambdas, wls.hero
        select_wl_pdf = NUM_SPECTRAL_SAMPLES / (WL_HI - WL_LO)
    else:
        lambdas = None
        hero = torch.clamp((u_wl * s_dim).to(torch.int64), max=s_dim - 1)
        select_wl_pdf = 1.0
    # One shutter time per pixel sample, through every cast of both
    # subpaths and the connections.
    f_time = u(Decision.TIME) if scene.instances is not None else None

    out = _Film(r, s_dim, lane_mask, dev)

    # ------------------------------------------------------------------
    # Light subpath. With an environment light, lanes pick the environment
    # or an area light by importance; environment lanes start on the
    # infinite sphere: the vertex's position is the sampled direction, its
    # EDF emits inward with pdf 1/(pi R^2), and the ray leaves from a disk
    # offset perpendicular to it, outside the scene.
    # ------------------------------------------------------------------
    u_sel = u(Decision.LIGHT_SELECT)
    lu0, lu1 = u(Decision.LIGHT_POS_U), u(Decision.LIGHT_POS_V)
    env_prob = scene.lights.env_prob
    if scene.has_env:
        is_env0 = u_sel < env_prob
        u_area = torch.clamp((u_sel - env_prob)
                             / torch.clamp(1.0 - env_prob, min=1e-12),
                             0.0, 1.0 - 1e-7)
    else:
        is_env0 = false_
        u_area = u_sel
    idx, pmf, _ = sample_discrete_1d(scene.lights.dist, u_area)
    light_tri = scene.lights.tri_idx.to(torch.int64)[idx]
    light_prob = (1.0 - env_prob) * pmf
    lp = sample_triangle_point(scene.geometry, light_tri, lu0, lu1)
    light_area_pdf = light_prob * lp.area_pdf
    # The emittance M = pi Le; emitted_radiance returns Le = M / pi.
    le0 = emitted_radiance(scene, lp.mat_id, lp.uv, ones, lambdas) * math.pi

    eu0, eu1 = u(Decision.EDF_U), u(Decision.EDF_V)
    edf_dir = cosine_sample_hemisphere(eu0, eu1)
    edf_pdf = torch.clamp(edf_dir[..., 2], min=1e-12) * _INV_PI
    le1 = torch.full((r, s_dim), _INV_PI, device=dev)
    l_ray_d = frame_from_local(lp.tangent, lp.bitangent, lp.sn, edf_dir)
    l_ray_o = lp.p
    cos_first = edf_dir[..., 2]
    v0_p, v0_gn, v0_tan = lp.p, lp.gn, lp.tangent
    v0_bit, v0_sn, v0_uv = lp.bitangent, lp.sn, lp.uv

    if scene.has_env:
        ex, ey, uvpdf = sample_continuous_2d(scene.env.dist, lu0, lu1)
        e_phi = ex * 2.0 * math.pi
        e_theta = ey * math.pi
        p_env = _env_direction(e_phi, e_theta)
        env_area_pdf = env_prob * uvpdf / torch.clamp(
            2.0 * math.pi ** 2 * torch.sin(e_theta), min=1e-8)
        gn_env = -p_env
        # The shading frame on the sphere.
        tan_env = normalize(torch.stack(
            [-torch.cos(e_phi), torch.zeros_like(e_phi), -torch.sin(e_phi)],
            dim=-1))
        bit_env = cross(gn_env, tan_env)
        le0_env = math.pi * _env_radiance(scene, ex, ey, lambdas)
        disc_pdf = 1.0 / (math.pi * scene.world_radius * scene.world_radius)
        dx, dy = concentric_sample_disk(eu0, eu1)
        origin_env = (scene.world_center[None, :]
                      + 1.1 * scene.world_radius * p_env
                      + scene.world_radius * (dx[:, None] * tan_env
                                              + dy[:, None] * bit_env))
        e0 = is_env0[:, None]
        v0_p = torch.where(e0, p_env, v0_p)
        v0_gn = torch.where(e0, gn_env, v0_gn)
        v0_tan = torch.where(e0, tan_env, v0_tan)
        v0_bit = torch.where(e0, bit_env, v0_bit)
        v0_sn = torch.where(e0, gn_env, v0_sn)
        v0_uv = torch.where(e0, torch.stack([ex, ey], dim=-1), v0_uv)
        le0 = torch.where(e0, le0_env, le0)
        light_area_pdf = torch.where(is_env0, env_area_pdf, light_area_pdf)
        l_ray_d = torch.where(e0, gn_env, l_ray_d)
        l_ray_o = torch.where(e0, origin_env, l_ray_o)
        edf_pdf = torch.where(is_env0, disc_pdf, edf_pdf)
        cos_first = torch.where(is_env0, 1.0, cos_first)

    zeros3 = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    l_v0 = Vertices(
        valid=~false_, p=v0_p, gn=v0_gn, tangent=v0_tan, bitangent=v0_bit,
        sn=v0_sn, uv=v0_uv, mat_id=lp.mat_id, dir_in_sn=zeros3,
        alpha=le0 / torch.clamp(light_area_pdf, min=1e-30)[:, None],
        area_pdf=light_area_pdf, rr_prob=ones, rev_area_pdf=ones,
        rev_rr_prob=ones, delta=false_, is_light0=~false_, wl_flag=false_,
        at_inf=is_env0)
    cos_o = torch.where(is_env0, 1.0, dot(l_ray_d, lp.gn).abs())
    l_alpha1 = l_v0.alpha * le1 * (cos_o / edf_pdf)[:, None]
    l_steps, _, l_zero, l_lobes, l_alive = _generate_subpath(
        scene, l_ray_o, l_ray_d, l_alpha1, edf_pdf, cos_first, false_,
        l_ray_o, True, seed, pid_c, sample_id, hero, false_, lambdas,
        max_light_verts - 1, _LIGHT_BOUNCE_OFFSET, f_time=f_time,
        cast_fns=cast_fns)
    # Light vertex 0's reverse pdfs come from the first bounce.
    upd, rev_area, rev_rr = l_zero
    l_v0 = l_v0._replace(
        rev_area_pdf=torch.where(upd, rev_area, l_v0.rev_area_pdf),
        rev_rr_prob=torch.where(upd, rev_rr, l_v0.rev_rr_prob))
    lv = _prepend_v0(l_v0, l_steps)

    # ------------------------------------------------------------------
    # Eye subpath: the lens vertex of the perspective or equirect camera.
    # ------------------------------------------------------------------
    cam = scene.camera
    lx, ly = u(Decision.LENS_U), u(Decision.LENS_V)
    jx, jy = u(Decision.PIXEL_X), u(Decision.PIXEL_Y)
    is_equirect = cam.kind == CameraKind.EQUIRECTANGULAR
    n3 = cam.to_world[:3, 2]
    x3 = cam.to_world[:3, 0]
    y3 = cross(n3, x3)
    lens_n = torch.broadcast_to(n3, (r, 3))
    lens_x = torch.broadcast_to(x3, (r, 3))
    lens_y = torch.broadcast_to(y3, (r, 3))
    if is_equirect:
        # A delta lens at the origin; phi = phiAngle u, theta = thetaAngle v,
        # with the mapping's true density as the direction pdf.
        dx = torch.zeros((r,), dtype=torch.float32, device=dev)
        dy = dx
        lens_p = transform_point(cam.to_world, zeros3)
        lens_area_pdf = torch.ones((), dtype=torch.float32, device=dev)
        sensitivity = lens_area_pdf
        phi_e = cam.phi_angle * ((px + jx) / width)
        theta_e = cam.theta_angle * ((py + jy) / height)
        st_e = torch.sin(theta_e)
        dir_local = torch.stack([-torch.sin(phi_e) * st_e,
                                 torch.cos(theta_e),
                                 torch.cos(phi_e) * st_e], dim=-1)
        we_dir_pdf = 1.0 / (cam.phi_angle * cam.theta_angle
                            * torch.clamp(st_e.abs(), min=1e-6))
        z_l = dir_local[..., 2]
        v0_delta = ~false_
    else:
        op_w, op_h, img_area = camera_derived(cam)
        dx, dy = concentric_sample_disk(lx, ly)
        org_local = torch.stack([cam.lens_radius * dx, cam.lens_radius * dy,
                                 torch.zeros_like(dx)], dim=-1)
        lens_p = transform_point(cam.to_world, org_local)
        lens_area_pdf = torch.where(
            cam.lens_radius > 0,
            1.0 / (math.pi * torch.clamp(cam.lens_radius, min=1e-12) ** 2),
            1.0)
        sensitivity = lens_area_pdf
        sx = (px + jx) / width
        sy = (py + jy) / height
        p_focus = torch.stack([op_w * (0.5 - sx), op_h * (0.5 - sy),
                               torch.broadcast_to(cam.obj_dist, sx.shape)],
                              dim=-1)
        dir_local = normalize(p_focus - org_local)
        z_l = dir_local[..., 2]
        we_dir_pdf = (cam.img_dist * cam.img_dist) / (z_l * z_l * z_l
                                                      * img_area)
        v0_delta = torch.broadcast_to(cam.lens_radius == 0.0, (r,))
    e_ray_d = transform_vector(cam.to_world, dir_local)

    e_v0 = Vertices(
        valid=~false_, p=lens_p, gn=lens_n, tangent=lens_x, bitangent=lens_y,
        sn=lens_n, uv=torch.stack([dx, dy], dim=-1),
        mat_id=torch.full((r,), -1, dtype=torch.int64, device=dev),
        dir_in_sn=zeros3,
        alpha=torch.ones((r, s_dim), device=dev)
        * (sensitivity / (lens_area_pdf * select_wl_pdf)),
        area_pdf=ones * lens_area_pdf, rr_prob=ones, rev_area_pdf=ones,
        rev_rr_prob=ones, delta=v0_delta, is_light0=false_, wl_flag=false_,
        at_inf=false_)
    # The cosine at the lens in the camera's local frame.
    e_alpha1 = e_v0.alpha * (z_l.abs() / we_dir_pdf)[:, None]
    e_steps, s0_info, e_zero, e_lobes, e_alive = _generate_subpath(
        scene, lens_p, e_ray_d, e_alpha1, we_dir_pdf, dir_local[..., 2],
        false_, lens_p, False, seed, pid_c, sample_id, hero, false_, lambdas,
        max_eye_verts - 1, 0, f_time=f_time, cast_fns=cast_fns)
    # A lane whose subpath still extended at its cap carries a clipped
    # estimate; with clip_at_cap it banks nothing here, and the caller runs
    # it again deeper (the same streams reproduce the short prefix).
    overflow = l_alive | e_alive
    if lane_mask is not None:
        overflow = overflow & lane_mask
    if clip_at_cap:
        out.bank = ~overflow
    upd, rev_area, rev_rr = e_zero
    e_v0 = e_v0._replace(
        rev_area_pdf=torch.where(upd, rev_area, e_v0.rev_area_pdf),
        rev_rr_prob=torch.where(upd, rev_rr, e_v0.rev_rr_prob))
    ev = _prepend_v0(e_v0, e_steps)

    n_l = lv.valid.shape[0]
    n_e = ev.valid.shape[0]
    mis_l = _mis_incremental(lv, n_l, 0)
    mis_e = _mis_incremental(ev, n_e, 1)

    # ------------------------------------------------------------------
    # s = 0 terms, over the eye vertex axis (row i <-> t = i + 2), with the
    # incremental MIS partial sums (no light side at s = 0).
    # ------------------------------------------------------------------
    emit_ok0, contrib0, ext1_0, ext2_0, wl_sel0 = s0_info
    d_e, zb_e, s_e = mis_e
    c1_0 = _safe_div(ext1_0, d_e[1:])
    c2_0 = _safe_div(ext2_0, d_e[:-1])
    w0 = 1.0 / (1.0 + zb_e[1:] * c1_0 * c1_0 + (c1_0 * c2_0) ** 2 * s_e[2:])
    # A huge pdf ratio squared can give inf * 0 = NaN, which emit_ok0
    # would not gate.
    w0 = torch.where(torch.isfinite(w0), w0, 0.0)
    c0 = contrib0 * w0[..., None]
    # x N where the hero wavelength (or, in RGB, the hero channel) was
    # collapsed; 1/selectWLPDF is in the eye vertex 0 alpha already.
    c0 = torch.where(wl_sel0[..., None], c0 * s_dim, c0)
    out.add_own(torch.where(emit_ok0[..., None], c0, 0.0).sum(0))

    # ------------------------------------------------------------------
    # Connections s >= 1, t >= 1: one eye level t at a time, every s at
    # once, with one any-hit cast of n_l * R shadow rays per level.
    # ------------------------------------------------------------------
    if n_l > 1:
        row0 = _tree_at(l_lobes, 0)   # a dummy closure for the EDF endpoint
    else:
        row0 = _tmap(lambda x: torch.zeros(x.shape[1:], dtype=x.dtype,
                                           device=dev), l_lobes)
    lobes_l = _tree_prepend(row0, l_lobes)
    f_b = None if f_time is None else f_time.repeat(n_l)
    occl_fn = None if cast_fns is None else cast_fns[1]
    for t in range(1, n_e + 1):
        (o_b, d_b, tmax_b, act_b), contribution, valid, splat_pix, own = \
            _connect_t(scene, lv, ev, t, hero, s_dim, pid_c, width, height,
                       cam, lobes_l,
                       None if t == 1 else _tree_at(e_lobes, t - 2),
                       mis_l, mis_e)
        vis = ~_sorted_occluded(scene, o_b, d_b, tmax_b, act_b, f=f_b,
                                occl_fn=occl_fn)
        ok = valid & vis.reshape(n_l, r)
        if own:
            out.add_own(torch.where(ok[..., None], contribution, 0.0).sum(0))
        else:
            out.add_splat(splat_pix, _flat(contribution), _flat(ok))
    film = out.flush(film, pid_c, lambdas,
                     int(pid_c[0]) if pid_contiguous else None)
    if clip_at_cap:
        return film, overflow
    return film


def _connect_t(scene, lv, ev, t, hero, s_dim, pid_c, width, height, cam,
               lobes_l, e_lobes, mis_l, mis_e):
    """Every s strategy of one eye level t, over the light-vertex axis
    (s = row + 1). The BSDF evaluations run on the (n_l * R) lanes
    flattened s-major; the MIS weight is an O(1) combination of the
    `_mis_incremental` partial sums.

    Returns (shadow query (o, d, tmax, active), each (n_l * R, ...)
    s-major; contribution (n_l, R, S); valid (n_l, R); splat_pix; own)."""
    r = pid_c.shape[0]
    n_l = lv.valid.shape[0]
    dev = pid_c.device
    ei = t - 1
    valid = lv.valid & ev.valid[ei][None]
    hero_b = _rep(hero, n_l)

    def evaluate(lob, wo, wi, gn, adjoint):
        return bsdf_evaluate(lob, wo, wi, gn, hero_b,
                             adjoint=adjoint).reshape(n_l, r, -1)

    def pdf(lob, wo, wi, gn):
        return bsdf_pdf(lob, wo, wi, gn, hero_b).reshape(n_l, r)

    def imp(values):
        return importance(values, hero)

    # An environment light endpoint: its "position" is a unit direction,
    # with dist2 = 1 and cos_light = 1.
    at_l = lv.at_inf                                     # (n_l, R)
    raw = lv.p - ev.p[ei][None]                          # (n_l, R, 3)
    raw2 = torch.clamp(dot(raw, raw), min=1e-12)
    conn = torch.where(at_l[..., None], lv.p, raw)
    dist2 = torch.where(at_l, 1.0, raw2)
    conn_dir = conn / torch.sqrt(torch.clamp(dot(conn, conn),
                                             min=1e-12))[..., None]
    cos_light = dot(conn_dir, lv.gn).abs()
    cos_eye = dot(conn_dir, ev.gn[ei][None]).abs()
    g = cos_eye * cos_light / dist2

    # --- light end: rows >= 1 the BSDF; row 0 the EDF endpoint (diffuse:
    # 1/pi above the surface; environment: 1/pi, pdf 1/(pi R^2)) ----------
    l_conn_sn = frame_to_local(lv.tangent, lv.bitangent, lv.sn, -conn_dir)
    l_gn_sn = frame_to_local(lv.tangent, lv.bitangent, lv.sn, lv.gn)
    wo_l = lv.dir_in_sn
    lob_l = _tmap(_flat, lobes_l)
    fl = [_flat(x) for x in (wo_l, l_conn_sn, l_gn_sn)]
    l_ddf = evaluate(lob_l, fl[0], fl[1], fl[2], True)
    l_ext1_dir_pdf = pdf(lob_l, fl[0], fl[1], fl[2])
    e_ext2_dir_pdf = pdf(lob_l, fl[1], fl[0], fl[2])
    l_rev_ddf = evaluate(lob_l, fl[1], fl[0], fl[2], False)
    upper = l_conn_sn[0, :, 2] > 0
    l_ddf0 = torch.where(upper[:, None], _INV_PI, 0.0) * torch.ones(
        (r, s_dim), device=dev)
    l_ext1_dir0 = torch.where(upper, l_conn_sn[0, :, 2] * _INV_PI, 0.0)
    if scene.has_env:
        disc_pdf = 1.0 / (math.pi * scene.world_radius ** 2)
        l_ddf0 = torch.where(at_l[0][:, None], _INV_PI, l_ddf0)
        l_ext1_dir0 = torch.where(at_l[0], disc_pdf, l_ext1_dir0)
    l_ddf[0] = l_ddf0
    l_ext1_dir_pdf[0] = l_ext1_dir0
    e_ext2_dir_pdf[0] = 0.0
    l_rev_ddf[0] = 0.0

    # --- eye end ---------------------------------------------------------
    e_conn_sn = frame_to_local(ev.tangent[ei][None], ev.bitangent[ei][None],
                               ev.sn[ei][None], conn_dir)
    e_gn_sn = frame_to_local(ev.tangent[ei], ev.bitangent[ei], ev.sn[ei],
                             ev.gn[ei])                  # (R, 3)
    zeros_ls = torch.zeros((n_l, r), device=dev)
    if t == 1 and cam.kind == CameraKind.EQUIRECTANGULAR:
        # The equirect IDF: 1 inside the angular window, the mapping's
        # density as pdf, and calculatePixel (the inverse mapping).
        y_c = torch.clamp(e_conn_sn[..., 1], -1.0, 1.0)
        theta_c = torch.arccos(y_c)
        phi_c = torch.atan2(-e_conn_sn[..., 0], e_conn_sn[..., 2])
        phi_c = torch.where(phi_c < 0, phi_c + 2.0 * math.pi, phi_c)
        in_img = (phi_c <= cam.phi_angle) & (theta_c <= cam.theta_angle)
        sin_c = torch.clamp(torch.sin(theta_c), min=1e-6)
        e_ddf = torch.where(in_img[..., None], 1.0, 0.0) * torch.ones(
            (n_l, r, s_dim), device=dev)
        e_ext1_dir_pdf = torch.where(
            in_img, 1.0 / (cam.phi_angle * cam.theta_angle * sin_c), 0.0)
        l_ext2_dir_pdf = zeros_ls
        e_rev_ddf = torch.zeros((n_l, r, s_dim), device=dev)
        smp_x = phi_c / cam.phi_angle
        smp_y = theta_c / cam.theta_angle
        splat_pix = _splat_pixels(smp_x, smp_y, width, height)
    elif t == 1:
        # The perspective IDF endpoint: evaluate, and calculatePixel.
        op_w, op_h, img_area = camera_derived(cam)
        zsafe = torch.where(e_conn_sn[..., 2] <= 1e-6, 1e-6,
                            e_conn_sn[..., 2])
        pf = e_conn_sn * (cam.obj_dist / zsafe)[..., None] + torch.stack(
            [cam.lens_radius * ev.uv[ei][:, 0],
             cam.lens_radius * ev.uv[ei][:, 1],
             torch.zeros((r,), device=dev)], dim=-1)[None]
        in_img = ((pf[..., 0] >= -op_w * 0.5) & (pf[..., 0] <= op_w * 0.5)
                  & (pf[..., 1] >= -op_h * 0.5) & (pf[..., 1] <= op_h * 0.5)
                  & (e_conn_sn[..., 2] > 0))
        e_ddf = torch.where(in_img[..., None], 1.0, 0.0) * torch.ones(
            (n_l, r, s_dim), device=dev)
        e_ext1_dir_pdf = torch.where(
            in_img,
            (cam.img_dist ** 2) / torch.clamp(zsafe ** 3 * img_area,
                                              min=1e-12),
            0.0)
        l_ext2_dir_pdf = zeros_ls
        e_rev_ddf = torch.zeros((n_l, r, s_dim), device=dev)
        smp_x = 0.5 - pf[..., 0] / op_w
        smp_y = 0.5 - pf[..., 1] / op_h
        splat_pix = _splat_pixels(smp_x, smp_y, width, height)
    else:
        lob_e = _tmap(lambda x: _rep(x, n_l), e_lobes)
        wo_e = _rep(ev.dir_in_sn[ei], n_l)
        conn_e = _flat(e_conn_sn)
        gn_e = _rep(e_gn_sn, n_l)
        e_ddf = evaluate(lob_e, wo_e, conn_e, gn_e, False)
        e_ext1_dir_pdf = pdf(lob_e, wo_e, conn_e, gn_e)
        l_ext2_dir_pdf = pdf(lob_e, conn_e, wo_e, gn_e)
        e_rev_ddf = evaluate(lob_e, conn_e, wo_e, gn_e, True)
        splat_pix = pid_c

    # The wavelength-collapse probability: a connection touching a subpath
    # that collapsed the hero wavelength (or RGB channel) carries N.
    collapsed = lv.wl_flag | ev.wl_flag[ei][None]
    wl_prob_inv = torch.where(collapsed, float(s_dim), 1.0)
    connection = l_ddf * (g * wl_prob_inv)[..., None] * e_ddf
    nonzero = (connection != 0.0).any(-1)
    # Visibility is cast by the caller, one any-hit call for every s of
    # this level. Environment endpoints only need to clear the world sphere.
    shadow_tmax = torch.where(at_l, 4.0 * scene.world_radius,
                              torch.sqrt(raw2) * (1.0 - 1e-3))
    valid = valid & nonzero
    shadow_q = (_flat(torch.broadcast_to(ev.p[ei][None], (n_l, r, 3))),
                _flat(conn_dir), _flat(shadow_tmax), _flat(valid))

    # The first and second extension pdfs, all (n_l, R) with s = row + 1.
    l_ext1_area = l_ext1_dir_pdf * cos_eye / dist2
    l_ext1_rr = torch.clamp(imp(l_ddf * (cos_light / torch.clamp(
        l_ext1_dir_pdf, min=1e-30))[..., None]), max=1.0)
    l_ext1_rr[0] = 1.0
    if t > 1:
        prev_p = ev.p[ei - 1]
        dev_ = ev.p[ei] - prev_p
        d2 = torch.clamp(dot(dev_, dev_), min=1e-12)
        dir2 = dev_ / torch.sqrt(d2)[:, None]
        l_ext2_area = l_ext2_dir_pdf * (
            dot(ev.gn[ei - 1], dir2).abs() / d2)[None]
        l_ext2_rr = torch.clamp(imp(
            e_rev_ddf * (dot(e_gn_sn, ev.dir_in_sn[ei]).abs()[None]
                         / torch.clamp(l_ext2_dir_pdf, min=1e-30))[..., None]),
            max=1.0)
    else:
        l_ext2_area = zeros_ls
        l_ext2_rr = zeros_ls

    e_ext1_area = e_ext1_dir_pdf * cos_light / dist2
    if t > 1:
        e_ext1_rr = torch.clamp(imp(e_ddf * (cos_eye / torch.clamp(
            e_ext1_dir_pdf, min=1e-30))[..., None]), max=1.0)
    else:
        e_ext1_rr = torch.ones((n_l, r), device=dev)
    # Rows >= 1: the pdf of extending the light path again from vertex
    # s - 2 to s - 1; a previous vertex at infinity keeps dist2 = 1 and
    # |cos| = 1.
    prev_lp = torch.cat([lv.p[:1], lv.p[:-1]])
    prev_gn = torch.cat([lv.gn[:1], lv.gn[:-1]])
    prev_inf = torch.cat([at_l[:1], at_l[:-1]])
    dlv_ = lv.p - prev_lp
    d2l = torch.clamp(dot(dlv_, dlv_), min=1e-12)
    dir2l = dlv_ / torch.sqrt(d2l)[..., None]
    e_ext2_area = e_ext2_dir_pdf * dot(prev_gn, dir2l).abs() / d2l
    if scene.has_env:
        e_ext2_area = torch.where(prev_inf, e_ext2_dir_pdf, e_ext2_area)
    e_ext2_area[0] = 0.0
    e_ext2_rr = torch.clamp(imp(l_rev_ddf * (
        dot(l_gn_sn, lv.dir_in_sn).abs()
        / torch.clamp(e_ext2_dir_pdf, min=1e-30))[..., None]), max=1.0)
    e_ext2_rr[0] = 0.0

    # The MIS weight from the incremental partial sums.
    d_l, zb_l, s_l = mis_l
    d_e, zb_e, s_e = mis_e
    c1l = _safe_div(e_ext1_area * e_ext1_rr, d_l)
    d_l_prev = torch.cat([torch.ones((1, r), device=dev), d_l[:-1]])
    c2l = _safe_div(e_ext2_area * e_ext2_rr, d_l_prev)
    rec = 1.0 + zb_l * c1l * c1l + (c1l * c2l) ** 2 * s_l[1:]
    if t > 1:
        c1e = _safe_div(l_ext1_area * l_ext1_rr, d_e[t - 1][None])
        c2e = _safe_div(l_ext2_area * l_ext2_rr, d_e[t - 2][None])
        rec = rec + zb_e[t - 1][None] * c1e * c1e \
            + (c1e * c2e) ** 2 * s_e[t][None]
    w = 1.0 / rec
    w = torch.where(torch.isfinite(w), w, 0.0)
    contribution = lv.alpha * connection * ev.alpha[ei][None] * w[..., None]
    return shadow_q, contribution, valid, splat_pix, t != 1


def _splat_pixels(smp_x: Tensor, smp_y: Tensor, width: int,
                  height: int) -> Tensor:
    """Film coordinates in [0, 1)^2 -> (n_l * R,) pixel ids, clamped to the
    image."""
    hit_px = torch.clamp((smp_x * width).to(torch.int32), 0, width - 1)
    hit_py = torch.clamp((smp_y * height).to(torch.int32), 0, height - 1)
    return (hit_py.to(torch.int64) * width + hit_px).reshape(-1)


def render_bpt(
    scene: FlatScene,
    width: int,
    height: int,
    spp: int,
    seed: int = 0,
    max_light_verts: int = 16,
    max_eye_verts: int = 16,
    ray_batch: int | None = None,
    sample_offset: int = 0,
    base_verts: int = 8,
    deep_batch: int | None = None,
    device=None,
) -> Tensor:
    """Full-frame BPT render -> (H, W, 3) linear RGB mean radiance on
    `device` (default: the CUDA device).

    Subpath depth is adaptive (the original renderer's subpaths end by
    Russian roulette alone, and a flat cap clips transported energy): every
    lane first runs at `base_verts` caps; lanes whose subpaths were still
    extending at the cap bank nothing and run again, in `deep_batch`-lane
    batches, at the full `max_*_verts` caps. The base passes are all queued
    before any overflow mask is read back. Passing max_*_verts <=
    base_verts gives one pass at flat caps.

    As in the reference, the base pass takes `base_verts` for both
    subpaths whatever the per-subpath caps, and the padding lanes of a deep
    batch are traced again (masked out of the film)."""
    from ..spectrum.spectral import NUM_STRATA, strata_to_rgb

    scene = scene.to(resolve_device(device))
    dev = scene.device
    n_pix = width * height
    spectral = scene.stex.spectral
    s_film = NUM_STRATA if spectral else scene.stex.value.shape[-1]
    batch = int(ray_batch or min(n_pix, 65536))
    n_batches = -(-n_pix // batch)
    tiered = max(max_light_verts, max_eye_verts) > base_verts

    film = torch.zeros((n_pix, s_film), dtype=torch.float32, device=dev)
    deep_work = []   # (sample index, base offset, overflow mask)
    for i in range(spp):
        sample_id = torch.full((batch,), sample_offset + i,
                               dtype=torch.int64, device=dev)
        for b in range(n_batches):
            pixel_id = torch.arange(b * batch, (b + 1) * batch, device=dev)
            contiguous = (b + 1) * batch <= n_pix
            if not tiered:
                film = bpt_batch(scene, pixel_id, sample_id, seed, width,
                                 height, film, max_light_verts,
                                 max_eye_verts, pid_contiguous=contiguous)
                continue
            film, overflow = bpt_batch(
                scene, pixel_id, sample_id, seed, width, height, film,
                base_verts, base_verts, pid_contiguous=contiguous,
                clip_at_cap=True)
            TIERS["base_lanes"] += batch
            deep_work.append((i, b * batch, overflow))

    for i, base_off, overflow in deep_work:
        idxs = base_off + np.nonzero(overflow.cpu().numpy())[0]
        TIERS["clipped"] += len(idxs)
        if len(idxs) == 0:
            continue
        if deep_batch is None:
            # The smallest size of the ladder that holds the clipped set.
            db = next((n for n in (1024, 4096, 16384) if len(idxs) <= n),
                      65536)
        else:
            db = deep_batch
        db = min(db, batch)
        samp2 = torch.full((db,), sample_offset + i, dtype=torch.int64,
                           device=dev)
        for c0 in range(0, len(idxs), db):
            sel = idxs[c0:c0 + db]
            pad = db - len(sel)
            pix2 = torch.as_tensor(np.concatenate(
                [sel, np.zeros(pad, np.int64)]), device=dev)
            mask2 = torch.as_tensor(np.concatenate(
                [np.ones(len(sel), bool), np.zeros(pad, bool)]), device=dev)
            film = bpt_batch(scene, pix2, samp2, seed, width, height, film,
                             max_light_verts, max_eye_verts, lane_mask=mask2)
            TIERS["deep_lanes"] += db
            TIERS["deep_passes"] += 1
    img = (film / spp).reshape(height, width, s_film)
    if spectral:
        img = strata_to_rgb(img)
    return img
