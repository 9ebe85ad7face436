"""Aggregate BSDF over material lobe tables — one-sample MIS over up to 4
lobes with the shading-normal correction (counterpart of
slr_tpu/bsdf/bsdf.py). Every present lobe kind is evaluated for the whole
batch and the per-lobe kind selects the result.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.math3d import dot as _dot3
from ..scene.textures import eval_float_texture, eval_float_texture_default1, eval_stex
from ..scene.types import FlatScene, LobeKind, Materials
from ..spectrum.rgb import importance
from . import lobes as lb_mod
from .lobes import LobeBatch

Tensor = torch.Tensor


class BSDFSampleResult(NamedTuple):
    wi: Tensor
    fs: Tensor
    pdf: Tensor
    is_delta: Tensor
    dispersive: Tensor
    rev_pdf: Tensor = None
    rev_fs: Tensor = None


def gather_lobes(scene: FlatScene, mat_id: Tensor, uv: Tensor,
                 wpos: Tensor | None = None,
                 lambdas: Tensor | None = None) -> LobeBatch:
    """Evaluate all material textures at the hits: (R,) mat ids -> (R, L)
    lobes. The lobe weight texture (a mixed material's ratio) is folded
    into s0; Voronoi textures are evaluated at the world position `wpos`."""
    mats = scene.materials
    m, l = mats.lobe_kind.shape
    mid = torch.clamp(mat_id, 0, m - 1)
    kind = mats.lobe_kind[mid].to(torch.int64)                 # (R, L)
    stex_ids = mats.lobe_stex[mid].to(torch.int64)             # (R, L, 3)
    ftex_ids = mats.lobe_ftex[mid].to(torch.int64)             # (R, L, 2)
    wtex_ids = mats.lobe_wtex[mid].to(torch.int64)             # (R, L)
    r = kind.shape[0]
    uv_b = uv[:, None, :].expand(r, l, 2).reshape(-1, 2)
    lam_b = (None if lambdas is None else
             lambdas[:, None, :].expand(r, l, lambdas.shape[-1])
             .reshape(-1, lambdas.shape[-1]))
    pos_b = (None if wpos is None else
             wpos[:, None, :].expand(r, l, 3).reshape(-1, 3))

    def ev_s(ids: Tensor) -> Tensor:
        return eval_stex(scene.stex, ids.reshape(-1), uv_b, lam_b,
                         pos_b).reshape(r, l, -1)

    def ev_f(ids: Tensor, default1: bool = False) -> Tensor:
        fn = eval_float_texture_default1 if default1 else eval_float_texture
        return fn(scene.ftex, ids.reshape(-1), uv_b, scene.stex.images,
                  scene.stex.image_hw, pos_b).reshape(r, l)

    s0 = ev_s(stex_ids[..., 0])
    s1 = ev_s(stex_ids[..., 1])
    s2 = ev_s(stex_ids[..., 2])
    f0 = ev_f(ftex_ids[..., 0])
    f1 = ev_f(ftex_ids[..., 1])
    wmul = ev_f(wtex_ids, default1=True)
    s0 = s0 * wmul[..., None]
    return LobeBatch(kind=kind, s0=s0, s1=s1, s2=s2, f0=f0, f1=f1,
                     kinds=scene.lobe_kinds_present)


def _is_kind(kind: Tensor, k: LobeKind) -> Tensor:
    return kind == int(k)


def _have(lobes: LobeBatch, k: LobeKind) -> bool:
    """Can this kind occur in the batch? Absent kinds are never evaluated."""
    return lobes.kinds is None or int(k) in lobes.kinds


def _sanitized(lobes: LobeBatch, kind: LobeKind) -> LobeBatch:
    """Rows not of `kind` get numerically safe parameters, so every kind's
    math stays finite in the branches a `where` discards (gradients
    differentiate both)."""
    m0 = _is_kind(lobes.kind, kind)
    m1 = m0[..., None]
    return LobeBatch(kind=lobes.kind,
                     s0=torch.where(m1, lobes.s0, 0.5),
                     s1=torch.where(m1, lobes.s1, 1.0),
                     s2=torch.where(m1, lobes.s2, 1.5),
                     f0=torch.where(m0, lobes.f0, 0.5),
                     f1=torch.where(m0, lobes.f1, 0.5),
                     kinds=lobes.kinds)


def _any_kind(lobes: LobeBatch, kinds) -> Tensor:
    out = torch.zeros(lobes.kind.shape, dtype=torch.bool,
                      device=lobes.kind.device)
    for k in kinds:
        if _have(lobes, k):
            out = out | _is_kind(lobes.kind, k)
    return out


def _bcast(lobes: LobeBatch, v: Tensor) -> Tensor:
    """(R, ...) per-ray values -> (R, L, ...) per lobe."""
    return v[:, None].expand(lobes.kind.shape + v.shape[1:])


def lobe_weights(lobes: LobeBatch, wo: Tensor, hero: Tensor) -> Tensor:
    """Per-lobe sampling weights (R, L)."""
    wo_b = _bcast(lobes, wo)
    hero_b = _bcast(lobes, hero)
    w = torch.zeros(lobes.kind.shape, dtype=torch.float32, device=wo.device)
    diffuse_like = _any_kind(lobes, (LobeKind.LAMBERT, LobeKind.OREN_NAYAR,
                                     LobeKind.WARD, LobeKind.FLIPPED_LAMBERT))
    w = torch.where(diffuse_like, importance(lobes.s0, hero_b), w)
    for kind, fn in (
            (LobeKind.SPECULAR_REFLECTION, lb_mod.specular_reflection_weight),
            (LobeKind.SPECULAR_SCATTERING, lb_mod.specular_scattering_weight),
            (LobeKind.MICROFACET_REFLECTION,
             lb_mod.microfacet_reflection_weight),
            (LobeKind.MICROFACET_SCATTERING,
             lb_mod.microfacet_reflection_weight),
            (LobeKind.ASHIKHMIN,
             lambda lb, a, h: sum(lb_mod.ashikhmin_weights(lb, a, h)))):
        if _have(lobes, kind):
            w = torch.where(_is_kind(lobes.kind, kind),
                            fn(_sanitized(lobes, kind), wo_b, hero_b), w)
    return torch.clamp(w, min=0.0)


def _eval_internal_all(lobes: LobeBatch, wo: Tensor, wi: Tensor,
                       adjoint: bool = False) -> Tensor:
    """Internal fs per lobe (R, L, S); delta lobes evaluate to zero."""
    wo_b = _bcast(lobes, wo)
    wi_b = _bcast(lobes, wi)
    fs = torch.zeros(lobes.s0.shape, dtype=torch.float32, device=wo.device)
    for kind, fn in (
            (LobeKind.LAMBERT, lb_mod.lambert_eval),
            (LobeKind.FLIPPED_LAMBERT, lb_mod.flipped_lambert_eval),
            (LobeKind.OREN_NAYAR, lb_mod.oren_nayar_eval),
            (LobeKind.MICROFACET_REFLECTION,
             lb_mod.microfacet_reflection_eval),
            (LobeKind.MICROFACET_SCATTERING,
             lambda lb, a, b: lb_mod.microfacet_scattering_eval(
                 lb, a, b, adjoint=adjoint)),
            (LobeKind.WARD, lb_mod.ward_eval),
            (LobeKind.ASHIKHMIN, lb_mod.ashikhmin_eval)):
        if _have(lobes, kind):
            fs = torch.where(_is_kind(lobes.kind, kind)[..., None],
                             fn(_sanitized(lobes, kind), wo_b, wi_b), fs)
    return fs


def _pdf_internal_all(lobes: LobeBatch, wo: Tensor, wi: Tensor,
                      hero: Tensor) -> Tensor:
    """Internal pdf per lobe (R, L); delta lobes have zero pdf."""
    wo_b = _bcast(lobes, wo)
    wi_b = _bcast(lobes, wi)
    hero_b = _bcast(lobes, hero)
    pdf = torch.zeros(lobes.kind.shape, dtype=torch.float32, device=wo.device)
    cosine_like = _any_kind(lobes, (LobeKind.LAMBERT, LobeKind.OREN_NAYAR))
    pdf = torch.where(cosine_like, lb_mod.lambert_pdf(lobes, wo_b, wi_b), pdf)
    for kind, fn in (
            (LobeKind.FLIPPED_LAMBERT,
             lambda lb: lb_mod.flipped_lambert_pdf(lb, wo_b, wi_b)),
            (LobeKind.MICROFACET_REFLECTION,
             lambda lb: lb_mod.microfacet_reflection_pdf(lb, wo_b, wi_b)),
            (LobeKind.MICROFACET_SCATTERING,
             lambda lb: lb_mod.microfacet_scattering_pdf(lb, wo_b, wi_b,
                                                         hero_b)),
            (LobeKind.WARD, lambda lb: lb_mod.ward_pdf(lb, wo_b, wi_b)),
            (LobeKind.ASHIKHMIN,
             lambda lb: lb_mod.ashikhmin_pdf(lb, wo_b, wi_b, hero_b))):
        if _have(lobes, kind):
            pdf = torch.where(_is_kind(lobes.kind, kind),
                              fn(_sanitized(lobes, kind)), pdf)
    return pdf


def _side_match(kind: Tensor, wo: Tensor, wi: Tensor, gn: Tensor) -> Tensor:
    """Geometric side test: a lobe contributes only if its reflection /
    transmission type matches the side of wi; FLIPPED_LAMBERT scatters into
    the opposite hemisphere, so it matches on the transmission side."""
    reflect = (_dot3(wo, gn) * _dot3(wi, gn) > 0.0)[:, None]
    refl_only = torch.zeros(kind.shape, dtype=torch.bool, device=kind.device)
    for k in lb_mod.REFLECTION_ONLY:
        refl_only = refl_only | _is_kind(kind, k)
    scatter = (_is_kind(kind, LobeKind.SPECULAR_SCATTERING)
               | _is_kind(kind, LobeKind.MICROFACET_SCATTERING))
    flipped = _is_kind(kind, LobeKind.FLIPPED_LAMBERT)
    match = torch.where(refl_only, reflect, scatter)
    return torch.where(flipped, ~reflect, match)


def _sn_correction_dir(v: Tensor, gn: Tensor) -> Tensor:
    """Veach shading-normal correction |v.z| / |dot(v, gN_sn)|."""
    return v[..., 2].abs() / torch.clamp(_dot3(v, gn).abs(), min=1e-6)


def bsdf_has_nondelta(lobes: LobeBatch) -> Tensor:
    """(R,) bool — any non-delta lobe present."""
    nondelta = lobes.kind != int(LobeKind.NONE)
    for k in lb_mod.DELTA_KINDS:
        nondelta = nondelta & ~_is_kind(lobes.kind, k)
    return nondelta.any(-1)


def bsdf_evaluate(lobes: LobeBatch, wo: Tensor, wi: Tensor, gn: Tensor,
                  hero: Tensor, adjoint: bool = False) -> Tensor:
    """Full evaluate with side test and sn-correction. Returns (R, S).
    The evaluated lobes are always the radiance-transport ones; `adjoint`
    only moves the correction to the query direction wo."""
    match = _side_match(lobes.kind, wo, wi, gn)
    fs = torch.where(match[..., None], _eval_internal_all(lobes, wo, wi),
                     0.0).sum(1)
    return fs * _sn_correction_dir(wo if adjoint else wi, gn)[..., None]


def bsdf_pdf(lobes: LobeBatch, wo: Tensor, wi: Tensor, gn: Tensor,
             hero: Tensor) -> Tensor:
    """Weighted one-sample-MIS pdf over lobes."""
    w = lobe_weights(lobes, wo, hero)
    sum_w = w.sum(-1)
    pdfs = _pdf_internal_all(lobes, wo, wi, hero)
    pdf = (pdfs * w).sum(-1) / torch.clamp(sum_w, min=1e-30)
    return torch.where(sum_w > 0, pdf, 0.0)


def bsdf_sample(lobes: LobeBatch, wo: Tensor, gn: Tensor, hero: Tensor,
                wl_selected: Tensor, u_comp: Tensor, u0: Tensor, u1: Tensor,
                adjoint: bool = False) -> BSDFSampleResult:
    """One-sample MIS sampling over the lobes (the picked lobe's own
    sample; for non-delta picks the pdf and fs of every lobe at wi).

    wl_selected (R,) bool: the hero wavelength is already collapsed; a glass
    transmission when it is False reports `dispersive=True` so the caller
    divides the pdf by S."""
    r, l = lobes.kind.shape
    w = lobe_weights(lobes, wo, hero)
    sum_w = w.sum(-1)
    cdf = torch.cumsum(w, -1)
    target = u_comp * sum_w
    idx = torch.clamp((cdf <= target[:, None]).sum(-1), max=l - 1)

    def take1(x: Tensor) -> Tensor:
        return torch.gather(x, 1, idx[:, None])[:, 0]

    def take1s(x: Tensor) -> Tensor:
        return torch.gather(
            x, 1, idx[:, None, None].expand(r, 1, x.shape[-1]))[:, 0]

    base = torch.where(idx > 0, torch.gather(
        cdf, 1, torch.clamp(idx - 1, min=0)[:, None])[:, 0], 0.0)
    w_sel = take1(w)
    u_remap = torch.clamp((target - base) / torch.clamp(w_sel, min=1e-30),
                          0.0, 1.0 - 1e-7)
    picked = LobeBatch(kind=take1(lobes.kind), s0=take1s(lobes.s0),
                       s1=take1s(lobes.s1), s2=take1s(lobes.s2),
                       f0=take1(lobes.f0), f1=take1(lobes.f1),
                       kinds=lobes.kinds)
    front = _dot3(wo, gn) > 0.0

    def san(kind):
        return _sanitized(picked, kind)

    samplers = (
        (LobeKind.LAMBERT,
         lambda: lb_mod.lambert_sample(san(LobeKind.LAMBERT), wo, front,
                                       u0, u1)),
        (LobeKind.FLIPPED_LAMBERT,
         lambda: lb_mod.flipped_lambert_sample(
             san(LobeKind.FLIPPED_LAMBERT), wo, front, u0, u1)),
        (LobeKind.OREN_NAYAR,
         lambda: lb_mod.oren_nayar_sample(san(LobeKind.OREN_NAYAR), wo,
                                          front, u0, u1)),
        (LobeKind.SPECULAR_REFLECTION,
         lambda: lb_mod.specular_reflection_sample(
             san(LobeKind.SPECULAR_REFLECTION), wo)),
        (LobeKind.SPECULAR_SCATTERING,
         lambda: lb_mod.specular_scattering_sample(
             san(LobeKind.SPECULAR_SCATTERING), wo, hero, u_remap,
             adjoint=adjoint)),
        (LobeKind.MICROFACET_REFLECTION,
         lambda: lb_mod.microfacet_reflection_sample(
             san(LobeKind.MICROFACET_REFLECTION), wo, u0, u1)),
        (LobeKind.MICROFACET_SCATTERING,
         lambda: lb_mod.microfacet_scattering_sample(
             san(LobeKind.MICROFACET_SCATTERING), wo, hero, u_remap, u0, u1,
             adjoint=adjoint)),
        (LobeKind.WARD,
         lambda: lb_mod.ward_sample(san(LobeKind.WARD), wo, u0, u1)),
        (LobeKind.ASHIKHMIN,
         lambda: lb_mod.ashikhmin_sample(san(LobeKind.ASHIKHMIN), wo, front,
                                         hero, u_remap, u0, u1)),
    )
    outs = [(k, fn()) for k, fn in samplers if _have(lobes, k)]

    def sel(field: str) -> Tensor:
        v = getattr(outs[0][1], field)
        for kind_enum, out in outs[1:]:
            mask = _is_kind(picked.kind, kind_enum)
            val = getattr(out, field)
            if val.ndim > mask.ndim:
                mask = mask[..., None]
            v = torch.where(mask, val, v)
        return v

    wi = sel("wi")
    pdf_sel = sel("pdf")
    fs_sel = sel("fs")
    is_delta = sel("is_delta")
    is_trans = sel("is_transmission")

    def sel_rev(field: str, like: Tensor) -> Tensor:
        v = torch.zeros_like(like)
        for kind_enum, out in outs:
            rv = getattr(out, field)
            if rv is None:
                continue
            mask = _is_kind(picked.kind, kind_enum)
            if rv.ndim > mask.ndim:
                mask = mask[..., None]
            v = torch.where(mask, rv, v)
        return v

    rev_pdf_lobe = sel_rev("rev_pdf", pdf_sel)
    rev_fs_lobe = sel_rev("rev_fs", fs_sel)

    # Combined pdf and fs for non-delta picks.
    pdf = pdf_sel * w_sel
    pdfs_all = _pdf_internal_all(lobes, wo, wi, hero)
    pdf_others = (pdfs_all * w).sum(-1) - take1(pdfs_all) * w_sel
    pdf = torch.where(is_delta, pdf, pdf + pdf_others)
    pdf = pdf / torch.clamp(sum_w, min=1e-30)

    match = _side_match(lobes.kind, wo, wi, gn)
    fs_sum = torch.where(match[..., None],
                         _eval_internal_all(lobes, wo, wi, adjoint=adjoint),
                         0.0).sum(1)
    fs = torch.where(is_delta[..., None], fs_sel, fs_sum)

    ok = (sum_w > 0) & (pdf_sel > 0)
    pdf = torch.where(ok, pdf, 0.0)
    fs = torch.where(ok[..., None], fs, 0.0)
    corr = _sn_correction_dir(wo if adjoint else wi, gn)
    fs = fs * corr[..., None]
    dispersive = is_trans & ~wl_selected & _is_kind(
        picked.kind, LobeKind.SPECULAR_SCATTERING)

    # Reverse delta info at the material level.
    w_rev = lobe_weights(lobes, wi, hero)
    sum_w_rev = w_rev.sum(-1)
    w_rev_sel = take1(w_rev)
    rev_pdf = torch.where(
        is_delta & (sum_w_rev > 0),
        rev_pdf_lobe * w_rev_sel / torch.clamp(sum_w_rev, min=1e-30), 0.0)
    rev_fs = torch.where(is_delta[..., None], rev_fs_lobe * corr[..., None],
                         0.0)
    return BSDFSampleResult(wi=wi, fs=fs, pdf=pdf, is_delta=is_delta,
                            dispersive=dispersive, rev_pdf=rev_pdf,
                            rev_fs=rev_fs)


def emitted_radiance(scene: FlatScene, mat_id: Tensor, uv: Tensor,
                     cos_out: Tensor, lambdas: Tensor | None = None) -> Tensor:
    """Le = emittance / pi on the emitting side. (R, S)."""
    m = scene.materials.emit_stex.shape[0]
    emit_tex = scene.materials.emit_stex[torch.clamp(mat_id, 0, m - 1)].to(
        torch.int64)
    le = eval_stex(scene.stex, emit_tex, uv, lambdas) * (1.0 / math.pi)
    visible = (cos_out > 0.0) & (emit_tex >= 0)
    return torch.where(visible[..., None], le, 0.0)


def is_emissive(mats: Materials, mat_id: Tensor) -> Tensor:
    m = mats.emit_stex.shape[0]
    ok = (mat_id >= 0) & (mat_id < m)
    return ok & (mats.emit_stex[torch.clamp(mat_id, 0, m - 1)] >= 0)
