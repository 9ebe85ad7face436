"""Per-kind BSDF lobes over hit batches (counterpart of
slr_tpu/bsdf/lobes.py). Directions are in the shading frame (z = shading
normal); the aggregate in bsdf.py applies the shading-normal correction.

Every kind of the reference: LAMBERT, FLIPPED_LAMBERT, OREN_NAYAR,
SPECULAR_REFLECTION, SPECULAR_SCATTERING, MICROFACET_REFLECTION,
MICROFACET_SCATTERING (GGX with visible-normal sampling), WARD and
ASHIKHMIN.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..core.math3d import dot, normalize
from ..core.sampling import cosine_sample_hemisphere
from ..scene.types import LobeKind
from ..spectrum.rgb import importance
from .fresnel import fresnel_conductor, fresnel_dielectric

Tensor = torch.Tensor


@dataclasses.dataclass
class LobeBatch:
    """Per-lobe gathered parameters, any batch shape B.
    kind (B,); s0/s1/s2 (B, S) spectrum slots; f0/f1 (B,) float slots;
    kinds: the static set of LobeKind ints that can occur (None = all)."""

    kind: Tensor
    s0: Tensor
    s1: Tensor
    s2: Tensor
    f0: Tensor
    f1: Tensor
    kinds: tuple = None


class SampleOut(NamedTuple):
    wi: Tensor
    pdf: Tensor
    fs: Tensor
    is_delta: Tensor
    is_transmission: Tensor
    rev_pdf: Tensor = None
    rev_fs: Tensor = None


_INV_PI = 1.0 / math.pi

REFLECTION_ONLY = (LobeKind.LAMBERT, LobeKind.OREN_NAYAR,
                   LobeKind.SPECULAR_REFLECTION, LobeKind.MICROFACET_REFLECTION,
                   LobeKind.WARD, LobeKind.ASHIKHMIN)
DELTA_KINDS = (LobeKind.SPECULAR_REFLECTION, LobeKind.SPECULAR_SCATTERING)


def _hero_take(values: Tensor, hero: Tensor) -> Tensor:
    """values (B, S), hero (B,) -> (B,)."""
    return torch.gather(values, -1, hero.to(torch.int64)[..., None])[..., 0]


def _one_hot_hero(value_hero: Tensor, hero: Tensor, s: int) -> Tensor:
    """Place (B,) values into the hero channel of a zero (B, S) spectrum."""
    oh = torch.arange(s, device=hero.device) == hero[..., None]
    return torch.where(oh, value_hero[..., None], 0.0)


def _bools(like: Tensor, value: bool) -> Tensor:
    return torch.full(like.shape, value, dtype=torch.bool, device=like.device)


def _cosine_into(front: Tensor, u0: Tensor, u1: Tensor,
                 flip: bool = False) -> tuple[Tensor, Tensor]:
    """A cosine-weighted direction on wo's side (the other side when
    `flip`) and its pdf."""
    d = cosine_sample_hemisphere(u0, u1)
    z = torch.where(front != flip, d[..., 2], -d[..., 2])
    return torch.cat([d[..., :2], z[..., None]], dim=-1), d[..., 2] * _INV_PI


# Lambert ------------------------------------------------------------------

def lambert_eval(lb: LobeBatch, wo: Tensor, wi: Tensor) -> Tensor:
    same_side = (wo[..., 2] * wi[..., 2]) > 0.0
    return torch.where(same_side[..., None], lb.s0 * _INV_PI, 0.0)


def lambert_pdf(lb: LobeBatch, wo: Tensor, wi: Tensor) -> Tensor:
    same_side = (wo[..., 2] * wi[..., 2]) > 0.0
    return torch.where(same_side, wi[..., 2].abs() * _INV_PI, 0.0)


def lambert_sample(lb: LobeBatch, wo: Tensor, front: Tensor, u0: Tensor,
                   u1: Tensor) -> SampleOut:
    wi, pdf = _cosine_into(front, u0, u1)
    false_ = _bools(pdf, False)
    return SampleOut(wi=wi, pdf=pdf, fs=lb.s0 * _INV_PI, is_delta=false_,
                     is_transmission=false_)


# Flipped Lambert: Lambert scattering into the hemisphere opposite wo ----

def flipped_lambert_eval(lb: LobeBatch, wo: Tensor, wi: Tensor) -> Tensor:
    opposite = (wo[..., 2] * wi[..., 2]) < 0.0
    return torch.where(opposite[..., None], lb.s0 * _INV_PI, 0.0)


def flipped_lambert_pdf(lb: LobeBatch, wo: Tensor, wi: Tensor) -> Tensor:
    opposite = (wo[..., 2] * wi[..., 2]) < 0.0
    return torch.where(opposite, wi[..., 2].abs() * _INV_PI, 0.0)


def flipped_lambert_sample(lb: LobeBatch, wo: Tensor, front: Tensor,
                           u0: Tensor, u1: Tensor) -> SampleOut:
    wi, pdf = _cosine_into(front, u0, u1, flip=True)
    return SampleOut(wi=wi, pdf=pdf, fs=lb.s0 * _INV_PI,
                     is_delta=_bools(pdf, False),
                     is_transmission=_bools(pdf, True))


# Oren-Nayar (the reference's sin^2-as-sin quirk kept: its sin(theta)
# terms are 1 - z^2) ----------------------------------------------------------

def _oren_nayar_factor(lb: LobeBatch, wo: Tensor, wi: Tensor) -> Tensor:
    sigma2 = lb.f0 * lb.f0
    a = 1.0 - 0.5 * sigma2 / (sigma2 + 0.33)
    b = 0.45 * sigma2 / (sigma2 + 0.09)
    sin_ti = 1.0 - wi[..., 2] * wi[..., 2]
    sin_to = 1.0 - wo[..., 2] * wo[..., 2]
    abs_tan_ti = sin_ti / torch.clamp(wi[..., 2].abs(), min=1e-12)
    abs_tan_to = sin_to / torch.clamp(wo[..., 2].abs(), min=1e-12)
    sin_alpha = torch.maximum(sin_ti, sin_to)
    tan_beta = torch.minimum(abs_tan_ti, abs_tan_to)
    denom = sin_ti * sin_to
    cos_daz = torch.where(
        denom > 1e-12,
        (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1])
        / torch.clamp(denom, min=1e-12), 0.0)
    return (a + b * torch.clamp(cos_daz, min=0.0) * sin_alpha * tan_beta) \
        * _INV_PI


def oren_nayar_eval(lb: LobeBatch, wo: Tensor, wi: Tensor) -> Tensor:
    same_side = (wo[..., 2] * wi[..., 2]) > 0.0
    f = _oren_nayar_factor(lb, wo, wi)
    return torch.where(same_side[..., None], lb.s0 * f[..., None], 0.0)


def oren_nayar_sample(lb: LobeBatch, wo: Tensor, front: Tensor, u0: Tensor,
                      u1: Tensor) -> SampleOut:
    wi, pdf = _cosine_into(front, u0, u1)
    fs = lb.s0 * _oren_nayar_factor(lb, wo, wi)[..., None]
    false_ = _bools(pdf, False)
    return SampleOut(wi=wi, pdf=pdf, fs=fs, is_delta=false_,
                     is_transmission=false_)


# Specular reflection (conductor) -------------------------------------------

def specular_reflection_weight(lb: LobeBatch, wo: Tensor,
                               hero: Tensor) -> Tensor:
    f = fresnel_conductor(lb.s1, lb.s2, wo[..., 2])
    return importance(lb.s0 * f, hero)


def specular_reflection_sample(lb: LobeBatch, wo: Tensor) -> SampleOut:
    wi = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    pdf = torch.ones(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    f = fresnel_conductor(lb.s1, lb.s2, wo[..., 2])
    fs = lb.s0 * f / torch.clamp(wo[..., 2].abs(), min=1e-12)[..., None]
    true_ = torch.ones(pdf.shape, dtype=torch.bool, device=pdf.device)
    # Mirror reflection is symmetric: the reverse branch equals the forward.
    return SampleOut(wi=wi, pdf=pdf, fs=fs, is_delta=true_,
                     is_transmission=~true_, rev_pdf=pdf, rev_fs=fs)


# Specular scattering (dielectric glass) ------------------------------------

def specular_scattering_weight(lb: LobeBatch, wo: Tensor,
                               hero: Tensor) -> Tensor:
    return importance(lb.s0, hero)


def specular_scattering_sample(lb: LobeBatch, wo: Tensor, hero: Tensor,
                               u_comp: Tensor,
                               adjoint: bool = False) -> SampleOut:
    """One-sample reflect/refract pick by hero-channel Fresnel importance.
    Refraction collapses to the hero wavelength (fs nonzero only in the
    hero channel); the caller handles the dispersive pdf and flag."""
    s = lb.s0.shape[-1]
    cos_o = wo[..., 2]
    f_spec = fresnel_dielectric(lb.s1, lb.s2, cos_o)
    reflect_prob = importance(f_spec, hero)
    do_reflect = u_comp < reflect_prob

    wi_r = torch.stack([-wo[..., 0], -wo[..., 1], cos_o], dim=-1)
    pdf_r = reflect_prob
    fs_r = lb.s0 * f_spec / torch.clamp(cos_o.abs(), min=1e-12)[..., None]

    entering = cos_o > 0.0
    eta_ext_h = _hero_take(lb.s1, hero)
    eta_int_h = _hero_take(lb.s2, hero)
    e_enter = torch.where(entering, eta_ext_h, eta_int_h)
    e_exit = torch.where(entering, eta_int_h, eta_ext_h)
    sin_enter2 = 1.0 - cos_o * cos_o
    rr_eta = e_enter / torch.clamp(e_exit, min=1e-12)
    sin_exit2 = rr_eta * rr_eta * sin_enter2
    tir = sin_exit2 >= 1.0
    cos_exit = torch.sqrt(torch.clamp(1.0 - sin_exit2, min=0.0))
    cos_exit = torch.where(entering, -cos_exit, cos_exit)
    wi_t = torch.stack([rr_eta * -wo[..., 0], rr_eta * -wo[..., 1], cos_exit],
                       dim=-1)
    pdf_t = torch.where(tir, 0.0, 1.0 - reflect_prob)
    coeff_h = _hero_take(lb.s0, hero)
    f_h = _hero_take(f_spec, hero)
    val_h = coeff_h * (1.0 - f_h)
    if not adjoint:
        # Radiance scaling under refraction.
        val_h = val_h * (e_enter * e_enter) / torch.clamp(e_exit * e_exit,
                                                          min=1e-12)
    fs_t = _one_hot_hero(val_h / torch.clamp(cos_exit.abs(), min=1e-12),
                         hero, s)
    fs_t = torch.where(tir[..., None], 0.0, fs_t)

    wi = torch.where(do_reflect[..., None], wi_r, wi_t)
    pdf = torch.where(do_reflect, pdf_r, pdf_t)
    fs = torch.where(do_reflect[..., None], fs_r, fs_t)
    bad = do_reflect & (cos_o == 0.0)     # grazing reflection: kill
    pdf = torch.where(bad, 0.0, pdf)
    true_ = torch.ones(pdf.shape, dtype=torch.bool, device=pdf.device)

    # Reverse branch: same branch probability; the transmission value swaps
    # the eta^2 scale and divides by |cos wo| instead of |cos_exit|.
    val_rev_h = coeff_h * (1.0 - f_h)
    if adjoint:
        val_rev_h = val_rev_h * (e_exit * e_exit) / torch.clamp(
            e_enter * e_enter, min=1e-12)
    fs_t_rev = _one_hot_hero(val_rev_h / torch.clamp(cos_o.abs(), min=1e-12),
                             hero, s)
    fs_t_rev = torch.where(tir[..., None], 0.0, fs_t_rev)
    rev_pdf = torch.where(bad, 0.0, pdf)
    rev_fs = torch.where(do_reflect[..., None], fs_r, fs_t_rev)
    return SampleOut(wi=wi, pdf=pdf, fs=fs, is_delta=true_,
                     is_transmission=~do_reflect, rev_pdf=rev_pdf,
                     rev_fs=rev_fs)


# GGX microfacet distribution with visible-normal sampling (Heitz 2014) -----

def ggx_D(alpha: Tensor, m: Tensor) -> Tensor:
    """alpha^2 / (pi cos^4 (alpha^2 + tan^2)^2); 0 below the surface."""
    cos2 = m[..., 2] * m[..., 2]
    tan2 = (1.0 - cos2) / torch.clamp(cos2, min=1e-12)
    a2 = alpha * alpha
    d = a2 / (math.pi * torch.clamp(cos2 * cos2, min=1e-16) * (a2 + tan2) ** 2)
    return torch.where(m[..., 2] > 0, d, 0.0)


def ggx_smith_g1(alpha: Tensor, v: Tensor, m: Tensor) -> Tensor:
    """Smith masking G1."""
    chi = (dot(v, m) / torch.where(v[..., 2] == 0, 1e-12, v[..., 2])) > 0
    cos_v = torch.clamp(v[..., 2], -1.0, 1.0)
    tan2_v = (1.0 - cos_v * cos_v) / torch.clamp(cos_v * cos_v, min=1e-12)
    g = 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * tan2_v))
    return torch.where(chi, g, 0.0)


def ggx_sample_vndf(alpha: Tensor, v: Tensor, u0: Tensor,
                    u1: Tensor) -> tuple[Tensor, Tensor]:
    """A visible normal for v (v.z > 0) by the slope-space method.
    Returns (m, pdf)."""
    sv = normalize(torch.stack([alpha * v[..., 0], alpha * v[..., 1],
                                v[..., 2]], dim=-1))
    near_normal = sv[..., 2] > 0.99999
    theta = torch.where(near_normal, 0.0,
                        torch.arccos(torch.clamp(sv[..., 2], -1.0, 1.0)))
    phi = torch.where(near_normal, 0.0, torch.atan2(sv[..., 1], sv[..., 0]))

    # normal incidence
    r_ni = torch.sqrt(u0 / torch.clamp(1.0 - u0, min=1e-12))
    phi_ni = 2.0 * math.pi * u1
    sx_ni = r_ni * torch.cos(phi_ni)
    sy_ni = r_ni * torch.sin(phi_ni)

    # theta >= 1e-4
    tan_ti = torch.tan(torch.clamp(theta, min=1e-4))
    a = 1.0 / tan_ti
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + 1.0 / torch.clamp(a * a, min=1e-20)))
    big_a = 2.0 * u0 / torch.clamp(g1, min=1e-12) - 1.0
    a2m1 = big_a * big_a - 1.0
    tmp = 1.0 / torch.where(a2m1.abs() < 1e-12, 1e-12, a2m1)
    big_b = tan_ti
    disc = torch.clamp(big_b * big_b * tmp * tmp
                       - (big_a * big_a - big_b * big_b) * tmp, min=0.0)
    d_root = torch.sqrt(disc)
    sx1 = big_b * tmp - d_root
    sx2 = big_b * tmp + d_root
    sx_g = torch.where((big_a < 0) | (sx2 > 1.0 / tan_ti), sx1, sx2)
    sx_g = torch.where(u0 == 0.0, 0.0, sx_g)
    s_sign = torch.where(u1 > 0.5, 1.0, -1.0)
    u1m = torch.where(u1 > 0.5, 2.0 * (u1 - 0.5), 2.0 * (0.5 - u1))
    z = (u1m * (u1m * (u1m * 0.27385 - 0.73369) + 0.46341)) / (
        u1m * (u1m * (u1m * 0.093073 + 0.309420) - 1.0) + 0.597999)
    sy_g = s_sign * z * torch.sqrt(1.0 + sx_g * sx_g)

    use_ni = theta < 1e-4
    slope_x = torch.where(use_ni, sx_ni, sx_g)
    slope_y = torch.where(use_ni, sy_ni, sy_g)

    # rotate and unstretch
    cphi = torch.cos(phi)
    sphi = torch.sin(phi)
    rx = (cphi * slope_x - sphi * slope_y) * alpha
    ry = (sphi * slope_x + cphi * slope_y) * alpha
    m = normalize(torch.stack([-rx, -ry, torch.ones_like(rx)], dim=-1))
    return m, ggx_vndf_pdf(alpha, v, m)


def ggx_vndf_pdf(alpha: Tensor, v: Tensor, m: Tensor) -> Tensor:
    return (ggx_smith_g1(alpha, v, m) * dot(v, m).abs() * ggx_D(alpha, m)
            / torch.clamp(v[..., 2].abs(), min=1e-12))


def _half_vector(a: Tensor, b: Tensor) -> Tensor:
    h = a + b
    return h / torch.clamp(torch.sqrt(dot(h, h))[..., None], min=1e-12)


def _sign_z(wo: Tensor) -> Tensor:
    return torch.where(wo[..., 2] >= 0, 1.0, -1.0)


# Microfacet reflection (conductor) ----------------------------------------

def microfacet_reflection_eval(lb: LobeBatch, wo: Tensor,
                               wi: Tensor) -> Tensor:
    alpha = lb.f0
    same = wi[..., 2] * wo[..., 2] > 0
    m = _sign_z(wo)[..., None] * _half_vector(wo, wi)
    f = fresnel_conductor(lb.s1, lb.s2, dot(wo, m))
    g = ggx_smith_g1(alpha, wo, m) * ggx_smith_g1(alpha, wi, m)
    fs = f * (ggx_D(alpha, m) * g / torch.clamp(
        4.0 * (wo[..., 2] * wi[..., 2]).abs(), min=1e-12))[..., None]
    return torch.where(same[..., None], fs, 0.0)


def microfacet_reflection_pdf(lb: LobeBatch, wo: Tensor,
                              wi: Tensor) -> Tensor:
    same = wi[..., 2] * wo[..., 2] > 0
    sign = _sign_z(wo)
    m = sign[..., None] * _half_vector(wo, wi)
    dot_hv = dot(wo, m)
    ok = same & (dot_hv * sign > 0)
    mpdf = ggx_vndf_pdf(lb.f0, sign[..., None] * wo, m)
    return torch.where(ok, mpdf / torch.clamp(4.0 * dot_hv * sign, min=1e-12),
                       0.0)


def microfacet_reflection_weight(lb: LobeBatch, wo: Tensor,
                                 hero: Tensor) -> Tensor:
    z = torch.zeros_like(wo)
    z[..., 2] = 1.0
    return ggx_smith_g1(lb.f0, wo * _sign_z(wo)[..., None], z)


def microfacet_reflection_sample(lb: LobeBatch, wo: Tensor, u0: Tensor,
                                 u1: Tensor) -> SampleOut:
    sign = _sign_z(wo)
    m, mpdf = ggx_sample_vndf(lb.f0, sign[..., None] * wo, u0, u1)
    dot_hv = dot(wo, m)
    wi = 2.0 * dot_hv[..., None] * m - wo
    ok = (dot_hv * sign > 0) & (wi[..., 2] * wo[..., 2] > 0)
    pdf = mpdf / torch.clamp(4.0 * dot_hv * sign, min=1e-12)
    fs = microfacet_reflection_eval(lb, wo, wi)
    false_ = _bools(pdf, False)
    return SampleOut(wi=wi, pdf=torch.where(ok, pdf, 0.0),
                     fs=torch.where(ok[..., None], fs, 0.0),
                     is_delta=false_, is_transmission=false_)


# Microfacet scattering (rough dielectric) ---------------------------------

def _fresnel_dielectric_scalar(e_enter: Tensor, e_exit: Tensor,
                               cos_enter: Tensor) -> Tensor:
    """Dielectric Fresnel with the etas already picked for the side."""
    cos = torch.clamp(cos_enter, -1.0, 1.0)
    sin_exit = e_enter / torch.clamp(e_exit, min=1e-12) * torch.sqrt(
        torch.clamp(1.0 - cos * cos, min=0.0))
    cos_exit = torch.sqrt(torch.clamp(1.0 - sin_exit * sin_exit, min=0.0))
    ci = cos.abs()
    d1 = e_exit * ci + e_enter * cos_exit
    d2 = e_enter * ci + e_exit * cos_exit
    rparl = (e_exit * ci - e_enter * cos_exit) / torch.where(d1 == 0, 1e-12,
                                                             d1)
    rperp = (e_enter * ci - e_exit * cos_exit) / torch.where(d2 == 0, 1e-12,
                                                             d2)
    return torch.where(sin_exit >= 1.0, 1.0,
                       0.5 * (rparl * rparl + rperp * rperp))


def _micro_scatter_trans_fs(lb: LobeBatch, wo: Tensor, wi: Tensor,
                            adjoint: bool = False) -> Tensor:
    """Per-wavelength transmission fs, each with its own half vector."""
    alpha = lb.f0[..., None]
    entering = (wo[..., 2] >= 0)[..., None]
    e_enter = torch.where(entering, lb.s1, lb.s2)              # (B, S)
    e_exit = torch.where(entering, lb.s2, lb.s1)
    m = -(e_enter[..., None] * wo[..., None, :]
          + e_exit[..., None] * wi[..., None, :])              # (B, S, 3)
    m = m / torch.clamp(torch.sqrt(dot(m, m))[..., None], min=1e-12)
    dot_hv = dot(wo[..., None, :], m)
    dot_hl = dot(wi[..., None, :], m)
    f = _fresnel_dielectric_scalar(e_enter, e_exit, dot_hv)
    g = (ggx_smith_g1(alpha, wo[..., None, :], m)
         * ggx_smith_g1(alpha, wi[..., None, :], m))
    denom = (e_enter * dot_hv + e_exit * dot_hl) ** 2
    val = ((dot_hv * dot_hl).abs() * (1.0 - f) * g * ggx_D(alpha, m)
           / torch.clamp(denom, min=1e-12))
    val = val / torch.clamp((wo[..., 2] * wi[..., 2]).abs(),
                            min=1e-12)[..., None]
    return val * ((e_exit * e_exit) if adjoint else (e_enter * e_enter))


def microfacet_scattering_eval(lb: LobeBatch, wo: Tensor, wi: Tensor,
                               adjoint: bool = False) -> Tensor:
    alpha = lb.f0
    prod = wo[..., 2] * wi[..., 2]
    m = _sign_z(wo)[..., None] * _half_vector(wo, wi)
    f = fresnel_dielectric(lb.s1, lb.s2, dot(wo, m))
    g = ggx_smith_g1(alpha, wo, m) * ggx_smith_g1(alpha, wi, m)
    fs_refl = f * (ggx_D(alpha, m) * g
                   / torch.clamp(4.0 * prod.abs(), min=1e-12))[..., None]
    fs_trans = _micro_scatter_trans_fs(lb, wo, wi, adjoint=adjoint)
    return torch.where((prod > 0)[..., None], fs_refl,
                       torch.where((prod < 0)[..., None], fs_trans, 0.0))


def _hero_etas(lb: LobeBatch, wo: Tensor, hero: Tensor):
    """(eta on wo's side, eta on the other side) at the hero wavelength."""
    entering = wo[..., 2] >= 0
    ext_h = _hero_take(lb.s1, hero)
    int_h = _hero_take(lb.s2, hero)
    return (torch.where(entering, ext_h, int_h),
            torch.where(entering, int_h, ext_h))


def microfacet_scattering_pdf(lb: LobeBatch, wo: Tensor, wi: Tensor,
                              hero: Tensor) -> Tensor:
    prod = wo[..., 2] * wi[..., 2]
    sign = _sign_z(wo)
    ee_h, ex_h = _hero_etas(lb, wo, hero)
    m_refl = sign[..., None] * _half_vector(wo, wi)
    m_trans = -(ee_h[..., None] * wo + ex_h[..., None] * wi)
    m_trans = m_trans / torch.clamp(
        torch.sqrt(dot(m_trans, m_trans))[..., None], min=1e-12)
    m = torch.where((prod > 0)[..., None], m_refl, m_trans)
    dot_hv = dot(wo, m)
    ok = (dot_hv * sign > 0) & (prod != 0)
    mpdf = ggx_vndf_pdf(lb.f0, sign[..., None] * wo, m)
    reflect_prob = importance(fresnel_dielectric(lb.s1, lb.s2, dot_hv), hero)
    dot_hl = dot(wi, m)
    pdf_refl = reflect_prob * mpdf / torch.clamp(4.0 * dot_hv * sign,
                                                 min=1e-12)
    denom = torch.clamp((ee_h * dot_hv + ex_h * dot_hl) ** 2, min=1e-12)
    pdf_trans = ((1.0 - reflect_prob) / denom * mpdf * ex_h * ex_h
                 * dot_hl.abs())
    return torch.where(ok, torch.where(prod > 0, pdf_refl, pdf_trans), 0.0)


def microfacet_scattering_sample(lb: LobeBatch, wo: Tensor, hero: Tensor,
                                 u_comp: Tensor, u0: Tensor, u1: Tensor,
                                 adjoint: bool = False) -> SampleOut:
    """Reflect or refract about a sampled visible normal, picked by the
    hero wavelength's Fresnel term; the hero etas set the refraction."""
    sign = _sign_z(wo)
    ee_h, ex_h = _hero_etas(lb, wo, hero)
    m, mpdf = ggx_sample_vndf(lb.f0, sign[..., None] * wo, u0, u1)
    dot_hv = dot(wo, m)
    valid_m = dot_hv * sign > 0
    reflect_prob = importance(fresnel_dielectric(lb.s1, lb.s2, dot_hv), hero)
    do_reflect = u_comp < reflect_prob

    wi_r = 2.0 * dot_hv[..., None] * m - wo
    ok_r = wi_r[..., 2] * wo[..., 2] > 0
    pdf_r = reflect_prob * mpdf / torch.clamp(4.0 * dot_hv * sign, min=1e-12)

    rr = ee_h / torch.clamp(ex_h, min=1e-12)
    inner = 1.0 + rr * rr * (dot_hv * dot_hv - 1.0)
    wi_t = ((rr * dot_hv - sign * torch.sqrt(torch.clamp(inner, min=0.0)))
            [..., None] * m - rr[..., None] * wo)
    ok_t = (inner >= 0) & (wi_t[..., 2] * wo[..., 2] < 0)
    dot_hl = dot(wi_t, m)
    denom = torch.clamp((ee_h * dot_hv + ex_h * dot_hl) ** 2, min=1e-12)
    pdf_t = (1.0 - reflect_prob) / denom * mpdf * ex_h * ex_h * dot_hl.abs()

    wi = torch.where(do_reflect[..., None], wi_r, wi_t)
    ok = valid_m & torch.where(do_reflect, ok_r, ok_t)
    pdf = torch.where(do_reflect, pdf_r, pdf_t)
    fs = microfacet_scattering_eval(lb, wo, wi, adjoint=adjoint)
    return SampleOut(wi=wi, pdf=torch.where(ok, pdf, 0.0),
                     fs=torch.where(ok[..., None], fs, 0.0),
                     is_delta=_bools(pdf, False), is_transmission=~do_reflect)


# Modified Ward-Duer -------------------------------------------------------

def _ward_terms(lb: LobeBatch, wo: Tensor, wi: Tensor):
    ax = torch.clamp(lb.f0, min=1e-4)
    ay = torch.clamp(lb.f1, min=1e-4)
    h = _half_vector(wo, wi)
    hx_ax = h[..., 0] / ax
    hy_ay = h[..., 1] / ay
    dot_hn = h[..., 2].abs()
    numerator = torch.exp(-(hx_ax * hx_ax + hy_ay * hy_ay)
                          / torch.clamp(dot_hn * dot_hn, min=1e-12))
    return ax, ay, dot_hn, dot(h, wi), numerator


def ward_eval(lb: LobeBatch, wo: Tensor, wi: Tensor) -> Tensor:
    same = wi[..., 2] * wo[..., 2] > 0
    ax, ay, dot_hn, dot_hi, num = _ward_terms(lb, wo, wi)
    denom = 4.0 * math.pi * ax * ay * dot_hi * dot_hi * dot_hn ** 4
    fs = lb.s0 * (num / torch.clamp(denom, min=1e-12))[..., None]
    return torch.where(same[..., None], fs, 0.0)


def ward_pdf(lb: LobeBatch, wo: Tensor, wi: Tensor) -> Tensor:
    same = wi[..., 2] * wo[..., 2] > 0
    ax, ay, dot_hn, dot_hi, num = _ward_terms(lb, wo, wi)
    denom = 4.0 * math.pi * ax * ay * dot_hi * dot_hn ** 3
    return torch.where(same, num / torch.clamp(denom, min=1e-12), 0.0)


def ward_sample(lb: LobeBatch, wo: Tensor, u0: Tensor,
                u1: Tensor) -> SampleOut:
    ax = torch.clamp(lb.f0, min=1e-4)
    ay = torch.clamp(lb.f1, min=1e-4)
    quad = 2.0 * math.pi * u1
    phi_h = torch.atan2(ay * torch.sin(quad), ax * torch.cos(quad))
    cosphi_ax = torch.cos(phi_h) / ax
    sinphi_ay = torch.sin(phi_h) / ay
    theta_h = torch.atan(torch.sqrt(
        -torch.log(torch.clamp(1.0 - u0, min=1e-12))
        / torch.clamp(cosphi_ax ** 2 + sinphi_ay ** 2, min=1e-12)))
    h = torch.stack([torch.sin(theta_h) * torch.cos(phi_h),
                     torch.sin(theta_h) * torch.sin(phi_h),
                     torch.cos(theta_h)
                     * torch.where(wo[..., 2] > 0, 1.0, -1.0)], dim=-1)
    wi = 2.0 * dot(wo, h)[..., None] * h - wo
    ok = wi[..., 2] * wo[..., 2] > 0
    pdf = torch.where(ok, ward_pdf(lb, wo, wi), 0.0)
    fs = torch.where(ok[..., None], ward_eval(lb, wo, wi), 0.0)
    false_ = _bools(pdf, False)
    return SampleOut(wi=wi, pdf=pdf, fs=fs, is_delta=false_,
                     is_transmission=false_)


# Ashikhmin-Shirley: anisotropic Phong specular and a coupled diffuse term
# with an internal one-sample MIS. s0 = Rs, s1 = Rd, f0 = nu, f1 = nv. -------

def ashikhmin_weights(lb: LobeBatch, wo: Tensor,
                      hero: Tensor) -> tuple[Tensor, Tensor]:
    """(specular, diffuse) component weights."""
    i_rs = importance(lb.s0, hero)
    i_rd = importance(lb.s1, hero)
    vdh = wo[..., 2].abs()
    spec_w = i_rs + (1.0 - i_rs) * (1.0 - vdh) ** 5
    trans = 1.0 - (1.0 - vdh * 0.5) ** 5
    diff_w = 28.0 * i_rd / 23.0 * (1.0 - i_rs) * trans * trans
    return spec_w, diff_w


def _ashikhmin_spec_terms(lb: LobeBatch, wo: Tensor, h: Tensor):
    nu = lb.f0
    nv = lb.f1
    dot_hv = dot(h, wo)
    expo = (nu * h[..., 0] ** 2 + nv * h[..., 1] ** 2) / torch.clamp(
        1.0 - h[..., 2] * h[..., 2], min=1e-12)
    common = (torch.sqrt((nu + 1.0) * (nv + 1.0))
              / (8.0 * math.pi * torch.clamp(dot_hv, min=1e-12))
              * h[..., 2].abs() ** expo)
    return dot_hv, common


def ashikhmin_eval(lb: LobeBatch, wo: Tensor, wi: Tensor) -> Tensor:
    same = wi[..., 2] * wo[..., 2] > 0
    h = _half_vector(wo, wi)
    dot_hv, common = _ashikhmin_spec_terms(lb, wo, h)
    f = lb.s0 + (1.0 - lb.s0) * ((1.0 - dot_hv) ** 5)[..., None]
    spec = (common / torch.clamp(torch.maximum(wo[..., 2].abs(),
                                               wi[..., 2].abs()), min=1e-12)
            )[..., None] * f
    diff = (28.0 * lb.s1 / (23.0 * math.pi) * (1.0 - lb.s0)
            * ((1.0 - (1.0 - wo[..., 2].abs() / 2.0) ** 5)
               * (1.0 - (1.0 - wi[..., 2].abs() / 2.0) ** 5))[..., None])
    return torch.where(same[..., None], spec + diff, 0.0)


def ashikhmin_pdf(lb: LobeBatch, wo: Tensor, wi: Tensor,
                  hero: Tensor) -> Tensor:
    same = wi[..., 2] * wo[..., 2] > 0
    _, spec_pdf = _ashikhmin_spec_terms(lb, wo, _half_vector(wo, wi))
    diff_pdf = wi[..., 2].abs() * _INV_PI
    spec_w, diff_w = ashikhmin_weights(lb, wo, hero)
    pdf = (spec_pdf * spec_w + diff_pdf * diff_w) / torch.clamp(
        spec_w + diff_w, min=1e-12)
    return torch.where(same, pdf, 0.0)


def ashikhmin_sample(lb: LobeBatch, wo: Tensor, front: Tensor, hero: Tensor,
                     u_comp: Tensor, u0: Tensor, u1: Tensor) -> SampleOut:
    nu = lb.f0
    nv = lb.f1
    spec_w, diff_w = ashikhmin_weights(lb, wo, hero)
    pick_spec = u_comp * torch.clamp(spec_w + diff_w, min=1e-12) < spec_w

    # the specular half vector
    quad = 2.0 * math.pi * u1
    phi_h = torch.atan2(torch.sqrt(nu + 1.0) * torch.sin(quad),
                        torch.sqrt(nv + 1.0) * torch.cos(quad))
    cosphi = torch.cos(phi_h)
    sinphi = torch.sin(phi_h)
    expo = 1.0 / (nu * cosphi * cosphi + nv * sinphi * sinphi + 1.0)
    cos_th = torch.clamp(1.0 - u0, min=1e-12) ** expo
    theta_h = torch.arccos(torch.clamp(cos_th, -1.0, 1.0))
    theta_h = torch.where(wo[..., 2] < 0, math.pi - theta_h, theta_h)
    h = torch.stack([torch.sin(theta_h) * cosphi, torch.sin(theta_h) * sinphi,
                     torch.cos(theta_h)], dim=-1)
    wi_spec = 2.0 * dot(wo, h)[..., None] * h - wo
    wi_diff, _ = _cosine_into(front, u0, u1)

    wi = torch.where(pick_spec[..., None], wi_spec, wi_diff)
    ok = wi[..., 2] * wo[..., 2] > 0
    pdf = torch.where(ok, ashikhmin_pdf(lb, wo, wi, hero), 0.0)
    fs = torch.where(ok[..., None], ashikhmin_eval(lb, wo, wi), 0.0)
    false_ = _bools(pdf, False)
    return SampleOut(wi=wi, pdf=pdf, fs=fs, is_delta=false_,
                     is_transmission=false_)
