"""Per-kind BSDF lobes over hit batches (counterpart of
slr_tpu/bsdf/lobes.py). Directions are in the shading frame (z = shading
normal); the aggregate in bsdf.py applies the shading-normal correction.

Ported kinds: LAMBERT, SPECULAR_REFLECTION, SPECULAR_SCATTERING. The others
raise NotImplementedError by name in the bsdf.py dispatchers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

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

PORTED_KINDS = (LobeKind.LAMBERT, LobeKind.SPECULAR_REFLECTION,
                LobeKind.SPECULAR_SCATTERING)
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


# Lambert ------------------------------------------------------------------

def lambert_eval(lb: LobeBatch, wo: Tensor, wi: Tensor) -> Tensor:
    same_side = (wo[..., 2] * wi[..., 2]) > 0.0
    return torch.where(same_side[..., None], lb.s0 * _INV_PI, 0.0)


def lambert_pdf(lb: LobeBatch, wo: Tensor, wi: Tensor) -> Tensor:
    same_side = (wo[..., 2] * wi[..., 2]) > 0.0
    return torch.where(same_side, wi[..., 2].abs() * _INV_PI, 0.0)


def lambert_sample(lb: LobeBatch, wo: Tensor, front: Tensor, u0: Tensor,
                   u1: Tensor) -> SampleOut:
    d = cosine_sample_hemisphere(u0, u1)
    pdf = d[..., 2] * _INV_PI
    z = torch.where(front, d[..., 2], -d[..., 2])
    wi = torch.cat([d[..., :2], z[..., None]], dim=-1)
    fs = lb.s0 * _INV_PI
    false_ = torch.zeros(pdf.shape, dtype=torch.bool, device=pdf.device)
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
