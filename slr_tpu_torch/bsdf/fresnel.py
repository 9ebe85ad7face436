"""Fresnel reflectance over wavefronts and spectral channels (counterpart of
slr_tpu/bsdf/fresnel.py)."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def fresnel_conductor(eta: Tensor, k: Tensor, cos_enter: Tensor) -> Tensor:
    """Conductor Fresnel. eta/k: (..., S); cos: (...)."""
    c = cos_enter.abs()[..., None]
    c2 = c * c
    two_eta_c = 2.0 * eta * c
    tmp_f = eta * eta + k * k
    tmp = tmp_f * c2
    rparl2 = (tmp - two_eta_c + 1.0) / (tmp + two_eta_c + 1.0)
    rperp2 = (tmp_f - two_eta_c + c2) / (tmp_f + two_eta_c + c2)
    return 0.5 * (rparl2 + rperp2)


def _eval_f(eta_enter: Tensor, eta_exit: Tensor, cos_enter: Tensor,
            cos_exit: Tensor) -> Tensor:
    rparl = (eta_exit * cos_enter - eta_enter * cos_exit) / (
        eta_exit * cos_enter + eta_enter * cos_exit)
    rperp = (eta_enter * cos_enter - eta_exit * cos_exit) / (
        eta_enter * cos_enter + eta_exit * cos_exit)
    return 0.5 * (rparl * rparl + rperp * rperp)


def fresnel_dielectric(eta_ext: Tensor, eta_int: Tensor,
                       cos_enter: Tensor) -> Tensor:
    """Dielectric Fresnel; the sign of cos selects entering/exiting.
    eta_*: (..., S); cos: (...). Returns (..., S)."""
    cos = torch.clamp(cos_enter, -1.0, 1.0)[..., None]
    entering = cos > 0.0
    e_enter = torch.where(entering, eta_ext, eta_int)
    e_exit = torch.where(entering, eta_int, eta_ext)
    sin_exit = e_enter / e_exit * torch.sqrt(torch.clamp(1.0 - cos * cos, min=0.0))
    cos_abs = cos.abs()
    tir = sin_exit >= 1.0
    cos_exit = torch.sqrt(torch.clamp(1.0 - sin_exit * sin_exit, min=0.0))
    f = _eval_f(e_enter, e_exit, cos_abs, cos_exit)
    return torch.where(tir, 1.0, f)
