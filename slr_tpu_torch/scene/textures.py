"""Texture evaluation over hit batches (counterpart of
slr_tpu/scene/textures.py).

Ported kinds: spectrum textures CONST (RGB mode) and CURVE (spectral mode),
float textures CONST and CHECKER. Scenes holding image, checker or voronoi
spectra, image / voronoi / one-minus float textures or constant spectra left
untabulated in spectral mode raise NotImplementedError.
"""
from __future__ import annotations

import torch

from .types import FloatTextures, FTexKind, SpectrumTextures, STexKind

Tensor = torch.Tensor


def _refuse(what: str):
    raise NotImplementedError(f"{what} textures are not ported yet")


def eval_spectrum_texture(stex: SpectrumTextures, tex_id: Tensor,
                          uv: Tensor, wpos: Tensor | None = None) -> Tensor:
    """RGB mode: (R, S) per hit; tex_id -1 returns zero."""
    if stex.has_checker or stex.has_voronoi or stex.images.shape[0] > 0:
        _refuse("checker, voronoi and image spectrum")
    tid = torch.clamp(tex_id, 0, stex.kind.shape[0] - 1)
    out = stex.value[tid]
    return torch.where((tex_id >= 0)[..., None], out, 0.0)


def eval_spectrum_texture_spectral(stex: SpectrumTextures, tex_id: Tensor,
                                   uv: Tensor, lambdas: Tensor,
                                   wpos: Tensor | None = None) -> Tensor:
    """Spectral mode: per-wavelength samples (R, N). CURVE rows interpolate
    their per-nm table linearly; the scale is value[0]."""
    from ..spectrum.spectral import WL_HI, WL_LO

    if stex.has_const or stex.has_checker or stex.has_voronoi \
            or stex.images.shape[0] > 0:
        _refuse("constant (untabulated), checker, voronoi and image spectral")
    tid = torch.clamp(tex_id, 0, stex.kind.shape[0] - 1)
    kind = stex.kind[tid]
    out = torch.zeros(tid.shape + (lambdas.shape[-1],), dtype=torch.float32,
                      device=lambdas.device)
    k_n, g = stex.curves_v.shape
    if stex.has_curve and k_n > 0:
        cid = torch.clamp(stex.curve_id[tid].to(torch.int64), 0, k_n - 1)
        x = (lambdas - WL_LO) / (WL_HI - WL_LO) * (g - 1)
        xi = torch.clamp(x.to(torch.int64), 0, g - 2)
        frac = torch.clamp(x - xi, 0.0, 1.0)
        flat = stex.curves_v.reshape(-1)
        at = cid[..., None] * g + xi                              # (R, N)
        curve = flat[at] * (1.0 - frac) + flat[at + 1] * frac
        curve = curve * stex.value[tid][..., 0:1]
        out = torch.where((kind == STexKind.CURVE)[..., None], curve, out)
    return torch.where((tex_id >= 0)[..., None], out, 0.0)


def eval_stex(stex: SpectrumTextures, tex_id: Tensor, uv: Tensor,
              lambdas: Tensor | None = None,
              wpos: Tensor | None = None) -> Tensor:
    """Mode dispatch: RGB (S=3) or spectral (per-wavelength) evaluation."""
    if stex.spectral:
        if lambdas is None:
            raise ValueError("a spectral scene needs wavelength samples")
        return eval_spectrum_texture_spectral(stex, tex_id, uv, lambdas, wpos)
    return eval_spectrum_texture(stex, tex_id, uv, wpos)


def _eval_ftex_base(ftex: FloatTextures, tid: Tensor, uv: Tensor) -> Tensor:
    kind = ftex.kind[tid]
    value = ftex.value[tid]
    value2 = ftex.value2[tid]
    tc = uv * ftex.map_scale[tid] + ftex.map_offset[tid]
    sel = torch.remainder((tc[..., 0] * 2).to(torch.int32)
                          + (tc[..., 1] * 2).to(torch.int32), 2)
    checker = torch.where(sel == 0, value, value2)
    return torch.where(kind == FTexKind.CHECKER, checker, value)


def eval_float_texture(ftex: FloatTextures, tex_id: Tensor, uv: Tensor,
                       images: Tensor | None = None,
                       image_hw: Tensor | None = None,
                       wpos: Tensor | None = None) -> Tensor:
    """Float textures; tex_id (R,), -1 returns 0. Returns (R,)."""
    if ftex.has_image or ftex.has_voronoi or ftex.has_one_minus:
        _refuse("image, voronoi and one-minus float")
    tid = torch.clamp(tex_id, 0, ftex.kind.shape[0] - 1)
    out = _eval_ftex_base(ftex, tid, uv)
    return torch.where(tex_id >= 0, out, 0.0)


def eval_float_texture_default1(ftex: FloatTextures, tex_id: Tensor,
                                uv: Tensor, images: Tensor | None = None,
                                image_hw: Tensor | None = None,
                                wpos: Tensor | None = None) -> Tensor:
    """Like eval_float_texture but -1 means 1.0 (lobe weight default)."""
    v = eval_float_texture(ftex, tex_id, uv, images, image_hw, wpos)
    return torch.where(tex_id >= 0, v, 1.0)
