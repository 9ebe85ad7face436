"""Sampling routines and piecewise-constant distributions (counterpart of
slr_tpu/core/sampling.py). Distributions are small NamedTuples of tensors;
sampling is `searchsorted` plus plain indexing.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Analytic mappings
# ---------------------------------------------------------------------------

def concentric_sample_disk(u0: Tensor, u1: Tensor) -> tuple[Tensor, Tensor]:
    """Shirley-Chiu concentric disk mapping with a SIGNED radius per square
    region, branchless."""
    sx = 2.0 * u0 - 1.0
    sy = 2.0 * u1 - 1.0
    r12 = sx >= -sy
    gt = sx > sy
    r1 = r12 & gt
    r2 = r12 & ~gt
    r4 = ~r12 & gt
    safe_x = torch.where(sx == 0.0, 1.0, sx)
    safe_y = torch.where(sy == 0.0, 1.0, sy)
    r = torch.where(r1, sx, torch.where(r2, sy, torch.where(r4, -sy, -sx)))
    theta8 = torch.where(
        r1, sy / safe_x,
        torch.where(r2, 2.0 - sx / safe_y,
                    torch.where(r4, 6.0 + sx / safe_y, 4.0 + sy / safe_x)))
    theta = theta8 * (math.pi / 4.0)
    zero = (sx == 0.0) & (sy == 0.0)
    r = torch.where(zero, 0.0, r)
    return r * torch.cos(theta), r * torch.sin(theta)


def cosine_sample_hemisphere(u0: Tensor, u1: Tensor) -> Tensor:
    """Cosine-weighted hemisphere (z-up) via concentric disk + projection."""
    x, y = concentric_sample_disk(u0, u1)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return torch.stack([x, y, z], dim=-1)


def uniform_sample_triangle(u0: Tensor, u1: Tensor) -> tuple[Tensor, Tensor]:
    """Barycentric (b0, b1) uniform over the triangle."""
    sqrt_u0 = torch.sqrt(u0)
    return 1.0 - sqrt_u0, u1 * sqrt_u0


# ---------------------------------------------------------------------------
# Piecewise-constant distributions
# ---------------------------------------------------------------------------

class Discrete1D(NamedTuple):
    """Discrete distribution over N items: pmf (N,), cdf (N+1,)."""

    pmf: Tensor
    cdf: Tensor

    @property
    def num(self) -> int:
        return self.pmf.shape[-1]


def build_discrete_1d(weights) -> Discrete1D:
    w = torch.clamp(torch.as_tensor(weights, dtype=torch.float32), min=0.0)
    total = w.sum()
    pmf = torch.where(total > 0, w / torch.clamp(total, min=1e-30),
                      1.0 / w.shape[-1])
    cdf = torch.cat([torch.zeros(1, dtype=pmf.dtype, device=pmf.device),
                     torch.cumsum(pmf, 0)])
    cdf = cdf / cdf[-1]
    return Discrete1D(pmf=pmf, cdf=cdf)


def _bin(cdf: Tensor, u: Tensor, n: int) -> Tensor:
    """Index i with cdf[i] <= u < cdf[i+1], clipped to [0, n-1]."""
    i = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True) - 1
    return torch.clamp(i, 0, n - 1)


def sample_discrete_1d(dist: Discrete1D,
                       u: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Sample index ~ pmf. Returns (index, prob, remapped_u)."""
    idx = _bin(dist.cdf, u, dist.num)
    lo = dist.cdf[idx]
    hi = dist.cdf[idx + 1]
    prob = dist.pmf[idx]
    remapped = torch.clamp((u - lo) / torch.clamp(hi - lo, min=1e-30),
                           0.0, 1.0 - 1e-7)
    return idx, prob, remapped


class Continuous1D(NamedTuple):
    """Piecewise-constant density on [0,1]: pdf (N,), cdf (N+1,)."""

    pdf: Tensor
    cdf: Tensor
    integral: Tensor

    @property
    def num(self) -> int:
        return self.pdf.shape[-1]


def build_continuous_1d(values) -> Continuous1D:
    v = torch.clamp(torch.as_tensor(values, dtype=torch.float32), min=0.0)
    n = v.shape[-1]
    integral = v.sum(-1) / n
    safe = torch.clamp(integral, min=1e-30)
    pdf = v / safe[..., None]
    cdf = torch.cat([torch.zeros(v.shape[:-1] + (1,), dtype=v.dtype,
                                 device=v.device),
                     torch.cumsum(v, -1)], dim=-1)
    cdf = cdf / torch.clamp(cdf[..., -1:], min=1e-30)
    return Continuous1D(pdf=pdf, cdf=cdf, integral=integral)


class Continuous2D(NamedTuple):
    """2-D piecewise-constant density: per-row conditionals and a row
    marginal. cond_pdf/cond_cdf (H, W)/(H, W+1); marg_pdf/marg_cdf (H,)/(H+1,)."""

    cond_pdf: Tensor
    cond_cdf: Tensor
    marg_pdf: Tensor
    marg_cdf: Tensor

    @property
    def shape(self) -> tuple[int, int]:
        return self.cond_pdf.shape[-2], self.cond_pdf.shape[-1]


def build_continuous_2d(values) -> Continuous2D:
    """values: (H, W) nonnegative importance."""
    v = torch.clamp(torch.as_tensor(values, dtype=torch.float32), min=0.0)
    cond = build_continuous_1d(v)
    marg = build_continuous_1d(cond.integral)
    return Continuous2D(cond_pdf=cond.pdf, cond_cdf=cond.cdf,
                        marg_pdf=marg.pdf, marg_cdf=marg.cdf)


def sample_continuous_2d(dist: Continuous2D, u0: Tensor,
                         u1: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Sample (x, y) in [0,1)^2 with joint density. Returns (x, y, pdf)."""
    h, w = dist.shape
    yidx = _bin(dist.marg_cdf, u1, h)
    ylo = dist.marg_cdf[yidx]
    yhi = dist.marg_cdf[yidx + 1]
    yfrac = torch.clamp((u1 - ylo) / torch.clamp(yhi - ylo, min=1e-30),
                        0.0, 1.0)
    y = (yidx.to(torch.float32) + yfrac) / h
    row_cdf = dist.cond_cdf[yidx]                              # (..., W+1)
    xidx = torch.clamp(
        (row_cdf <= u0[..., None]).to(torch.int64).sum(-1) - 1, 0, w - 1)
    xlo = torch.gather(row_cdf, -1, xidx[..., None])[..., 0]
    xhi = torch.gather(row_cdf, -1, xidx[..., None] + 1)[..., 0]
    xfrac = torch.clamp((u0 - xlo) / torch.clamp(xhi - xlo, min=1e-30),
                        0.0, 1.0)
    x = (xidx.to(torch.float32) + xfrac) / w
    pdf = dist.marg_pdf[yidx] * dist.cond_pdf[yidx, xidx]
    return x, y, pdf


def pdf_continuous_2d(dist: Continuous2D, x: Tensor, y: Tensor) -> Tensor:
    h, w = dist.shape
    xi = torch.clamp((x * w).to(torch.int64), 0, w - 1)
    yi = torch.clamp((y * h).to(torch.int64), 0, h - 1)
    return dist.marg_pdf[yi] * dist.cond_pdf[yi, xi]


def power_heuristic(f: Tensor, g: Tensor) -> Tensor:
    """Power heuristic (beta=2) MIS weight."""
    f2 = f * f
    g2 = g * g
    return torch.where(f2 + g2 > 0, f2 / torch.clamp(f2 + g2, min=1e-38), 0.0)
