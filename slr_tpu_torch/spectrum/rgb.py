"""RGB color pipeline: sRGB/XYZ conversion, luminance, hero-channel
importance and the sensor tone-map (counterpart of slr_tpu/spectrum/rgb.py).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

sRGB_to_XYZ = torch.tensor(
    [[0.4124564, 0.3575761, 0.1804375],
     [0.2126729, 0.7151522, 0.0721750],
     [0.0193339, 0.1191920, 0.9503041]], dtype=torch.float32)
XYZ_to_sRGB = torch.tensor(
    [[3.2404542, -1.5371385, -0.4985314],
     [-0.9692660, 1.8760108, 0.0415560],
     [0.0556434, -0.2040259, 1.0572252]], dtype=torch.float32)

HERO_PRIMARY = 0.9


def luminance(rgb: Tensor) -> Tensor:
    """sRGB luminance."""
    return (0.222485 * rgb[..., 0] + 0.716905 * rgb[..., 1]
            + 0.060610 * rgb[..., 2])


def importance(values: Tensor, hero: Tensor) -> Tensor:
    """Hero-sample importance: 0.9 weight on the hero channel, the rest
    spread over the others. values (..., S), hero (...) integer index."""
    s = values.shape[-1]
    total = values.sum(-1)
    if s == 1:
        return total
    marginal = (1.0 - HERO_PRIMARY) / (s - 1)
    hero_val = torch.gather(
        values, -1,
        hero.to(torch.int64).expand(values.shape[:-1])[..., None])[..., 0]
    return total * marginal + hero_val * (HERO_PRIMARY - marginal)


def srgb_gamma(v: Tensor) -> Tensor:
    """sRGB OETF."""
    v = torch.clamp(v, min=0.0)
    return torch.where(v <= 0.0031308, 12.92 * v,
                       1.055 * torch.pow(v, 1.0 / 2.4) - 0.055)


def srgb_degamma(v: Tensor) -> Tensor:
    v = torch.clamp(v, min=0.0)
    return torch.where(v <= 0.04045, v / 12.92,
                       torch.pow((v + 0.055) / 1.055, 2.4))


def tonemap_sensor(y: Tensor) -> Tensor:
    """The sensor's luminance compression (1 - e^-Y)/Y, as a scale."""
    return torch.where(y > 1e-8, (1.0 - torch.exp(-y)) / torch.clamp(y, min=1e-8),
                       1.0)
