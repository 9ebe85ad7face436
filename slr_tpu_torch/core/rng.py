"""Counter-based, decision-enumerated random streams (counterpart of
slr_tpu/core/rng.py, bit for bit).

Every random number is a pure function of (seed, pixel, sample, bounce,
decision). The hash is 32-bit unsigned arithmetic; it runs here in int64
masked to 32 bits, because CPU `uint32` tensors lack `add` and `>>`. Each
32x32-bit product is split into two 16-bit halves of the constant so no
intermediate leaves the int64 range.
"""
from __future__ import annotations

import enum

import torch

Tensor = torch.Tensor

_M32 = 0xFFFFFFFF


class Decision(enum.IntEnum):
    """One entry per random decision a path makes."""

    TIME = 0
    PIXEL_X = 1
    PIXEL_Y = 2
    WAVELENGTH = 3
    WL_SELECT = 4
    LENS_U = 5
    LENS_V = 6
    IDF_U = 7
    IDF_V = 8
    BSDF_COMPONENT = 9
    BSDF_U = 10
    BSDF_V = 11
    RR = 12
    LIGHT_SELECT = 13
    LIGHT_POS_U = 14
    LIGHT_POS_V = 15
    EDF_COMPONENT = 16
    EDF_U = 17
    EDF_V = 18
    _COUNT = 19


def u32(x):
    """A uint32 value as a Python int, or a tensor of them as int64, in
    [0, 2^32). Python ints stay on the host, so scalar arguments cost no
    copy to the device."""
    if isinstance(x, Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) (a Python int or an int64
    tensor) and a constant c < 2^32."""
    if not isinstance(x, Tensor):
        return (x * c) & _M32
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x):
    """Strong 32-bit integer finalizer (murmur3-style avalanche)."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def uniform(seed, pixel, sample, bounce, decision) -> Tensor:
    """One uniform float32 in [0, 1) per element of the broadcast shape.

    Integer arguments may be Python ints or int64 tensors holding uint32
    values; the tensors decide the device."""
    s, p, n, b, d = (u32(a) for a in (seed, pixel, sample, bounce, decision))
    h = _hash32((mul32(p, 0x9E3779B9) + s) & _M32)
    h = _hash32((h + mul32(n, 0x85EBCA6B)) & _M32)
    h = _hash32((h + mul32(b, 0xC2B2AE35) + mul32(d, 0x27D4EB2F)) & _M32)
    # Top 24 bits -> [0,1) float32 (exactly representable).
    return (torch.as_tensor(h) >> 8).to(torch.float32) * (1.0 / 16777216.0)
