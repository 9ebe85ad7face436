"""Film development and image writers (counterpart of
slr_tpu/render/film.py). `develop` reproduces the sensor's save-time
processing: scale, clamp, luminance tone-map (1 - e^-Y)/Y, sRGB gamma. The
writers need numpy only.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..core.device import resolve_device
from ..spectrum.rgb import luminance, srgb_gamma

Tensor = torch.Tensor


def develop(film_rgb, scale: float = 1.0, device=None) -> Tensor:
    """(H, W, 3) linear RGB -> (H, W, 3) display RGB in [0, 1) on `device`
    (default: the CUDA device)."""
    rgb = torch.as_tensor(film_rgb, dtype=torch.float32,
                          device=resolve_device(device))
    rgb = torch.clamp(rgb * scale, min=0.0)
    y = luminance(rgb)
    scale_y = torch.where(y != 0.0,
                          (1.0 - torch.exp(-y)) / torch.clamp(y, min=1e-20), 0.0)
    rgb = torch.clamp(rgb * scale_y[..., None], max=1.0)
    return torch.clamp(srgb_gamma(rgb), max=0.999)


def _host(img01) -> np.ndarray:
    if isinstance(img01, Tensor):
        img01 = img01.detach().cpu().numpy()
    return np.asarray(img01)


def to_uint8(img01) -> np.ndarray:
    return (_host(img01) * 256.0).clip(0, 255).astype(np.uint8)


def save_png(path: str, img01) -> None:
    """Minimal dependency-free PNG writer: RGB8, or RGBA8 for an image of
    four channels."""
    arr = to_uint8(img01)
    h, w, c = arr.shape
    colour_type = {3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + arr[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    png = b"\x89PNG\r\n\x1a\n"
    png += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0,
                                          0))
    png += chunk(b"IDAT", zlib.compress(raw, 6))
    png += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(png)


def save_bmp(path: str, img01) -> None:
    """Minimal BMP writer (24-bit BGR, bottom-up)."""
    arr = to_uint8(img01)
    h, w = arr.shape[:2]
    row_pad = (-3 * w) % 4
    body = b"".join(arr[h - 1 - row, :, ::-1].tobytes() + b"\x00" * row_pad
                    for row in range(h))
    header = struct.pack("<2sIHHI", b"BM", 54 + len(body), 0, 0, 54) + \
        struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(body), 2835, 2835,
                    0, 0)
    with open(path, "wb") as f:
        f.write(header + body)


class CompensatedFilm:
    """Kahan-compensated accumulation buffer (the reference's
    CompensatedSum film): keeps the compensation term for very long
    progressive runs, where per-texel sums span many orders of magnitude."""

    def __init__(self, height: int, width: int, channels: int, device=None):
        dev = resolve_device(device)
        self.sum = torch.zeros((height, width, channels), dtype=torch.float32,
                               device=dev)
        self.comp = torch.zeros_like(self.sum)

    def add(self, values):
        """values: (H, W, C) one pass of contributions."""
        self.sum, self.comp = kahan_add(self.sum, self.comp, values)
        return self

    @property
    def value(self):
        return self.sum + self.comp


def kahan_add(total, comp, values):
    """One Kahan step on tensors or arrays: returns (new total, new
    compensation)."""
    y = values - comp
    t = total + y
    new_comp = (t - total) - y
    return t, new_comp
