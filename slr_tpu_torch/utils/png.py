"""PNG decoder on zlib and numpy: the image files of scene descriptions.

Decodes 8-bit, non-interlaced PNGs of colour types 0 (grey), 2 (RGB), 3
(palette), 4 (grey + alpha) and 6 (RGBA), with all five row filters and
`tRNS` transparency, to the (H, W, 4) uint8 RGBA that PIL's
`Image.open(path).convert("RGBA")` gives. Anything else (other bit depths,
Adam7 interlacing) raises ValueError naming the feature.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, tag = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield tag, body
        pos += 12 + length
        if tag == b"IEND":
            return
    raise ValueError("PNG without IEND")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (h, stride) uint8 scanlines."""
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is shorter than its rows")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:       # Sub: running sum per byte lane, mod 256
            lanes = line.reshape(-1, bpp).astype(np.int64)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:       # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            buf = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = buf[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    buf[x] = (buf[x] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    buf[x] = (buf[x] + _paeth(a, b, c)) & 0xFF
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    ihdr = None
    palette = trns = None
    idat = []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype}")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} (only 8-bit PNGs are read)")
    if interlace != 0:
        raise ValueError("PNG Adam7 interlacing")
    if comp != 0 or filt != 0:
        raise ValueError(f"PNG compression method {comp} / filter method "
                         f"{filt}")
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    rgba = np.empty((h, w, 4), np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        alpha = np.full(len(palette), 255, np.uint8)
        if trns is not None:
            t = np.frombuffer(trns, np.uint8)[:len(palette)]
            alpha[:len(t)] = t
        idx = px[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index out of range")
        rgba[..., :3] = palette[idx]
        rgba[..., 3] = alpha[idx]
        return rgba
    if ctype in (0, 4):
        rgba[..., :3] = px[..., :1]
    else:
        rgba[..., :3] = px[..., :3]
    if ctype in (4, 6):
        rgba[..., 3] = px[..., -1]
    else:
        rgba[..., 3] = 255
        if trns is not None:   # one colour (grey or RGB, 16-bit samples)
            key = np.frombuffer(trns, ">u2").astype(np.int64)
            colour = px[..., :1] if ctype == 0 else px[..., :3]
            rgba[..., 3] = np.where((colour == key).all(-1), 0, 255)
    return rgba


def read_png(path: str) -> np.ndarray:
    """PNG file -> (H, W, 4) uint8 RGBA."""
    with open(path, "rb") as f:
        return decode_png(f.read())
