"""Minimal OpenEXR scanline reader/writer (pure numpy + zlib), a copy of
slr_tpu/utils/exr.py.

The reference loads EXR environment maps through OpenEXR's
``Imf::RgbaInputFile`` (libSLRSceneGraph/Helper/image_loader.cpp:9-12);
this module provides the TPU build's equivalent without a native OpenEXR
dependency: enough of the EXR 2.0 container to round-trip the RGBA images
the renderer consumes.

Supported on read: single-part scanline files, HALF/FLOAT channels,
compression NONE / RLE / ZIPS / ZIP (the formats `Imf::RgbaOutputFile`
emits by default), increasing-Y line order. Writes: HALF RGB(A), ZIP.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXEL_UINT, _PIXEL_HALF, _PIXEL_FLOAT = 0, 1, 2
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_RLE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}
_DTYPE = {_PIXEL_UINT: np.uint32, _PIXEL_HALF: np.float16,
          _PIXEL_FLOAT: np.float32}


def _read_cstr(buf: bytes, off: int) -> tuple[str, int]:
    end = buf.index(b"\0", off)
    return buf[off:end].decode("latin-1"), end + 1


def _unpredict_interleave(raw: bytes) -> bytes:
    """Invert OpenEXR's ZIP/RLE pre-filter: byte delta then two-half
    interleave (OpenEXR ImfZip.cpp semantics)."""
    d = np.frombuffer(raw, np.uint8).astype(np.int64)
    # t[i] = (t[i-1] + raw[i] - 128) mod 256 — mod distributes over the sum.
    d = (np.cumsum(d - 128) & 0xFF).astype(np.uint8)
    n = len(d)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def _predict_deinterleave(raw: bytes) -> bytes:
    d = np.frombuffer(raw, np.uint8)
    n = len(d)
    half = (n + 1) // 2
    tmp = np.empty(n, np.uint8)
    tmp[:half] = d[0::2]
    tmp[half:] = d[1::2]
    t = tmp.astype(np.int16)
    delta = np.empty(n, np.int16)
    delta[0] = t[0]
    delta[1:] = t[1:] - t[:-1]
    return ((delta + 128) & 0xFF).astype(np.uint8).tobytes()


def _rle_decode(raw: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(raw)
    while i < n:
        count = struct.unpack_from("b", raw, i)[0]
        i += 1
        if count < 0:
            out += raw[i:i - count]
            i -= count
        else:
            out += raw[i:i + 1] * (count + 1)
            i += 1
    return bytes(out)


def read_exr(path: str) -> np.ndarray:
    """Read an EXR file -> float32 (H, W, 4) linear RGBA (A=1 if absent).
    Non-RGBA channel names (Y, Z, ...) map in alphabetical-channel order."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x1000:
        raise ValueError(f"{path}: multi-part EXR unsupported")
    if version & 0x800:
        raise ValueError(f"{path}: deep EXR unsupported")
    tiled = bool(version & 0x200)

    off = 8
    channels: list[tuple[str, int]] = []
    compression = _COMP_NONE
    data_window = (0, 0, 0, 0)
    line_order = 0
    while True:
        name, off = _read_cstr(buf, off)
        if not name:
            break
        atype, off = _read_cstr(buf, off)
        size = struct.unpack_from("<i", buf, off)[0]
        off += 4
        body = buf[off:off + size]
        off += size
        if name == "channels" and atype == "chlist":
            c = 0
            while body[c] != 0:
                cname, c = _read_cstr(body, c)
                ptype = struct.unpack_from("<i", body, c)[0]
                c += 16  # type + pLinear/reserved + xSampling + ySampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = body[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", body)
        elif name == "lineOrder":
            line_order = body[0]
        elif name == "tiles":
            tiled = True
    if tiled:
        raise ValueError(f"{path}: tiled EXR unsupported")
    if compression not in _LINES_PER_BLOCK:
        raise ValueError(f"{path}: compression {compression} unsupported "
                         "(NONE/RLE/ZIPS/ZIP only)")

    xmin, ymin, xmax, ymax = data_window
    width, height = xmax - xmin + 1, ymax - ymin + 1
    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = -(-height // lpb)
    off += 8 * n_blocks  # skip the scanline offset table (we read linearly)

    # Channels are stored per scanline in alphabetical order.
    order = sorted(range(len(channels)), key=lambda i: channels[i][0])
    bpp = {_PIXEL_UINT: 4, _PIXEL_HALF: 2, _PIXEL_FLOAT: 4}
    line_bytes = sum(width * bpp[channels[i][1]] for i in range(len(channels)))

    planes = {channels[i][0]: np.zeros((height, width), np.float32)
              for i in range(len(channels))}
    for _ in range(n_blocks):
        y, size = struct.unpack_from("<ii", buf, off)
        off += 8
        data = buf[off:off + size]
        off += size
        rows = min(lpb, ymax - y + 1)
        expect = line_bytes * rows
        if compression in (_COMP_ZIP, _COMP_ZIPS):
            if size < expect:
                data = _unpredict_interleave(zlib.decompress(data))
        elif compression == _COMP_RLE:
            if size < expect:
                data = _unpredict_interleave(_rle_decode(data))
        p = 0
        for r in range(rows):
            ry = y - ymin + r
            if line_order == 1:  # decreasing Y
                ry = height - 1 - ry
            for i in order:
                cname, ptype = channels[i]
                nb = width * bpp[ptype]
                vals = np.frombuffer(data[p:p + nb], _DTYPE[ptype])
                planes[cname][ry] = vals.astype(np.float32)
                p += nb

    out = np.zeros((height, width, 4), np.float32)
    out[..., 3] = 1.0
    names = [c[0] for c in channels]
    rgba = ("R", "G", "B", "A")
    if any(n in names for n in rgba):
        for k, n in enumerate(rgba):
            if n in planes:
                out[..., k] = planes[n]
    else:  # luminance or arbitrary channels: broadcast the first
        first = planes[sorted(names)[0]]
        out[..., 0] = out[..., 1] = out[..., 2] = first
    return out


def write_exr(path: str, img: np.ndarray) -> None:
    """Write float RGB(A) (H, W, 3|4) as HALF, ZIP-compressed scanlines."""
    img = np.asarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError("write_exr expects (H, W, 3|4)")
    h, w, nc = img.shape
    names = ["B", "G", "R"] if nc == 3 else ["A", "B", "G", "R"]
    src = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]}
    if nc == 4:
        src["A"] = img[..., 3]

    def attr(name: str, atype: str, body: bytes) -> bytes:
        return (name.encode() + b"\0" + atype.encode() + b"\0"
                + struct.pack("<i", len(body)) + body)

    chlist = b""
    for n in names:  # alphabetical
        chlist += (n.encode() + b"\0" + struct.pack("<i", _PIXEL_HALF)
                   + b"\0\0\0\0" + struct.pack("<ii", 1, 1))
    chlist += b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (
        attr("channels", "chlist", chlist)
        + attr("compression", "compression", bytes([_COMP_ZIP]))
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\0")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )
    n_blocks = -(-h // 16)
    chunks = []
    for b in range(n_blocks):
        y0, rows = b * 16, min(16, h - b * 16)
        raw = b"".join(
            src[n][y0 + r].astype(np.float16).tobytes()
            for r in range(rows) for n in names
        )
        comp = zlib.compress(_predict_deinterleave(raw))
        if len(comp) >= len(raw):
            comp = raw
        chunks.append(struct.pack("<ii", y0, len(comp)) + comp)
    base = 8 + len(header) + 8 * n_blocks
    offsets, pos = [], base
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for c in chunks:
            f.write(c)
