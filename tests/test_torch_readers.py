"""The image and model readers of the port against slr_tpu's: its copy of
the EXR reader on the same bytes for every compression and pixel type it
reads; `.assbin` written and read back by both; its own PNG decoder
against PIL's decoding (what slr_tpu reads PNGs with) of PNGs that PIL
writes in modes L, LA, P, RGB and RGBA; `Image2D` of a PNG through the
scene API (sRGB de-gamma, the store mode); and the placeholder sky of a
missing image, as slr_tpu substitutes it.

Tolerance: decoded pixels, EXR planes and placeholder images bit for bit;
the de-gamma'd PNG floats within rtol 1e-6 (each framework's f32 pow)."""
import io
import struct
import zlib

import numpy as np
import pytest

from slr_tpu.utils import assbin as jassbin
from slr_tpu.utils import exr as jexr
from slr_tpu_torch.utils import assbin as tassbin
from slr_tpu_torch.utils import exr as texr
from slr_tpu_torch.utils.png import decode_png, read_png


# -- EXR ----------------------------------------------------------------------

def _rle_encode(raw: bytes) -> bytes:
    """OpenEXR's RLE: runs of >= 3 equal bytes as (count - 1, byte), other
    bytes as literal runs (-count, bytes...), counts up to 127."""
    out, i, n = bytearray(), 0, len(raw)
    while i < n:
        j = i
        while j < n and j - i < 128 and raw[j] == raw[i]:
            j += 1
        if j - i >= 3:
            out += struct.pack("b", j - i - 1) + raw[i:i + 1]
            i = j
            continue
        j = i
        while j < n and j - i < 127 and not (
                j + 2 < n and raw[j] == raw[j + 1] == raw[j + 2]):
            j += 1
        out += struct.pack("b", -(j - i)) + raw[i:j]
        i = j
    return bytes(out)


def _write_exr(path, img, compression, ptype, line_order=0):
    """An RGBA EXR in any of the reader's compressions (0 NONE, 1 RLE, 2
    ZIPS, 3 ZIP) and pixel types (1 HALF, 2 FLOAT)."""
    h, w, _ = img.shape
    names = ["A", "B", "G", "R"]
    src = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2],
           "A": img[..., 3]}
    dt = np.float16 if ptype == 1 else np.float32

    def attr(name, atype, body):
        return (name.encode() + b"\0" + atype.encode() + b"\0"
                + struct.pack("<i", len(body)) + body)

    chlist = b"".join(n.encode() + b"\0" + struct.pack("<i", ptype)
                      + b"\0\0\0\0" + struct.pack("<ii", 1, 1)
                      for n in names) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (attr("channels", "chlist", chlist)
              + attr("compression", "compression", bytes([compression]))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", bytes([line_order])) + b"\0")
    lpb = 16 if compression == 3 else 1
    n_blocks = -(-h // lpb)
    chunks = []
    for b in range(n_blocks):
        y0, rows = b * lpb, min(lpb, h - b * lpb)
        file_rows = [h - 1 - (y0 + r) if line_order else y0 + r
                     for r in range(rows)]
        raw = b"".join(src[n][fy].astype(dt).tobytes()
                       for fy in file_rows for n in names)
        pre = jexr._predict_deinterleave(raw)
        comp = {0: raw, 1: _rle_encode(pre), 2: zlib.compress(pre),
                3: zlib.compress(pre)}[compression]
        if len(comp) >= len(raw):
            comp = raw
        chunks.append(struct.pack("<ii", y0, len(comp)) + comp)
    base = 8 + len(header) + 8 * n_blocks
    offsets, pos = [], base
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", 20000630, 2) + header
                + struct.pack(f"<{n_blocks}Q", *offsets) + b"".join(chunks))


@pytest.mark.parametrize("ptype", [1, 2], ids=["half", "float"])
@pytest.mark.parametrize("compression", [0, 1, 2, 3],
                         ids=["none", "rle", "zips", "zip"])
def test_exr_reader_matches_reference(tmp_path, compression, ptype):
    rs = np.random.RandomState(compression * 3 + ptype)
    img = rs.gamma(1.5, 1.0, (37, 29, 4)).astype(np.float32)
    img[5:20, 3:25] = [0.5, 2.0, 7.25, 1.0]        # runs for RLE and zlib
    for line_order in (0, 1):
        path = str(tmp_path / f"t{line_order}.exr")
        _write_exr(path, img, compression, ptype, line_order)
        got, want = texr.read_exr(path), jexr.read_exr(path)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, img.astype(np.float16 if ptype == 1 else np.float32))
    texr.write_exr(str(tmp_path / "w.exr"), img[..., :3])
    np.testing.assert_array_equal(
        texr.read_exr(str(tmp_path / "w.exr")),
        jexr.read_exr(str(tmp_path / "w.exr")))


def test_exr_rejects_what_it_cannot_read(tmp_path):
    path = str(tmp_path / "bogus.exr")
    with open(path, "wb") as f:
        f.write(b"not an exr at all")
    with pytest.raises(ValueError):
        texr.read_exr(path)


# -- .assbin --------------------------------------------------------------------

def _model(mod):
    tri = mod.AssbinMesh(
        positions=np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0]]),
        normals=np.float32([[0, 0, 1]] * 3),
        tangents=np.float32([[1, 0, 0]] * 3),
        texcoords=np.float32([[0, 0], [1, 0], [0, 1]]),
        faces=np.int32([[0, 1, 2]]), material_index=0)
    quad = mod.AssbinMesh(
        positions=np.float32([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]]),
        normals=None, tangents=None, texcoords=None,
        faces=np.int32([[0, 1, 2], [0, 2, 3]]), material_index=1)
    child = mod.AssbinNode("child", np.float32(
        [[1, 0, 0, 2], [0, -1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]), [1])
    root = mod.AssbinNode("root", np.eye(4, dtype=np.float32), [0], [child])
    return mod.AssbinScene(root=root, meshes=[tri, quad],
                           material_names=["leaf", "stone"])


def test_assbin_round_trip(tmp_path):
    path = str(tmp_path / "m.assbin")
    tassbin.write_assbin(path, _model(tassbin))
    got, want = tassbin.read_assbin(path), jassbin.read_assbin(path)
    assert got.material_names == want.material_names == ["leaf", "stone"]
    assert got.root.children[0].name == "child"
    np.testing.assert_array_equal(got.root.children[0].transform,
                                  want.root.children[0].transform)
    for gm, wm, sm in zip(got.meshes, want.meshes, _model(tassbin).meshes):
        for field in ("positions", "normals", "tangents", "texcoords",
                      "faces"):
            g, w, s = (getattr(m, field) for m in (gm, wm, sm))
            assert (g is None) == (w is None) == (s is None), field
            if g is not None:
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, s)
        assert gm.material_index == wm.material_index


# -- PNG ------------------------------------------------------------------------

def _pil_png(mode, rs, **save):
    Image = pytest.importorskip("PIL.Image")
    h, w = 23, 41
    smooth = (np.add.outer(np.arange(h) * 5, np.arange(w) * 3) % 256)
    rgba = np.stack([smooth, smooth[::-1], 255 - smooth,
                     rs.randint(0, 256, (h, w))], -1).astype(np.uint8)
    rgba[::3] = rs.randint(0, 256, (len(rgba[::3]), w, 4))  # noisy rows
    im = Image.fromarray(rgba, "RGBA")
    im = im.convert("RGB").convert("P") if mode == "P" else im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "PNG", **save)
    data = buf.getvalue()
    return data, np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


@pytest.mark.parametrize("mode", ["L", "LA", "P", "RGB", "RGBA"])
def test_png_decoder_matches_pil(mode):
    """PIL picks each row's filter itself: all five filters occur."""
    rs = np.random.RandomState(len(mode))
    data, want = _pil_png(mode, rs)
    np.testing.assert_array_equal(decode_png(data), want)
    data, want = _pil_png(mode, rs, optimize=True)
    np.testing.assert_array_equal(decode_png(data), want)


@pytest.mark.parametrize("mode,key", [("P", 7), ("L", 40),
                                      ("RGB", (12, 6, 243))])
def test_png_transparency_matches_pil(mode, key):
    data, want = _pil_png(mode, np.random.RandomState(9), transparency=key)
    np.testing.assert_array_equal(decode_png(data), want)


def test_png_refuses_by_feature(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000,
                    "I;16").save(buf, "PNG")
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(buf.getvalue())
    data, _ = _pil_png("RGB", np.random.RandomState(0))
    ihdr = bytearray(data[16:29])
    ihdr[12] = 1                                    # the Adam7 flag
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + bytes(ihdr)) & 0xFFFFFFFF)
    laced = data[:16] + bytes(ihdr) + crc + data[33:]
    with pytest.raises(ValueError, match="interlac"):
        decode_png(laced)
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")


def test_port_writer_round_trips(tmp_path):
    """The port's own PNG writer (RGB and RGBA) read back by the decoder
    and by PIL."""
    from slr_tpu_torch.render.film import save_png, to_uint8

    rs = np.random.RandomState(3)
    for c in (3, 4):
        img = rs.uniform(0, 1, (17, 9, c)).astype(np.float32)
        path = str(tmp_path / f"w{c}.png")
        save_png(path, img)
        want = to_uint8(img)
        got = read_png(path)
        np.testing.assert_array_equal(got[..., :c], want)
        Image = pytest.importorskip("PIL.Image")
        np.testing.assert_array_equal(
            np.asarray(Image.open(path).convert("RGBA")), got)


# -- images through the scene API -------------------------------------------------

def test_image2d_matches_reference(tmp_path):
    """Image2D of a PNG: PIL's bytes in slr_tpu, the port's decoder here,
    then the same sRGB de-gamma; AlphaTexture rides on the array."""
    from slr_tpu.scene.api import ApiContext as JCtx
    from slr_tpu.scene.api import _load_image as j_load
    from slr_tpu_torch.scene.api import ApiContext as TCtx
    from slr_tpu_torch.scene.api import _load_image as t_load
    from slr_tpu_torch.scene.api import make_global_env
    from slr_tpu_torch.scene.dsl.parser import execute
    from slr_tpu_torch.scene.graph import SceneDesc

    data, _ = _pil_png("RGBA", np.random.RandomState(5))
    (tmp_path / "tex.png").write_bytes(data)
    got = t_load(TCtx(SceneDesc(), str(tmp_path)), "tex.png")
    want = j_load(JCtx(None, str(tmp_path)), "tex.png")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    ctx = TCtx(SceneDesc(), str(tmp_path))
    env = make_global_env(ctx)
    execute('a = FloatTexture(Image2D("tex.png", "AlphaTexture")); '
            'l = FloatTexture(Image2D("tex.png"));', env, ctx)
    assert env.lookup("a").channel == "alpha"
    assert env.lookup("l").channel == "lum"


@pytest.mark.parametrize("name", ["missing.png", "missing.exr", "broken.exr"])
def test_missing_image_gets_reference_placeholder(tmp_path, caplog, name):
    from slr_tpu.scene.api import ApiContext as JCtx
    from slr_tpu.scene.api import _load_image as j_load
    from slr_tpu_torch.scene.api import ApiContext as TCtx
    from slr_tpu_torch.scene.api import _load_image as t_load
    from slr_tpu_torch.scene.graph import SceneDesc

    (tmp_path / "broken.exr").write_bytes(b"\x76\x2f\x31\x01garbage")
    with caplog.at_level("WARNING", logger="slr_tpu_torch"):
        got = t_load(TCtx(SceneDesc(), str(tmp_path)), name)
    assert caplog.records
    want = j_load(JCtx(None, str(tmp_path)), name)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (64, 128, 4)
