"""Minimal assimp binary-dump (.assbin) reader, a copy of
slr_tpu/utils/assbin.py.

The reference imports models through assimp 3.2 (libSLRSceneGraph/
node_constructor.cpp:35-105: recursive node walk applying transforms,
per-mesh vertices with generated tangents when absent, per-mesh material
index). This module parses the subset of the `.assbin` container those
scenes need — node hierarchy (names + 4x4 transforms), triangle meshes
(positions / normals / tangents / texcoords / faces) and material name
properties — for UNCOMPRESSED, NON-SHORTENED dumps (the assimp CLI's
default `assimp export model.X model.assbin`).

Layout follows assimp's AssbinExporter/AssbinLoader (code/assbin_chunks.h):
a 512-byte header (signature, version words, shortened/compressed u16
flags, source-path fields) followed by length-prefixed chunks
(u32 magic, u32 byte length). Only the chunk kinds below are understood;
unknown chunks are skipped by length, which is what makes the reader
version-tolerant.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

CHUNK_AICAMERA = 0x1234
CHUNK_AILIGHT = 0x1235
CHUNK_AITEXTURE = 0x1236
CHUNK_AIMESH = 0x1237
CHUNK_AINODEANIM = 0x1238
CHUNK_AINODE = 0x1239
CHUNK_AIMATERIAL = 0x123A
CHUNK_AIMATERIALPROPERTY = 0x123B
CHUNK_AIMESHANIM = 0x123C
CHUNK_AIANIMATION = 0x123D
CHUNK_AISCENE = 0x123E
CHUNK_AIBONE = 0x123F

MESH_HAS_POSITIONS = 0x1
MESH_HAS_NORMALS = 0x2
MESH_HAS_TANGENTS = 0x4
MESH_HAS_TEXCOORD_BASE = 0x100
MESH_HAS_COLOR_BASE = 0x10000

_HEADER_LEN = 512
_SIGNATURE = b"ASSIMP.binary-dump."


@dataclass
class AssbinMesh:
    positions: np.ndarray                  # (V, 3) f32
    normals: np.ndarray | None             # (V, 3) f32
    tangents: np.ndarray | None            # (V, 3) f32
    texcoords: np.ndarray | None           # (V, 2) f32 (channel 0)
    faces: np.ndarray                      # (F, 3) int32 (triangulated)
    material_index: int = 0


@dataclass
class AssbinNode:
    name: str
    transform: np.ndarray                  # (4, 4) f32 row-major
    mesh_indices: list = field(default_factory=list)
    children: list = field(default_factory=list)


@dataclass
class AssbinScene:
    root: AssbinNode
    meshes: list
    material_names: list                   # str per material ("" if absent)


class _Reader:
    def __init__(self, buf: bytes, off: int = 0):
        self.buf = buf
        self.off = off

    def u16(self) -> int:
        v = struct.unpack_from("<H", self.buf, self.off)[0]
        self.off += 2
        return v

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.buf, self.off)[0]
        self.off += 4
        return v

    def f32s(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.buf, np.float32, n, self.off)
        self.off += 4 * n
        return v

    def aistring(self) -> str:
        n = self.u32()
        s = self.buf[self.off:self.off + n]
        self.off += n
        return s.split(b"\0", 1)[0].decode("utf-8", "replace")

    def chunk(self) -> tuple[int, "_Reader"]:
        """Read a (magic, payload reader) pair, advancing past the chunk."""
        magic = self.u32()
        ln = self.u32()
        sub = _Reader(self.buf[self.off:self.off + ln])
        self.off += ln
        return magic, sub


def _read_node(r: _Reader) -> AssbinNode:
    magic, sub = r.chunk()
    if magic != CHUNK_AINODE:
        raise ValueError(f"expected AINODE chunk, got 0x{magic:x}")
    name = sub.aistring()
    m = sub.f32s(16).reshape(4, 4)
    n_children = sub.u32()
    n_meshes = sub.u32()
    meshes = [sub.u32() for _ in range(n_meshes)]
    node = AssbinNode(name=name, transform=np.array(m, np.float32),
                      mesh_indices=meshes)
    for _ in range(n_children):
        node.children.append(_read_node(sub))
    return node


def _read_mesh(sub: _Reader) -> AssbinMesh:
    sub.u32()                    # primitive types
    n_v = sub.u32()
    n_f = sub.u32()
    n_bones = sub.u32()
    mat_idx = sub.u32()
    comp = sub.u32()
    positions = normals = tangents = texcoords = None
    if comp & MESH_HAS_POSITIONS:
        positions = sub.f32s(3 * n_v).reshape(n_v, 3)
    if comp & MESH_HAS_NORMALS:
        normals = sub.f32s(3 * n_v).reshape(n_v, 3)
    if comp & MESH_HAS_TANGENTS:
        tangents = sub.f32s(3 * n_v).reshape(n_v, 3)
        sub.f32s(3 * n_v)        # bitangents (recomputed at build)
    c = 0
    while comp & (MESH_HAS_COLOR_BASE << c):
        sub.f32s(4 * n_v)
        c += 1
    t = 0
    while comp & (MESH_HAS_TEXCOORD_BASE << t):
        sub.u32()                # mNumUVComponents[t]
        uvw = sub.f32s(3 * n_v).reshape(n_v, 3)
        if t == 0:
            texcoords = uvw[:, :2].copy()
        t += 1
    tris = []
    wide = n_v >= (1 << 16)
    for _ in range(n_f):
        k = sub.u16()
        idx = [sub.u32() if wide else sub.u16() for _ in range(k)]
        # triangulate fans (the reference triangulates at import)
        for j in range(1, k - 1):
            tris.append((idx[0], idx[j], idx[j + 1]))
    for _ in range(n_bones):
        sub.chunk()
    if positions is None:
        raise ValueError("assbin mesh without positions")
    return AssbinMesh(
        positions=np.ascontiguousarray(positions, np.float32),
        normals=None if normals is None
        else np.ascontiguousarray(normals, np.float32),
        tangents=None if tangents is None
        else np.ascontiguousarray(tangents, np.float32),
        texcoords=texcoords,
        faces=np.asarray(tris, np.int32).reshape(-1, 3),
        material_index=mat_idx,
    )


def _read_material_name(sub: _Reader) -> str:
    n_props = sub.u32()
    name = ""
    for _ in range(n_props):
        magic, p = sub.chunk()
        if magic != CHUNK_AIMATERIALPROPERTY:
            continue
        key = p.aistring()
        p.u32()                  # semantic
        p.u32()                  # index
        ln = p.u32()
        p.u32()                  # type
        data = p.buf[p.off:p.off + ln]
        if key == "?mat.name":
            # aiString payload: u32 length + bytes
            sl = struct.unpack_from("<I", data, 0)[0]
            name = data[4:4 + sl].split(b"\0", 1)[0].decode(
                "utf-8", "replace")
    return name


def read_assbin(path: str) -> AssbinScene:
    """Parse an .assbin file into (node tree, meshes, material names)."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not an assimp binary dump")
    head = _Reader(buf, 44)
    head.u32()                   # version major
    head.u32()                   # version minor
    head.u32()                   # revision
    head.u32()                   # compile flags
    shortened = head.u16()
    compressed = head.u16()
    if shortened:
        raise ValueError(f"{path}: shortened dumps are not supported")
    if compressed:
        raise ValueError(f"{path}: compressed dumps are not supported")

    r = _Reader(buf, _HEADER_LEN)
    magic, sc = r.chunk()
    if magic != CHUNK_AISCENE:
        raise ValueError(f"{path}: expected AISCENE chunk, got 0x{magic:x}")
    sc.u32()                     # scene flags
    n_meshes = sc.u32()
    n_materials = sc.u32()
    n_anims = sc.u32()
    n_textures = sc.u32()
    n_lights = sc.u32()
    n_cameras = sc.u32()
    root = _read_node(sc)
    meshes = []
    for _ in range(n_meshes):
        magic, sub = sc.chunk()
        if magic != CHUNK_AIMESH:
            raise ValueError(f"{path}: expected AIMESH, got 0x{magic:x}")
        meshes.append(_read_mesh(sub))
    mat_names = []
    for _ in range(n_materials):
        magic, sub = sc.chunk()
        if magic != CHUNK_AIMATERIAL:
            break
        mat_names.append(_read_material_name(sub))
    # animations/textures/lights/cameras: skipped (length-prefixed)
    return AssbinScene(root=root, meshes=meshes, material_names=mat_names)


# ---------------------------------------------------------------------------
# Writer — the fixture generator (no assimp CLI or pyassimp is assumed, so
# round-trip tests and generated scenes write their own dumps with the same
# layout the reader documents).
# ---------------------------------------------------------------------------

def _w_aistring(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    out += struct.pack("<I", len(b)) + b


def _w_chunk(out: bytearray, magic: int, payload: bytes) -> None:
    out += struct.pack("<II", magic, len(payload)) + payload


def _node_payload(node: AssbinNode) -> bytes:
    out = bytearray()
    _w_aistring(out, node.name)
    out += np.asarray(node.transform, np.float32).reshape(16).tobytes()
    out += struct.pack("<II", len(node.children), len(node.mesh_indices))
    for mi in node.mesh_indices:
        out += struct.pack("<I", mi)
    for ch in node.children:
        _w_chunk(out, CHUNK_AINODE, _node_payload(ch))
    return bytes(out)


def write_assbin(path: str, scene: AssbinScene) -> None:
    sc = bytearray()
    sc += struct.pack("<7I", 0, len(scene.meshes), len(scene.material_names),
                      0, 0, 0, 0)
    _w_chunk(sc, CHUNK_AINODE, _node_payload(scene.root))
    for m in scene.meshes:
        p = bytearray()
        n_v = m.positions.shape[0]
        comp = MESH_HAS_POSITIONS
        if m.normals is not None:
            comp |= MESH_HAS_NORMALS
        if m.tangents is not None:
            comp |= MESH_HAS_TANGENTS
        if m.texcoords is not None:
            comp |= MESH_HAS_TEXCOORD_BASE
        p += struct.pack("<6I", 4, n_v, m.faces.shape[0], 0,
                         m.material_index, comp)
        p += np.asarray(m.positions, np.float32).tobytes()
        if m.normals is not None:
            p += np.asarray(m.normals, np.float32).tobytes()
        if m.tangents is not None:
            p += np.asarray(m.tangents, np.float32).tobytes()
            p += np.zeros_like(np.asarray(m.tangents, np.float32)).tobytes()
        if m.texcoords is not None:
            p += struct.pack("<I", 2)
            uvw = np.zeros((n_v, 3), np.float32)
            uvw[:, :2] = m.texcoords
            p += uvw.tobytes()
        wide = n_v >= (1 << 16)
        for f in np.asarray(m.faces, np.int64):
            p += struct.pack("<H", 3)
            p += struct.pack("<3I" if wide else "<3H", *f)
        _w_chunk(sc, CHUNK_AIMESH, bytes(p))
    for name in scene.material_names:
        props = bytearray()
        props += struct.pack("<I", 1)
        pp = bytearray()
        _w_aistring(pp, "?mat.name")
        nb = name.encode("utf-8")
        payload = struct.pack("<I", len(nb)) + nb
        pp += struct.pack("<IIII", 0, 0, len(payload), 3)  # type 3 = aiString
        pp += payload
        _w_chunk(props, CHUNK_AIMATERIALPROPERTY, bytes(pp))
        _w_chunk(sc, CHUNK_AIMATERIAL, bytes(props))

    head = bytearray()
    head += (_SIGNATURE + b" (slr_tpu test fixture)").ljust(44, b"\0")[:44]
    head += struct.pack("<4I", 3, 2, 0, 0)
    head += struct.pack("<HH", 0, 0)     # shortened=0, compressed=0
    head += b"\0" * (256 + 128 + 64)
    assert len(head) == _HEADER_LEN
    out = bytearray(head)
    _w_chunk(out, CHUNK_AISCENE, bytes(sc))
    with open(path, "wb") as f:
        f.write(bytes(out))
