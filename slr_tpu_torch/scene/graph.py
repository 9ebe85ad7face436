"""Authoring scene graph: descriptor objects and their flattening into a
FlatScene (counterpart of slr_tpu/scene/graph.py).

Nodes with transforms and children, triangle-mesh nodes, reference nodes for
instancing and camera nodes; `flatten` bakes static transforms into the
vertices and hands flat arrays to `scene.build.SceneBuilder`. Animated
subtrees and reference nodes become shared BLASes with instance rows. The
descriptors cover every kind the scene language has.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from .build import SceneBuilder


# ---------------------------------------------------------------------------
# Spectrum descriptors
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpectrumDesc:
    kind: str                 # mono | rgb | regular | irregular | library
    spectrum_type: str = "Reflectance"
    value: float = 0.0        # mono
    rgb: tuple = (0.0, 0.0, 0.0)
    min_wl: float = 0.0
    max_wl: float = 0.0
    values: tuple = ()
    wls: tuple = ()
    library_id: str = ""
    library_comp: int = 0
    scale: float = 1.0

    def scaled(self, s: float) -> "SpectrumDesc":
        return dataclasses.replace(self, scale=self.scale * s)

    def curve(self) -> tuple[np.ndarray, np.ndarray]:
        """Tabulated (wls, values) for curve-typed spectra."""
        from ..spectrum.spectral import _raw, ior_spectrum

        if self.kind == "regular":
            wls = np.linspace(self.min_wl, self.max_wl, len(self.values))
            return wls.astype(np.float32), np.asarray(self.values, np.float32)
        if self.kind == "irregular":
            return (np.asarray(self.wls, np.float32),
                    np.asarray(self.values, np.float32))
        if self.kind == "library":
            if self.library_id == "D65":
                d = _raw("cie.npz")
                wls = np.linspace(300.0, 830.0, d["d65"].shape[0])
                return wls.astype(np.float32), d["d65"]
            if self.library_id.startswith("ColorChecker"):
                d = _raw("cie.npz")
                wls = np.linspace(380.0, 730.0, 36)
                return (wls.astype(np.float32),
                        d["colorchecker"][self.library_comp])
            lam, etas, ks = ior_spectrum(self.library_id)
            return lam, (etas if self.library_comp == 0 else ks)
        raise ValueError(f"not a curve spectrum: {self.kind}")

    def to_rgb(self) -> np.ndarray:
        """RGB-mode conversion: constants pass through, curves integrate
        against the CIE 1931 colour-matching functions."""
        if self.kind == "mono":
            return np.full((3,), self.value * self.scale, np.float32)
        if self.kind == "rgb":
            return np.asarray(self.rgb, np.float32) * self.scale
        from ..spectrum.spectral import _raw

        d = _raw("cie.npz")
        wls, vals = self.curve()
        grid = np.linspace(360.0, 830.0, 471)
        v = np.interp(grid, wls, vals, left=0.0, right=0.0)
        xyz = np.stack([
            (v * d["xbar"]).sum(), (v * d["ybar"]).sum(), (v * d["zbar"]).sum()
        ]) / d["ybar"].sum()
        m = np.array([[3.2404542, -1.5371385, -0.4985314],
                      [-0.9692660, 1.8760108, 0.0415560],
                      [0.0556434, -0.2040259, 1.0572252]], np.float32)
        return (m @ xyz.astype(np.float32)) * self.scale


# ---------------------------------------------------------------------------
# Texture / material descriptors
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MappingDesc:
    kind: str = "texcoord 2D"   # | "world pos"
    scale: tuple = (1.0, 1.0)
    offset: tuple = (0.0, 0.0)


@dataclasses.dataclass
class STexDesc:
    kind: str                  # constant | image | checker | voronoi
    spectrum: Optional[SpectrumDesc] = None
    image: Optional[np.ndarray] = None
    v0: Optional[SpectrumDesc] = None
    v1: Optional[SpectrumDesc] = None
    cell_scale: float = 1.0
    brightness: float = 0.8
    mapping: MappingDesc = dataclasses.field(default_factory=MappingDesc)


@dataclasses.dataclass
class FTexDesc:
    kind: str                  # constant | checker | voronoi | image
    value: float = 0.0
    v0: float = 0.0
    v1: float = 0.0
    cell_scale: float = 1.0
    value_scale: float = 1.0
    image: Optional[np.ndarray] = None
    channel: str = "lum"       # image channel: lum | alpha
    mapping: MappingDesc = dataclasses.field(default_factory=MappingDesc)


@dataclasses.dataclass
class NTexDesc:
    kind: str                  # image | checker | voronoi
    image: Optional[np.ndarray] = None
    step_width: float = 1.0
    reverse: bool = False
    mapping: MappingDesc = dataclasses.field(default_factory=MappingDesc)


@dataclasses.dataclass
class EmitterDesc:
    kind: str                  # diffuse | ibl
    emittance: Optional[STexDesc] = None


@dataclasses.dataclass
class MaterialDesc:
    kind: str
    stex: tuple = ()           # spectrum texture descriptors
    ftex: tuple = ()           # float texture descriptors
    sub: tuple = ()            # sub-materials (mix / sum / inverse / emitter)
    emitter: Optional[EmitterDesc] = None


@dataclasses.dataclass
class Vertex:
    position: np.ndarray
    normal: np.ndarray
    tangent: np.ndarray
    uv: np.ndarray


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------

class Node:
    def __init__(self, name: str = ""):
        self.name = name
        self.transform: Any = np.eye(4, dtype=np.float32)  # 4x4 or animated tuple
        self.children: list[Node] = []

    def add_child(self, child: "Node") -> None:
        self.children.append(child)


class MeshNode(Node):
    def __init__(self, name: str = ""):
        super().__init__(name)
        self.vertices: list[Vertex] = []
        # (MaterialDesc, NTexDesc | None, FTexDesc | None, [(i, j, k)])
        self.groups: list[tuple] = []

    def add_group(self, mat, normal_tex, alpha_tex, tris) -> None:
        self.groups.append((mat, normal_tex, alpha_tex, list(tris)))


class ReferenceNode(Node):
    """Instancing: shares the referenced subtree."""

    def __init__(self, target: Node):
        super().__init__("ref:" + target.name)
        self.target = target


class CameraNode(Node):
    def __init__(self, params: dict):
        super().__init__("camera")
        self.params = params


class SceneDesc:
    """Root node plus the render configuration of a scene file."""

    def __init__(self) -> None:
        self.root = Node("root")
        self.env_image: Optional[np.ndarray] = None
        self.env_scale: float = 1.0
        self.renderer: dict = {"method": "PT", "samples": 8}
        self.settings: dict = {
            "width": 1024, "height": 1024, "timeStart": 0.0, "timeEnd": 0.0,
            "brightness": 1.0, "rngSeed": 1509761209,
        }


# ---------------------------------------------------------------------------
# Flattening
# ---------------------------------------------------------------------------

def _trs_sample_np(m0: np.ndarray, m1: np.ndarray, u: float) -> np.ndarray:
    """Matrix at parameter u in [0, 1] between two pinned transforms by
    decomposed interpolation: lerp of T and S, slerp of R."""
    from ..core.transform import decompose_trs, trs_to_matrix_np

    t0, q0, s0 = decompose_trs(m0)
    t1, q1, s1 = decompose_trs(m1)
    if np.dot(q0, q1) < 0:
        q1 = -q1
    d = float(np.clip(np.dot(q0, q1), -1.0, 1.0))
    theta = np.arccos(d)
    if theta < 1e-6:
        q = (1 - u) * q0 + u * q1
    else:
        q = (np.sin((1 - u) * theta) * q0 + np.sin(u * theta) * q1) \
            / np.sin(theta)
    q = q / np.linalg.norm(q)
    return trs_to_matrix_np((1 - u) * t0 + u * t1, q.astype(np.float32),
                            (1 - u) * s0 + u * s1)


def _matrix_pair(tf: Any, time_start: float = 0.0,
                 time_end: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """(matrix at shutter begin, matrix at shutter end). An animated
    transform (tfStart, tfEnd, tBegin, tEnd) is pinned at absolute times,
    so it is re-sampled at the shutter's [timeStart, timeEnd], clamped."""
    if isinstance(tf, tuple):
        m0 = np.asarray(tf[0], np.float32)
        m1 = np.asarray(tf[1], np.float32)
        tb, te = (float(tf[2]), float(tf[3])) if len(tf) >= 4 else (0.0, 1.0)
        span = te - tb
        if span <= 0.0:
            return m0, m0
        u0 = float(np.clip((time_start - tb) / span, 0.0, 1.0))
        u1 = float(np.clip((time_end - tb) / span, 0.0, 1.0))
        return _trs_sample_np(m0, m1, u0), _trs_sample_np(m0, m1, u1)
    m = np.asarray(tf, np.float32)
    return m, m


def _material_emits(mat: Any) -> bool:
    if mat is None:
        return False
    if getattr(mat, "emitter", None) is not None:
        return True
    return any(_material_emits(s) for s in getattr(mat, "sub", ()) or ())


def _subtree_emits(node: "Node") -> bool:
    if isinstance(node, MeshNode):
        if any(_material_emits(g[0]) for g in node.groups):
            return True
    if isinstance(node, ReferenceNode):
        return _subtree_emits(node.target)
    return any(_subtree_emits(c) for c in node.children)


class _Flattener:
    def __init__(self, builder: SceneBuilder, time_start: float = 0.0,
                 time_end: float = 0.0):
        self.b = builder
        self.time_start = time_start
        self.time_end = time_end
        self._stex_cache: dict[int, int] = {}
        self._ftex_cache: dict[int, int] = {}
        self._mat_cache: dict[tuple, int] = {}
        self._blas_cache: dict[int, int] = {}  # id(subtree) -> BLAS id
        self._in_blas = False

    # -- textures -----------------------------------------------------------
    def stex(self, desc: Optional[STexDesc]) -> int:
        if desc is None:
            return -1
        key = id(desc)
        if key not in self._stex_cache:
            self._stex_cache[key] = self._build_stex(desc)
        return self._stex_cache[key]

    def _spectrum_const(self, sd: SpectrumDesc, illuminant: bool) -> int:
        b = self.b
        if sd.kind in ("mono", "rgb"):
            if b.spectral:
                if sd.kind == "mono":
                    return b.add_stex_const((sd.value * sd.scale,) * 3,
                                            illuminant=illuminant)
                return b.add_stex_const(tuple(np.asarray(sd.rgb) * sd.scale),
                                        illuminant=illuminant)
            return b.add_stex_const(tuple(sd.to_rgb()))
        if b.spectral:          # curve-typed
            wls, vals = sd.curve()
            return b.add_stex_curve(b.add_curve(wls, vals), scale=sd.scale)
        return b.add_stex_const(tuple(sd.to_rgb()))

    def _build_stex(self, desc: STexDesc) -> int:
        b = self.b
        if desc.kind == "constant":
            illum = (desc.spectrum is not None
                     and desc.spectrum.spectrum_type == "Illuminant")
            return self._spectrum_const(desc.spectrum, illum)
        if desc.kind == "checker":
            if b.spectral:
                # The checker's colours as reflectance (u, v, scale).
                tid = b.add_stex_checker((0, 0, 0), (0, 0, 0),
                                         desc.mapping.scale,
                                         desc.mapping.offset)
                b.stex[tid].value = b._rgb_to_uvs(
                    np.asarray(desc.v0.to_rgb()), False)
                b.stex[tid].value2 = b._rgb_to_uvs(
                    np.asarray(desc.v1.to_rgb()), False)
                return tid
            return b.add_stex_checker(
                tuple(desc.v0.to_rgb()), tuple(desc.v1.to_rgb()),
                desc.mapping.scale, desc.mapping.offset)
        if desc.kind == "voronoi":
            return b.add_stex_voronoi(desc.cell_scale, desc.brightness)
        if desc.kind == "image":
            img_id = b.add_image(desc.image)
            tid = b.add_stex_image(img_id, 1.0, desc.mapping.scale,
                                   desc.mapping.offset)
            if b.spectral:
                # value[2] is the spectral scale multiplier.
                b.stex[tid].value = np.float32([0.0, 0.0, 1.0])
            return tid
        raise ValueError(f"unknown stex kind {desc.kind}")

    def ntex(self, desc: Optional[NTexDesc]) -> int:
        if desc is None:
            return -1
        key = id(desc)
        if key in self._ftex_cache:     # shared cache, keyed by identity
            return self._ftex_cache[key]
        b = self.b
        if desc.kind == "image":
            tid = b.add_ntex_image(b.add_image(desc.image),
                                   desc.mapping.scale, desc.mapping.offset)
        else:                           # the procedural checker board
            tid = b.add_ntex_checker(desc.step_width, desc.reverse,
                                     desc.mapping.scale, desc.mapping.offset)
        self._ftex_cache[key] = tid
        return tid

    def ftex(self, desc: Optional[FTexDesc]) -> int:
        if desc is None:
            return -1
        key = id(desc)
        if key in self._ftex_cache:
            return self._ftex_cache[key]
        if desc.kind == "constant":
            tid = self.b.add_ftex_const(desc.value)
        elif desc.kind == "checker":
            tid = self.b.add_ftex_checker(desc.v0, desc.v1,
                                          desc.mapping.scale,
                                          desc.mapping.offset)
        elif desc.kind == "voronoi":
            tid = self.b.add_ftex_voronoi(desc.cell_scale, desc.value_scale)
        elif desc.kind == "image":
            img_id = self.b.add_image(desc.image)
            tid = self.b.add_ftex_image(img_id, desc.channel, 1.0,
                                        desc.mapping.scale,
                                        desc.mapping.offset)
        else:
            raise ValueError(f"unknown ftex kind {desc.kind}")
        self._ftex_cache[key] = tid
        return tid

    # -- materials ----------------------------------------------------------
    def material(self, desc: MaterialDesc) -> int:
        key = (id(desc),)
        if key not in self._mat_cache:
            self._mat_cache[key] = self._build_material(desc)
        return self._mat_cache[key]

    def _build_material(self, m: MaterialDesc) -> int:
        b = self.b
        k = m.kind
        if k == "matte":
            return b.add_matte(self.stex(m.stex[0]),
                               self.ftex(m.ftex[0]) if m.ftex else -1)
        if k == "metal":
            return b.add_metal(*(self.stex(t) for t in m.stex))
        if k == "glass":
            return b.add_glass(*(self.stex(t) for t in m.stex))
        if k == "sum":
            return b.add_summed(self.material(m.sub[0]),
                                self.material(m.sub[1]))
        if k == "emitter":
            scatter_id = self.material(m.sub[0])
            return b.add_emitter(scatter_id, self.stex(m.emitter.emittance))
        if k == "microfacet metal":
            return b.add_microfacet_metal(self.stex(m.stex[0]),
                                          self.stex(m.stex[1]),
                                          self.ftex(m.ftex[0]))
        if k == "microfacet glass":
            return b.add_microfacet_glass(self.stex(m.stex[0]),
                                          self.stex(m.stex[1]),
                                          self.ftex(m.ftex[0]))
        if k == "Ward":
            return b.add_ward(self.stex(m.stex[0]), self.ftex(m.ftex[0]),
                              self.ftex(m.ftex[1]))
        if k == "Ashikhmin":
            # The scene language's order is (Rd, Rs, nx, ny).
            return b.add_ashikhmin(self.stex(m.stex[1]), self.stex(m.stex[0]),
                                   self.ftex(m.ftex[0]), self.ftex(m.ftex[1]))
        if k == "mix":
            return b.add_mixed(self.material(m.sub[0]),
                               self.material(m.sub[1]), self.ftex(m.ftex[0]))
        if k == "inverse":
            return b.add_inverse(self.material(m.sub[0]))
        raise ValueError(f"unknown material kind {k}")

    # -- geometry -----------------------------------------------------------
    def mesh(self, node: MeshNode, world: np.ndarray) -> None:
        if not node.vertices:
            return
        pos = np.stack([v.position for v in node.vertices])
        nrm = np.stack([v.normal for v in node.vertices])
        tan = np.stack([v.tangent for v in node.vertices])
        uv = np.stack([v.uv for v in node.vertices])
        for mat, normal_tex, alpha_tex, tris in node.groups:
            if not tris or mat is None:
                continue
            mid = self.material(mat)
            self.b.add_mesh(pos, nrm, tan, uv, np.asarray(tris, np.int32),
                            mid, transform=world,
                            alpha_ftex=self.ftex(alpha_tex) if alpha_tex
                            else -1,
                            normal_ntex=self.ntex(normal_tex) if normal_tex
                            else -1)

    def walk(self, node: Node, world: np.ndarray,
             world_end: Optional[np.ndarray] = None) -> None:
        """Flatten the graph. `world` / `world_end` are the chain products
        at the shutter's ends (equal while the chain is static). Static
        geometry is baked; animated subtrees and reference nodes become
        BLASes with instance rows, except emissive subtrees, which are
        baked (per instance) so that the light table stays static."""
        if world_end is None:
            world_end = world
        t0, t1 = _matrix_pair(node.transform, self.time_start, self.time_end)
        w0 = world @ t0
        w1 = world_end @ t1
        animated = not np.array_equal(w0, w1)

        if isinstance(node, ReferenceNode):
            if self._in_blas or _subtree_emits(node.target):
                # Emissive (or nested) instances are baked per instance;
                # animated emitters bake at the shutter's begin.
                self.walk(node.target, w0, w0)
            else:
                bid = self._blas_cache.get(id(node.target))
                if bid is None:
                    bid = self.b.begin_blas()
                    self._in_blas = True
                    try:
                        self.walk(node.target, np.eye(4, dtype=np.float32))
                    finally:
                        self._in_blas = False
                        self.b.end_blas()
                    self._blas_cache[id(node.target)] = bid
                self.b.add_instance(bid, w0, w1)
            for c in node.children:
                self.walk(c, w0, w1)
            return

        if animated and not self._in_blas and isinstance(node, MeshNode) \
                and not _subtree_emits(node):
            bid = self._blas_cache.get(id(node))
            if bid is None:
                bid = self.b.begin_blas()
                self._in_blas = True
                try:
                    self.mesh(node, np.eye(4, dtype=np.float32))
                finally:
                    self._in_blas = False
                    self.b.end_blas()
                self._blas_cache[id(node)] = bid
            self.b.add_instance(bid, w0, w1)
        elif isinstance(node, MeshNode):
            self.mesh(node, w0)
        if isinstance(node, CameraNode):
            p = node.params
            self.b.set_camera_perspective(
                w0, aspect=p.get("aspect", 1.0),
                fovy=p.get("fovY", 0.5235987756),
                lens_radius=p.get("radius", 0.0),
                img_dist=p.get("imgDist", 0.02),
                obj_dist=p.get("objDist", 5.0))
        for c in node.children:
            self.walk(c, w0, w1)


def flatten(scene: SceneDesc, spectral: bool = False, use_bvh: bool = True):
    """SceneDesc -> FlatScene (CPU tensors)."""
    b = SceneBuilder(spectral=spectral)
    settings = getattr(scene, "settings", None) or {}
    f = _Flattener(b, time_start=float(settings.get("timeStart", 0.0)),
                   time_end=float(settings.get("timeEnd", 0.0)))
    f.walk(scene.root, np.eye(4, dtype=np.float32))
    if scene.env_image is not None:
        img_id = b.add_image(scene.env_image)
        b.set_environment(b.add_stex_image(img_id), scene.env_scale)
    return b.build(use_bvh=use_bvh)
