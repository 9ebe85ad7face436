"""The reference's scene: a scene file's graph (read by `scenefile`) as
world-space triangles, materials, spectra, emitters and a camera, in
float64 on one device.

It holds what the benchmark's scenes use and refuses the rest: matte
(Lambert), metal (a smooth conductor) and glass (a smooth dielectric)
surfaces, diffuse emitters over a matte surface, constant spectra, static
meshes and a thin-lens perspective camera.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import spectra
from .scenefile.api import read_scene
from .scenefile.graph import CameraNode, MeshNode, ReferenceNode

MATTE, METAL, GLASS = 0, 1, 2
_KINDS = {"matte": MATTE, "metal": METAL, "glass": GLASS}


@dataclasses.dataclass
class Material:
    kind: int
    slots: tuple          # spectrum slots: matte (R,), metal (R, eta, k),
                          # glass (R, eta outside, eta inside)
    emit: int = -1        # the emittance's slot, -1 if it does not emit


@dataclasses.dataclass
class Camera:
    to_world: np.ndarray  # 4x4, camera space looks down +z
    aspect: float
    fov_y: float
    lens_radius: float
    obj_dist: float


@dataclasses.dataclass
class Scene:
    p: torch.Tensor       # (T, 3, 3) vertex positions
    n: torch.Tensor       # (T, 3, 3) vertex normals
    t: torch.Tensor       # (T, 3, 3) vertex tangents
    mat: torch.Tensor     # (T,) material index
    lights: torch.Tensor  # (L,) indices of the emitting triangles
    materials: list
    spectra: list         # per slot: spectra.Curve or spectra.Upsampled
    camera: Camera
    settings: dict

    @property
    def device(self):
        return self.p.device

    def kind(self) -> torch.Tensor:
        return torch.tensor([m.kind for m in self.materials],
                            device=self.device)

    def emits(self) -> torch.Tensor:
        return torch.tensor([m.emit >= 0 for m in self.materials],
                            device=self.device)


class _Builder:
    """Walks the graph depth first, numbering spectrum textures in the
    order it first meets them (a material's own, in its parameters' order;
    an emitter's scattering material's before its emittance)."""

    def __init__(self):
        self.slot_of, self.spectra = {}, []
        self.mat_of, self.materials = {}, []
        self.tris = {"p": [], "n": [], "t": [], "mat": []}
        self.camera = None

    def slot(self, stex) -> int:
        if id(stex) not in self.slot_of:
            if stex.kind != "constant":
                raise NotImplementedError(f"{stex.kind} spectrum textures")
            self.slot_of[id(stex)] = len(self.spectra)
            self.spectra.append(spectra.spectrum_of(stex.spectrum))
        return self.slot_of[id(stex)]

    def material(self, m) -> int:
        if id(m) in self.mat_of:
            return self.mat_of[id(m)]
        if m.kind == "emitter":
            base = self.materials[self.material(m.sub[0])]
            if m.emitter.kind != "diffuse":
                raise NotImplementedError(f"{m.emitter.kind} emitters")
            mat = Material(base.kind, base.slots,
                           self.slot(m.emitter.emittance))
        elif m.kind in _KINDS:
            if m.kind == "matte" and m.ftex and m.ftex[0] is not None:
                raise NotImplementedError("rough matte surfaces")
            mat = Material(_KINDS[m.kind], tuple(self.slot(s) for s in m.stex))
        else:
            raise NotImplementedError(f"{m.kind} materials")
        self.mat_of[id(m)] = len(self.materials)
        self.materials.append(mat)
        return self.mat_of[id(m)]

    def walk(self, node, world: np.ndarray) -> None:
        if isinstance(node, ReferenceNode) or not isinstance(
                node.transform, np.ndarray):
            raise NotImplementedError("instances and animated transforms")
        world = world @ node.transform.astype(np.float64)
        if isinstance(node, MeshNode) and node.vertices:
            self.mesh(node, world)
        if isinstance(node, CameraNode):
            q = node.params
            self.camera = Camera(world, float(q["aspect"]), float(q["fovY"]),
                                 float(q["radius"]), float(q["objDist"]))
        for child in node.children:
            self.walk(child, world)

    def mesh(self, node, world: np.ndarray) -> None:
        lin, move = world[:3, :3], world[:3, 3]
        p = np.stack([v.position for v in node.vertices]) @ lin.T + move
        n = np.stack([v.normal for v in node.vertices]) @ np.linalg.inv(lin)
        t = np.stack([v.tangent for v in node.vertices]) @ lin.T
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        t /= np.linalg.norm(t, axis=1, keepdims=True)
        for mat, normal_tex, alpha_tex, tris in node.groups:
            if normal_tex is not None or alpha_tex is not None:
                raise NotImplementedError("normal maps and alpha cutouts")
            if not tris or mat is None:
                continue
            idx = np.asarray(tris, np.int64)
            m = self.material(mat)
            for key, a in (("p", p), ("n", n), ("t", t)):
                self.tris[key].append(a[idx])
            self.tris["mat"].append(np.full(len(idx), m))


def load(path: str, device) -> Scene:
    """The scene file at `path` on `device`."""
    desc, _ = read_scene(path)
    if desc.env_image is not None:
        raise NotImplementedError("environment lights")
    b = _Builder()
    b.walk(desc.root, np.eye(4))
    if b.camera is None:
        raise ValueError("the scene has no camera")

    def t(key, dtype=torch.float64):
        return torch.as_tensor(np.concatenate(b.tris[key]), dtype=dtype,
                               device=device)

    mat = t("mat", torch.int64)
    emits = torch.tensor([m.emit >= 0 for m in b.materials], device=device)
    return Scene(p=t("p"), n=t("n"), t=t("t"), mat=mat,
                 lights=torch.nonzero(emits[mat])[:, 0],
                 materials=b.materials, spectra=b.spectra, camera=b.camera,
                 settings=dict(desc.settings))
