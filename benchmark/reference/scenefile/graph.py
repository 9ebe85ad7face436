"""The scene graph a scene file builds: descriptor objects for spectra,
textures, materials and meshes, and the nodes that hold them (reference
libSLRSceneGraph). A copy of the program's, kept so that both sides read a
scene file alike; `reference/scene.py` turns it into what the reference
renders.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


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
