"""Flat SoA scene representation — the device-side scene format
(counterpart of slr_tpu/scene/types.py).

Every table is a dataclass of tensors with the reference's field names and
layouts; static metadata (flags, kind sets, byte blobs) are plain
attributes. `to_device` moves a whole scene in one call.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import torch

from ..core.sampling import Continuous2D, Discrete1D

Tensor = torch.Tensor

MAX_LOBES = 4


class LobeKind(enum.IntEnum):
    NONE = 0
    LAMBERT = 1
    OREN_NAYAR = 2
    SPECULAR_REFLECTION = 3
    SPECULAR_SCATTERING = 4
    MICROFACET_REFLECTION = 5
    MICROFACET_SCATTERING = 6
    WARD = 7
    ASHIKHMIN = 8
    FLIPPED_LAMBERT = 10


class STexKind(enum.IntEnum):
    CONST = 0
    IMAGE = 1
    CHECKER = 2
    VORONOI = 3
    CURVE = 4


class FTexKind(enum.IntEnum):
    CONST = 0
    IMAGE = 1
    CHECKER = 2
    VORONOI = 3
    ONE_MINUS = 4


class CameraKind(enum.IntEnum):
    PERSPECTIVE = 0
    EQUIRECTANGULAR = 1


@dataclasses.dataclass
class SpectrumTextures:
    """Tagged SoA table of spectrum textures. In spectral scenes tabulated
    SPDs live in `curves_v`, a regular per-nm grid over [WL_LO, WL_HI]
    addressed by `curve_id`; the scale of a CURVE row is value[0]."""

    kind: Tensor        # (C,) int32 STexKind
    value: Tensor       # (C, S)
    value2: Tensor      # (C, S)
    image_id: Tensor    # (C,) int32
    map_scale: Tensor   # (C, 2)
    map_offset: Tensor  # (C, 2)
    images: Tensor      # (NI, Hmax, Wmax, 4)
    image_hw: Tensor    # (NI, 2) int32
    curve_id: Tensor = None   # (C,) int32
    curves_wl: Tensor = None  # (K, 2) native [min_wl, max_wl] per curve
    curves_v: Tensor = None   # (K, G) regular-grid values
    spectral: bool = False
    has_checker: bool = False
    has_voronoi: bool = False
    has_curve: bool = False
    has_const: bool = True


@dataclasses.dataclass
class FloatTextures:
    kind: Tensor
    value: Tensor
    value2: Tensor
    image_id: Tensor
    map_scale: Tensor
    map_offset: Tensor
    has_image: bool = False
    has_voronoi: bool = False
    has_one_minus: bool = False


class NTexKind(enum.IntEnum):
    IMAGE = 0
    CHECKER = 1


@dataclasses.dataclass
class NormalTextures:
    kind: Tensor
    image_id: Tensor
    step_width: Tensor
    reverse: Tensor
    map_scale: Tensor
    map_offset: Tensor


@dataclasses.dataclass
class Materials:
    """Every material is <= MAX_LOBES tagged lobes (see the reference's
    Materials docstring for the per-kind slot meanings)."""

    lobe_kind: Tensor   # (M, L) int32
    lobe_stex: Tensor   # (M, L, 3) int32
    lobe_ftex: Tensor   # (M, L, 2) int32
    lobe_wtex: Tensor   # (M, L) int32
    emit_stex: Tensor   # (M,) int32

    @property
    def num(self) -> int:
        return self.lobe_kind.shape[0]


@dataclasses.dataclass
class Geometry:
    """Triangle soup with baked static transforms plus the packed (T, 40)
    per-triangle shading table (accel/intersect.py TRI_TABLE_COLS)."""

    positions: Tensor
    normals: Tensor
    tangents: Tensor
    uvs: Tensor
    tri_vidx: Tensor
    tri_mat: Tensor
    tri_alpha: Tensor
    tri_ntex: Tensor = None
    tri_table: Tensor = None

    @property
    def num_tris(self) -> int:
        return self.tri_vidx.shape[0]


@dataclasses.dataclass
class Lights:
    """Area lights over emissive triangles + the env-light share."""

    tri_idx: Tensor
    dist: Discrete1D
    env_prob: Tensor

    @property
    def num(self) -> int:
        return self.tri_idx.shape[0]


@dataclasses.dataclass
class EnvLight:
    stex: Tensor
    dist: Continuous2D
    scale: Tensor


@dataclasses.dataclass
class Camera:
    kind: int = CameraKind.PERSPECTIVE
    to_world: Tensor = None
    aspect: Tensor = None
    fovy: Tensor = None
    lens_radius: Tensor = None
    img_dist: Tensor = None
    obj_dist: Tensor = None
    phi_angle: Tensor = None
    theta_angle: Tensor = None


@dataclasses.dataclass
class BVH:
    node_min: Tensor
    node_max: Tensor
    node_left: Tensor
    node_right: Tensor
    prim_order: Tensor


@dataclasses.dataclass
class Instances:
    """Per-instance rows of an instanced / animated scene: the shutter-begin
    and shutter-end TRS decomposition of each instance's world transform
    and its motion bounds. Instanced triangles live at the tail of Geometry
    in local space; `FlatScene.n_static` is where that tail begins.

    The reference's TLAS / BLAS node arena (its lock-step two-level
    traversal) has no counterpart here: the port's casts all go through
    the chunk kernels."""

    t0_T: Tensor             # (I, 3) translation at shutter begin
    t0_R: Tensor             # (I, 4) rotation quaternion [x, y, z, w]
    t0_S: Tensor             # (I, 3) scale
    t1_T: Tensor             # ... at shutter end
    t1_R: Tensor
    t1_S: Tensor
    inst_bmin: Tensor        # (I, 3) motion bounds
    inst_bmax: Tensor

    @property
    def num(self) -> int:
        return self.t0_T.shape[0]


@dataclasses.dataclass
class FlatScene:
    """The complete device-side scene. `pallas_tris` holds the traversal
    kernels' chunk tables (accel/traverse.py PallasTris), over the static
    triangles [0, n_static) and, for a scene with `instances`, the
    (instance, chunk) entries of the local-space tail; `bvh` is the static
    triangles' SBVH the chunks were cut from (None for Morton tables), and
    `plucker` stays None (the port has no Plücker-matmul path)."""

    geometry: Geometry
    materials: Materials
    stex: SpectrumTextures
    ftex: FloatTextures
    lights: Lights
    env: EnvLight
    camera: Camera
    bvh: Optional[BVH] = None
    plucker: Optional[Any] = None
    pallas_tris: Optional[Any] = None
    ntex: Optional[NormalTextures] = None
    instances: Optional[Instances] = None
    n_static: int = -1
    lobe_kinds_present: Optional[tuple] = None
    has_env: bool = False
    has_normal_map: bool = False
    has_alpha: bool = False
    super_boxes_blob: Optional[bytes] = None
    world_center: Tensor = None
    world_radius: Tensor = None

    @property
    def device(self) -> torch.device:
        return self.geometry.positions.device

    def to(self, device) -> "FlatScene":
        return to_device(self, torch.device(device))


def to_device(obj, device: torch.device):
    """Copy every tensor of a (nested) scene table to `device`."""
    if isinstance(obj, Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(v, device) for v in obj))
    return obj
