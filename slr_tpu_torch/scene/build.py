"""Host-side scene builder: authoring calls -> FlatScene tensors
(counterpart of slr_tpu/scene/build.py).

Constant, tabulated, checker, voronoi and image spectra; constant,
checker, image, voronoi and one-minus float textures; image and checker
normal maps; every material kind (matte and Oren-Nayar, inverse, metal,
glass, the microfacet pair, Ward, Ashikhmin, mixed, summed, emitter);
triangle meshes with baked static transforms, alpha cutouts and normal
maps; shared BLASes with static or animated instances (motion blur); the
perspective and equirectangular cameras and the environment light with its
importance map. Images are stacked into one padded (NI, Hmax, Wmax, 4)
atlas, as the reference lays them out. The chunk tables are cut from an
SBVH over the static triangles (`use_bvh=True`, the default, as in the
reference) or sliced in Morton order (`use_bvh=False`). All arrays are
built with numpy on the host and become CPU tensors; `FlatScene.to` moves
them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.sampling import build_continuous_2d, build_discrete_1d
from .types import (
    Camera,
    CameraKind,
    EnvLight,
    FlatScene,
    FloatTextures,
    FTexKind,
    Geometry,
    Lights,
    LobeKind,
    Materials,
    MAX_LOBES,
    NormalTextures,
    STexKind,
    SpectrumTextures,
)


@dataclasses.dataclass
class _STex:
    kind: int
    value: np.ndarray          # (S,) RGB, or (3,) Meng-Simon uvs in spectral mode
    value2: np.ndarray
    image_id: int = -1
    map_scale: tuple = (1.0, 1.0)
    map_offset: tuple = (0.0, 0.0)
    curve_id: int = -1


@dataclasses.dataclass
class _FTex:
    kind: int
    value: float = 0.0
    value2: float = 0.0
    image_id: int = -1
    map_scale: tuple = (1.0, 1.0)
    map_offset: tuple = (0.0, 0.0)


@dataclasses.dataclass
class _Lobe:
    kind: int
    stex: tuple = (-1, -1, -1)
    ftex: tuple = (-1, -1)
    wtex: int = -1


@dataclasses.dataclass
class _Material:
    lobes: list
    emit_stex: int = -1


def _t(a, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=dtype))


class SceneBuilder:
    """Accumulates host-side scene data, then `build()`s the FlatScene."""

    def __init__(self, spectral_dim: int = 3, spectral: bool = False):
        self.spectral = spectral
        self.s = 3 if spectral else spectral_dim
        self.curves: list[tuple[np.ndarray, np.ndarray]] = []
        self.stex: list[_STex] = []
        self.ftex: list[_FTex] = []
        self.images: list[np.ndarray] = []
        self.ntex: list[dict] = []
        self.materials: list[_Material] = []
        self.positions: list[np.ndarray] = []
        self.normals: list[np.ndarray] = []
        self.tangents: list[np.ndarray] = []
        self.uvs: list[np.ndarray] = []
        self.tri_vidx: list[np.ndarray] = []
        self.tri_mat: list[np.ndarray] = []
        self.tri_alpha: list[np.ndarray] = []
        self.tri_ntex: list[np.ndarray] = []
        self._nverts = 0
        # Instancing: recorded BLASes (local-space mesh lists) and the
        # instance rows (blas_id, matrix at shutter begin, ... at shutter end).
        self._blas: list[dict] = []
        self._cur_blas: Optional[dict] = None
        self.instance_rows: list[tuple[int, np.ndarray, np.ndarray]] = []
        self.camera: Optional[Camera] = None
        self.env_stex: int = -1
        self.env_scale: float = 1.0

    # -- textures -----------------------------------------------------------
    def _spec(self, v, illuminant: bool = False) -> np.ndarray:
        a = np.asarray(v, np.float32).reshape(-1)
        if a.size == 1:
            a = np.full((3,), a[0], np.float32)
        if a.size != self.s:
            raise ValueError(f"expected spectrum dim {self.s}, got {a.size}")
        if self.spectral:
            return self._rgb_to_uvs(a, illuminant)
        return a

    @staticmethod
    def _rgb_to_uvs(rgb: np.ndarray, illuminant: bool) -> np.ndarray:
        """Host-side sRGB -> Meng-Simon (u, v, scale), with reflectances
        normalized so (1,1,1) evaluates to a flat spectrum of 1."""
        from ..spectrum.spectral import _sRGB_E_to_XYZ, _sRGB_to_XYZ, upsampling_tables

        m = _sRGB_to_XYZ if illuminant else _sRGB_E_to_XYZ
        xyz = m @ rgb.astype(np.float32)
        b = float(xyz.sum())
        if b == 0:
            xy = np.array([1 / 3, 1 / 3], np.float32)
        else:
            xy = (xyz[:2] / b).astype(np.float32)
        u = 16.730260708356887 * xy[0] + 7.7801960340706 * xy[1] - 2.170152247475828
        v = -7.530081094743006 * xy[0] + 16.192422314095225 * xy[1] + 1.1125529268825947
        scale = b if illuminant else b / upsampling_tables()["eer"]
        return np.array([u, v, scale], np.float32)

    def add_stex_const(self, value, illuminant: bool = False) -> int:
        self.stex.append(_STex(STexKind.CONST, self._spec(value, illuminant),
                               np.zeros(self.s, np.float32)))
        return len(self.stex) - 1

    def add_curve(self, wls, values) -> int:
        """Register a tabulated SPD (wavelengths in nm, ascending)."""
        self.curves.append((np.asarray(wls, np.float32),
                            np.asarray(values, np.float32)))
        return len(self.curves) - 1

    def add_stex_curve(self, curve_id: int, scale: float = 1.0) -> int:
        v = np.zeros(self.s, np.float32)
        v[0] = scale
        self.stex.append(_STex(STexKind.CURVE, v, np.zeros(self.s, np.float32),
                               curve_id=curve_id))
        return len(self.stex) - 1

    def add_stex_d65(self, scale: float = 1.0) -> int:
        from ..spectrum.spectral import _raw

        d = _raw("cie.npz")
        wls = np.linspace(300.0, 830.0, d["d65"].shape[0])
        return self.add_stex_curve(self.add_curve(wls, d["d65"]), scale)

    def add_stex_ior(self, name: str, component: int = 0,
                     scale: float = 1.0) -> int:
        """Measured eta (component 0) or k (component 1) curve."""
        from ..spectrum.spectral import ior_spectrum

        lambdas, etas, ks = ior_spectrum(name)
        vals = etas if component == 0 else ks
        return self.add_stex_curve(self.add_curve(lambdas, vals), scale)

    def add_stex_colorchecker(self, patch: int, scale: float = 1.0) -> int:
        from ..spectrum.spectral import _raw

        wls = np.linspace(380.0, 730.0, 36)
        return self.add_stex_curve(
            self.add_curve(wls, _raw("cie.npz")["colorchecker"][patch]), scale)

    def add_stex_checker(self, v0, v1, map_scale=(1, 1),
                         map_offset=(0, 0)) -> int:
        self.stex.append(_STex(STexKind.CHECKER, self._spec(v0),
                               self._spec(v1), map_scale=tuple(map_scale),
                               map_offset=tuple(map_offset)))
        return len(self.stex) - 1

    def add_stex_voronoi(self, scale: float, brightness: float = 0.8) -> int:
        v = np.zeros(self.s, np.float32)
        v[0] = scale
        v2 = np.zeros(self.s, np.float32)
        v2[0] = brightness
        self.stex.append(_STex(STexKind.VORONOI, v, v2))
        return len(self.stex) - 1

    def add_image(self, img: np.ndarray) -> int:
        """img: (H, W, 3 | 4) float32 linear."""
        img = np.asarray(img, np.float32)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        self.images.append(img)
        return len(self.images) - 1

    def add_stex_image(self, image_id: int, scale=1.0, map_scale=(1, 1),
                       map_offset=(0, 0)) -> int:
        self.stex.append(_STex(STexKind.IMAGE, self._spec(scale),
                               np.zeros(self.s, np.float32),
                               image_id=image_id, map_scale=tuple(map_scale),
                               map_offset=tuple(map_offset)))
        return len(self.stex) - 1

    def add_ntex_image(self, image_id: int, map_scale=(1, 1),
                       map_offset=(0, 0)) -> int:
        self.ntex.append({
            "kind": 0, "image_id": image_id, "step_width": 1.0,
            "reverse": 0.0, "map_scale": tuple(map_scale),
            "map_offset": tuple(map_offset)})
        return len(self.ntex) - 1

    def add_ntex_checker(self, step_width: float = 0.05,
                         reverse: bool = False, map_scale=(1, 1),
                         map_offset=(0, 0)) -> int:
        self.ntex.append({
            "kind": 1, "image_id": -1, "step_width": float(step_width),
            "reverse": 1.0 if reverse else 0.0,
            "map_scale": tuple(map_scale), "map_offset": tuple(map_offset)})
        return len(self.ntex) - 1

    def add_ftex_const(self, value: float) -> int:
        self.ftex.append(_FTex(FTexKind.CONST, float(value)))
        return len(self.ftex) - 1

    def add_ftex_checker(self, v0: float, v1: float, map_scale=(1, 1),
                         map_offset=(0, 0)) -> int:
        self.ftex.append(_FTex(FTexKind.CHECKER, float(v0), float(v1),
                               map_scale=tuple(map_scale),
                               map_offset=tuple(map_offset)))
        return len(self.ftex) - 1

    def add_ftex_image(self, image_id: int, channel: str = "lum",
                       scale: float = 1.0, map_scale=(1, 1),
                       map_offset=(0, 0)) -> int:
        """An image's luminance, or its alpha (channel 'alpha'), x scale."""
        chan = 3.0 if channel == "alpha" else 0.0
        self.ftex.append(_FTex(FTexKind.IMAGE, float(scale), chan,
                               image_id=image_id, map_scale=tuple(map_scale),
                               map_offset=tuple(map_offset)))
        return len(self.ftex) - 1

    def add_ftex_voronoi(self, scale: float, value_scale: float = 1.0) -> int:
        """A random value in [0, value_scale) per cell of size `scale`."""
        self.ftex.append(_FTex(FTexKind.VORONOI, float(value_scale),
                               float(scale)))
        return len(self.ftex) - 1

    def add_ftex_one_minus(self, src_ftex: int) -> int:
        """1 - src (the second arm of a mixed material)."""
        self.ftex.append(_FTex(FTexKind.ONE_MINUS, image_id=src_ftex))
        return len(self.ftex) - 1

    # -- materials ----------------------------------------------------------
    def _add_material(self, lobes: list, emit_stex: int = -1) -> int:
        if len(lobes) > MAX_LOBES:
            raise ValueError(f"a material holds at most {MAX_LOBES} lobes")
        self.materials.append(_Material(lobes=lobes, emit_stex=emit_stex))
        return len(self.materials) - 1

    def add_matte(self, reflectance_stex: int, sigma_ftex: int = -1) -> int:
        """Lambert, or Oren-Nayar with roughness `sigma_ftex`."""
        if sigma_ftex >= 0:
            lobe = _Lobe(LobeKind.OREN_NAYAR, (reflectance_stex, -1, -1),
                         (sigma_ftex, -1))
        else:
            lobe = _Lobe(LobeKind.LAMBERT, (reflectance_stex, -1, -1))
        return self._add_material([lobe])

    def add_inverse(self, base_mat: int) -> int:
        """The base material scattering into the opposite hemisphere
        (diffuse bases: the two-sided sum(matte, inverse(matte)) idiom)."""
        flip = {int(LobeKind.LAMBERT): LobeKind.FLIPPED_LAMBERT,
                int(LobeKind.OREN_NAYAR): LobeKind.FLIPPED_LAMBERT}
        lobes = []
        for lb in self.materials[base_mat].lobes:
            if int(lb.kind) not in flip:
                raise NotImplementedError(
                    f"inverse of lobe kind {LobeKind(lb.kind).name} is not "
                    "supported")
            lobes.append(dataclasses.replace(lb, kind=flip[int(lb.kind)]))
        return self._add_material(lobes)

    def add_metal(self, coeff_stex: int, eta_stex: int, k_stex: int) -> int:
        return self._add_material(
            [_Lobe(LobeKind.SPECULAR_REFLECTION, (coeff_stex, eta_stex, k_stex))])

    def add_glass(self, coeff_stex: int, eta_ext_stex: int,
                  eta_int_stex: int) -> int:
        return self._add_material(
            [_Lobe(LobeKind.SPECULAR_SCATTERING,
                   (coeff_stex, eta_ext_stex, eta_int_stex))])

    def add_microfacet_metal(self, eta_stex: int, k_stex: int,
                             alpha_ftex: int) -> int:
        return self._add_material(
            [_Lobe(LobeKind.MICROFACET_REFLECTION, (-1, eta_stex, k_stex),
                   (alpha_ftex, -1))])

    def add_microfacet_glass(self, eta_ext_stex: int, eta_int_stex: int,
                             alpha_ftex: int) -> int:
        return self._add_material(
            [_Lobe(LobeKind.MICROFACET_SCATTERING,
                   (-1, eta_ext_stex, eta_int_stex), (alpha_ftex, -1))])

    def add_ward(self, reflectance_stex: int, ax_ftex: int,
                 ay_ftex: int) -> int:
        return self._add_material(
            [_Lobe(LobeKind.WARD, (reflectance_stex, -1, -1),
                   (ax_ftex, ay_ftex))])

    def add_ashikhmin(self, rs_stex: int, rd_stex: int, nu_ftex: int,
                      nv_ftex: int) -> int:
        return self._add_material(
            [_Lobe(LobeKind.ASHIKHMIN, (rs_stex, rd_stex, -1),
                   (nu_ftex, nv_ftex))])

    def add_mixed(self, mat0: int, mat1: int, ratio_ftex: int) -> int:
        """mat0 x ratio + mat1 x (1 - ratio): a constant ratio's complement
        folds at build time, any other evaluates as 1 - ratio(uv)."""
        lobes = [dataclasses.replace(lb, wtex=ratio_ftex)
                 for lb in self.materials[mat0].lobes]
        src = self.ftex[ratio_ftex]
        if src.kind == FTexKind.CONST:
            inv = self.add_ftex_const(1.0 - src.value)
        else:
            inv = self.add_ftex_one_minus(ratio_ftex)
        lobes += [dataclasses.replace(lb, wtex=inv)
                  for lb in self.materials[mat1].lobes]
        return self._add_material(lobes)

    def add_summed(self, mat0: int, mat1: int) -> int:
        m0 = self.materials[mat0]
        m1 = self.materials[mat1]
        emit = max(m0.emit_stex, m1.emit_stex)
        return self._add_material(list(m0.lobes) + list(m1.lobes),
                                  emit_stex=emit)

    def add_emitter(self, scatter_mat: int, emit_stex: int) -> int:
        """Scattering material + emitter property."""
        m = self.materials[scatter_mat]
        return self._add_material(list(m.lobes), emit_stex=emit_stex)

    # -- geometry -----------------------------------------------------------
    def add_mesh(self, positions, normals, tangents, uvs, tri_vidx, mat_id,
                 transform: Optional[np.ndarray] = None, alpha_ftex: int = -1,
                 normal_ntex: int = -1) -> None:
        """Append a triangle mesh; bakes `transform` (4x4) into the vertices.
        `alpha_ftex` cuts the surface out where it evaluates to 0;
        `normal_ntex` perturbs its shading frame."""
        positions = np.asarray(positions, np.float32).reshape(-1, 3)
        normals = np.asarray(normals, np.float32).reshape(-1, 3)
        tangents = np.asarray(tangents, np.float32).reshape(-1, 3)
        uvs = np.asarray(uvs, np.float32).reshape(-1, 2)
        tri_vidx = np.asarray(tri_vidx, np.int32).reshape(-1, 3)
        if transform is not None:
            m = np.asarray(transform, np.float32)
            positions = positions @ m[:3, :3].T + m[:3, 3]
            inv = np.linalg.inv(m[:3, :3])
            normals = normals @ inv
            norms = np.linalg.norm(normals, axis=-1, keepdims=True)
            normals = normals / np.maximum(norms, 1e-20)
            tangents = tangents @ m[:3, :3].T
            tnorms = np.linalg.norm(tangents, axis=-1, keepdims=True)
            tangents = tangents / np.maximum(tnorms, 1e-20)
        n_tris = tri_vidx.shape[0]
        mat = np.broadcast_to(np.asarray(mat_id, np.int32), (n_tris,))
        if self._cur_blas is not None:
            b = self._cur_blas
            b["positions"].append(positions)
            b["normals"].append(normals)
            b["tangents"].append(tangents)
            b["uvs"].append(uvs)
            b["tri_vidx"].append(tri_vidx + b["nverts"])
            b["tri_mat"].append(mat.copy())
            b["tri_alpha"].append(np.full((n_tris,), alpha_ftex, np.int32))
            b["tri_ntex"].append(np.full((n_tris,), normal_ntex, np.int32))
            b["nverts"] += positions.shape[0]
            return
        self.positions.append(positions)
        self.normals.append(normals)
        self.tangents.append(tangents)
        self.uvs.append(uvs)
        self.tri_vidx.append(tri_vidx + self._nverts)
        self.tri_mat.append(mat.copy())
        self.tri_alpha.append(np.full((n_tris,), alpha_ftex, np.int32))
        self.tri_ntex.append(np.full((n_tris,), normal_ntex, np.int32))
        self._nverts += positions.shape[0]

    # -- instancing / motion blur -------------------------------------------
    def begin_blas(self) -> int:
        """Start recording a shared BLAS: `add_mesh` calls append local-space
        geometry to it until `end_blas()`. Returns its id."""
        if self._cur_blas is not None:
            raise ValueError("nested BLAS recording")
        self._cur_blas = {
            "positions": [], "normals": [], "tangents": [], "uvs": [],
            "tri_vidx": [], "tri_mat": [], "tri_alpha": [], "tri_ntex": [],
            "nverts": 0,
        }
        self._blas.append(self._cur_blas)
        return len(self._blas) - 1

    def end_blas(self) -> None:
        if self._cur_blas is None or not self._cur_blas["positions"]:
            raise ValueError("no BLAS is being recorded, or it is empty")
        self._cur_blas = None

    def add_instance(self, blas_id: int, m_begin: np.ndarray,
                     m_end: Optional[np.ndarray] = None) -> None:
        """Instance a recorded BLAS with world transforms at the shutter's
        two ends (equal, or m_end=None, for a static instance)."""
        m0 = np.asarray(m_begin, np.float32)
        m1 = m0 if m_end is None else np.asarray(m_end, np.float32)
        self.instance_rows.append((blas_id, m0, m1))

    # -- camera -------------------------------------------------------------
    def set_camera_perspective(self, to_world, aspect: float, fovy: float,
                               lens_radius: float = 0.0, img_dist: float = 1.0,
                               obj_dist: float = 1.0) -> None:
        f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
        self.camera = Camera(
            kind=CameraKind.PERSPECTIVE,
            to_world=_t(to_world, np.float32),
            aspect=f(aspect), fovy=f(fovy), lens_radius=f(lens_radius),
            img_dist=f(img_dist), obj_dist=f(obj_dist),
            phi_angle=f(2 * np.pi), theta_angle=f(np.pi),
        )

    def set_camera_equirect(self, to_world, phi_angle: float = 2 * np.pi,
                            theta_angle: float = np.pi) -> None:
        """Latitude-longitude camera over phi_angle x theta_angle."""
        f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
        self.camera = Camera(
            kind=CameraKind.EQUIRECTANGULAR,
            to_world=_t(to_world, np.float32),
            aspect=f(1.0), fovy=f(1.0), lens_radius=f(0.0), img_dist=f(1.0),
            obj_dist=f(1.0), phi_angle=f(phi_angle),
            theta_angle=f(theta_angle),
        )

    def set_environment(self, stex_id: int, scale: float = 1.0) -> None:
        self.env_stex = stex_id
        self.env_scale = float(scale)

    # -- build --------------------------------------------------------------
    def build(self, use_bvh: bool = True,
              flatten_static_instances: bool = True,
              flatten_budget: int = 4_000_000,
              two_level: bool = False) -> FlatScene:
        """The scene's tables. `two_level` gives an instanced scene's
        `instances` the TLAS / BLAS node arena as well
        (accel/instances.py `TwoLevel`), which only the two-level oracle
        `accel/twolevel.py` `intersect_instances` reads."""
        from ..accel.intersect import build_tri_table
        from ..accel.traverse import (
            build_pallas_tris,
            build_super_boxes,
            extend_pallas_instanced,
        )
        from ..spectrum.spectral import WL_HI, WL_LO, upsample_tabulate_host

        s = self.s
        if self.camera is None:
            self.set_camera_perspective(np.eye(4, dtype=np.float32), 1.0, 0.52)
        if not self.positions and not self._blas:
            raise ValueError("scene has no geometry")
        if self._cur_blas is not None:
            raise ValueError("unterminated BLAS recording")
        if self._blas and not self.instance_rows:
            raise ValueError("BLAS recorded but no instances added")

        # Local copies: build() never mutates the recorded lists.
        static = {k: list(getattr(self, k)) for k in (
            "positions", "normals", "tangents", "uvs", "tri_vidx", "tri_mat",
            "tri_alpha", "tri_ntex")}
        nverts = self._nverts
        inst_rows = list(self.instance_rows)

        # Static-instance flattening: instances whose shutter-begin and
        # shutter-end transforms agree are baked into world-space static
        # geometry, so they ride the static chunks instead of one worklist
        # entry per instance; only animated instances stay instanced.
        if flatten_static_instances and inst_rows:
            n_flat = sum(
                sum(t.shape[0] for t in self._blas[bid]["tri_vidx"])
                for bid, m0, m1 in inst_rows if np.array_equal(m0, m1))
            if n_flat <= flatten_budget:
                blas_cat: dict[int, tuple] = {}
                kept = []
                for bid, m0, m1 in inst_rows:
                    if not np.array_equal(m0, m1):
                        kept.append((bid, m0, m1))
                        continue
                    if bid not in blas_cat:
                        b = self._blas[bid]
                        blas_cat[bid] = tuple(
                            np.concatenate(b[k]) for k in (
                                "positions", "normals", "tangents", "uvs",
                                "tri_vidx", "tri_mat", "tri_alpha",
                                "tri_ntex"))
                    bp, bn, bt, bu, bv, bm, ba, bx = blas_cat[bid]
                    lin = m0[:3, :3]
                    p = bp @ lin.T + m0[:3, 3]
                    nn = bn @ np.linalg.inv(lin)  # inverse transpose
                    nn = nn / np.maximum(
                        np.linalg.norm(nn, axis=-1, keepdims=True), 1e-20)
                    tt = bt @ lin.T
                    tt = tt / np.maximum(
                        np.linalg.norm(tt, axis=-1, keepdims=True), 1e-20)
                    static["positions"].append(p.astype(np.float32))
                    static["normals"].append(nn.astype(np.float32))
                    static["tangents"].append(tt.astype(np.float32))
                    static["uvs"].append(bu)
                    static["tri_vidx"].append(bv + nverts)
                    static["tri_mat"].append(bm)
                    static["tri_alpha"].append(ba)
                    static["tri_ntex"].append(bx)
                    nverts += p.shape[0]
                inst_rows = kept

        if not static["positions"]:
            # Fully instanced scene: keep a degenerate, never-hit static
            # triangle so the static prefix and its chunk table stay valid.
            static["positions"].append(np.full((3, 3), 1e30, np.float32))
            static["normals"].append(np.tile(np.float32([0, 1, 0]), (3, 1)))
            static["tangents"].append(np.tile(np.float32([1, 0, 0]), (3, 1)))
            static["uvs"].append(np.zeros((3, 2), np.float32))
            static["tri_vidx"].append(
                np.asarray([[0, 1, 2]], np.int32) + nverts)
            static["tri_mat"].append(np.zeros((1,), np.int32))
            static["tri_alpha"].append(np.full((1,), -1, np.int32))
            static["tri_ntex"].append(np.full((1,), -1, np.int32))
            nverts += 3
        positions = np.concatenate(static["positions"])
        normals = np.concatenate(static["normals"])
        tangents = np.concatenate(static["tangents"])
        uvs = np.concatenate(static["uvs"])
        tri_vidx = np.concatenate(static["tri_vidx"])
        tri_mat = np.concatenate(static["tri_mat"])
        tri_alpha = np.concatenate(static["tri_alpha"])
        tri_ntex = np.concatenate(static["tri_ntex"])
        n_static = tri_vidx.shape[0]

        # BLAS geometry (local space) goes after the static prefix; the
        # static chunk table covers [0, n_static) only. Skipped when
        # flattening left no live instance.
        blas_ranges: list[tuple[int, int]] = []
        if self._blas and inst_rows:
            voff = positions.shape[0]
            toff = n_static
            parts: dict[str, list] = {k: [] for k in static}
            for b in self._blas:
                bp = np.concatenate(b["positions"])
                bt = np.concatenate(b["tri_vidx"])
                parts["positions"].append(bp)
                parts["tri_vidx"].append(bt + voff)
                for k in ("normals", "tangents", "uvs", "tri_mat",
                          "tri_alpha", "tri_ntex"):
                    parts[k].append(np.concatenate(b[k]))
                blas_ranges.append((toff, toff + bt.shape[0]))
                voff += bp.shape[0]
                toff += bt.shape[0]
            positions = np.concatenate([positions, *parts["positions"]])
            normals = np.concatenate([normals, *parts["normals"]])
            tangents = np.concatenate([tangents, *parts["tangents"]])
            uvs = np.concatenate([uvs, *parts["uvs"]])
            tri_vidx = np.concatenate([tri_vidx, *parts["tri_vidx"]])
            tri_mat = np.concatenate([tri_mat, *parts["tri_mat"]])
            tri_alpha = np.concatenate([tri_alpha, *parts["tri_alpha"]])
            tri_ntex = np.concatenate([tri_ntex, *parts["tri_ntex"]])

        geom = Geometry(
            positions=_t(positions), normals=_t(normals),
            tangents=_t(tangents), uvs=_t(uvs), tri_vidx=_t(tri_vidx),
            tri_mat=_t(tri_mat), tri_alpha=_t(tri_alpha),
            tri_ntex=_t(tri_ntex),
            tri_table=_t(build_tri_table(positions, normals, tangents, uvs,
                                         tri_vidx, tri_mat, tri_alpha,
                                         tri_ntex)),
        )

        # Material SoA, as wide as the scene's largest lobe count.
        m = len(self.materials)
        l_max = max(max((len(mat.lobes) for mat in self.materials), default=1), 1)
        lobe_kind = np.zeros((m, l_max), np.int32)
        lobe_stex = np.full((m, l_max, 3), -1, np.int32)
        lobe_ftex = np.full((m, l_max, 2), -1, np.int32)
        lobe_wtex = np.full((m, l_max), -1, np.int32)
        emit_stex = np.full((m,), -1, np.int32)
        for i, mat in enumerate(self.materials):
            for j, lb in enumerate(mat.lobes):
                lobe_kind[i, j] = lb.kind
                lobe_stex[i, j] = lb.stex
                lobe_ftex[i, j] = lb.ftex
                lobe_wtex[i, j] = lb.wtex
            emit_stex[i] = mat.emit_stex
        materials = Materials(lobe_kind=_t(lobe_kind), lobe_stex=_t(lobe_stex),
                              lobe_ftex=_t(lobe_ftex), lobe_wtex=_t(lobe_wtex),
                              emit_stex=_t(emit_stex))
        lobe_kinds_present = tuple(sorted(
            int(k) for k in np.unique(lobe_kind) if k != int(LobeKind.NONE)))

        stexs = self.stex or [_STex(STexKind.CONST, np.zeros(s, np.float32),
                                    np.zeros(s, np.float32))]
        ftexs = self.ftex or [_FTex(FTexKind.CONST)]
        if self.images:
            hmax = max(im.shape[0] for im in self.images)
            wmax = max(im.shape[1] for im in self.images)
            atlas = np.zeros((len(self.images), hmax, wmax, 4), np.float32)
            image_hw = np.zeros((len(self.images), 2), np.int32)
            for i, im in enumerate(self.images):
                atlas[i, :im.shape[0], :im.shape[1]] = im
                image_hw[i] = (im.shape[0], im.shape[1])
        else:
            atlas = np.zeros((0, 1, 1, 4), np.float32)
            image_hw = np.zeros((0, 2), np.int32)
        if self.spectral:
            # Pre-tabulate constant spectra into per-nm curves (exact: the
            # Meng-Simon basis is piecewise linear with 5 nm knots), so the
            # render never evaluates the upsampling grid.
            grid = np.linspace(WL_LO, WL_HI, int(round(WL_HI - WL_LO)) + 1)
            for st in stexs:
                if st.kind == STexKind.CONST:
                    vals = upsample_tabulate_host(
                        float(st.value[0]), float(st.value[1]),
                        float(st.value[2]), grid)
                    st.kind = STexKind.CURVE
                    st.curve_id = self.add_curve(grid, vals)
                    st.value = np.zeros_like(st.value)
                    st.value[0] = 1.0

        if self.curves:
            # Regular per-nm resampling over [WL_LO, WL_HI]: linear inside
            # each curve's native domain, zero outside it.
            grid_n = int(round(WL_HI - WL_LO)) + 1
            grid = np.linspace(WL_LO, WL_HI, grid_n)
            curves_wl = np.zeros((len(self.curves), 2), np.float32)
            curves_v = np.zeros((len(self.curves), grid_n), np.float32)
            for i, (wl, v) in enumerate(self.curves):
                curves_wl[i] = (wl[0], wl[-1])
                vals = np.interp(grid, wl, v)
                vals[(grid < wl[0]) | (grid > wl[-1])] = 0.0
                curves_v[i] = vals
        else:
            curves_wl = np.zeros((0, 2), np.float32)
            curves_v = np.zeros((0, 1), np.float32)
        stex = SpectrumTextures(
            kind=_t([t.kind for t in stexs], np.int32),
            value=_t(np.stack([t.value for t in stexs])),
            value2=_t(np.stack([t.value2 for t in stexs])),
            image_id=_t([t.image_id for t in stexs], np.int32),
            map_scale=_t([t.map_scale for t in stexs], np.float32),
            map_offset=_t([t.map_offset for t in stexs], np.float32),
            images=_t(atlas), image_hw=_t(image_hw),
            curve_id=_t([t.curve_id for t in stexs], np.int32),
            curves_wl=_t(curves_wl), curves_v=_t(curves_v),
            spectral=self.spectral,
            # A float checker sets the flag too, as in the reference.
            has_checker=(any(t.kind == STexKind.CHECKER for t in stexs)
                         or any(t.kind == FTexKind.CHECKER for t in ftexs)),
            has_voronoi=any(t.kind == STexKind.VORONOI for t in stexs),
            has_curve=any(t.kind == STexKind.CURVE for t in stexs),
            has_const=any(t.kind == STexKind.CONST for t in stexs),
        )
        ftex = FloatTextures(
            kind=_t([t.kind for t in ftexs], np.int32),
            value=_t([t.value for t in ftexs], np.float32),
            value2=_t([t.value2 for t in ftexs], np.float32),
            image_id=_t([t.image_id for t in ftexs], np.int32),
            map_scale=_t([t.map_scale for t in ftexs], np.float32),
            map_offset=_t([t.map_offset for t in ftexs], np.float32),
            has_image=any(t.kind == FTexKind.IMAGE for t in ftexs),
            has_voronoi=any(t.kind == FTexKind.VORONOI for t in ftexs),
            has_one_minus=any(t.kind == FTexKind.ONE_MINUS for t in ftexs),
        )

        # Every emissive triangle of the static prefix is one light of
        # importance 1; the environment, when present, is one more. An emissive material in the instanced tail would be
        # invisible to light sampling while its implicit hits were still
        # MIS-weighted against a light pdf that is never realized: a silent
        # energy bias, so it is refused.
        emissive = emit_stex[tri_mat[:n_static]] >= 0
        if tri_mat.shape[0] > n_static:
            tail_emissive = emit_stex[tri_mat[n_static:]] >= 0
            if tail_emissive.any():
                bad = np.unique(tri_mat[n_static:][tail_emissive])
                raise ValueError(
                    f"emissive material(s) {bad.tolist()} are referenced by "
                    "instanced/animated geometry; lights on instances are "
                    "not samplable (the light table covers the static "
                    "prefix only) and would render biased. Keep emissive "
                    "subtrees static.")
        light_tris = np.nonzero(emissive)[0].astype(np.int32)
        n_area = len(light_tris)
        if n_area == 0:
            light_tris = np.zeros((1,), np.int32)
        env_imp = 1.0 if self.env_stex >= 0 else 0.0
        lights = Lights(
            tri_idx=_t(light_tris),
            dist=build_discrete_1d(torch.ones(max(n_area, 1))),
            env_prob=torch.tensor(env_imp / max(env_imp + n_area, 1.0),
                                  dtype=torch.float32),
        )
        # The environment's importance map: luminance x sin(theta) of an
        # image environment, else flat.
        if (self.env_stex >= 0
                and self.stex[self.env_stex].kind == STexKind.IMAGE):
            img = self.images[self.stex[self.env_stex].image_id]
            lum = (0.222485 * img[..., 0] + 0.716905 * img[..., 1]
                   + 0.060610 * img[..., 2])
            h = img.shape[0]
            sin_t = np.sin(np.pi * (np.arange(h) + 0.5) / h)
            env_dist = build_continuous_2d(
                torch.as_tensor(lum * sin_t[:, None], dtype=torch.float32))
        else:
            env_dist = build_continuous_2d(torch.ones((4, 8)))
        env = EnvLight(stex=torch.tensor(self.env_stex, dtype=torch.int32),
                       dist=env_dist,
                       scale=torch.tensor(self.env_scale,
                                          dtype=torch.float32))

        instances = None
        if inst_rows:
            from ..accel.instances import build_instances, build_two_level

            instances = (build_two_level if two_level else build_instances)(
                positions, tri_vidx, blas_ranges, inst_rows)

        # World bounding sphere: the static geometry (without the never-hit
        # triangle at 1e30) plus the instances' motion bounds.
        verts = positions[tri_vidx[:n_static].reshape(-1)]
        verts = verts[np.abs(verts).max(axis=1) < 1e29]
        bounds = []
        if len(verts):
            bounds.append((verts.min(axis=0), verts.max(axis=0)))
        if instances is not None:
            bounds.append((instances.inst_bmin.numpy().min(axis=0),
                           instances.inst_bmax.numpy().max(axis=0)))
        lo = np.min([b[0] for b in bounds], axis=0)
        hi = np.max([b[1] for b in bounds], axis=0)
        center = 0.5 * (lo + hi)
        radius = float(np.linalg.norm(hi - center)) + 1e-3

        # Chunk tables over the static prefix, cut from its SBVH when
        # `use_bvh`; with instances, the BLAS chunks and one entry per
        # (instance, BLAS chunk) follow, so one traversal covers the whole
        # two-level scene.
        bvh = None
        if use_bvh:
            from ..accel.lbvh import build_bvh

            bvh = build_bvh(positions, tri_vidx[:n_static])
        pallas_tris = build_pallas_tris(dataclasses.replace(
            geom, tri_vidx=_t(tri_vidx[:n_static])), bvh=bvh)
        if instances is not None:
            pallas_tris = extend_pallas_instanced(
                pallas_tris, positions, tri_vidx, blas_ranges, inst_rows)
        nts = self.ntex or [{
            "kind": 0, "image_id": -1, "step_width": 1.0, "reverse": 0.0,
            "map_scale": (1.0, 1.0), "map_offset": (0.0, 0.0)}]
        ntex_table = NormalTextures(**{
            k: _t([t[k] for t in nts],
                  np.int32 if k in ("kind", "image_id") else np.float32)
            for k in ("kind", "image_id", "step_width", "reverse",
                      "map_scale", "map_offset")})
        return FlatScene(
            geometry=geom, materials=materials, stex=stex, ftex=ftex,
            lights=lights, env=env, camera=self.camera, bvh=bvh,
            pallas_tris=pallas_tris, ntex=ntex_table, instances=instances,
            n_static=n_static,
            lobe_kinds_present=lobe_kinds_present,
            has_env=self.env_stex >= 0,
            has_normal_map=bool((tri_ntex >= 0).any()),
            has_alpha=bool((tri_alpha >= 0).any()),
            world_center=_t(center),
            world_radius=torch.tensor(radius, dtype=torch.float32),
            super_boxes_blob=np.asarray(
                build_super_boxes(pallas_tris.boxes.numpy()),
                np.float32).tobytes(),
        )
