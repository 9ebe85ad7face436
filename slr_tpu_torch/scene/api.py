"""The scene-description API: the builtin functions of the SLR scene
language (counterpart of slr_tpu/scene/api.py).

Math, transforms, textures, the `Spectrum` overloads, materials, meshes,
nodes, camera, renderer and settings, plus `read_scene` and `load_scene`.
Builtins build the authoring graph (scene/graph.py); `load_scene` returns
the flattened FlatScene with the renderer config and the render settings.
Transforms are float32 4x4 numpy matrices made by core/math3d.py.

Image files are read by the port's own PNG decoder and EXR reader
(utils/png.py, utils/exr.py); a missing or undecodable image gets a
procedural sky with a warning, as in the reference package. `load3DModel`
reads assimp binary dumps (`.assbin`, utils/assbin.py) and `.obj` files,
and gives a missing asset the reference's placeholder geometry.
"""
from __future__ import annotations

import logging
import math as _math
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core import math3d as m3
from ..spectrum.rgb import srgb_degamma
from .dsl.parser import DSLError, Env, TupleVal, execute
from .graph import (
    CameraNode,
    EmitterDesc,
    FTexDesc,
    MappingDesc,
    MaterialDesc,
    MeshNode,
    NTexDesc,
    Node,
    ReferenceNode,
    STexDesc,
    SceneDesc,
    SpectrumDesc,
    Vertex,
    flatten,
)

logger = logging.getLogger("slr_tpu_torch")

_MISSING = object()


class _TaggedImage(np.ndarray):
    """ndarray carrying the Image2D store mode (AsIs / NormalTexture /
    AlphaTexture) through the scene language's values, so that
    FloatTexture(image) knows to sample the alpha channel."""

    store_mode: str = "AsIs"


class ApiContext:
    def __init__(self, scene: SceneDesc, base_dir: str = "."):
        self.scene = scene
        self.base_dir = base_dir
        self.rng = np.random.RandomState(12345)


def _sig(params: list[tuple], fn: Callable) -> tuple:
    return (params, fn)


def builtin(*signatures):
    """Overloaded builtin with named/positional matching and defaults,
    mirroring the reference Function signature matching
    (SceneParser.hpp:220-273)."""

    def dispatcher(args: TupleVal, ctx: ApiContext):
        errors = []
        for params, fn in signatures:
            bound = _try_bind(params, args, ctx)
            if bound is not None:
                return fn(ctx=ctx, **bound)
            errors.append([p[0] for p in params])
        raise DSLError(f"no matching overload; tried {errors}; args={args!r}")

    return dispatcher


def _type_ok(value: Any, ty: Optional[type | tuple]) -> bool:
    if ty is None:
        return True
    if ty is float:
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if ty is int:
        return isinstance(value, int) and not isinstance(value, bool)
    return isinstance(value, ty)


def _try_bind(params: list[tuple], args: TupleVal, ctx) -> Optional[dict]:
    named = dict(args.named())
    pos = list(args.positional())
    out = {}
    for name, ty, *rest in params:
        default = rest[0] if rest else _MISSING
        if name in named:
            v = named.pop(name)
            if not _type_ok(v, ty):
                return None
        elif pos and _type_ok(pos[0], ty):
            v = pos.pop(0)
        elif default is not _MISSING:
            # defaulted param skipped by a non-matching positional
            out[name] = default
            continue
        else:
            return None
        out[name] = v
    if pos or named:
        return None
    return out


def _vec(v) -> np.ndarray:
    return np.asarray(v, np.float32).reshape(3)


def _tuple_to_vec(t) -> np.ndarray:
    if isinstance(t, TupleVal):
        return np.asarray([float(x) for x in t.positional()], np.float32)
    return _vec(t)


# ---------------------------------------------------------------------------
# Registry construction
# ---------------------------------------------------------------------------

def make_global_env(ctx: ApiContext) -> Env:
    env = Env()
    s = ctx.scene
    env.define("root", s.root)

    # -- basic utilities ----------------------------------------------------
    env.define("print", builtin(_sig([("value", None)], lambda value, ctx: print(value))))

    def _add_item(tuple, item, key="", ctx=None):
        tuple.add(key or None, item)
        return tuple

    env.define("addItem", builtin(
        _sig([("tuple", TupleVal), ("key", str, ""), ("item", None)], _add_item)
    ))
    env.define("numElements", builtin(
        _sig([("tuple", TupleVal)], lambda tuple, ctx: len(tuple))
    ))
    env.define("Point", builtin(
        _sig([("x", float), ("y", float), ("z", float)],
             lambda x, y, z, ctx: _vec((x, y, z)))
    ))
    env.define("Vector", builtin(
        _sig([("x", float), ("y", float), ("z", float)],
             lambda x, y, z, ctx: _vec((x, y, z)))
    ))
    env.define("getX", builtin(_sig([("v", np.ndarray)], lambda v, ctx: float(v[0]))))
    env.define("getY", builtin(_sig([("v", np.ndarray)], lambda v, ctx: float(v[1]))))
    env.define("getZ", builtin(_sig([("v", np.ndarray)], lambda v, ctx: float(v[2]))))
    env.define("random", builtin(_sig([], lambda ctx: float(ctx.rng.rand()))))

    # -- math ---------------------------------------------------------------
    env.define("min", builtin(
        _sig([("x0", float), ("x1", float)], lambda x0, x1, ctx: min(x0, x1))
    ))
    env.define("clamp", builtin(
        _sig([("x", float), ("min", float), ("max", float)],
             lambda x, min, max, ctx: np.clip(x, min, max).item())
    ))
    for name, f in [("sqrt", _math.sqrt), ("sin", _math.sin), ("cos", _math.cos),
                    ("tan", _math.tan), ("asin", _math.asin), ("acos", _math.acos),
                    ("atan", _math.atan)]:
        env.define(name, builtin(_sig([("x", float)], (lambda f: lambda x, ctx: f(x))(f))))
    env.define("pow", builtin(
        _sig([("x", float), ("e", float)], lambda x, e, ctx: x ** e)
    ))
    env.define("dot", builtin(
        _sig([("v0", np.ndarray), ("v1", np.ndarray)],
             lambda v0, v1, ctx: float(np.dot(v0, v1)))
    ))
    env.define("cross", builtin(
        _sig([("v0", np.ndarray), ("v1", np.ndarray)],
             lambda v0, v1, ctx: np.cross(v0, v1).astype(np.float32))
    ))
    env.define("distance", builtin(
        _sig([("p0", np.ndarray), ("p1", np.ndarray)],
             lambda p0, p1, ctx: float(np.linalg.norm(p1 - p0)))
    ))
    env.define("normalize", builtin(
        _sig([("v", np.ndarray)],
             lambda v, ctx: (v / np.linalg.norm(v)).astype(np.float32))
    ))

    # -- transforms (BuiltinFunctions::Transform) ---------------------------
    env.define("translate", builtin(
        _sig([("x", float), ("y", float), ("z", float)],
             lambda x, y, z, ctx: m3.mat_translate(np.array([x, y, z], np.float32)).numpy()),
        _sig([("v", np.ndarray)],
             lambda v, ctx: m3.mat_translate(v).numpy()),
    ))
    env.define("rotate", builtin(
        _sig([("angle", float), ("axis", np.ndarray)],
             lambda angle, axis, ctx: m3.mat_rotate(angle, axis).numpy())
    ))
    env.define("rotateX", builtin(
        _sig([("angle", float)], lambda angle, ctx: m3.mat_rotate_x(angle).numpy())
    ))
    env.define("rotateY", builtin(
        _sig([("angle", float)], lambda angle, ctx: m3.mat_rotate_y(angle).numpy())
    ))
    env.define("rotateZ", builtin(
        _sig([("angle", float)], lambda angle, ctx: m3.mat_rotate_z(angle).numpy())
    ))
    env.define("scale", builtin(
        _sig([("s", float)], lambda s, ctx: m3.mat_scale(s).numpy()),
        _sig([("sx", float), ("sy", float), ("sz", float)],
             lambda sx, sy, sz, ctx: m3.mat_scale(np.array([sx, sy, sz], np.float32)).numpy()),
    ))
    env.define("lookAt", builtin(
        _sig([("eye", np.ndarray), ("target", np.ndarray), ("up", np.ndarray)],
             lambda eye, target, up, ctx: m3.mat_look_at(eye, target, up).numpy())
    ))
    env.define("AnimatedTransform", builtin(
        # Reference signature (builtin_transform.cpp:81-88): transforms
        # pinned to absolute times tBegin/tEnd; flatten re-pins them to the
        # render [timeStart, timeEnd] shutter.
        _sig([("tfStart", np.ndarray), ("tfEnd", np.ndarray),
              ("tBegin", float), ("tEnd", float)],
             lambda tfStart, tfEnd, tBegin, tEnd, ctx:
             (tfStart, tfEnd, float(tBegin), float(tEnd))),
        _sig([("begin", np.ndarray), ("end", np.ndarray)],
             lambda begin, end, ctx: (begin, end, 0.0, 1.0)),
    ))

    # -- textures -----------------------------------------------------------
    def _mapping_params(kind: str, params: TupleVal | None) -> MappingDesc:
        """Texture2DMapping/3DMapping (builtin_texture.cpp:14-42). The
        reference exposes "texcoord 2D" and "world pos"; the optional params
        tuple maps onto OffsetAndScale2DMapping (textures.h:32-42):
        positional (ox, oy, sx, sy) or named offset/scale pairs."""
        if kind not in ("texcoord 2D", "world pos"):
            raise DSLError(f"unknown texture mapping type {kind!r}")
        scale = (1.0, 1.0)
        offset = (0.0, 0.0)
        if params is not None:
            pos = params.positional()
            named = params.named()
            if len(pos) >= 4:
                offset = (float(pos[0]), float(pos[1]))
                scale = (float(pos[2]), float(pos[3]))
            if "offset" in named:
                o = named["offset"]
                offset = (float(o[0]), float(o[1]))
            if "scale" in named:
                sv = named["scale"]
                if isinstance(sv, (int, float)):
                    scale = (float(sv), float(sv))
                else:
                    scale = (float(sv[0]), float(sv[1]))
        return MappingDesc(kind=kind, scale=scale, offset=offset)

    env.define("Texture2DMapping", builtin(
        _sig([("type", str, "texcoord 2D"), ("params", TupleVal, None)],
             lambda type, params, ctx: _mapping_params(type, params))
    ))
    env.define("Texture3DMapping", builtin(
        _sig([("type", str, "texcoord 2D"), ("params", TupleVal, None)],
             lambda type, params, ctx: _mapping_params(type, params))
    ))

    def _spectrum_texture(value, ctx, mapping=None):
        if isinstance(value, SpectrumDesc):
            return STexDesc(kind="constant", spectrum=value,
                            mapping=mapping or MappingDesc())
        if isinstance(value, np.ndarray):  # image
            return STexDesc(kind="image", image=value,
                            mapping=mapping or MappingDesc())
        if isinstance(value, str):
            raise DSLError(f"SpectrumTexture: bad argument {value!r}")
        raise DSLError("SpectrumTexture: bad argument")

    def _procedural_stex(procedure, params, ctx):
        named = params.named()
        pos = params.positional()
        mapping = named.get("mapping") or MappingDesc()
        if procedure == "checker board":
            # configFunc(c0, c1, mapping) — builtin_texture.cpp:63-75
            return STexDesc(kind="checker", v0=pos[0], v1=pos[1],
                            mapping=mapping)
        if procedure == "voronoi":
            return STexDesc(kind="voronoi", cell_scale=float(pos[0]),
                            brightness=float(pos[1]) if len(pos) > 1 else 0.8,
                            mapping=mapping)
        raise DSLError(f"unknown procedure {procedure}")

    env.define("SpectrumTexture", builtin(
        _sig([("spectrum", SpectrumDesc)],
             lambda spectrum, ctx: STexDesc(kind="constant", spectrum=spectrum)),
        _sig([("image", np.ndarray), ("mapping", MappingDesc, None)],
             lambda image, mapping, ctx: STexDesc(kind="image", image=image,
                                                  mapping=mapping or MappingDesc())),
        _sig([("procedure", str), ("params", TupleVal)], _procedural_stex),
    ))

    def _float_texture(value=None, procedure=None, params=None, image=None, ctx=None):
        if value is not None:
            return FTexDesc(kind="constant", value=float(value))
        if image is not None:
            chan = ("alpha" if getattr(image, "store_mode", "") == "AlphaTexture"
                    else "lum")
            return FTexDesc(kind="image", image=np.asarray(image), channel=chan)
        if procedure == "checker board":
            pos = params.positional()
            return FTexDesc(kind="checker", v0=float(pos[0]), v1=float(pos[1]))
        if procedure == "voronoi":
            pos = params.positional()
            cell = float(pos[0]) if pos else 1.0
            vscale = float(pos[1]) if len(pos) > 1 else 1.0
            return FTexDesc(kind="voronoi", cell_scale=cell, value_scale=vscale)
        raise DSLError("FloatTexture: unsupported arguments")

    env.define("FloatTexture", builtin(
        _sig([("value", float)], lambda value, ctx: FTexDesc(kind="constant", value=float(value))),
        _sig([("image", np.ndarray)],
             lambda image, ctx: _float_texture(image=image)),
        _sig([("procedure", str), ("params", TupleVal)],
             lambda procedure, params, ctx: _float_texture(procedure=procedure, params=params)),
    ))
    env.define("NormalTexture", builtin(
        _sig([("image", np.ndarray), ("mapping", MappingDesc, None)],
             lambda image, mapping, ctx: NTexDesc(kind="image", image=image,
                                                  mapping=mapping or MappingDesc())),
        _sig([("procedure", str), ("params", TupleVal)],
             lambda procedure, params, ctx: NTexDesc(kind=procedure)),
    ))

    # -- Spectrum overloads (API.cpp:286-441) -------------------------------
    def _spectrum_library(ID, idx=0, ctx=None):
        return SpectrumDesc(kind="library", library_id=ID, library_comp=int(idx))

    def _srgb_degamma(v: float) -> float:
        v = max(float(v), 0.0)
        return v / 12.92 if v <= 0.04045 else ((v + 0.055) / 1.055) ** 2.4

    def _spectrum_rgb(type, space, e0, e1, e2, ctx):
        """Color-space semantics of the reference DSL (strToColorSpace,
        API.cpp:59-71): the DEFAULT space string "sRGB" means
        ColorSpace::sRGB_NonLinear — scene RGB constants are gamma-encoded
        and degamma'd before upsampling (UpsampledContinuousSpectrum ctor,
        SpectrumTypes.h:183-189); "Rec709" is linear sRGB primaries. XYZ and
        xyY are mapped to linear RGB through the inverse of the matrix the
        flattener will re-apply (E-white for reflectance/IoR, D65 for
        illuminants), so the round trip is exact."""
        if space == "sRGB":
            rgb = (_srgb_degamma(e0), _srgb_degamma(e1), _srgb_degamma(e2))
        elif space == "Rec709":
            rgb = (float(e0), float(e1), float(e2))
        elif space in ("XYZ", "xyY"):
            from ..spectrum.spectral import _sRGB_E_to_XYZ, _sRGB_to_XYZ

            if space == "xyY":
                x, y, bright = float(e0), float(e1), float(e2)
                b = bright / max(y, 1e-9)
                xyz = np.array([x * b, y * b, (1.0 - x - y) * b], np.float64)
            else:
                xyz = np.array([e0, e1, e2], np.float64)
            m = _sRGB_to_XYZ if type == "Illuminant" else _sRGB_E_to_XYZ
            rgb = tuple(np.linalg.solve(np.asarray(m, np.float64), xyz))
        else:
            raise DSLError(f"Spectrum: invalid color space {space!r}")
        return SpectrumDesc(kind="rgb", spectrum_type=type, rgb=rgb)

    env.define("Spectrum", builtin(
        # (type, value) must be tried before the library overload so
        # Spectrum("Illuminant", 500) binds as a mono spectrum; the library
        # form is reached by its named argument, Spectrum("ID": ..., idx)
        # (reference overload table, API.cpp:286-441).
        _sig([("type", str), ("value", float)],
             lambda type, value, ctx: SpectrumDesc(kind="mono", spectrum_type=type, value=value)),
        _sig([("ID", str), ("idx", int, 0)], _spectrum_library),
        _sig([("value", float)],
             lambda value, ctx: SpectrumDesc(kind="mono", value=value)),
        _sig([("type", str, "Reflectance"), ("space", str, "sRGB"),
              ("e0", float), ("e1", float), ("e2", float)],
             _spectrum_rgb),
        _sig([("type", str, "Reflectance"), ("minWL", float), ("maxWL", float),
              ("values", TupleVal)],
             lambda type, minWL, maxWL, values, ctx: SpectrumDesc(
                 kind="regular", spectrum_type=type, min_wl=minWL, max_wl=maxWL,
                 values=tuple(float(v) for v in values.positional()))),
        _sig([("type", str, "Reflectance"), ("wls", TupleVal), ("values", TupleVal)],
             lambda type, wls, values, ctx: SpectrumDesc(
                 kind="irregular", spectrum_type=type,
                 wls=tuple(float(v) for v in wls.positional()),
                 values=tuple(float(v) for v in values.positional()))),
    ))

    def _image2d(path, type, ctx):
        """Image2D(path, mode): mode AsIs | NormalTexture | AlphaTexture."""
        img = _load_image(ctx, path).view(_TaggedImage)
        img.store_mode = type
        return img

    env.define("Image2D", builtin(
        _sig([("path", str), ("type", str, "AsIs")], _image2d)
    ))

    # -- vertices / meshes --------------------------------------------------
    def _create_vertex(position, normal, tangent, texCoord, ctx):
        return Vertex(
            position=_tuple_to_vec(position),
            normal=_tuple_to_vec(normal),
            tangent=_tuple_to_vec(tangent),
            uv=np.asarray([float(x) for x in texCoord.positional()], np.float32)
            if isinstance(texCoord, TupleVal)
            else np.asarray(texCoord, np.float32),
        )

    env.define("createVertex", builtin(
        _sig([("position", None), ("normal", None), ("tangent", None),
              ("texCoord", None)], _create_vertex)
    ))

    # -- materials ----------------------------------------------------------
    def _create_surface_material(type, params, ctx):
        pos = params.positional()
        named = params.named()

        def get(i, name, default=_MISSING):
            if name in named:
                return named[name]
            if i < len(pos):
                return pos[i]
            if default is not _MISSING:
                return default
            raise DSLError(f"createSurfaceMaterial {type}: missing {name}")

        if type == "matte":
            return MaterialDesc(
                kind="matte",
                stex=(get(0, "reflectance"),),
                ftex=(get(1, "sigma", None),),
            )
        if type == "metal":
            return MaterialDesc(
                kind="metal",
                stex=(get(0, "coeffR"), get(1, "eta"), get(2, "k")),
            )
        if type == "glass":
            return MaterialDesc(
                kind="glass",
                stex=(get(0, "coeff"), get(1, "etaExt"), get(2, "etaInt")),
            )
        if type == "Ward":
            return MaterialDesc(
                kind="Ward", stex=(get(0, "R"),),
                ftex=(get(1, "anisoX"), get(2, "anisoY")),
            )
        if type == "Ashikhmin":
            return MaterialDesc(
                kind="Ashikhmin", stex=(get(0, "Rd"), get(1, "Rs")),
                ftex=(get(2, "nx"), get(3, "ny")),
            )
        if type == "microfacet metal":
            return MaterialDesc(
                kind="microfacet metal", stex=(get(0, "eta"), get(1, "k")),
                ftex=(get(2, "alpha_g"),),
            )
        if type == "microfacet glass":
            return MaterialDesc(
                kind="microfacet glass",
                stex=(get(0, "etaExt"), get(1, "etaInt")),
                ftex=(get(2, "alpha_g"),),
            )
        if type == "inverse":
            return MaterialDesc(kind="inverse", sub=(get(0, "base"),))
        if type == "emitter":
            return MaterialDesc(
                kind="emitter", sub=(get(0, "scatter"),),
                emitter=get(1, "emitter"),
            )
        if type == "mix":
            return MaterialDesc(
                kind="mix", sub=(get(0, "mat0"), get(1, "mat1")),
                ftex=(get(2, "factor"),),
            )
        if type == "sum":
            return MaterialDesc(kind="sum", sub=(get(0, "mat0"), get(1, "mat1")))
        raise DSLError(f"unknown surface material type {type}")

    env.define("createSurfaceMaterial", builtin(
        _sig([("type", str), ("params", TupleVal)], _create_surface_material)
    ))

    def _create_emitter(type, params, ctx):
        if type == "diffuse":
            pos = params.positional()
            named = params.named()
            em = named.get("emittance", pos[0] if pos else None)
            return EmitterDesc(kind="diffuse", emittance=em)
        raise DSLError(f"unknown emitter type {type}")

    env.define("createEmitterSurfaceProperty", builtin(
        _sig([("type", str), ("params", TupleVal)], _create_emitter)
    ))

    # -- mesh / node construction ------------------------------------------
    def _create_mesh(vertices, matGroups, ctx):
        node = MeshNode("mesh")
        for item in vertices.positional():
            if isinstance(item, Vertex):
                node.vertices.append(item)
            else:
                # Vertex tuples bind like createVertex's signature: named
                # entries ("position": ...) may interleave with positionals
                # (SceneParser.hpp:220-273 matching, e.g.
                # Cornell_Box_Boxes.txt:19).
                named = dict(item.named())
                pos = list(item.positional())
                vals = {}
                for pname in ("position", "normal", "tangent", "texCoord"):
                    if pname in named:
                        vals[pname] = named[pname]
                    elif pos:
                        vals[pname] = pos.pop(0)
                    else:
                        raise DSLError(f"vertex tuple missing {pname}")
                node.vertices.append(
                    Vertex(
                        position=_tuple_to_vec(vals["position"]),
                        normal=_tuple_to_vec(vals["normal"]),
                        tangent=_tuple_to_vec(vals["tangent"]),
                        uv=np.asarray(
                            [float(x) for x in vals["texCoord"].positional()],
                            np.float32),
                    )
                )
        for group in matGroups.positional():
            gpos = group.positional()
            gnamed = group.named()
            mat = gnamed.get("mat", gpos[0] if gpos else None)
            rest = [g for g in gpos[1:]]
            normal_tex = gnamed.get("normal")
            alpha_tex = gnamed.get("alpha")
            tris_tuple = None
            for r in rest:
                if isinstance(r, NTexDesc):
                    normal_tex = r
                elif isinstance(r, FTexDesc):
                    alpha_tex = r
                elif isinstance(r, TupleVal):
                    tris_tuple = r
            if tris_tuple is None:
                tris_tuple = gnamed.get("triangles")
            tris = [
                tuple(int(i) for i in t.positional())
                for t in tris_tuple.positional()
            ]
            node.add_group(mat, normal_tex, alpha_tex, tris)
        return node

    env.define("createMesh", builtin(
        _sig([("vertices", TupleVal), ("matGroups", TupleVal)], _create_mesh)
    ))
    env.define("createNode", builtin(_sig([], lambda ctx: Node("node"))))

    def _copy_node(src, ctx):
        import copy

        return copy.deepcopy(src)

    env.define("copyNode", builtin(_sig([("src", Node)], _copy_node)))
    env.define("createReferenceNode", builtin(
        _sig([("node", Node)], lambda node, ctx: ReferenceNode(node))
    ))

    def _set_transform(node, transform, ctx):
        node.transform = transform
        return node

    env.define("setTransform", builtin(
        _sig([("node", Node), ("transform", None)], _set_transform)
    ))

    def _add_child(parent, child, ctx):
        parent.add_child(child)
        return parent

    env.define("addChild", builtin(
        _sig([("parent", Node), ("child", Node)], _add_child)
    ))

    env.define("load3DModel", builtin(
        _sig([("path", str), ("matProc", None, None), ("meshProc", None, None)],
             lambda path, matProc, meshProc, ctx: _load_model(ctx, path, matProc))
    ))

    def _scan_xz(node, numX, numZ, randomness, callback, ctx):
        """scanXZFromYPlus (API.cpp:926-983): raycast an X-Z grid downward
        onto `node`'s geometry and invoke `callback(i, position)` — used for
        scatter/instancing (RTC3 grass). Host-side implementation."""
        from .graph import flatten as _flat
        tmp = SceneDesc()
        tmp.root.add_child(node)
        # host raycast via numpy brute force over flattened triangles
        b_scene = _flat(tmp, spectral=False, use_bvh=False)
        pos = b_scene.geometry.positions.numpy()
        tri = b_scene.geometry.tri_vidx.numpy()
        nrm = b_scene.geometry.normals.numpy()
        tan = b_scene.geometry.tangents.numpy()
        p0, p1, p2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
        lo = pos.min(axis=0)
        hi = pos.max(axis=0)
        for iz in range(numZ):
            for ix in range(numX):
                fx = (ix + 0.5 + (ctx.rng.rand() - 0.5) * randomness) / numX
                fz = (iz + 0.5 + (ctx.rng.rand() - 0.5) * randomness) / numZ
                ox = lo[0] + (hi[0] - lo[0]) * fx
                oz = lo[2] + (hi[2] - lo[2]) * fz
                o = np.array([ox, hi[1] + 1.0, oz], np.float32)
                d = np.array([0.0, -1.0, 0.0], np.float32)
                res = _raycast_down(o, d, p0, p1, p2)
                if res is None:
                    continue
                t, ti, b1, b2 = res
                p = o + t * d
                b0 = 1.0 - b1 - b2
                vi = tri[ti]
                # Shading frame at the hit (callback(p, tangent, bitangent,
                # normal) — reference API.cpp:968-975).
                n = b0 * nrm[vi[0]] + b1 * nrm[vi[1]] + b2 * nrm[vi[2]]
                n = n / max(float(np.linalg.norm(n)), 1e-20)
                tg = b0 * tan[vi[0]] + b1 * tan[vi[1]] + b2 * tan[vi[2]]
                tg = tg - np.dot(tg, n) * n
                tg = tg / max(float(np.linalg.norm(tg)), 1e-20)
                bt = np.cross(n, tg)
                args = TupleVal()
                args.add(None, p.astype(np.float32))
                args.add(None, tg.astype(np.float32))
                args.add(None, bt.astype(np.float32))
                args.add(None, n.astype(np.float32))
                callback(args, ctx)
        return None

    env.define("scanXZFromYPlus", builtin(
        _sig([("node", Node), ("numX", int), ("numZ", int),
              ("randomness", float, 0.0), ("callback", None)], _scan_xz)
    ))

    def _create_camera(ctx, sensitivity=0.0, aspect=1.0, fovY=0.5235987756,
                       radius=0.0, imgDist=0.02, objDist=5.0):
        return CameraNode({
            "sensitivity": sensitivity, "aspect": aspect, "fovY": fovY,
            "radius": radius, "imgDist": imgDist, "objDist": objDist,
        })

    env.define("createPerspectiveCamera", builtin(
        _sig([("sensitivity", float, 0.0), ("aspect", float, 1.0),
              ("fovY", float, 0.5235987756), ("radius", float, 0.0),
              ("imgDist", float, 0.02), ("objDist", float, 5.0)],
             _create_camera)
    ))

    def _set_renderer(method, config=None, ctx=None):
        cfg = {"method": method}
        if config is not None:
            cfg.update({k: v for k, v in config.named().items()})
        ctx.scene.renderer = cfg
        return None

    env.define("setRenderer", builtin(
        _sig([("method", str), ("config", TupleVal, None)], _set_renderer)
    ))

    def _set_render_settings(ctx, width=1024, height=1024, timeStart=0.0,
                             timeEnd=0.0, brightness=1.0, rngSeed=1509761209):
        ctx.scene.settings.update({
            "width": width, "height": height, "timeStart": timeStart,
            "timeEnd": timeEnd, "brightness": brightness, "rngSeed": rngSeed,
        })
        return None

    env.define("setRenderSettings", builtin(
        _sig([("width", int, 1024), ("height", int, 1024),
              ("timeStart", float, 0.0), ("timeEnd", float, 0.0),
              ("brightness", float, 1.0), ("rngSeed", int, 1509761209)],
             _set_render_settings)
    ))

    def _set_environment(path, scale=1.0, ctx=None):
        img = _load_image(ctx, path)
        ctx.scene.env_image = img
        ctx.scene.env_scale = scale
        return None

    env.define("setEnvironment", builtin(
        _sig([("path", str), ("scale", float, 1.0)], _set_environment)
    ))

    return env


def _raycast_down(o, d, p0, p1, p2):
    """Minimal host Möller-Trumbore for scanXZFromYPlus."""
    e1 = p1 - p0
    e2 = p2 - p0
    pv = np.cross(d, e2)
    det = np.einsum("ij,ij->i", e1, pv)
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tv = o - p0
    b1 = np.einsum("ij,ij->i", tv, pv) * inv
    qv = np.cross(tv, e1)
    b2 = np.dot(qv, d) * inv
    t = np.einsum("ij,ij->i", e2, qv) * inv
    hit = ok & (b1 >= 0) & (b1 <= 1) & (b2 >= 0) & (b1 + b2 <= 1) & (t > 1e-4)
    if not hit.any():
        return None
    t_masked = np.where(hit, t, np.inf)
    i = int(np.argmin(t_masked))
    return float(t[i]), i, float(b1[i]), float(b2[i])


def _load_image(ctx: ApiContext, path: str) -> np.ndarray:
    """An image file as float32 linear RGBA: EXR as stored, PNG through
    the sRGB de-gamma. A missing asset or an undecodable EXR (the reference
    repo bundles neither its EXR environments nor its models) gets a
    procedural sky, with a warning, so that the scene still loads."""
    full = path if os.path.isabs(path) else os.path.join(ctx.base_dir, path)
    if os.path.exists(full) and full.lower().endswith(".exr"):
        from ..utils.exr import read_exr

        try:
            return read_exr(full)
        except ValueError as e:
            logger.warning("%s; using placeholder", e)
            return _placeholder_sky()
    if os.path.exists(full):
        from ..utils.png import read_png

        # A PNG feature the decoder lacks raises, as an unreadable file
        # does in the reference package.
        im = read_png(full).astype(np.float32) / 255.0
        rgb = srgb_degamma(torch.as_tensor(im[..., :3])).numpy()
        return np.concatenate([rgb, im[..., 3:]], axis=-1)
    logger.warning("image asset %s unavailable; substituting a procedural "
                   "sky", path)
    return _placeholder_sky()


def _placeholder_sky(h: int = 64, w: int = 128) -> np.ndarray:
    """Equirectangular gradient sky with a bright sun disc, so the
    environment's importance sampler has something to work on."""
    v = (np.arange(h, dtype=np.float32) + 0.5) / h   # 0 top .. 1 bottom
    u = (np.arange(w, dtype=np.float32) + 0.5) / w
    uu, vv = np.meshgrid(u, v)
    zenith = np.array([0.35, 0.55, 1.0], np.float32)
    horizon = np.array([0.9, 0.85, 0.8], np.float32)
    ground = np.array([0.25, 0.22, 0.2], np.float32)
    tcol = np.where(
        (vv < 0.5)[..., None],
        zenith * (1 - 2 * vv)[..., None] + horizon * (2 * vv)[..., None],
        horizon * (2 - 2 * vv)[..., None] + ground * (2 * vv - 1)[..., None],
    ).astype(np.float32)
    # the sun at (u, v) = (0.25, 0.3)
    ang = (uu - 0.25) ** 2 + (vv - 0.3) ** 2
    sun = np.exp(-ang / 0.0004)[..., None] * np.float32([40.0, 36.0, 30.0])
    return np.concatenate([tcol + sun, np.ones((h, w, 1), np.float32)],
                          axis=-1)


def _load_model(ctx: ApiContext, path: str, mat_proc) -> Node:
    """load3DModel (API.cpp:800-925). The reference uses assimp; here:
    the bundled sphere model is generated procedurally (the assets are not in
    the repository, README.md:71-72) and .obj files get a minimal loader."""
    from .presets import uv_sphere

    node = Node("model:" + path)
    full0 = path if os.path.isabs(path) else os.path.join(ctx.base_dir, path)
    if full0.endswith(".assbin") and os.path.exists(full0):
        try:
            return _load_assbin(ctx, full0, path, mat_proc)
        except Exception as e:
            logger.warning("assbin import of %s failed (%s); falling through",
                           path, e)
    if "sphere" in os.path.basename(path):
        pos, nrm, tan, uv, tris = uv_sphere((0.0, 0.0, 0.0), 1.0, 32, 64)
        mesh = MeshNode("sphere")
        for i in range(len(pos)):
            mesh.vertices.append(Vertex(pos[i], nrm[i], tan[i], uv[i]))
        mat = _apply_mat_proc(ctx, mat_proc, "sphere")
        mesh.add_group(mat, None, None, [tuple(t) for t in tris])
        node.add_child(mesh)
        return node
    full = path if os.path.isabs(path) else os.path.join(ctx.base_dir, path)
    if full.endswith(".obj") and os.path.exists(full):
        mesh = _load_obj(full)
        mat = _apply_mat_proc(ctx, mat_proc, os.path.basename(path))
        mesh.groups = [(mat, None, None, g[3]) for g in mesh.groups]
        node.add_child(mesh)
        return node
    # Missing / binary-assimp assets (the reference repo does not bundle its
    # models, README.md:71-72): substitute a shape-appropriate placeholder so
    # the scene still loads, instances, and renders a meaningful image:
    #  - Cornell_box_* -> inward-facing [-1,1]^3 Cornell shell (white
    #    floor/ceiling/back, red left, green right) — the scenes position
    #    their DSL-defined area light and props inside those bounds;
    #  - *plain* (RTC3 terrain) -> large ground plane at y=0 (the
    #    scanXZFromYPlus grid raycasts down onto it);
    #  - otherwise -> [-1,1]^3 cube (the transforms in Cornell_Box_Boxes
    #    assume box.assbin spans [-1,1]).
    base = os.path.basename(path)
    if "cornell_box" in base.lower():
        kind = "Cornell-shell"
        mesh = _cornell_shell_mesh(base)
        names = ("white", "red", "green")
        if mat_proc is not None:
            mesh.groups = [
                (_apply_mat_proc(ctx, mat_proc, n), None, None, g[3])
                for n, g in zip(names, mesh.groups)
            ]
        else:
            mesh.groups = [
                (_shell_material(n), None, None, g[3])
                for n, g in zip(names, mesh.groups)
            ]
    else:
        if "plain" in base.lower():
            kind = "ground-plane"
            mesh = _ground_plane_mesh(base)
        else:
            kind = "unit-cube"
            mesh = _unit_cube_mesh(base)
        mat = _apply_mat_proc(ctx, mat_proc, base)
        mesh.groups = [(mat, None, None, g[3]) for g in mesh.groups]
    logger.warning(
        "model asset %s unavailable; substituting a %s placeholder",
        path, kind,
    )
    node.add_child(mesh)
    return node


def _load_assbin(ctx: ApiContext, full: str, path: str, mat_proc) -> Node:
    """Assimp binary-dump import (node_constructor.cpp:35-105 semantics):
    walk the node hierarchy accumulating transforms, emit one MeshNode per
    (node, mesh) reference with the transform baked into vertices (the
    reference bakes static transforms at flatten time anyway), generate
    tangents when the dump lacks them, and resolve each mesh's material
    through the DSL override callback with the material's name."""
    from ..utils.assbin import read_assbin

    sc = read_assbin(full)
    root = Node("model:" + path)

    def mat_for(mesh_idx: int, mat_idx: int):
        name = (sc.material_names[mat_idx]
                if 0 <= mat_idx < len(sc.material_names) else "")
        return _apply_mat_proc(ctx, mat_proc,
                               name or f"material{mat_idx}")

    def walk(an, xform: np.ndarray):
        m = xform @ np.asarray(an.transform, np.float32)
        for mi in an.mesh_indices:
            am = sc.meshes[mi]
            v = am.positions @ m[:3, :3].T + m[:3, 3]
            lin = m[:3, :3]
            inv_t = np.linalg.inv(lin).T
            if am.normals is not None:
                nrm = am.normals @ inv_t.T
            else:
                nrm = np.zeros_like(v)
                f = am.faces
                fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
                for k in range(3):
                    np.add.at(nrm, f[:, k], fn)
            nrm = nrm / np.maximum(
                np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
            if am.tangents is not None:
                tan = am.tangents @ lin.T
                tan = tan / np.maximum(
                    np.linalg.norm(tan, axis=-1, keepdims=True), 1e-20)
            else:
                # generated tangents (aiProcess_CalcTangentSpace analogue):
                # any frame orthogonal to the normal
                up = np.where(np.abs(nrm[:, 1:2]) < 0.9,
                              np.array([[0.0, 1.0, 0.0]], np.float32),
                              np.array([[1.0, 0.0, 0.0]], np.float32))
                tan = np.cross(up, nrm)
                tan = tan / np.maximum(
                    np.linalg.norm(tan, axis=-1, keepdims=True), 1e-20)
            uv = (am.texcoords if am.texcoords is not None
                  else np.zeros((v.shape[0], 2), np.float32))
            mesh = MeshNode(f"{an.name}:mesh{mi}")
            for i in range(v.shape[0]):
                mesh.vertices.append(Vertex(v[i], nrm[i], tan[i], uv[i]))
            mesh.add_group(mat_for(mi, am.material_index), None, None,
                           [tuple(t) for t in np.asarray(am.faces)])
            root.add_child(mesh)
        for ch in an.children:
            walk(ch, m)

    walk(sc.root, np.eye(4, dtype=np.float32))
    return root


def _shell_material(name: str) -> MaterialDesc:
    rgb = {
        "white": (0.75, 0.75, 0.75),
        "red": (0.61, 0.09, 0.07),
        "green": (0.12, 0.47, 0.10),
    }[name]
    return MaterialDesc(kind="matte", stex=(
        STexDesc(kind="constant",
                 spectrum=SpectrumDesc(kind="rgb", rgb=rgb)),
    ))


def _cornell_shell_mesh(name: str) -> MeshNode:
    """Inward-facing [-1,1]^3 Cornell shell, front (z=+1) open: three
    material groups (white floor/ceiling/back, red left, green right)."""
    mesh = MeshNode("placeholder:" + name)
    quads = [
        # (inward normal, corners, material group)
        ((0, 1, 0), [(-1, -1, 1), (1, -1, 1), (1, -1, -1), (-1, -1, -1)], 0),
        ((0, -1, 0), [(-1, 1, -1), (1, 1, -1), (1, 1, 1), (-1, 1, 1)], 0),
        ((0, 0, 1), [(1, -1, -1), (1, 1, -1), (-1, 1, -1), (-1, -1, -1)], 0),
        ((1, 0, 0), [(-1, -1, -1), (-1, 1, -1), (-1, 1, 1), (-1, -1, 1)], 1),
        ((-1, 0, 0), [(1, -1, 1), (1, 1, 1), (1, 1, -1), (1, -1, -1)], 2),
    ]
    uv4 = [(0, 0), (1, 0), (1, 1), (0, 1)]
    group_tris: list = [[], [], []]
    for n, quad, grp in quads:
        basev = len(mesh.vertices)
        nn = np.asarray(n, np.float32)
        tangent = _any_tangent(nn)
        for p, uv in zip(quad, uv4):
            mesh.vertices.append(Vertex(
                np.asarray(p, np.float32), nn, tangent,
                np.asarray(uv, np.float32),
            ))
        group_tris[grp] += [(basev, basev + 1, basev + 2),
                            (basev, basev + 2, basev + 3)]
    for tris in group_tris:
        mesh.add_group(None, None, None, tris)
    return mesh


def _ground_plane_mesh(name: str) -> MeshNode:
    """Flat ground at y=0 spanning [-10, 10]^2 (terrain stand-in)."""
    mesh = MeshNode("placeholder:" + name)
    s = 10.0
    nn = np.float32([0, 1, 0])
    tangent = _any_tangent(nn)
    for p, uv in zip([(-s, 0, s), (s, 0, s), (s, 0, -s), (-s, 0, -s)],
                     [(0, 0), (1, 0), (1, 1), (0, 1)]):
        mesh.vertices.append(Vertex(
            np.asarray(p, np.float32), nn, tangent,
            np.asarray(uv, np.float32),
        ))
    mesh.add_group(None, None, None, [(0, 1, 2), (0, 2, 3)])
    return mesh


def _unit_cube_mesh(name: str) -> MeshNode:
    """Axis-aligned cube spanning [-1, 1]^3, outward normals — the scene
    transforms in Cornell_Box_Boxes assume box.assbin has these bounds
    (translate(0,1,0) then scale puts its base exactly on the shell floor)."""
    mesh = MeshNode("placeholder:" + name)
    faces = [
        ((0, 0, 1), [(-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]),
        ((0, 0, -1), [(1, -1, -1), (-1, -1, -1), (-1, 1, -1), (1, 1, -1)]),
        ((1, 0, 0), [(1, -1, 1), (1, -1, -1), (1, 1, -1), (1, 1, 1)]),
        ((-1, 0, 0), [(-1, -1, -1), (-1, -1, 1), (-1, 1, 1), (-1, 1, -1)]),
        ((0, 1, 0), [(-1, 1, 1), (1, 1, 1), (1, 1, -1), (-1, 1, -1)]),
        ((0, -1, 0), [(-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1)]),
    ]
    uv4 = [(0, 0), (1, 0), (1, 1), (0, 1)]
    tris = []
    for n, quad in faces:
        base = len(mesh.vertices)
        nn = np.asarray(n, np.float32)
        tangent = _any_tangent(nn)
        for p, uv in zip(quad, uv4):
            mesh.vertices.append(Vertex(
                np.asarray(p, np.float32), nn, tangent,
                np.asarray(uv, np.float32),
            ))
        tris += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    mesh.add_group(None, None, None, tris)
    return mesh


def _apply_mat_proc(ctx: ApiContext, mat_proc, name: str) -> MaterialDesc:
    if mat_proc is None:
        return MaterialDesc(
            kind="matte",
            stex=(STexDesc(kind="constant",
                           spectrum=SpectrumDesc(kind="mono", value=0.5)),),
            ftex=(None,),
        )
    args = TupleVal()
    args.add(None, name)
    # Material attributes the reference translates from assimp
    # (node_constructor.cpp:35-105); placeholders since assets aren't bundled.
    attrs = TupleVal()
    attrs.add("diffuse textures", TupleVal())
    dif = TupleVal()
    for c in (0.6, 0.6, 0.6):
        dif.add(None, c)
    attrs.add("diffuse color", dif)
    args.add(None, attrs)
    return mat_proc(args, ctx)


def _load_obj(path: str) -> MeshNode:
    """Minimal OBJ reader: v/vn/vt/f (triangulated fan)."""
    vs, vns, vts = [], [], []
    mesh = MeshNode(os.path.basename(path))
    tris = []
    vert_cache: dict[tuple, int] = {}

    def vertex_index(spec: str) -> int:
        if spec in vert_cache:
            return vert_cache[spec]
        parts = (spec.split("/") + ["", ""])[:3]
        vi = int(parts[0]) - 1
        ti = int(parts[1]) - 1 if parts[1] else -1
        ni = int(parts[2]) - 1 if parts[2] else -1
        p = np.asarray(vs[vi], np.float32)
        n = np.asarray(vns[ni], np.float32) if ni >= 0 else np.array([0, 1, 0], np.float32)
        t = np.asarray(vts[ti][:2], np.float32) if ti >= 0 else np.zeros(2, np.float32)
        tangent = _any_tangent(n)
        idx = len(mesh.vertices)
        mesh.vertices.append(Vertex(p, n, tangent, t))
        vert_cache[spec] = idx
        return idx

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vs.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                vns.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                vts.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                idxs = [vertex_index(s) for s in parts[1:]]
                for k in range(1, len(idxs) - 1):
                    tris.append((idxs[0], idxs[k], idxs[k + 1]))
    mesh.add_group(None, None, None, tris)
    return mesh


def _any_tangent(n: np.ndarray) -> np.ndarray:
    a = np.array([1.0, 0.0, 0.0], np.float32)
    if abs(n[0]) > 0.9:
        a = np.array([0.0, 1.0, 0.0], np.float32)
    t = np.cross(a, n)
    return (t / np.linalg.norm(t)).astype(np.float32)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def read_scene(path: str) -> tuple[SceneDesc, ApiContext]:
    """Parse + execute a scene file (reference readScene, API.cpp:84-97)."""
    scene = SceneDesc()
    ctx = ApiContext(scene, base_dir=os.path.dirname(os.path.abspath(path)))
    env = make_global_env(ctx)
    with open(path) as f:
        src = f.read()
    execute(src, env, ctx)
    return scene, ctx


def load_scene(path: str, spectral: bool = False, use_bvh: bool = True,
               device=None):
    """Scene file -> (FlatScene on `device`, renderer config, render
    settings). `device=None` means the CUDA device; the CPU only when
    asked for (`device="cpu"`)."""
    from ..core.device import resolve_device

    dev = resolve_device(device)
    scene, _ = read_scene(path)
    flat = flatten(scene, spectral=spectral, use_bvh=use_bvh)
    return flat.to(dev), scene.renderer, scene.settings
