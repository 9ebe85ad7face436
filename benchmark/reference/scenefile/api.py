"""The scene language's builtin functions: what the SLR scene files call
(reference API.cpp), building the scene graph of `graph.py`.

A copy of the program's scene-file reader, kept so that both sides read a
scene file alike; everything after the graph (spectra, geometry, shading,
tracing) is the benchmark's own (`reference/scene.py`, `pathtracer.py`).
It reads only what the benchmark's scene files use: images, 3D models and
environment maps are refused.
"""
from __future__ import annotations

import math as _math
import os
from typing import Any, Callable, Optional

import numpy as np

from . import transforms as m3
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
)
from .parser import DSLError, Env, TupleVal, execute

_MISSING = object()


def _refuse(what: str):
    raise DSLError(f"{what}: not read by the benchmark's reference")


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
             lambda x, y, z, ctx: m3.translate((x, y, z))),
        _sig([("v", np.ndarray)],
             lambda v, ctx: m3.translate(v)),
    ))
    env.define("rotate", builtin(
        _sig([("angle", float), ("axis", np.ndarray)],
             lambda angle, axis, ctx: m3.rotate(angle, axis))
    ))
    env.define("rotateX", builtin(
        _sig([("angle", float)], lambda angle, ctx: m3.rotate_axis("x", angle))
    ))
    env.define("rotateY", builtin(
        _sig([("angle", float)], lambda angle, ctx: m3.rotate_axis("y", angle))
    ))
    env.define("rotateZ", builtin(
        _sig([("angle", float)], lambda angle, ctx: m3.rotate_axis("z", angle))
    ))
    env.define("scale", builtin(
        _sig([("s", float)], lambda s, ctx: m3.scale((s, s, s))),
        _sig([("sx", float), ("sy", float), ("sz", float)],
             lambda sx, sy, sz, ctx: m3.scale((sx, sy, sz))),
    ))
    env.define("lookAt", builtin(
        _sig([("eye", np.ndarray), ("target", np.ndarray), ("up", np.ndarray)],
             lambda eye, target, up, ctx: m3.look_at(eye, target, up))
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
            from ..spectra import SRGB_E_TO_XYZ as _sRGB_E_to_XYZ
            from ..spectra import SRGB_TO_XYZ as _sRGB_to_XYZ

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
        return _refuse("Image2D")

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
             lambda path, matProc, meshProc, ctx: _refuse("load3DModel"))
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
        return _refuse("setEnvironment")

    env.define("setEnvironment", builtin(
        _sig([("path", str), ("scale", float, 1.0)], _set_environment)
    ))

    return env


def read_scene(path: str) -> tuple[SceneDesc, ApiContext]:
    """Parse + execute a scene file (reference readScene, API.cpp:84-97)."""
    scene = SceneDesc()
    ctx = ApiContext(scene, base_dir=os.path.dirname(os.path.abspath(path)))
    env = make_global_env(ctx)
    with open(path) as f:
        src = f.read()
    execute(src, env, ctx)
    return scene, ctx
