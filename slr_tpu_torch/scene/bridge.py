"""Carry a reference `FlatScene` into the port, so both packages render the
same arrays in the tests.

`from_reference` walks the reference scene's fields by name — its tables are
dataclasses (flax struct nodes) or NamedTuples — and builds the port's
tables from them: each array leaf becomes a tensor via numpy, static fields
are copied. An instanced scene comes across whole: the extended chunk
table (`entry_inst`, `inst_trs`; the port derives `tri24`, `n_valid`,
`cast_boxes` and the `instanced` flag), the `Instances` rows (the
reference's TLAS / BLAS node arena comes across with `cls=TwoLevel`, for
the two-level oracle) and `n_static`.
It imports nothing of the reference package or of JAX; any object with the
same field names works.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.traverse import PallasTris
from ..core.sampling import Continuous2D, Discrete1D
from . import types as T

# Port table type of each nested field, by (parent type, field name).
_NESTED = {
    (T.FlatScene, "geometry"): T.Geometry,
    (T.FlatScene, "materials"): T.Materials,
    (T.FlatScene, "stex"): T.SpectrumTextures,
    (T.FlatScene, "ftex"): T.FloatTextures,
    (T.FlatScene, "lights"): T.Lights,
    (T.FlatScene, "env"): T.EnvLight,
    (T.FlatScene, "camera"): T.Camera,
    (T.FlatScene, "bvh"): T.BVH,
    (T.FlatScene, "pallas_tris"): PallasTris,
    (T.FlatScene, "ntex"): T.NormalTextures,
    (T.FlatScene, "instances"): T.Instances,
    (T.Lights, "dist"): Discrete1D,
    (T.EnvLight, "dist"): Continuous2D,
}

# Fields that are static metadata in the reference (not array leaves).
_STATIC = {"n_static", "lobe_kinds_present", "has_env", "has_alpha",
           "has_normal_map", "super_boxes_blob", "spectral", "has_checker",
           "has_voronoi", "has_curve", "has_const", "has_image",
           "has_one_minus"}

# Port-only fields the port derives itself.
_DERIVED = {(PallasTris, "tri24"), (PallasTris, "n_valid"),
            (PallasTris, "instanced"), (PallasTris, "cast_boxes")}


def _field_names(cls) -> list[str]:
    if dataclasses.is_dataclass(cls):
        return [f.name for f in dataclasses.fields(cls) if f.init]
    return list(cls._fields)


def _leaf(x, device) -> torch.Tensor | None:
    if x is None:
        return None
    return torch.as_tensor(np.array(np.asarray(x)), device=device)


def _convert(src, cls, device):
    kwargs = {}
    for name in _field_names(cls):
        if (cls, name) in _DERIVED or not hasattr(src, name):
            continue
        val = getattr(src, name)
        nested = _NESTED.get((cls, name))
        if nested is not None:
            kwargs[name] = None if val is None else _convert(val, nested, device)
        elif name in _STATIC:
            kwargs[name] = val
        elif cls is T.Camera and name == "kind":      # a static int there
            kwargs[name] = int(val)
        elif name == "plucker":
            kwargs[name] = None          # the port has no Plücker-matmul path
        else:
            kwargs[name] = _leaf(val, device)
    return cls(**kwargs)


def from_reference(flat_scene, device="cpu", cls=None):
    """The reference `FlatScene` (or any nested dataclass / NamedTuple of
    arrays with the same field names) as the port's FlatScene on `device`;
    with `cls`, any one reference table as that port table (e.g. the
    reference's `Instances` with its node arena as accel/instances.py
    `TwoLevel`)."""
    return _convert(flat_scene, cls or T.FlatScene, torch.device(device))
