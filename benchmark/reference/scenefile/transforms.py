"""The scene language's transform builtins as float32 4x4 matrices acting
on column vectors (reference builtin_transform.cpp)."""
from __future__ import annotations

import math

import numpy as np


def _m(rows) -> np.ndarray:
    out = np.eye(4, dtype=np.float64)
    out[:3, :3] = rows
    return out.astype(np.float32)


def translate(t) -> np.ndarray:
    out = np.eye(4, dtype=np.float32)
    out[:3, 3] = np.asarray(t, np.float32).reshape(3)
    return out


def scale(s) -> np.ndarray:
    return np.diag(np.append(np.asarray(s, np.float32).reshape(3),
                             np.float32(1.0))).astype(np.float32)


def rotate_axis(axis: str, angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    if axis == "x":
        return _m([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return _m([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return _m([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def rotate(angle: float, axis) -> np.ndarray:
    """Rotation by `angle` about `axis` (Rodrigues)."""
    a = np.asarray(axis, np.float64).reshape(3)
    x, y, z = a / np.linalg.norm(a)
    c, s = math.cos(angle), math.sin(angle)
    oc = 1.0 - c
    return _m([[c + x * x * oc, x * y * oc - z * s, x * z * oc + y * s],
               [y * x * oc + z * s, c + y * y * oc, y * z * oc - x * s],
               [z * x * oc - y * s, z * y * oc + x * s, c + z * z * oc]])


def look_at(eye, target, up) -> np.ndarray:
    """Camera-to-world: +z towards `target`, +y along `up`."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    u = np.asarray(up, np.float64)
    x = np.cross(u / np.linalg.norm(u), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    out = np.eye(4)
    out[:3, 0], out[:3, 1], out[:3, 2], out[:3, 3] = x, y, z, eye
    return out.astype(np.float32)
