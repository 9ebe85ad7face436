"""Rigid/affine transform utilities for animated instances (counterpart of
slr_tpu/core/transform.py).

An animated transform is its begin and end matrices decomposed into
translation, rotation quaternion and scale; at a ray's shutter fraction the
rotation is slerped and the rest lerped. The decomposition happens once on
the host at scene build (`decompose_trs`, numpy); the device side
interpolates per ray and applies the transform or its inverse on tensors,
never building a matrix.

Convention: M = T * R * S (scale first). A ray taken into instance space
keeps an unnormalized direction, so its parameter t stays the world one.
"""
from __future__ import annotations

import numpy as np
import torch

from .math3d import cross

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Host side (numpy, scene build)
# ---------------------------------------------------------------------------

def decompose_trs(m: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """4x4 -> (T (3,), R quat (4,) [x, y, z, w], S (3,)).

    Column-norm scale extraction (no shear: products of translate, rotate
    and scale). A mirrored matrix gets a negative S[0]."""
    m = np.asarray(m, np.float64)
    t = m[:3, 3].copy()
    a = m[:3, :3]
    s = np.linalg.norm(a, axis=0)
    s = np.where(s < 1e-12, 1e-12, s)
    if np.linalg.det(a) < 0:
        s[0] = -s[0]
    r = a / s[None, :]
    q = _quat_from_matrix(r)
    return t.astype(np.float32), q.astype(np.float32), s.astype(np.float32)


def _quat_from_matrix(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion [x, y, z, w] (Shepperd's method)."""
    tr = r[0, 0] + r[1, 1] + r[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([
            (r[2, 1] - r[1, 2]) / s,
            (r[0, 2] - r[2, 0]) / s,
            (r[1, 0] - r[0, 1]) / s,
            0.25 * s,
        ])
    i = int(np.argmax([r[0, 0], r[1, 1], r[2, 2]]))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (r[j, i] + r[i, j]) / s
    q[k] = (r[k, i] + r[i, k]) / s
    q[3] = (r[k, j] - r[j, k]) / s
    return q


def trs_to_matrix_np(t: np.ndarray, q: np.ndarray, s: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = _quat_to_matrix_np(q) * np.asarray(s)[None, :]
    m[:3, 3] = t
    return m


def _quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    x, y, z, w = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def motion_bounds_np(
    local_min: np.ndarray,
    local_max: np.ndarray,
    t0: tuple[np.ndarray, np.ndarray, np.ndarray],
    t1: tuple[np.ndarray, np.ndarray, np.ndarray],
    steps: int = 16,
) -> tuple[np.ndarray, np.ndarray]:
    """Union AABB of the transformed local box over the shutter, sampled
    at `steps` + 1 shutter fractions."""
    corners = np.array([
        [local_min[0] if (i & 1) == 0 else local_max[0],
         local_min[1] if (i & 2) == 0 else local_max[1],
         local_min[2] if (i & 4) == 0 else local_max[2]]
        for i in range(8)
    ], np.float32)
    lo = np.full(3, np.inf, np.float32)
    hi = np.full(3, -np.inf, np.float32)
    for k in range(steps + 1):
        f = k / steps
        t = (1 - f) * t0[0] + f * t1[0]
        q = _slerp_np(t0[1], t1[1], f)
        s = (1 - f) * t0[2] + f * t1[2]
        m = trs_to_matrix_np(t, q, s)
        p = corners @ m[:3, :3].T + m[:3, 3]
        lo = np.minimum(lo, p.min(axis=0))
        hi = np.maximum(hi, p.max(axis=0))
    return lo, hi


def _slerp_np(q0: np.ndarray, q1: np.ndarray, f: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = (1 - f) * q0 + f * q1
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - f) * th) * q0 + np.sin(f * th) * q1) / np.sin(th)


# ---------------------------------------------------------------------------
# Device side (tensors, batched per ray)
# ---------------------------------------------------------------------------

def quat_slerp(q0: Tensor, q1: Tensor, f: Tensor) -> Tensor:
    """Batched slerp; q*: (..., 4), f: (...,). Flips q1 onto q0's
    hemisphere and lerps where the two are nearly parallel."""
    d = (q0 * q1).sum(-1)
    q1 = torch.where(d[..., None] < 0, -q1, q1)
    d = d.abs()
    th = torch.acos(torch.clamp(d, -1.0, 1.0))
    sth = torch.clamp(torch.sin(th), min=1e-9)
    near = d > 0.9995
    w0 = torch.where(near, 1.0 - f, torch.sin((1.0 - f) * th) / sth)
    w1 = torch.where(near, f, torch.sin(f * th) / sth)
    q = w0[..., None] * q0 + w1[..., None] * q1
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate v (..., 3) by quaternion q (..., 4) [x, y, z, w]."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_conj(q: Tensor) -> Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def trs_at(t0_T, t0_R, t0_S, t1_T, t1_R, t1_S, f: Tensor):
    """Interpolated TRS at shutter fraction f (batched per ray)."""
    T = (1.0 - f)[..., None] * t0_T + f[..., None] * t1_T
    R = quat_slerp(t0_R, t1_R, f)
    S = (1.0 - f)[..., None] * t0_S + f[..., None] * t1_S
    return T, R, S


def trs_apply_point(T: Tensor, R: Tensor, S: Tensor, p: Tensor) -> Tensor:
    return quat_rotate(R, p * S) + T


def trs_apply_vector(T: Tensor, R: Tensor, S: Tensor, v: Tensor) -> Tensor:
    return quat_rotate(R, v * S)


def trs_apply_normal(T: Tensor, R: Tensor, S: Tensor, n: Tensor) -> Tensor:
    """Normals transform by the inverse transpose: R * S^-1 for M = T R S."""
    return quat_rotate(R, n / S)


def trs_inv_apply_point(T: Tensor, R: Tensor, S: Tensor, p: Tensor) -> Tensor:
    return quat_rotate(quat_conj(R), p - T) / S


def trs_inv_apply_vector(T: Tensor, R: Tensor, S: Tensor, v: Tensor) -> Tensor:
    return quat_rotate(quat_conj(R), v) / S
