"""Vector math over SoA tensors of 3-vectors (counterpart of
slr_tpu/core/math3d.py). Every function takes tensors whose last axis has
size 3, so a "vector" is `(..., 3)` and whole wavefronts are processed at once.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

_TINY = torch.finfo(torch.float32).tiny


def dot(a: Tensor, b: Tensor) -> Tensor:
    """Batched dot product over the last axis (explicit components for
    3-vectors, in the reference's summation order)."""
    if a.shape[-1] == 3 or b.shape[-1] == 3:
        return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
                + a[..., 2] * b[..., 2])
    return (a * b).sum(-1)


def absdot(a: Tensor, b: Tensor) -> Tensor:
    return dot(a, b).abs()


def cross(a: Tensor, b: Tensor) -> Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def length2(a: Tensor) -> Tensor:
    return dot(a, a)


def length(a: Tensor) -> Tensor:
    return torch.sqrt(length2(a))


def normalize(a: Tensor, eps: float = 0.0) -> Tensor:
    """Normalize over the last axis; `eps` guards the zero vector."""
    n2 = length2(a)
    inv = torch.rsqrt(torch.clamp(n2, min=eps if eps > 0 else _TINY))
    return a * inv[..., None]


def vec3(x, y, z, dtype=torch.float32) -> Tensor:
    return torch.stack([torch.as_tensor(x, dtype=dtype),
                        torch.as_tensor(y, dtype=dtype),
                        torch.as_tensor(z, dtype=dtype)], dim=-1)


def reflect(v: Tensor, n: Tensor) -> Tensor:
    """Mirror `v` about normal `n` (both pointing away from the surface)."""
    return 2.0 * dot(v, n)[..., None] * n - v


def distance(a: Tensor, b: Tensor) -> Tensor:
    return length(b - a)


# ---------------------------------------------------------------------------
# 4x4 homogeneous transforms (scene building; float32 like the reference)
# ---------------------------------------------------------------------------

def _f32(x) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def mat_identity(dtype=torch.float32) -> Tensor:
    return torch.eye(4, dtype=dtype)


def mat_translate(t) -> Tensor:
    m = torch.eye(4, dtype=torch.float32)
    m[:3, 3] = _f32(t)
    return m


def mat_scale(s) -> Tensor:
    s = torch.broadcast_to(_f32(s), (3,))
    return torch.diag(torch.cat([s, torch.ones(1)]))


def _rot(axis: int, angle: Tensor) -> Tensor:
    c = torch.cos(angle)
    s = torch.sin(angle)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m = torch.eye(4, dtype=torch.float32)
    m[i, i] = c
    m[i, j] = -s
    m[j, i] = s
    m[j, j] = c
    return m


def mat_rotate_x(angle) -> Tensor:
    return _rot(0, _f32(angle))


def mat_rotate_y(angle) -> Tensor:
    return _rot(1, _f32(angle))


def mat_rotate_z(angle) -> Tensor:
    return _rot(2, _f32(angle))


def mat_rotate(angle, axis) -> Tensor:
    """Rodrigues rotation about an arbitrary axis."""
    a = normalize(_f32(axis))
    x, y, z = a[0], a[1], a[2]
    angle = _f32(angle)
    c, s = torch.cos(angle), torch.sin(angle)
    oc = 1.0 - c
    m3 = torch.stack([
        torch.stack([c + x * x * oc, x * y * oc - z * s, x * z * oc + y * s]),
        torch.stack([y * x * oc + z * s, c + y * y * oc, y * z * oc - x * s]),
        torch.stack([z * x * oc - y * s, z * y * oc + x * s, c + z * z * oc]),
    ])
    m = torch.eye(4, dtype=torch.float32)
    m[:3, :3] = m3
    return m


def mat_look_at(eye, target, up) -> Tensor:
    """Camera-to-world matrix."""
    eye = _f32(eye)
    z = normalize(_f32(target) - eye)
    x = normalize(cross(normalize(_f32(up)), z))
    y = cross(z, x)
    m = torch.eye(4, dtype=torch.float32)
    m[:3, 0] = x
    m[:3, 1] = y
    m[:3, 2] = z
    m[:3, 3] = eye
    return m


def transform_point(m: Tensor, p: Tensor) -> Tensor:
    """Apply 4x4 `m` to points `(..., 3)`."""
    return p @ m[:3, :3].T + m[:3, 3]


def transform_vector(m: Tensor, v: Tensor) -> Tensor:
    return v @ m[:3, :3].T


def transform_normal(m_inv: Tensor, n: Tensor) -> Tensor:
    """Transform normals with the inverse-transpose: pass the inverse."""
    return n @ m_inv[:3, :3]


# ---------------------------------------------------------------------------
# Orthonormal frames
# ---------------------------------------------------------------------------

def onb_from_z(z: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Right-handed orthonormal basis around unit z (branchless Frisvad /
    Duff et al. 2017). Returns (x, y, z), each (..., 3)."""
    zz = z[..., 2]
    sign = torch.where(zz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + zz)
    b = z[..., 0] * z[..., 1] * a
    x = torch.stack(
        [1.0 + sign * z[..., 0] * z[..., 0] * a, sign * b, -sign * z[..., 0]],
        dim=-1)
    y = torch.stack([b, sign + z[..., 1] * z[..., 1] * a, -z[..., 1]], dim=-1)
    return x, y, z


def frame_to_local(x: Tensor, y: Tensor, z: Tensor, v: Tensor) -> Tensor:
    """World -> frame-local coordinates (z is the shading normal axis)."""
    return torch.stack([dot(v, x), dot(v, y), dot(v, z)], dim=-1)


def frame_from_local(x: Tensor, y: Tensor, z: Tensor, v: Tensor) -> Tensor:
    return v[..., 0:1] * x + v[..., 1:2] * y + v[..., 2:3] * z


def spherical_direction(sin_theta: Tensor, cos_theta: Tensor,
                        phi: Tensor) -> Tensor:
    return torch.stack([sin_theta * torch.cos(phi),
                        sin_theta * torch.sin(phi), cos_theta], dim=-1)
