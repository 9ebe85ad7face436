"""Ray-triangle intersection contract (counterpart of
slr_tpu/accel/intersect.py): hit records, the packed per-triangle shading
table, Möller-Trumbore, the brute-force closest-hit cast (the port's own
oracle) and surface-point resolution.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.math3d import cross, dot, normalize
from ..scene.types import Geometry

Tensor = torch.Tensor

RAY_EPSILON = 1e-4


class Hit(NamedTuple):
    t: Tensor        # (R,) hit distance (inf if miss)
    tri: Tensor      # (R,) int64 triangle id (-1 if miss)
    b0: Tensor       # (R,) barycentric of v0
    b1: Tensor       # (R,) barycentric of v1
    mask: Tensor     # (R,) bool
    inst: Tensor = None
    # The cast's own t (the traversal's, before the Möller-Trumbore
    # recomputation of `t`), inf on a miss: alpha recasts advance from it.
    t_cast: Tensor = None


class SurfacePoint(NamedTuple):
    p: Tensor
    gn: Tensor
    sn: Tensor
    tangent: Tensor
    bitangent: Tensor
    uv: Tensor
    mat_id: Tensor    # (R,) int64
    area_pdf: Tensor


# Packed per-triangle shading table, column layout:
#  0:3 p0 | 3:6 e01 | 6:9 e02 | 9:12 n0 | 12:15 n1 | 15:18 n2
# 18:21 t0 | 21:24 t1 | 24:27 t2 | 27:29 uv0 | 29:31 uv1 | 31:33 uv2
# 33 mat_id | 34 inv_area | 35 alpha_ftex | 36 ntex | 37:40 gn (normalized)
TRI_TABLE_COLS = 40


def build_tri_table(positions, normals, tangents, uvs, tri_vidx, tri_mat,
                    tri_alpha, tri_ntex) -> np.ndarray:
    """Host-side (numpy) construction of the packed per-triangle table."""
    p = np.asarray(positions, np.float32)
    n = np.asarray(normals, np.float32)
    tg = np.asarray(tangents, np.float32)
    uv = np.asarray(uvs, np.float32)
    v = np.asarray(tri_vidx, np.int64)
    t = v.shape[0]
    tab = np.zeros((max(t, 1), TRI_TABLE_COLS), np.float32)
    if t == 0:
        return tab
    p0, p1, p2 = p[v[:, 0]], p[v[:, 1]], p[v[:, 2]]
    e01, e02 = p1 - p0, p2 - p0
    gn = np.cross(e01, e02)
    nrm = np.linalg.norm(gn, axis=-1)
    area = 0.5 * nrm
    gn = gn / np.maximum(nrm, 1e-20)[:, None]
    tab[:, 0:3] = p0
    tab[:, 3:6] = e01
    tab[:, 6:9] = e02
    tab[:, 9:12] = n[v[:, 0]]
    tab[:, 12:15] = n[v[:, 1]]
    tab[:, 15:18] = n[v[:, 2]]
    tab[:, 18:21] = tg[v[:, 0]]
    tab[:, 21:24] = tg[v[:, 1]]
    tab[:, 24:27] = tg[v[:, 2]]
    tab[:, 27:29] = uv[v[:, 0]]
    tab[:, 29:31] = uv[v[:, 1]]
    tab[:, 31:33] = uv[v[:, 2]]
    tab[:, 33] = np.asarray(tri_mat, np.float32)
    tab[:, 34] = 1.0 / np.maximum(area, 1e-20)
    tab[:, 35] = np.asarray(tri_alpha, np.float32)
    tab[:, 36] = (np.asarray(tri_ntex, np.float32)
                  if tri_ntex is not None else -1.0)
    tab[:, 37:40] = gn
    return tab


class TriRow(NamedTuple):
    p0: Tensor
    e01: Tensor
    e02: Tensor
    n0: Tensor
    n1: Tensor
    n2: Tensor
    t0: Tensor
    t1: Tensor
    t2: Tensor
    uv0: Tensor
    uv1: Tensor
    uv2: Tensor
    mat_id: Tensor
    inv_area: Tensor
    alpha_id: Tensor
    ntex_id: Tensor
    gn: Tensor


def fetch_tri_row(table: Tensor, tri: Tensor) -> TriRow:
    """One row gather + slices. `tri` must already be clamped >= 0."""
    row = table[tri]
    return TriRow(
        p0=row[..., 0:3], e01=row[..., 3:6], e02=row[..., 6:9],
        n0=row[..., 9:12], n1=row[..., 12:15], n2=row[..., 15:18],
        t0=row[..., 18:21], t1=row[..., 21:24], t2=row[..., 24:27],
        uv0=row[..., 27:29], uv1=row[..., 29:31], uv2=row[..., 31:33],
        mat_id=row[..., 33].to(torch.int64),
        inv_area=row[..., 34],
        alpha_id=row[..., 35].to(torch.int64),
        ntex_id=row[..., 36].to(torch.int64),
        gn=row[..., 37:40],
    )


def moller_trumbore(o: Tensor, d: Tensor, p0: Tensor, p1: Tensor, p2: Tensor,
                    tmin, tmax) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Batched Möller-Trumbore; inputs broadcast. Returns (t, b1, b2, hit)."""
    e01 = p1 - p0
    e02 = p2 - p0
    pv = cross(d, e02)
    det = dot(e01, pv)
    inv_det = torch.where(det != 0.0,
                          1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tv = o - p0
    b1 = dot(tv, pv) * inv_det
    qv = cross(tv, e01)
    b2 = dot(d, qv) * inv_det
    t = dot(e02, qv) * inv_det
    hit = ((det != 0.0) & (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0)
           & (b1 + b2 <= 1.0) & (t >= tmin) & (t <= tmax))
    return t, b1, b2, hit


def intersect_brute(geom: Geometry, o: Tensor, d: Tensor,
                    tmin=RAY_EPSILON, tmax=float("inf"),
                    block: int = 512) -> Hit:
    """Closest hit over all triangles, one triangle block at a time."""
    n_tris = geom.num_tris
    r = o.shape[0]
    dev = o.device
    tmin = torch.broadcast_to(torch.as_tensor(tmin, dtype=torch.float32,
                                              device=dev), (r,))
    tmax = torch.broadcast_to(torch.as_tensor(tmax, dtype=torch.float32,
                                              device=dev), (r,))
    vidx = geom.tri_vidx.to(torch.int64)
    best_t = torch.full((r,), float("inf"), device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_b1 = torch.zeros((r,), device=dev)
    best_b2 = torch.zeros((r,), device=dev)
    for s0 in range(0, n_tris, block):
        ids = torch.arange(s0, min(s0 + block, n_tris), device=dev)
        v = vidx[ids]
        p0 = geom.positions[v[:, 0]][None]
        p1 = geom.positions[v[:, 1]][None]
        p2 = geom.positions[v[:, 2]][None]
        t, b1, b2, hit = moller_trumbore(o[:, None, :], d[:, None, :],
                                         p0, p1, p2, tmin[:, None],
                                         tmax[:, None])
        t = torch.where(hit, t, float("inf"))
        j = torch.argmin(t, dim=-1)
        t_min = torch.gather(t, 1, j[:, None])[:, 0]
        closer = t_min < best_t
        best_t = torch.where(closer, t_min, best_t)
        best_tri = torch.where(closer, ids[j], best_tri)
        best_b1 = torch.where(closer, torch.gather(b1, 1, j[:, None])[:, 0],
                              best_b1)
        best_b2 = torch.where(closer, torch.gather(b2, 1, j[:, None])[:, 0],
                              best_b2)
    return Hit(t=best_t, tri=best_tri, b0=1.0 - best_b1 - best_b2,
               b1=best_b1, mask=best_tri >= 0)


def _finish_surface_point(p, gn, n0, n1, n2, t0, t1, t2, uv0, uv1, uv2,
                          mat_id, area_pdf, b0, b1) -> SurfacePoint:
    """Barycentric shading normal/tangent with re-orthogonalization."""
    b2 = 1.0 - b0 - b1
    sn = normalize(b0 * n0 + b1 * n1 + b2 * n2)
    tangent = normalize(b0 * t0 + b1 * t1 + b2 * t2)
    dot_nt = dot(sn, tangent)
    tangent = torch.where((dot_nt.abs() >= 0.01)[..., None],
                          normalize(tangent - dot_nt[..., None] * sn),
                          tangent)
    return SurfacePoint(p=p, gn=gn, sn=sn, tangent=tangent,
                        bitangent=cross(sn, tangent),
                        uv=b0 * uv0 + b1 * uv1 + b2 * uv2,
                        mat_id=mat_id, area_pdf=area_pdf)


def resolve_surface_point(geom: Geometry, hit: Hit, o: Tensor,
                          d: Tensor) -> SurfacePoint:
    tri = torch.clamp(hit.tri, min=0)
    b0 = hit.b0[..., None]
    b1 = hit.b1[..., None]
    t_safe = torch.where(hit.mask, hit.t, 1.0)
    p = o + d * t_safe[..., None]
    r = fetch_tri_row(geom.tri_table, tri)
    return _finish_surface_point(p, r.gn, r.n0, r.n1, r.n2, r.t0, r.t1, r.t2,
                                 r.uv0, r.uv1, r.uv2, r.mat_id, r.inv_area,
                                 b0, b1)


def sample_triangle_point(geom: Geometry, tri: Tensor, u0: Tensor,
                          u1: Tensor) -> SurfacePoint:
    """Uniform area sampling on triangles `tri` (R,)."""
    from ..core.sampling import uniform_sample_triangle

    b0, b1 = uniform_sample_triangle(u0, u1)
    b0 = b0[..., None]
    b1 = b1[..., None]
    b2 = 1.0 - b0 - b1
    r = fetch_tri_row(geom.tri_table, tri)
    p = r.p0 + b1 * r.e01 + b2 * r.e02
    return _finish_surface_point(p, r.gn, r.n0, r.n1, r.n2, r.t0, r.t1, r.t2,
                                 r.uv0, r.uv1, r.uv2, r.mat_id, r.inv_area,
                                 b0, b1)


def any_hit_brute(geom: Geometry, o: Tensor, d: Tensor, tmin, tmax,
                  block: int = 512) -> Tensor:
    """Shadow-ray occlusion over every triangle: (R,) bool, True where a
    triangle lies in [tmin, tmax] (an oracle for the any-hit cast)."""
    return intersect_brute(geom, o, d, tmin, tmax, block).mask
