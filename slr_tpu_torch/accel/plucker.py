"""Closest hit over all triangles through Plücker edge tests, in matrix
products (counterpart of slr_tpu/accel/plucker.py): an oracle, with no
kernel of its own.

A ray (o, d) has Plücker coordinates r6 = [d, o x d]; a triangle edge
a -> b has e6 = [a x b, b - a]; the permuted inner product r6 . e6 says on
which side of the edge's line the ray passes. A ray meets a triangle when
the three sides agree in sign, and its t comes from the plane equation. A
chunk of triangles is tested with (R, 6) @ (6, 3C) and (R, 3) @ (3, C)
products, the running minimum carried from chunk to chunk; the winner's
barycentrics are then computed once by Möller-Trumbore.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.math3d import cross
from ..scene.types import Geometry
from .intersect import RAY_EPSILON, Hit, moller_trumbore

Tensor = torch.Tensor


class PluckerTris(NamedTuple):
    """Per-triangle tables, padded to whole chunks.

    edges: (n_chunks, 6, 3*chunk) edge Plücker 6-vectors, edge-major
    normals: (n_chunks, 3, chunk) geometric (unnormalized) normals
    d0: (n_chunks, chunk) plane offsets dot(n, p0)
    valid: (n_chunks, chunk) padding mask
    """

    edges: Tensor
    normals: Tensor
    d0: Tensor
    valid: Tensor

    @property
    def chunk(self) -> int:
        return self.edges.shape[-1] // 3


def build_plucker(geom: Geometry, chunk: int = 1024) -> PluckerTris:
    """The Plücker tables of the scene's triangles, built on the host and
    placed on the geometry's device."""
    pos = geom.positions.cpu().numpy()
    tri = geom.tri_vidx.cpu().numpy()
    p0, p1, p2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
    t = len(tri)
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t

    def edge6(a, b):
        return np.concatenate([np.cross(a, b), b - a], axis=-1)

    e = np.stack([edge6(p0, p1), edge6(p1, p2), edge6(p2, p0)], axis=1)
    n = np.cross(p1 - p0, p2 - p0)
    d0 = np.einsum("ij,ij->i", n, p0)
    valid = np.ones((t,), bool)
    if pad:
        e = np.concatenate([e, np.zeros((pad, 3, 6), e.dtype)])
        n = np.concatenate([n, np.zeros((pad, 3), n.dtype)])
        d0 = np.concatenate([d0, np.zeros((pad,), d0.dtype)])
        valid = np.concatenate([valid, np.zeros((pad,), bool)])
    # Column edge * chunk + tri inside a chunk.
    e = e.reshape(n_chunks, chunk, 3, 6).transpose(0, 3, 2, 1).reshape(
        n_chunks, 6, 3 * chunk)
    n = n.reshape(n_chunks, chunk, 3).transpose(0, 2, 1)
    dev = geom.positions.device
    return PluckerTris(
        edges=torch.as_tensor(e.astype(np.float32), device=dev),
        normals=torch.as_tensor(np.ascontiguousarray(n, np.float32),
                                device=dev),
        d0=torch.as_tensor(d0.reshape(n_chunks, chunk).astype(np.float32),
                           device=dev),
        valid=torch.as_tensor(valid.reshape(n_chunks, chunk), device=dev))


def intersect_plucker(geom: Geometry, pt: PluckerTris, o: Tensor, d: Tensor,
                      tmin=RAY_EPSILON, tmax=float("inf")) -> Hit:
    """Closest hit over all triangles; o, d (R, 3)."""
    r = o.shape[0]
    dev = o.device
    chunk = pt.chunk
    r6 = torch.cat([d, cross(o, d)], dim=-1)
    tmin = torch.broadcast_to(torch.as_tensor(tmin, dtype=torch.float32,
                                              device=dev), (r,))
    best_t = torch.broadcast_to(torch.as_tensor(
        tmax, dtype=torch.float32, device=dev), (r,)).clone()
    tmax0 = best_t.clone()
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    for c in range(pt.edges.shape[0]):
        sides = (r6 @ pt.edges[c]).reshape(r, 3, chunk)
        through = (sides >= 0.0).all(1) | (sides <= 0.0).all(1)
        n_dot_o = o @ pt.normals[c]
        n_dot_d = d @ pt.normals[c]
        denom_ok = n_dot_d.abs() > 1e-12
        t = (pt.d0[c][None, :] - n_dot_o) / torch.where(denom_ok, n_dot_d,
                                                         1.0)
        hit = (through & denom_ok & pt.valid[c][None, :]
               & (t >= tmin[:, None])
               & (t <= torch.minimum(tmax0, best_t)[:, None]))
        t = torch.where(hit, t, float("inf"))
        t_min, j = t.min(-1)
        closer = t_min < best_t
        best_t = torch.where(closer, t_min, best_t)
        best_tri = torch.where(closer, c * chunk + j, best_tri)
    mask = best_tri >= 0
    # The winners' barycentrics, one Möller-Trumbore per ray.
    vidx = geom.tri_vidx.to(torch.int64)[torch.clamp(best_tri, min=0)]
    p = geom.positions
    t_mt, b1, b2, _ = moller_trumbore(o, d, p[vidx[:, 0]], p[vidx[:, 1]],
                                      p[vidx[:, 2]], 0.0, float("inf"))
    b1 = torch.clamp(b1, 0.0, 1.0)
    b2 = torch.clamp(b2, 0.0, 1.0)
    return Hit(t=torch.where(mask, t_mt, float("inf")),
               tri=torch.where(mask, best_tri, -1), b0=1.0 - b1 - b2, b1=b1,
               mask=mask)
