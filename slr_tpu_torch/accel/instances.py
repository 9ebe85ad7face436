"""Host-side instance rows (counterpart of the instance part of
slr_tpu/accel/instances.py).

Each instance is one row: the TRS decomposition of its world matrix at the
shutter's two ends, and the union over the shutter of its BLAS's transformed
local box. The reference also builds a TLAS over those bounds and a BLAS node
arena for its lock-step two-level traversal; the port casts through the
chunk kernels only (accel/traverse.py `extend_pallas_instanced`), so that
part is not built here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.transform import decompose_trs, motion_bounds_np
from ..scene.types import Instances


def build_instances(positions: np.ndarray, tri_vidx: np.ndarray,
                    blas_ranges: list[tuple[int, int]],
                    rows: list[tuple[int, np.ndarray, np.ndarray]]) -> Instances:
    """positions / tri_vidx: the whole geometry (instanced triangles in
    local space). blas_ranges: [lo, hi) triangle range per BLAS. rows:
    (blas_id, world matrix at shutter begin, ... at shutter end)."""
    positions = np.asarray(positions, np.float32)
    tri_vidx = np.asarray(tri_vidx, np.int32)
    local_bounds = []
    for lo, hi in blas_ranges:
        if hi - lo < 1:
            raise ValueError("a BLAS holds no triangle")
        p = positions[tri_vidx[lo:hi].reshape(-1)]
        local_bounds.append((p.min(axis=0), p.max(axis=0)))

    n = len(rows)
    if n < 1:
        raise ValueError("no instance rows")
    trs = [np.zeros((n, w), np.float32) for w in (3, 4, 3, 3, 4, 3)]
    inst_bmin = np.zeros((n, 3), np.float32)
    inst_bmax = np.zeros((n, 3), np.float32)
    for i, (bid, m0, m1) in enumerate(rows):
        tr0 = decompose_trs(m0)
        tr1 = decompose_trs(m1)
        for dst, src in zip(trs, tr0 + tr1):
            dst[i] = src
        lb = local_bounds[bid]
        static = np.allclose(np.asarray(m0), np.asarray(m1))
        inst_bmin[i], inst_bmax[i] = motion_bounds_np(
            lb[0], lb[1], tr0, tr1, steps=1 if static else 16)
    t0_T, t0_R, t0_S, t1_T, t1_R, t1_S = (torch.from_numpy(a) for a in trs)
    return Instances(t0_T=t0_T, t0_R=t0_R, t0_S=t0_S, t1_T=t1_T, t1_R=t1_R,
                     t1_S=t1_S, inst_bmin=torch.from_numpy(inst_bmin),
                     inst_bmax=torch.from_numpy(inst_bmax))
