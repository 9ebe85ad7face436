"""Host-side instance rows and the two-level node arena (counterpart of
slr_tpu/accel/instances.py).

Each instance is one row: the TRS decomposition of its world matrix at the
shutter's two ends, and the union over the shutter of its BLAS's transformed
local box (`build_instances`). The scene's casts go through the chunk
kernels (accel/traverse.py `extend_pallas_instanced`) and need nothing more.
`build_two_level` adds the reference's TLAS over the instances' motion
bounds and its BLAS node arena, which the lock-step two-level traversal
`accel/twolevel.py` `intersect_instances` walks: an oracle for the
instanced casts.
"""
from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass
class TwoLevel(Instances):
    """The instance rows plus the reference's two-level node arena.

    TLAS: a binary BVH whose leaves are instance ids (`tlas_prim`);
    interior child boxes in tlas_min / tlas_max, a leaf child's box is its
    instance's motion bounds. BLAS: every BLAS's BVH in one arena, child
    pointers arena-absolute, leaves `-(slot) - 1` into `blas_prim` (global
    triangle ids); `blas_root` (I,) is each instance's BLAS root (a leaf
    encoding for a one-triangle BLAS)."""

    tlas_min: torch.Tensor = None
    tlas_max: torch.Tensor = None
    tlas_left: torch.Tensor = None
    tlas_right: torch.Tensor = None
    tlas_prim: torch.Tensor = None
    blas_min: torch.Tensor = None
    blas_max: torch.Tensor = None
    blas_left: torch.Tensor = None
    blas_right: torch.Tensor = None
    blas_prim: torch.Tensor = None
    blas_root: torch.Tensor = None


def build_two_level(positions: np.ndarray, tri_vidx: np.ndarray,
                    blas_ranges: list[tuple[int, int]],
                    rows: list[tuple[int, np.ndarray, np.ndarray]]
                    ) -> TwoLevel:
    """`build_instances` plus the TLAS over the instances' motion bounds
    and the BLAS node arena (each BLAS's BVH from `lbvh.build_bvh`,
    re-based into one arena, local primitive ids made global)."""
    from .lbvh import build_bvh, build_bvh_boxes_np

    inst = build_instances(positions, tri_vidx, blas_ranges, rows)
    positions = np.asarray(positions, np.float32)
    tri_vidx = np.asarray(tri_vidx, np.int32)
    node_min, node_max, node_left, node_right, prim = [], [], [], [], []
    roots = []
    n_nodes = n_prims = 0
    for lo, hi in blas_ranges:
        if hi - lo == 1:
            roots.append(-n_prims - 1)
            prim.append(np.asarray([lo], np.int32))
            n_prims += 1
            continue
        bvh = build_bvh(positions, tri_vidx[lo:hi])
        nl = bvh.node_left.numpy().copy()
        nr = bvh.node_right.numpy().copy()
        for arr in (nl, nr):
            interior = arr >= 0
            arr[interior] += n_nodes
            leaf = ~interior
            arr[leaf] = -((-arr[leaf] - 1) + n_prims) - 1
        roots.append(n_nodes)
        node_min.append(bvh.node_min.numpy())
        node_max.append(bvh.node_max.numpy())
        node_left.append(nl)
        node_right.append(nr)
        prim.append(bvh.prim_order.numpy().astype(np.int32) + lo)
        n_nodes += len(nl)
        n_prims += len(bvh.prim_order)

    bmin, bmax = inst.inst_bmin.numpy(), inst.inst_bmax.numpy()
    if inst.num >= 2:
        tm, tx, tl, tr, order = build_bvh_boxes_np(bmin, bmax)
    else:
        # One instance: a root whose two children are the same leaf.
        tm, tx = bmin.reshape(1, 3), bmax.reshape(1, 3)
        tl = tr = np.asarray([-1], np.int32)
        order = np.asarray([0], np.int32)

    def cat(parts, shape, dtype):
        return torch.from_numpy(np.ascontiguousarray(
            np.concatenate(parts) if parts else np.zeros(shape, dtype),
            dtype))

    f32, i32 = np.float32, np.int32
    return TwoLevel(
        **{f.name: getattr(inst, f.name)
           for f in dataclasses.fields(Instances)},
        tlas_min=cat([tm], (1, 3), f32), tlas_max=cat([tx], (1, 3), f32),
        tlas_left=cat([tl], (1,), i32), tlas_right=cat([tr], (1,), i32),
        tlas_prim=cat([order], (1,), i32),
        blas_min=cat(node_min, (1, 3), f32),
        blas_max=cat(node_max, (1, 3), f32),
        blas_left=cat(node_left, (1,), i32),
        blas_right=cat(node_right, (1,), i32),
        blas_prim=cat(prim, (1,), i32),
        blas_root=torch.tensor([roots[bid] for bid, _, _ in rows],
                               dtype=torch.int32))
