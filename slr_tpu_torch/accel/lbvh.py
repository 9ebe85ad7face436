"""BVH builds on the host (counterpart of slr_tpu/accel/lbvh.py).

`build_bvh` makes the scene's BVH: by default the SBVH of the native
builder (`native/sbvh.cc`), else the Morton-presorted median-split LBVH of
`build_lbvh`. The traversal kernels do not walk this tree; the chunk tables
are cut from it (accel/traverse.py `_bvh_chunk_order`), so which tree is
built decides the tables, and the choice follows the reference's rules to
the letter.

Leaf encoding: child pointer < 0 means leaf `-(ptr) - 1`, an index into
`prim_order`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..scene.types import BVH

# The reference's lock-step traversal has a stack of this depth, and a tree
# whose depth + 2 reaches it falls back to the LBVH there. The port keeps
# the rule so that both packages cut their tables from the same tree.
MAX_STACK = 64


def _bvh(node_min, node_max, node_left, node_right, prim_order) -> BVH:
    return BVH(node_min=torch.from_numpy(np.asarray(node_min, np.float32)),
               node_max=torch.from_numpy(np.asarray(node_max, np.float32)),
               node_left=torch.from_numpy(np.asarray(node_left, np.int32)),
               node_right=torch.from_numpy(np.asarray(node_right, np.int32)),
               prim_order=torch.from_numpy(np.asarray(prim_order, np.int32)))


def build_bvh(positions: np.ndarray, tri_vidx: np.ndarray,
              method: str = "auto") -> BVH:
    """Build the scene BVH. `method`: "sbvh" (the native binned-SAH builder
    with spatial splits), "lbvh" (Morton median split) or "auto" (SBVH,
    unless n < 2 or the tree is too deep for MAX_STACK)."""
    if method not in ("auto", "sbvh", "lbvh"):
        raise ValueError(f"unknown BVH method {method!r}")
    if method != "lbvh" and len(tri_vidx) >= 2:
        from ..native import sbvh_build

        pos = np.asarray(positions, np.float32)
        tv = np.asarray(tri_vidx)
        t0 = time.perf_counter()
        res = sbvh_build(pos[tv[:, 0]], pos[tv[:, 1]], pos[tv[:, 2]])
        if res is not None and res.depth + 2 < MAX_STACK:
            from ..utils.metrics import log_build_stats

            log_build_stats(
                "sbvh", tris=len(tri_vidx), nodes=res.n_nodes,
                refs=res.n_refs, depth=res.depth,
                sah_cost=round(res.sah_cost, 2), budget_hit=res.budget_hit,
                seconds=round(time.perf_counter() - t0, 3))
            return _bvh(res.node_min, res.node_max, res.node_left,
                        res.node_right, res.prim_order)
        if method == "sbvh":
            raise RuntimeError("the SBVH build failed or is too deep")
    return build_lbvh(positions, tri_vidx)


def build_lbvh(positions: np.ndarray, tri_vidx: np.ndarray) -> BVH:
    """Median-split BVH over triangle centroids, Morton-presorted."""
    positions = np.asarray(positions)
    tri_vidx = np.asarray(tri_vidx)
    p0 = positions[tri_vidx[:, 0]]
    p1 = positions[tri_vidx[:, 1]]
    p2 = positions[tri_vidx[:, 2]]
    tri_min = np.minimum(np.minimum(p0, p1), p2)
    tri_max = np.maximum(np.maximum(p0, p1), p2)
    centroids = 0.5 * (tri_min + tri_max)
    n = len(tri_vidx)
    if n == 1:
        return _bvh(tri_min.reshape(1, 3), tri_max.reshape(1, 3), [-1], [-1],
                    [0])

    lo = centroids.min(axis=0)
    ext = np.maximum(centroids.max(axis=0) - lo, 1e-12)
    q = np.clip(((centroids - lo) / ext) * 1023.0, 0, 1023).astype(np.uint64)

    def expand_bits(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    morton = ((expand_bits(q[:, 0]) << 2) | (expand_bits(q[:, 1]) << 1)
              | expand_bits(q[:, 2]))
    order = np.argsort(morton, kind="stable").astype(np.int32)
    nodes = _median_split(tri_min[order], tri_max[order], centroids[order],
                          order)
    return _bvh(*nodes)


def _median_split(s_min, s_max, s_cent, order):
    """Iterative median split over sorted ranges, node ids in allocation
    order (children after their parent). Sorts the arrays in place."""
    n = len(order)
    node_min = np.zeros((n - 1, 3), np.float32)
    node_max = np.zeros((n - 1, 3), np.float32)
    node_left = np.zeros((n - 1,), np.int32)
    node_right = np.zeros((n - 1,), np.int32)
    next_id = [0]

    def alloc():
        i = next_id[0]
        next_id[0] += 1
        return i

    work = [(0, n, alloc())]
    while work:
        lo_i, hi_i, nid = work.pop()
        node_min[nid] = s_min[lo_i:hi_i].min(axis=0)
        node_max[nid] = s_max[lo_i:hi_i].max(axis=0)
        c = s_cent[lo_i:hi_i]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        local = np.argsort(c[:, axis], kind="stable")
        sel = np.arange(lo_i, hi_i)[local]
        s_min[lo_i:hi_i] = s_min[sel]
        s_max[lo_i:hi_i] = s_max[sel]
        s_cent[lo_i:hi_i] = s_cent[sel]
        order[lo_i:hi_i] = order[sel]
        mid = lo_i + (hi_i - lo_i) // 2
        if mid - lo_i == 1:
            node_left[nid] = -lo_i - 1
        else:
            cid = alloc()
            node_left[nid] = cid
            work.append((lo_i, mid, cid))
        if hi_i - mid == 1:
            node_right[nid] = -mid - 1
        else:
            cid = alloc()
            node_right[nid] = cid
            work.append((mid, hi_i, cid))
    return node_min, node_max, node_left, node_right, order


def build_bvh_boxes_np(
    bmin: np.ndarray, bmax: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Median-split BVH over arbitrary AABBs (n >= 2). Returns (node_min,
    node_max, node_left, node_right, order) in the BVH's flat layout."""
    n = len(bmin)
    if n < 2:
        raise ValueError("build_bvh_boxes_np needs at least two boxes")
    s_min = np.asarray(bmin, np.float32).copy()
    s_max = np.asarray(bmax, np.float32).copy()
    return _median_split(s_min, s_max, 0.5 * (s_min + s_max),
                         np.arange(n, dtype=np.int32))
