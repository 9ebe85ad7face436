"""BVH builds on the host, and a lock-step stack traversal of the BVH
(counterpart of slr_tpu/accel/lbvh.py).

`build_bvh` makes the scene's BVH: by default the SBVH of the native
builder (`native/sbvh.cc`), else the Morton-presorted median-split LBVH of
`build_lbvh`. The traversal kernels do not walk this tree; the chunk tables
are cut from it (accel/traverse.py `_bvh_chunk_order`), so which tree is
built decides the tables, and the choice follows the reference's rules to
the letter.

Leaf encoding: child pointer < 0 means leaf `-(ptr) - 1`, an index into
`prim_order`.

`intersect_bvh` walks the tree for every ray at once (one stack per ray,
one node per ray and step): the reference's oracle for the chunk
traversal, with no kernel of its own.
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


def _slab_test(bmin, bmax, o, inv_d, tmin, tmax):
    """AABB slab test of (R, 3) boxes: (hit, near distance)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = torch.minimum(t0, t1).amax(-1)
    tfar = torch.maximum(t0, t1).amin(-1)
    return (tnear <= tfar) & (tfar >= tmin) & (tnear <= tmax), tnear


def _push(stack, sp, value, mask):
    """Push `value` on the stacks of the rays in `mask`."""
    idx = torch.clamp(sp, max=MAX_STACK - 1)
    pushed = stack.scatter(1, idx[:, None], value[:, None].to(stack.dtype))
    stack = torch.where(mask[:, None], pushed, stack)
    return stack, torch.where(mask, torch.clamp(sp + 1, max=MAX_STACK), sp)


def intersect_bvh(geom, bvh: BVH, o: torch.Tensor, d: torch.Tensor,
                  tmin=1e-4, tmax=float("inf")):
    """Closest hit by a lock-step stack traversal of `bvh`; o, d (R, 3).
    Children are visited near first; a leaf child's box is its triangle's
    bounds. Returns an accel/intersect.py `Hit`."""
    from .intersect import Hit, moller_trumbore

    r = o.shape[0]
    dev = o.device
    tmin = torch.broadcast_to(torch.as_tensor(tmin, dtype=torch.float32,
                                              device=dev), (r,))
    best_t = torch.broadcast_to(torch.as_tensor(
        tmax, dtype=torch.float32, device=dev), (r,)).clone()
    inv_d = 1.0 / torch.where(d.abs() < 1e-20,
                              torch.where(d >= 0, 1e-20, -1e-20), d)
    sorted_tri = bvh.prim_order.to(torch.int64)
    vidx = geom.tri_vidx.to(torch.int64)
    v0, v1, v2 = (geom.positions[vidx[:, k]] for k in range(3))
    left_of = bvh.node_left.to(torch.int64)
    right_of = bvh.node_right.to(torch.int64)

    stack = torch.zeros((r, MAX_STACK), dtype=torch.int64, device=dev)
    sp = torch.ones((r,), dtype=torch.int64, device=dev)  # root pushed
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_b1 = torch.zeros((r,), device=dev)
    best_b2 = torch.zeros((r,), device=dev)

    def child_box(c):
        leaf_tri = sorted_tri[torch.clamp(-c - 1, min=0)]
        tp = torch.stack([v0[leaf_tri], v1[leaf_tri], v2[leaf_tri]], dim=1)
        node = torch.clamp(c, min=0)
        leaf = (c < 0)[:, None]
        return (torch.where(leaf, tp.amin(1), bvh.node_min[node]),
                torch.where(leaf, tp.amax(1), bvh.node_max[node]))

    while bool((sp > 0).any()):
        active = sp > 0
        top = torch.clamp(sp - 1, min=0)[:, None]
        entry = torch.gather(stack, 1, top)[:, 0]
        sp = torch.where(active, sp - 1, sp)

        is_leaf = entry < 0
        tri = sorted_tri[torch.clamp(-entry - 1, min=0)]
        t, b1, b2, hit = moller_trumbore(o, d, v0[tri], v1[tri], v2[tri],
                                         tmin, best_t)
        take = active & is_leaf & hit & (t < best_t)
        best_t = torch.where(take, t, best_t)
        best_tri = torch.where(take, tri, best_tri)
        best_b1 = torch.where(take, b1, best_b1)
        best_b2 = torch.where(take, b2, best_b2)

        node = torch.clamp(entry, min=0)
        left, right = left_of[node], right_of[node]
        lmin, lmax = child_box(left)
        rmin, rmax = child_box(right)
        lhit, lnear = _slab_test(lmin, lmax, o, inv_d, tmin, best_t)
        rhit, rnear = _slab_test(rmin, rmax, o, inv_d, tmin, best_t)
        interior = active & ~is_leaf
        lhit = interior & lhit
        rhit = interior & rhit
        near_left = lnear <= rnear
        first = torch.where(near_left, left, right)
        second = torch.where(near_left, right, left)
        # Far first, so that the near child pops first.
        stack, sp = _push(stack, sp, second,
                          torch.where(near_left, rhit, lhit))
        stack, sp = _push(stack, sp, first,
                          torch.where(near_left, lhit, rhit))
    mask = best_tri >= 0
    return Hit(t=torch.where(mask, best_t, float("inf")), tri=best_tri,
               b0=1.0 - best_b1 - best_b2, b1=best_b1, mask=mask)
