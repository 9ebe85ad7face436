"""Worklist-driven closest-hit and any-hit casts (counterpart of
slr_tpu/accel/pallas_intersect.py).

The chunk tables keep the reference's layout (`PallasTris`, built on the
host), so the two packages' tables compare leaf by leaf: treelets cut from
the scene's SBVH (`_bvh_chunk_order`), whose boxes are the subtrees' node
boxes, or Morton slices. The casts follow
the reference's wrappers `intersect_pallas` / `anyhit_pallas`: per-ray
ranges with inert inactive lanes, the scene-exit clamp of tmax, packed rays,
per-block culled near-sorted worklists, then the traversal, then slot remap
and Möller-Trumbore barycentrics.

`prepare_cast` builds the ranges, packed rays and worklists: on CUDA tensors
in one launch of the hand-written worklist kernel (`build_worklists`), on
CPU tensors with plain tensor ops (`prepare_cast_plain`, the reference
wrappers' steps), which give the same values. The traversal is
`closest_hit` / `any_hit`: on CUDA tensors they launch the hand-written
kernels of `csrc/traverse.cu`; on CPU tensors they run their plain PyTorch
versions (`closest_hit_plain` / `any_hit_plain`), which walk the same
worklists with the same arithmetic in the same order. A CUDA tensor never
takes a plain path.

Instanced scenes ride the same tables: after the static chunks come the
local-space chunks of each BLAS, and after the static entries one entry per
(instance, BLAS chunk) whose box is the instance's world-space motion-union
box (`extend_pallas_instanced`). For such an entry the kernels take each
lane's ray into the instance's local space at the lane's shutter fraction
(`xform_rays`, the counterpart of the reference's in-kernel `_xform_rays`)
before the triangle tests; boxes, bounds and t stay in world space.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core.math3d import cross
from ..core.transform import (
    decompose_trs,
    motion_bounds_np,
    trs_at,
    trs_inv_apply_point,
    trs_inv_apply_vector,
)
from ..utils.metrics import traced
from .intersect import RAY_EPSILON, Hit, moller_trumbore

Tensor = torch.Tensor

RB = 256
DEFAULT_CHUNK = 128
ROWS = 16
T_FAR = 3e38
KCOLS = 24     # kernel row per triangle: e0(6) e1(6) e2(6) n(3) d0 pad pad
MAX_CHUNK = 128

# Kernel launches since the last reset, by kernel name: each wrapper adds
# one where it launches its kernel. The plain versions do not count.
# `xform_rays` is the transform launched on its own; the casts never do
# that (inside the traversal kernels it is a device function, whose work
# `track_work` counts). `worklist` is the worklist build of a cast;
# `worklist_tensor_sort` counts those of its launches whose table had more
# entries than the kernel sorts (WORKLIST_MAX_SORT), sorted by tensor code.
LAUNCHES = {"closest_hit": 0, "any_hit": 0, "xform_rays": 0, "worklist": 0,
            "worklist_tensor_sort": 0}

# Work the casts' kernels needed since `track_work(device)`, counted on the
# device by the kernels themselves: int64 [closest-hit tests, closest-hit
# transforms, any-hit tests, any-hit transforms]. None: not tracked.
WORK: Tensor | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def track_work(device=None) -> None:
    """Start (a device) or stop (None) counting, in `WORK`, the ray-triangle
    tests and instance transforms that the casts' rays need. CUDA only: the
    plain versions count nothing."""
    global WORK
    WORK = None if device is None else torch.zeros(4, dtype=torch.int64,
                                                   device=device)


def _work_counters(rays: Tensor):
    if WORK is None or rays.device.type != "cuda":
        return None, None
    return (torch.zeros(rays.shape[0], dtype=torch.int32, device=rays.device),
            torch.zeros(rays.shape[0], dtype=torch.int32, device=rays.device))


def _add_work(at: int, tests: Tensor | None, xforms: Tensor | None) -> None:
    if tests is not None:
        WORK[at] += tests.sum()
        WORK[at + 1] += xforms.sum()


# ---------------------------------------------------------------------------
# Chunk tables
# ---------------------------------------------------------------------------

def kernel_tris(tris: Tensor, chunk: int) -> Tensor:
    """(NC, 16, >=5C) reference chunk tables -> (NC, C, 24) kernel rows
    [e0(6) e1(6) e2(6) n(3) d0 0 0]. Column `col*C + slot` of the reference
    layout holds triangle `slot`'s column `col` (edges 0-2, n.d, num)."""
    nc = tris.shape[0]
    cols = [tris[:, 0:6, 0:chunk], tris[:, 0:6, chunk:2 * chunk],
            tris[:, 0:6, 2 * chunk:3 * chunk], tris[:, 0:3, 3 * chunk:4 * chunk],
            tris[:, 9:10, 4 * chunk:5 * chunk],
            torch.zeros((nc, 2, chunk), dtype=tris.dtype, device=tris.device)]
    return torch.cat(cols, dim=1).transpose(1, 2).contiguous()


@dataclasses.dataclass
class PallasTris:
    """Triangle chunk tables (reference layout) plus the kernels' compact
    per-triangle rows.

    tris:  (NC, 16, 5C') f32 Plücker chunk tables (C' >= C, zero padded)
    boxes: (NE, 8) f32 per-entry AABB + nonempty flag
    remap: (NC*C,) int32 kernel slot -> triangle id (-1 = padding)
    entry_chunk / entry_inst: (NE,) int32 chunk and instance per entry
    inst_trs: (I, 24) f32 instance transforms (instanced scenes only)
    tri24: (NC, C, 24) f32 derived kernel rows (see `kernel_tris`)
    n_valid: (NC,) int32 derived: the triangles each chunk holds, which
        fill its first slots (the rest is zero padding)
    instanced: whether any entry is instanced (host flag, set at build)
    cast_boxes: (NE, 8) f32 derived: the boxes the casts cull with, `boxes`
        with each moving instance's entries widened (see `motion_slack`)
    """

    tris: Tensor
    boxes: Tensor
    remap: Tensor
    entry_chunk: Tensor = None
    entry_inst: Tensor = None
    inst_trs: Tensor = None
    tri24: Tensor = None
    n_valid: Tensor = None
    instanced: bool = None
    cast_boxes: Tensor = None

    def __post_init__(self):
        if self.entry_chunk is None:
            self.entry_chunk = torch.arange(self.n_chunks, dtype=torch.int32,
                                            device=self.tris.device)
        if self.entry_inst is None:
            self.entry_inst = torch.full((self.n_chunks,), -1,
                                         dtype=torch.int32,
                                         device=self.tris.device)
        if self.instanced is None:
            self.instanced = bool((self.entry_inst >= 0).any())
        if self.tri24 is None:
            self.tri24 = kernel_tris(self.tris, self.chunk)
        if self.n_valid is None:
            self.n_valid = (self.remap.reshape(self.n_chunks, -1) >= 0).sum(
                1, dtype=torch.int32)
        if self.cast_boxes is None:
            self.cast_boxes = self.boxes
            if self.instanced:
                slack = motion_slack(self.boxes, self.entry_inst,
                                     self.inst_trs)
                self.cast_boxes = torch.cat(
                    [self.boxes[:, 0:3] - slack[:, None],
                     self.boxes[:, 3:6] + slack[:, None], self.boxes[:, 6:]],
                    dim=1)

    @property
    def chunk(self) -> int:
        return self.remap.shape[0] // self.tris.shape[0]

    @property
    def n_chunks(self) -> int:
        return self.tris.shape[0]

    @property
    def n_entries(self) -> int:
        return self.boxes.shape[0]


def motion_slack(boxes: Tensor, entry_inst: Tensor,
                 inst_trs: Tensor, steps: int = 16) -> Tensor:
    """(NE,) f32: how far an entry's triangles can stray out of its box.

    The box of a moving instance's entry is the union of its local box's
    corners transformed at `steps` + 1 shutter fractions (`steps` = 1 for an
    instance whose two transforms are nearly equal). Between two of them a
    corner moves along p(f) = T(f) + R(f) (S(f) * c), with T and S linear
    and R a slerp at angular speed w = 2 theta; its chord lies in the box,
    and it strays from the chord by at most h^2 / 8 max|p''| for a step h,
    with |p''| <= w^2 |S c| + 2 w |(S1 - S0) c|. |S c| is at most the
    distance from T0 or T1 to the box's farthest corner, |(S1 - S0) c| that
    from T0 times the largest relative change of scale. A ray that misses
    the box so widened misses the triangles at every shutter fraction.
    Entries of static instances and of the static triangles get 0.
    Computed in float64, rounded up, plus 1e-6 (1 + the box's largest
    coordinate) for the float32 rounding of the widened faces."""
    inst = entry_inst.to(torch.int64)
    row = inst_trs[torch.clamp(inst, min=0)].to(torch.float64)
    box = boxes[:, 0:6].to(torch.float64)
    t0, s0, t1, s1 = row[:, 0:3], row[:, 7:10], row[:, 10:13], row[:, 17:20]
    w = 2.0 * row[:, 20]
    sel = torch.tensor([[(i >> a) & 1 for a in range(3)] for i in range(8)],
                       dtype=torch.bool, device=boxes.device)
    corners = torch.where(sel[None], box[:, None, 3:6], box[:, None, 0:3])
    d0 = (corners - t0[:, None]).norm(dim=-1).amax(1)
    d1 = (corners - t1[:, None]).norm(dim=-1).amax(1)
    rel = ((s1 - s0).abs() / s0.abs()).amax(1)
    top = w * w * torch.maximum(d0, d1) + 2.0 * w * rel * d0
    floor = 1e-6 * (1.0 + box.abs().amax(1))
    one_step = top / 8.0
    slack = torch.where(one_step <= floor, one_step, top / (8.0 * steps ** 2))
    slack = torch.nan_to_num(slack * (1.0 + 1e-3) + floor, nan=float("inf"))
    moving = (inst >= 0) & (row[:, 0:10] != row[:, 10:20]).any(1)
    return torch.where(moving, slack, 0.0).to(torch.float32)


def build_super_boxes(boxes: np.ndarray, g: int = 16,
                      small: int = 48) -> np.ndarray:
    """Union AABBs over groups of `g` consecutive entries; small tables keep
    per-entry granularity."""
    b = np.asarray(boxes, np.float32)
    ne = b.shape[0]
    if ne <= small:
        return b.copy()
    ns = -(-ne // g)
    sup = np.zeros((ns, 8), np.float32)
    for i in range(ns):
        grp = b[i * g:(i + 1) * g]
        val = grp[:, 6] > 0.5
        if val.any():
            sup[i, 0:3] = grp[val, 0:3].min(axis=0)
            sup[i, 3:6] = grp[val, 3:6].max(axis=0)
            sup[i, 6] = 1.0
    return sup


def _safe_inv(d: Tensor) -> Tensor:
    return 1.0 / torch.where(d.abs() < 1e-20,
                             torch.where(d >= 0, 1e-20, -1e-20), d)


def nearest_super_tn(o: Tensor, d: Tensor, super_boxes: Tensor) -> Tensor:
    """Per-ray near distance (>= 0) of the nearest slab-hit super box;
    T_FAR when the ray misses all of them."""
    ot, dt = o.T, d.T
    inv = _safe_inv(dt)
    ns, r = super_boxes.shape[0], o.shape[0]
    tn = torch.full((ns, r), -T_FAR, device=o.device)
    tf = torch.full((ns, r), T_FAR, device=o.device)
    for a in range(3):
        t0 = (super_boxes[:, a][:, None] - ot[a][None, :]) * inv[a][None, :]
        t1 = (super_boxes[:, 3 + a][:, None] - ot[a][None, :]) * inv[a][None, :]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    ok = (tn <= tf) & (tf >= 0.0) & (super_boxes[:, 6][:, None] > 0.5)
    return torch.where(ok, torch.clamp(tn, min=0.0), T_FAR).amin(0)


def _morton_order(cent: np.ndarray) -> np.ndarray:
    lo = cent.min(axis=0)
    ext = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = np.clip((cent - lo) / ext * 1023.0, 0, 1023).astype(np.uint64)

    def expand(v):
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    code = (expand(q[:, 0]) << np.uint64(2)) | (expand(q[:, 1]) << np.uint64(1)) \
        | expand(q[:, 2])
    return np.argsort(code, kind="stable").astype(np.int32)


def chunk_table_rows(pos: np.ndarray, tri: np.ndarray, chunk_tris: list,
                     chunk: int = DEFAULT_CHUNK) -> tuple:
    """Chunk-table packing shared by static and BLAS chunks: a list of
    triangle-id arrays -> (tris (NC, 16, 5C'), AABBs (NC, 6), remap
    (NC*C,)). Padding slots hold zero geometry, so n.d = 0 rejects them."""
    nc = len(chunk_tris)
    slot_tri = np.zeros((nc, chunk), np.int64)
    slot_valid = np.zeros((nc, chunk), bool)
    boxes = np.zeros((nc, 6), np.float32)
    for c, ids in enumerate(chunk_tris):
        k = len(ids)
        slot_tri[c, :k] = ids
        slot_valid[c, :k] = True
        if k:
            pts = pos[tri[np.asarray(ids, np.int64)].reshape(-1)]
            boxes[c, 0:3] = pts.min(axis=0)
            boxes[c, 3:6] = pts.max(axis=0)

    flat_tri = slot_tri.reshape(-1)
    p0 = pos[tri[flat_tri, 0]]
    p1 = pos[tri[flat_tri, 1]]
    p2 = pos[tri[flat_tri, 2]]
    v = slot_valid.reshape(-1)
    p0[~v] = 0.0
    p1[~v] = 0.0
    p2[~v] = 0.0

    def edge6(a, b):
        return np.concatenate([np.cross(a, b), b - a], axis=-1)

    e = np.stack([edge6(p0, p1), edge6(p1, p2), edge6(p2, p0)], axis=1)
    n = np.cross(p1 - p0, p2 - p0)
    d0 = np.einsum("ij,ij->i", n, p0)

    tris = np.zeros((nc * chunk, ROWS, 5), np.float32)
    tris[:, 0:6, 0] = e[:, 0]
    tris[:, 0:6, 1] = e[:, 1]
    tris[:, 0:6, 2] = e[:, 2]
    tris[:, 0:3, 3] = n
    tris[:, 6:9, 4] = -n
    tris[:, 9, 4] = d0
    tris = tris.reshape(nc, chunk, ROWS, 5).transpose(0, 2, 3, 1).reshape(
        nc, ROWS, 5 * chunk)
    # The reference pads the minor dim to a multiple of 128 for TPU DMA
    # alignment; keep its shape so the tables compare leaf by leaf.
    wpad = -(-(5 * chunk) // 128) * 128
    if wpad != 5 * chunk:
        tris = np.concatenate(
            [tris, np.zeros((nc, ROWS, wpad - 5 * chunk), np.float32)], axis=2)
    remap = np.where(v, flat_tri, -1).astype(np.int32)
    return tris, boxes, remap


def _bvh_chunk_order(bvh, chunk: int) -> tuple[list, list]:
    """Cut a BVH into chunks: the maximal subtrees of at most `chunk`
    references (canonical treelets), in depth-first order, then consecutive
    pieces merged while they fit one chunk and the union box's diagonal
    stays within 1.5 times the larger piece's. Returns (triangle ids per
    chunk, box per chunk): a chunk's box is its subtree's node box (the
    union box after a merge), None for a bare leaf under an over-full node.

    With SBVH spatial splits a triangle can sit in several chunks, and a
    node box covers only the part of each triangle clipped to its side of
    the splits: every point of a triangle lies in the box of some chunk
    that holds it, while a chunk still tests its triangles whole."""
    left = np.asarray(bvh.node_left)
    right = np.asarray(bvh.node_right)
    prim_order = np.asarray(bvh.prim_order)
    n_nodes = len(left)

    # References under each node; children are allocated after their
    # parent, so a reverse sweep sees children first.
    count = np.zeros(n_nodes, np.int64)
    for nid in range(n_nodes - 1, -1, -1):
        lc, rc = left[nid], right[nid]
        count[nid] = (1 if lc < 0 else count[lc]) + (1 if rc < 0 else count[rc])

    def collect(ptr) -> list[int]:
        out: list[int] = []
        st = [ptr]
        while st:
            p = st.pop()
            if p < 0:
                out.append(-p - 1)
            else:
                st.append(right[p])
                st.append(left[p])
        return out

    nmin = np.asarray(bvh.node_min)
    nmax = np.asarray(bvh.node_max)
    chunks: list[np.ndarray] = []
    boxes: list = []
    stack = [0]
    while stack:
        ptr = stack.pop()
        if ptr < 0:
            chunks.append(prim_order[np.asarray([-ptr - 1], np.int64)])
            boxes.append(None)
        elif count[ptr] <= chunk:
            chunks.append(prim_order[np.asarray(collect(ptr), np.int64)])
            boxes.append(np.concatenate([nmin[ptr], nmax[ptr]]))
        else:
            stack.append(right[ptr])
            stack.append(left[ptr])

    merged_c: list[np.ndarray] = []
    merged_b: list = []
    for ids, box in zip(chunks, boxes):
        if (box is not None and merged_c and merged_b[-1] is not None
                and len(merged_c[-1]) + len(ids) <= chunk):
            pb = merged_b[-1]
            lo = np.minimum(pb[0:3], box[0:3])
            hi = np.maximum(pb[3:6], box[3:6])
            d_new = float(np.linalg.norm(hi - lo))
            d_max = max(float(np.linalg.norm(pb[3:6] - pb[0:3])),
                        float(np.linalg.norm(box[3:6] - box[0:3])))
            if d_new <= 1.5 * max(d_max, 1e-12):
                merged_c[-1] = np.concatenate([merged_c[-1], ids])
                merged_b[-1] = np.concatenate([lo, hi])
                continue
        merged_c.append(ids)
        merged_b.append(None if box is None else box.copy())
    return merged_c, merged_b


def build_pallas_tris(geom, chunk: int = DEFAULT_CHUNK, bvh=None) -> PallasTris:
    """Chunk tables of `geom`'s triangles (host, numpy): treelets of `bvh`
    (`_bvh_chunk_order`, boxes from its nodes) when given, else Morton
    slices (boxes of the chunks' triangles)."""
    pos = np.asarray(geom.positions)
    tri = np.asarray(geom.tri_vidx)
    t = len(tri)
    chunk_boxes = None
    if bvh is not None and t >= 2:
        chunk_tris, chunk_boxes = _bvh_chunk_order(bvh, chunk)
    elif t > 1:
        order = _morton_order((pos[tri[:, 0]] + pos[tri[:, 1]]
                               + pos[tri[:, 2]]) / 3.0)
        chunk_tris = [order[i:i + chunk] for i in range(0, t, chunk)]
    else:
        chunk_tris = [np.zeros((1,), np.int32)]
    tris, boxes6, remap = chunk_table_rows(pos, tri, chunk_tris, chunk)
    nc = len(chunk_tris)
    boxes = np.zeros((nc, 8), np.float32)
    boxes[:, 0:6] = boxes6
    if chunk_boxes is not None:
        for c, box in enumerate(chunk_boxes):
            if box is not None and len(chunk_tris[c]):
                boxes[c, 0:6] = box
    boxes[:, 6] = [1.0 if len(ids) else 0.0 for ids in chunk_tris]
    return PallasTris(
        tris=torch.from_numpy(tris),
        boxes=torch.from_numpy(boxes),
        remap=torch.from_numpy(remap),
        entry_chunk=torch.arange(nc, dtype=torch.int32),
        entry_inst=torch.full((nc,), -1, dtype=torch.int32),
        inst_trs=torch.zeros((1, 24), dtype=torch.float32),
    )


def extend_pallas_instanced(static_pt: PallasTris, positions, tri_vidx,
                            blas_ranges: list, rows: list) -> PallasTris:
    """Append local-space BLAS chunks and one worklist entry per (instance,
    BLAS chunk) to a static chunk table, so one traversal covers the whole
    two-level scene. Entry boxes are the instance-transformed world AABBs of
    each BLAS chunk (the union over the shutter for animated rows).

    `inst_trs` row per instance: [T0(3) Q0(4) S0(3) T1(3) Q1(4) S1(3) theta
    sin(theta) 0 0], Q1 already flipped onto Q0's hemisphere and theta the
    angle between them, so the kernels slerp without an acos."""
    pos = np.asarray(positions, np.float32)
    tv = np.asarray(tri_vidx, np.int64)
    chunk = static_pt.chunk
    all_tris = [static_pt.tris.numpy()]
    all_remap = [static_pt.remap.numpy()]
    local_boxes: list[np.ndarray] = []
    blas_chunk_ids: list[np.ndarray] = []
    next_chunk = static_pt.n_chunks
    # Chunk each BLAS's local triangles (Morton order within the BLAS).
    for lo, hi in blas_ranges:
        ids = np.arange(lo, hi, dtype=np.int64)
        if len(ids) > 1:
            cent = (pos[tv[ids, 0]] + pos[tv[ids, 1]] + pos[tv[ids, 2]]) / 3.0
            ids = ids[_morton_order(cent)]
        pieces = [ids[i:i + chunk] for i in range(0, len(ids), chunk)]
        tris_b, boxes_b, remap_b = chunk_table_rows(pos, tv, pieces, chunk)
        all_tris.append(tris_b)
        all_remap.append(remap_b)
        local_boxes.append(boxes_b)
        blas_chunk_ids.append(
            np.arange(next_chunk, next_chunk + len(pieces), dtype=np.int32))
        next_chunk += len(pieces)

    # Entries: static chunks first, then (instance x BLAS chunk).
    e_box = [static_pt.boxes.numpy()]
    e_chunk = [static_pt.entry_chunk.numpy()]
    e_inst = [static_pt.entry_inst.numpy()]
    inst_trs = np.zeros((max(len(rows), 1), 24), np.float32)
    for i, (bid, m0, m1) in enumerate(rows):
        tr0 = decompose_trs(m0)
        tr1 = decompose_trs(m1)
        T0, Q0, S0 = tr0
        T1, Q1, S1 = tr1
        d_q = float(np.dot(Q0, Q1))
        theta = float(np.arccos(np.clip(abs(d_q), 0.0, 1.0)))
        inst_trs[i, 0:3] = T0
        inst_trs[i, 3:7] = Q0
        inst_trs[i, 7:10] = S0
        inst_trs[i, 10:13] = T1
        inst_trs[i, 13:17] = Q1 if d_q >= 0 else -Q1
        inst_trs[i, 17:20] = S1
        inst_trs[i, 20] = theta
        inst_trs[i, 21] = float(np.sin(theta))
        static = np.allclose(np.asarray(m0), np.asarray(m1))
        lb = local_boxes[bid]
        eb = np.zeros((lb.shape[0], 8), np.float32)
        for c in range(lb.shape[0]):
            eb[c, 0:3], eb[c, 3:6] = motion_bounds_np(
                lb[c, 0:3], lb[c, 3:6], tr0, tr1, steps=1 if static else 16)
            eb[c, 6] = 1.0
        e_box.append(eb)
        e_chunk.append(blas_chunk_ids[bid])
        e_inst.append(np.full((lb.shape[0],), i, np.int32))

    # Morton-order the instanced entries by world box center: instances are
    # recorded in author order, so consecutive entries (and the 16-entry
    # super boxes built over them) would otherwise span the whole scene.
    n_static_e = e_box[0].shape[0]
    boxes_all = np.concatenate(e_box, axis=0)
    e_chunk_all = np.concatenate(e_chunk, axis=0)
    e_inst_all = np.concatenate(e_inst, axis=0)
    tail = slice(n_static_e, boxes_all.shape[0])
    if boxes_all[tail].shape[0] > 1:
        cent = 0.5 * (boxes_all[tail, 0:3] + boxes_all[tail, 3:6])
        order = _morton_order(cent)
        boxes_all[tail] = boxes_all[tail][order]
        e_chunk_all[tail] = e_chunk_all[tail][order]
        e_inst_all[tail] = e_inst_all[tail][order]
    return PallasTris(
        tris=torch.from_numpy(np.concatenate(all_tris, axis=0)),
        boxes=torch.from_numpy(boxes_all),
        remap=torch.from_numpy(np.concatenate(all_remap, axis=0)),
        entry_chunk=torch.from_numpy(e_chunk_all),
        entry_inst=torch.from_numpy(e_inst_all),
        inst_trs=torch.from_numpy(inst_trs),
    )


# ---------------------------------------------------------------------------
# Rays and worklists: the plain version of the worklist kernel
# ---------------------------------------------------------------------------

def _per_ray(v, r: int, device) -> Tensor:
    if isinstance(v, Tensor):
        return torch.broadcast_to(v.to(torch.float32), (r,))
    return torch.full((r,), v, dtype=torch.float32, device=device)


def _ray_ranges(r: int, tmin, tmax, active, device) -> tuple[Tensor, Tensor]:
    """Per-ray [tmin, tmax]; inactive lanes get the degenerate range
    [T_FAR, -T_FAR] so they opt out of culling, traversal and early-outs.
    Scalar bounds are filled on the device (no host-to-device copy)."""
    tmin_a = _per_ray(tmin, r, device)
    tmax_a = torch.clamp(_per_ray(tmax, r, device), max=T_FAR)
    if active is not None:
        tmin_a = torch.where(active, tmin_a, T_FAR)
        tmax_a = torch.where(active, tmax_a, -T_FAR)
    return tmin_a, tmax_a


def _scene_exit_clamp(o: Tensor, d: Tensor, tmax_a: Tensor,
                      boxes: Tensor) -> Tensor:
    """Clamp tmax to the exit distance from the union of the entry boxes, so
    the near-sorted break fires for rays that miss everything."""
    valid = boxes[:, 6] > 0.5
    lo = torch.where(valid[:, None], boxes[:, 0:3], T_FAR).amin(0)
    hi = torch.where(valid[:, None], boxes[:, 3:6], -T_FAR).amax(0)
    inv = _safe_inv(d)
    t0 = (lo[None, :] - o) * inv
    t1 = (hi[None, :] - o) * inv
    tf = torch.maximum(t0, t1).amin(1)
    exit_t = torch.clamp(tf, min=0.0) * 1.0001 + 1e-4
    return torch.minimum(tmax_a, exit_t)


def _pack_rays(o: Tensor, d: Tensor, tmin_a: Tensor, tmax_a: Tensor,
               rb: int = RB, f: Tensor | None = None) -> tuple[Tensor, int]:
    """(R, 3)x2 + (R,)x2 -> (NB, 16, rb) rows [d, m = o x d, o, 1, tmin,
    tmax, f, 0...]; row 12 is the per-ray shutter fraction (instanced
    scenes). Padding lanes are inert: degenerate [T_FAR, -T_FAR]."""
    r = o.shape[0]
    nb = -(-r // rb)
    rays = torch.zeros((nb * rb, ROWS), dtype=torch.float32, device=o.device)
    rays[:r, 0:3] = d
    rays[:r, 3:6] = cross(o, d)
    rays[:r, 6:9] = o
    rays[:r, 9] = 1.0
    rays[:r, 10] = tmin_a
    rays[:r, 11] = tmax_a
    if f is not None:
        rays[:r, 12] = f
    rays[r:, 2] = 1.0
    rays[r:, 10] = T_FAR
    rays[r:, 11] = -T_FAR
    return rays.reshape(nb, rb, ROWS).transpose(1, 2).contiguous(), nb


def _chunk_worklist(rays: Tensor, boxes: Tensor,
                    slice_w: int = 512) -> tuple[Tensor, Tensor, Tensor]:
    """Per-block culled, front-to-back ordered entry worklists: exact
    per-ray slab tests against every entry box, OR-reduced over each block,
    entries sorted by block-entry distance. Returns (wl (NB*NE,) int32,
    count (NB,) int32, near (NB*NE,) f32); entries past `count` repeat the
    last valid one."""
    nb, _, rb = rays.shape
    ne = boxes.shape[0]
    o = rays[:, 6:9, :]
    inv = _safe_inv(rays[:, 0:3, :])
    tminr = rays[:, 10, :]
    tmaxr = rays[:, 11, :]
    blk_parts, tn_parts = [], []
    for s0 in range(0, ne, slice_w):
        bsl = boxes[s0:s0 + slice_w]
        ns = bsl.shape[0]
        tn = torch.full((nb, ns, rb), -T_FAR, device=rays.device)
        tf = torch.full((nb, ns, rb), T_FAR, device=rays.device)
        for a in range(3):
            lo = bsl[:, a][None, :, None]
            hi = bsl[:, 3 + a][None, :, None]
            t0 = (lo - o[:, a, None, :]) * inv[:, a, None, :]
            t1 = (hi - o[:, a, None, :]) * inv[:, a, None, :]
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        ok = ((tn <= tf) & (tf >= tminr[:, None, :])
              & (tn <= tmaxr[:, None, :]) & (bsl[:, 6][None, :, None] > 0.5))
        blk_parts.append(ok.any(2))
        tn_parts.append(torch.where(ok, tn, T_FAR).amin(2))
    blk = torch.cat(blk_parts, dim=1)                          # (NB, NE)
    tn_blk = torch.cat(tn_parts, dim=1)
    count = blk.sum(1)
    wl, near = _sorted_worklist(torch.where(blk, tn_blk, float("inf")), count)
    return wl, count.to(torch.int32), near


def _sorted_worklist(key: Tensor, count: Tensor) -> tuple[Tensor, Tensor]:
    """Block-entry keys (NB, NE) (+inf where no ray of the block meets the
    entry) and the (NB,) int64 counts of finite keys -> the worklists
    (NB*NE,) int32 in (key, entry) order, entries past `count` repeating the
    last listed one (entry 0 where none is), and the keys (NB*NE,) clamped
    to T_FAR."""
    near, order = torch.sort(key, dim=1, stable=True)
    near = torch.clamp(near, max=T_FAR)
    last = torch.gather(order, 1, torch.clamp(count - 1, min=0)[:, None])
    pos = torch.arange(key.shape[1], device=key.device)[None, :]
    wl = torch.where(pos < count[:, None], order, last)
    return wl.to(torch.int32).reshape(-1), near.reshape(-1).contiguous()


def prepare_cast_plain(pt: PallasTris, o: Tensor, d: Tensor, tmin, tmax,
                       active: Tensor | None, rb: int,
                       f: Tensor | None = None):
    """The plain version of `build_worklists`: ranges, exit clamp, packed
    rays and worklists by tensor functions, on any device. Returns (rays,
    wl, cnt, wtn, tmax_a)."""
    tmin_a, tmax_a = _ray_ranges(o.shape[0], tmin, tmax, active, o.device)
    tmax_a = _scene_exit_clamp(o, d, tmax_a, pt.cast_boxes)
    rays, _ = _pack_rays(o, d, tmin_a, tmax_a, rb, f)
    wl, cnt, wtn = _chunk_worklist(rays, pt.cast_boxes)
    return rays, wl, cnt, wtn, tmax_a


def _auto_rb(pt: PallasTris) -> int:
    """Rays per kernel block: smaller blocks keep per-block worklist unions
    tight once tables have many entries."""
    return 128 if pt.n_entries > 128 else RB


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels
# ---------------------------------------------------------------------------

def xform_rays_plain(rays: Tensor, trs_rows: Tensor) -> Tensor:
    """The instance transform in plain PyTorch: every lane's ray of block b
    into the local space of the instance whose `inst_trs` row is
    trs_rows[b], at the lane's shutter fraction (ray row 12).

    rays (NB, 16, RB), trs_rows (NB, 24) -> (NB, 9, RB) rows [d, m, o] of
    the local ray: o_l = R^-1 (o - T) / S, d_l = R^-1 d / S (unnormalized,
    so t stays the world parameter), m = o_l x d_l. The rotation is the
    slerp of Q0 and the pre-flipped Q1 with weights from theta and
    sin(theta) (a lerp where sin(theta) < 1e-4), renormalized with rsqrt;
    T and S are lerped. The same steps in the same order as the device
    function `xform_ray` of csrc/traverse.cu."""
    c = [trs_rows[:, j, None] for j in range(22)]              # (NB, 1)
    f = rays[:, 12, :]
    theta, sin_t = c[20], c[21]
    near = sin_t < 1e-4
    inv_sin = 1.0 / torch.where(near, 1.0, sin_t)
    one_f = 1.0 - f
    w0 = torch.where(near, one_f, torch.sin(one_f * theta) * inv_sin)
    w1 = torch.where(near, f, torch.sin(f * theta) * inv_sin)
    qx = w0 * c[3] + w1 * c[13]
    qy = w0 * c[4] + w1 * c[14]
    qz = w0 * c[5] + w1 * c[15]
    qw = w0 * c[6] + w1 * c[16]
    qn = torch.rsqrt(torch.clamp(qx * qx + qy * qy + qz * qz + qw * qw,
                                 min=1e-20))
    qx, qy, qz, qw = qx * qn, qy * qn, qz * qn, qw * qn
    tx = one_f * c[0] + f * c[10]
    ty = one_f * c[1] + f * c[11]
    tz = one_f * c[2] + f * c[12]
    inv_sx = 1.0 / (one_f * c[7] + f * c[17])
    inv_sy = 1.0 / (one_f * c[8] + f * c[18])
    inv_sz = 1.0 / (one_f * c[9] + f * c[19])

    def invrot(vx, vy, vz):
        # R^-1 v = v + 2 (-qw (u x v) + u x (u x v)), u = (qx, qy, qz)
        cx = qy * vz - qz * vy
        cy = qz * vx - qx * vz
        cz = qx * vy - qy * vx
        ex = qy * cz - qz * cy
        ey = qz * cx - qx * cz
        ez = qx * cy - qy * cx
        return (vx + 2.0 * (-qw * cx + ex), vy + 2.0 * (-qw * cy + ey),
                vz + 2.0 * (-qw * cz + ez))

    olx, oly, olz = invrot(rays[:, 6, :] - tx, rays[:, 7, :] - ty,
                           rays[:, 8, :] - tz)
    olx, oly, olz = olx * inv_sx, oly * inv_sy, olz * inv_sz
    dlx, dly, dlz = invrot(rays[:, 0, :], rays[:, 1, :], rays[:, 2, :])
    dlx, dly, dlz = dlx * inv_sx, dly * inv_sy, dlz * inv_sz
    return torch.stack([dlx, dly, dlz,
                        oly * dlz - olz * dly, olz * dlx - olx * dlz,
                        olx * dly - oly * dlx, olx, oly, olz], dim=1)


def _plucker_terms(line: Tensor, tk: Tensor):
    """line (NB, 9, RB) rows [d, m, o]; tk (NB, 1, C, 24): the three side
    products, n.d and d0 - n.o, in the kernel's order of operations."""
    dx, dy, dz, mx, my, mz, ox, oy, oz = (line[:, i, :, None]
                                          for i in range(9))
    T = [tk[..., j] for j in range(22)]
    s0 = dx * T[0] + dy * T[1] + dz * T[2] + mx * T[3] + my * T[4] + mz * T[5]
    s1 = (dx * T[6] + dy * T[7] + dz * T[8] + mx * T[9] + my * T[10]
          + mz * T[11])
    s2 = (dx * T[12] + dy * T[13] + dz * T[14] + mx * T[15] + my * T[16]
          + mz * T[17])
    through = (((s0 >= 0) & (s1 >= 0) & (s2 >= 0))
               | ((s0 <= 0) & (s1 <= 0) & (s2 <= 0)))
    den = T[18] * dx + T[19] * dy + T[20] * dz
    num = T[21] - (T[18] * ox + T[19] * oy + T[20] * oz)
    return through, den, num


def _entry_tables(pt: PallasTris, rays: Tensor, wl2: Tensor, k: int):
    """Step k of every block's worklist: (chunk id (NB,), instance id (NB,),
    kernel rows (NB, 1, C, 24), ray rows [d, m, o] (NB, 9, RB) in the space
    the chunk's triangles live in)."""
    e = wl2[:, k]
    ch = pt.entry_chunk.to(torch.int64)[e]
    inst = pt.entry_inst.to(torch.int64)[e]
    line = rays[:, 0:9, :]
    if pt.instanced:
        local = xform_rays_plain(rays, pt.inst_trs[torch.clamp(inst, min=0)])
        line = torch.where((inst >= 0)[:, None, None], local, line)
    return ch, inst, pt.tri24[ch][:, None], line


def _valid_slots(pt: PallasTris, ch: Tensor, tk: Tensor) -> Tensor:
    """The rows of `tk` up to the most triangles any chunk of `ch` holds:
    the slots past a chunk's triangles are zero rows, which never hit."""
    return tk[:, :, :max(int(pt.n_valid[ch].max()), 1)]


def closest_hit_plain(rays: Tensor, wl: Tensor, cnt: Tensor,
                      pt: PallasTris) -> tuple[Tensor, Tensor, Tensor]:
    """The closest-hit kernel's function in plain PyTorch: every worklist
    entry of each block, in order, with no culling (culled entries cannot
    hold a closer hit)."""
    nb, _, rb = rays.shape
    tmin = rays[:, 10, :, None]
    best = rays[:, 11, :].clone()
    idx = torch.full((nb, rb), -1, dtype=torch.int64, device=rays.device)
    best_inst = torch.full_like(idx, -1)
    wl2 = wl.reshape(nb, -1).to(torch.int64)
    chunk = pt.chunk
    for k in range(int(cnt.max()) if nb else 0):
        ch, inst, tk, line = _entry_tables(pt, rays, wl2, k)
        through, den, num = _plucker_terms(line, _valid_slots(pt, ch, tk))
        ok = den.abs() > 1e-12
        t = num / torch.where(ok, den, 1.0)
        hit = (through & ok & (t >= tmin) & (t < best[..., None])
               & (k < cnt)[:, None, None])
        t_min, a_min = torch.where(hit, t, float("inf")).min(-1)
        closer = t_min < best
        best = torch.where(closer, t_min, best)
        idx = torch.where(closer, ch[:, None] * chunk + a_min, idx)
        best_inst = torch.where(closer, inst[:, None], best_inst)
    return best, idx.to(torch.int32), best_inst.to(torch.int32)


def any_hit_plain(rays: Tensor, wl: Tensor, cnt: Tensor,
                  pt: PallasTris) -> Tensor:
    """The any-hit kernel's function in plain PyTorch (occluded, int32)."""
    nb, _, rb = rays.shape
    tmin, tmax = rays[:, 10, :, None], rays[:, 11, :, None]
    occ = torch.zeros((nb, rb), dtype=torch.bool, device=rays.device)
    wl2 = wl.reshape(nb, -1).to(torch.int64)
    for k in range(int(cnt.max()) if nb else 0):
        ch, _, tk, line = _entry_tables(pt, rays, wl2, k)
        through, den, num = _plucker_terms(line, _valid_slots(pt, ch, tk))
        lo = num - tmin * den
        hi = num - tmax * den
        hit = through & (lo * hi <= 0) & (den.abs() > 1e-12) & (tmax >= tmin)
        occ = occ | (hit.any(-1) & (k < cnt)[:, None])
    return occ.to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t: Tensor | None):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of csrc/traverse.cu: pointers, then sizes, then the stream.
# The traversals take, after the stream, `ran` and the instanced flag.
_SIGNATURES = {
    "slr_closest_hit": [_P] * 15 + [_I] * 4 + [_P, _P, _I],
    "slr_any_hit": [_P] * 13 + [_I] * 4 + [_P, _P, _I],
    "slr_xform_rays": [_P] * 3 + [_I] * 2 + [_P],
    "slr_traverse_info": [_I, _I, _P],
    "slr_build_worklists": [_P] * 13 + [ctypes.c_longlong] * 4
    + [ctypes.c_float] * 2 + [_I] * 5 + [_P],
}
MAX_RB = 256   # lanes per kernel block, a multiple of 32
# The most entries the worklist kernel sorts in one block's shared memory
# (WL_MAX_SORT in csrc/traverse.cu: 16,384 keys and indices, 128 KB); a
# larger table's keys are sorted by the tensor code.
WORKLIST_MAX_SORT = 16384


def _library():
    from ..core.cuda_build import load_library

    return load_library("traverse", _SIGNATURES)


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_tensors(want, dev) -> None:
    for t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"traversal kernel argument {tuple(t.shape)} {t.dtype} on "
                f"{t.device}: expected contiguous {shape} {dtype} on {dev}")


def _check_kernel_args(rays: Tensor, wl: Tensor, wtn: Tensor, cnt: Tensor,
                       pt: PallasTris, counters) -> tuple[int, int, int]:
    nb, rows, rb = rays.shape
    ne = pt.n_entries
    want = [(rays, torch.float32, (nb, ROWS, rb)),
            (wl, torch.int32, (nb * ne,)), (wtn, torch.float32, (nb * ne,)),
            (cnt, torch.int32, (nb,)),
            (pt.cast_boxes, torch.float32, (ne, 8)),
            (pt.entry_chunk, torch.int32, (ne,)),
            (pt.entry_inst, torch.int32, (ne,)),
            (pt.inst_trs, torch.float32, (pt.inst_trs.shape[0], 24)),
            (pt.tri24, torch.float32, (pt.n_chunks, pt.chunk, KCOLS)),
            (pt.n_valid, torch.int32, (pt.n_chunks,))]
    tests, xforms, ran = counters
    want += [(c, torch.int32, (nb,)) for c in (tests, xforms)
             if c is not None]
    if ran is not None:
        want.append((ran, torch.int32, (nb, 2)))
    _check_tensors(want, rays.device)
    if rows != ROWS or rb % 32 or not 32 <= rb <= MAX_RB:
        raise ValueError(f"ray block of {rb} lanes is not supported")
    if pt.chunk > MAX_CHUNK:
        raise ValueError(f"chunk width {pt.chunk} is not supported")
    return nb, rb, ne


def closest_hit(rays: Tensor, wl: Tensor, wtn: Tensor, cnt: Tensor,
                pt: PallasTris, tests: Tensor | None = None,
                xforms: Tensor | None = None, ran: Tensor | None = None
                ) -> tuple[Tensor, Tensor, Tensor]:
    """Closest hit per packed ray over its block's worklist.
    Returns (best_t (NB, RB) f32, best_idx = chunk*C + slot int32,
    best_inst int32: the winning entry's instance, -1 for a static entry or
    a miss). `tests` (NB,) int32, if given, receives the number of
    ray-triangle tests each kernel block's rays need: those of live rays
    against the triangles of the chunks whose box they meet; `xforms`
    likewise the number of (ray, instanced entry) transforms among them.
    `ran` (NB, 2) int32, if given, receives what the block executed: its
    slot tests, and the (ray, entry) pairs that only the margin of the
    per-ray box test listed.

    Replaces the TPU kernel of slr_tpu/accel/pallas_intersect.py
    `_run_kernel` (`_kernel_smallwl` / `_kernel` -> `_traverse_closest`).
    Its floor on an H100 is fp32 arithmetic (45 operations per ray-triangle
    test; triangle rows come from shared memory, so DRAM bytes are small).
    The first version (one thread per ray, every thread through all 128
    slots of every chunk its block visited, two block votes and one
    synchronous copy per entry) ran 5-30 times the needed tests at a few
    warps per SM. This one lists, per entry, only the rays whose own box
    test (widened by a small margin) meets it, spreads each listed ray's
    valid slots over up to 32 sub-lanes so that the listed rays fill the
    block, scans the worklist a group of entries at a time and copies each
    visited chunk's valid rows with `cp.async` while the listed rays'
    local lines are derived; tables without instances run a build without
    the transform (see csrc/traverse.cu, and PERF.md for what each step
    gave)."""
    if rays.device.type == "cpu":
        return closest_hit_plain(rays, wl, cnt, pt)
    if rays.device.type != "cuda":
        raise ValueError(f"closest_hit: unsupported device {rays.device}")
    from ..core.cuda_build import check

    nb, rb, ne = _check_kernel_args(rays, wl, wtn, cnt, pt,
                                    (tests, xforms, ran))
    lib = _library()
    best_t = torch.empty((nb, rb), dtype=torch.float32, device=rays.device)
    best_idx = torch.empty((nb, rb), dtype=torch.int32, device=rays.device)
    best_inst = torch.empty((nb, rb), dtype=torch.int32, device=rays.device)
    code = lib.slr_closest_hit(
        _ptr(rays), _ptr(wl), _ptr(wtn), _ptr(cnt), _ptr(pt.cast_boxes),
        _ptr(pt.entry_chunk), _ptr(pt.entry_inst), _ptr(pt.inst_trs),
        _ptr(pt.tri24), _ptr(best_t), _ptr(best_idx), _ptr(best_inst),
        _ptr(pt.n_valid), _ptr(tests), _ptr(xforms), nb, rb, ne, pt.chunk,
        _stream(rays.device), _ptr(ran), int(pt.instanced))
    check(lib, code, "closest_hit launch")
    LAUNCHES["closest_hit"] += 1
    return best_t, best_idx, best_inst


def any_hit(rays: Tensor, wl: Tensor, wtn: Tensor, cnt: Tensor,
            pt: PallasTris, tests: Tensor | None = None,
            xforms: Tensor | None = None, ran: Tensor | None = None
            ) -> Tensor:
    """Occlusion per packed ray: 1 when some triangle has t in
    [tmin, tmax]. Returns (NB, RB) int32; `tests`, `xforms` and `ran` as in
    `closest_hit` (tests up to a ray's first hit).

    Replaces the TPU kernel of slr_tpu/accel/pallas_intersect.py
    `_run_kernel_any` (`_kernel_any_smallwl` / `_kernel_any` ->
    `_traverse_any`). Its floor is fp32 arithmetic like closest_hit's (49
    operations per test, divide-free). The design is closest_hit's: per-ray
    listing, sub-lanes over a listed ray's slots (reduced by a ballot, the
    ray leaving at its first hit) and group scans; since most shadow rays
    end at their first hit, an entry's ray list is compacted once more
    where that frees sub-lanes; a block stops once its live rays are all
    occluded."""
    if rays.device.type == "cpu":
        return any_hit_plain(rays, wl, cnt, pt)
    if rays.device.type != "cuda":
        raise ValueError(f"any_hit: unsupported device {rays.device}")
    from ..core.cuda_build import check

    nb, rb, ne = _check_kernel_args(rays, wl, wtn, cnt, pt,
                                    (tests, xforms, ran))
    lib = _library()
    occ = torch.empty((nb, rb), dtype=torch.int32, device=rays.device)
    code = lib.slr_any_hit(
        _ptr(rays), _ptr(wl), _ptr(wtn), _ptr(cnt), _ptr(pt.cast_boxes),
        _ptr(pt.entry_chunk), _ptr(pt.entry_inst), _ptr(pt.inst_trs),
        _ptr(pt.tri24), _ptr(occ), _ptr(pt.n_valid), _ptr(tests),
        _ptr(xforms), nb, rb, ne, pt.chunk, _stream(rays.device), _ptr(ran),
        int(pt.instanced))
    check(lib, code, "any_hit launch")
    LAUNCHES["any_hit"] += 1
    return occ


def traverse_info(rb: int, chunk: int = DEFAULT_CHUNK) -> dict:
    """What the built traversal kernels use at a launch of `rb` lanes:
    kernel name -> {(instanced, counting): dict(registers, static_smem,
    local_bytes (spills), dynamic_smem, blocks_per_sm)}. Needs the card."""
    from ..core.cuda_build import check

    lib = _library()
    out = (ctypes.c_int * 40)()
    check(lib, lib.slr_traverse_info(rb, chunk, out), "traverse_info")
    keys = ("registers", "static_smem", "local_bytes", "dynamic_smem",
            "blocks_per_sm")
    info = {}
    for k, name in enumerate(("closest_hit_kernel", "any_hit_kernel")):
        info[name] = {
            (bool(v >> 1), bool(v & 1)):
                dict(zip(keys, out[5 * (4 * k + v):5 * (4 * k + v) + 5]))
            for v in range(4)}
    return info


def xform_rays(rays: Tensor, trs_rows: Tensor) -> Tensor:
    """The instance transform on its own: block b's rays into the local
    space of the instance row trs_rows[b] ((NB, 16, RB), (NB, 24) ->
    (NB, 9, RB) rows [d, m, o]; see `xform_rays_plain`).

    Replaces slr_tpu/accel/pallas_intersect.py `_xform_rays`, which the TPU
    kernels run on a ray block before the triangle tests of an instanced
    entry. Both traversal kernels call the same device function
    (`xform_ray`, csrc/traverse.cu) once per ray listed for an instanced
    entry, by the ray's owner thread, the local line kept in shared
    memory; this launch runs that function alone, so it can be held
    against the plain version and timed. On its own it is bound by bytes
    (ray rows 0-8 and 12 read, 40 B, and 36 B written per ray, plus one
    96 B row per block, for 138 fp32 operations per ray)."""
    if rays.device.type == "cpu":
        return xform_rays_plain(rays, trs_rows)
    if rays.device.type != "cuda":
        raise ValueError(f"xform_rays: unsupported device {rays.device}")
    from ..core.cuda_build import check

    nb, rows, rb = rays.shape
    _check_tensors([(rays, torch.float32, (nb, ROWS, rb)),
                    (trs_rows, torch.float32, (nb, 24))], rays.device)
    if rb % 32 or not 32 <= rb <= MAX_RB:
        raise ValueError(f"ray block of {rb} lanes is not supported")
    lib = _library()
    out = torch.empty((nb, 9, rb), dtype=torch.float32, device=rays.device)
    code = lib.slr_xform_rays(_ptr(rays), _ptr(trs_rows), _ptr(out), nb, rb,
                              _stream(rays.device))
    check(lib, code, "xform_rays launch")
    LAUNCHES["xform_rays"] += 1
    return out


def _per_ray_arg(v, r: int, dev) -> tuple[Tensor | None, int, float]:
    """A per-ray operand of the worklist kernel: (float32 values, element
    step, 0.0) for a tensor that broadcasts to (r,), (None, 0, value) for
    a number."""
    if not isinstance(v, Tensor):
        return None, 0, float(v)
    v = torch.broadcast_to(v.detach().to(dev, torch.float32), (r,))
    return v, v.stride(0), 0.0


def build_worklists(pt: PallasTris, o: Tensor, d: Tensor, tmin, tmax,
                    active: Tensor | None, rb: int, f: Tensor | None = None):
    """One launch of the worklist kernel: per-ray ranges ([T_FAR, -T_FAR]
    on inactive lanes), tmax clamped at the exit from the union of the
    entry boxes, the packed rays (NB, 16, rb) and each block's culled,
    near-sorted worklist. Returns (rays, wl, cnt, wtn, tmax_a), equal to
    `prepare_cast_plain`'s on the same CUDA tensors. Above
    WORKLIST_MAX_SORT entries the kernel writes the blocks' keys and the
    tensor code sorts them (counted in LAUNCHES["worklist_tensor_sort"]).

    Replaces no TPU kernel: the reference builds the worklists with jnp in
    slr_tpu/accel/pallas_intersect.py's wrappers, as `prepare_cast_plain`
    does with ~100 tensor operations. Its floor on an H100 is bytes: ~96 B
    a ray (the ray read, its packed column and tmax written) plus the
    worklists; one block a ray block does each ray's slab tests against
    every entry box from shared memory and reduces them over the block with
    warp minimums, then sorts the block's keys in shared memory (see
    csrc/traverse.cu)."""
    if o.device.type != "cuda":
        raise ValueError(f"build_worklists: unsupported device {o.device}")
    from ..core.cuda_build import check

    dev = o.device
    o, d = o.contiguous(), d.contiguous()
    r, ne = o.shape[0], pt.n_entries
    _check_tensors([(o, torch.float32, (r, 3)), (d, torch.float32, (r, 3)),
                    (pt.cast_boxes, torch.float32, (ne, 8))], dev)
    if rb % 32 or not 32 <= rb <= MAX_RB:
        raise ValueError(f"ray block of {rb} lanes is not supported")
    if ne < 1:
        raise ValueError("build_worklists: the table has no entries")
    tmin_t, tmin_step, tmin_s = _per_ray_arg(tmin, r, dev)
    tmax_t, tmax_step, tmax_s = _per_ray_arg(tmax, r, dev)
    f_t, f_step, _ = (None, 0, 0.0) if f is None else _per_ray_arg(
        torch.as_tensor(f), r, dev)
    act, act_step = None, 0
    if active is not None:
        act = torch.broadcast_to(active.detach().to(dev, torch.bool), (r,))
        act_step = act.stride(0)
    nb = -(-r // rb)
    sort_n = (max(32, 1 << (ne - 1).bit_length())
              if ne <= WORKLIST_MAX_SORT else 0)
    rays = torch.empty((nb, ROWS, rb), dtype=torch.float32, device=dev)
    tmax_a = torch.empty((r,), dtype=torch.float32, device=dev)
    cnt = torch.empty((nb,), dtype=torch.int32, device=dev)
    keys = wl = wtn = None
    if sort_n:
        wl = torch.empty((nb * ne,), dtype=torch.int32, device=dev)
        wtn = torch.empty((nb * ne,), dtype=torch.float32, device=dev)
    else:
        keys = torch.empty((nb, ne), dtype=torch.float32, device=dev)
    lib = _library()
    code = lib.slr_build_worklists(
        _ptr(o), _ptr(d), _ptr(tmin_t), _ptr(tmax_t), _ptr(act), _ptr(f_t),
        _ptr(pt.cast_boxes), _ptr(rays), _ptr(tmax_a), _ptr(wl), _ptr(cnt),
        _ptr(wtn), _ptr(keys), tmin_step, tmax_step, act_step, f_step,
        tmin_s, tmax_s, r, nb, rb, ne, sort_n, _stream(dev))
    check(lib, code, "build_worklists launch")
    LAUNCHES["worklist"] += 1
    if not sort_n:
        wl, wtn = _sorted_worklist(keys, cnt.to(torch.int64))
        LAUNCHES["worklist_tensor_sort"] += 1
    return rays, wl, cnt, wtn, tmax_a


# ---------------------------------------------------------------------------
# Casts (the reference's host-facing entry points)
# ---------------------------------------------------------------------------

@traced("cast.prepare")
def prepare_cast(pt: PallasTris, o: Tensor, d: Tensor, tmin, tmax,
                 active: Tensor | None, rb: int | None = None,
                 f: Tensor | None = None):
    """Ranges, exit clamp, packed rays and worklists for one cast: the
    worklist kernel on CUDA tensors (`build_worklists`), its plain version
    on CPU tensors. Returns (rays, wl, cnt, wtn, tmax_a)."""
    # The traversal stays outside any autograd graph: hits are discrete.
    o, d = o.detach(), d.detach()
    if isinstance(tmax, Tensor):
        tmax = tmax.detach()
    rb = rb or _auto_rb(pt)
    if o.device.type == "cpu":
        return prepare_cast_plain(pt, o, d, tmin, tmax, active, rb, f)
    return build_worklists(pt, o, d, tmin, tmax, active, rb, f)


@traced("cast.shadow")
def anyhit_pallas(geom, pt: PallasTris, o: Tensor, d: Tensor,
                  tmin=RAY_EPSILON, tmax=float("inf"),
                  active: Tensor | None = None, rb: int | None = None,
                  f: Tensor | None = None) -> Tensor:
    """Occlusion query (bool per ray): True if anything lies in
    [tmin, tmax]. `f` is the per-ray shutter fraction (instanced tables)."""
    r = o.shape[0]
    rays, wl, cnt, wtn, _ = prepare_cast(pt, o, d, tmin, tmax, active, rb, f)
    tests, xforms = _work_counters(rays)
    occ = any_hit(rays, wl, wtn, cnt, pt, tests, xforms)
    _add_work(2, tests, xforms)
    return occ.reshape(-1)[:r] > 0


@traced("cast.closest")
def intersect_pallas(geom, pt: PallasTris, o: Tensor, d: Tensor,
                     tmin=RAY_EPSILON, tmax=float("inf"),
                     active: Tensor | None = None, rb: int | None = None,
                     f: Tensor | None = None, instances=None) -> Hit:
    """Closest hit via the worklist traversal, then the winning slot's
    triangle and its Möller-Trumbore barycentrics. With an instanced table
    pass the per-ray shutter fraction `f` and the scene's `Instances`, so
    that a winner on an instance gets its barycentrics against the
    local-space triangle; `Hit.inst` is then its instance (-1 elsewhere)."""
    r = o.shape[0]
    rays, wl, cnt, wtn, tmax_a = prepare_cast(pt, o, d, tmin, tmax, active,
                                              rb, f)
    tests, xforms = _work_counters(rays)
    best_t, best_idx, best_inst = closest_hit(rays, wl, wtn, cnt, pt, tests,
                                              xforms)
    _add_work(0, tests, xforms)
    best_t = best_t.reshape(-1)[:r]
    slot = best_idx.reshape(-1)[:r].to(torch.int64)
    inst = best_inst.reshape(-1)[:r].to(torch.int64)
    tri = torch.where(slot >= 0,
                      pt.remap.to(torch.int64)[torch.clamp(slot, min=0)], -1)
    mask = (tri >= 0) & (best_t < T_FAR) & (best_t < tmax_a * (1.0 + 1e-6))
    row = geom.tri_table[torch.clamp(tri, min=0)]
    p0 = row[:, 0:3]
    p1 = p0 + row[:, 3:6]
    p2 = p0 + row[:, 6:9]
    o_mt, d_mt = o, d
    if instances is not None:
        # The ray in the winning instance's space (unnormalized direction:
        # t stays the world parameter), through the run-time slerp of
        # core/transform.py as the reference does here.
        f_ = torch.zeros((r,), device=o.device) if f is None else f
        ic = torch.clamp(inst, min=0)
        T, R, S = trs_at(instances.t0_T[ic], instances.t0_R[ic],
                         instances.t0_S[ic], instances.t1_T[ic],
                         instances.t1_R[ic], instances.t1_S[ic], f_)
        on_inst = (inst >= 0)[:, None]
        o_mt = torch.where(on_inst, trs_inv_apply_point(T, R, S, o), o)
        d_mt = torch.where(on_inst, trs_inv_apply_vector(T, R, S, d), d)
    t_mt, b1, b2, _ = moller_trumbore(o_mt, d_mt, p0, p1, p2, 0.0,
                                      float("inf"))
    b1 = torch.clamp(b1, 0.0, 1.0)
    b2 = torch.clamp(b2, 0.0, 1.0)
    return Hit(t=torch.where(mask, t_mt, float("inf")),
               tri=torch.where(mask, tri, -1), b0=1.0 - b1 - b2, b1=b1,
               mask=mask,
               inst=torch.where(mask, inst, -1) if instances is not None
               else None,
               t_cast=torch.where(mask, best_t, float("inf")))
