"""Two-level traversal, TLAS over instances -> BLAS over triangles
(counterpart of slr_tpu/accel/twolevel.py): an oracle for the instanced
casts, with no kernel of its own.

The whole wavefront walks in lock step with one stack of (node, instance)
pairs per ray: entries tagged instance -1 walk the TLAS in world space;
entering a TLAS leaf pushes the instance's BLAS root tagged with the
instance, and every step takes the ray into the space of the popped entry's
instance at the ray's shutter fraction. Hit.t is a world-space parameter
throughout: local rays keep unnormalized directions (core/transform.py), so
t from static and instanced geometry compare directly.
"""
from __future__ import annotations

import torch

from ..core.transform import trs_at, trs_inv_apply_point, trs_inv_apply_vector
from ..scene.types import Geometry
from .instances import TwoLevel
from .intersect import Hit, moller_trumbore
from .lbvh import MAX_STACK, _push, _slab_test

Tensor = torch.Tensor


def _instance_ray(inst: TwoLevel, iid: Tensor, f: Tensor, o: Tensor,
                  d: Tensor) -> tuple[Tensor, Tensor]:
    """The ray in the space of instance iid (world space where iid < 0)."""
    i = torch.clamp(iid, min=0)
    T, R, S = trs_at(inst.t0_T[i], inst.t0_R[i], inst.t0_S[i],
                     inst.t1_T[i], inst.t1_R[i], inst.t1_S[i], f)
    world = (iid < 0)[:, None]
    return (torch.where(world, o, trs_inv_apply_point(T, R, S, o)),
            torch.where(world, d, trs_inv_apply_vector(T, R, S, d)))


def _at(table: Tensor, i: Tensor) -> Tensor:
    return table[torch.clamp(i, 0, table.shape[0] - 1)]


def intersect_instances(geom: Geometry, inst: TwoLevel, o: Tensor,
                        d: Tensor, f, tmin=1e-4,
                        tmax=float("inf")) -> Hit:
    """Closest hit against all instances of `inst` (world rays o, d (R, 3)
    at shutter fractions f (R,) in [0, 1]). `Hit.inst` is the instance
    hit."""
    r = o.shape[0]
    dev = o.device
    tmin = torch.broadcast_to(torch.as_tensor(tmin, dtype=torch.float32,
                                              device=dev), (r,))
    best_t = torch.broadcast_to(torch.as_tensor(
        tmax, dtype=torch.float32, device=dev), (r,)).clone()
    f = torch.broadcast_to(torch.as_tensor(f, dtype=torch.float32,
                                           device=dev), (r,))
    vidx = geom.tri_vidx.to(torch.int64)
    v0, v1, v2 = (geom.positions[vidx[:, k]] for k in range(3))
    tl_left, tl_right = inst.tlas_left.to(torch.int64), \
        inst.tlas_right.to(torch.int64)
    bl_left, bl_right = inst.blas_left.to(torch.int64), \
        inst.blas_right.to(torch.int64)
    tlas_prim = inst.tlas_prim.to(torch.int64)
    blas_prim = inst.blas_prim.to(torch.int64)
    blas_root = inst.blas_root.to(torch.int64)

    stack_n = torch.zeros((r, MAX_STACK), dtype=torch.int64, device=dev)
    stack_i = torch.full((r, MAX_STACK), -1, dtype=torch.int64, device=dev)
    sp = torch.ones((r,), dtype=torch.int64, device=dev)  # TLAS root pushed
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_inst = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_b1 = torch.zeros((r,), device=dev)
    best_b2 = torch.zeros((r,), device=dev)

    while bool((sp > 0).any()):
        active = sp > 0
        idx = torch.clamp(sp - 1, min=0)[:, None]
        node = torch.gather(stack_n, 1, idx)[:, 0]
        itag = torch.gather(stack_i, 1, idx)[:, 0]
        sp = torch.where(active, sp - 1, sp)

        o_l, d_l = _instance_ray(inst, itag, f, o, d)
        inv_d = 1.0 / torch.where(d_l.abs() < 1e-20,
                                  torch.where(d_l >= 0, 1e-20, -1e-20), d_l)
        at_tlas = itag < 0
        is_leaf = node < 0
        slot = torch.clamp(-node - 1, min=0)

        # A TLAS leaf: enter the instance's BLAS.
        enter_i = _at(tlas_prim, slot)
        enter = active & at_tlas & is_leaf
        # A BLAS leaf: the triangle test in local space.
        tri = _at(blas_prim, slot)
        t, b1, b2, hit = moller_trumbore(o_l, d_l, v0[tri], v1[tri], v2[tri],
                                         tmin, best_t)
        take = active & ~at_tlas & is_leaf & hit & (t < best_t)
        best_t = torch.where(take, t, best_t)
        best_tri = torch.where(take, tri, best_tri)
        best_inst = torch.where(take, itag, best_inst)
        best_b1 = torch.where(take, b1, best_b1)
        best_b2 = torch.where(take, b2, best_b2)

        # Interior: the children's boxes from the level's arrays.
        n_safe = torch.clamp(node, min=0)
        left = torch.where(at_tlas, _at(tl_left, n_safe),
                           _at(bl_left, n_safe))
        right = torch.where(at_tlas, _at(tl_right, n_safe),
                            _at(bl_right, n_safe))

        def child_box(c):
            ci = torch.clamp(c, min=0)
            cs = torch.clamp(-c - 1, min=0)
            tl = at_tlas[:, None]
            imin = torch.where(tl, _at(inst.tlas_min, ci),
                               _at(inst.blas_min, ci))
            imax = torch.where(tl, _at(inst.tlas_max, ci),
                               _at(inst.blas_max, ci))
            # A leaf child: the instance's motion bounds (TLAS) or its
            # triangle's bounds (BLAS).
            li = _at(tlas_prim, cs)
            lt = _at(blas_prim, cs)
            tp = torch.stack([v0[lt], v1[lt], v2[lt]], dim=1)
            lmin = torch.where(tl, inst.inst_bmin[li], tp.amin(1))
            lmax = torch.where(tl, inst.inst_bmax[li], tp.amax(1))
            leaf = (c < 0)[:, None]
            return torch.where(leaf, lmin, imin), torch.where(leaf, lmax,
                                                              imax)

        lmin, lmax = child_box(left)
        rmin, rmax = child_box(right)
        lhit, lnear = _slab_test(lmin, lmax, o_l, inv_d, tmin, best_t)
        rhit, rnear = _slab_test(rmin, rmax, o_l, inv_d, tmin, best_t)
        interior = active & ~is_leaf
        lhit = interior & lhit
        rhit = interior & rhit
        near_left = lnear <= rnear
        first = torch.where(near_left, left, right)
        second = torch.where(near_left, right, left)
        first_hit = torch.where(near_left, lhit, rhit)
        second_hit = torch.where(near_left, rhit, lhit)

        # A TLAS leaf pushes its BLAS root tagged with the instance; the
        # children keep their parent's tag, far first.
        root = _at(blas_root, enter_i)
        for value, tag, mask in ((root, enter_i, enter),
                                 (second, itag, second_hit),
                                 (first, itag, first_hit)):
            stack_i, _ = _push(stack_i, sp, tag, mask)
            stack_n, sp = _push(stack_n, sp, value, mask)
    mask = best_tri >= 0
    return Hit(t=torch.where(mask, best_t, float("inf")), tri=best_tri,
               b0=1.0 - best_b1 - best_b2, b1=best_b1, mask=mask,
               inst=best_inst)


def intersect_scene_oracle(scene, o: Tensor, d: Tensor, f=None,
                           tmin=1e-4, tmax=float("inf")) -> Hit:
    """Closest hit over a whole scene through the oracles, as the
    reference casts on the CPU: the static prefix by `intersect_bvh` on the
    scene's BVH (or `intersect_brute`), the instances by
    `intersect_instances` (their `TwoLevel` arena), the closer hit
    winning."""
    import dataclasses

    from .intersect import intersect_brute
    from .lbvh import intersect_bvh

    geom = scene.geometry
    if scene.instances is not None:
        n = scene.n_static
        geom = dataclasses.replace(geom, tri_vidx=geom.tri_vidx[:n],
                                   tri_mat=geom.tri_mat[:n],
                                   tri_alpha=geom.tri_alpha[:n])
    hit = (intersect_bvh(geom, scene.bvh, o, d, tmin, tmax)
           if scene.bvh is not None
           else intersect_brute(geom, o, d, tmin, tmax))
    if scene.instances is None:
        return hit
    f = torch.zeros(o.shape[:1], device=o.device) if f is None else f
    hit2 = intersect_instances(scene.geometry, scene.instances, o, d, f,
                               tmin, tmax)
    closer = hit2.mask & (hit2.t < torch.where(hit.mask, hit.t,
                                               float("inf")))
    return Hit(t=torch.where(closer, hit2.t, hit.t),
               tri=torch.where(closer, hit2.tri, hit.tri),
               b0=torch.where(closer, hit2.b0, hit.b0),
               b1=torch.where(closer, hit2.b1, hit.b1),
               mask=hit.mask | hit2.mask,
               inst=torch.where(closer, hit2.inst, -1))
