"""The casts' reckoner: the work a cast needs, counted from the scene's own
triangles, whatever implements the cast.

- Closest hit: the triangles whose own box the segment from tmin to the
  true closest hit meets (to where the ray leaves the scene's box on a
  miss); the hit is the reference's own brute-force cast's.
- Any hit: an occluded ray needs one test; an unoccluded one, the
  triangles whose box its segment [tmin, tmax] meets.

Chunking, culling or the kernels of the program cannot change the count.
Triangles are the reference scene's (T, 3, 3) vertex array.
"""
from __future__ import annotations

import torch

from reference.pathtracer import closest_hit, occluded

Tensor = torch.Tensor

# Rays x boxes per block of the slab tests.
BLOCK_ELEMS = 1 << 23


def triangle_boxes(tris: Tensor) -> tuple[Tensor, Tensor]:
    return tris.amin(1), tris.amax(1)


def scene_bounds(tris: Tensor) -> tuple[Tensor, Tensor]:
    v = tris.reshape(-1, 3)
    return v.amin(0), v.amax(0)


def _safe_inv(d: Tensor) -> Tensor:
    return 1.0 / torch.where(d.abs() < 1e-20,
                             torch.where(d >= 0, 1e-20, -1e-20), d)


def exit_t(tris: Tensor, o: Tensor, d: Tensor, tmax: Tensor) -> Tensor:
    """tmax, or where the ray leaves the scene's box if that is sooner."""
    lo, hi = scene_bounds(tris)
    inv = _safe_inv(d)
    far = torch.maximum((lo - o) * inv, (hi - o) * inv).amin(1)
    return torch.minimum(tmax, torch.clamp(far, min=0.0) * 1.0001 + 1e-4)


def boxes_met(o: Tensor, d: Tensor, t0: Tensor, t1: Tensor, lo: Tensor,
              hi: Tensor) -> Tensor:
    """(R,) int64: how many boxes [lo, hi] (B, 3) each segment o + t d,
    t in [t0, t1], meets (closed slab test)."""
    inv = _safe_inv(d)
    count = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    step = max(1, BLOCK_ELEMS // max(o.shape[0], 1))
    for s0 in range(0, lo.shape[0], step):
        bl, bh = lo[s0:s0 + step][None], hi[s0:s0 + step][None]
        ta = (bl - o[:, None, :]) * inv[:, None, :]
        tb = (bh - o[:, None, :]) * inv[:, None, :]
        tn = torch.minimum(ta, tb).amax(-1)
        tf = torch.maximum(ta, tb).amin(-1)
        met = (tn <= tf) & (tf >= t0[:, None]) & (tn <= t1[:, None])
        count += met.sum(1)
    return count


def closest_tests(tris: Tensor, o: Tensor, d: Tensor, tmin: Tensor,
                  tmax: Tensor) -> Tensor:
    o, d, tmin, tmax = (x.double() for x in (o, d, tmin, tmax))
    t, tri, _, _ = closest_hit(tris, o, d, tmin, tmax)
    end = torch.where(tri >= 0, t, exit_t(tris, o, d, tmax))
    lo, hi = triangle_boxes(tris)
    return boxes_met(o, d, tmin, end, lo, hi)


def any_tests(tris: Tensor, o: Tensor, d: Tensor, tmin: Tensor,
              tmax: Tensor) -> Tensor:
    o, d, tmin, tmax = (x.double() for x in (o, d, tmin, tmax))
    end = exit_t(tris, o, d, tmax)
    occ = occluded(tris, o, d, end, tmin)
    lo, hi = triangle_boxes(tris)
    return torch.where(occ, 1, boxes_met(o, d, tmin, end, lo, hi))


def ray_sets(tris: Tensor, emitters: Tensor, n: int,
             gen: torch.Generator) -> dict:
    """Two sets of `n` float32 rays from `gen`: bounce-like rays from
    points inside the scene's box in uniform directions (tmin 1e-4, no
    tmax), and shadow rays from such points to uniform points on the
    emitting triangles `emitters`, tmax just short of them. Each is
    (o, d, tmin, tmax)."""
    dev = tris.device
    lo, hi = (x.float() for x in scene_bounds(tris))

    def inside():
        u = torch.rand((n, 3), generator=gen, device=dev)
        return lo + (hi - lo) * (0.01 + 0.98 * u)

    o = inside()
    d = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=gen, device=dev), dim=-1)
    tmin = torch.full((n,), 1e-4, device=dev)
    closest = (o, d, tmin, torch.full((n,), float("inf"), device=dev))

    o2 = inside()
    pick = torch.randint(0, emitters.shape[0], (n,), generator=gen,
                         device=dev)
    p0, p1, p2 = (tris[emitters[pick], k].float() for k in range(3))
    u = torch.rand((n, 2), generator=gen, device=dev)
    su = torch.sqrt(u[:, 0:1])
    target = p0 * (1 - su) + p1 * (su * (1 - u[:, 1:2])) + p2 * (su
                                                               * u[:, 1:2])
    delta = target - o2
    dist = delta.norm(dim=-1)
    shadow = (o2, delta / dist[:, None], tmin.clone(), dist * (1.0 - 1e-3))
    return {"closest": closest, "any": shadow}


def cast_bytes(kind: str, n_rays: int, n_tris: int) -> int:
    """Each ray's fields (o, d, tmin, tmax) read once, each output written
    once (closest: t, triangle id as int64, two barycentrics, the mask and
    the cast's t; any: one bool), the triangles' vertices read once."""
    out = 4 + 8 + 4 + 4 + 1 + 4 if kind == "closest" else 1
    return n_rays * (32 + out) + n_tris * 36
