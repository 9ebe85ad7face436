"""The casts' reckoner counts the same work as a loop over every ray and
triangle, and the reference's brute-force casts agree with a plain loop."""
from __future__ import annotations

import numpy as np
import torch

from harness import peaks, reckoner
from reference.pathtracer import closest_hit, occluded


def tiny_scene(seed=0, n=40):
    """(n, 3, 3) float64 vertices of small triangles scattered in a box."""
    rs = np.random.RandomState(seed)
    centres = rs.uniform(-1, 1, (n, 1, 3))
    return torch.as_tensor(centres + rs.uniform(-0.3, 0.3, (n, 3, 3)))


def loop_count(tris, o, d, t0, t1):
    """Boxes met by each segment, one ray and one triangle at a time."""
    pos = tris.numpy()
    out = []
    for r in range(o.shape[0]):
        n = 0
        for p in pos:
            lo, hi = p.min(0), p.max(0)
            tn, tf = -np.inf, np.inf
            for a in range(3):
                da = float(d[r, a])
                inv = 1.0 / (da if abs(da) >= 1e-20 else
                             (1e-20 if da >= 0 else -1e-20))
                ta = (lo[a] - float(o[r, a])) * inv
                tb = (hi[a] - float(o[r, a])) * inv
                tn, tf = max(tn, min(ta, tb)), min(tf, max(ta, tb))
            n += tn <= tf and tf >= float(t0[r]) and tn <= float(t1[r])
        out.append(n)
    return np.array(out)


def loop_cast(tris, o, d, tmin, tmax):
    """The nearest hit's t per ray (inf on a miss), by a plain loop of
    Moller-Trumbore over every triangle."""
    out = []
    for r in range(o.shape[0]):
        best = np.inf
        oo, dd = o[r].numpy().astype(np.float64), d[r].numpy().astype(
            np.float64)
        for p in tris.numpy():
            e1, e2 = p[1] - p[0], p[2] - p[0]
            pv = np.cross(dd, e2)
            det = e1 @ pv
            if det == 0:
                continue
            tv = oo - p[0]
            b1 = (tv @ pv) / det
            qv = np.cross(tv, e1)
            b2 = (dd @ qv) / det
            t = (e2 @ qv) / det
            if b1 >= 0 and b2 >= 0 and b1 + b2 <= 1 and \
                    float(tmin[r]) <= t <= float(tmax[r]):
                best = min(best, t)
        out.append(best)
    return np.array(out)


def test_closest_and_any_counts_match_a_loop():
    tris = tiny_scene()
    sets = reckoner.ray_sets(tris, torch.arange(3), 64,
                             torch.Generator().manual_seed(5))
    o, d, tmin, tmax = sets["closest"]
    got = reckoner.closest_tests(tris, o, d, tmin, tmax).numpy()
    t = loop_cast(tris, o, d, tmin, tmax)
    exit_t = reckoner.exit_t(tris, o.double(), d.double(), tmax.double())
    end = np.where(np.isfinite(t), t, exit_t.numpy())
    assert (got == loop_count(tris, o, d, tmin, end)).all()
    assert got.sum() > 0 and got.max() >= 2
    o, d, tmin, tmax = sets["any"]
    got = reckoner.any_tests(tris, o, d, tmin, tmax).numpy()
    end = reckoner.exit_t(tris, o.double(), d.double(), tmax.double())
    occ = np.isfinite(loop_cast(tris, o, d, tmin, end.numpy()))
    want = loop_count(tris, o, d, tmin, end.numpy())
    assert (got == np.where(occ, 1, want)).all()
    assert occ.any() and (~occ).any()


def test_reference_casts_agree_with_a_loop():
    tris = tiny_scene(1)
    o, d, tmin, tmax = reckoner.ray_sets(
        tris, torch.arange(2), 256, torch.Generator().manual_seed(2))[
        "closest"]
    t, tri, _, _ = closest_hit(tris, o.double(), d.double(), tmin, tmax,
                               block=7)
    want = loop_cast(tris, o, d, tmin, tmax)
    assert ((tri >= 0).numpy() == np.isfinite(want)).all()
    assert np.allclose(t.numpy()[np.isfinite(want)], want[np.isfinite(want)])
    found = np.isfinite(want)
    short = torch.as_tensor(np.where(found, want * (1 - 1e-9), 1e9))
    assert (occluded(tris, o, d, short, tmin, block=7).numpy()
            <= ~found).all() or found.all()
    far = torch.full((o.shape[0],), 1e9, dtype=torch.float64)
    assert (occluded(tris, o, d, far, tmin, block=7).numpy() == found).all()


def test_least_time_takes_the_larger_bound():
    assert peaks.least_seconds(3.35e12, 0) == 1.0
    assert peaks.least_seconds(0, 67e12) == 1.0
    assert reckoner.cast_bytes("any", 10, 2) == 10 * 33 + 72
