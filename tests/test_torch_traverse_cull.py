"""The per-ray culling rule of the CUDA traversal kernels
(slr_tpu_torch/csrc/traverse.cu), emulated in plain PyTorch and held against
the un-culled plain versions and the reference's Pallas kernels.

The CUDA kernels list, per worklist entry, only the rays whose own slab test
meets the entry's box (each face widened by MARGIN * (1 + the largest
coordinate of the box and of the ray's origin); the boxes are the casts'
`cast_boxes`, where a moving instance's entries are widened by the most its
triangles can stray out of the box between the shutter fractions it was
sampled at), test only the chunk's first
`n_valid` slots, and split a listed ray's slots over G sub-lanes whose
results are reduced to the smallest t and, on equal t, the lowest slot. The
emulation below (`closest_hit_culled`, `any_hit_culled`) follows that rule
step for step and is used by these tests only. It has to give what the
plain versions `closest_hit_plain` / `any_hit_plain` give, which test every
ray of a block against every slot of every listed entry: bit for bit (t,
slot, instance, occluded; tolerance 0). Against the reference's kernels in
interpret mode the casts meet the tests/test_pallas.py criteria: equal hit
masks, the same triangle or |dt| <= 1e-4 * max(t, 1) on more than 99.5% of
the rays hit, t within rtol 2e-4 / atol 2e-5; occlusion equal on static
tables and on more than 99.5% of the rays of instanced ones."""
import types
from unittest import mock

import numpy as np
import pytest
import torch

from slr_tpu_torch.accel import traverse as tv
from slr_tpu_torch.accel.intersect import RAY_EPSILON
from slr_tpu_torch.camera.perspective import sample_camera_rays
from slr_tpu_torch.scene.bridge import from_reference
from slr_tpu_torch.scene.presets import cornell_box_spheres

torch.set_num_threads(1)

MARGIN = np.float32(1e-4)        # csrc/traverse.cu MARGIN
GRASS = dict(n_side=8, blade_segments=3, animated_fraction=0.25)
N_RAYS = 640


# ---------------------------------------------------------------------------
# The kernels' rule in plain PyTorch
# ---------------------------------------------------------------------------

def box_near(rays, box, margin=True):
    """The kernels' `box_near`: rays (NB, 16, RB), box (NB, 8) -> (meets
    (NB, RB) under the ray's own [tmin, tmax], near distance). The caller
    applies the running bound."""
    o = rays[:, 6:9, :]
    inv = tv._safe_inv(rays[:, 0:3, :])
    if margin:
        pad = (MARGIN * (1.0 + box[:, 0:6].abs().amax(1)))[:, None] \
            + MARGIN * o.abs().amax(1)
    else:
        pad = torch.zeros_like(o[:, 0])
    tn = torch.full_like(pad, -tv.T_FAR)
    tf = torch.full_like(pad, tv.T_FAR)
    for a in range(3):
        t0 = ((box[:, a, None] - pad) - o[:, a]) * inv[:, a]
        t1 = ((box[:, 3 + a, None] + pad) - o[:, a]) * inv[:, a]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    return (tn <= tf) & (tf >= rays[:, 10, :]), tn


def _entries(pt, rays, wl2, k, trim, boxes):
    ch, inst, tk, line = tv._entry_tables(pt, rays, wl2, k)
    through, den, num = tv._plucker_terms(line, tk)
    slots = torch.arange(pt.chunk)
    n_slots = pt.n_valid.to(torch.int64)[ch] if trim else \
        torch.full_like(ch, pt.chunk)
    in_chunk = slots[None, None, :] < n_slots[:, None, None]
    boxes = pt.cast_boxes if boxes is None else boxes
    return ch, inst, through, den, num, in_chunk, boxes[wl2[:, k]]


def closest_hit_culled(rays, wl, cnt, pt, sub_lanes=1, trim=True,
                       margin=True, stats=None, boxes=None):
    """The closest-hit kernel's rule. `sub_lanes` = G: sub-lane g holds the
    slots g, g + G, ... and keeps its first smallest t (strict <); the G
    results reduce to the smallest t, on equal t the lowest slot. `boxes`
    replaces the cast boxes the kernels cull with."""
    nb, _, rb = rays.shape
    g = sub_lanes
    assert pt.chunk % g == 0
    tmin = rays[:, 10, :, None]
    best = rays[:, 11, :].clone()
    live = rays[:, 11, :] >= rays[:, 10, :]
    idx = torch.full((nb, rb), -1, dtype=torch.int64)
    best_inst = torch.full_like(idx, -1)
    wl2 = wl.reshape(nb, -1).to(torch.int64)
    inf = float("inf")
    for k in range(int(cnt.max()) if nb else 0):
        ch, inst, through, den, num, in_chunk, box = _entries(
            pt, rays, wl2, k, trim, boxes)
        meets, tn = box_near(rays, box, margin)
        listed = live & meets & (tn <= best) & (k < cnt)[:, None]
        if stats is not None:
            stats["listed"] += int(listed.sum())
        ok = den.abs() > 1e-12
        t = num / torch.where(ok, den, 1.0)
        hit = (through & ok & (t >= tmin) & (t < best[..., None]) & in_chunk
               & listed[..., None])
        cand = torch.where(hit, t, inf).reshape(nb, rb, pt.chunk // g, g)
        lane_t, lane_it = cand.min(2)             # first smallest per lane
        lane_slot = lane_it * g + torch.arange(g)
        t_min = lane_t.min(-1).values
        tied = lane_t == t_min[..., None]
        a_min = torch.where(tied, lane_slot, pt.chunk).min(-1).values
        closer = t_min < best
        best = torch.where(closer, t_min, best)
        idx = torch.where(closer, ch[:, None] * pt.chunk + a_min, idx)
        best_inst = torch.where(closer, inst[:, None], best_inst)
    return best, idx.to(torch.int32), best_inst.to(torch.int32)


def any_hit_culled(rays, wl, cnt, pt, trim=True, margin=True, stats=None,
                   boxes=None):
    """The any-hit kernel's rule: a ray still open is listed for an entry
    whose (widened) box it meets within [tmin, tmax]."""
    nb, _, rb = rays.shape
    tmin, tmax = rays[:, 10, :, None], rays[:, 11, :, None]
    live = rays[:, 11, :] >= rays[:, 10, :]
    occ = torch.zeros((nb, rb), dtype=torch.bool)
    wl2 = wl.reshape(nb, -1).to(torch.int64)
    for k in range(int(cnt.max()) if nb else 0):
        _, _, through, den, num, in_chunk, box = _entries(pt, rays, wl2, k,
                                                          trim, boxes)
        meets, tn = box_near(rays, box, margin)
        listed = (live & ~occ & meets & (tn <= rays[:, 11, :])
                  & (k < cnt)[:, None])
        if stats is not None:
            stats["listed"] += int(listed.sum())
        lo = num - tmin * den
        hi = num - tmax * den
        hit = (through & (lo * hi <= 0) & (den.abs() > 1e-12) & in_chunk
               & listed[..., None])
        occ = occ | hit.any(-1)
    return occ.to(torch.int32)


# ---------------------------------------------------------------------------
# Scenes and seeded ray sets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from slr_tpu.accel import pallas_intersect
    from slr_tpu.scene import build, presets
    from test_torch_reference_build import load_reference_sbvh

    load_reference_sbvh()

    return types.SimpleNamespace(jnp=jnp, pi=pallas_intersect, build=build,
                                 presets=presets)


@pytest.fixture(scope="module")
def scenes(ref):
    """name -> (reference scene, the same scene in the port): the Cornell
    box and a small grass field, both on Morton chunk tables."""
    r_cornell = ref.presets.cornell_box_spheres(use_bvh=False)
    build = ref.build.SceneBuilder.build
    with mock.patch.object(ref.build.SceneBuilder, "build",
                           lambda self: build(self, use_bvh=False)):
        r_grass = ref.presets.grass_field(**GRASS)
    return {"cornell": (r_cornell, cornell_box_spheres(use_bvh=False,
                                                       device="cpu")),
            "grass": (r_grass, from_reference(r_grass))}


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _camera(scene, rs, n, w=64, h=48):
    pix = rs.choice(w * h, n, replace=n > w * h)
    px = torch.as_tensor((pix % w + rs.rand(n)).astype(np.float32))
    py = torch.as_tensor((pix // w + rs.rand(n)).astype(np.float32))
    u, v = (torch.as_tensor(rs.rand(n).astype(np.float32)) for _ in "uv")
    cam = sample_camera_rays(scene.camera, px, py, w, h, u, v)
    return cam.o.numpy(), cam.d.numpy()


def ray_set(scenes, name):
    """(scene name, o, d, tmax, active, f) of a named seeded set: camera,
    bounce-like and shadow-like rays of both scenes, the in-scene sets with
    an active mask, the grass sets with random shutter fractions."""
    which, kind = name.split("-")
    port = scenes[which][1]
    rs = np.random.RandomState(sum(map(ord, name)))
    n = N_RAYS
    active = rs.rand(n) < 0.8
    tmax = np.full(n, np.inf, np.float32)
    if which == "cornell":
        lo, hi = np.float32([-1.45, 0.05, -2.5]), np.float32([1.45, 2.45, 2.5])
        light = (rs.uniform(-0.5, 0.5, n), np.full(n, 2.499),
                 rs.uniform(-0.5, 0.5, n))
        near = 0.7
    else:
        half = GRASS["n_side"] * 0.05
        lo, hi = np.float32([-half, 0.01, -half]), np.float32([half, 0.4, half])
        light = (rs.uniform(-2, 2, n), np.full(n, 8.0), rs.uniform(-2, 2, n))
        near = 0.3
    o = (lo + (hi - lo) * rs.rand(n, 3)).astype(np.float32)
    if kind == "camera":
        o, d = _camera(port, rs, n)
        active = np.ones(n, bool)
    elif kind == "inbox":
        d = _unit(rs.normal(size=(n, 3)))
    elif kind == "near":            # any hit over a short range, all lanes
        d = _unit(rs.normal(size=(n, 3)))
        tmax[:] = near
        active = np.ones(n, bool)
    else:                           # shadow rays toward the light
        delta = np.stack(light, axis=1).astype(np.float32) - o
        dist = np.linalg.norm(delta, axis=1).astype(np.float32)
        d = (delta / dist[:, None]).astype(np.float32)
        tmax = (dist * np.float32(1.0 - 1e-3)).astype(np.float32)
    f = rs.rand(n).astype(np.float32) if which == "grass" else None
    return which, o, d, tmax, active, f


def _prepared(scenes, name):
    which, o, d, tmax, active, f = ray_set(scenes, name)
    pt = scenes[which][1].pallas_tris
    rays, wl, cnt, _, _ = tv.prepare_cast(
        pt, torch.as_tensor(o), torch.as_tensor(d), RAY_EPSILON,
        torch.as_tensor(tmax), torch.as_tensor(active),
        f=None if f is None else torch.as_tensor(f))
    return pt, rays, wl, cnt


CLOSEST_SETS = ["cornell-camera", "cornell-inbox", "grass-camera",
                "grass-inbox"]
ANY_SETS = ["cornell-shadow", "cornell-near", "grass-shadow", "grass-near"]


# ---------------------------------------------------------------------------
# Against the plain versions: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sub_lanes", [1, 8, 32])
@pytest.mark.parametrize("name", CLOSEST_SETS)
def test_culled_closest_hit_equals_plain_version(scenes, name, sub_lanes):
    pt, rays, wl, cnt = _prepared(scenes, name)
    stats = {"listed": 0}
    got = closest_hit_culled(rays, wl, cnt, pt, sub_lanes, stats=stats)
    want = tv.closest_hit_plain(rays, wl, cnt, pt)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((want[1] >= 0).sum()) > N_RAYS // 8
    if name.startswith("grass"):
        assert bool((want[2] >= 0).any())
    # The rule does cull: fewer (ray, entry) pairs than the plain version's.
    assert stats["listed"] < 0.8 * int(cnt.sum()) * rays.shape[2]


@pytest.mark.parametrize("name", ANY_SETS)
def test_culled_any_hit_equals_plain_version(scenes, name):
    pt, rays, wl, cnt = _prepared(scenes, name)
    stats = {"listed": 0}
    got = any_hit_culled(rays, wl, cnt, pt, stats=stats)
    want = tv.any_hit_plain(rays, wl, cnt, pt)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < want.numel()
    assert stats["listed"] < 0.8 * int(cnt.sum()) * rays.shape[2]


@pytest.mark.parametrize("name", ["cornell-inbox", "grass-inbox"])
def test_margin_only_adds_listed_pairs(scenes, name):
    """The widened test lists every pair the exact one lists, a few more,
    and the extra tests change nothing (how many: printed with -s)."""
    pt, rays, wl, cnt = _prepared(scenes, name)
    wide, exact = {"listed": 0}, {"listed": 0}
    got = closest_hit_culled(rays, wl, cnt, pt, stats=wide)
    tight = closest_hit_culled(rays, wl, cnt, pt, margin=False, stats=exact)
    wl2 = wl.reshape(rays.shape[0], -1).to(torch.int64)
    for k in range(int(cnt.max())):
        box = pt.cast_boxes[wl2[:, k]]
        m_wide, tn_wide = box_near(rays, box)
        m_exact, tn_exact = box_near(rays, box, margin=False)
        assert bool((m_wide | ~m_exact).all())
        assert bool((tn_wide <= tn_exact)[m_exact].all())
    print(f"{name}: listed pairs exact {exact['listed']}, with the margin "
          f"{wide['listed']}")
    assert exact["listed"] <= wide["listed"] <= 1.05 * exact["listed"] + 8
    for g, w in zip(got, tight):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kernel", ["closest_hit", "any_hit"])
def test_trimmed_slots_change_nothing(scenes, kernel):
    """A chunk with fewer than C triangles gives the same result whether
    the slot loop runs all C slots or the chunk's `n_valid`."""
    name = "grass-inbox" if kernel == "closest_hit" else "grass-near"
    pt, rays, wl, cnt = _prepared(scenes, name)
    assert int(pt.n_valid.min()) < pt.chunk
    # Padding slots hold zero rows: n.d = 0 fails the |den| test.
    pad = torch.arange(pt.chunk)[None, :] >= pt.n_valid[:, None]
    assert bool((pt.tri24[pad] == 0).all())
    if kernel == "closest_hit":
        a = closest_hit_culled(rays, wl, cnt, pt, 4, trim=True)
        b = closest_hit_culled(rays, wl, cnt, pt, 4, trim=False)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    else:
        assert torch.equal(any_hit_culled(rays, wl, cnt, pt, trim=True),
                           any_hit_culled(rays, wl, cnt, pt, trim=False))


# ---------------------------------------------------------------------------
# Against the reference's kernels (interpret mode)
# ---------------------------------------------------------------------------

def _jax_args(ref, o, d, tmax, active, f):
    jnp = ref.jnp
    kw = dict(tmax=jnp.asarray(tmax), active=jnp.asarray(active),
              interpret=True)
    if f is not None:
        kw["f"] = jnp.asarray(f)
    return jnp.asarray(o), jnp.asarray(d), kw


@pytest.mark.parametrize("name", ["cornell-inbox", "grass-inbox"])
def test_culled_closest_cast_meets_reference_kernel(ref, scenes, name):
    which, o, d, tmax, active, f = ray_set(scenes, name)
    rsc, port = scenes[which]
    culled = lambda rays, wl, wtn, cnt, pt, *a: closest_hit_culled(  # noqa: E731
        rays, wl, cnt, pt, 8)
    with mock.patch.object(tv, "closest_hit", culled):
        hit = tv.intersect_pallas(
            port.geometry, port.pallas_tris, torch.as_tensor(o),
            torch.as_tensor(d), tmax=torch.as_tensor(tmax),
            active=torch.as_tensor(active),
            f=None if f is None else torch.as_tensor(f),
            instances=port.instances if f is not None else None)
    jo, jd, kw = _jax_args(ref, o, d, tmax, active, f)
    if f is not None:
        kw["instances"] = rsc.instances
    k = ref.pi.intersect_pallas(rsc.geometry, rsc.pallas_tris, jo, jd, **kw)
    mask, tri, t = (np.asarray(x) for x in (k.mask, k.tri, k.t))
    np.testing.assert_array_equal(hit.mask.numpy(), mask)
    same = hit.tri.numpy() == tri
    if f is not None:
        same &= hit.inst.numpy() == np.asarray(k.inst)
    with np.errstate(invalid="ignore"):
        close = np.abs(hit.t.numpy() - t) <= 1e-4 * np.maximum(t, 1.0)
    assert np.mean(np.where(mask, same | close, True)) > 0.995
    np.testing.assert_allclose(np.where(mask, hit.t.numpy(), 0.0),
                               np.where(mask, t, 0.0), rtol=2e-4, atol=2e-5)
    assert mask.sum() > N_RAYS // 8


@pytest.mark.parametrize("name", ["cornell-shadow", "grass-near"])
def test_culled_any_cast_meets_reference_kernel(ref, scenes, name):
    which, o, d, tmax, active, f = ray_set(scenes, name)
    rsc, port = scenes[which]
    culled = lambda rays, wl, wtn, cnt, pt, *a: any_hit_culled(  # noqa: E731
        rays, wl, cnt, pt)
    with mock.patch.object(tv, "any_hit", culled):
        occ = tv.anyhit_pallas(
            port.geometry, port.pallas_tris, torch.as_tensor(o),
            torch.as_tensor(d), tmax=torch.as_tensor(tmax),
            active=torch.as_tensor(active),
            f=None if f is None else torch.as_tensor(f)).numpy()
    jo, jd, kw = _jax_args(ref, o, d, tmax, active, f)
    k = np.asarray(ref.pi.anyhit_pallas(rsc.geometry, rsc.pallas_tris, jo, jd,
                                        **kw))
    if f is None:
        np.testing.assert_array_equal(occ, k)
    else:
        assert (occ == k).mean() > 0.995
    assert occ.any() and not occ.all()


# ---------------------------------------------------------------------------
# The wrappers' new argument
# ---------------------------------------------------------------------------

def test_wrappers_take_the_ran_counter_on_the_cpu(scenes):
    """On CPU tensors the wrappers run the plain versions, which fill no
    counter; the argument is accepted and left untouched."""
    pt, rays, wl, cnt = _prepared(scenes, "grass-inbox")
    wtn = torch.zeros(wl.shape, dtype=torch.float32)
    ran = torch.full((rays.shape[0], 2), -7, dtype=torch.int32)
    t, idx, inst = tv.closest_hit(rays, wl, wtn, cnt, pt, ran=ran)
    assert torch.equal(idx, tv.closest_hit_plain(rays, wl, cnt, pt)[1])
    assert torch.equal(tv.any_hit(rays, wl, wtn, cnt, pt, ran=ran),
                       tv.any_hit_plain(rays, wl, cnt, pt))
    assert bool((ran == -7).all())
    assert tv.MAX_RB == 256 and tv._auto_rb(pt) <= tv.MAX_RB


@pytest.mark.cuda
def test_cuda_kernels_report_what_they_ran():
    """On the card: the kernels' `ran` counter is at least the needed tests
    (closest hit) and the margin lists few extra pairs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    pt = cornell_box_spheres(use_bvh=False, device="cuda").pallas_tris
    rs = np.random.RandomState(5)
    o = torch.as_tensor(rs.uniform(-0.9, 0.9, (4096, 3)).astype(np.float32),
                        device="cuda")
    d = torch.as_tensor(_unit(rs.normal(size=(4096, 3))), device="cuda")
    rays, wl, cnt, wtn, _ = tv.prepare_cast(pt, o, d, 1e-4, float("inf"),
                                            None)
    nb = rays.shape[0]
    tests = torch.zeros(nb, dtype=torch.int32, device="cuda")
    xforms = torch.zeros_like(tests)
    ran = torch.zeros((nb, 2), dtype=torch.int32, device="cuda")
    t_k, i_k, _ = tv.closest_hit(rays, wl, wtn, cnt, pt, tests, xforms, ran)
    t_p, i_p, _ = tv.closest_hit_plain(rays, wl, cnt, pt)
    assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
    assert int(ran[:, 0].sum()) >= int(tests.sum()) > 0
    assert int(ran[:, 1].sum()) < 0.05 * int(tests.sum()) / pt.chunk + 64
