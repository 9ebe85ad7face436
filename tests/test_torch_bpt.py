"""The bidirectional path tracer: slr_tpu_torch's render/bpt.py against
slr_tpu's on the same scenes carried across, with the same pixel ids,
sample ids and seed, on the CPU.

The reference runs as its own tests run it here: `bpt_batch` jitted, its
casts through the Plücker intersector; the port casts through the plain
versions of its traversal kernels. Both fulfil one hit contract, and the
random streams are the same, so a film entry differs only where a path
decision flips on rounding: the gate is the share of entries within rtol
1e-3 and the means. The reference's `bpt_batch` is compiled three times
here (the RGB and spectral Cornell box at flat caps 4 + 4, the
environment and equirect scene at 3 + 3); the animated scene and the
lens-only cap are held against it in test_torch_bpt_scenes.py. The CUDA
case (`cuda` marker) holds every cast of a batch against the kernels'
plain versions on the card; JAX is imported inside the fixtures, so that
it runs without JAX:
`python -m pytest --noconftest tests/test_torch_bpt.py -m cuda`."""
import types

import numpy as np
import pytest
import torch

from slr_tpu_torch.accel.intersect import RAY_EPSILON
from slr_tpu_torch.render import bpt as tb
from slr_tpu_torch.render import pt as tpt
from slr_tpu_torch.scene.bridge import from_reference
from slr_tpu_torch.scene.presets import cornell_box_spheres, glass_corridor

torch.set_num_threads(1)

SEED = 7


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from slr_tpu.render import bpt as jb
    from test_torch_reference_build import load_reference_sbvh

    load_reference_sbvh()
    return types.SimpleNamespace(jnp=jnp, bpt=jb)


def _agreement(a, b, rtol=1e-3, atol=1e-5):
    """Share of entries within rtol / atol, and the means' relative
    difference."""
    close = np.abs(a - b) <= rtol * np.abs(b) + atol
    return close.mean(), abs(a.mean() / b.mean() - 1.0)


def film_pair(ref, ref_scene, port, w, h, caps, sample=0):
    """One `bpt_batch` pass over every pixel of a w x h frame in both
    packages: (reference film, port film), (H*W, S) numpy."""
    jnp = ref.jnp
    n = w * h
    s_film = 16 if ref_scene.stex.spectral else 3
    want = ref.bpt.bpt_batch(
        ref_scene, jnp.arange(n, dtype=jnp.uint32),
        jnp.full((n,), sample, jnp.uint32), jnp.uint32(SEED), jnp.int32(w),
        jnp.int32(h), jnp.zeros((n, s_film), jnp.float32), *caps,
        pid_contiguous=True)
    got = tb.bpt_batch(port, torch.arange(n),
                       torch.full((n,), sample, dtype=torch.int64), SEED, w,
                       h, torch.zeros((n, s_film)), *caps,
                       pid_contiguous=True)
    return np.asarray(want), got.numpy()


@pytest.fixture(scope="module")
def cornell(ref):
    """spectral -> (reference Cornell box, the port's copy)."""
    from slr_tpu.scene.presets import cornell_box_spheres as ref_cornell

    out = {}
    for spectral in (False, True):
        sc = ref_cornell(sphere_res=6, spectral=spectral)
        out[spectral] = (sc, from_reference(sc))
    return out


def env_equirect_scene(builder_cls):
    """A diffuse sphere and a floor under a constant sky and a small area
    light, seen by the equirectangular camera: light subpaths start on the
    environment sphere and on the light, and t = 1 connections splat
    through the equirect camera's inverse mapping."""
    from slr_tpu_torch.scene.presets import uv_sphere

    b = builder_cls()
    mat = b.add_matte(b.add_stex_const((0.5, 0.5, 0.5)))
    b.add_mesh(*uv_sphere((0, 0, -3), 1.0, 8, 16), mat)
    floor = np.float32([[-4, -1, -6], [4, -1, -6], [4, -1, 2], [-4, -1, 2]])
    up = np.tile(np.float32([0, 1, 0]), (4, 1))
    tan = np.tile(np.float32([1, 0, 0]), (4, 1))
    quad = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    b.add_mesh(floor, up, tan, np.zeros((4, 2), np.float32), quad, mat)
    lm = b.add_emitter(b.add_matte(b.add_stex_const((0.5,) * 3)),
                       b.add_stex_const((8.0,) * 3))
    lamp = np.float32([[-0.5, 2, -3.5], [0.5, 2, -3.5], [0.5, 2, -2.5],
                       [-0.5, 2, -2.5]])
    b.add_mesh(lamp, -up, tan, np.zeros((4, 2), np.float32), quad[:, ::-1],
               lm)
    b.set_environment(b.add_stex_image(b.add_image(
        np.full((8, 16, 3), 0.7, np.float32))), 1.0)
    b.set_camera_equirect(np.eye(4, dtype=np.float32))
    return b.build(use_bvh=False)


# ---------------------------------------------------------------------------
# MIS weights
# ---------------------------------------------------------------------------

def _vertex_tables(rs, n, r):
    area = rs.uniform(0.05, 3.0, (n, r)).astype(np.float32)
    rrp = rs.uniform(0.2, 1.0, (n, r)).astype(np.float32)
    rev_a = rs.uniform(0.05, 3.0, (n, r)).astype(np.float32)
    rev_r = rs.uniform(0.2, 1.0, (n, r)).astype(np.float32)
    delta = rs.uniform(size=(n, r)) < 0.25
    return area, rrp, rev_a, rev_r, delta


def _vertices(cls, tables, as_array):
    z = as_array(np.zeros(tables[0].shape, np.float32))
    return cls(*([z] * 10), *(as_array(t) for t in tables), z, z, z)


@pytest.mark.parametrize("n, min_idx", [(5, 0), (6, 1), (1, 0), (2, 1)],
                         ids=["light5", "eye6", "light1", "eye2"])
def test_mis_incremental_matches_reference(ref, n, min_idx):
    tables = _vertex_tables(np.random.default_rng(3), n, 64)
    want = ref.bpt._mis_incremental(
        _vertices(ref.bpt.Vertices, tables, ref.jnp.asarray), n, min_idx)
    got = tb._mis_incremental(
        _vertices(tb.Vertices, tables, torch.as_tensor), n, min_idx)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_mis_incremental_matches_static_walk():
    """The port's O(V) partial sums against its literal walk for every
    (s, t) on seeded pdf and delta tables (tests/test_bpt.py's check)."""
    rs = np.random.default_rng(7)
    r, n_l, n_e = 64, 5, 6
    lt = _vertex_tables(rs, n_l, r)
    et = _vertex_tables(rs, n_e, r)
    d_l, zb_l, s_l = tb._mis_incremental(
        _vertices(tb.Vertices, lt, torch.as_tensor), n_l, 0)
    d_e, zb_e, s_e = tb._mis_incremental(
        _vertices(tb.Vertices, et, torch.as_tensor), n_e, 1)
    ext = torch.as_tensor(rs.uniform(0.05, 2.0, (8, r)).astype(np.float32))
    l_e1, l_r1, l_e2, l_r2, e_e1, e_r1, e_e2, e_r2 = ext
    lane_major = [torch.as_tensor(x).T for x in lt + et]
    for s in range(n_l + 1):
        for t in range(1, n_e + 1):
            want = tb._mis_weight_static(l_e1, l_r1, l_e2, l_r2, e_e1, e_r1,
                                         e_e2, e_r2, s, t, *lane_major)
            rec = torch.ones(r)
            if t > 1:
                c1 = tb._safe_div(l_e1 * l_r1, d_e[t - 1])
                c2 = tb._safe_div(l_e2 * l_r2, d_e[t - 2])
                rec = rec + zb_e[t - 1] * c1 * c1 + (c1 * c2) ** 2 * s_e[t]
            if s > 0:
                c1 = tb._safe_div(e_e1 * e_r1, d_l[s - 1])
                c2 = tb._safe_div(e_e2 * e_r2,
                                  d_l[s - 2] if s >= 2 else torch.ones(r))
                rec = rec + zb_l[s - 1] * c1 * c1 + (c1 * c2) ** 2 * s_l[s]
            np.testing.assert_allclose((1.0 / rec).numpy(), want.numpy(),
                                       rtol=2e-5, err_msg=f"s={s} t={t}")


def test_mis_static_walk_matches_reference(ref):
    """The port's literal walk against the reference's at one (s, t)."""
    rs = np.random.default_rng(11)
    r = 32
    tables = _vertex_tables(rs, 5, r) + _vertex_tables(rs, 6, r)
    ext = rs.uniform(0.05, 2.0, (8, r)).astype(np.float32)
    want = ref.bpt._mis_weight_static(
        *(ref.jnp.asarray(x) for x in ext), 4, 5,
        *(ref.jnp.asarray(x.T) for x in tables))
    got = tb._mis_weight_static(*(torch.as_tensor(x) for x in ext), 4, 5,
                                *(torch.as_tensor(x.T) for x in tables))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# Subpaths
# ---------------------------------------------------------------------------

def _subpath_inputs(adjoint, n, rs):
    """Seeded rays of an eye subpath (from the camera's position) or of a
    light subpath (from points on the Cornell box's light, downward)."""
    if adjoint:
        o = np.stack([rs.uniform(-0.4, 0.4, n), np.full(n, 2.49),
                      rs.uniform(-0.4, 0.4, n)], 1)
        d = rs.normal(size=(n, 3))
        d[:, 1] = -np.abs(d[:, 1])
    else:
        o = np.tile([0.0, 1.25, 6.8], (n, 1))
        d = np.stack([rs.uniform(-0.25, 0.25, n), rs.uniform(-0.2, 0.2, n),
                      -np.ones(n)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32),
            rs.randint(0, 3, n))


@pytest.mark.parametrize("adjoint", [False, True], ids=["eye", "light"])
def test_generate_subpath_matches_reference(ref, cornell, adjoint):
    """Three bounces (caps 4) from seeded rays: the valid masks agree on
    >= 99.5% of lanes, and each vertex field within rtol 1e-4 on >= 99.5%
    of the lanes valid in both; the s = 0 terms and the overflow mask
    too."""
    jnp = ref.jnp
    ref_scene, port = cornell[False]
    n = 512
    o, d, hero = _subpath_inputs(adjoint, n, np.random.RandomState(5))
    ones = np.ones(n, np.float32)
    args_np = (o, d, np.ones((n, 3), np.float32), ones, ones,
               np.zeros(n, bool), o)
    offset = tb._LIGHT_BOUNCE_OFFSET if adjoint else 0
    want = ref.bpt._generate_subpath(
        ref_scene, *(jnp.asarray(x) for x in args_np), adjoint,
        jnp.uint32(SEED), jnp.arange(n, dtype=jnp.uint32),
        jnp.zeros(n, jnp.uint32), jnp.asarray(hero, jnp.int32),
        jnp.zeros(n, bool), None, 3, offset)
    got = tb._generate_subpath(
        port, *(torch.as_tensor(x) for x in args_np), adjoint, SEED,
        torch.arange(n), torch.zeros(n, dtype=torch.int64),
        torch.as_tensor(hero), torch.zeros(n, dtype=torch.bool), None, 3,
        offset)
    steps_j, s0_j, zero_j, _, alive_j = want
    steps_t, s0_t, zero_t, _, alive_t = got
    valid_j = np.asarray(steps_j.valid)
    valid_t = steps_t.valid.numpy()
    assert 0.2 < valid_j.mean() < 1.0
    assert (valid_j == valid_t).all(0).mean() >= 0.995
    assert (np.asarray(alive_j) == alive_t.numpy()).mean() >= 0.995
    both = (valid_j & valid_t)
    lanes_ok = np.ones(n, bool)
    fields = [(np.asarray(a), b.numpy()) for a, b in zip(steps_j, steps_t)]
    fields += [(np.asarray(a), b.numpy()) for a, b in zip(zero_j, zero_t)]
    if not adjoint:
        fields += [(np.asarray(a), b.numpy()) for a, b in zip(s0_j, s0_t)]
    for a, b in fields:
        a = a.astype(np.float64)
        b = b.astype(np.float64)
        close = np.abs(a - b) <= 1e-4 * np.abs(a) + 1e-6
        close = close.reshape(close.shape[:2] + (-1,)).all(-1) \
            if close.ndim > 2 else close
        if close.ndim == 2:     # (V, R): lanes valid in both vertices
            close = (close | ~both).all(0)
        lanes_ok &= close
    assert lanes_ok.mean() >= 0.995


def test_zero_cap_subpath_is_empty(cornell):
    """max_verts 0 (max_eye_verts=1: the lens vertex alone) gives empty
    (0, R, ...) tables with the full structure and casts nothing."""
    _, port = cornell[False]
    n = 8
    o = torch.zeros((n, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(n, 1)
    ones = torch.ones(n)
    steps, s0, zero, lobes, alive = tb._generate_subpath(
        port, o, d, torch.ones((n, 3)), ones, ones,
        torch.zeros(n, dtype=torch.bool), o, False, SEED, torch.arange(n),
        torch.zeros(n, dtype=torch.int64), torch.zeros(n, dtype=torch.int64),
        torch.zeros(n, dtype=torch.bool), None, 0, 0)
    assert steps.valid.shape == (0, n) and steps.alpha.shape == (0, n, 3)
    assert s0[1].shape == (0, n, 3) and lobes.s0.shape[:2] == (0, n)
    assert alive.all() and zero[1].shape == (n,)


# ---------------------------------------------------------------------------
# Whole films against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spectral", [False, True], ids=["rgb", "spectral"])
def test_bpt_batch_film_matches_reference(ref, cornell, spectral):
    """The Cornell box (metal and glass spheres) at 24x18, flat caps 4 + 4:
    every strategy, the t = 1 splats through the perspective camera, the
    hero collapse at the glass. Gate: >= 98% of entries within rtol 1e-3 /
    atol 1e-5, means within 1%."""
    want, got = film_pair(ref, *cornell[spectral], 24, 18, (4, 4))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    close, rel = _agreement(got, want)
    assert close >= 0.98, close
    assert rel < 0.01, rel


def test_bpt_batch_env_equirect_matches_reference(ref):
    """Light subpaths from the environment sphere and an area light, the
    s = 0 environment term, and t = 1 splats through the equirect
    camera's inverse mapping, at 16x8, caps 3 + 3."""
    from slr_tpu.scene.build import SceneBuilder

    sc = env_equirect_scene(SceneBuilder)
    want, got = film_pair(ref, sc, from_reference(sc), 16, 8, (3, 3))
    assert np.isfinite(got).all()
    close, rel = _agreement(got, want)
    assert close >= 0.98, close
    assert rel < 0.01, rel


# ---------------------------------------------------------------------------
# render_bpt on the port alone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell_small():
    return cornell_box_spheres(sphere_res=6, use_bvh=False, metal=False,
                               glass=False, device="cpu")


def test_render_bpt_is_deterministic(cornell_small):
    a = tb.render_bpt(cornell_small, 12, 9, spp=1, device="cpu")
    b = tb.render_bpt(cornell_small, 12, 9, spp=1, device="cpu")
    assert torch.equal(a, b)
    assert np.isfinite(a.numpy()).all() and float(a.min()) >= 0.0


def test_tiered_equals_flat_deep():
    """The adaptive base -> deep tiers are scheduling only: the same keys
    reproduce a clipped lane's short prefix, so the tiered render equals
    the flat deep one (tests/test_bpt.py's rtol 2e-4) on the glass
    corridor, where many lanes overflow the base cap."""
    sc = glass_corridor(n_panes=1, device="cpu")
    tb.reset_tiers()
    tiered = tb.render_bpt(sc, 16, 12, spp=2, base_verts=6,
                           max_light_verts=12, max_eye_verts=12,
                           device="cpu").numpy()
    assert tb.TIERS["clipped"] > 0 and tb.TIERS["deep_passes"] > 0
    flat = tb.render_bpt(sc, 16, 12, spp=2, base_verts=12,
                         max_light_verts=12, max_eye_verts=12,
                         device="cpu").numpy()
    np.testing.assert_allclose(tiered, flat, rtol=2e-4, atol=1e-6)


def test_pt_bpt_agree(cornell_small):
    """Two estimators of one integral agree in the mean (tests/test_bpt.py:
    rtol 0.12 on the image mean, 0.15 per channel)."""
    w, h = 24, 18
    pt = tpt.render(cornell_small, w, h, spp=48, max_depth=4,
                    device="cpu").numpy()
    bpt = tb.render_bpt(cornell_small, w, h, spp=48, max_light_verts=4,
                        max_eye_verts=4, device="cpu").numpy()
    np.testing.assert_allclose(bpt.mean(), pt.mean(), rtol=0.12)
    np.testing.assert_allclose(bpt.mean(axis=(0, 1)), pt.mean(axis=(0, 1)),
                               rtol=0.15)


def test_pt_bpt_agree_per_block(cornell_small):
    """3x3-block means agree everywhere (tests/test_bpt.py: mean block
    relative error < 0.12, largest < 0.35): a wrong MIS weight distorts
    regions near the light or in shadow while barely moving the mean."""
    w, h = 24, 18
    pt = tpt.render(cornell_small, w, h, spp=256, max_depth=6,
                    device="cpu").numpy()
    bpt = tb.render_bpt(cornell_small, w, h, spp=64, max_light_verts=4,
                        max_eye_verts=4, device="cpu").numpy()

    def blocks(a, f=3):
        return a.reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))

    rel = np.abs(blocks(bpt) - blocks(pt)) / np.maximum(blocks(pt), 1e-3)
    assert rel.mean() < 0.12, rel.mean()
    assert rel.max() < 0.35, rel.max()


def test_light_tracing_splats_present(cornell_small):
    """With the lens vertex alone on the eye side every contribution is a
    t = 1 splat; the image is still lit."""
    img = tb.render_bpt(cornell_small, 16, 12, spp=2, max_eye_verts=1,
                        device="cpu")
    assert float(img.mean()) > 0.001


def test_render_bpt_refuses_cpu_fallback(cornell_small):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.render_bpt(cornell_small, 4, 4, spp=1)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def hold_casts_against_plain(scene, run):
    """Runs `run(cast_fns)` with hooks that hold every closest-hit and
    shadow cast against the kernels' plain versions on the same packed
    rays (tests/test_pallas.py's criteria: equal masks, the same triangle
    or t within 1e-4 on > 99.5% of hit rays; any hit equal). Returns the
    number of casts of each kind."""
    from slr_tpu_torch.accel import traverse as tv

    pt = scene.pallas_tris
    seen = {"closest": 0, "shadow": 0}

    def isect(sc, o, d, tmin=RAY_EPSILON, tmax=float("inf"), f=None,
              active=None):
        rays, wl, cnt, wtn, _ = tv.prepare_cast(pt, o, d, tmin, tmax, active,
                                                f=f)
        t_k, i_k, inst_k = tv.closest_hit(rays, wl, wtn, cnt, pt)
        t_p, i_p, inst_p = tv.closest_hit_plain(rays, wl, cnt, pt)
        h_k, h_p = i_k >= 0, i_p >= 0
        assert torch.equal(h_k, h_p)
        tri_k = torch.where(h_k, pt.remap.long()[i_k.clamp(min=0).long()], -1)
        tri_p = torch.where(h_p, pt.remap.long()[i_p.clamp(min=0).long()], -1)
        same = (tri_k == tri_p) | ((t_k - t_p).abs()
                                   <= 1e-4 * t_p.abs().clamp(min=1.0))
        if bool(h_p.any()):
            assert float(same[h_p].float().mean()) > 0.995
        seen["closest"] += 1
        return tpt.scene_intersect_alpha(sc, o, d, tmin, tmax, f=f,
                                         active=active)

    def occl(sc, o, d, tmin, tmax, f=None, active=None):
        rays, wl, cnt, wtn, _ = tv.prepare_cast(pt, o, d, tmin, tmax, active,
                                                f=f)
        assert torch.equal(tv.any_hit(rays, wl, wtn, cnt, pt),
                           tv.any_hit_plain(rays, wl, cnt, pt))
        seen["shadow"] += 1
        return tpt.scene_occluded(sc, o, d, tmin, tmax, f=f, active=active)

    run((isect, occl))
    return seen


@pytest.mark.cuda
def test_cuda_bpt_casts_match_plain_versions():
    """Every cast of one `bpt_batch` pass at 64x48 (light and eye bounces,
    the connection casts of n_l x 3,072 shadow rays with a tmax each) on
    the card: the kernels against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    scene = cornell_box_spheres(sphere_res=6, device="cuda")
    n = 64 * 48
    film = torch.zeros((n, 3), device="cuda")
    seen = hold_casts_against_plain(scene, lambda fns: tb.bpt_batch(
        scene, torch.arange(n, device="cuda"),
        torch.zeros(n, dtype=torch.int64, device="cuda"), SEED, 64, 48, film,
        4, 4, cast_fns=fns))
    assert seen == {"closest": 6, "shadow": 4}
    assert bool(torch.isfinite(film).all())
