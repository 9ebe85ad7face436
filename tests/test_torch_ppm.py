"""Progressive photon mapping: slr_tpu_torch's render/ppm.py (SPPM and
AMCMC-PPM) against slr_tpu's on the same Cornell box carried across, with
the same seeds and iteration ids, on the CPU.

The reference's `ppm_iteration` is compiled twice here (use_mcmc False and
True, tests/test_ppm.py's shapes); its casts go through the Plücker
intersector and the port's through the plain versions of its traversal
kernels. The gather is held against the reference's on seeded photons that
overfill their cells, so that the stable sort decides which photons count.
The CUDA case (`cuda` marker) holds every cast of a pass against the
kernels' plain versions on the card:
`python -m pytest --noconftest tests/test_torch_ppm.py -m cuda`."""
import types

import numpy as np
import pytest
import torch

from slr_tpu_torch.render import ppm as tp
from slr_tpu_torch.render import pt as tpt
from slr_tpu_torch.scene.bridge import from_reference
from slr_tpu_torch.scene.presets import cornell_box_spheres

torch.set_num_threads(1)

W, H = 32, 24


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from slr_tpu.render import ppm as jp
    from slr_tpu.scene.presets import cornell_box_spheres as ref_cornell
    from test_torch_reference_build import load_reference_sbvh

    load_reference_sbvh()
    sc = ref_cornell(sphere_res=6, use_bvh=True)
    return types.SimpleNamespace(jnp=jnp, ppm=jp, scene=sc,
                                 port=from_reference(sc))


def _numpy(state):
    return {k: np.asarray(v) if not isinstance(v, torch.Tensor)
            else v.numpy() for k, v in state._asdict().items()}


def run_iterations(ref, use_mcmc, seed, n_iter=2):
    """tests/test_ppm.py's shapes (r0 0.15, 256 chains and photon paths, 3
    bounces, grid 16, K 4) in both packages: their states after each
    pass."""
    jnp = ref.jnp
    kw = dict(n_photon_paths=256, max_bounces=3, grid_res=16, k_per_cell=4,
              use_mcmc=use_mcmc)
    js = ref.ppm.init_state(ref.scene, W, H, r0=0.15, n_chains=256,
                            max_bounces=3)
    ts = tp.init_state(ref.port, W, H, r0=0.15, n_chains=256, max_bounces=3)
    out = []
    for it in range(n_iter):
        js = ref.ppm.ppm_iteration(ref.scene, js, W, H, jnp.uint32(it),
                                   jnp.uint32(seed), **kw)
        ts = tp.ppm_iteration(ref.port, ts, W, H, it, seed, **kw)
        out.append((_numpy(js), _numpy(ts)))
    return out


def _assert_states_match(want, got):
    for k in ("r2", "n", "tau"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got["direct"], want["direct"], rtol=1e-4,
                               atol=1e-6)
    for k in ("n_emitted", "n_visible", "n_uniform"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["chain_alive"], want["chain_alive"])
    np.testing.assert_allclose(got["mutation_size"], want["mutation_size"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["chain_u"], want["chain_u"], rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("use_mcmc", [False, True], ids=["sppm", "amcmc"])
def test_ppm_iteration_matches_reference(ref, use_mcmc):
    """Two passes: r2, n and tau within rtol 1e-4; the chain counts equal,
    and the chains' primary samples and mutation size within rtol 1e-6."""
    for want, got in run_iterations(ref, use_mcmc, seed=9):
        _assert_states_match(want, got)
    if use_mcmc:
        assert got["n_visible"] > 0 and got["chain_alive"].any()


@pytest.mark.parametrize("seed", [0xFFFFFFF0, 0xFFFFFFFA],
                         ids=["fffffff0", "fffffffa"])
def test_seed_near_two_to_the_32(ref, seed):
    """Seeds near 2^32 (the CLI masks rngSeed to 32 bits): seed + 7, + 11
    and + 13 of the primary-sample streams wrap mod 2^32 as the
    reference's uint32 sums do (0xFFFFFFFA wraps all three)."""
    for want, got in run_iterations(ref, True, seed=seed, n_iter=1):
        _assert_states_match(want, got)


def test_cell_code_matches_reference(ref):
    rs = np.random.RandomState(2)
    p = rs.uniform(-3.0, 3.0, (4096, 3)).astype(np.float32)
    origin = np.float32([-2.0, -1.5, -2.5])
    inv = np.float32([3.1, 3.1, 3.1])
    want = ref.ppm._cell_code(*(ref.jnp.asarray(x) for x in (p, origin,
                                                              inv)), 16)
    got = tp._cell_code(*(torch.as_tensor(x) for x in (p, origin, inv)), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_matches_reference(ref):
    """Hitpoints of one pass and seeded photons, several times as many per
    cell as the gather reads (K = 4), so that which photons of a cell count
    depends on the order of equal codes: m_count and visible equal, flux
    within rtol 1e-5."""
    jnp = ref.jnp
    jp = ref.ppm
    hp_j = jp._trace_hitpoints(ref.scene, W, H, jnp.uint32(3),
                               jnp.uint32(0), 3)
    hp_t = tp._trace_hitpoints(ref.port, W, H, 3, 0, 3)
    np.testing.assert_array_equal(hp_t.valid.numpy(), np.asarray(hp_j.valid))
    hp = tp.HitPoints(*(torch.as_tensor(np.array(x)) for x in hp_j))
    rs = np.random.RandomState(8)
    n = 8192
    idx = rs.randint(0, W * H, n)
    p = (np.asarray(hp_j.p)[idx]
         + rs.normal(0.0, 0.03, (n, 3))).astype(np.float32)
    wi = rs.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    ph_np = (p, wi, rs.uniform(0.0, 2.0, (n, 3)).astype(np.float32),
             rs.rand(n) < 0.9, np.arange(n) % 1024)
    r2 = np.full(W * H, 0.1 ** 2, np.float32)
    lo = np.asarray(hp_j.p).min(0) - 0.1
    cell_np = (lo.astype(np.float32), np.full(3, 1.0 / 0.2, np.float32))
    want = jp._gather(ref.scene, hp_j,
                      jp.Photons(*(jnp.asarray(x) for x in ph_np)),
                      jnp.asarray(r2), tuple(jnp.asarray(c) for c in cell_np),
                      32, 4, 3)
    got = tp._gather(ref.port, hp,
                     tp.Photons(*(torch.as_tensor(x) for x in ph_np[:4])),
                     torch.as_tensor(r2),
                     tuple(torch.as_tensor(c) for c in cell_np), 32, 4, 3)
    flux, m, vis = (np.asarray(x) for x in want)
    codes = tp._cell_code(torch.as_tensor(p), *(torch.as_tensor(c)
                                                for c in cell_np), 32)
    per_cell = np.bincount(codes[torch.as_tensor(ph_np[3])].numpy())
    assert per_cell.max() > 4 * 4 and m.max() > 0 and 0 < vis.mean() < 1
    np.testing.assert_array_equal(got[1].numpy(), m)
    np.testing.assert_array_equal(got[2].numpy(), vis)
    np.testing.assert_allclose(got[0].numpy(), flux, rtol=1e-5, atol=1e-7)


def test_gather_in_column_blocks(ref, monkeypatch):
    """Cutting the candidate columns into blocks (the card's memory bound
    at large frames) changes no count and no flux beyond rounding."""
    hp = tp._trace_hitpoints(ref.port, W, H, 3, 0, 3)
    ph = tp._trace_photons_pss(ref.port, torch.rand(
        2048, tp._pss_dims(3), generator=torch.Generator().manual_seed(1)),
        3, 3)
    r2 = torch.full((W * H,), 0.15 ** 2)
    cell = (hp.p.amin(0) - 0.15, torch.full((3,), 1.0 / 0.3))
    whole = tp._gather(ref.port, hp, ph, r2, cell, 16, 8, 3)
    monkeypatch.setattr(tp, "GATHER_ROWS", W * H * 5)
    blocks = tp._gather(ref.port, hp, ph, r2, cell, 16, 8, 3)
    assert float(whole[1].sum()) > 0
    assert torch.equal(whole[1], blocks[1]) and torch.equal(whole[2],
                                                            blocks[2])
    torch.testing.assert_close(blocks[0], whole[0], rtol=1e-5, atol=1e-6)


def test_mutate_pss_matches_reference(ref):
    rs = np.random.RandomState(4)
    u, xi, sg = (rs.rand(256, 17).astype(np.float32) for _ in range(3))
    for size in (1.0, 0.37, 1e-4):
        want = ref.ppm._mutate_pss(ref.jnp.asarray(u), ref.jnp.float32(size),
                                   ref.jnp.asarray(xi), ref.jnp.asarray(sg))
        got = tp._mutate_pss(torch.as_tensor(u), torch.tensor(size),
                             torch.as_tensor(xi), torch.as_tensor(sg))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
        assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.fixture(scope="module")
def scene():
    return cornell_box_spheres(sphere_res=6, use_bvh=True, device="cpu")


def test_radius_shrinks_and_shapes(scene):
    """tests/test_ppm.py:25-50 on the port: every pixel that received
    photons shrank its radius, none grew, and the image has its shape."""
    state0 = tp.init_state(scene, W, H, r0=0.2, n_chains=128, max_bounces=3)
    state = state0
    for i in range(3):
        state = tp.ppm_iteration(scene, state, W, H, i, 1,
                                 n_photon_paths=512, max_bounces=3,
                                 grid_res=16, k_per_cell=4, use_mcmc=False)
    n = state.n
    assert bool((state.r2[n > 0] < state0.r2[n > 0]).all())
    assert bool((state.r2 <= state0.r2 + 1e-7).all())
    assert float(state.n_emitted) == 3 * 512
    img = tp.develop_ppm(state, W, H, 3)
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())


def test_ppm_converges_to_pt(scene):
    """tests/test_ppm.py:52's gates on the port: SPPM (8 waves of 8,192
    photon paths, 5 bounces, K 32, r0 0.08) against the port's PT (spp 32,
    depth 5): means within rel 0.45, pixel correlation > 0.7."""
    pt_img = tpt.render(scene, W, H, spp=32, max_depth=5, seed=3,
                        device="cpu").numpy()
    ppm_img = tp.render_ppm(scene, W, H, n_iterations=8,
                            n_photon_paths=8192, max_bounces=5, seed=3,
                            k_per_cell=32, r0=0.08, device="cpu").numpy()
    assert ppm_img.mean() == pytest.approx(pt_img.mean(), rel=0.45)
    corr = np.corrcoef(pt_img.mean(-1).ravel(), ppm_img.mean(-1).ravel())
    assert corr[0, 1] > 0.7


def test_amcmc_chain_bookkeeping(scene):
    """tests/test_ppm.py:69 on the port."""
    _, state = tp.render_ppm(scene, W, H, n_iterations=1,
                             n_photon_paths=256, max_bounces=3, seed=9,
                             r0=0.15, grid_res=16, k_per_cell=4,
                             use_mcmc=True, device="cpu", return_state=True)
    assert float(state.n_uniform) == 256
    assert 0.0 <= float(state.n_visible) <= 256
    # float32, clipped to [1e-4, 1]: its floor is float32(1e-4).
    assert np.float32(1e-4) <= float(state.mutation_size) <= 1.0
    assert bool(state.chain_alive.any()) or float(state.n_visible) == 0


def test_render_ppm_refuses_cpu_fallback(scene):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.render_ppm(scene, 4, 4, n_iterations=1)


@pytest.mark.cuda
def test_cuda_ppm_casts_match_plain_versions():
    """Every closest-hit cast of one AMCMC-PPM pass at 64x48 (hitpoints,
    their specular bounces, the photon bounces) on the card: the kernel
    against its plain version; a photon pass casts no shadow ray."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from test_torch_bpt import hold_casts_against_plain

    sc = cornell_box_spheres(sphere_res=6, device="cuda")
    state = tp.init_state(sc, 64, 48, 0.05, 4096, 5)

    def run(fns):
        isect, _ = fns
        orig = tp.scene_intersect_alpha
        tp.scene_intersect_alpha = isect
        try:
            return tp.ppm_iteration(sc, state, 64, 48, 0, 1, 4096, 5, 32, 8,
                                    True)
        finally:
            tp.scene_intersect_alpha = orig

    seen = hold_casts_against_plain(sc, run)
    assert seen["closest"] >= 6 and seen["shadow"] == 0
