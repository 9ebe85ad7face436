"""The fixed-depth path tracer: slr_tpu_torch's trace_radiance, render and
render_fused against slr_tpu's on the same Cornell scene carried across,
with the same rays, pixel ids and seed.

On the CPU the reference casts through its Plücker-matmul intersector and
the port through the plain versions of its traversal kernels; both fulfil
one hit contract. At depth 1 (the camera ray and one bounce of NEE and BSDF
sampling) no path decision can flip. Deeper, a decision that flips on
rounding (a tie at a glass interface, a Russian-roulette draw at its
threshold) changes that path from there on, so the gate is the share of
lanes within rtol 1e-3 and the mean."""
import os

import numpy as np
import pytest
import torch

from slr_tpu_torch.render import pt as tpt
from slr_tpu_torch.scene.bridge import from_reference
from slr_tpu_torch.scene.build import SceneBuilder
from slr_tpu_torch.scene.presets import grass_field, uv_sphere
from test_torch_reference_build import load_reference_sbvh

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_sbvh():
    """Reference tables are built with the SBVH library loaded (see
    test_torch_reference_build.py)."""
    load_reference_sbvh()


W, H, SEED = 32, 24, 7
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "grass_field_n8.npz")


def _deep_agreement(a, b):
    """Share of lanes (pixels) whose every channel is within rtol 1e-3."""
    close = np.abs(a - b) <= 1e-3 * np.abs(b) + 1e-6
    return close.all(axis=-1).mean()


@pytest.fixture(scope="module")
def jax_pt():
    from slr_tpu.render import pt

    return pt


@pytest.fixture(scope="module")
def cornell():
    """spectral -> (reference scene, the port's copy of it, camera rays of
    a 32x24 frame jittered from a numpy seed, as numpy arrays)."""
    from slr_tpu.scene.presets import cornell_box_spheres as ref_cornell
    from slr_tpu_torch.camera.perspective import sample_camera_rays

    out = {}
    for spectral in (False, True):
        ref = ref_cornell(sphere_res=6, spectral=spectral)
        port = from_reference(ref)
        rs = np.random.RandomState(4)
        n = W * H
        pid = np.arange(n)
        px = torch.as_tensor((pid % W + rs.rand(n)).astype(np.float32))
        py = torch.as_tensor((pid // W + rs.rand(n)).astype(np.float32))
        lens = torch.as_tensor(rs.rand(2, n).astype(np.float32))
        rays = sample_camera_rays(port.camera, px, py, W, H, lens[0], lens[1])
        out[spectral] = (ref, port, rays.o.numpy(), rays.d.numpy())
    return out


def _trace_both(jax_pt, cornell, spectral, depth):
    """(reference, port) radiance and lambdas (None in RGB mode)."""
    import jax.numpy as jnp

    ref, port, o, d = cornell[spectral]
    n = o.shape[0]
    args = (jnp.arange(n, dtype=jnp.uint32), jnp.zeros((n,), jnp.uint32),
            SEED)
    targs = (torch.arange(n), torch.zeros(n, dtype=torch.int64), SEED)
    if spectral:
        jr, jl = jax_pt.trace_radiance_spectral(
            ref, jnp.asarray(o), jnp.asarray(d), *args, max_depth=depth)
        tr, tl = tpt.trace_radiance_spectral(
            port, torch.as_tensor(o), torch.as_tensor(d), *targs,
            max_depth=depth)
        return np.asarray(jr), tr.numpy(), np.asarray(jl), tl.numpy()
    jr = jax_pt.trace_radiance(ref, jnp.asarray(o), jnp.asarray(d), *args,
                               max_depth=depth)
    tr = tpt.trace_radiance(port, torch.as_tensor(o), torch.as_tensor(d),
                            *targs, max_depth=depth)
    return np.asarray(jr), tr.numpy(), None, None


@pytest.mark.parametrize("spectral", [False, True], ids=["rgb", "spectral"])
def test_depth1_matches_reference(jax_pt, cornell, spectral):
    """Camera ray, NEE and one BSDF bounce: every lane agrees to f32
    rounding; a spectral scene's wavelengths agree bit for bit."""
    ref, got, ref_l, got_l = _trace_both(jax_pt, cornell, spectral, 1)
    assert got.shape == ref.shape == (W * H, 16 if spectral else 3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    if spectral:
        np.testing.assert_array_equal(got_l, ref_l)


@pytest.mark.parametrize("spectral", [False, True], ids=["rgb", "spectral"])
def test_depth6_matches_reference(jax_pt, cornell, spectral):
    """Six bounces through the metal and glass spheres: measured on this
    scene, every lane (100%) within rtol 1e-3 in RGB and spectral mode;
    the gate leaves room for 2% of flipped paths, and the means agree
    within 1%."""
    ref, got, ref_l, got_l = _trace_both(jax_pt, cornell, spectral, 6)
    assert np.isfinite(got).all()
    assert _deep_agreement(got, ref) >= 0.98
    assert abs(got.mean() / ref.mean() - 1.0) < 0.01
    if spectral:
        np.testing.assert_array_equal(got_l, ref_l)


def test_visibility_matches_reference(jax_pt, cornell):
    """The shadow test between seeded point pairs inside the box (some
    through the spheres) gives the reference's answer on every pair."""
    import jax.numpy as jnp

    ref, port, _, _ = cornell[False]
    rs = np.random.RandomState(5)
    lo, hi = np.float32([-1.4, 0.05, -2.4]), np.float32([1.4, 2.45, 2.4])
    a = (lo + (hi - lo) * rs.rand(512, 3)).astype(np.float32)
    b = (lo + (hi - lo) * rs.rand(512, 3)).astype(np.float32)
    want = np.asarray(jax_pt.test_visibility(ref, jnp.asarray(a),
                                             jnp.asarray(b)))
    got = tpt.test_visibility(port, torch.as_tensor(a),
                              torch.as_tensor(b)).numpy()
    assert 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got, want)


def test_sort_rays_does_not_change_results(cornell):
    """The coherence sort permutes the lanes; every lane draws the same
    random numbers in any order, so each lane's radiance agrees to f32
    rounding (tests/test_render.py's tolerance)."""
    _, port, o, d = cornell[False]
    args = (port, torch.as_tensor(o), torch.as_tensor(d),
            torch.arange(W * H), torch.zeros(W * H, dtype=torch.int64), SEED)
    a = tpt.trace_radiance(*args, max_depth=6, sort_rays=False).numpy()
    b = tpt.trace_radiance(*args, max_depth=6, sort_rays=True).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_render_is_deterministic(cornell):
    _, port, _, _ = cornell[False]
    a = tpt.render(port, 16, 12, spp=1, max_depth=4, device="cpu")
    b = tpt.render(port, 16, 12, spp=1, max_depth=4, device="cpu")
    assert torch.equal(a, b)


def test_white_furnace():
    """A uniformly emitting Lambert enclosure of albedo rho: L = Le / (1 -
    rho) = 2 for Le = 1, through NEE, MIS, BSDF sampling and Russian
    roulette (tests/test_render.py's furnace, rtol 0.05)."""
    rho = 0.5
    b = SceneBuilder()
    mat = b.add_emitter(b.add_matte(b.add_stex_const((rho, rho, rho))),
                        b.add_stex_const((np.pi,) * 3))
    pos, nrm, tan, uv, tris = uv_sphere((0, 0, 0), 2.0, 12, 24)
    b.add_mesh(pos, -nrm, tan, uv, tris[:, ::-1], mat)
    b.set_camera_perspective(np.eye(4, dtype=np.float32), aspect=1.0,
                             fovy=1.0, lens_radius=0.0, img_dist=1.0,
                             obj_dist=1.0)
    scene = b.build(use_bvh=False)
    n = 512
    d = np.random.RandomState(3).randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = tpt.trace_radiance(scene, torch.zeros((n, 3)),
                           torch.as_tensor(d, dtype=torch.float32),
                           torch.arange(n), torch.zeros(n, dtype=torch.int64),
                           0, max_depth=32)
    np.testing.assert_allclose(float(c.mean()), 1.0 / (1.0 - rho), rtol=0.05)


@pytest.fixture(scope="module")
def renders(cornell):
    """The port's render of the RGB Cornell box at 32x24, spp 2, depth 4,
    in one call, in two passes of one sample, and fused."""
    _, port, _, _ = cornell[False]
    kw = dict(seed=3, max_depth=4, device="cpu")
    return dict(
        whole=tpt.render(port, W, H, spp=2, **kw),
        first=tpt.render(port, W, H, spp=1, sample_offset=0, **kw),
        second=tpt.render(port, W, H, spp=1, sample_offset=1, **kw),
        fused=tpt.render_fused(port, W, H, spp=2, **kw))


def test_render_matches_reference(jax_pt, cornell, renders):
    """`render` against the reference's at 32x24, spp 2, depth 4: the
    camera jitter, lens and sample streams are the reference's, so pixels
    agree as the deep traces do (measured: every pixel within rtol
    1e-3)."""
    ref, _, _, _ = cornell[False]
    want = np.asarray(jax_pt.render(ref, W, H, spp=2, seed=3, max_depth=4))
    got = renders["whole"].numpy()
    assert got.shape == want.shape == (H, W, 3)
    assert _deep_agreement(got, want) >= 0.98
    assert abs(got.mean() / want.mean() - 1.0) < 0.01


def test_render_in_passes_equals_one_render(renders):
    """Sample streams are keyed by (seed, sample_offset + i): two passes of
    one sample, averaged, are the two-sample render bit for bit."""
    both = (renders["first"] * 1 + renders["second"] * 1) / 2
    assert torch.equal(both, renders["whole"])


def test_render_fused_equals_render(renders):
    assert torch.equal(renders["fused"], renders["whole"])


def test_render_batches_cover_the_image(cornell, renders):
    """Lane batches smaller than the image (the last one past its end)
    give the same pixels."""
    _, port, _, _ = cornell[False]
    got = tpt.render(port, W, H, spp=2, seed=3, max_depth=4, ray_batch=500,
                     device="cpu")
    assert _deep_agreement(got.numpy(), renders["whole"].numpy()) >= 0.98
    np.testing.assert_allclose(got.mean(), renders["whole"].mean(),
                               rtol=1e-3)


def test_render_refuses_cpu_fallback(cornell):
    _, port, _, _ = cornell[False]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpt.render(port, 4, 4, spp=1)


def test_grass_field_golden():
    """The port's own grass field (instances, motion blur) through `render`
    against the reference's golden (tests/test_instancing.py: 48x36, spp
    32, depth 5, seed 11) at the golden's tolerance (rtol 1e-3, atol 1e-4).
    The golden was rendered through the reference's two-level intersector,
    the port casts through its chunk kernels' plain versions: one of the
    55,296 camera samples takes another path at a blade edge, and that
    pixel is off by one sample's share. Measured: 1727 of 1728 pixels
    (0.99942) within the tolerance, means within 3.2e-4; the gate is 0.99
    of the pixels and the means within 1e-3."""
    scene = grass_field(n_side=8, blade_segments=3, animated_fraction=0.25,
                        device="cpu")
    img = tpt.render(scene, 48, 36, spp=32, max_depth=5, seed=11,
                     device="cpu").numpy()
    gold = np.load(GOLDEN)["img"]
    assert img.shape == gold.shape
    close = (np.abs(img - gold) <= 1e-3 * np.abs(gold) + 1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img.mean() / gold.mean() - 1.0) < 1e-3
