"""slr_tpu_torch.core against slr_tpu.core: the counter-based RNG and the
wavefront sort key bit for bit, sampling and vector math to float tolerance.

Inputs are made with numpy from a seed and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slr_tpu.core import math3d as jm3
from slr_tpu.core import rng as jrng
from slr_tpu.core import sampling as jsamp
from slr_tpu_torch.core import math3d as tm3
from slr_tpu_torch.core import rng as trng
from slr_tpu_torch.core import sampling as tsamp
from test_torch_reference_build import load_reference_sbvh

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_sbvh():
    """Reference tables are built with the SBVH library loaded (see
    test_torch_reference_build.py)."""
    load_reference_sbvh()


# Float math runs the same f32 operations in both packages; XLA and PyTorch
# may still order a reduction or pick a transcendental differently, which
# moves results by a few ulp.
RTOL, ATOL = 2e-6, 2e-6


def _u32(x):
    return jnp.asarray(np.asarray(x, np.uint32))


def _i64(x):
    return torch.as_tensor(np.asarray(x, np.int64))


@pytest.mark.parametrize("seed", [0, 1, 0xFFFFFFFF])
def test_uniform_bit_equal(seed):
    rs = np.random.RandomState(seed % 1000)
    n = 4096
    pixel = rs.randint(0, 2 ** 20 + 1, n)
    pixel[:2] = (0, 2 ** 20)
    sample = rs.randint(0, 2 ** 16 + 1, n)
    sample[:2] = (0, 2 ** 16)
    bounce = rs.randint(0, 101, n)
    for dec in range(int(jrng.Decision._COUNT)):
        ref = np.asarray(jrng.uniform(_u32(seed), _u32(pixel), _u32(sample),
                                      _u32(bounce), dec))
        out = trng.uniform(seed, _i64(pixel), _i64(sample), _i64(bounce),
                           dec).numpy()
        np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))
    assert trng.Decision._COUNT == jrng.Decision._COUNT


def test_hash32_bit_equal_extremes():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF],
                 np.uint32)
    ref = np.asarray(jrng._hash32(jnp.asarray(x)))
    out = trng._hash32(_i64(x)).numpy()
    np.testing.assert_array_equal(out.astype(np.uint32), ref)


@pytest.fixture(scope="module")
def ref_scene():
    from slr_tpu.scene.presets import cornell_box_spheres

    return cornell_box_spheres(sphere_res=8)


def test_ray_sort_key_bit_equal(ref_scene):
    from slr_tpu.render.pt import _ray_sort_key as jkey
    from slr_tpu_torch.render.pt import _ray_sort_key as tkey
    from slr_tpu_torch.scene.bridge import from_reference

    rs = np.random.RandomState(4)
    n = 2048
    o = rs.uniform([-1.4, 0.05, -2.5], [1.4, 2.45, 2.5], (n, 3)).astype(np.float32)
    o[:64] = (0.0, 1.689714, 6.70284)           # camera-origin rays
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = rs.rand(n) < 0.8
    ref = np.asarray(jkey(ref_scene, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(active)))
    scene = from_reference(ref_scene)
    out = tkey(scene, torch.as_tensor(o), torch.as_tensor(d),
               torch.as_tensor(active)).numpy()
    np.testing.assert_array_equal(out, ref.astype(np.int64))


def _rand(shape, seed, lo=0.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


def test_sampling_mappings_allclose():
    u0, u1 = _rand(1000, 1), _rand(1000, 2)
    u0[:3] = (0.5, 0.0, 0.25)
    u1[:3] = (0.5, 0.0, 0.75)
    for jf, tf in ((jsamp.concentric_sample_disk, tsamp.concentric_sample_disk),
                   (jsamp.uniform_sample_triangle, tsamp.uniform_sample_triangle)):
        for r, o in zip(jf(jnp.asarray(u0), jnp.asarray(u1)),
                        tf(torch.as_tensor(u0), torch.as_tensor(u1))):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), RTOL, ATOL)
    np.testing.assert_allclose(
        tsamp.cosine_sample_hemisphere(torch.as_tensor(u0),
                                       torch.as_tensor(u1)).numpy(),
        np.asarray(jsamp.cosine_sample_hemisphere(jnp.asarray(u0),
                                                  jnp.asarray(u1))), RTOL, ATOL)
    f, g = _rand(1000, 3, 0, 5), _rand(1000, 4, 0, 5)
    f[:2] = 0.0
    g[:1] = 0.0
    np.testing.assert_allclose(
        tsamp.power_heuristic(torch.as_tensor(f), torch.as_tensor(g)).numpy(),
        np.asarray(jsamp.power_heuristic(jnp.asarray(f), jnp.asarray(g))),
        RTOL, ATOL)


def test_distributions_allclose():
    w = _rand(7, 5, 0, 3)
    w[2] = 0.0
    u = _rand(500, 6)
    jd = jsamp.build_discrete_1d(jnp.asarray(w))
    td = tsamp.build_discrete_1d(torch.as_tensor(w))
    np.testing.assert_allclose(td.cdf.numpy(), np.asarray(jd.cdf), RTOL, ATOL)
    for r, o in zip(jsamp.sample_discrete_1d(jd, jnp.asarray(u)),
                    tsamp.sample_discrete_1d(td, torch.as_tensor(u))):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), RTOL, ATOL)

    img = _rand((6, 10), 7, 0, 2)
    j2 = jsamp.build_continuous_2d(jnp.asarray(img))
    t2 = tsamp.build_continuous_2d(torch.as_tensor(img))
    for a, b in zip(j2, t2):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), RTOL, ATOL)
    u0, u1 = _rand(500, 8), _rand(500, 9)
    for r, o in zip(jsamp.sample_continuous_2d(j2, jnp.asarray(u0),
                                               jnp.asarray(u1)),
                    tsamp.sample_continuous_2d(t2, torch.as_tensor(u0),
                                               torch.as_tensor(u1))):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), RTOL, ATOL)
    np.testing.assert_allclose(
        tsamp.pdf_continuous_2d(t2, torch.as_tensor(u0),
                                torch.as_tensor(u1)).numpy(),
        np.asarray(jsamp.pdf_continuous_2d(j2, jnp.asarray(u0),
                                           jnp.asarray(u1))), RTOL, ATOL)


def test_math3d_allclose():
    a = _rand((300, 3), 10, -2, 2)
    b = _rand((300, 3), 11, -2, 2)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.as_tensor(a), \
        torch.as_tensor(b)
    for name in ("dot", "cross", "length", "normalize", "reflect", "distance"):
        jf, tf = getattr(jm3, name), getattr(tm3, name)
        args_j = (ja,) if name in ("length", "normalize") else (ja, jb)
        args_t = (ta,) if name in ("length", "normalize") else (ta, tb)
        np.testing.assert_allclose(tf(*args_t).numpy(), np.asarray(jf(*args_j)),
                                   RTOL, ATOL, err_msg=name)
    z = tm3.normalize(ta)
    for r, o in zip(jm3.onb_from_z(jm3.normalize(ja)), tm3.onb_from_z(z)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), RTOL, ATOL)
    x, y, _ = tm3.onb_from_z(z)
    loc = tm3.frame_to_local(x, y, z, tb)
    np.testing.assert_allclose(tm3.frame_from_local(x, y, z, loc).numpy(), b,
                               1e-5, 1e-5)
    for name, arg in (("mat_rotate_x", 0.3), ("mat_rotate_y", np.pi),
                      ("mat_rotate_z", -1.2)):
        np.testing.assert_allclose(getattr(tm3, name)(arg).numpy(),
                                   np.asarray(getattr(jm3, name)(arg)),
                                   RTOL, ATOL, err_msg=name)
    m = np.array(jm3.mat_look_at(jnp.asarray([0.0, 1.0, 5.0]),
                                   jnp.asarray([0.0, 0.5, 0.0]),
                                   jnp.asarray([0.0, 1.0, 0.0])))
    np.testing.assert_allclose(
        tm3.mat_look_at([0.0, 1.0, 5.0], [0.0, 0.5, 0.0], [0.0, 1.0, 0.0]).numpy(),
        m, RTOL, ATOL)
    np.testing.assert_allclose(
        tm3.transform_point(torch.as_tensor(m), ta).numpy(),
        np.asarray(jm3.transform_point(jnp.asarray(m), ja)), 1e-5, 1e-5)
