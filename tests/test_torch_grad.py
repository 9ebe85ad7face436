"""Gradients with respect to scene parameters through torch autograd: one
case for each case of tests/test_grad.py, at its tolerances, against finite
differences of the port's own renders; three of them also against
`jax.grad` of the same objective on the same scene carried across.

A scene leaf that carries a gradient is a tensor that requires grad (or a
dual tensor), put into the scene with `dataclasses.replace`. The sampled
directions, their pdfs and the Russian-roulette probability are detached,
as the reference stops gradients there; the casts take detached rays. So
the estimator has no boundary terms, and a finite difference that crosses
a Russian-roulette decision sees a jump the gradient does not: the FD
gates are loose where the parameter moves throughput, tight where it does
not (emitters).

Per-pixel gradient maps (tests/test_grad.py:81 and :114 use `jax.jvp`) use
forward mode, `torch.autograd.forward_ad`: every operation on the path has
a forward-mode formula, the casts see no dual tensor, and one forward pass
gives the whole map, where reverse mode would need one backward pass per
pixel (or the double-vjp trick, a second backward through the graph)."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from slr_tpu_torch.render import pt as tpt
from slr_tpu_torch.scene.bridge import from_reference
from slr_tpu_torch.scene.build import SceneBuilder
from slr_tpu_torch.scene.presets import cornell_box_spheres
from slr_tpu_torch.scene.types import STexKind

torch.set_num_threads(1)

# Objective scenes: tests/test_grad.py's Cornell box without the metal and
# glass spheres, on Morton chunk tables (use_bvh=False, as there).
CORNELL = dict(sphere_res=6, use_bvh=False, metal=False, glass=False)
# The reference's gradient and the port's differ by float rounding only.
JAX_RTOL = 1e-3


def _with_stex(scene, **fields):
    return dataclasses.replace(
        scene, stex=dataclasses.replace(scene.stex, **fields))


def _set_row(scene, row, v):
    """stex.value[row, :] = v, differentiable in v."""
    val = scene.stex.value
    sel = (torch.arange(val.shape[0]) == row)[:, None]
    return _with_stex(scene, value=torch.where(sel, v, val))


def _scale_entry(scene, row, col, s):
    """stex.value[row, col] *= s, differentiable in s."""
    val = scene.stex.value
    sel = ((torch.arange(val.shape[0]) == row)[:, None]
           & (torch.arange(val.shape[1]) == col)[None, :])
    return _with_stex(scene, value=val * torch.where(sel, s, 1.0))


def _rays(seed, n, origin, spread=0.0, shift=(0.0, 0.0, 0.0)):
    """tests/test_grad.py's ray fans, drawn from the same numpy streams."""
    rs = np.random.RandomState(seed)
    o = np.array([origin] * n)
    if spread:
        o = o + rs.randn(n, 3) * spread
    d = rs.randn(n, 3) - np.asarray(shift)
    return (torch.as_tensor(o, dtype=torch.float32),
            torch.nn.functional.normalize(
                torch.as_tensor(d, dtype=torch.float32), dim=-1))


def _mean_radiance(scene, o, d, depth):
    n = o.shape[0]
    return tpt.trace_radiance(scene, o, d, torch.arange(n),
                              torch.zeros(n, dtype=torch.int64), 0,
                              max_depth=depth).mean()


def _grad(f, v0):
    v = torch.tensor(v0, requires_grad=True)
    val = f(v)
    (g,) = torch.autograd.grad(val, v)
    return float(g), float(val)


def _fd(f, v0, eps):
    """The central difference of f at v0 (a float or an image)."""
    with torch.no_grad():
        fd = (f(torch.tensor(v0 + eps))
              - f(torch.tensor(v0 - eps))) / (2 * eps)
    return float(fd) if isinstance(fd, torch.Tensor) else fd


def _jax_grad(jf, v0):
    import jax
    import jax.numpy as jnp

    return float(jax.grad(jf)(jnp.float32(v0)))


def _jax_rays(o, d):
    import jax.numpy as jnp

    return jnp.asarray(o.numpy()), jnp.asarray(d.numpy())


def _jax_mean_radiance(scene, o, d, depth):
    import jax.numpy as jnp
    from slr_tpu.render.pt import trace_radiance

    n = o.shape[0]
    return jnp.mean(trace_radiance(
        scene, o, d, jnp.arange(n, dtype=jnp.uint32),
        jnp.zeros((n,), jnp.uint32), 0, max_depth=depth))


@pytest.fixture(scope="module")
def ref_cornell():
    from slr_tpu.scene.presets import cornell_box_spheres as jcornell

    return jcornell(**CORNELL)


@pytest.fixture(scope="module")
def cornell():
    return cornell_box_spheres(device="cpu", **CORNELL)


def test_grad_matches_finite_difference(ref_cornell):
    """d(mean radiance)/d(white-wall reflectance) (stex 2): against the
    central FD (rtol 0.08, tests/test_grad.py:38) and against jax.grad of
    the same objective on the same scene."""
    scene = from_reference(ref_cornell)
    o, d = _rays(0, 256, [0.0, 1.2, 1.0], spread=0.05)

    def f(v):
        return _mean_radiance(_set_row(scene, 2, v), o, d, 4)

    g, _ = _grad(f, 0.75)
    np.testing.assert_allclose(g, _fd(f, 0.75, 1e-2), rtol=0.08)
    assert g > 0

    import jax.numpy as jnp

    jo, jd = _jax_rays(o, d)

    def jf(v):
        st = ref_cornell.stex
        sc = ref_cornell.replace(stex=st.replace(
            value=st.value.at[2].set(jnp.full((3,), v))))
        return _jax_mean_radiance(sc, jo, jd, 4)

    np.testing.assert_allclose(g, _jax_grad(jf, 0.75), rtol=JAX_RTOL)


def test_grad_of_emitter_scale(cornell):
    """Radiance is linear in the emitter (stex 4): grad = f(s) / s (rtol
    1e-4, tests/test_grad.py:48)."""
    o, d = _rays(1, 128, [0.0, 1.2, 1.0])
    g, val = _grad(lambda s: _mean_radiance(_set_row(cornell, 4, s), o, d, 3),
                   30.0)
    np.testing.assert_allclose(g, val / 30.0, rtol=1e-4)


def test_functional_grad_is_finite(cornell):
    """The objective through torch.func.grad, the functional transform (the
    counterpart of tests/test_grad.py's jit(grad) case): finite, and equal
    to the autograd gradient."""
    o, d = _rays(0, 64, [0.0, 1.2, 1.0], spread=0.05)

    def f(v):
        return _mean_radiance(_set_row(cornell, 2, v), o, d, 2)

    g = torch.func.grad(f)(torch.tensor(0.5))
    assert torch.isfinite(g)
    np.testing.assert_allclose(float(g), _grad(f, 0.5)[0], rtol=1e-6)


def _jvp_image(f, v0):
    """(image, d image / dv) at v0 in one forward pass."""
    with fwAD.dual_level():
        out = f(fwAD.make_dual(torch.tensor(v0), torch.tensor(1.0)))
        img, dimg = fwAD.unpack_dual(out)
    return img.numpy(), dimg.numpy()


def test_pixel_gradient_map_vs_fd(cornell):
    """The whole image's gradient w.r.t. the emitter scale through
    render_fused (16x12, spp 8, depth 3): per pixel against the FD and
    against img / scale (rtol 2e-3, tests/test_grad.py:81). No sampling
    decision depends on the emitter, so both sides trace the same paths."""
    def f(v):
        return tpt.render_fused(_set_row(cornell, 4, v), 16, 12, spp=8,
                                max_depth=3, device="cpu")

    img, dimg = _jvp_image(f, 30.0)
    fd = _fd(lambda v: f(v).numpy(), 30.0, 0.5)
    assert np.isfinite(dimg).all()
    atol = 1e-5 * float(np.abs(fd).max())
    np.testing.assert_allclose(dimg, fd, rtol=2e-3, atol=atol)
    np.testing.assert_allclose(dimg, img / 30.0, rtol=2e-3, atol=atol)
    assert float(np.abs(dimg).max()) > 1e-4


def test_pixel_gradient_reflectance_mean(cornell):
    """The gradient image w.r.t. the white-wall reflectance: the FD crosses
    Russian-roulette decisions per texel, so most texels (> 0.7) and the
    image mean (rtol 0.25) must agree (tests/test_grad.py:114)."""
    def f(v):
        return tpt.render_fused(_set_row(cornell, 2, v), 16, 12, spp=8,
                                max_depth=3, device="cpu")

    _, dimg = _jvp_image(f, 0.75)
    fd = _fd(lambda v: f(v).numpy(), 0.75, 5e-3)
    assert np.isfinite(dimg).all()
    close = np.isclose(dimg, fd, rtol=0.05,
                       atol=0.02 * float(np.abs(fd).max()))
    assert close.mean() > 0.7, f"only {close.mean():.2%} texels agree"
    np.testing.assert_allclose(dimg.mean(), fd.mean(), rtol=0.25)


@pytest.fixture(scope="module")
def ref_spectral():
    from slr_tpu.scene.presets import cornell_box_spheres as jcornell

    return jcornell(spectral=True, **CORNELL)


def test_spectral_gradient(ref_spectral):
    """Spectral mode: the emitter's CURVE row scale (value[emit, 0]) is
    linear in the radiance, grad = f (rtol 1e-3, tests/test_grad.py:140);
    and against jax.grad on the same scene."""
    scene = from_reference(ref_spectral)
    emit_ids = np.unique(scene.materials.emit_stex.numpy())
    emit_ids = emit_ids[emit_ids >= 0]
    assert len(emit_ids) == 1
    emit_id = int(emit_ids[0])
    assert int(scene.stex.kind[emit_id]) == int(STexKind.CURVE)
    o, d = _rays(2, 64, [0.0, 1.2, 1.0])

    g, val = _grad(
        lambda s: _mean_radiance(_scale_entry(scene, emit_id, 0, s), o, d, 3),
        1.0)
    np.testing.assert_allclose(g, val, rtol=1e-3)

    jo, jd = _jax_rays(o, d)

    def jf(s):
        st = ref_spectral.stex
        sc = ref_spectral.replace(stex=st.replace(
            value=st.value.at[emit_id, 0].mul(s)))
        return _jax_mean_radiance(sc, jo, jd, 3)

    np.testing.assert_allclose(g, _jax_grad(jf, 1.0), rtol=JAX_RTOL)


def _plane_and_light(b, mat, uv_scale, light_mat):
    pos = np.array([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]],
                   np.float32)
    nrm = np.tile(np.float32([0, 0, 1]), (4, 1))
    tan = np.tile(np.float32([1, 0, 0]), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale
    b.add_mesh(pos, nrm, tan, uv, np.array([[0, 1, 2], [0, 2, 3]], np.int32),
               mat)
    b.add_mesh(pos * 0.5 + np.float32([0, 0, 3]), -nrm, tan, uv,
               np.array([[0, 2, 1], [0, 3, 2]], np.int32),
               b.add_emitter(light_mat, b.add_stex_const((5.0, 5.0, 5.0))))
    b.set_camera_perspective(np.eye(4, dtype=np.float32), 1.0, 0.5)


def test_checker_texture_gradient():
    """Gradient w.r.t. a procedural texture's colour (the checker's first
    colour, stex 0): against the FD, rtol 0.08 (tests/test_grad.py:177)."""
    b = SceneBuilder()
    chk = b.add_stex_checker((0.2, 0.2, 0.2), (0.8, 0.8, 0.8))
    _plane_and_light(b, b.add_matte(chk), 4.0, b.add_matte(chk))
    scene = b.build(use_bvh=False)
    o, d = _rays(3, 128, [0.0, 0.0, 1.5], shift=(0, 0, 1))

    def f(c0):
        return _mean_radiance(_set_row(scene, 0, c0), o, d, 3)

    g, _ = _grad(f, 0.2)
    np.testing.assert_allclose(g, _fd(f, 0.2, 1e-2), rtol=0.08)
    assert g > 0


def test_image_texture_gradient():
    """d(mean radiance)/d(image texels) through bilinear image sampling, as
    a global image scale: against the FD (rtol 0.08, tests/test_grad.py:228)
    and against jax.grad on the same scene. Depth 2 keeps Russian roulette
    out of these short paths."""
    from slr_tpu.scene.build import SceneBuilder as JBuilder

    b = JBuilder()
    tex = b.add_stex_image(b.add_image(np.full((8, 8, 4), 0.5, np.float32)))
    _plane_and_light(b, b.add_matte(tex), 1.0,
                     b.add_matte(b.add_stex_const((0.5, 0.5, 0.5))))
    ref = b.build(use_bvh=False)
    scene = from_reference(ref)
    o, d = _rays(5, 256, [0.0, 0.0, 1.5], shift=(0, 0, 1))

    def f(s):
        return _mean_radiance(
            _with_stex(scene, images=scene.stex.images * s), o, d, 2)

    g, _ = _grad(f, 1.0)
    np.testing.assert_allclose(g, _fd(f, 1.0, 1e-2), rtol=0.08)
    assert g > 0

    jo, jd = _jax_rays(o, d)

    def jf(s):
        st = ref.stex
        return _jax_mean_radiance(
            ref.replace(stex=st.replace(images=st.images * s)), jo, jd, 2)

    np.testing.assert_allclose(g, _jax_grad(jf, 1.0), rtol=JAX_RTOL)


def test_spectral_curve_gradient():
    """Spectral mode, through the tabulated reflectance curves (every
    constant spectrum is a CURVE row after the build) as a global curve
    scale: against the FD (rtol 0.1, tests/test_grad.py:276)."""
    scene = cornell_box_spheres(spectral=True, device="cpu", **CORNELL)
    o, d = _rays(6, 64, [0.0, 1.2, 1.0])

    def f(s):
        return _mean_radiance(
            _with_stex(scene, curves_v=scene.stex.curves_v * s), o, d, 3)

    g, _ = _grad(f, 1.0)
    np.testing.assert_allclose(g, _fd(f, 1.0, 5e-3), rtol=0.1)
    assert np.isfinite(g) and g != 0.0
