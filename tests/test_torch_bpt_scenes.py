"""Two more configurations of slr_tpu_torch's `bpt_batch` against slr_tpu's
(the criterion of test_torch_bpt.py: >= 98% of film entries within rtol
1e-3 / atol 1e-5, means within 1%): the animated instanced scene of
tests/test_bpt.py (a quad sweeping across the shutter; one time sample per
pixel sample through every cast), and the lens-only eye cap
(max_eye_verts=1), where every contribution is a t = 1 splat. Each compiles
the reference's `bpt_batch` once; they live apart from test_torch_bpt.py so
that the test workers share the compile time."""
import numpy as np
import pytest
import torch

from slr_tpu_torch.render import bpt as tb
from slr_tpu_torch.scene.bridge import from_reference
from test_torch_bpt import _agreement, film_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref():
    import types

    import jax.numpy as jnp
    from slr_tpu.render import bpt as jb
    from test_torch_reference_build import load_reference_sbvh

    load_reference_sbvh()
    return types.SimpleNamespace(jnp=jnp, bpt=jb)


def animated_scene(x0, x1=None):
    """tests/test_bpt.py's scene: a floor, a ceiling light and an instanced
    quad translated from x0 to x1 across the shutter, built by the
    reference's SceneBuilder."""
    import slr_tpu.core.math3d as m3
    from slr_tpu.scene.build import SceneBuilder

    b = SceneBuilder()
    white = b.add_matte(b.add_stex_const((0.6,) * 3))
    g = np.float32([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]])
    nrm = np.tile(np.float32([0, 1, 0]), (4, 1))
    tan = np.tile(np.float32([1, 0, 0]), (4, 1))
    b.add_mesh(g, nrm, tan, np.zeros((4, 2), np.float32),
               np.array([[0, 1, 2], [0, 2, 3]], np.int32), white)
    em = b.add_stex_const((30.0,) * 3)
    lm = b.add_emitter(b.add_matte(b.add_stex_const((0.5,) * 3)), em)
    s = np.float32([[-1, 3, -1], [1, 3, -1], [1, 3, 1], [-1, 3, 1]])
    b.add_mesh(s, np.tile(np.float32([0, -1, 0]), (4, 1)), tan,
               np.zeros((4, 2), np.float32),
               np.array([[0, 2, 1], [0, 3, 2]], np.int32), lm)
    bid = b.begin_blas()
    q = np.float32([[-0.6, 0, 0], [0.6, 0, 0], [0.6, 1.4, 0],
                    [-0.6, 1.4, 0]])
    b.add_mesh(q, np.tile(np.float32([0, 0, 1]), (4, 1)), tan,
               np.zeros((4, 2), np.float32),
               np.array([[0, 1, 2], [0, 2, 3]], np.int32), white)
    b.end_blas()
    m0 = np.eye(4, dtype=np.float32)
    m0[0, 3] = x0
    if x1 is None:
        b.add_instance(bid, m0)
    else:
        m1 = m0.copy()
        m1[0, 3] = x1
        b.add_instance(bid, m0, m1)
    cam = (np.asarray(m3.mat_translate(np.array([0.0, 1.0, 3.0])))
           @ np.asarray(m3.mat_rotate_y(np.pi))).astype(np.float32)
    b.set_camera_perspective(cam, 4.0 / 3.0, 1.0)
    return b.build(use_bvh=False)


def test_bpt_batch_animated_matches_reference(ref):
    """Instances and motion blur: each pixel sample's shutter time goes
    through both subpaths' casts and the connection casts (tiled s-major
    over the light vertices), at 24x18, caps 3 + 3."""
    sc = animated_scene(-1.0, 1.0)
    port = from_reference(sc)
    assert port.instances is not None
    want, got = film_pair(ref, sc, port, 24, 18, (3, 3))
    assert np.isfinite(got).all() and got.mean() > 0.0
    close, rel = _agreement(got, want)
    assert close >= 0.98, close
    assert rel < 0.01, rel


def test_bpt_batch_lens_only_matches_reference(ref):
    """max_eye_verts=1: the eye subpath is the lens vertex alone (empty
    vertex tables), and the film is the t = 1 splats, at 24x18 with light
    cap 4 on the RGB Cornell box."""
    from slr_tpu.scene.presets import cornell_box_spheres as ref_cornell

    sc = ref_cornell(sphere_res=6)
    want, got = film_pair(ref, sc, from_reference(sc), 24, 18, (4, 1))
    assert (got > 0).any(-1).mean() > 0.3
    close, rel = _agreement(got, want)
    assert close >= 0.98, close
    assert rel < 0.01, rel


def test_bpt_integrates_the_shutter():
    """The port's image of the sweeping quad sits closer to the mean of
    the two frozen endpoint renders than to either (tests/test_bpt.py's
    gate: 0.75 of the distance to each endpoint)."""
    w, h, spp = 32, 24, 32
    kw = dict(max_light_verts=3, max_eye_verts=3, device="cpu")
    blur, i0, i1 = (tb.render_bpt(from_reference(animated_scene(*xs)), w, h,
                                  spp=spp, **kw).numpy()
                    for xs in ((-1.0, 1.0), (-1.0,), (1.0,)))
    d_avg = np.abs(blur - 0.5 * (i0 + i1)).mean()
    assert np.abs(i0 - i1).mean() > 0.03
    assert d_avg < 0.75 * np.abs(blur - i0).mean()
    assert d_avg < 0.75 * np.abs(blur - i1).mean()
