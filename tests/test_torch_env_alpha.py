"""The environment light, the equirectangular camera, alpha cutouts and
normal maps of the port against slr_tpu: the environment's direction and
(u, v) mappings and radiance; its importance map and light share carried
across with `from_reference`; the two-level light pick with an environment
present; equirectangular camera rays; the six-layer cutout of
tests/test_features.py through `scene_intersect_alpha`; `resolve_sp` with a
normal map; and a render of the sphere under a sun-disc environment.

Tolerance: integers and the cutout's t exactly as the reference states it
(t = 7 within 1e-4); floats within rtol 1e-5, atol 1e-6 (the same f32
formulas; sin, cos, atan2 and acos round differently by an ulp); the render
as tests/test_torch_wavefront.py holds it (>= 98% of pixels within rtol
1e-3, means within 1%)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slr_tpu.render import pt as jpt
from slr_tpu.scene import presets as jpresets
from slr_tpu.scene.build import SceneBuilder as JBuilder
from slr_tpu_torch.render import pt as tpt
from slr_tpu_torch.scene import presets as tpresets
from slr_tpu_torch.scene.bridge import from_reference
from slr_tpu_torch.scene.build import SceneBuilder as TBuilder
from test_torch_reference_build import load_reference_sbvh

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_sbvh():
    """Reference tables are built with the SBVH library loaded (see
    test_torch_reference_build.py)."""
    load_reference_sbvh()


RTOL, ATOL = 1e-5, 1e-6
N = 4096


def _close(got, want, name="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol, atol,
                               err_msg=name)


def _sun_sky(h=16, w=32):
    img = np.full((h, w, 3), 0.05, np.float32)
    img[: h // 2] += np.linspace(0.2, 0.6, h // 2, dtype=np.float32)[:, None,
                                                                       None]
    img[h // 3, w // 4] = 300.0
    return img


@pytest.fixture(scope="module")
def env_scenes():
    sky = _sun_sky()
    j = jpresets.env_sphere_scene(env_image=sky, env_scale=1.5,
                                  reflectance=0.5)
    t = tpresets.env_sphere_scene(env_image=sky, env_scale=1.5,
                                  reflectance=0.5, device="cpu")
    return j, t


def test_env_mappings_and_radiance(env_scenes):
    jscene, tscene = env_scenes
    rs = np.random.RandomState(0)
    phi = rs.uniform(0, 2 * np.pi, N).astype(np.float32)
    theta = rs.uniform(0, np.pi, N).astype(np.float32)
    d_j = jpt._env_direction(jnp.asarray(phi), jnp.asarray(theta))
    d_t = tpt._env_direction(torch.as_tensor(phi), torch.as_tensor(theta))
    _close(d_t, d_j, "direction")
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    uv_j = jpt._env_uv_from_direction(jnp.asarray(d))
    uv_t = tpt._env_uv_from_direction(torch.as_tensor(d))
    for g, w in zip(uv_t, uv_j):
        _close(g, w, "uv")
    u, v = (x.numpy() for x in uv_t)
    _close(tpt._env_radiance(tscene, torch.as_tensor(u), torch.as_tensor(v),
                             None),
           jpt._env_radiance(jscene, jnp.asarray(u), jnp.asarray(v), None),
           "radiance")


def test_env_distribution_and_light_pick(env_scenes):
    """The importance map (luminance x sin theta of the sky) and the
    environment's light share, as built by the port and carried across
    from the reference; then the light pick over them."""
    jscene, tscene = env_scenes
    carried = from_reference(jscene)
    for field in ("marg_pdf", "marg_cdf", "cond_pdf", "cond_cdf"):
        # The same f32 sums and prefix sums, in each framework's order.
        _close(getattr(tscene.env.dist, field), getattr(carried.env.dist,
                                                        field), field)
    for name in ("stex", "scale"):
        np.testing.assert_array_equal(getattr(tscene.env, name).numpy(),
                                      getattr(carried.env, name).numpy())
    assert float(tscene.lights.env_prob) == float(jscene.lights.env_prob) == 1
    assert tscene.has_env and carried.has_env
    # A scene with area lights and an environment: the share splits.
    rs = np.random.RandomState(1)

    def lit(b):
        mat = b.add_emitter(b.add_matte(b.add_stex_const((0.5,) * 3)),
                            b.add_stex_const((4.0,) * 3))
        quad = (np.float32([[0, 2, 0], [1, 2, 0], [1, 2, 1], [0, 2, 1]]),
                np.float32([[0, -1, 0]] * 4), np.float32([[1, 0, 0]] * 4),
                np.float32([[0, 0], [1, 0], [1, 1], [0, 1]]),
                np.int32([[0, 1, 2], [0, 2, 3]]))
        b.add_mesh(*quad, mat)
        b.set_environment(b.add_stex_image(b.add_image(_sun_sky())), 2.0)
        return b.build(use_bvh=False)

    j2, t2 = lit(JBuilder()), lit(TBuilder())
    assert float(t2.lights.env_prob) == pytest.approx(1 / 3)
    u = rs.rand(N).astype(np.float32)
    got = tpt._select_light(t2, torch.as_tensor(u))
    want = jpt._select_light(j2, jnp.asarray(u))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_equirect_camera_rays():
    from slr_tpu.camera.perspective import sample_camera_rays_equirect as jcam
    from slr_tpu_torch.camera.perspective import (
        sample_camera_rays_equirect as tcam,
    )

    def cam(b):
        to_world = np.eye(4, dtype=np.float32)
        to_world[:3, 3] = [0.5, 1.0, -2.0]
        to_world[:3, :3] = np.float32([[0, 0, 1], [0, 1, 0], [-1, 0, 0]])
        b.set_camera_equirect(to_world, 1.5 * np.pi, 0.8 * np.pi)
        return b.camera

    jc = cam(JBuilder())
    tc = cam(TBuilder())
    rs = np.random.RandomState(2)
    px = rs.uniform(0, 64, N).astype(np.float32)
    py = rs.uniform(0, 32, N).astype(np.float32)
    want = jcam(jc, jnp.asarray(px), jnp.asarray(py), 64, 32)
    got = tcam(tc, torch.as_tensor(px), torch.as_tensor(py), 64, 32)
    for name in ("o", "d", "weight"):
        _close(getattr(got, name), getattr(want, name), name)


def _cutout_stack(b):
    mat = b.add_matte(b.add_stex_const((0.5, 0.5, 0.5)))
    cut = b.add_ftex_const(0.0)
    quad = (np.float32([[0, 0, 1]] * 4), np.float32([[1, 0, 0]] * 4),
            np.float32([[0, 0], [1, 0], [1, 1], [0, 1]]),
            np.int32([[0, 1, 2], [0, 2, 3]]))
    for i in range(7):
        z = float(i)
        pos = np.float32([[-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z]])
        b.add_mesh(pos, *quad, mat, alpha_ftex=(cut if i < 6 else -1))
    b.set_camera_perspective(np.eye(4, dtype=np.float32), 1.0, 0.5)
    return b.build(use_bvh=False)


def test_six_layer_cutout():
    """A ray through 6 fully cut-out quads reaches the 7th, solid one at
    t = 7: the recast loop has no cap (tests/test_features.py:140-172); a
    shadow ray through them is not occluded before it."""
    scene = _cutout_stack(TBuilder())
    # (0.1, 0.1) as the reference's test has it (on the quads' diagonal,
    # where either triangle may win), and a point off the diagonal.
    o = torch.tensor([[0.1, 0.1, -1.0], [0.1, 0.1, -1.0], [0.3, -0.2, -1.0],
                      [0.3, -0.2, -1.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    tpt.reset_alpha_recasts()
    hit = tpt.scene_intersect_alpha(scene, o, d)
    assert bool(hit.mask.all())
    np.testing.assert_allclose(hit.t.numpy(), 7.0, atol=1e-4)
    assert tpt.ALPHA_RECASTS == {"casts": 6, "rays": 24}
    occ = tpt.scene_occluded(scene, o, d, 1e-4, torch.tensor([6.5, 7.5] * 2))
    assert occ.tolist() == [False, True] * 2
    ref = jpt.scene_intersect_alpha(_cutout_stack(JBuilder()),
                                    jnp.asarray(o.numpy()),
                                    jnp.asarray(d.numpy()))
    np.testing.assert_array_equal(hit.t.numpy(), np.asarray(ref.t))
    np.testing.assert_array_equal(hit.tri.numpy()[2:], np.asarray(ref.tri)[2:])


def _normal_mapped(b, rs):
    img = rs.uniform(0.2, 0.8, (9, 11, 3)).astype(np.float32)
    img[..., 2] = 0.95
    nt = b.add_ntex_image(b.add_image(img), (2.0, 1.0))
    nc = b.add_ntex_checker(0.2, True, (3.0, 3.0))
    mat = b.add_matte(b.add_stex_const((0.5, 0.5, 0.5)))
    pos = np.float32([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]])
    nrm = np.float32([[0.1, 0, 1], [0, 0.1, 1], [0, 0, 1], [-0.1, 0, 1]])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    common = (nrm, np.float32([[1, 0, 0]] * 4),
              np.float32([[0, 0], [1, 0], [1, 1], [0, 1]]))
    b.add_mesh(pos, *common, np.int32([[0, 1, 2]]), mat, normal_ntex=nt)
    b.add_mesh(pos, *common, np.int32([[0, 2, 3]]), mat, normal_ntex=nc)
    b.add_mesh(pos + np.float32([0, 0, -1]), *common,
               np.int32([[0, 1, 2], [0, 2, 3]]), mat)
    return b.build(use_bvh=False)


def test_resolve_sp_with_normal_maps():
    """An image normal map, a reversed checker one and a plain surface
    behind: the perturbed shading frames as the reference resolves them."""
    jscene = _normal_mapped(JBuilder(), np.random.RandomState(3))
    tscene = _normal_mapped(TBuilder(), np.random.RandomState(3))
    assert tscene.has_normal_map and jscene.has_normal_map
    rs = np.random.RandomState(4)
    o = np.concatenate([rs.uniform(-1.2, 1.2, (N, 2)),
                        np.full((N, 1), 2.0)], 1).astype(np.float32)
    d = np.float32([[0.05, -0.02, -1.0]] * N)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    thit = tpt.scene_intersect(tscene, torch.as_tensor(o), torch.as_tensor(d))
    jhit = jpt.scene_intersect(jscene, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(thit.tri.numpy(), np.asarray(jhit.tri))
    assert {0, 1, 2} <= set(np.asarray(jhit.tri).tolist())
    tsp = tpt.resolve_sp(tscene, thit, torch.as_tensor(o), torch.as_tensor(d))
    jsp = jpt.resolve_sp(jscene, jhit, jnp.asarray(o), jnp.asarray(d))
    hit = np.asarray(jhit.mask)
    for name in ("p", "gn", "sn", "tangent", "bitangent", "uv"):
        _close(getattr(tsp, name).numpy()[hit],
               np.asarray(getattr(jsp, name))[hit], name, atol=2e-6)


def test_env_sphere_render_matches_reference(env_scenes):
    """The sphere under the sun-disc sky, RGB, 16x16, spp 4, depth 6:
    environment hits on a miss with MIS against the BSDF, environment NEE
    through the importance map, the any-hit shadow casts."""
    from slr_tpu.render.wavefront import render_wavefront as jrender
    from slr_tpu_torch.render.wavefront import render_wavefront

    jscene, _ = env_scenes
    want, jit = jrender(jscene, 16, 16, spp=4, seed=3, max_depth=6,
                        return_iters=True)
    got, it = render_wavefront(from_reference(jscene), 16, 16, spp=4, seed=3,
                               max_depth=6, return_iters=True, device="cpu")
    want, got = np.asarray(want), got.numpy()
    assert np.isfinite(got).all() and it == jit
    close = (np.abs(got - want) <= 1e-3 * np.abs(want) + 1e-6).all(-1)
    assert close.mean() >= 0.98
    assert abs(got.mean() / want.mean() - 1.0) < 0.01


def _scene_leaves(obj, path=""):
    import dataclasses

    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _scene_leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for name in obj._fields:
            yield from _scene_leaves(getattr(obj, name), f"{path}.{name}")
    else:
        yield path, obj


@pytest.mark.parametrize("name", ["glass_corridor", "env_sphere_scene"])
def test_presets_match_reference(name):
    """The two presets this slice adds, built by each package: every leaf
    (integers and chunk tables exactly, floats within rtol 1e-5)."""
    kw = {"env_image": _sun_sky()} if name == "env_sphere_scene" else {}
    carried = from_reference(getattr(jpresets, name)(**kw))
    carried.plucker = None
    port = getattr(tpresets, name)(device="cpu", **kw)
    got, want = dict(_scene_leaves(port)), dict(_scene_leaves(carried))
    assert got.keys() == want.keys() and len(want) > 80
    for path, w in want.items():
        g = got[path]
        if not isinstance(w, torch.Tensor):
            assert g == w, path
        elif w.dtype.is_floating_point and not path.startswith(
                (".pallas_tris", ".bvh")):
            _close(g.numpy(), w.numpy(), path)
        else:
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=path)


def test_recasts_advance_on_grazing_rays(monkeypatch):
    """A ray 2e-7 above a cut-out card, grazing it: the cast's own t and
    the Möller-Trumbore t of its hit differ by 0.6 here (1e-4 is the
    recast's step). The reference's loop steps from the latter and finds
    the same triangle again, forever; the port steps from the former, and
    one recast finds nothing beyond the card (the ray never descends to
    the wall). Casts are counted, so a stall fails the test instead of
    hanging it."""
    b = TBuilder()
    mat = b.add_matte(b.add_stex_const((0.5, 0.5, 0.5)))
    quad = (np.float32([[0, 0, 1]] * 4), np.float32([[1, 0, 0]] * 4),
            np.float32([[0, 0], [1, 0], [1, 1], [0, 1]]),
            np.int32([[0, 1, 2], [0, 2, 3]]))
    b.add_mesh(np.float32([[-0.9, 0.35, 1.15], [0.1, 0.35, 1.15],
                           [0.1, 1.55, 1.15], [-0.9, 1.55, 1.15]]), *quad,
               mat, alpha_ftex=b.add_ftex_const(0.0))
    b.add_mesh(np.float32([[-3, -3, -2], [3, -3, -2], [3, 3, -2],
                           [-3, 3, -2]]), *quad, mat)
    scene = b.build(use_bvh=False)
    o = torch.tensor([[-2.0649166107177734, -0.34723100066185,
                       1.1500002145767212]])
    d = torch.tensor([[0.8896901607513428, 0.45656484365463257,
                       -1.0005462058870762e-07]])
    first = tpt.scene_intersect(scene, o, d)
    assert int(first.tri) == 0 and float(first.t_cast - first.t) > 0.1
    casts = []
    cast = tpt.scene_intersect

    def counted(*args, **kw):
        casts.append(1)
        assert len(casts) < 10, "the recast loop makes no progress"
        return cast(*args, **kw)

    monkeypatch.setattr(tpt, "scene_intersect", counted)
    tpt.reset_alpha_recasts()
    hit = tpt.scene_intersect_alpha(scene, o, d)
    assert not bool(hit.mask.any()) and len(casts) == 2
    assert tpt.ALPHA_RECASTS == {"casts": 1, "rays": 1}
