"""Textures and spectra of the rest of the shading against slr_tpu: every
spectrum, float and normal texture kind, built by both packages' scene
builders from the same calls (the tables compared leaf by leaf) and
evaluated at the same seeded uv and world positions; the Voronoi hashes and
the image texel addresses bit for bit; perturb_frame; the device-side
Meng-Simon evaluator, rgb_to_spectrum, irregular and ColorChecker spectra.

Tolerance: integers and texel addresses exactly; float values within rtol
1e-5, atol 1e-6 (the same f32 formulas; summation order may differ by an
ulp)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slr_tpu.scene import textures as jt
from slr_tpu.scene.build import SceneBuilder as JBuilder
from slr_tpu.spectrum import spectral as jspec
from slr_tpu_torch.scene import textures as tt
from slr_tpu_torch.scene.bridge import from_reference
from slr_tpu_torch.scene.build import SceneBuilder as TBuilder
from slr_tpu_torch.spectrum import spectral as tspec

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N = 2048


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), RTOL, ATOL,
                               err_msg=name)


def _images(rs):
    """Two linear RGBA images of different sizes (the atlas pads them)."""
    a = rs.uniform(0, 1, (13, 21, 4)).astype(np.float32)
    a[..., 3] = np.where(rs.rand(13, 21) < 0.3, 0.0, a[..., 3])
    b = rs.uniform(0, 1, (8, 5, 3)).astype(np.float32)
    return a, b


def _populate(b, rs, spectral):
    """The same calls on either package's builder: every texture kind."""
    img_a, img_b = _images(rs)
    ia, ib = b.add_image(img_a), b.add_image(img_b)
    s = [b.add_stex_const((0.3, 0.6, 0.9)),
         b.add_stex_checker((0.9, 0.2, 0.1), (0.1, 0.3, 0.8), (3.0, 2.0),
                            (0.1, -0.2)),
         b.add_stex_voronoi(0.15, 0.7),
         b.add_stex_image(ia, 1.0, (1.5, 0.7), (0.3, 0.0)),
         b.add_stex_image(ib, 0.8),
         b.add_stex_colorchecker(7, 1.2)]
    if spectral:
        s.append(b.add_stex_d65(0.5))
        s.append(b.add_stex_ior("Aluminium", 1))
    lum = b.add_ftex_image(ia, "lum", 0.9, (2.0, 2.0))
    vor = b.add_ftex_voronoi(0.2, 0.8)
    f = [b.add_ftex_const(0.4), b.add_ftex_checker(0.2, 0.7, (4.0, 4.0)),
         lum, b.add_ftex_image(ia, "alpha"), vor, b.add_ftex_one_minus(vor),
         b.add_ftex_one_minus(lum)]
    n = [b.add_ntex_image(ib, (1.3, 1.0)), b.add_ntex_checker(0.1),
         b.add_ntex_checker(0.3, True, (2.0, 2.0), (0.5, 0.25))]
    mat = b.add_matte(s[0])
    quad = (np.float32([[0, 0, 0], [1, 0, 0], [1, 1, 0]]),
            np.float32([[0, 0, 1]] * 3), np.float32([[1, 0, 0]] * 3),
            np.float32([[0, 0], [1, 0], [1, 1]]), np.int32([[0, 1, 2]]))
    b.add_mesh(*quad, mat, alpha_ftex=f[3], normal_ntex=n[0])
    return s, f, n


@pytest.fixture(scope="module", params=[False, True], ids=["rgb", "spectral"])
def scenes(request):
    spectral = request.param
    jb = JBuilder(spectral=spectral)
    ids = _populate(jb, np.random.RandomState(0), spectral)
    tb = TBuilder(spectral=spectral)
    assert _populate(tb, np.random.RandomState(0), spectral) == ids
    return spectral, jb.build(use_bvh=False), tb.build(use_bvh=False), ids


def _queries(seed, n_ids, spectral):
    rs = np.random.RandomState(seed)
    uv = rs.uniform(-2.5, 2.5, (N, 2)).astype(np.float32)
    uv[:16] = [[0, 0], [1, 1], [-1, 0.5], [0.5, -1e-8]] * 4   # wrap edges
    wpos = rs.uniform(-3, 3, (N, 3)).astype(np.float32)
    tid = rs.randint(-1, n_ids, N).astype(np.int32)
    off = rs.rand(N).astype(np.float32)
    lam = (360 + 470 * (np.arange(16)[None, :] + off[:, None]) / 16
           ).astype(np.float32)
    return uv, wpos, tid, lam


def test_texture_tables_match_reference(scenes):
    """Every texture leaf, flag and the image atlas as the reference
    builds them."""
    _, jscene, tscene, _ = scenes
    carried = from_reference(jscene)
    for name in ("stex", "ftex", "ntex"):
        j, t = getattr(carried, name), getattr(tscene, name)
        for field in j.__dataclass_fields__:
            a, b = getattr(j, field), getattr(t, field)
            if isinstance(a, torch.Tensor):
                np.testing.assert_array_equal(b.numpy(), a.numpy(),
                                              err_msg=f"{name}.{field}")
            else:
                assert a == b, f"{name}.{field}"
    for field in ("has_alpha", "has_normal_map"):
        assert getattr(tscene, field) and getattr(jscene, field)


@pytest.mark.parametrize("with_wpos", [False, True], ids=["uv", "wpos"])
def test_spectrum_textures(scenes, with_wpos):
    spectral, jscene, tscene, (s, _, _) = scenes
    uv, wpos, tid, lam = _queries(1, len(s), spectral)
    wp = (jnp.asarray(wpos), torch.as_tensor(wpos)) if with_wpos else (None,
                                                                        None)
    lam_j, lam_t = ((jnp.asarray(lam), torch.as_tensor(lam)) if spectral
                    else (None, None))
    want = jt.eval_stex(jscene.stex, jnp.asarray(tid), jnp.asarray(uv), lam_j,
                        wp[0])
    got = tt.eval_stex(tscene.stex, torch.as_tensor(tid), torch.as_tensor(uv),
                       lam_t, wp[1])
    _close(got, want)


@pytest.mark.parametrize("with_wpos", [False, True], ids=["uv", "wpos"])
def test_float_textures(scenes, with_wpos):
    _, jscene, tscene, (_, f, _) = scenes
    uv, wpos, tid, _ = _queries(2, len(f), False)
    wp = (jnp.asarray(wpos), torch.as_tensor(wpos)) if with_wpos else (None,
                                                                        None)
    for fn in ("eval_float_texture", "eval_float_texture_default1"):
        want = getattr(jt, fn)(jscene.ftex, jnp.asarray(tid), jnp.asarray(uv),
                               jscene.stex.images, jscene.stex.image_hw,
                               wp[0])
        got = getattr(tt, fn)(tscene.ftex, torch.as_tensor(tid),
                              torch.as_tensor(uv), tscene.stex.images,
                              tscene.stex.image_hw, wp[1])
        _close(got, want, fn)
    # The alpha texture has true zeros where the image's alpha is zero.
    alpha = tt.eval_float_texture(tscene.ftex, torch.full((N,), f[3]),
                                  torch.as_tensor(uv), tscene.stex.images,
                                  tscene.stex.image_hw)
    assert 0.1 < float((alpha == 0.0).float().mean()) < 0.6


def test_normal_textures_and_perturb_frame(scenes):
    _, jscene, tscene, (_, _, n) = scenes
    uv, _, tid, _ = _queries(3, len(n), False)
    want = jt.eval_normal_texture(jscene.ntex, jscene.stex.images,
                                  jscene.stex.image_hw, jnp.asarray(tid),
                                  jnp.asarray(uv))
    got = tt.eval_normal_texture(tscene.ntex, tscene.stex.images,
                                 tscene.stex.image_hw, torch.as_tensor(tid),
                                 torch.as_tensor(uv))
    _close(got, want)
    from slr_tpu.accel.intersect import SurfacePoint as JSP
    from slr_tpu_torch.accel.intersect import SurfacePoint as TSP

    rs = np.random.RandomState(4)
    sn = rs.normal(size=(N, 3)).astype(np.float32)
    sn /= np.linalg.norm(sn, axis=1, keepdims=True)
    tan = np.cross(sn, rs.normal(size=(N, 3))).astype(np.float32)
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    bit = np.cross(sn, tan).astype(np.float32)
    fields = dict(p=sn, gn=sn, sn=sn, tangent=tan, bitangent=bit,
                  uv=uv, mat_id=np.zeros(N, np.int32),
                  area_pdf=np.ones(N, np.float32))
    jsp = JSP(**{k: jnp.asarray(v) for k, v in fields.items()})
    tsp = TSP(**{k: torch.as_tensor(v) for k, v in fields.items()})
    jo = jt.perturb_frame(jsp, want)
    to = tt.perturb_frame(tsp, got)
    for name in ("tangent", "bitangent", "sn"):
        _close(getattr(to, name), getattr(jo, name), name)


def test_texel_addresses_bit_for_bit(scenes):
    _, jscene, tscene, _ = scenes
    rs = np.random.RandomState(5)
    u = rs.uniform(-3, 3, N).astype(np.float32)
    v = rs.uniform(-3, 3, N).astype(np.float32)
    u[:6] = [0.0, 1.0, -1.0, -1e-8, 0.999999, 3.0]
    iid = rs.randint(-1, 3, N).astype(np.int32)
    want = jt.texel_coords(jscene.stex.image_hw, jnp.asarray(iid),
                           jnp.asarray(u), jnp.asarray(v), 2)
    got = tt.texel_coords(tscene.stex.image_hw, torch.as_tensor(iid),
                          torch.as_tensor(u), torch.as_tensor(v), 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_voronoi_hashes_bit_for_bit():
    """FNV-1 cell hashes, the LCG's states and floats, and the winning
    feature's seed, as uint32 values."""
    rs = np.random.RandomState(6)
    c = [rs.randint(-2 ** 31, 2 ** 31 - 1, N).astype(np.int32)
         for _ in range(3)]
    want = np.asarray(jt._fnv1_hash_3i(*(jnp.asarray(x) for x in c)))
    got = tt._fnv1_hash_3i(*(torch.as_tensor(x) for x in c)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    state_j, state_t = jnp.asarray(want), torch.as_tensor(got)
    for _ in range(4):
        state_j, f_j = jt._lcg_next(state_j)
        state_t, f_t = tt._lcg_next(state_t)
        np.testing.assert_array_equal(state_t.numpy(),
                                      np.asarray(state_j).astype(np.int64))
        np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    p = rs.uniform(-5, 5, (N, 3)).astype(np.float32)
    scale = rs.uniform(0.05, 1.0, N).astype(np.float32)
    seed_j, dist_j = jt.voronoi_cell_feature(jnp.asarray(p),
                                             jnp.asarray(scale))
    seed_t, dist_t = tt.voronoi_cell_feature(torch.as_tensor(p),
                                             torch.as_tensor(scale))
    np.testing.assert_array_equal(seed_t.numpy(),
                                  np.asarray(seed_j).astype(np.int64))
    _close(dist_t, dist_j)


def test_upsampling_and_spectra():
    """The Meng-Simon evaluator (inside the grid, at its fan-shaped
    boundary and outside it), rgb_to_spectrum, irregular and ColorChecker
    spectra."""
    rs = np.random.RandomState(7)
    off = rs.rand(N).astype(np.float32)
    lam = (360 + 470 * (np.arange(16)[None, :] + off[:, None]) / 16
           ).astype(np.float32)
    u = rs.uniform(-1, 13, N).astype(np.float32)
    v = rs.uniform(-1, 15, N).astype(np.float32)
    scale = rs.uniform(0.1, 2.0, N).astype(np.float32)
    _close(tspec.upsample_eval(torch.as_tensor(u), torch.as_tensor(v),
                               torch.as_tensor(scale), torch.as_tensor(lam)),
           jspec.upsample_eval(jnp.asarray(u), jnp.asarray(v),
                               jnp.asarray(scale), jnp.asarray(lam)))
    rgb = rs.uniform(0, 1.5, (N, 3)).astype(np.float32)
    rgb[:8] = 0.0
    for illum in (False, True):
        _close(tspec.srgb_to_uvs(torch.as_tensor(rgb), illum),
               jspec.srgb_to_uvs(jnp.asarray(rgb), illum))
        _close(tspec.rgb_to_spectrum(torch.as_tensor(rgb),
                                     torch.as_tensor(lam), illum),
               jspec.rgb_to_spectrum(jnp.asarray(rgb), jnp.asarray(lam),
                                     illum))
    wls, etas, _ = tspec.ior_spectrum("Glass_BK7")
    _close(tspec.eval_irregular_spectrum(torch.as_tensor(wls),
                                         torch.as_tensor(etas),
                                         torch.as_tensor(lam)),
           jspec.eval_irregular_spectrum(jnp.asarray(wls), jnp.asarray(etas),
                                         jnp.asarray(lam)))
    for patch in (0, 13, 23):
        _close(tspec.colorchecker_spectrum(patch, torch.as_tensor(lam)),
               jspec.colorchecker_spectrum(patch, jnp.asarray(lam)))
