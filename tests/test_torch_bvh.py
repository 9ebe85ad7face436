"""SBVH treelet chunk tables: the port's native builder
(slr_tpu_torch/native), `accel/lbvh.py` and `build_pallas_tris(bvh=...)`
against slr_tpu's, bit for bit, and the CUDA kernels' per-ray culling rule
on these tables.

A triangle cut by a spatial split sits in several chunks, and a chunk's box
is its subtree's node box, which holds only the part of each triangle on its
side of the splits. The kernels cull per ray, so on such tables closest hit
may find a triangle through another chunk than the plain version does:
another slot, the same triangle and t. Closest hit is therefore compared by
triangle and t after the remap; any hit stays bit for bit."""
import os
import types
from unittest import mock

import numpy as np
import pytest
import torch

from slr_tpu_torch.accel import lbvh
from slr_tpu_torch.accel import traverse as tv
from slr_tpu_torch.accel.intersect import RAY_EPSILON
from slr_tpu_torch.camera.perspective import sample_camera_rays
from slr_tpu_torch.native import sbvh_build
from slr_tpu_torch.scene.api import load_scene
from slr_tpu_torch.scene.presets import cornell_box_spheres, grass_field
from test_torch_traverse_cull import any_hit_culled, closest_hit_culled
from test_torch_reference_build import load_reference_sbvh

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_sbvh():
    """Reference tables are built with the SBVH library loaded (see
    test_torch_reference_build.py)."""
    load_reference_sbvh()


PARITY = os.path.join(os.path.dirname(__file__), "parity_scenes",
                      "Cornell_Box_Parity.txt")
GRASS = dict(n_side=16, blade_segments=5, animated_fraction=0.25)
N_RAYS = 640


@pytest.fixture(scope="module")
def ref():
    from slr_tpu import native
    from slr_tpu.accel import lbvh as jlbvh
    from slr_tpu.accel import pallas_intersect
    from slr_tpu.scene import api, presets

    return types.SimpleNamespace(native=native, lbvh=jlbvh,
                                 pi=pallas_intersect, api=api,
                                 presets=presets)


def _soup(t, seed, spread=0.3):
    rs = np.random.RandomState(seed)
    c = rs.rand(t, 3).astype(np.float32) * 10
    return [c + rs.randn(t, 3).astype(np.float32) * spread for _ in range(3)]


def _skinny(t, seed):
    """Long diagonal triangles that overlap: spatial splits fire."""
    a = np.random.RandomState(seed).rand(t, 3).astype(np.float32)
    return [a, a + np.float32([4.0, 0.05, 0.05]), a + np.float32([4.0, 0.1, 0.0])]


def _static_tris(scene):
    pos = scene.geometry.positions.numpy()
    tri = scene.geometry.tri_vidx.numpy()[:scene.n_static]
    return [pos[tri[:, k]] for k in range(3)]


@pytest.fixture(scope="module")
def triangle_sets():
    return {
        "soup": _soup(400, 0),
        "soup-wide": _soup(1500, 5, spread=1.0),
        "skinny": _skinny(64, 3),
        "parity": _static_tris(load_scene(PARITY, device="cpu")[0]),
        "grass": _static_tris(grass_field(device="cpu", **GRASS)),
    }


# -- the native builder -------------------------------------------------------

@pytest.mark.parametrize("name", ["soup", "soup-wide", "skinny", "parity",
                                  "grass"])
def test_sbvh_build_matches_reference_bit_for_bit(ref, triangle_sets, name):
    p0, p1, p2 = triangle_sets[name]
    want = ref.native.sbvh_build(p0, p1, p2)
    got = sbvh_build(p0, p1, p2)
    assert want is not None and got is not None
    for k in ("node_min", "node_max", "node_left", "node_right",
              "prim_order"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("n_nodes", "n_refs", "depth", "sah_cost", "budget_hit"):
        assert getattr(got, k) == getattr(want, k), k
    if name == "skinny":
        assert got.n_refs > len(p0)        # spatial splits duplicated refs


def test_sbvh_build_options_and_small_inputs(ref, triangle_sets):
    p0, p1, p2 = triangle_sets["skinny"]
    for kw in (dict(spatial=False), dict(alpha=1.0), dict(budget=1.2),
               dict(prim_cost=np.linspace(1, 3, len(p0)).astype(np.float32))):
        a, b = sbvh_build(p0, p1, p2, **kw), ref.native.sbvh_build(p0, p1,
                                                                   p2, **kw)
        np.testing.assert_array_equal(a.prim_order, b.prim_order)
        np.testing.assert_array_equal(a.node_min, b.node_min)
        assert (a.n_refs, a.depth, a.sah_cost) == (b.n_refs, b.depth,
                                                   b.sah_cost)
    assert sbvh_build(p0[:1], p1[:1], p2[:1]) is None


# -- accel/lbvh.py --------------------------------------------------------------

def _positions_and_tris(p0, p1, p2):
    n = len(p0)
    pos = np.stack([p0, p1, p2], axis=1).reshape(-1, 3)
    return pos, np.arange(3 * n, dtype=np.int32).reshape(n, 3)


def _assert_bvh_equal(got, want):
    for k in ("node_min", "node_max", "node_left", "node_right",
              "prim_order"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("method", ["auto", "sbvh", "lbvh"])
@pytest.mark.parametrize("name", ["soup", "parity"])
def test_build_bvh_matches_reference(ref, triangle_sets, name, method):
    pos, tri = _positions_and_tris(*triangle_sets[name])
    _assert_bvh_equal(lbvh.build_bvh(pos, tri, method),
                      ref.lbvh.build_bvh(pos, tri, method))


def test_build_lbvh_edge_cases_match_reference(ref, triangle_sets):
    pos, tri = _positions_and_tris(*triangle_sets["soup"])
    for n in (1, 2, 3, 17):
        _assert_bvh_equal(lbvh.build_lbvh(pos, tri[:n]),
                          ref.lbvh.build_lbvh(pos, tri[:n]))
    # auto with a single triangle: the median-split builder, as there.
    _assert_bvh_equal(lbvh.build_bvh(pos, tri[:1]),
                      ref.lbvh.build_bvh(pos, tri[:1]))
    with pytest.raises(ValueError):
        lbvh.build_bvh(pos, tri, "octree")


def test_deep_tree_falls_back_to_lbvh(ref, triangle_sets):
    """A tree too deep for the reference's traversal stack (depth + 2 >=
    MAX_STACK) is replaced by the LBVH in both packages."""
    pos, tri = _positions_and_tris(*triangle_sets["soup"])
    shallow = types.SimpleNamespace(**vars(sbvh_build(
        *triangle_sets["soup"])))
    shallow.depth = lbvh.MAX_STACK - 2
    with mock.patch("slr_tpu_torch.native.sbvh_build",
                    lambda *a, **k: shallow):
        got = lbvh.build_bvh(pos, tri)
        with pytest.raises(RuntimeError):
            lbvh.build_bvh(pos, tri, "sbvh")
    _assert_bvh_equal(got, ref.lbvh.build_lbvh(pos, tri))


@pytest.mark.parametrize("n", [2, 3, 40, 257])
def test_build_bvh_boxes_np_matches_reference(ref, n):
    rs = np.random.RandomState(n)
    lo = rs.uniform(-5, 5, (n, 3)).astype(np.float32)
    hi = lo + rs.uniform(0, 2, (n, 3)).astype(np.float32)
    for a, b in zip(lbvh.build_bvh_boxes_np(lo, hi),
                    ref.lbvh.build_bvh_boxes_np(lo, hi)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- chunk tables ---------------------------------------------------------------

_TABLES = ("tris", "boxes", "remap", "entry_chunk", "entry_inst", "inst_trs")


def _assert_tables_equal(port_pt, ref_pt):
    for k in _TABLES:
        a, b = getattr(port_pt, k).numpy(), np.asarray(getattr(ref_pt, k))
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    remap = np.asarray(ref_pt.remap).reshape(port_pt.n_chunks, -1)
    np.testing.assert_array_equal(port_pt.n_valid.numpy(),
                                  (remap >= 0).sum(1))


def _chopped(scene) -> int:
    """Chunks whose box does not hold every vertex of their triangles."""
    pt = scene.pallas_tris
    pos = scene.geometry.positions.numpy()
    tri = scene.geometry.tri_vidx.numpy()
    remap = pt.remap.numpy().reshape(pt.n_chunks, -1)
    boxes = pt.boxes.numpy()
    n = 0
    for c in range(pt.n_chunks):
        v = pos[tri[remap[c][remap[c] >= 0]]].reshape(-1, 3)
        n += bool(((v < boxes[c, 0:3]) | (v > boxes[c, 3:6])).any())
    return n


@pytest.fixture(scope="module")
def sbvh_scenes(ref):
    """(reference scene, port scene), both on SBVH treelet tables."""
    out = {}
    for spectral in (False, True):
        out[f"cornell-{'spectral' if spectral else 'rgb'}"] = (
            ref.presets.cornell_box_spheres(sphere_res=8, spectral=spectral),
            cornell_box_spheres(sphere_res=8, spectral=spectral,
                                device="cpu"))
    out["parity"] = (ref.api.load_scene(PARITY, spectral=True)[0],
                     load_scene(PARITY, spectral=True, device="cpu")[0])
    return out


@pytest.mark.parametrize("name", ["cornell-rgb", "cornell-spectral",
                                  "parity"])
def test_sbvh_chunk_tables_match_reference(sbvh_scenes, name):
    rsc, port = sbvh_scenes[name]
    _assert_bvh_equal(port.bvh, rsc.bvh)
    _assert_tables_equal(port.pallas_tris, rsc.pallas_tris)
    pt = port.pallas_tris
    # Treelets of the SBVH: more references than triangles, and node boxes
    # that need not hold their chunks' triangles.
    assert int(pt.n_valid.sum()) > port.n_static
    assert _chopped(port) > 0
    # Rebuilt from the carried tree, the tables are the same again.
    again = tv.build_pallas_tris(port.geometry, bvh=port.bvh)
    _assert_tables_equal(again, rsc.pallas_tris)


def test_defaults_build_the_reference_tables(ref):
    """With default arguments both packages cut the same SBVH treelet
    tables: the port used to default to Morton slices."""
    pairs = [(ref.presets.cornell_box_spheres(sphere_res=8),
              cornell_box_spheres(sphere_res=8, device="cpu"))]
    pairs.append((ref.presets.grass_field(**GRASS),
                  grass_field(device="cpu", **GRASS)))
    for rsc, port in pairs:
        assert port.bvh is not None
        _assert_bvh_equal(port.bvh, rsc.bvh)
        _assert_tables_equal(port.pallas_tris, rsc.pallas_tris)
        assert port.super_boxes_blob == rsc.super_boxes_blob


# -- the kernels' culling rule on SBVH tables ------------------------------------

def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _rays(scene, kind, seed):
    """(o, d, tmax, active) of a seeded set in the Cornell-sized box:
    camera rays, in-box rays with an active mask, shadow rays toward the
    ceiling light, or short any-hit rays."""
    rs = np.random.RandomState(seed)
    n = N_RAYS
    lo, hi = np.float32([-1.45, 0.05, -2.5]), np.float32([1.45, 2.45, 2.5])
    o = (lo + (hi - lo) * rs.rand(n, 3)).astype(np.float32)
    tmax = np.full(n, np.inf, np.float32)
    active = rs.rand(n) < 0.8
    if kind == "camera":
        pix = rs.choice(64 * 48, n, replace=False)
        f = lambda a: torch.as_tensor(a.astype(np.float32))  # noqa: E731
        cam = sample_camera_rays(scene.camera, f(pix % 64 + rs.rand(n)),
                                 f(pix // 64 + rs.rand(n)), 64, 48,
                                 f(rs.rand(n)), f(rs.rand(n)))
        o, d = cam.o.numpy(), cam.d.numpy()
        active[:] = True
    elif kind == "inbox":
        d = _unit(rs.normal(size=(n, 3)))
    elif kind == "near":
        d = _unit(rs.normal(size=(n, 3)))
        tmax[:] = 0.7
        active[:] = True
    else:
        tgt = np.stack([rs.uniform(-0.5, 0.5, n), np.full(n, 2.499),
                        rs.uniform(-0.5, 0.5, n)], axis=1).astype(np.float32)
        dist = np.linalg.norm(tgt - o, axis=1).astype(np.float32)
        d = ((tgt - o) / dist[:, None]).astype(np.float32)
        tmax = (dist * np.float32(1.0 - 1e-3)).astype(np.float32)
    return o, d, tmax, active


def _prepared(sbvh_scenes, name, kind):
    port = sbvh_scenes[name][1]
    o, d, tmax, active = _rays(port, kind, sum(map(ord, name + kind)))
    pt = port.pallas_tris
    rays, wl, cnt, _, _ = tv.prepare_cast(
        pt, torch.as_tensor(o), torch.as_tensor(d), RAY_EPSILON,
        torch.as_tensor(tmax), torch.as_tensor(active))
    return pt, rays, wl, cnt


@pytest.mark.parametrize("kind", ["camera", "inbox"])
@pytest.mark.parametrize("name", ["cornell-spectral", "parity"])
def test_culled_closest_hit_on_sbvh_tables(sbvh_scenes, name, kind):
    """The per-ray culling rule against the plain version: the same hit
    mask, and on every ray the same triangle and the same t bit for bit."""
    pt, rays, wl, cnt = _prepared(sbvh_scenes, name, kind)
    t_c, i_c, n_c = closest_hit_culled(rays, wl, cnt, pt, 8)
    t_p, i_p, n_p = tv.closest_hit_plain(rays, wl, cnt, pt)
    remap = pt.remap.long()
    tri_c = torch.where(i_c >= 0, remap[i_c.long().clamp(min=0)], -1)
    tri_p = torch.where(i_p >= 0, remap[i_p.long().clamp(min=0)], -1)
    assert torch.equal(i_c >= 0, i_p >= 0)
    assert torch.equal(tri_c, tri_p)
    assert torch.equal(t_c, t_p)
    assert bool((n_c == -1).all()) and bool((n_p == -1).all())
    assert int((i_p >= 0).sum()) > N_RAYS // 8


@pytest.mark.parametrize("kind", ["shadow", "near"])
@pytest.mark.parametrize("name", ["cornell-spectral", "parity"])
def test_culled_any_hit_on_sbvh_tables(sbvh_scenes, name, kind):
    pt, rays, wl, cnt = _prepared(sbvh_scenes, name, kind)
    got = any_hit_culled(rays, wl, cnt, pt)
    want = tv.any_hit_plain(rays, wl, cnt, pt)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < want.numel()


def test_sbvh_casts_meet_reference_kernel(ref, sbvh_scenes):
    """The port's casts on the parity scene's SBVH tables, with the culling
    rule in place of the CUDA kernels, against the reference's Pallas
    kernels in interpret mode (tests/test_pallas.py criteria)."""
    import jax.numpy as jnp

    rsc, port = sbvh_scenes["parity"]
    o, d, tmax, active = _rays(port, "inbox", 7)
    culled = lambda rays, wl, wtn, cnt, pt, *a: closest_hit_culled(  # noqa: E731
        rays, wl, cnt, pt, 8)
    with mock.patch.object(tv, "closest_hit", culled):
        hit = tv.intersect_pallas(port.geometry, port.pallas_tris,
                                  torch.as_tensor(o), torch.as_tensor(d),
                                  active=torch.as_tensor(active))
    k = ref.pi.intersect_pallas(rsc.geometry, rsc.pallas_tris,
                                jnp.asarray(o), jnp.asarray(d),
                                active=jnp.asarray(active), interpret=True)
    mask, tri, t = (np.asarray(x) for x in (k.mask, k.tri, k.t))
    np.testing.assert_array_equal(hit.mask.numpy(), mask)
    with np.errstate(invalid="ignore"):
        close = np.abs(hit.t.numpy() - t) <= 1e-4 * np.maximum(t, 1.0)
    same = hit.tri.numpy() == tri
    assert np.mean(np.where(mask, same | close, True)) > 0.995
    occ_culled = lambda rays, wl, wtn, cnt, pt, *a: any_hit_culled(  # noqa: E731
        rays, wl, cnt, pt)
    o, d, tmax, active = _rays(port, "shadow", 8)
    with mock.patch.object(tv, "any_hit", occ_culled):
        occ = tv.anyhit_pallas(port.geometry, port.pallas_tris,
                               torch.as_tensor(o), torch.as_tensor(d),
                               tmax=torch.as_tensor(tmax),
                               active=torch.as_tensor(active)).numpy()
    ko = np.asarray(ref.pi.anyhit_pallas(
        rsc.geometry, rsc.pallas_tris, jnp.asarray(o), jnp.asarray(d),
        tmax=jnp.asarray(tmax), active=jnp.asarray(active), interpret=True))
    np.testing.assert_array_equal(occ, ko)
