"""Instancing and motion blur in the port, against slr_tpu on the same
seeded inputs: the built instanced tables leaf by leaf, the instance
transform, the casts (the reference's Pallas kernels in interpret mode and
its two-level oracle), surface points on instanced hits and the slice as a
whole (`render_wavefront` on the grass field).

On the CPU the port's casts run the kernels' plain PyTorch versions; the
CUDA kernels are checked on the card (`cuda` marker, and chip_smoke.py)."""
import dataclasses
import types
from unittest import mock

import numpy as np
import pytest
import torch

from slr_tpu_torch.accel import traverse as tv
from slr_tpu_torch.accel.intersect import Hit
from slr_tpu_torch.render import pt as port_pt
from slr_tpu_torch.render.wavefront import render_wavefront
from slr_tpu_torch.scene.bridge import from_reference
from slr_tpu_torch.scene.build import SceneBuilder
from slr_tpu_torch.scene.graph import (
    MaterialDesc,
    MeshNode,
    SceneDesc,
    Vertex,
    flatten,
)
from slr_tpu_torch.scene.presets import grass_field, uv_sphere

torch.set_num_threads(1)

GRASS = dict(n_side=8, blade_segments=3, animated_fraction=0.25)


@pytest.fixture(scope="module")
def ref():
    """The reference package, imported here rather than at the top so that
    the CUDA case below runs on a machine without JAX
    (`python -m pytest --noconftest tests/test_torch_instancing.py -m cuda`)."""
    import jax.numpy as jnp
    from slr_tpu.accel import pallas_intersect
    from slr_tpu.accel.intersect import Hit as JHit
    from slr_tpu.accel.intersect import intersect_brute
    from slr_tpu.accel.twolevel import intersect_instances
    from slr_tpu.core import transform
    from slr_tpu.render import pt, wavefront
    from slr_tpu.scene import build, presets
    from test_torch_reference_build import load_reference_sbvh

    load_reference_sbvh()

    return types.SimpleNamespace(
        jnp=jnp, pi=pallas_intersect, Hit=JHit, brute=intersect_brute,
        twolevel=intersect_instances, transform=transform, pt=pt,
        wavefront=wavefront, build=build, presets=presets)


def _seventeen(cls, sphere):
    """tests/test_pallas.py's instanced scene: a ground quad, one small
    sphere BLAS, sixteen static instances on a grid and one that moves +x
    over the shutter."""
    b = cls()
    mat = b.add_matte(b.add_stex_const((0.5, 0.5, 0.5)))
    g = np.float32([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]])
    b.add_mesh(g, np.tile(np.float32([0, 1, 0]), (4, 1)),
               np.tile(np.float32([1, 0, 0]), (4, 1)),
               np.zeros((4, 2), np.float32),
               np.array([[0, 1, 2], [0, 2, 3]], np.int32), mat)
    bid = b.begin_blas()
    b.add_mesh(*sphere((0.0, 0.0, 0.0), 0.25, 6, 10), mat)
    b.end_blas()
    for i in range(4):
        for j in range(4):
            m = np.eye(4, dtype=np.float32)
            m[0, 3] = -1.5 + i
            m[1, 3] = 0.3
            m[2, 3] = -1.5 + j
            b.add_instance(bid, m)
    m0 = np.eye(4, dtype=np.float32)
    m0[1, 3] = 1.5
    m1 = m0.copy()
    m1[0, 3] = 1.0
    b.add_instance(bid, m0, m1)
    b.set_camera_perspective(np.eye(4, dtype=np.float32), 1.0, 0.5)
    return b


@pytest.fixture(scope="module")
def scenes(ref):
    """(reference scene, the port's own build, the reference scene carried
    across) for both instanced scenes, all on Morton chunk tables."""
    out = {}
    r17 = _seventeen(ref.build.SceneBuilder,
                     ref.presets.uv_sphere).build(use_bvh=False)
    p17 = _seventeen(SceneBuilder, uv_sphere).build(use_bvh=False)
    out["seventeen"] = (r17, p17, from_reference(r17))
    # Both presets build with SBVH chunks by default; the tests here hold
    # both to Morton chunks (use_bvh=False; tests/test_torch_bvh.py covers
    # the SBVH tables).
    build = ref.build.SceneBuilder.build
    with mock.patch.object(ref.build.SceneBuilder, "build",
                           lambda self: build(self, use_bvh=False)):
        rg = ref.presets.grass_field(**GRASS)
    out["grass"] = (rg, grass_field(device="cpu", use_bvh=False, **GRASS),
                    from_reference(rg))
    return out


# -- (a) the built tables, leaf by leaf ---------------------------------------

_STATIC = ("n_static", "lobe_kinds_present", "has_env", "has_alpha",
           "has_normal_map", "super_boxes_blob", "spectral", "has_checker",
           "has_voronoi", "has_curve", "has_const", "has_image",
           "has_one_minus")
# Fields of the reference that the port does not have: its TLAS and BLAS
# node arena (the lock-step two-level traversal) among them.
_NOT_BUILT = ("plucker", "bvh", "tlas_min", "tlas_max", "tlas_left",
              "tlas_right", "tlas_prim", "blas_min", "blas_max", "blas_left",
              "blas_right", "blas_prim", "blas_root")


def _fields(obj):
    if dataclasses.is_dataclass(obj):
        return [f.name for f in dataclasses.fields(obj)]
    return list(obj._fields)


def _walk(r, p, path=""):
    for name in _fields(r):
        if name in _NOT_BUILT:
            continue
        rv, pv = getattr(r, name), getattr(p, name)
        sub = f"{path}.{name}"
        if rv is None:
            assert pv is None, sub
        elif dataclasses.is_dataclass(rv) or hasattr(rv, "_fields"):
            yield from _walk(rv, pv, sub)
        else:
            yield sub, name, rv, pv


def _compare(r, p, path=""):
    """Integers and static fields exactly, floats to atol 1e-6."""
    n = 0
    for sub, name, rv, pv in _walk(r, p, path):
        n += 1
        if name in _STATIC or (name == "kind" and ".camera" in sub):
            assert pv == rv, sub
            continue
        rv = np.asarray(rv)
        pv = pv.cpu().numpy()
        assert pv.shape == rv.shape, sub
        if rv.dtype.kind in "iub":
            np.testing.assert_array_equal(pv, rv.astype(pv.dtype), err_msg=sub)
        else:
            np.testing.assert_allclose(pv, rv, rtol=0, atol=1e-6, err_msg=sub)
    return n


@pytest.mark.parametrize("which", ["seventeen", "grass"])
@pytest.mark.parametrize("table", ["pallas_tris", "instances", "geometry"])
def test_port_build_matches_reference_tables(scenes, which, table):
    r, p, _ = scenes[which]
    assert _compare(getattr(r, table), getattr(p, table), "." + table) >= 6


@pytest.mark.parametrize("which", ["seventeen", "grass"])
def test_port_build_matches_reference_scene(scenes, which):
    r, p, _ = scenes[which]
    assert _compare(r, p) > 60
    assert p.n_static == r.n_static and p.pallas_tris.instanced
    assert not hasattr(p.instances, "tlas_min")


def test_static_instances_are_flattened(scenes):
    """Sixteen static spheres are baked into the static prefix; the one
    animated instance keeps its BLAS and one entry per BLAS chunk."""
    _, p, _ = scenes["seventeen"]
    blas_tris = p.geometry.num_tris - p.n_static
    assert p.instances.num == 1
    assert p.n_static == 2 + 16 * blas_tris
    pt = p.pallas_tris
    assert int((pt.entry_inst >= 0).sum()) == -(-blas_tris // pt.chunk)
    assert pt.n_entries == pt.n_chunks


def test_unflattened_static_instances_match_reference(ref):
    """With flattening off the sixteen static spheres stay instanced: their
    entry boxes are the transformed chunk boxes at one shutter sample, and
    the casts still agree with the two-level oracle."""
    jnp = ref.jnp
    r = _seventeen(ref.build.SceneBuilder, ref.presets.uv_sphere).build(
        use_bvh=False, flatten_static_instances=False)
    p = _seventeen(SceneBuilder, uv_sphere).build(
        use_bvh=False, flatten_static_instances=False)
    assert p.instances.num == 17 and p.n_static == 2
    assert _compare(r, p) > 60
    o, d, f = _rand_rays(384, seed=15)
    got = tv.intersect_pallas(p.geometry, p.pallas_tris, torch.as_tensor(o),
                              torch.as_tensor(d), f=torch.as_tensor(f),
                              instances=p.instances)
    want = _oracle(ref, r, jnp.asarray(o), jnp.asarray(d), jnp.asarray(f))
    share, n_bad, n_hit = _agreement(got, want)
    assert share > 0.995, (n_bad, n_hit)
    assert int((got.inst >= 0).sum()) > 20


def test_bridge_carries_instanced_scene_bit_for_bit(scenes):
    r, _, carried = scenes["grass"]
    for name in ("tris", "boxes", "remap", "entry_chunk", "entry_inst",
                 "inst_trs"):
        np.testing.assert_array_equal(
            getattr(carried.pallas_tris, name).numpy(),
            np.asarray(getattr(r.pallas_tris, name)))
    for name in _fields(carried.instances):    # the rows, not the node arena
        np.testing.assert_array_equal(getattr(carried.instances, name).numpy(),
                                      np.asarray(getattr(r.instances, name)))
    assert len(_fields(carried.instances)) == 8
    assert carried.n_static == r.n_static and carried.pallas_tris.instanced
    pt = carried.pallas_tris
    assert pt.tri24.shape == (pt.n_chunks, pt.chunk, 24)
    # The derived per-chunk triangle counts: full static chunks, and the
    # one BLAS chunk holds a blade's triangles in its first slots.
    valid = pt.remap.reshape(pt.n_chunks, -1) >= 0
    assert pt.n_valid.tolist() == valid.sum(1).tolist()
    assert bool((valid[:, :-1] >= valid[:, 1:]).all())
    assert int(pt.n_valid[-1]) == 2 * GRASS["blade_segments"]


def test_fully_instanced_scene_keeps_a_never_hit_static_triangle(ref):
    def make(cls, sphere):
        b = cls()
        mat = b.add_matte(b.add_stex_const((0.5, 0.5, 0.5)))
        bid = b.begin_blas()
        b.add_mesh(*sphere((0.0, 0.0, 0.0), 0.25, 4, 6), mat)
        b.end_blas()
        m1 = np.eye(4, dtype=np.float32)
        m1[0, 3] = 0.5
        b.add_instance(bid, np.eye(4, dtype=np.float32), m1)
        return b.build(use_bvh=False)

    r = make(ref.build.SceneBuilder, ref.presets.uv_sphere)
    p = make(SceneBuilder, uv_sphere)
    assert p.n_static == 1 and float(p.geometry.positions[0, 0]) > 1e29
    assert _compare(r, p) > 60


def test_build_refuses_what_it_cannot_render():
    # A material of an unknown kind; every kind of the scene language
    # (here the microfacet metal, ROADMAP Q3) flattens.
    desc = SceneDesc()
    mesh = MeshNode()
    mesh.vertices = [Vertex(np.float32(p), np.float32([0, 0, 1]),
                            np.float32([1, 0, 0]), np.zeros(2, np.float32))
                     for p in ([0, 0, 0], [1, 0, 0], [0, 1, 0])]
    mesh.add_group(MaterialDesc(kind="velvet"), None, None, [(0, 1, 2)])
    desc.root.add_child(mesh)
    with pytest.raises(ValueError, match="velvet"):
        flatten(desc)
    from slr_tpu_torch.scene.graph import FTexDesc, SpectrumDesc, STexDesc

    al = [STexDesc(kind="constant", spectrum=SpectrumDesc(
        kind="library", library_id="Aluminium", library_comp=c))
        for c in (0, 1)]
    mesh.groups = [(MaterialDesc(kind="microfacet metal", stex=tuple(al),
                                 ftex=(FTexDesc(kind="constant", value=0.2),)),
                    None, None, [(0, 1, 2)])]
    assert flatten(desc).lobe_kinds_present == (5,)
    e = SceneBuilder()
    lit = e.add_emitter(e.add_matte(e.add_stex_const((0.5,) * 3)),
                        e.add_stex_const((5.0,) * 3))
    bid = e.begin_blas()
    e.add_mesh(*uv_sphere((0.0, 0.0, 0.0), 0.25, 4, 6), lit)
    e.end_blas()
    m1 = np.eye(4, dtype=np.float32)
    m1[0, 3] = 0.5
    e.add_instance(bid, np.eye(4, dtype=np.float32), m1)
    with pytest.raises(ValueError, match="emissive"):
        e.build()
    n = SceneBuilder()
    n.begin_blas()
    with pytest.raises(ValueError):
        n.begin_blas()


def test_grass_field_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        grass_field(n_side=2)


# -- (b) the instance transform ----------------------------------------------

def _rand_rays(n, seed, scale=2.0, lift=(0.0, 1.0, 0.0)):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32) * scale \
        + np.float32(lift)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, rs.uniform(0, 1, n).astype(np.float32)


def _trs_rows(seed, n):
    """inst_trs rows as `extend_pallas_instanced` lays them out, from random
    TRS pairs: rotations from identical to ~100 degrees apart, one in four
    mirrored (negative S[0])."""
    from slr_tpu_torch.core.transform import decompose_trs, trs_to_matrix_np

    rs = np.random.RandomState(seed)
    rows = np.zeros((n, 24), np.float32)
    for i in range(n):
        q0 = rs.normal(size=4)
        q0 /= np.linalg.norm(q0)
        q1 = q0 + (0.0, 1e-5, 0.3, 1.0)[i % 4] * rs.normal(size=4)
        q1 /= np.linalg.norm(q1)
        s0, s1 = rs.uniform(0.5, 2.0, 3), rs.uniform(0.5, 2.0, 3)
        if i % 4 == 1:
            s0[0], s1[0] = -s0[0], -s1[0]
        tr = [decompose_trs(trs_to_matrix_np(rs.uniform(-1, 1, 3), q, s))
              for q, s in ((q0, s0), (q1, s1))]
        (T0, Q0, S0), (T1, Q1, S1) = tr
        dq = float(np.dot(Q0, Q1))
        th = float(np.arccos(np.clip(abs(dq), 0.0, 1.0)))
        rows[i, :22] = np.concatenate(
            [T0, Q0, S0, T1, Q1 if dq >= 0 else -Q1, S1, [th, np.sin(th)]])
    return rows


def test_xform_rays_plain_matches_reference_function(ref):
    """The reference's `_xform_rays` itself, run outside its kernel on numpy
    buffers, block by block (atol 1e-5 on values of order 1-10)."""
    nb, rb = 12, 64
    o, d, f = _rand_rays(nb * rb, seed=21)
    rows = _trs_rows(22, nb)
    z = torch.zeros(nb * rb)
    rays, _ = tv._pack_rays(torch.as_tensor(o), torch.as_tensor(d), z, z, rb,
                            torch.as_tensor(f))
    got = tv.xform_rays_plain(rays, torch.as_tensor(rows)).numpy()
    assert (rows[:, 21] < 1e-4).any() and (rows[:, 21] > 1e-2).any()
    assert (rows[:, 7] < 0).any()
    for b in range(nb):
        rbuf = np.full((16, rb), np.nan, np.float32)
        ref.pi._xform_rays(ref.jnp.asarray(rays[b].numpy()),
                           ref.jnp.asarray(rows.reshape(-1)), b, rbuf, rb)
        np.testing.assert_allclose(got[b], rbuf[0:9], rtol=1e-5, atol=1e-5)


def test_xform_rays_plain_is_the_inverse_trs(ref):
    """Semantics: o_l = TRS(f)^-1 o, d_l = R^-1 d / S (unnormalized),
    m = o_l x d_l, with the run-time slerp of core/transform.py."""
    jnp, tr = ref.jnp, ref.transform
    nb, rb = 12, 64
    o, d, f = _rand_rays(nb * rb, seed=23)
    rows = _trs_rows(24, nb)
    z = torch.zeros(nb * rb)
    rays, _ = tv._pack_rays(torch.as_tensor(o), torch.as_tensor(d), z, z, rb,
                            torch.as_tensor(f))
    got = tv.xform_rays_plain(rays, torch.as_tensor(rows))
    got = got.permute(0, 2, 1).reshape(nb * rb, 9).numpy()
    per_ray = jnp.asarray(np.repeat(rows, rb, axis=0))
    T, R, S = tr.trs_at(per_ray[:, 0:3], per_ray[:, 3:7], per_ray[:, 7:10],
                        per_ray[:, 10:13], per_ray[:, 13:17],
                        per_ray[:, 17:20], jnp.asarray(f))
    o_l = np.asarray(tr.trs_inv_apply_point(T, R, S, jnp.asarray(o)))
    d_l = np.asarray(tr.trs_inv_apply_vector(T, R, S, jnp.asarray(d)))
    np.testing.assert_allclose(got[:, 0:3], d_l, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:, 6:9], o_l, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:, 3:6], np.cross(o_l, d_l), rtol=1e-4,
                               atol=1e-4)      # products of values up to ~10


def test_pack_rays_carries_the_shutter_fraction(ref):
    jnp = ref.jnp
    o, d, f = _rand_rays(300, seed=25)
    tmin, tmax = np.full(300, 1e-4, np.float32), np.full(300, 9.0, np.float32)
    got, nb = tv._pack_rays(*(torch.as_tensor(x) for x in (o, d, tmin, tmax)),
                            128, torch.as_tensor(f))
    want, jnb = ref.pi._pack_rays(*(jnp.asarray(x) for x in (o, d, tmin, tmax)),
                                  128, f=jnp.asarray(f))
    assert nb == jnb == 3
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, 12].reshape(-1)[:300].numpy(), f)


# -- (c) the casts -------------------------------------------------------------

def _oracle(ref, scene, o, d, f):
    """Brute force over the static prefix + the reference's two-level
    traversal over the instances; the closer hit wins."""
    jnp = ref.jnp
    g = scene.geometry
    static = g.replace(tri_vidx=g.tri_vidx[: scene.n_static],
                       tri_mat=g.tri_mat[: scene.n_static],
                       tri_alpha=g.tri_alpha[: scene.n_static],
                       tri_ntex=g.tri_ntex[: scene.n_static])
    hit = ref.brute(static, o, d)
    hit2 = ref.twolevel(g, scene.instances, o, d, f)
    closer = hit2.mask & (hit2.t < jnp.where(hit.mask, hit.t, jnp.inf))
    return ref.Hit(t=jnp.where(closer, hit2.t, hit.t),
                   tri=jnp.where(closer, hit2.tri, hit.tri),
                   b0=jnp.where(closer, hit2.b0, hit.b0),
                   b1=jnp.where(closer, hit2.b1, hit.b1),
                   mask=hit.mask | hit2.mask,
                   inst=jnp.where(closer, hit2.inst, -1))


def _cast_rays(which, n, seed):
    if which == "seventeen":
        return _rand_rays(n, seed)
    return _rand_rays(n, seed, scale=0.45, lift=(0.0, 0.45, 0.0))


def _agreement(got: Hit, want):
    """tests/test_pallas.py criteria: equal hit masks; on the rays hit, the
    same (triangle, instance) or |dt| <= 1e-4 (shared-edge ties). Returns
    the share that agrees and the count that does not."""
    mask = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    t, wt = got.t.numpy()[mask], np.asarray(want.t)[mask]
    same = ((got.tri.numpy()[mask] == np.asarray(want.tri)[mask])
            & (got.inst.numpy()[mask] == np.asarray(want.inst)[mask]))
    ok = same | (np.abs(t - wt) <= 1e-4 * np.maximum(wt, 1.0))
    np.testing.assert_allclose(t, wt, rtol=2e-4, atol=2e-5)
    return ok.mean(), int((~ok).sum()), int(mask.sum())


@pytest.mark.parametrize("which", ["seventeen", "grass"])
def test_closest_hit_matches_reference_kernel(ref, scenes, which):
    """Measured here: every hit ray has the same (triangle, instance) on
    both scenes (0 of 267 and 0 of 363 disagree)."""
    jnp = ref.jnp
    r, _, carried = scenes[which]
    o, d, f = _cast_rays(which, 517, seed=4)
    got = tv.intersect_pallas(
        carried.geometry, carried.pallas_tris, torch.as_tensor(o),
        torch.as_tensor(d), f=torch.as_tensor(f), instances=carried.instances)
    want = ref.pi.intersect_pallas(
        r.geometry, r.pallas_tris, jnp.asarray(o), jnp.asarray(d),
        f=jnp.asarray(f), instances=r.instances, interpret=True)
    share, n_bad, n_hit = _agreement(got, want)
    assert share > 0.995, (n_bad, n_hit)
    assert (np.asarray(want.inst) >= 0).any()
    np.testing.assert_allclose(got.b0.numpy(), np.asarray(want.b0), atol=1e-4)
    np.testing.assert_allclose(got.b1.numpy(), np.asarray(want.b1), atol=1e-4)


@pytest.mark.parametrize("which", ["seventeen", "grass"])
@pytest.mark.parametrize("moving", [False, True], ids=["f0", "random_f"])
def test_closest_hit_matches_twolevel_oracle(ref, scenes, which, moving):
    jnp = ref.jnp
    r, own, _ = scenes[which]
    o, d, f = _cast_rays(which, 384, seed=9)
    if not moving:
        f = np.zeros_like(f)
    got = tv.intersect_pallas(
        own.geometry, own.pallas_tris, torch.as_tensor(o), torch.as_tensor(d),
        f=torch.as_tensor(f), instances=own.instances)
    want = _oracle(ref, r, jnp.asarray(o), jnp.asarray(d), jnp.asarray(f))
    share, n_bad, n_hit = _agreement(got, want)
    assert share > 0.995, (n_bad, n_hit)


@pytest.mark.parametrize("which", ["seventeen", "grass"])
def test_anyhit_matches_reference_kernel_and_oracle(ref, scenes, which):
    jnp = ref.jnp
    r, _, carried = scenes[which]
    o, d, f = _cast_rays(which, 384, seed=11)
    tmax = 3.0 if which == "seventeen" else 0.4
    occ = tv.anyhit_pallas(carried.geometry, carried.pallas_tris,
                           torch.as_tensor(o), torch.as_tensor(d), tmax=tmax,
                           f=torch.as_tensor(f)).numpy()
    k = ref.pi.anyhit_pallas(r.geometry, r.pallas_tris, jnp.asarray(o),
                             jnp.asarray(d), tmax=tmax, f=jnp.asarray(f),
                             interpret=True)
    assert (occ == np.asarray(k)).mean() > 0.995
    want = _oracle(ref, r, jnp.asarray(o), jnp.asarray(d), jnp.asarray(f))
    occ_o = np.asarray(want.mask) & (np.asarray(want.t) <= tmax * (1 + 1e-6))
    assert (occ == occ_o).mean() > 0.995            # tmax boundary ties
    assert occ.any() and not occ.all()


def test_motion_moves_the_hits(scenes):
    """The animated sphere of the seventeen-instance scene is hit where it
    stands at each ray's own shutter fraction."""
    _, own, _ = scenes["seventeen"]
    n = 256
    o = np.tile(np.float32([0.0, 1.5, 2.0]), (n, 1))
    o[:, 0] = np.linspace(-0.4, 1.4, n)
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (n, 1))
    hits = []
    for fv in (0.0, 1.0):
        h = tv.intersect_pallas(own.geometry, own.pallas_tris,
                                torch.as_tensor(o), torch.as_tensor(d),
                                f=torch.full((n,), fv),
                                instances=own.instances)
        assert bool((h.inst[h.mask] == 0).all())
        hits.append(o[h.mask.numpy(), 0])
    assert abs(hits[0].mean() - 0.0) < 0.02 and abs(hits[1].mean() - 1.0) < 0.02


def test_plain_versions_do_not_count_launches(scenes):
    _, own, _ = scenes["grass"]
    tv.reset_launches()
    o, d, f = (torch.as_tensor(x) for x in _cast_rays("grass", 64, seed=2))
    tv.intersect_pallas(own.geometry, own.pallas_tris, o, d, f=f,
                        instances=own.instances)
    tv.anyhit_pallas(own.geometry, own.pallas_tris, o, d, tmax=1.0, f=f)
    rays, _ = tv._pack_rays(o, d, torch.zeros(64), torch.zeros(64), 64, f)
    tv.xform_rays(rays, own.pallas_tris.inst_trs[:1])
    assert tv.LAUNCHES == {"closest_hit": 0, "any_hit": 0, "xform_rays": 0,
                           "worklist": 0, "worklist_tensor_sort": 0}


# -- (d) surface points on instanced hits --------------------------------------

@pytest.mark.parametrize("which", ["seventeen", "grass"])
def test_resolve_sp_on_instanced_hits_matches_reference(ref, scenes, which):
    jnp = ref.jnp
    r, _, carried = scenes[which]
    o, d, f = _cast_rays(which, 384, seed=13)
    if which == "seventeen":       # around the one animated sphere's sweep
        o, d, f = _rand_rays(384, seed=13, scale=0.8, lift=(0.5, 1.5, 0.0))
    jhit = _oracle(ref, r, jnp.asarray(o), jnp.asarray(d), jnp.asarray(f))
    assert (np.asarray(jhit.inst) >= 0).sum() >= 5
    hit = Hit(*(torch.as_tensor(np.asarray(x)) for x in jhit))
    hit = hit._replace(tri=hit.tri.to(torch.int64),
                       inst=hit.inst.to(torch.int64))
    got = port_pt.resolve_sp(carried, hit, torch.as_tensor(o),
                             torch.as_tensor(d), f=torch.as_tensor(f))
    want = ref.pt.resolve_sp(r, jhit, jnp.asarray(o), jnp.asarray(d),
                             f=jnp.asarray(f))
    m = np.asarray(jhit.mask)
    for name in ("p", "gn", "sn", "tangent", "bitangent", "uv", "area_pdf"):
        np.testing.assert_allclose(getattr(got, name).numpy()[m],
                                   np.asarray(getattr(want, name))[m],
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got.mat_id.numpy()[m],
                                  np.asarray(want.mat_id)[m])


# -- (e) the slice as a whole ---------------------------------------------------

@pytest.fixture(scope="module")
def grass_renders(ref, scenes):
    r, own, carried = scenes["grass"]
    kw = dict(spp=2, seed=1, max_depth=6, return_iters=True)
    ref_img, ref_it = ref.wavefront.render_wavefront(r, 32, 24, **kw)
    img, it = render_wavefront(carried, 32, 24, device="cpu", **kw)
    own_img, own_it = render_wavefront(own, 32, 24, device="cpu", **kw)
    return (np.asarray(ref_img), ref_it, img.numpy(), it, own_img.numpy(),
            own_it)


def _close_share(img, want):
    close = (np.abs(img - want) <= 1e-3 * np.abs(want) + 1e-6).all(-1)
    return close.mean(), int((~close).sum())


def test_grass_render_matches_reference(grass_renders):
    """The reference on the CPU casts through its Plücker matmul and its
    two-level traversal, the port through the worklist traversal, so a tie
    at a blade's edge may flip single pixels. Measured: 0 of 768 pixels
    beyond rtol 1e-3, means equal to 7 digits, 4 iterations on both."""
    want, want_it, img, it, _, _ = grass_renders
    assert np.isfinite(img).all() and (img >= 0).all()
    share, n_far = _close_share(img, want)
    assert share >= 0.98, n_far
    assert abs(img.mean() / want.mean() - 1.0) < 0.01
    assert abs(it - want_it) <= 2
    assert (img.sum(-1) > 0).mean() > 0.10


def test_grass_render_of_own_build_matches_carried_scene(grass_renders):
    _, _, img, it, own, own_it = grass_renders
    share, n_far = _close_share(own, img)
    assert share >= 0.98, n_far
    assert own_it == it


def test_shutter_time_reaches_the_casts(scenes):
    """A scene with instances draws each sample's shutter fraction and
    passes it to every cast; without instances the lanes carry zeros."""
    from slr_tpu_torch.render import wavefront as wf

    _, own, _ = scenes["seventeen"]
    seen = []
    real = port_pt.intersect_pallas

    def spy(*a, f=None, **k):
        seen.append(f)
        return real(*a, f=f, **k)

    with mock.patch.object(port_pt, "intersect_pallas", spy):
        wf.render_wavefront(own, 8, 6, spp=1, seed=3, max_depth=2,
                            device="cpu")
    assert seen and all(f is not None for f in seen)
    first = seen[0]
    assert float(first.min()) >= 0.0 and float(first.max()) < 1.0
    assert float(first.std()) > 0.1


# -- (f) the CUDA kernels --------------------------------------------------------

@pytest.mark.cuda
def test_cuda_instanced_kernels_match_plain_versions():
    """The CUDA kernels on an instanced table against their plain versions
    on the same inputs: equal hit masks, the same (slot, instance) or
    |dt| <= 1e-4 on > 99.5% of the rays hit; occlusion masks agree on >
    99.5%; the transform on its own within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    scene = grass_field(n_side=16, blade_segments=5, animated_fraction=0.25,
                        device="cuda")
    pt = scene.pallas_tris
    o, d, f = (torch.as_tensor(x, device="cuda")
               for x in _rand_rays(8192, seed=31, scale=0.9,
                                   lift=(0.0, 0.42, 0.0)))
    tv.reset_launches()
    rays, wl, cnt, wtn, _ = tv.prepare_cast(pt, o, d, 1e-4, float("inf"),
                                            None, f=f)
    xforms = torch.zeros(rays.shape[0], dtype=torch.int32, device="cuda")
    t_k, i_k, n_k = tv.closest_hit(rays, wl, wtn, cnt, pt, xforms=xforms)
    t_p, i_p, n_p = tv.closest_hit_plain(rays, wl, cnt, pt)
    assert torch.equal(i_k >= 0, i_p >= 0)
    hit = i_p >= 0
    same = ((i_k == i_p) & (n_k == n_p)) | (
        (t_k - t_p).abs() <= 1e-4 * torch.clamp(t_p.abs(), min=1.0))
    assert float(same[hit].float().mean()) > 0.995
    assert int(xforms.sum()) > 0 and bool((n_p >= 0).any())
    rays, wl, cnt, wtn, _ = tv.prepare_cast(pt, o, d, 1e-4, 0.3, None, f=f)
    occ_k = tv.any_hit(rays, wl, wtn, cnt, pt)
    occ_p = tv.any_hit_plain(rays, wl, cnt, pt)
    assert float((occ_k == occ_p).float().mean()) > 0.995
    rows = pt.inst_trs[torch.arange(rays.shape[0], device="cuda")
                       % pt.inst_trs.shape[0]].contiguous()
    torch.testing.assert_close(tv.xform_rays(rays, rows),
                               tv.xform_rays_plain(rays, rows),
                               rtol=1e-5, atol=1e-5)
    assert tv.LAUNCHES == {"closest_hit": 1, "any_hit": 1, "xform_rays": 1,
                           "worklist": 2, "worklist_tensor_sort": 0}
    # Through the casts the kernels' own counts land in `WORK`: tests over
    # the chunks' triangles (not their padding) and transforms, both kinds.
    tv.track_work("cuda")
    try:
        tv.intersect_pallas(scene.geometry, pt, o, d, f=f,
                            instances=scene.instances)
        tv.anyhit_pallas(scene.geometry, pt, o, d, tmax=0.3, f=f)
        work = tv.WORK.tolist()
    finally:
        tv.track_work(None)
    assert work[1] == int(xforms.sum()) and min(work) > 0
    assert tv.LAUNCHES == {"closest_hit": 2, "any_hit": 2, "xform_rays": 1,
                           "worklist": 4, "worklist_tensor_sort": 0}
