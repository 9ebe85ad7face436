"""The traversal module (accel/traverse.py): the closest-hit and any-hit
casts against the reference's Pallas kernels run in interpret mode and
against brute force, on the port's Morton tables and on the reference's SBVH
tables carried across.

On the CPU the casts run the kernels' plain PyTorch versions. The CUDA
kernels themselves are checked on the card (`cuda` marker below, and
chip_smoke.py); without a card those cases skip."""
import types

import numpy as np
import pytest
import torch

from slr_tpu_torch.accel import traverse as tv
from slr_tpu_torch.accel.intersect import intersect_brute
from slr_tpu_torch.scene.bridge import from_reference
from slr_tpu_torch.scene.presets import cornell_box_spheres

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref():
    """The reference functions, imported here rather than at the top so
    that the CUDA case below runs on a machine without JAX
    (`python -m pytest --noconftest tests/test_torch_traverse.py -m cuda`)."""
    import jax.numpy as jnp
    from slr_tpu.accel import pallas_intersect
    from slr_tpu.accel.intersect import intersect_brute as brute
    from slr_tpu.scene.presets import cornell_box_spheres as cornell
    from test_torch_reference_build import load_reference_sbvh

    load_reference_sbvh()

    return types.SimpleNamespace(jnp=jnp, pi=pallas_intersect, brute=brute,
                                 cornell=cornell)


@pytest.fixture(scope="module")
def scenes(ref):
    """(reference scene, port scene) per chunking: the port's own Morton
    tables (held against the reference built with use_bvh=False) and the
    reference's SBVH treelet tables carried across."""
    ref_morton = ref.cornell(use_bvh=False)
    ref_sbvh = ref.cornell(use_bvh=True)
    return {
        "morton": (ref_morton, cornell_box_spheres(use_bvh=False,
                                                   device="cpu")),
        "sbvh": (ref_sbvh, from_reference(ref_sbvh)),
    }


def _rand_rays(n, seed):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _assert_hits_agree(mask, tri, t, ref_mask, ref_tri, ref_t):
    """tests/test_pallas.py criteria: equal masks; the same triangle or t
    within 1e-4 (shared-edge ties) on more than 99.5% of hit rays."""
    np.testing.assert_array_equal(mask, ref_mask)
    same = tri == ref_tri
    with np.errstate(invalid="ignore"):          # inf - inf on missed rays
        close = np.abs(t - ref_t) <= 1e-4 * np.maximum(ref_t, 1.0)
    assert np.mean(np.where(ref_mask, same | close, True)) > 0.995
    np.testing.assert_allclose(np.where(ref_mask, t, 0.0),
                               np.where(ref_mask, ref_t, 0.0),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("tables", ["morton", "sbvh"])
def test_closest_hit_matches_reference_kernel_and_brute(ref, scenes, tables):
    rsc, port = scenes[tables]
    jnp = ref.jnp
    o, d = _rand_rays(517, seed=0)
    hit = tv.intersect_pallas(port.geometry, port.pallas_tris,
                              torch.as_tensor(o), torch.as_tensor(d))
    got = [x.numpy() for x in (hit.mask, hit.tri, hit.t)]
    k = ref.pi.intersect_pallas(rsc.geometry, rsc.pallas_tris, jnp.asarray(o),
                                jnp.asarray(d), interpret=True)
    _assert_hits_agree(*got, *(np.asarray(x) for x in (k.mask, k.tri, k.t)))
    b = ref.brute(rsc.geometry, jnp.asarray(o), jnp.asarray(d))
    _assert_hits_agree(*got, *(np.asarray(x) for x in (b.mask, b.tri, b.t)))
    pb = intersect_brute(port.geometry, torch.as_tensor(o), torch.as_tensor(d))
    _assert_hits_agree(*got, pb.mask.numpy(), pb.tri.numpy(), pb.t.numpy())


@pytest.mark.parametrize("tables", ["morton", "sbvh"])
def test_anyhit_matches_reference_kernel(ref, scenes, tables):
    rsc, port = scenes[tables]
    jnp = ref.jnp
    o, d = _rand_rays(511, seed=3)
    occ = tv.anyhit_pallas(port.geometry, port.pallas_tris,
                           torch.as_tensor(o), torch.as_tensor(d), tmax=0.7)
    k = ref.pi.anyhit_pallas(rsc.geometry, rsc.pallas_tris, jnp.asarray(o),
                             jnp.asarray(d),
                             tmax=jnp.full((511,), 0.7, jnp.float32),
                             interpret=True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(k))
    b = ref.brute(rsc.geometry, jnp.asarray(o), jnp.asarray(d), tmax=0.7)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(b.mask))


@pytest.mark.parametrize("tables", ["morton", "sbvh"])
def test_active_mask_opt_out(scenes, tables):
    """Inactive lanes report no hit and do not disturb active lanes."""
    _, port = scenes[tables]
    o, d = _rand_rays(384, seed=7)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    active = torch.as_tensor(np.random.RandomState(9).rand(384) < 0.4)
    g, pt = port.geometry, port.pallas_tris
    hit_m = tv.intersect_pallas(g, pt, o, d, active=active)
    hit_f = tv.intersect_pallas(g, pt, o, d)
    assert not bool((hit_m.mask & ~active).any())
    sel = active & hit_f.mask
    assert bool(torch.where(sel, hit_m.tri == hit_f.tri, True).all())
    occ_m = tv.anyhit_pallas(g, pt, o, d, tmax=2.0, active=active)
    occ_f = tv.anyhit_pallas(g, pt, o, d, tmax=2.0)
    assert not bool((occ_m & ~active).any())
    assert bool(torch.where(active, occ_m == occ_f, True).all())


def test_worklist_matches_reference(ref, scenes):
    """The per-block worklists, counts and near keys equal the reference's
    `_chunk_worklist` (same slab arithmetic, stable sort)."""
    jp, jnp = ref.pi, ref.jnp
    rsc, port = scenes["sbvh"]
    o, d = _rand_rays(600, seed=5)
    active = np.random.RandomState(6).rand(600) < 0.7
    ja, jb = jp._ray_ranges(600, 1e-4, jnp.inf, jnp.asarray(active))
    jb = jp._scene_exit_clamp(jnp.asarray(o), jnp.asarray(d), jb,
                              rsc.pallas_tris.boxes)
    jr, _ = jp._pack_rays(jnp.asarray(o), jnp.asarray(d), ja, jb, 256)
    jwl, jcnt, jwtn = jp._chunk_worklist(jr, rsc.pallas_tris.boxes)
    rays, wl, cnt, wtn, _ = tv.prepare_cast(
        port.pallas_tris, torch.as_tensor(o), torch.as_tensor(d), 1e-4,
        float("inf"), torch.as_tensor(active), rb=256)
    np.testing.assert_array_equal(rays.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(wl.numpy(), np.asarray(jwl))
    np.testing.assert_array_equal(wtn.numpy(), np.asarray(jwtn))


def test_instanced_tables_are_refused(ref):
    """The name dates from when the traversal refused `entry_inst >= 0`;
    it now takes such a table. The same one-instance table, carried across,
    goes through both casts and both traversal wrappers and matches the
    reference's kernels (interpret mode) ray for ray."""
    from slr_tpu.scene.build import SceneBuilder
    from slr_tpu.scene.presets import uv_sphere

    jnp = ref.jnp
    b = SceneBuilder()
    mat = b.add_matte(b.add_stex_const((0.5, 0.5, 0.5)))
    g = np.float32([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]])
    b.add_mesh(g, np.tile(np.float32([0, 1, 0]), (4, 1)),
               np.tile(np.float32([1, 0, 0]), (4, 1)), np.zeros((4, 2)),
               np.array([[0, 1, 2], [0, 2, 3]], np.int32), mat)
    bid = b.begin_blas()
    b.add_mesh(*uv_sphere((0.0, 0.0, 0.0), 0.25, 4, 6), mat)
    b.end_blas()
    m0 = np.eye(4, dtype=np.float32)
    m1 = m0.copy()
    m1[0, 3] = 1.0                                   # animated: stays instanced
    b.add_instance(bid, m0, m1)
    rsc = b.build(use_bvh=False)
    port = from_reference(rsc)
    pt = port.pallas_tris
    assert pt.instanced
    o, d = _rand_rays(256, seed=1)
    o *= 0.5
    f = np.random.RandomState(2).uniform(0, 1, 256).astype(np.float32)
    to, td, tf = (torch.as_tensor(x) for x in (o, d, f))
    hit = tv.intersect_pallas(port.geometry, pt, to, td, f=tf,
                              instances=port.instances)
    k = ref.pi.intersect_pallas(rsc.geometry, rsc.pallas_tris, jnp.asarray(o),
                                jnp.asarray(d), f=jnp.asarray(f),
                                instances=rsc.instances, interpret=True)
    _assert_hits_agree(hit.mask.numpy(), hit.tri.numpy(), hit.t.numpy(),
                       *(np.asarray(x) for x in (k.mask, k.tri, k.t)))
    np.testing.assert_array_equal(hit.inst.numpy(), np.asarray(k.inst))
    assert bool((hit.inst >= 0).any()) and bool((hit.inst[hit.mask] < 0).any())
    occ = tv.anyhit_pallas(port.geometry, pt, to, td, tmax=1.0, f=tf)
    ko = ref.pi.anyhit_pallas(rsc.geometry, rsc.pallas_tris, jnp.asarray(o),
                              jnp.asarray(d), tmax=1.0, f=jnp.asarray(f),
                              interpret=True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ko))
    rays, wl, cnt, wtn, _ = tv.prepare_cast(pt, to, td, 1e-4, 1.0, None, f=tf)
    best_t, best_idx, best_inst = tv.closest_hit(rays, wl, wtn, cnt, pt)
    assert best_inst.dtype == torch.int32 and bool((best_inst >= 0).any())
    assert tv.any_hit(rays, wl, wtn, cnt, pt).shape == best_t.shape


def test_plain_versions_do_not_count_launches(scenes):
    _, port = scenes["morton"]
    tv.reset_launches()
    o, d = (torch.as_tensor(x) for x in _rand_rays(64, seed=2))
    tv.intersect_pallas(port.geometry, port.pallas_tris, o, d)
    tv.anyhit_pallas(port.geometry, port.pallas_tris, o, d, tmax=1.0)
    assert tv.LAUNCHES == {"closest_hit": 0, "any_hit": 0, "xform_rays": 0,
                           "worklist": 0, "worklist_tensor_sort": 0}


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """The CUDA kernels against their plain versions on the same inputs
    (same arithmetic order and no FMA contraction, so bit-equal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    pt = cornell_box_spheres(use_bvh=False, device="cuda").pallas_tris
    o, d = (torch.as_tensor(x, device="cuda")
            for x in _rand_rays(4096, seed=11))
    active = torch.as_tensor(np.random.RandomState(12).rand(4096) < 0.8,
                             device="cuda")
    tv.reset_launches()
    rays, wl, cnt, wtn, _ = tv.prepare_cast(pt, o, d, 1e-4, float("inf"),
                                            active)
    t_k, i_k, _ = tv.closest_hit(rays, wl, wtn, cnt, pt)
    t_p, i_p, _ = tv.closest_hit_plain(rays, wl, cnt, pt)
    torch.testing.assert_close(t_k, t_p, rtol=0, atol=0)
    assert torch.equal(i_k, i_p)
    rays, wl, cnt, wtn, _ = tv.prepare_cast(pt, o, d, 1e-4, 0.7, active)
    assert torch.equal(tv.any_hit(rays, wl, wtn, cnt, pt),
                       tv.any_hit_plain(rays, wl, cnt, pt))
    assert tv.LAUNCHES == {"closest_hit": 1, "any_hit": 1, "xform_rays": 0,
                           "worklist": 2, "worklist_tensor_sort": 0}
