"""The port's intersector oracles against slr_tpu's: the Plücker matrix
cast (`accel/plucker.py`), the BVH stack traversal (`accel/lbvh.py`
`intersect_bvh`), the brute-force occlusion (`accel/intersect.py`
`any_hit_brute`), the two-level node arena (`accel/instances.py`
`build_two_level`) and traversal (`accel/twolevel.py`
`intersect_instances`), on scenes carried across; and each against the
port's chunk casts, which they check on the card.

Tables built on the host match bit for bit. Hits follow
tests/test_pallas.py's criteria: equal masks, the same triangle (and
instance) or t within 1e-4 on > 99.5% of hit rays, t to rtol 2e-4."""
import numpy as np
import pytest
import torch

from slr_tpu_torch.accel import instances as tinst
from slr_tpu_torch.accel.intersect import any_hit_brute
from slr_tpu_torch.accel.lbvh import intersect_bvh
from slr_tpu_torch.accel.plucker import build_plucker, intersect_plucker
from slr_tpu_torch.accel.twolevel import (
    intersect_instances,
    intersect_scene_oracle,
)
from slr_tpu_torch.render.pt import scene_intersect, scene_occluded
from slr_tpu_torch.scene.bridge import from_reference
from slr_tpu_torch.scene.presets import grass_field
from test_torch_reference_build import load_reference_sbvh
from torch_shard_scenes import hits_agree, random_rays

torch.set_num_threads(1)

O, D = random_rays(517, 0.9, seed=5)


@pytest.fixture(scope="module")
def cornell():
    load_reference_sbvh()
    from slr_tpu.scene.presets import cornell_box_spheres

    ref = cornell_box_spheres(sphere_res=8)
    return ref, from_reference(ref)


@pytest.fixture(scope="module")
def grass():
    """(reference grass field with its arena, the port's own build with
    its arena, the reference's arena carried into the port, rays)."""
    load_reference_sbvh()
    from slr_tpu.scene.presets import grass_field as ref_grass

    ref = ref_grass(n_side=6, animated_fraction=0.5)
    port = grass_field(n_side=6, animated_fraction=0.5, device="cpu",
                       two_level=True)
    carried = from_reference(ref)
    arena = from_reference(ref.instances, cls=tinst.TwoLevel)
    from slr_tpu_torch.render.pt import _camera_ray

    pid = torch.arange(24 * 18)
    rays = _camera_ray(port, pid, torch.zeros_like(pid), 11, 24, 18)
    o, d = rays.o.numpy(), rays.d.numpy()
    f = np.random.RandomState(11).uniform(0, 1, len(o)).astype(np.float32)
    return ref, port, carried, arena, (o, d, f)


def _np(hit):
    return {k: np.asarray(getattr(hit, k)) for k in ("t", "tri", "mask")}


def test_plucker_tables_match_reference(cornell):
    from slr_tpu.accel.plucker import build_plucker as ref_build

    for chunk in (256, 1024):
        want = ref_build(cornell[0].geometry, chunk=chunk)
        got = build_plucker(cornell[1].geometry, chunk=chunk)
        for name in ("edges", "normals", "d0", "valid"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))


@pytest.mark.parametrize("tmax", [float("inf"), 0.8])
def test_plucker_matches_reference(cornell, tmax):
    import jax.numpy as jnp
    from slr_tpu.accel.plucker import build_plucker as ref_build
    from slr_tpu.accel.plucker import intersect_plucker as ref_isect

    ref, port = cornell
    want = ref_isect(ref.geometry, ref_build(ref.geometry, chunk=512),
                     jnp.asarray(O), jnp.asarray(D), tmax=tmax)
    o, d = torch.as_tensor(O), torch.as_tensor(D)
    got = intersect_plucker(port.geometry,
                            build_plucker(port.geometry, chunk=512), o, d,
                            tmax=tmax)
    hits_agree(_np(got), _np(want))
    hits_agree(_np(got), _np(scene_intersect(port, o, d, tmax=tmax)))
    assert got.mask.float().mean() > (0.5 if tmax > 1 else 0.05)


def test_bvh_traversal_matches_reference(cornell):
    import jax.numpy as jnp
    from slr_tpu.accel.lbvh import intersect_bvh as ref_isect

    ref, port = cornell
    want = ref_isect(ref.geometry, ref.bvh, jnp.asarray(O), jnp.asarray(D))
    o, d = torch.as_tensor(O), torch.as_tensor(D)
    got = intersect_bvh(port.geometry, port.bvh, o, d)
    hits_agree(_np(got), _np(want))
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    hits_agree(_np(got), _np(scene_intersect(port, o, d)))


def test_slab_test_matches_reference():
    import jax.numpy as jnp
    from slr_tpu.accel.lbvh import _slab_test as ref_slab

    from slr_tpu_torch.accel.lbvh import _slab_test

    rs = np.random.RandomState(2)
    args = [rs.uniform(-1, 0, (64, 3)), rs.uniform(0, 1, (64, 3)),
            rs.uniform(-2, 2, (64, 3)), rs.normal(size=(64, 3)) * 3,
            np.full(64, 1e-4), rs.uniform(0.5, 3, 64)]
    args = [a.astype(np.float32) for a in args]
    hit_w, near_w = ref_slab(*map(jnp.asarray, args))
    hit_g, near_g = _slab_test(*map(torch.as_tensor, args))
    np.testing.assert_array_equal(hit_g.numpy(), np.asarray(hit_w))
    np.testing.assert_array_equal(near_g.numpy(), np.asarray(near_w))


@pytest.mark.parametrize("tmax", [0.3, 1.2])
def test_any_hit_brute_matches_reference(cornell, tmax):
    import jax.numpy as jnp
    from slr_tpu.accel.intersect import any_hit_brute as ref_any

    ref, port = cornell
    want = np.asarray(ref_any(ref.geometry, jnp.asarray(O), jnp.asarray(D),
                              1e-4, tmax))
    o, d = torch.as_tensor(O), torch.as_tensor(D)
    got = any_hit_brute(port.geometry, o, d, 1e-4, tmax).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, scene_occluded(port, o, d, 1e-4, tmax).numpy())
    assert 0.02 < got.mean() < 0.98


_ARENA = ("tlas_min", "tlas_max", "tlas_left", "tlas_right", "tlas_prim",
          "blas_min", "blas_max", "blas_left", "blas_right", "blas_prim",
          "blas_root", "inst_bmin", "inst_bmax", "t0_T", "t1_R")


@pytest.mark.parametrize("name", _ARENA)
def test_two_level_arena_matches_reference(grass, name):
    """The port's own build of the arena: integers bit for bit, floats to
    the last bit the host builds share (atol 1e-6)."""
    ref, port = grass[0], grass[1]
    assert isinstance(port.instances, tinst.TwoLevel)
    got = getattr(port.instances, name).numpy()
    want = np.asarray(getattr(ref.instances, name))
    assert got.shape == want.shape
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_two_level_traversal_matches_reference(grass):
    import jax.numpy as jnp
    from slr_tpu.accel.twolevel import intersect_instances as ref_isect

    ref, port, carried, arena, (o, d, f) = grass
    want = ref_isect(ref.geometry, ref.instances, jnp.asarray(o),
                     jnp.asarray(d), jnp.asarray(f))
    args = (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(f))
    for inst, geom in ((arena, carried.geometry),
                       (port.instances, port.geometry)):
        got = intersect_instances(geom, inst, *args)
        hits_agree(_np(got), _np(want))
        m = np.asarray(want.mask)
        assert (got.inst.numpy()[m] == np.asarray(want.inst)[m]).mean() \
            > 0.995
    assert np.asarray(want.mask).sum() >= 10   # blades are thin


def test_scene_oracle_matches_the_chunk_cast(grass):
    """The static prefix by the BVH traversal and the instances by the
    two-level one, against the chunk cast of the same scene."""
    _, port, _, _, (o, d, f) = grass
    args = (torch.as_tensor(o), torch.as_tensor(d))
    ft = torch.as_tensor(f)
    got = intersect_scene_oracle(port, *args, f=ft)
    want = scene_intersect(port, *args, f=ft)
    hits_agree(_np(got), _np(want))
    m = want.mask.numpy()
    assert (got.inst.numpy()[m] == want.inst.numpy()[m]).mean() > 0.995
    assert (got.inst.numpy() >= 0).sum() > 10


def test_single_instance_arena():
    """One instance: the TLAS root's two children are the same leaf."""
    pos = np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]])
    tv = np.int32([[0, 1, 2], [1, 3, 2]])
    m = np.eye(4, dtype=np.float32)
    two = tinst.build_two_level(pos, tv, [(0, 2)], [(0, m, m)])
    assert two.tlas_left.tolist() == [-1] and two.tlas_right.tolist() == [-1]
    assert two.blas_prim.tolist() in ([0, 1], [1, 0])
    assert two.num == 1
