"""Closest hits over chunk tables sharded by range: slr_tpu_torch's
intersect_scene_sharded on gloo worlds of 2 and 3 CPU processes against
slr_tpu's on meshes of as many virtual devices (its Pallas kernel in
interpret mode), on the Cornell scene carried across, with
tests/test_pallas.py's criteria; against the unsharded cast; with inert
lanes."""
import numpy as np
import pytest
import torch

from slr_tpu_torch.parallel.mesh import make_mesh
from slr_tpu_torch.parallel.scene_shard import intersect_scene_sharded
from slr_tpu_torch.render.pt import scene_intersect
from slr_tpu_torch.scene.bridge import from_reference
from test_torch_reference_build import load_reference_sbvh
from torch_dist_worker import run_ranks
from torch_shard_scenes import hits_agree, random_rays

torch.set_num_threads(1)

WORLDS = (2, 3)
O, D = random_rays(512, 0.9)
ACTIVE = np.arange(512) % 3 != 1


@pytest.fixture(scope="module")
def scenes():
    load_reference_sbvh()
    from slr_tpu.scene.presets import cornell_box_spheres

    ref = cornell_box_spheres(sphere_res=12)
    return ref, from_reference(ref)


@pytest.fixture(scope="module")
def worlds(scenes, tmp_path_factory):
    port = scenes[1]
    jobs = [("cast", (port, O, D, 1e-4, float("inf")), {}),
            ("cast", (port, O, D, 1e-4, 1.5), dict(active=ACTIVE))]
    return {n: run_ranks(n, jobs, str(tmp_path_factory.mktemp(f"w{n}")))
            for n in WORLDS}


def _hit(h):
    return {k: np.asarray(getattr(h, k)) for k in ("t", "tri", "mask")}


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_closest_hit_matches_reference(scenes, worlds, n):
    import jax.numpy as jnp
    from slr_tpu.parallel.mesh import make_mesh as ref_mesh
    from slr_tpu.parallel.scene_shard import intersect_scene_sharded as ref

    want = ref(scenes[0], ref_mesh(n), jnp.asarray(O), jnp.asarray(D))
    got = worlds[n][0][0]
    hits_agree(got, _hit(want))
    assert got["mask"].mean() > 0.5


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", [0, 1], ids=["all", "active-tmax"])
def test_sharded_equals_unsharded(scenes, worlds, n, case):
    """Against the port's one-device cast: the same closest hit, its
    barycentrics and its cast t on every hit ray; every rank holds it."""
    o, d = torch.as_tensor(O), torch.as_tensor(D)
    kw = dict(tmax=1.5, active=torch.as_tensor(ACTIVE)) if case else {}
    want = scene_intersect(scenes[1], o, d, **kw)
    one = intersect_scene_sharded(scenes[1], make_mesh("cpu"), o, d, **kw)
    got = worlds[n][0][case]
    m = want.mask.numpy()
    for h in (got, {k: v.numpy() for k, v in one._asdict().items()
                    if v is not None}):
        np.testing.assert_array_equal(h["mask"], m)
        np.testing.assert_array_equal(h["tri"][m], want.tri.numpy()[m])
        for k in ("t", "b0", "b1", "t_cast"):
            np.testing.assert_array_equal(h[k][m],
                                          getattr(want, k).numpy()[m])
    if case:
        assert not got["mask"][~ACTIVE].any()
    for r in range(1, n):
        for k in ("t", "tri", "mask", "t_cast"):
            np.testing.assert_array_equal(worlds[n][r][case][k], got[k])
