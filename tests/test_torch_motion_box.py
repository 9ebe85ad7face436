"""Per-ray culling against the box of an instance that turns fast over the
shutter.

The box of a moving instance's entry is its local box's corners taken at 17
shutter fractions (both packages, `motion_bounds_np`). A thin bar that turns
170 degrees about the vertical in one shutter sweeps an arc whose top (at 90
degrees) lies between two sampled fractions, 0.0021 beyond the box. The
reference visits an entry for a whole ray block once any ray of the block
meets the box and then tests every ray of the block, as the plain versions
do; the CUDA kernels test a ray only where its own slab test meets the box.
With the reference's boxes that rule misses the rays that graze the arc's
top, which the reference and the plain versions hit. The casts therefore
cull with `cast_boxes`: a moving instance's entries widened by a bound on
how far its triangles stray from the box (`motion_slack`), so the kernels'
rule gives the plain versions' hits again, bit for bit, and the chunk
tables stay the reference's.
"""
import numpy as np
import pytest
import torch

from chip_smoke import BAR_L as L
from chip_smoke import BAR_RAYS as N
from chip_smoke import turning_bar, turning_bar_rays
from slr_tpu_torch.accel import traverse as tv
from slr_tpu_torch.accel.intersect import RAY_EPSILON
from slr_tpu_torch.scene.bridge import from_reference
from slr_tpu_torch.scene.build import SceneBuilder
from test_torch_traverse_cull import MARGIN, any_hit_culled, closest_hit_culled

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cast():
    scene = turning_bar(SceneBuilder)
    pt = scene.pallas_tris
    o, d, f = turning_bar_rays()
    rays, wl, cnt, _, _ = tv.prepare_cast(
        pt, torch.as_tensor(o), torch.as_tensor(d), RAY_EPSILON,
        float("inf"), None, f=torch.as_tensor(f))
    return scene, pt, rays, wl, cnt


def test_grazing_rays_lie_beyond_the_sampled_box(cast):
    """The case exists: the arc's top is out of the reference's box by more
    than the kernels' margin, and inside the widened cast box."""
    _, pt, _, _, _ = cast
    inst = pt.entry_inst >= 0
    zmin = float(pt.boxes[inst, 2].min())
    margin = float(MARGIN * (1.0 + pt.boxes[inst, 0:6].abs().max()))
    assert zmin + L > 1.5e-3 and 1.4e-3 < zmin + L - 2 * margin
    assert float(pt.cast_boxes[inst, 2].min()) <= -L
    # The widening is a bound (measured 0.0061, three times the gap), not
    # a blanket: under 1% of the bar's length.
    assert float(tv.motion_slack(pt.boxes, pt.entry_inst,
                                 pt.inst_trs).max()) < 1e-2 * L


def test_the_old_rule_misses_what_the_plain_version_hits(cast):
    """With the reference's boxes, per-ray culling loses every grazing ray
    that the plain versions (the reference's block rule) hit."""
    _, pt, rays, wl, cnt = cast
    plain = tv.closest_hit_plain(rays, wl, cnt, pt)[2].reshape(-1)[:2 * N]
    old = closest_hit_culled(rays, wl, cnt, pt, 8, boxes=pt.boxes)[2]
    assert bool((plain >= 0).all())
    assert not bool((old.reshape(-1)[N:2 * N] >= 0).any())


@pytest.mark.parametrize("sub_lanes", [1, 8])
def test_culled_closest_hit_equals_plain_version(cast, sub_lanes):
    _, pt, rays, wl, cnt = cast
    got = closest_hit_culled(rays, wl, cnt, pt, sub_lanes)
    want = tv.closest_hit_plain(rays, wl, cnt, pt)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((want[2].reshape(-1)[N:2 * N] >= 0).all())


def test_culled_any_hit_equals_plain_version(cast):
    """Shadow rays down to just above the ground: the bar occludes them."""
    scene, pt, _, _, _ = cast
    o, d, f = turning_bar_rays()
    rays, wl, cnt, _, _ = tv.prepare_cast(
        pt, torch.as_tensor(o), torch.as_tensor(d), RAY_EPSILON,
        torch.full((2 * N,), 2.4), None, f=torch.as_tensor(f))
    got = any_hit_culled(rays, wl, cnt, pt)
    want = tv.any_hit_plain(rays, wl, cnt, pt)
    assert torch.equal(got, want)
    assert bool((want.reshape(-1)[:2 * N] == 1).all())
    old = any_hit_culled(rays, wl, cnt, pt, boxes=pt.boxes)
    assert not bool((old.reshape(-1)[N:2 * N] == 1).any())


def test_casts_meet_the_reference_kernels():
    """The port's casts (plain versions) against the reference's Pallas
    kernels in interpret mode on the same scene carried across: every ray
    hits the bar, the grazing ones included, with the same triangle and t
    within 1e-4; occlusion equal."""
    import jax.numpy as jnp
    from slr_tpu.accel import pallas_intersect as jpi
    from slr_tpu.scene.build import SceneBuilder as JBuilder

    ref = turning_bar(JBuilder)
    port = from_reference(ref)
    o, d, f = turning_bar_rays()
    hit = tv.intersect_pallas(port.geometry, port.pallas_tris,
                              torch.as_tensor(o), torch.as_tensor(d),
                              f=torch.as_tensor(f), instances=port.instances)
    k = jpi.intersect_pallas(ref.geometry, ref.pallas_tris, jnp.asarray(o),
                             jnp.asarray(d), f=jnp.asarray(f),
                             instances=ref.instances, interpret=True)
    assert bool(hit.mask.all()) and bool((hit.inst == 0).all())
    np.testing.assert_array_equal(hit.mask.numpy(), np.asarray(k.mask))
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(k.tri))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(k.t), rtol=1e-4)
    tmax = np.full(2 * N, 2.4, np.float32)
    occ = tv.anyhit_pallas(port.geometry, port.pallas_tris,
                           torch.as_tensor(o), torch.as_tensor(d),
                           tmax=torch.as_tensor(tmax), f=torch.as_tensor(f))
    k_occ = jpi.anyhit_pallas(ref.geometry, ref.pallas_tris, jnp.asarray(o),
                              jnp.asarray(d), tmax=jnp.asarray(tmax),
                              f=jnp.asarray(f), interpret=True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(k_occ))
    assert bool(occ.all())
