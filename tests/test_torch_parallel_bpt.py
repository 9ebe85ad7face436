"""Pixel-sharded rendering across ranks: slr_tpu_torch's render_sharded
(the fixed-depth path tracer) and render_bpt_sharded on gloo worlds of 2
and 3 CPU processes against slr_tpu's on meshes of as many of conftest's
virtual devices, the same Cornell scene carried across, and world 1
in-process against world N.

Pixels are padded to a multiple of the ranks with inert lanes (21x10 and
13x9 do not divide by 3 or 2). The estimate of every pixel is the
single-process one. Against the reference (Plücker casts on the CPU) a
path whose decision flips on a tie differs from there on: the gate is the
share of entries within the JAX tests' tolerance (rtol 2e-4, atol 1e-5)
and the means; world 1 against world N is held to the tolerance itself."""
import numpy as np
import pytest
import torch

from slr_tpu_torch.parallel.mesh import (
    make_mesh,
    render_bpt_sharded,
    render_sharded,
)
from slr_tpu_torch.scene.bridge import from_reference
from test_torch_reference_build import load_reference_sbvh
from torch_dist_worker import run_ranks

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5
WORLDS = (2, 3)
PT = dict(width=21, height=10, spp=3, max_depth=4)
BPT = dict(width=13, height=9, spp=2, max_light_verts=3, max_eye_verts=3)


@pytest.fixture(scope="module")
def scenes():
    """name -> (reference scene, the port's CPU copy)."""
    load_reference_sbvh()
    from slr_tpu.scene.presets import cornell_box_spheres

    out = {}
    for name, kw in (("rgb", {}), ("spectral", dict(spectral=True)),
                     ("diffuse", dict(metal=False, glass=False))):
        ref = cornell_box_spheres(sphere_res=6, use_bvh=False, **kw)
        out[name] = (ref, from_reference(ref))
    return out


def _pt_args():
    return (PT["width"], PT["height"], PT["spp"]), dict(
        max_depth=PT["max_depth"], seed=2)


def _bpt_args():
    return (BPT["width"], BPT["height"], BPT["spp"]), dict(
        max_light_verts=BPT["max_light_verts"],
        max_eye_verts=BPT["max_eye_verts"], seed=2)


@pytest.fixture(scope="module")
def worlds(scenes, tmp_path_factory):
    """world size -> each rank's [rgb PT, spectral PT, BPT] films."""
    a, k = _pt_args()
    ba, bk = _bpt_args()
    jobs = [("render_sharded", (scenes["rgb"][1],) + a, k),
            ("render_sharded", (scenes["spectral"][1],) + a, k),
            ("render_bpt_sharded", (scenes["diffuse"][1],) + ba, bk)]
    return {n: run_ranks(n, jobs, str(tmp_path_factory.mktemp(f"w{n}")))
            for n in WORLDS}


@pytest.fixture(scope="module")
def references(scenes):
    from slr_tpu.parallel.mesh import make_mesh as ref_mesh
    from slr_tpu.parallel.mesh import render_bpt_sharded as ref_bpt
    from slr_tpu.parallel.mesh import render_sharded as ref_pt

    a, k = _pt_args()
    ba, bk = _bpt_args()
    out = {}
    for n in WORLDS:
        mesh = ref_mesh(n)
        out[n] = [np.asarray(ref_pt(scenes["rgb"][0], *a, mesh=mesh, **k)),
                  np.asarray(ref_pt(scenes["spectral"][0], *a, mesh=mesh,
                                    **k)),
                  np.asarray(ref_bpt(scenes["diffuse"][0], *ba, mesh=mesh,
                                     **bk))]
    return out


def _share_close(a, b):
    return (np.abs(a - b) <= RTOL * np.abs(b) + ATOL).mean()


CASES = [pytest.param(0, id="pt-rgb"), pytest.param(1, id="pt-spectral"),
         pytest.param(2, id="bpt")]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_matches_reference(worlds, references, n, case):
    got = worlds[n][0][case]
    want = references[n][case]
    assert got.shape == want.shape
    assert np.isfinite(got).all() and got.mean() > 0
    assert _share_close(got, want) >= 0.98
    assert abs(got.mean() / want.mean() - 1.0) < 0.01


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_world_one_equals_world_n(scenes, worlds, n, case):
    mesh = make_mesh("cpu")
    if case < 2:
        a, k = _pt_args()
        scene = scenes["spectral" if case else "rgb"][1]
        one = render_sharded(scene, *a, mesh=mesh, **k)
    else:
        a, k = _bpt_args()
        one = render_bpt_sharded(scenes["diffuse"][1], *a, mesh=mesh, **k)
    np.testing.assert_allclose(worlds[n][0][case], one.numpy(), rtol=RTOL,
                               atol=ATOL)
    for r in range(1, n):
        np.testing.assert_array_equal(worlds[n][r][case], worlds[n][0][case])


def test_world_one_is_the_single_process_render(scenes):
    """At world 1 the pixel-sharded PT is `render`'s estimator and BPT is
    `render_bpt` at the same flat caps (before the strata's conversion)."""
    from slr_tpu_torch.render.bpt import render_bpt
    from slr_tpu_torch.render.pt import render

    mesh = make_mesh("cpu")
    a, k = _pt_args()
    np.testing.assert_array_equal(
        render_sharded(scenes["rgb"][1], *a, mesh=mesh, **k).numpy(),
        render(scenes["rgb"][1], *a, device="cpu", **k).numpy())
    ba, bk = _bpt_args()
    np.testing.assert_array_equal(
        render_bpt_sharded(scenes["diffuse"][1], *ba, mesh=mesh,
                           **bk).numpy(),
        render_bpt(scenes["diffuse"][1], *ba, device="cpu", **bk).numpy())
