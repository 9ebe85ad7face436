"""Rendering across ranks: slr_tpu_torch's render_wavefront_sharded on gloo
worlds of 2 and 3 CPU processes (3 gives work ranges that do not divide)
against slr_tpu's on meshes of as many of conftest's virtual devices, the
same Cornell scene carried across; world 1 in-process against world N;
the ranged `_run_wavefront`; the process-group set-up.

Random streams are keyed by (pixel, sample), so every work item's estimate
is the same on any rank: the sharded films differ from one render's only
in their sum order (the JAX tests' own tolerance, rtol 2e-4 / atol 1e-5).
The reference casts through its Plücker intersector on the CPU, the port
through its chunk traversal: a path whose decision flips on a tie differs
from there on, so against the reference the gate is the share of pixels
within that tolerance and the means."""
import numpy as np
import pytest
import torch

from slr_tpu_torch.parallel import distributed as pdist
from slr_tpu_torch.parallel.mesh import make_mesh, render_wavefront_sharded
from slr_tpu_torch.render.wavefront import _run_wavefront, render_wavefront
from slr_tpu_torch.scene.bridge import from_reference
from test_torch_reference_build import load_reference_sbvh
from torch_dist_worker import run_ranks

torch.set_num_threads(1)

W, H, SPP, SEED = 21, 10, 3, 1
RTOL, ATOL = 2e-4, 1e-5
WORLDS = (2, 3)


@pytest.fixture(scope="module")
def scenes():
    """spectral -> (reference scene, the port's CPU copy)."""
    load_reference_sbvh()
    from slr_tpu.scene.presets import cornell_box_spheres

    out = {}
    for spectral in (False, True):
        ref = cornell_box_spheres(sphere_res=6, use_bvh=False,
                                  spectral=spectral)
        out[spectral] = (ref, from_reference(ref))
    return out


@pytest.fixture(scope="module")
def worlds(scenes, tmp_path_factory):
    """world size -> each rank's results: the RGB and spectral sharded
    wavefront renders, and (world 2) the dryrun."""
    out = {}
    for n in WORLDS:
        jobs = [("render_wavefront_sharded", (scenes[s][1], W, H, SPP),
                 dict(seed=SEED, return_iters=True)) for s in (False, True)]
        if n == 2:
            jobs.append(("dryrun", (), {}))
        out[n] = run_ranks(n, jobs, str(tmp_path_factory.mktemp(f"w{n}")))
    return out


@pytest.fixture(scope="module")
def references(scenes):
    """(world, spectral) -> the reference's sharded render on a mesh of as
    many devices."""
    from slr_tpu.parallel.mesh import make_mesh as ref_mesh
    from slr_tpu.parallel.mesh import render_wavefront_sharded as ref_render

    return {(n, s): np.asarray(ref_render(scenes[s][0], W, H, spp=SPP,
                                          mesh=ref_mesh(n), seed=SEED))
            for n in WORLDS for s in (False, True)}


def _share_close(a, b):
    close = np.abs(a - b) <= RTOL * np.abs(b) + ATOL
    return close.all(axis=-1).mean()


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("spectral", [False, True], ids=["rgb", "spectral"])
def test_wavefront_sharded_matches_reference(worlds, references, n,
                                             spectral):
    img, _ = worlds[n][0][int(spectral)]
    ref = references[n, spectral]
    assert img.shape == ref.shape == (H, W, 3)
    assert np.isfinite(img).all()
    assert _share_close(img, ref) >= 0.98
    assert abs(img.mean() / ref.mean() - 1.0) < 0.01


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("spectral", [False, True], ids=["rgb", "spectral"])
def test_world_one_equals_world_n(scenes, worlds, n, spectral):
    """The in-process world of one (no process group) against N ranks: the
    same work items, another film sum order."""
    one = render_wavefront_sharded(scenes[spectral][1], W, H, SPP,
                                   make_mesh("cpu"), seed=SEED).numpy()
    whole = render_wavefront(scenes[spectral][1], W, H, SPP, seed=SEED,
                             device="cpu").numpy()
    np.testing.assert_array_equal(one, whole)
    img, _ = worlds[n][0][int(spectral)]
    np.testing.assert_allclose(img, one, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_holds_the_image(worlds, n):
    """The reduced film reaches every rank, bit for bit; each rank drained
    its own range in its own iterations."""
    for spectral in (0, 1):
        imgs = [worlds[n][r][spectral][0] for r in range(n)]
        for img in imgs[1:]:
            np.testing.assert_array_equal(img, imgs[0])
        assert all(worlds[n][r][spectral][1] > 0 for r in range(n))


def test_dryrun_on_two_ranks(worlds):
    assert worlds[2][0][2] is True and worlds[2][1][2] is True


def _film(scene, **kw):
    n_pix = W * H
    return _run_wavefront(scene, n_pix, SPP, SEED, W, H, 0, 100,
                          n_lanes=64, **kw)


@pytest.mark.parametrize("split", [0, 211, 630])
def test_ranged_run_splits_the_work(scenes, split):
    """Two ranges [0, split) and [split, total) hold every work item once:
    their films add up to the whole range's; the whole range given
    explicitly is the unranged call bit for bit."""
    scene = scenes[False][1]
    total = SPP * W * H
    whole, iters = _film(scene)
    full, full_iters = _film(scene, work_lo=0, work_hi=total)
    np.testing.assert_array_equal(full.numpy(), whole.numpy())
    assert full_iters == iters
    a, _ = _film(scene, work_lo=0, work_hi=split)
    b, _ = _film(scene, work_lo=split, work_hi=total + 17)
    np.testing.assert_allclose((a + b).numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)
    if split == 0:
        assert not a.any()


def test_init_distributed_without_a_world(monkeypatch):
    """Without torchrun's WORLD_SIZE nothing is set up: the world is one
    process, whose collectives are the identity."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pdist.init_distributed(device="cpu") is False
    mesh = make_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    x = torch.arange(6.0)
    for op in ("sum", "min", "max"):
        assert mesh.all_reduce(x, op) is x
    assert mesh.all_gather(x) is x
    mesh.barrier()


def test_backend_is_never_switched(monkeypatch):
    """NCCL is refused for CPU ranks instead of falling to gloo."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="gloo"):
        pdist.init_distributed(backend="nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pdist.init_distributed()
    assert not torch.distributed.is_initialized()

