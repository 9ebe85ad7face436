"""Cutting the wavefront's lanes to the live ones once its work queue has
drained (render/wavefront.py `_cut_width`, `_compact`).

On the CPU the film `index_add_` sums in lane order, and both forms of the
cut (a view of the sorted lanes' prefix; a stable gather of the unsorted
live lanes) keep the live lanes' order, so a render with cutting is bit for
bit the render with cutting turned off (the module constant raised above
any width), in as many iterations. Held on the Cornell parity scene at
depth 100, sorted and unsorted, whole and in the ranged form of
`render_wavefront_sharded`, and on a scene whose rays recast through an
alpha cut-out and escape to an environment. The spans record each cut and
the width every iteration ran over."""
import os

import numpy as np
import pytest
import torch

from slr_tpu_torch.render import wavefront
from slr_tpu_torch.scene.api import load_scene
from slr_tpu_torch.scene.build import SceneBuilder
from slr_tpu_torch.scene.presets import uv_sphere
from slr_tpu_torch.utils.metrics import clear_spans, record_spans, spans

torch.set_num_threads(1)

PARITY = os.path.join(os.path.dirname(__file__), "parity_scenes",
                      "Cornell_Box_Parity.txt")
LANES, SEED, DEPTH = 1024, 7, 100
NEVER = 2 ** 40      # COMPACT_MIN_LANES above any width: no cut


def _cutout_under_sky():
    """A matte sphere on a matte floor under a sun-and-sky environment,
    behind a quad whose alpha is 0 everywhere: every camera ray that meets
    the quad is cast again past it, paths bounce between sphere and floor,
    and rays that miss both escape to the sky."""
    b = SceneBuilder()
    mat = b.add_matte(b.add_stex_const((0.8, 0.7, 0.6)))
    b.add_mesh(*uv_sphere((0.0, 0.0, 0.0), 1.0, 8, 16), mat)

    def quad(corners, normal):
        return (np.float32(corners), np.float32([normal] * 4),
                np.float32([[1, 0, 0]] * 4),
                np.float32([[0, 0], [1, 0], [1, 1], [0, 1]]),
                np.int32([[0, 1, 2], [0, 2, 3]]))
    b.add_mesh(*quad([[-9, -1, -9], [-9, -1, 9], [9, -1, 9], [9, -1, -9]],
                     [0, 1, 0]), mat)
    b.add_mesh(*quad([[-0.6, -0.6, -2], [0.6, -0.6, -2], [0.6, 0.6, -2],
                      [-0.6, 0.6, -2]], [0, 0, -1]), mat,
               alpha_ftex=b.add_ftex_const(0.0))
    sky = np.full((8, 16, 3), 0.1, np.float32)
    sky[:4] += 0.4
    sky[2, 4] = 80.0
    b.set_environment(b.add_stex_image(b.add_image(sky)), 1.0)
    cam = np.eye(4, dtype=np.float32)
    cam[2, 3] = -4.0
    b.set_camera_perspective(cam, aspect=1.0, fovy=0.6, lens_radius=0.0,
                             img_dist=1.0, obj_dist=4.0)
    return b.build(use_bvh=False)


@pytest.fixture(scope="module")
def scenes():
    return {"parity": load_scene(PARITY, spectral=True, device="cpu")[0],
            "alpha_env": _cutout_under_sky()}


# (scene, width, height, spp, work_lo, work_hi): 2,048 items on 1,024
# lanes; the ranged case drains the items [300, 1900) as a rank would.
CASES = {"parity": ("parity", 32, 32, 2, 0, None),
         "parity_ranged": ("parity", 32, 32, 2, 300, 1900),
         "alpha_env": ("alpha_env", 32, 32, 2, 0, None)}

_RENDERS: dict = {}


def _render(scenes, case, sort_rays, min_lanes):
    """(film, iterations, span records) of one render, kept per module."""
    key = (case, sort_rays, min_lanes)
    if key not in _RENDERS:
        name, w, h, spp, lo, hi = CASES[case]
        saved = wavefront.COMPACT_MIN_LANES
        wavefront.COMPACT_MIN_LANES = min_lanes
        clear_spans()
        try:
            with record_spans():
                film, iters = wavefront._run_wavefront(
                    scenes[name], w * h, spp, SEED, w, h, 0, DEPTH,
                    n_lanes=LANES, sort_rays=sort_rays, work_lo=lo,
                    work_hi=hi)
            _RENDERS[key] = (film, iters, spans())
        finally:
            wavefront.COMPACT_MIN_LANES = saved
            clear_spans()
    return _RENDERS[key]


@pytest.mark.parametrize("sort_rays", [True, False],
                         ids=["sorted", "unsorted"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cut_film_is_bit_for_bit_the_uncut_film(scenes, case, sort_rays):
    film, iters, recs = _render(scenes, case, sort_rays,
                                wavefront.COMPACT_MIN_LANES)
    film_off, iters_off, recs_off = _render(scenes, case, sort_rays, NEVER)
    assert torch.equal(film, film_off)
    assert film.abs().sum() > 0
    assert iters == iters_off
    assert sum(r.name == "wavefront.compact" for r in recs) >= 1
    assert not any(r.name == "wavefront.compact" for r in recs_off)


@pytest.mark.parametrize("sort_rays", [True, False],
                         ids=["sorted", "unsorted"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_iterations_record_the_width_they_ran_over(scenes, case, sort_rays):
    """Every iteration's live lanes fit its width; the width is the run's
    lanes until the first cut and a power of two >= 256 after it, and
    each cut at least halves it, to the width the next iteration runs
    over, and still holds the live lanes it counted."""
    _, iters, recs = _render(scenes, case, sort_rays,
                             wavefront.COMPACT_MIN_LANES)
    its = [r for r in recs if r.name == "wavefront.iter"]
    assert [r.iter for r in its] == list(range(iters))
    assert all(0 < r.counts["live"] <= r.counts["lanes"] for r in its)
    cuts = {r.iter: r.counts for r in recs if r.name == "wavefront.compact"}
    assert all(r.parent is None for r in recs
               if r.name == "wavefront.compact")
    first = min(cuts)
    assert all(r.counts["lanes"] == LANES for r in its[:first])
    for r in its[first:]:
        n = r.counts["lanes"]
        assert n >= 256 and n & (n - 1) == 0
    width = LANES
    for r in its:
        if r.iter in cuts:
            c = cuts[r.iter]
            assert c["lanes_from"] == width
            assert c["live"] <= c["lanes_to"] <= width // 2
            assert c["live"] == r.counts["live"]
            width = c["lanes_to"]
        assert r.counts["lanes"] == width


def test_cut_width_is_the_smallest_power_of_two_that_holds_the_live():
    cut = wavefront._cut_width
    assert wavefront.COMPACT_MIN_LANES == 256
    assert [cut(n) for n in (1, 255, 256, 257, 1000, 1024, 1025)] == \
        [256, 256, 256, 512, 1024, 1024, 2048]
    assert cut(786_433) == 2 ** 20 < 1_572_864


@pytest.mark.parametrize("sort_rays", [True, False],
                         ids=["sorted", "unsorted"])
def test_compact_keeps_the_live_lanes_in_order(sort_rays):
    """Eight lanes of which five are live (work < 10): the cut to six
    holds them first, in their order. Sorted lanes hold them as a prefix
    already; unsorted ones are gathered, then a drained lane fills the
    width."""
    if sort_rays:
        work = torch.tensor([3, 9, 0, 5, 7, 12, 10, 11])
    else:
        work = torch.tensor([12, 3, 10, 9, 0, 11, 5, 7])
    lane = wavefront.LaneState(*([work] + [work * 2 + j for j in range(15)]))
    ones = torch.ones((8, 4))
    cut, ones_cut = wavefront._compact(lane, ones, 10, 6, sort_rays)
    assert cut.work[:5].tolist() == [w for w in work.tolist() if w < 10]
    assert cut.work.shape == (6,) and cut.work[5] >= 10
    for j, x in enumerate(cut[1:]):
        assert torch.equal(x, cut.work * 2 + j)
    assert ones_cut.shape == (6, 4)
