"""The program's spans (`slr_tpu_torch/utils/metrics.py`): off unless a
profiler records or `record_spans()` is open, no change to any result, the
phases nested under their iteration, the fixed-depth tracer's span counts,
the wavefront's live-lane counter against a recount, host stamps in the
profiler's clock, and the CLI's trace track and phase table."""
import json
import time
from unittest import mock

import pytest
import torch

from slr_tpu_torch.render import pt, wavefront
from slr_tpu_torch.scene.presets import cornell_box_spheres
from slr_tpu_torch.utils import metrics
from slr_tpu_torch.utils.metrics import clear_spans, record_spans, span, spans

W, H, SEED = 8, 6, 5
DEPTH = 3
PHASES = {"wavefront.shade", "wavefront.bank", "wavefront.sort",
          "wavefront.sync", "cast.closest", "cast.shadow"}


@pytest.fixture(scope="module")
def scene():
    return cornell_box_spheres(sphere_res=4, spectral=True, device="cpu")


@pytest.fixture(autouse=True)
def _fresh_records():
    clear_spans()
    yield
    clear_spans()


def _wavefront(scene):
    return wavefront.render_wavefront(scene, W, H, spp=2, seed=SEED,
                                      max_depth=8, return_iters=True,
                                      n_lanes=16, device="cpu")


def _fixed(scene):
    return pt.render(scene, W, H, spp=1, seed=SEED, max_depth=DEPTH,
                     ray_batch=W * H // 2, device="cpu")


@pytest.mark.parametrize("renderer", [_wavefront, _fixed],
                         ids=["wavefront", "fixed_depth"])
def test_spans_off_record_nothing_and_on_change_no_bit(scene, renderer):
    off = renderer(scene)
    assert spans() == []
    with record_spans():
        on = renderer(scene)
    assert spans()
    off_img = off[0] if isinstance(off, tuple) else off
    on_img = on[0] if isinstance(on, tuple) else on
    assert torch.equal(off_img, on_img)
    if isinstance(off, tuple):
        assert off[1] == on[1]


def test_wavefront_phases_nest_under_iterations(scene):
    with record_spans():
        _, n_iters = _wavefront(scene)
    recs = spans()
    iters = [r for r in recs if r.name == "wavefront.iter"]
    assert [r.iter for r in iters] == list(range(n_iters))
    assert all(r.parent is None for r in iters)
    for r in recs:
        if r.name == "wavefront.iter":
            continue
        parent = recs[r.parent]
        if r.name == "cast.prepare":
            assert parent.name in ("cast.closest", "cast.shadow")
            parent = recs[parent.parent]
        else:
            assert r.name in PHASES
        assert parent.name == "wavefront.iter" and r.iter == parent.iter
    per_iter = {}
    for r in recs:
        if r.name != "wavefront.iter" and recs[r.parent].name == \
                "wavefront.iter":
            per_iter.setdefault(r.iter, []).append(r.name)
    assert all(names == ["cast.closest", "wavefront.shade", "cast.shadow",
                         "wavefront.shade", "wavefront.bank",
                         "wavefront.sort", "wavefront.sync"]
               for names in per_iter.values())


def test_fixed_depth_span_counts_and_nesting(scene):
    """Two batches of DEPTH bounces on a scene without alpha: per batch one
    `pt.camera`, DEPTH `pt.bounce`, `cast.shadow` and `pt.sort`, three
    `pt.shade` a bounce, 1 + DEPTH `cast.closest`, and a `cast.prepare` in
    every cast."""
    assert not scene.has_alpha
    with record_spans():
        _fixed(scene)
    recs = spans()
    count = {}
    for r in recs:
        count[r.name] = count.get(r.name, 0) + 1
    batches = 2
    assert count == {"pt.camera": batches, "pt.bounce": batches * DEPTH,
                     "pt.shade": 3 * batches * DEPTH,
                     "pt.sort": batches * DEPTH,
                     "cast.shadow": batches * DEPTH,
                     "cast.closest": batches * (1 + DEPTH),
                     "cast.prepare": batches * (1 + 2 * DEPTH)}
    for r in recs:
        if r.name in ("pt.camera", "pt.bounce"):
            assert r.parent is None
        elif r.name == "cast.prepare":
            assert recs[r.parent].name in ("cast.closest", "cast.shadow")
        else:
            assert recs[r.parent].name in ("pt.camera", "pt.bounce")
            assert r.iter == recs[r.parent].iter
    assert [r.iter for r in recs if r.name == "pt.bounce"] == \
        list(range(DEPTH)) * batches


def test_live_lanes_match_a_recount(scene):
    """Sum of the iterations' `live` counts = the active lanes of each
    iteration's closest-hit cast, counted again in a plain run."""
    with record_spans():
        _, n_iters = _wavefront(scene)
    iters = [r for r in spans() if r.name == "wavefront.iter"]
    assert all(r.counts["lanes"] == 16 for r in iters)
    clear_spans()
    active = []
    cast = wavefront.scene_intersect_alpha

    def counting(*args, **kwargs):
        active.append(int(kwargs["active"].sum()))
        return cast(*args, **kwargs)

    with mock.patch.object(wavefront, "scene_intersect_alpha", counting):
        _, n_again = _wavefront(scene)
    assert n_again == n_iters == len(active)
    assert [r.counts["live"] for r in iters] == active
    assert 0 < sum(active) < 16 * n_iters


def test_host_stamps_inside_the_call_and_no_device_time(scene):
    t0 = time.time_ns()
    with record_spans():
        _fixed(scene)
    t1 = time.time_ns()
    recs = spans()
    assert all(t0 <= r.start_ns <= r.end_ns <= t1 for r in recs)
    for r in recs:
        if r.parent is not None:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    assert all(r.device_ms is None for r in recs)


def test_a_profiler_turns_spans_on():
    with span("outside"):
        pass
    assert spans() == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("inside", it=3, n=2):
            with span("child"):
                pass
    recs = spans()
    assert [(r.name, r.parent, r.iter) for r in recs] == \
        [("inside", None, 3), ("child", 0, 3)]
    assert recs[0].counts == {"n": 2}


def test_record_spans_turns_spans_on_without_a_profiler():
    with record_spans():
        with span("a"):
            pass
        with record_spans():
            with span("b"):
                pass
        with span("c"):
            pass
    with span("d"):
        pass
    assert [r.name for r in spans()] == ["a", "b", "c"]
    with record_spans(), span("open"):
        with pytest.raises(RuntimeError):
            clear_spans()


def test_profile_trace_writes_a_span_track_and_takes_the_records(tmp_path,
                                                                  scene):
    with metrics.profile_trace(str(tmp_path)) as taken:
        _, n_iters = _wavefront(scene)
    assert spans() == []
    names = [r.name for r in taken]
    assert names.count("wavefront.iter") == n_iters
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    track = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in track] == names
    assert all(e["dur"] >= 0 for e in track)
    table = metrics.phase_table(taken)
    rows = {line.split()[0]: line.split() for line in table.splitlines()[1:]}
    assert int(rows["wavefront.iter"][1]) == n_iters
    assert rows["wavefront.iter"][2] == "-"
    assert any(c.startswith("live=") for c in rows["wavefront.iter"])
