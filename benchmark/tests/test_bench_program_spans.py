"""The program's spans as the readers take them: kept to the traced window,
the device's idle time summed by the innermost span open at each gap's
start, nothing from a program without spans, and the new metrics on the
small CPU cells (device ones absent there)."""
from __future__ import annotations

import json

import numpy as np
import pytest

import run as bench_run
from conftest import small_cell
from harness import program_spans
from harness.record import Run
from harness.trace import Events
from slr_tpu_torch.utils import metrics
from slr_tpu_torch.utils.metrics import SpanRecord

US = 1000
SEED = 2 ** 31 + 777


def rec(name, start_us, end_us, parent=None, device_ms=None, **counts):
    return SpanRecord(name, parent, None, start_us * US, end_us * US,
                      device_ms, counts)


def synthetic_run(records, starts_us, ends_us, steps=1):
    """A traced run over a window of 0-1000 us with the given device
    activities and the program's records."""
    run = Run(cell=None, seed=0, device="cpu")
    run.intervals = [("window", 0, 1000 * US)]
    run.events = Events(names=["k"] * len(starts_us),
                        start=np.array(starts_us, np.int64) * US,
                        end=np.array(ends_us, np.int64) * US)
    run.spans["step"] = [0.001] * steps
    run.cache["program_spans"] = records
    return run


def test_idle_goes_to_the_innermost_span_at_the_gap_start():
    recs = [rec("pt.bounce", 100, 900),
            rec("pt.shade", 100, 300, parent=0),
            rec("cast.closest", 300, 700, parent=0),
            rec("cast.prepare", 300, 400, parent=2),
            rec("pt.shade", 700, 900, parent=0)]
    # Gaps: 0-50 and 60-120 (no span yet), 200-350 (shade, though it ends
    # in the cast), 380-450 (prepare), 500-720 (closest), 800-950 (the
    # second shade), 990-1000 (none).
    run = synthetic_run(recs, [50, 120, 350, 450, 720, 950],
                        [60, 200, 380, 500, 800, 990], steps=2)
    idle = program_spans.idle_by_span(run)
    assert idle[""] == pytest.approx((50 + 60 + 10) * 1e-6)
    assert idle["pt.shade"] == pytest.approx((150 + 150) * 1e-6)
    assert idle["cast.prepare"] == pytest.approx(70e-6)
    assert idle["cast.closest"] == pytest.approx(220e-6)
    assert idle["pt.bounce"] == 0.0
    busy = 10 + 80 + 30 + 50 + 80 + 40
    assert sum(idle.values()) == pytest.approx((1000 - busy) * 1e-6)
    assert program_spans.idle_ms_per_step(
        run, lambda n: n.startswith("cast.")) == pytest.approx(0.29 / 2)


def test_device_ms_and_counts_by_name():
    recs = [rec("wavefront.iter", 0, 500, live=3, lanes=8),
            rec("cast.closest", 0, 100, 0, device_ms=2.0),
            rec("wavefront.shade", 100, 200, 0, device_ms=1.5),
            rec("wavefront.iter", 500, 1000, live=1, lanes=8),
            rec("cast.closest", 500, 600, 3, device_ms=1.0)]
    run = synthetic_run(recs, [0], [10])
    assert program_spans.iterations(run) == 2
    assert program_spans.device_ms_per_iter(
        run, ("cast.closest",)) == pytest.approx(1.5)
    assert program_spans.device_ms(run, ("wavefront.shade",)) == 1.5
    # A span without device time (a CPU run) gives no device metric.
    recs[1].device_ms = None
    assert program_spans.device_ms(run, ("cast.closest",)) is None
    assert bench_run.read_layer_metric("wavefront.live_lanes_pct", run) \
        == pytest.approx(100 * 4 / 16)


def test_records_are_kept_to_the_window_and_absent_without_spans(
        monkeypatch):
    inside = rec("wavefront.iter", 200, 300)
    monkeypatch.setattr(metrics, "spans", lambda: [
        rec("wavefront.iter", 0, 150), inside, rec("cast.closest", 900,
                                                    1200)])
    run = Run(cell=None, seed=0, device="cpu")
    run.intervals = [("window", 100 * US, 1000 * US)]
    assert program_spans.records(run) == [inside]
    monkeypatch.delattr(metrics, "spans")
    older = Run(cell=None, seed=0, device="cpu")
    older.intervals = run.intervals
    assert program_spans.records(older) is None
    assert program_spans.idle_by_span(older) is None
    for name in ("cast.device_ms_per_iter", "cast.prepare_pct",
                 "wavefront.live_lanes_pct", "grad.cast_idle_ms"):
        assert bench_run.read_layer_metric(name, older) is None


@pytest.mark.parametrize("name", ["cornell_pt", "cornell_grad"])
def test_new_metrics_on_the_small_cells(name, capsys):
    """Traced CPU runs: the live-lane share comes from the program's
    counter; every metric of device time is left out."""
    metrics.clear_spans()
    bench_run.main(["--workload", name, "--seed", str(SEED), "--seconds",
                    "0.3", "--trace", "1"], device="cpu",
                   cell=small_cell(name))
    res = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
    got = res["metrics"]
    assert res["correct"] is True
    if name == "cornell_pt":
        assert 0 < got["wavefront.live_lanes_pct"]["value"] <= 100
        assert got["wavefront.live_lanes_pct"]["unit"] == "%"
    assert not {"cast.device_ms_per_iter", "cast.prepare_pct",
                "shade.device_ms_per_iter",
                "wavefront.bank_device_ms_per_iter",
                "wavefront.sort_device_ms_per_iter", "grad.cast_idle_ms",
                "grad.shade_idle_ms"} & set(got)
    assert set(got) <= {m["name"] for m in small_cell(name).per_layer}
