"""A run's last line holds exactly the contract's keys, the numbers
compared come last there and on standard error, and a run on the CPU at a
few pixels agrees with the reference in every cell."""
from __future__ import annotations

import json

import pytest

import run as bench_run
from conftest import small_cell

SEED = 2 ** 31 + 12345


def drive(name, trace, capsys, cell=None):
    bench_run.main(["--workload", name, "--seed", str(SEED), "--seconds",
                    "0.5", "--trace", str(trace)], device="cpu",
                   cell=cell or small_cell(name))
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("name", ["cornell_pt", "cornell_grad"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(name, trace, capsys):
    res, err = drive(name, trace, capsys)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(res) == keys + ["checks"]
    assert res["correct"] is True and res["attempted"] >= 1
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    cell = small_cell(name)
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # CPU runs report no device metric.
        assert not any(k.startswith(("device.", "cast."))
                       for k in res["metrics"])
        assert "scene.load_s" in res["metrics"]
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    tail = err.strip().splitlines()[-len(res["checks"]):]
    for line, (k, c) in zip(tail, res["checks"].items()):
        assert line.startswith(f"check {k} ") and c["value"] <= c["limit"]
