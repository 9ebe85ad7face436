"""BENCHMARK.json against the contract's shape, and every cell, config,
traffic mix, entry, limit and per-layer reader found by name."""
from __future__ import annotations

import importlib
import json
import os
import re

import pytest

from conftest import BENCH_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_found_by_name(cell):
    from harness import spec

    c = spec.load_cell(cell)
    assert c.chips == 1
    importlib.import_module("entries." + c.entry)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], "moves a metric this cell "
                                   "does not report")
        assert os.path.exists(os.path.join(
            BENCH_DIR, "layer_metrics", m["name"] + ".py"))


@pytest.mark.parametrize("config", [c["name"] for c in bench()["configs"]])
def test_config_files(config):
    c = {x["name"]: x for x in bench()["configs"]}[config]
    assert c["file"].startswith("benchmark/")
    with open(os.path.join(ROOT, c["file"])) as f:
        body = json.load(f)
    assert body["reduced"] == c["reduced"]
    assert body["spectral"] and body["max_depth"] == 100


def test_every_reader_is_named_in_benchmark_json():
    have = {f[:-3] for f in os.listdir(os.path.join(BENCH_DIR,
                                                    "layer_metrics"))
            if f.endswith(".py") and f != "__init__.py"}
    assert have == {m["name"] for m in bench()["per_layer"]}


def test_unknown_workload_is_refused():
    from harness import spec

    with pytest.raises(SystemExit):
        spec.load_cell("no_such_cell")
