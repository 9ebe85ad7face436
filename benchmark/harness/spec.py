"""A cell's specification, found by name: its entry in BENCHMARK.json, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), its limits (`checks/<cell>.json`) and the
metrics it reports."""
from __future__ import annotations

import dataclasses
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file, with "name"
    traffic: dict         # the traffic mix's file, with "name"
    limits: dict          # number compared -> its limit
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list

    @property
    def entry(self) -> str:
        return self.traffic["entry"]

    def param(self, key: str):
        """A traffic parameter, or else the configuration's."""
        if key in self.traffic:
            return self.traffic[key]
        return self.config[key]


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def load_cell(name: str, bench_path: str | None = None) -> Cell:
    bench = _load(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = dict(_load(os.path.join(ROOT, cfg["file"])), name=w["config"])
    traffic = dict(_load(os.path.join(BENCH_DIR, "traffic",
                                      w["traffic"] + ".json")),
                   name=w["traffic"])
    limits = _load(os.path.join(BENCH_DIR, "checks", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits["limits"], end_to_end=e2e,
                per_layer=per_layer)
