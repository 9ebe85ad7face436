"""The comparison deciding `correct` fails what it must: the control (the
reference in bfloat16 in the program's place) in every cell, and a run with
its timed path broken underneath, once for each fault the cell can have.
On the CPU at a few pixels; the readings at the cells' own sizes come from
`calibrate.py` on the card."""
from __future__ import annotations

import importlib
import json

import pytest
import torch

import run as bench_run
from conftest import small_cell
from harness.record import Run

SEED = 2 ** 31 + 4242


def fails(numbers: dict, limits: dict) -> bool:
    """As run.py decides: a number fails unless it is within its limit (a
    NaN fails)."""
    return not all(v <= limits[k] for k, v in numbers.items())


@pytest.mark.parametrize("name", ["cornell_pt", "cornell_grad"])
def test_control_fails_and_program_passes(name):
    cell = small_cell(name)
    entry = importlib.import_module("entries." + cell.entry)
    base = Run(cell=cell, seed=SEED, device="cpu")
    entry.setup(base)
    assert not fails(entry.calibrate(base), cell.limits)
    run = Run(cell=cell, seed=SEED + 1, device="cpu")
    run.state["scene"] = base.state["scene"]
    run.kept.update(scene_path=base.kept["scene_path"],
                    render_seed=base.kept["render_seed"])
    assert fails(entry.control(run), cell.limits)


def _altered(fn):
    """Every pixel of each image the program renders, 1% brighter."""
    def wrapped(*a, **k):
        out = fn(*a, **k)
        if isinstance(out, tuple):
            return (out[0] * 1.01,) + out[1:]
        return out * 1.01
    return wrapped


def _half_batch(fn):
    """Half of the pixels left out: each odd pixel takes the mean of the
    rendered ones beside it (its left neighbour)."""
    def wrapped(*a, **k):
        out = fn(*a, **k)
        img = out[0] if isinstance(out, tuple) else out
        img = img.clone()
        img[:, 1::2] = img[:, 0::2][:, :img[:, 1::2].shape[1]]
        return (img,) + out[1:] if isinstance(out, tuple) else img
    return wrapped


def _drive(name, capsys, cell=None):
    bench_run.main(["--workload", name, "--seed", str(SEED), "--seconds",
                    "0.3", "--trace", "0"], device="cpu",
                   cell=cell or small_cell(name))
    return json.loads(capsys.readouterr()[0].strip().splitlines()[-1])


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
def test_render_faults_are_caught(fault, monkeypatch, capsys):
    from slr_tpu_torch.render import wavefront

    wrap = _altered if fault == "answer_altered" else _half_batch
    monkeypatch.setattr(wavefront, "render_wavefront",
                        wrap(wavefront.render_wavefront))
    assert _drive("cornell_pt", capsys)["correct"] is False


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_grad_faults_are_caught(fault, monkeypatch, capsys):
    from slr_tpu_torch.render import pt

    entry = importlib.import_module("entries.grad_steps")
    if fault == "state_unchanged":
        setup = entry.setup

        def frozen_setup(run):
            step = torch.optim.Adam.step
            torch.optim.Adam.step = lambda self, closure=None: None
            try:
                setup(run)
            finally:
                torch.optim.Adam.step = step
        monkeypatch.setattr(entry, "setup", frozen_setup)
    else:
        wrap = _altered if fault == "answer_altered" else _half_batch
        monkeypatch.setattr(pt, "render", wrap(pt.render))
    assert _drive("cornell_grad", capsys)["correct"] is False
