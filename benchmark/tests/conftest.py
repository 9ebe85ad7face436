"""The benchmark's CPU tests: run with `python -m pytest benchmark/tests`
from the repository's root. Cells are shrunk to a few pixels here; the
timed sizes run only on the card."""
from __future__ import annotations

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (BENCH_DIR, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def small_cell(name: str):
    """The cell `name` at a size the CPU runs in seconds."""
    from harness import spec

    cell = spec.load_cell(name)
    if cell.entry == "wavefront_passes":
        cell.traffic.update(width=24, height=18, lanes=24 * 18 * 4,
                            check_items=64,
                            warmup={"width": 8, "height": 6, "max_depth": 2})
    else:
        cell.traffic.update(width=16, height=12, max_depth=4,
                            traced_steps=1)
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
