"""Render checkpoint / resume (counterpart of slr_tpu/utils/checkpoint.py,
in its `.npz` format).

The film accumulator and the sample counter are plain arrays, so a render
can snapshot at every export and resume: the counter-based RNG keys each
sample by (pixel, sample index), so the continuation draws what an
uninterrupted run draws.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np


def save_checkpoint(path: str, state: dict[str, Any]) -> None:
    """Persist a dict of arrays / scalars to `path` + '.npz'."""
    np.savez(path + ".npz", **{k: np.asarray(v) for k, v in state.items()})


def load_checkpoint(path: str) -> Optional[dict[str, Any]]:
    """The dict written by save_checkpoint to `path`; None if absent."""
    if not os.path.exists(path + ".npz"):
        return None
    with np.load(path + ".npz") as z:
        return {k: z[k] for k in z.files}
