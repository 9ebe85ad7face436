"""Observability: build stats, render meters and device traces
(counterpart of slr_tpu/utils/metrics.py).

Build and render stats go through the standard `logging` module (logger
"slr_tpu_torch"), plus:

* `RenderMeter` — wall-clock and derived rays/s over render passes;
* `profile_trace` — a `torch.profiler` trace of a block, written as a
  Chrome trace into a directory.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field

logger = logging.getLogger("slr_tpu_torch")


def log_build_stats(kind: str, **stats) -> None:
    """One structured line per build event (BVH, scene)."""
    parts = " ".join(f"{k}={v}" for k, v in stats.items())
    logger.info("[build] %s %s", kind, parts)


@dataclass
class RenderMeter:
    """Accumulates ray-cast counts and wall time across passes.

    Its ray count is nominal: one closest-hit cast for the camera ray plus
    (closest + one shared shadow cast) per bounce up to `max_depth`, for
    every sample, whatever depth the paths reach."""

    width: int
    height: int
    max_depth: int
    has_env: bool = True
    samples: int = 0
    seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def casts_per_sample(self) -> int:
        return self.width * self.height * (1 + 2 * self.max_depth)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, samples: int) -> None:
        self.seconds += time.perf_counter() - self._t0
        self.samples += samples

    @property
    def rays(self) -> int:
        return self.casts_per_sample() * self.samples

    @property
    def mrays_per_s(self) -> float:
        return self.rays / max(self.seconds, 1e-9) / 1e6

    def report(self) -> str:
        return (f"{self.samples} spp in {self.seconds:.2f}s — "
                f"{self.mrays_per_s:.3f} Mrays/s "
                f"({self.rays / 1e6:.1f}M casts)")


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Trace a block with torch.profiler (host and, where there is one, the
    CUDA device) and write `trace.json` (Chrome trace format) into
    `log_dir`. No-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("[profile] trace written to %s", path)
