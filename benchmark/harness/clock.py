"""The measured window's clock and the kernels' event timer."""
from __future__ import annotations

import statistics
import time

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(step, seconds: float, device,
               durations: list | None = None) -> tuple[int, float]:
    """Calls `step(i)` for i = 0, 1, ... while the elapsed time is under
    `seconds`, each call ending in a synchronise; the last call is counted
    whole, with its whole time. Returns (calls, seconds from the window's
    start to the end of the last call), so that work / time is all the
    work over all the time. Each call's seconds go into `durations`."""
    sync(device)
    t0 = time.perf_counter()
    n = 0
    while True:
        t1 = time.perf_counter()
        step(n)
        sync(device)
        n += 1
        now = time.perf_counter()
        if durations is not None:
            durations.append(now - t1)
        elapsed = now - t0
        if elapsed >= seconds:
            return n, elapsed


def median_ms(fn, runs: int = 25) -> float:
    """CUDA events around each of `runs` calls after one warm-up call; the
    median in milliseconds."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
