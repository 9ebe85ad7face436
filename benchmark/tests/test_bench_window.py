"""The window's rule: calls start only while the elapsed time is under the
window's length; the last one counts whole, with its whole time."""
from __future__ import annotations

import time

from harness.clock import run_window


def test_last_call_counts_whole():
    durations = [0.03, 0.03, 0.2, 0.03]
    done = []

    def step(i):
        time.sleep(durations[i])
        done.append(i)

    n, elapsed = run_window(step, 0.05, "cpu")
    # Calls 0 and 1 end at ~0.06 s > 0.05 s: no third call starts.
    assert n == 2 and done == [0, 1]
    assert elapsed >= 0.06
    n, elapsed = run_window(lambda i: time.sleep([0.01, 0.2][i % 2]),
                            0.1, "cpu")
    # The second call runs past the window and is counted with its time.
    assert n == 2 and elapsed >= 0.21
    rate = n / elapsed
    assert rate < n / 0.1


def test_one_long_call_fills_the_window():
    n, elapsed = run_window(lambda i: time.sleep(0.12), 0.05, "cpu")
    assert n == 1 and elapsed >= 0.12
