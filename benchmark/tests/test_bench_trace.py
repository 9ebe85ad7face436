"""The trace's reduction: device time is the union of the activities inside
the window, and idle time is summed by span and gap length."""
from __future__ import annotations

import numpy as np
import pytest

from harness.trace import Events, summarise

US = 1000


def test_union_clipping_and_idle_classes():
    # Two overlapping kernels, one 50 us gap, one 2 ms gap, one kernel
    # sticking out of the window.
    start = np.array([0, 5, 65, 2075]) * US + 10 * US
    end = np.array([10, 15, 70, 2200]) * US + 10 * US
    ev = Events(names=["a", "b", "a", "c"], start=start, end=end)
    window = ("window", 10 * US, 2100 * US)
    s = summarise(ev, [("pass", 10 * US, 2100 * US), window])
    assert s.window_s == pytest.approx(2090e-6)
    assert s.busy_s == pytest.approx((15 + 5 + 15) * 1e-6)
    assert s.device_ops == 4
    assert s.top_ops[0] == ["a", pytest.approx(15e-6)]
    idle = dict(s.idle_gaps)
    assert idle["pass gaps 20-100us x1"] == pytest.approx(50e-6)
    assert idle["pass gaps 1-10ms x1"] == pytest.approx(2005e-6)
    assert sum(idle.values()) + s.busy_s == pytest.approx(s.window_s)


def test_no_window_is_an_error():
    ev = Events(names=[], start=np.zeros(0, np.int64),
                end=np.zeros(0, np.int64))
    with pytest.raises(RuntimeError):
        summarise(ev, [("pass", 0, 1)])
