"""What one run carries between its entry, the per-layer readers and the
comparison: the cell, the seed, the device, counters and spans taken on
the host, the trace's summary, and the program's state while it lives."""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from .clock import sync


@dataclasses.dataclass
class Run:
    cell: object                  # harness.spec.Cell
    seed: int
    device: str
    counters: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)
    summary: object = None        # harness.trace.Summary of a traced run
    events: object = None         # harness.trace.Events of a traced run
    intervals: list = dataclasses.field(default_factory=list)
    state: dict = dataclasses.field(default_factory=dict)   # the program's
    kept: dict = dataclasses.field(default_factory=dict)    # outputs judged
    cache: dict = dataclasses.field(default_factory=dict)

    @property
    def seed32(self) -> int:
        """The renderer's seed: its random streams hash 32-bit seeds."""
        return self.seed & 0xFFFFFFFF

    def generator(self, salt: int = 0) -> torch.Generator:
        """A generator on the run's device, seeded from --seed and `salt`."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + salt) % (1 << 63))
        return g

    @contextlib.contextmanager
    def span(self, name: str, synced: bool = True):
        """A benchmark span: host-clock seconds into `spans[name]`, and its
        interval in the profiler's clock (ns since the epoch) into
        `intervals`. Synchronised at both ends unless `synced` is False."""
        if synced:
            sync(self.device)
        t0, w0 = time.perf_counter(), time.time_ns()
        yield
        if synced:
            sync(self.device)
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)
        self.intervals.append((name, w0, time.time_ns()))
