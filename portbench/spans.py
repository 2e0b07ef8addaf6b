"""The span recorder: host-clock intervals around the benchmark's calls into
each layer of the program, kept in memory.  While a trace is taken each
span is also a ``record_function`` range, so the trace shows what the host
was doing during a gap on the device."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self):
        self.tracing = False
        self.total = defaultdict(float)   # name -> seconds, over the measured window
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        ranged = torch.profiler.record_function(name) if self.tracing else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ranged:
            yield
        if not self.tracing:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1


class GcPauses:
    """Host time spent in the garbage collector, read through
    ``gc.callbacks`` while the object is one of them."""

    def __init__(self):
        self.total = 0.0   # seconds
        self.count = 0
        self._t0 = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.total += time.perf_counter() - self._t0
            self.count += 1
            self._t0 = None
