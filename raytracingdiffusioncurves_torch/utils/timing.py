"""Timing, tracing and metrics.

The reference's observability is two wall timers and a frame-counter printf
(optixHello.cpp:104-105,1156-1157,1253-1263) plus `-lineinfo` for external
profilers.  Here, as in the JAX package (the same JSON keys):

* ``PhaseTimer``: named phase accumulation with the reference's protocol
  (setup once, mean frame time) plus percentiles;
* ``trace_to``: a context manager around ``torch.profiler`` that writes a
  Chrome trace (chrome://tracing, Perfetto) of the host and the card;
* ``Metrics``: a counter/gauge sink with one-line JSON dumps (the
  structured form of the reference's prints).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict


class PhaseTimer:
    def __init__(self):
        self.phases: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name].append(time.perf_counter() - t0)

    def mean_ms(self, name: str) -> float:
        xs = self.phases.get(name, [])
        return 1000.0 * sum(xs) / len(xs) if xs else 0.0

    def summary(self) -> dict:
        out = {}
        for name, xs in self.phases.items():
            xs_sorted = sorted(xs)
            out[name] = {
                "count": len(xs),
                "mean_ms": round(1000.0 * sum(xs) / len(xs), 3),
                "min_ms": round(1000.0 * xs_sorted[0], 3),
                "p50_ms": round(1000.0 * xs_sorted[len(xs) // 2], 3),
                "max_ms": round(1000.0 * xs_sorted[-1], 3),
            }
        return out

    def report(self) -> str:
        return json.dumps(self.summary())


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the block with torch.profiler (host activity, and the card's
    kernels when CUDA is available) and write ``logdir/trace.json``, a
    Chrome trace.  The reference relied on nvcc -lineinfo + Nsight
    (CMakeLists.txt:179-184)."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Metrics:
    """Minimal counter/gauge registry with JSON line output."""

    def __init__(self):
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}

    def inc(self, name: str, value: float = 1.0):
        self.counters[name] += value

    def set(self, name: str, value: float):
        self.gauges[name] = float(value)

    def dump(self) -> str:
        return json.dumps({"counters": dict(self.counters), "gauges": self.gauges})
