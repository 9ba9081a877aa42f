"""Timing, tracing and metrics.

The reference's observability is two wall timers and a frame-counter printf
(optixHello.cpp:104-105,1156-1157,1253-1263) plus `-lineinfo` for external
profilers.  Here:

* ``span``: the program's span recorder.  ``with span("post.blur",
  frame=state.frame):`` marks one stage of the work; names are dotted,
  layer first.  Off by default: ``span`` then returns one shared no-op
  object and reads no clock.  ``enable()`` turns it on; each span then
  records its name, start and end in ns of ``now_ns`` (``time.time_ns``,
  the Unix clock that ``torch.profiler``'s device events use), its parent
  (the span open on its thread when it began), its thread and its
  attributes, into a list of ``CAPACITY`` spans; spans past it are counted
  in ``dropped``.  ``with span(...) as sp:`` ... ``sp.set(k=v)`` adds
  attributes known only inside the block (a no-op while off).  ``drain()``
  hands them over, ``disable()`` stops it.
* ``PhaseTimer``: named phase accumulation with the reference's protocol
  (setup once, mean frame time) plus percentiles, with the JAX package's
  JSON keys; its phases are spans of the same record and clock, timed
  whether the recorder is on or off and kept by the timer alone.
* ``trace_to``: a context manager around ``torch.profiler`` that writes a
  Chrome trace (chrome://tracing, Perfetto) of the host and the card, with
  the program's spans on a track of their own.
* ``Metrics``: a counter/gauge sink with one-line JSON dumps (the
  structured form of the reference's prints).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple

# The clock of every span: ns since the Unix epoch.
now_ns = time.time_ns
# Spans one drain holds at most; spans past it are counted in ``dropped``.
CAPACITY = 1 << 18


class Span(NamedTuple):
    """One recorded span.  ``parent``: the index, in the same drain, of the
    span open on the same thread when this one began (-1: none).
    ``thread``: ``threading.get_native_id()`` of that thread."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    thread: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_on = False
dropped = 0
# The record since the last drain, column by column (name, start, end,
# parent, thread, attrs), in start order: columns of strings, ints and
# dicts of ints, so a long record gives the garbage collector nothing to
# scan; an open span's end is 0.
_cols: tuple[list, ...] = ([], [], [], [], [], [])
_stacks: dict[int, list[int]] = {}  # per thread, the indices of its open spans
_lock = threading.Lock()


class _Noop:
    """What ``span`` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NOOP = _Noop()


class _Open:
    """A span being timed, and kept in the recorder when ``keep`` and the
    recorder is on at its start (PhaseTimer's phases are timed, not kept).
    A kept span holds the columns and the thread's stack it went into: a
    drain in between leaves the new record alone."""

    __slots__ = ("name", "attrs", "keep", "start", "end", "thread", "parent", "index", "cols",
                 "stack")

    def __init__(self, name: str, attrs: dict, keep: bool = True):
        self.name, self.attrs, self.keep = name, attrs, keep
        self.index = -1

    def __enter__(self):
        global dropped
        # the thread's native id as threading caches it (no system call)
        self.thread = tid = threading.current_thread().native_id
        self.parent = -1
        if _on and self.keep:
            with _lock:
                cols = _cols
                i = len(cols[0])
                if i < CAPACITY:
                    stack = _stacks.setdefault(tid, [])
                    if stack:
                        self.parent = stack[-1]
                    stack.append(i)
                    names, starts, ends, parents, threads, attrs = cols
                    names.append(self.name)
                    starts.append(0)
                    ends.append(0)
                    parents.append(self.parent)
                    threads.append(tid)
                    attrs.append(self.attrs)
                    self.index, self.cols, self.stack = i, cols, stack
                else:
                    dropped += 1
        self.start = now_ns()
        if self.index >= 0:
            self.cols[1][self.index] = self.start
        return self

    def __exit__(self, *exc):
        self.end = now_ns()
        if self.index >= 0:
            self.cols[2][self.index] = self.end
            self.stack.pop()
        return False

    def set(self, **attrs):
        """Adds ``attrs`` to the span's attributes (for values known only
        inside the block)."""
        self.attrs.update(attrs)

    @property
    def span(self) -> Span:
        """The Span (closed: after the block)."""
        return Span(self.name, self.start, self.end, self.parent, self.thread, self.attrs)


def span(name: str, **attrs):
    """A context manager that records the block as a span named ``name``
    with ``attrs`` (``frame=state.frame`` on each frame's spans) while the
    recorder is on; the shared ``NOOP`` while it is off."""
    if not _on:
        return NOOP
    return _Open(name, attrs)


def spanned(name: str):
    """Decorator: each call of the function is a span named ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> list[Span]:
    """The spans recorded since the last drain, in start order, and a fresh
    record (``dropped`` back to 0: read it first).  A span still open
    comes with ``end_ns`` 0."""
    global _cols, dropped
    with _lock:
        cols, _cols = _cols, ([], [], [], [], [], [])
        _stacks.clear()
        dropped = 0
    return [Span(*fields) for fields in zip(*cols)]


class PhaseTimer:
    def __init__(self):
        self.spans: list[Span] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        timed = _Open(name, {}, keep=False)
        with timed:
            yield
        self.spans.append(timed.span)

    @property
    def phases(self) -> dict[str, list[float]]:
        """Seconds of each phase's spans, by name, in order."""
        out: dict[str, list[float]] = defaultdict(list)
        for s in self.spans:
            out[s.name].append(s.seconds)
        return out

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


def _chrome_events(spans: list[Span], base_ns: int = 0, pid: str = "program spans") -> list[dict]:
    """The spans as Chrome trace events ("X", µs since ``base_ns``) on a
    process track of their own, one row per thread."""
    events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
               "args": {"name": pid}}]
    for s in spans:
        if s.end_ns < s.start_ns:  # still open at the drain
            continue
        events.append({"ph": "X", "name": s.name, "cat": s.name.split(".")[0], "pid": pid,
                       "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": dict(s.attrs)})
    return events


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the block with torch.profiler (host activity, and the card's
    kernels when CUDA is available) and write ``logdir/trace.json``, a
    Chrome trace, with the program's spans (the recorder is on inside the
    block; the trace takes what it holds at the end) on their own track,
    on the profiler's clock.  The reference
    relied on nvcc -lineinfo + Nsight (CMakeLists.txt:179-184)."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was_on = _on
    enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        if not was_on:
            disable()
    spans = drain()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"] += _chrome_events(spans, int(trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)


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
