"""The program's own spans in a traced run, and the device operations each
stage launched.

The harness's traced window (``core.run``) keeps the device operations and
the harness's spans; it turns on no recorder of the program and keeps no
launch calls.  ``of(tr)`` runs, once per traced run and after the check, a
second window of its own on the same cell, scene, settings and device: the
program's span recorder (``raytracingdiffusioncurves_torch.utils.timing``)
on from the scene's set-up, the loop's warm-up as ``core.run`` makes it,
then ``trace_frames`` frames under the profiler (device activity, with the
launch calls that the CUDA activity brings), and for the still loop one
launch of the trace kernel's counting instantiation after the profiler
stops.  Each device operation of that window goes to the innermost program
span open on its launching thread when its launch call began, matched by
correlation id; nothing is guessed from the operations' own times.

Where the program has no recorder, or the cell runs across cards (its
ranks have ended by then), ``of`` returns None and runs nothing, so every
reader of it leaves its metric out of the line.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading
import time
import traceback
from collections import defaultdict

from perfbench import core


@dataclasses.dataclass
class Stages:
    """The second window: its device operations (name, start_ns,
    duration_ns) and harness spans (name, start_ns, duration_ns) as
    ``core.Trace`` holds them, the program's spans (``timing.Span``, set-up
    included), ``launches`` (correlation id -> (start_ns, thread: the native
    id of the launching thread, None where the profiler's thread cannot be
    named)), each operation's correlation id in ``device_ops``' order, and
    the trace kernel's walk counters (None where there is no counting
    launch)."""

    kind: str
    frames: int
    device_ops: list
    spans: list
    program_spans: list
    launches: dict = dataclasses.field(default_factory=dict)
    device_corr: list = dataclasses.field(default_factory=list)
    walk_stats: dict | None = None
    dropped: int = 0
    _op_spans: list | None = None

    def op_spans(self) -> list[int]:
        """Per device operation, the index in ``program_spans`` of the
        innermost span open on its launching thread when the launch call
        began, or -1 (no launch event, an unnamed thread, or no span open)."""
        if self._op_spans is None:
            self._op_spans = assign_ops(self.program_spans, self.device_corr, self.launches)
        return self._op_spans


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from raytracingdiffusioncurves_torch.utils import timing
    except ImportError:
        return None
    return timing if all(hasattr(timing, f) for f in ("enable", "disable", "drain")) else None


_last: tuple = (None, None)  # (the Trace, its Stages): one run's window


def of(tr) -> Stages | None:
    """The second window of the traced run ``tr`` (a ``core.Trace``), run
    on first use; None where the program records no spans or the window
    failed (the failure printed on stderr)."""
    global _last
    if _last[0] is not tr:
        got = None
        timing = recorder() if tr.ranks is None else None
        if timing is not None:
            try:
                got = measure(tr, timing)
            except Exception:  # a reader leaves its metric out, the run goes on
                print("stage window failed:\n" + traceback.format_exc(), file=sys.stderr)
            if got is not None:
                print("stages " + json.dumps(stage_table(got)), file=sys.stderr)
        _last = (tr, got)
    return _last[1]


def _frames(loop, kind: str, n: int, dev, rec: list):
    """``n`` frames as ``core``'s loops run them in their windows: the still
    loop double-buffered, the session loop one waited frame after another
    along its cycle.  Returns the last frame's counter."""
    last = 0
    if kind == "still":
        pending = None
        for _ in range(n):
            with core.Span("enqueue", rec=rec):
                st, _, _ = loop._frame()
            fence = core._Fence(dev)
            if pending is not None:
                with core.Span("wait", rec=rec):
                    pending.wait()
            pending, last = fence, st.frame
        with core.Span("wait", rec=rec):
            pending.wait()
    else:
        for i in range(n):
            last = loop._frame(i % len(loop.frames)).index
    return last


def measure(tr, timing) -> Stages:
    import torch

    import raytracingdiffusioncurves_torch as rt

    cell = tr.cell
    dev = torch.device(str(tr.dev))
    # the second window's own phases, in s (stderr's stage_window_s)
    clock = {"start": time.perf_counter()}
    timing.drain()
    timing.enable()
    loop = prof = None
    try:
        dscene = rt.build_device_scene(rt.load_scene_from_string(tr.xml), device=dev)
        net = rt.net_for_params(core.nested_params(cell.weights), device=dev)
        cfg = rt.RenderConfig(**tr.settings)
        loop = core.LOOPS[cell.kind](rt, cell, dscene, cfg, net, dev, {})
        clock["setup"] = time.perf_counter()
        loop.warmup()
        clock["warmup"] = time.perf_counter()
        if dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        loop.prime()
        frames = int(cell.workload["trace_frames"])
        host: list = []
        loop.rec = host
        last = _frames(loop, cell.kind, frames, dev, host)
        loop.rec = None
        if prof is not None:
            prof.stop()
        clock["traced"] = time.perf_counter()
        timing.disable()
        dropped = timing.dropped
        program_spans = timing.drain()
        ops, corr, launches = [], [], {}
        if prof is not None:
            ops, corr, launches = collect(prof, host, threading.get_native_id())
        walk = None
        if cell.kind == "still" and dev.type == "cuda":
            walk = walk_stats(loop, dscene, cfg, last)
        clock["collect"] = time.perf_counter()
        marks = list(clock.items())
        print("stage_window_s " + json.dumps({k: t1 - t0 for (_, t0), (k, t1)
                                              in zip(marks, marks[1:])}), file=sys.stderr)
        return Stages(cell.kind, frames, ops, host, program_spans, launches, corr, walk, dropped)
    finally:
        timing.disable()
        if loop is not None:
            loop.release()
        del prof, loop
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def collect(prof, host: list, thread: int) -> tuple[list, list, dict]:
    """(device operations, each one's correlation id, launches) from a
    stopped profiler: the operations that start at or after the first
    harness span (the primed frame's came before it), and for each, the
    earliest CUDA runtime or driver API call (``cu*``) of the same
    correlation id.  The profiler numbers threads its own way; where every
    launch came from one of its threads, that thread is ``thread`` (the
    native id of the thread that drove the window), else the launches'
    thread is None."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    first = min((s for _, s, _ in host), default=0)
    kept = [e for e in events if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation() and e.start_ns() >= first]
    ops = [(e.name(), e.start_ns(), e.duration_ns()) for e in kept]
    corr = [e.correlation_id() for e in kept]
    wanted = set(corr)
    calls: dict[int, tuple[int, int]] = {}
    for e in events:
        c = e.correlation_id()
        if (e.device_type() != DeviceType.CUDA and c in wanted and e.name().startswith("cu")
                and (c not in calls or e.start_ns() < calls[c][0])):
            calls[c] = (e.start_ns(), e.start_thread_id())
    named = len({t for _, t in calls.values()}) == 1
    launches = {c: (t0, thread if named else None) for c, (t0, _) in calls.items()}
    return ops, corr, launches


def walk_stats(loop, dscene, cfg, frame: int) -> dict | None:
    """The trace kernel's walk counters (one launch of its counting
    instantiation) on the still loop's hoisted tables at ``frame``, or None
    where the tables are not distance-ordered."""
    from raytracingdiffusioncurves_torch.ops import trace_cuda

    t = loop.tables
    if t is None or not t.dist_ordered or not hasattr(trace_cuda, "trace_walk_stats"):
        return None
    return trace_cuda.trace_walk_stats(dscene, loop.camera, cfg, frame, 0,
                                       dscene.width * dscene.height, t)


def assign_ops(program_spans: list, device_corr: list, launches: dict) -> list[int]:
    """Stages.op_spans: one sweep per thread over the spans' starts and ends
    and the launch calls, in time order (at one instant a start comes
    before a launch, and a launch before an end)."""
    out = [-1] * len(device_corr)
    calls = defaultdict(list)
    for k, c in enumerate(device_corr):
        launch = launches.get(c)
        if launch is not None and launch[1] is not None:
            calls[launch[1]].append((launch[0], 1, k))
    spans = defaultdict(list)
    for i, sp in enumerate(program_spans):
        if sp.thread in calls and sp.end_ns >= sp.start_ns:
            spans[sp.thread] += [(sp.start_ns, 0, i), (sp.end_ns, 2, i)]
    for thread, events in calls.items():
        stack: list[int] = []
        for _, what, x in sorted(events + spans[thread]):
            if what == 0:
                stack.append(x)
            elif what == 2:
                stack.remove(x)
            elif stack:
                out[x] = stack[-1]
    return out


# ---------------------------------------------------------------------------
# what the readers share
# ---------------------------------------------------------------------------


def window_ns(st: Stages) -> tuple[int, int] | None:
    """The window on the host clock: the first harness span's start to the
    last one's end."""
    if not st.spans:
        return None
    return min(s for _, s, _ in st.spans), max(s + d for _, s, d in st.spans)


def windowed(st: Stages) -> list[int]:
    """Indices of the program's spans that start inside the window."""
    w = window_ns(st)
    if w is None:
        return []
    return [i for i, p in enumerate(st.program_spans)
            if w[0] <= p.start_ns <= w[1] and p.end_ns >= p.start_ns]


def host_ms(tr, kind: str, name: str):
    """Host ms per frame of the window in the program's spans named
    ``name``, or None where the program recorded none there."""
    if tr.kind != kind:
        return None
    st = of(tr)
    if st is None or st.frames <= 0:
        return None
    got = [st.program_spans[i] for i in windowed(st) if st.program_spans[i].name == name]
    if not got:
        return None
    return sum(p.end_ns - p.start_ns for p in got) * 1e-6 / st.frames


def enclosing(st: Stages, name: str) -> list[int]:
    """Per device operation, the index of the program span named ``name``
    that holds its launch (the innermost span it was assigned to, or one of
    that span's ancestors), or -1."""
    spans = st.program_spans
    memo: dict[int, int] = {}

    def find(i: int) -> int:
        if i not in memo:
            memo[i] = -1 if i < 0 else (i if spans[i].name == name else find(spans[i].parent))
        return memo[i]

    return [find(i) for i in st.op_spans()]


def attributed(st: Stages | None) -> bool:
    """Whether the window assigns device operations to program spans (it
    needs the launch calls: none on the CPU)."""
    return st is not None and bool(st.launches) and any(i >= 0 for i in st.op_spans())


def launched_in(st: Stages | None, name: str) -> list[int] | None:
    """Indices of the device operations launched inside spans named
    ``name`` (their children included), or None without attribution."""
    if not attributed(st):
        return None
    return [k for k, i in enumerate(enclosing(st, name)) if i >= 0]


def covered_share(st: Stages, name: str) -> float | None:
    """The share of the host time of the spans named ``name`` in the window
    that their direct children cover."""
    idx = [i for i in windowed(st) if st.program_spans[i].name == name]
    if not idx:
        return None
    children = defaultdict(list)
    for p in st.program_spans:
        children[p.parent].append((p.start_ns, p.end_ns))
    total = covered = 0
    for i in idx:
        p = st.program_spans[i]
        total += p.end_ns - p.start_ns
        clipped = [(max(a, p.start_ns), min(b, p.end_ns)) for a, b in children[i]]
        covered += core.union_ns([(a, b) for a, b in clipped if b > a])
    return covered / total if total else None


def idle_gaps(st: Stages, top: int = 10) -> list:
    """The window's ``top`` largest idle gaps of the device, as
    ``core.breakdown`` finds them, each labelled with the innermost span
    open at its start among the harness's and the program's together."""
    merged: list = []
    for s, e in sorted((s, s + d) for _, s, d in st.device_ops):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    if not merged or not st.spans:
        return []
    w0 = min(s for _, s, _ in st.spans + st.device_ops)
    w1 = max(s + d for _, s, d in st.spans + st.device_ops)
    edges = [(w0, merged[0][0])] + [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    edges.append((merged[-1][1], w1))
    gaps = sorted(((g0, g1) for g0, g1 in edges if g1 > g0), key=lambda g: g[0] - g[1])[:top]
    spans = sorted(st.spans + [(p.name, p.start_ns, p.end_ns - p.start_ns)
                               for p in st.program_spans], key=lambda x: x[1])
    labelled = []
    for g0, g1 in gaps:
        label = "none"
        for name, s, d in spans:
            if s > g0:
                break
            if g0 < s + d:
                label = name  # the innermost: the latest-starting open span
        labelled.append([label, (g1 - g0) * 1e-9])
    return labelled


def stage_table(st: Stages) -> dict:
    """Where the window's time went by the program's spans (printed on
    stderr, not a metric): per span name, host ms per frame in its spans,
    and device ms and operations per frame of what was launched with it
    innermost; the share of device time assigned to some span; the share of
    ``frame``, ``session.render``, ``post`` and ``trace`` host time that
    their children cover; the largest idle gaps by stage; spans dropped."""
    if st.frames <= 0:
        return {}
    rows: dict[str, list] = {}
    for i in windowed(st):
        p = st.program_spans[i]
        rows.setdefault(p.name, [0.0, 0.0, 0])[0] += (p.end_ns - p.start_ns) * 1e-6
    assigned = 0
    for (_, _, d), i in zip(st.device_ops, st.op_spans()):
        if i >= 0:
            row = rows.setdefault(st.program_spans[i].name, [0.0, 0.0, 0])
            row[1] += d * 1e-6
            row[2] += 1
            assigned += d
    total = sum(d for _, _, d in st.device_ops)
    host = [d for name, _, d in st.spans if name.startswith("enqueue")]
    return {"frames": st.frames,
            "per_frame": {k: [v[0] / st.frames, v[1] / st.frames, v[2] / st.frames]
                          for k, v in sorted(rows.items())},
            "enqueue_ms": sum(host) * 1e-6 / st.frames,
            "device_assigned_share": assigned / total if total else None,
            "children_cover": {k: covered_share(st, k)
                               for k in ("frame", "session.render", "post", "trace")},
            "idle_gaps": idle_gaps(st), "dropped": st.dropped}
