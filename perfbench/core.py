"""The benchmark's harness: one cell, one run.

A cell (``workloads/<name>.json``) names a configuration
(``configs/<name>.json``: the scene, the render settings, the checkpoint)
and a traffic mix (``traffic/<name>.json``: a still camera, or one user's
zoom and pan gestures cut into a cycle of frames), and holds the comparison's sample sizes and limits.  The
harness reads them by name, builds the inputs from ``--seed``, drives the
program (``raytracingdiffusioncurves_torch``) through set-up, warm-up and
the measured window, checks a sample of the window's frames against the
plain reference (``reference/``), and, in a traced run, hands the profiler's
events to every per-layer reader in ``metrics/``.

Two loops are built in, one per traffic kind:

* ``still``: ``render_frame`` on hoisted tables, chained as a
  double-buffered viewer chains them: the host waits on frame i-1's
  completion event before it enqueues frame i+1.
* ``session``: an ``InteractiveSession`` closed loop, one user: each frame
  applies its scripted event, enqueues the session's render, and waits for
  the card.

Any other kind is a file, ``loops/<kind>.py``, whose ``run`` takes the
place of ``run`` here (``load_loop``); a loop that spans several cards
spawns one rank per card through ``run_ranks``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import random
import subprocess
import sys
import time

import numpy as np

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# Modules that must never load in a run, compared by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracingdiffusioncurves_tpu")


def read_json(root: pathlib.Path, kind: str, name: str) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    root: pathlib.Path = BENCH

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def weights(self) -> pathlib.Path:
        return self.root / "configs" / self.config["denoiser"]


def load_cell(name: str, root: pathlib.Path = BENCH) -> Cell:
    """The cell ``name``: its workload file and the config and traffic files
    it names, under ``root`` (the benchmark's folder; the tests pass a
    folder of tiny cells)."""
    wl = read_json(root, "workloads", name)
    return Cell(name, wl, read_json(root, "configs", wl["config"]),
                read_json(root, "traffic", wl["traffic"]), root)


def process_age() -> float:
    """Seconds since this process started (Linux; 0 where unknown)."""
    try:
        start_ticks = int(pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def scene_xml(config: dict, seed: int) -> str:
    """The configuration's scene: geometry from its own seed, colours from
    the run's ``seed``."""
    from perfbench import scenes

    sc = config["scene"]
    colour_seed = seed % (1 << 63)
    if sc["kind"] == "seeded":
        return scenes.seeded_scene_xml(sc["seed"], config["width"], config["height"], colour_seed)
    return scenes.dense_scene_xml(sc["seed"], config["width"], config["height"], sc["kind"],
                                  colour_seed)


def render_settings(config: dict, seed: int) -> dict:
    """RenderConfig fields of the configuration; ``seed`` keys the rays'
    jitter."""
    return dict(config["render"], rays_per_pixel=config["rays_per_pixel"], seed=seed)


def nested_params(path: pathlib.Path) -> dict:
    """The checkpoint as the program's loader returns it: {"params": {layer:
    {"kernel", "bias"}}}."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            layer, leaf = key.split("/")
            tree.setdefault(layer, {})[leaf] = z[key]
    return {"params": tree}


def frames_of(traffic: dict) -> list[tuple]:
    """The session traffic's cycle of frames, each the tuple of events the
    viewer applies before it (empty at rest).

    The traffic states gestures in time, not in frames: ``rest`` for some
    seconds, ``zoom`` by a number of wheel ticks (> 0 in) at a rate in
    ticks per second, ``pan`` for some seconds at a speed in pixels per
    second along a direction.  A pan is the pointer's moves at
    ``pointer_hz``, each a drag of speed / pointer_hz pixels.  Frames last
    ``frame_ms``; a frame takes every event that falls in its span, in
    order, as the HTTP viewer applies all events queued since its last
    frame (``viewer_http._apply_events``)."""
    frame_s = float(traffic["frame_ms"]) * 1e-3
    hz = float(traffic["pointer_hz"])
    t, timed = 0.0, []
    for g in traffic["gestures"]:
        if g[0] == "rest":
            t += float(g[1])
        elif g[0] == "zoom":
            ticks, rate = int(g[1]), float(g[2])
            step = math.copysign(1.0, ticks)
            timed += [(t + (i + 0.5) / rate, ("scroll", step)) for i in range(abs(ticks))]
            t += abs(ticks) / rate
        elif g[0] == "pan":
            secs, speed, ux, uy = (float(x) for x in g[1:5])
            d = speed / hz / math.hypot(ux, uy)
            timed += [(t + (i + 0.5) / hz, ("drag", d * ux, d * uy))
                      for i in range(round(secs * hz))]
            t += secs
        else:
            raise ValueError(f"unknown gesture {g!r}")
    frames: list[list] = [[] for _ in range(max(1, round(t / frame_s)))]
    for when, ev in timed:
        frames[min(len(frames) - 1, int(when / frame_s))].append(ev)
    return [tuple(f) for f in frames]


def frame_kinds(frames: list[tuple]) -> list[str]:
    """Per frame of the cycle (run back to back): ``moving`` (events before
    it), ``rest_build`` (the first frame on a camera: it builds the
    camera's own tables), ``rest``."""
    kinds = []
    for i, events in enumerate(frames):
        if events:
            kinds.append("moving")
        else:
            kinds.append("rest_build" if frames[i - 1] else "rest")
    return kinds


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------


class Span:
    """A host span.  ``log`` sums its seconds by name; ``rec`` (a traced
    window's list) takes (name, start, duration) in ns of the Unix clock,
    the clock of the profiler's device events."""

    def __init__(self, name: str, log: dict | None = None, rec: list | None = None):
        self.name, self.log, self.rec = name, log, rec

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.log is not None:
            self.log[self.name] = self.log.get(self.name, 0.0) + dt
        if self.rec is not None:
            self.rec.append((self.name, self.t0_ns, int(dt * 1e9)))
        return False


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Fence:
    """A completion event on the card; nothing on the CPU (every op there
    has completed when it returns)."""

    def __init__(self, dev):
        import torch

        self.event = None
        if dev.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()


@dataclasses.dataclass
class Checked:
    """A frame kept for the comparison: what it started from and what it
    produced (the program's own tensors, held, never copied)."""

    index: int  # the frame counter it rendered with
    kind: str
    events: tuple  # applied before it, in order
    zoom_before: float
    camera: object
    history: object  # (H, W, 4) state it started from
    image: object  # (H, W, 4) display image
    state: object  # (H, W, 4) next state


class Sample:
    """A sample drawn from the seed of the frames that the window completes:
    ``quota[kind]`` frames of each kind named, each frame of the kind
    equally likely; the kind ``any`` draws from every frame.  A reservoir,
    because the window's length in frames is known only once it closes."""

    def __init__(self, quota: dict[str, int], rng: random.Random):
        self.quota, self.rng = quota, rng
        self.seen = dict.fromkeys(quota, 0)
        self.kept: dict[str, list] = {k: [] for k in quota}

    def offer(self, kind: str, item) -> None:
        for k in (kind, "any"):
            if k not in self.quota:
                continue
            self.seen[k] += 1
            kept = self.kept[k]
            if len(kept) < self.quota[k]:
                kept.append(item)
            else:
                j = self.rng.randrange(self.seen[k])
                if j < self.quota[k]:
                    kept[j] = item

    def items(self) -> list:
        return [x for k in self.quota for x in self.kept[k]]


# ---------------------------------------------------------------------------
# the two loops
# ---------------------------------------------------------------------------


class StillLoop:
    """render_frame on a static camera, tables hoisted, at most two frames
    in flight."""

    def __init__(self, rt, cell: Cell, dscene, cfg, net, dev, setup_log):
        self.dscene, self.cfg, self.net, self.dev = dscene, cfg, net, dev
        cam = cell.traffic["camera"]
        self.camera = rt.Camera(float(cam["zoom"]), float(cam["offset_x"]), float(cam["offset_y"]))
        with Span("tables", setup_log):
            tables = rt.build_cand_tables(dscene, self.camera, cfg)
            gl = rt.seg_max_count(dscene, tables)
            if gl is not None:
                tables = rt.narrow_cand_tables(tables, gl)
            self.tables, self.gather_len = tables, gl
        self.state = rt.init_frame_state(dscene.width, dscene.height, device=dev)
        self.warmup_frames = int(cell.traffic["warmup_frames"])
        self.first = None
        self.rec = None
        self.host: dict[str, float] = {}

    def _frame(self):
        from raytracingdiffusioncurves_torch.models import renderer

        st = self.state
        image, nxt = renderer.render_frame(
            self.dscene, self.camera, st, self.cfg, denoiser=self.net,
            cand_tables=self.tables, gather_len=self.gather_len)
        self.state = nxt
        return st, image, nxt

    def prime(self):
        """One frame outside the window, waited for: the profiler's start
        lands there."""
        self._frame()
        _sync(self.dev)

    def warmup(self):
        for i in range(self.warmup_frames):
            st, image, nxt = self._frame()
            if i == 0:
                self.first = Checked(st.frame, "start", (), self.camera.zoom_factor, self.camera,
                                     st.prev_image, image, nxt.prev_image)
        _sync(self.dev)

    def window(self, seconds: float, sample: Sample, profiler=None, trace_frames=0):
        """Returns (frames, wall seconds, per-frame seconds or None, traced frames)."""
        self.host = {}
        n, pending = 0, None
        traced = 0
        t0 = time.perf_counter()
        while True:
            with Span("enqueue", self.host, self.rec):
                st, image, nxt = self._frame()
            fence = _Fence(self.dev)
            if pending is not None:
                with Span("wait", rec=self.rec):
                    pending.wait()
            pending = fence
            sample.offer("frame", Checked(st.frame, "frame", (), self.camera.zoom_factor,
                                          self.camera, st.prev_image, image, nxt.prev_image))
            n += 1
            if profiler is not None and n == trace_frames:
                with Span("wait", rec=self.rec):
                    pending.wait()
                profiler.stop()
                traced, profiler, self.rec = n, None, None
            if time.perf_counter() - t0 >= seconds:
                break
        pending.wait()
        return n, time.perf_counter() - t0, None, traced

    def release(self):
        self.tables = self.state = None


class SessionLoop:
    """An InteractiveSession driven by the traffic's event cycle, each frame
    waited for."""

    def __init__(self, rt, cell: Cell, dscene, cfg, net, dev, setup_log):
        self.dev = dev
        with Span("tables", setup_log):
            self.session = rt.InteractiveSession(dscene, cfg, denoiser=net)
        self.frames = frames_of(cell.traffic)
        self.kinds = frame_kinds(self.frames)
        self.warmup_cycles = int(cell.traffic["warmup_cycles"])
        self.first = None
        self.rec = None
        self.host: dict[str, float] = {}

    def _apply(self, events):
        s = self.session
        for ev in events:
            if ev[0] == "scroll":
                s.scroll(float(ev[1]))
            else:
                s.drag(float(ev[1]), float(ev[2]))

    def _frame(self, pos: int):
        s = self.session
        events = self.frames[pos]
        zoom_before = float(s.camera.zoom_factor)
        with Span("event", rec=self.rec):
            self._apply(events)
        st = s.state
        with Span(f"enqueue.{self.kinds[pos]}", self.host, self.rec):
            image = s.render(block=False)
        with Span("wait", rec=self.rec):
            _sync(self.dev)
        return Checked(st.frame, self.kinds[pos], events, zoom_before, s.camera, st.prev_image,
                       image, s.state.prev_image)

    def prime(self):
        """One resting frame outside the window, waited for: the profiler's
        start lands there."""
        self.session.render(block=False)
        _sync(self.dev)

    def warmup(self):
        """The first frame (it builds the world grid), then the traffic's
        ``warmup_cycles`` whole cycles, each resting frame after another
        left out (the same work as the one before it): every shape and path
        the window takes."""
        s = self.session
        st = s.state
        image = s.render(block=False)
        _sync(self.dev)
        self.first = Checked(st.frame, "start", (), float(s.camera.zoom_factor), s.camera,
                             st.prev_image, image, s.state.prev_image)
        for _ in range(self.warmup_cycles):
            for pos, kind in enumerate(self.kinds):
                if not (kind == "rest" and self.kinds[pos - 1] == "rest"):
                    self._frame(pos)
        _sync(self.dev)

    def window(self, seconds: float, sample: Sample, profiler=None, trace_frames=0):
        self.host = {}
        times = []
        traced = 0
        builds = self.session.grid_builds
        t0 = time.perf_counter()
        n = 0
        while True:
            pos = n % len(self.frames)
            f0 = time.perf_counter()
            item = self._frame(pos)
            times.append(time.perf_counter() - f0)
            sample.offer(item.kind, item)
            n += 1
            if profiler is not None and n == trace_frames:
                profiler.stop()
                traced, profiler, self.rec = n, None, None
            # the window closes at the end of a whole cycle
            if pos == len(self.frames) - 1 and time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        cycles = n // len(self.frames)
        print("session_cycle " + json.dumps({
            "frames": len(self.frames), "cycles": cycles,
            "kinds": {k: self.kinds.count(k) for k in ("moving", "rest_build", "rest")},
            "events": sum(len(f) for f in self.frames),
            "grid_builds_per_cycle": (self.session.grid_builds - builds) / cycles}),
            file=sys.stderr)
        return n, wall, times, traced

    def release(self):
        self.session = None


LOOPS = {"still": StillLoop, "session": SessionLoop}


def load_loop(kind: str, root: pathlib.Path = BENCH):
    """The loop of traffic ``kind``: a built-in class of ``LOOPS``, or else
    the module ``root``/loops/<kind>.py, which defines ``run`` with
    ``run``'s arguments."""
    if kind in LOOPS:
        return LOOPS[kind]
    path = root / "loops" / f"{kind}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no loop for traffic kind {kind!r} ({path})")
    return load_file(path)


def load_file(path) -> object:
    """The module of the Python file ``path``, loaded under a name of its
    own (the benchmark's readers and loops are files, not a package)."""
    path = pathlib.Path(path)
    name = f"perfbench_{path.parent.name}_{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rank_entry(rank: int, world_size: int, loop_path: str, job: dict):
    """A spawned rank of ``run_ranks``: the loop file's ``rank_main``."""
    return load_file(loop_path).rank_main(rank, world_size, job)


def run_ranks(loop_path, world_size: int, job: dict, dev_name: str, timeout: float) -> list:
    """``rank_main(rank, world_size, job)`` of the loop file ``loop_path``
    in ``world_size`` spawned ranks of one process group, through the
    program's ``parallel.sharded.spawn_ranks``, as its CLI's ``--devices``
    spawns them: NCCL with one card per rank, gloo on the CPU (and where
    ranks would share a card).  ``job["dev"]`` tells each rank its device:
    ``cpu``, or ``cuda`` (rank i on card i modulo the cards).  Returns the
    ranks' values; raises when a rank fails or ``timeout`` seconds pass
    (every rank has ended then)."""
    import torch

    from raytracingdiffusioncurves_torch.parallel import sharded

    backend = "gloo"
    if dev_name != "cpu" and torch.cuda.device_count() >= world_size:
        backend = "nccl"
    return sharded.spawn_ranks(rank_entry, world_size, (str(loop_path), dict(job, dev=dev_name)),
                               backend=backend, timeout=timeout)


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------


def _stats(a, b) -> tuple[float, float]:
    d = (a.float() - b.float()).abs()
    if not bool(d.isfinite().all()):
        return math.inf, math.inf
    return float(d.max()), float(d.mean())


NUMBERS = ("display_max", "display_mean", "state_max", "state_mean")


def compare(cell: Cell, xml: str, settings: dict, items: list, rng: random.Random, dev,
            mode: str = "program") -> list[dict]:
    """Each kept frame's band of rows against the reference: one dict of the
    compared numbers per frame.  ``mode`` "control" compares the reference
    computed a precision lower (the control) in the program's place."""
    import torch

    from perfbench.reference import frame as ref
    from perfbench.reference.config import Camera, RenderConfig

    band = int(cell.workload["check"]["band_rows"])
    cfg = RenderConfig(**settings)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        scene = ref.load_scene(xml, cfg, dev)
        weights = ref.load_weights(str(cell.weights), dev)
        h, w = scene.height, scene.width
        rows = []
        for it in items:
            r0 = rng.randrange(0, h - band + 1)
            cam = Camera(float(it.camera.zoom_factor), float(it.camera.offset_x),
                         float(it.camera.offset_y))
            history = it.history.to(dev, torch.float32)
            flow_field = None
            if it.events:
                flow_field = ref.frame_flow(h, w, it.events, it.zoom_before, dev)
            args = (scene, cam, cfg, weights, it.index, history, flow_field, r0, r0 + band)
            with torch.no_grad():
                shown, state = ref.reference_band(*args)
                if mode == "control":
                    image, nxt = ref.reference_band(*args, prec=ref.CONTROL)
                else:
                    image, nxt = it.image[r0: r0 + band], it.state[r0: r0 + band]
            dm, da = _stats(image, shown)
            sm, sa = _stats(nxt, state)
            rows.append({"frame": it.index, "kind": it.kind, "row": r0, "display_max": dm,
                         "display_mean": da, "state_max": sm, "state_mean": sa})
        return rows
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev_tf32


# ---------------------------------------------------------------------------
# traced runs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trace:
    """What a per-layer reader reads: the traced window's device operations
    and host spans, on one clock (ns), and the cell's inputs."""

    cell: Cell
    frames: int
    window_s: float
    device_ops: list  # (name, start_ns, duration_ns)
    spans: list  # (name, start_ns, duration_ns)
    setup_log: dict
    settings: dict
    xml: str
    dev: object
    _counts: dict | None = None
    # A cell across cards: every rank's traced window (``RankTrace``), the
    # fields above being the slowest rank's; None on one card.
    ranks: list | None = None

    @property
    def kind(self) -> str:
        return self.cell.kind

    @property
    def busy_s(self) -> float:
        return union_ns([(s, s + d) for _, s, d in self.device_ops]) * 1e-9

    def counts(self) -> dict:
        """The roofline counts of this cell's frame (perfbench/roofline.py),
        computed on first use."""
        if self._counts is None:
            from perfbench import roofline

            self._counts = roofline.frame_counts(self.cell.config, self.xml, self.settings,
                                                 self.cell.traffic["camera"], self.dev)
        return self._counts


@dataclasses.dataclass
class RankTrace:
    """One rank's traced window: its device operations and harness spans
    (as ``Trace`` holds them), its band of rows, and what its collectives
    moved in its last frame (the program's ``sharded.EXCHANGE_LOG``)."""

    rank: int
    frames: int
    window_s: float
    device_ops: list
    spans: list
    row0: int
    rows: int
    exchange: list

    @property
    def busy_s(self) -> float:
        return union_ns([(s, s + d) for _, s, d in self.device_ops]) * 1e-9


def union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def collect(prof, host: list) -> tuple[list, list, float]:
    """(device operations, harness spans, traced window in s) from a
    stopped profiler and the window's spans."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    first = min((s for _, s, _ in host), default=0)
    # the primed frame's operations came before the first span
    ops = [(e.name(), e.start_ns(), e.duration_ns()) for e in events
           if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
           and e.start_ns() >= first]
    # the traced window: from the first span or operation to the last end
    starts = [s for _, s, _ in host + ops]
    ends = [s + d for _, s, d in host + ops]
    window_s = (max(ends) - min(starts)) * 1e-9 if host else 0.0
    return ops, host, window_s


# Kernel names in the breakdown are cut to this many characters (the
# demangled templates of PyTorch's kernels run to hundreds).
NAME_CHARS = 120


def breakdown(tr: Trace) -> dict:
    by_name: dict[str, int] = {}
    for name, _, d in tr.device_ops:
        by_name[name] = by_name.get(name, 0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # idle gaps of the device inside the window, labelled by the host span
    # open when each began
    ivs = sorted((s, s + d) for _, s, d in tr.device_ops)
    merged = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    spans = sorted(tr.spans, key=lambda x: x[1])
    w0 = min(s for _, s, _ in spans + tr.device_ops) if spans else 0
    w1 = max(s + d for _, s, d in spans + tr.device_ops) if spans else 0
    edges = [(w0, merged[0][0])] if merged else []
    edges += [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    if merged:
        edges.append((merged[-1][1], w1))
    gaps = []
    for g0, g1 in edges:
        if g1 <= g0:
            continue
        label = "none"
        for name, s, d in spans:
            if s <= g0 < s + d:
                label = name  # the innermost: the latest-starting open span
        gaps.append((label, (g1 - g0) * 1e-9))
    gaps.sort(key=lambda x: -x[1])
    return {"device_ops": [[n[:NAME_CHARS], d * 1e-9] for n, d in top],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}


def load_readers(root: pathlib.Path = BENCH) -> dict:
    """Every per-layer reader in ``root``/metrics/, by metric name (its file
    name)."""
    readers = {}
    for path in sorted((root / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        readers[path.stem] = load_file(path)
    return readers


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev_name: str = "cuda",
        t_start: float | None = None, mode: str = "program") -> dict:
    """One run of ``cell``; returns the result line's object.  ``mode``
    "control" puts the reference, computed a precision lower, in the
    program's place in the comparison (never in a benchmark run)."""
    if t_start is None:
        t_start = time.perf_counter()
    if cell.kind not in LOOPS:
        return load_loop(cell.kind, cell.root).run(cell, seed, seconds, trace, dev_name,
                                                   t_start, mode)
    import torch

    import raytracingdiffusioncurves_torch as rt

    dev = torch.device(dev_name)
    setup_log: dict[str, float] = {}
    with Span("scene", setup_log):
        xml = scene_xml(cell.config, seed)
        dscene = rt.build_device_scene(rt.load_scene_from_string(xml), device=dev)
    with Span("weights", setup_log):
        net = rt.net_for_params(nested_params(cell.weights), device=dev)
    settings = render_settings(cell.config, seed)
    cfg = rt.RenderConfig(**settings)
    loop = LOOPS[cell.kind](rt, cell, dscene, cfg, net, dev, setup_log)
    with Span("warmup", setup_log):
        loop.warmup()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    rng = random.Random(seed)
    quota = dict(cell.workload["check"]["frames"])
    sample = Sample(quota, rng)
    prof = None
    trace_frames = 0
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # device activity only: the host spans are the harness's own
        prof = profile(activities=[ProfilerActivity.CUDA if dev.type == "cuda"
                                   else ProfilerActivity.CPU])
        prof.start()
        loop.prime()
        loop.rec = spans = []
        trace_frames = int(cell.workload["trace_frames"])
    n, wall, times, traced = loop.window(seconds, sample, prof, trace_frames)
    if prof is not None and traced == 0:
        prof.stop()
        traced, loop.rec = n, None
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    metrics = {}
    if cell.kind == "still":
        metrics["frame_ms"] = {"value": wall * 1e3 / n, "unit": "ms"}
    else:
        metrics["session_frame_ms"] = {"value": wall * 1e3 / n, "unit": "ms"}
        metrics["session_frame_p95_ms"] = {"value": percentile(times, 95) * 1e3, "unit": "ms"}
    metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
              "count": 1, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": False, "attempted": n, "failed": 0, "metrics": metrics,
           "device": device}
    if dev.type == "cuda":
        device["power_limit"] = power_limit()

    tr = None
    if prof is not None:
        ops, spans, window_s = collect(prof, spans)
        if ops and spans:
            # the two clocks: device work starts after the first span and
            # ends before the last
            print("trace_clock_us " + json.dumps({
                "first_op_after_first_span": (min(s for _, s, _ in ops)
                                              - min(s for _, s, _ in spans)) / 1e3,
                "last_op_before_last_span_end": (max(s + d for _, s, d in spans)
                                                 - max(s + d for _, s, d in ops)) / 1e3}),
                  file=sys.stderr)
        tr = Trace(cell, traced, window_s, ops, spans, setup_log, settings, xml, dev)
        del prof
        if dev.type == "cuda":
            device["busy_s"] = tr.busy_s
            device["window_s"] = window_s

    items = ([loop.first] if cell.workload["check"].get("start") else []) + sample.items()
    loop_host = loop.host
    loop.release()
    del net, dscene, loop
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    rows = compare(cell, xml, settings, items, rng, dev, mode)
    phases = dict(setup_log, setup=setup_s, window=wall, check=time.perf_counter() - t_check,
                  enqueue_ms_per_frame=sum(loop_host.values()) * 1e3 / n)
    limits = cell.workload["check"]["limits"]
    for r in rows:
        print("checked " + json.dumps(r), file=sys.stderr)
    bad = [r for r in rows if not all(r[k] <= limits[k] for k in NUMBERS)]
    checks = {k: {"value": max(r[k] for r in rows), "limit": limits[k]} for k in NUMBERS}
    out["correct"] = not bad
    out["failed"] = len(bad)

    if tr is not None:
        t_read = time.perf_counter()
        per_layer = {}
        for name, mod in load_readers(cell.root).items():
            got = mod.read(tr)
            if got is not None:
                per_layer[name] = {"value": got, "unit": mod.UNIT}
        out["metrics"] = per_layer
        out["breakdown"] = breakdown(tr)
        phases["readers"] = time.perf_counter() - t_read
    print("phases_s " + json.dumps(phases), file=sys.stderr)
    out["checks"] = checks
    return out


def percentile(values, q: float) -> float:
    """The q-th percentile, nearest rank (a value that was measured)."""
    s = sorted(values)
    k = max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))
    return s[k]


def print_result(out: dict) -> None:
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    chips = int(cell.workload.get("chips", 1))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    # after the window, the check and the readers: nothing of JAX loaded
    found = forbidden_modules()
    if found:
        print("modules that must not load in a run: " + ", ".join(found), file=sys.stderr)
        return 3
    print_result(out)
    return 0
