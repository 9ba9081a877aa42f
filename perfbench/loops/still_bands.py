"""The ``still_bands`` loop: one still frame rendered in row bands across
ranks, one rank per card, as the program's CLI renders with ``--devices``.

The parent process spawns the traffic's ``ranks`` ranks (``core.run_ranks``:
NCCL across cards, gloo on the CPU) and touches no card until they have
ended.  Each rank builds the scene on its device, its band's hoisted tables
(``build_cand_tables_sharded``, ``seg_max_count_sharded``,
``narrow_cand_tables``) and its band of the first state, warms up, and
renders its band with ``render_frame_sharded``, chained as ``StillLoop``
chains frames: the host waits on frame i-1's completion event before it
enqueues frame i+1.  Every rank must render as many frames as the others
(the frame's collectives pair them), so rank 0 sets the window's frame count
from its quickest warm-up frame, enough to fill ``--seconds``, and
broadcasts it once before the barrier that opens the window.

The result merges the ranks: ``frame_ms`` is the slowest rank's window over
its frames; ``setup_s`` runs from the parent's start to the barrier;
``memory_peak_bytes`` is the fullest card's.  The check: the start frame
and frames of the window drawn from the seed, each on a band of rows that
straddles a rank's edge (a wrong halo shows only there); each rank hands
back its rows of those bands, and the parent compares them on its device
with ``reference/plain_frame.py`` once the ranks have ended.
"""

from __future__ import annotations

import json
import math
import random
import sys
import time

import numpy as np

from perfbench import core, layers
from perfbench import ranks as ranks_of

# Seconds the ranks may take beyond the window: spawn, imports, set-up,
# warm-up and the trace's collection (the run's whole limit is 360 s).
RANKS_EXTRA_S = 240.0


def _device(job: dict, rank: int):
    import torch

    if job["dev"] == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _plan(rng: random.Random, n: int, quota: int, start: bool, world: int, rows: int,
          band: int) -> list[tuple[str, int, int]]:
    """The checked frames, each (kind, window frame or -1 for the start
    frame, first row): a band of ``band`` rows across the edge between two
    ranks, the edge and the band's offset drawn from ``rng``."""
    picks = sorted(rng.sample(range(n), min(quota, n)))
    items = ([("start", -1)] if start else []) + [("frame", i) for i in picks]
    plan = []
    for kind, i in items:
        edge = rng.randrange(1, world) * rows
        plan.append((kind, i, edge - rng.randrange(1, band)))
    return plan


def rank_main(rank: int, world: int, job: dict) -> dict:
    """One rank: set-up, warm-up, the window; returns what the parent merges
    (host data only)."""
    import torch
    import torch.distributed as dist

    # set-up by phase, s: from the parent's start to this process's
    # (``parent``), from there to here (``rank_start``: imports, joining
    # the process group), then the harness's spans
    age = core.process_age()
    setup_log = {"parent": time.time() - age - job["t_start_unix"], "rank_start": age}
    if job.get("rank_setup") is not None:
        job["rank_setup"]()
    with core.Span("imports", setup_log):
        import raytracingdiffusioncurves_torch as rt
        from raytracingdiffusioncurves_torch.parallel import sharded

        cell, seed = job["cell"], job["seed"]
        dev = _device(job, rank)
        mesh = sharded.make_mesh(world, device_type=dev.type)
    with core.Span("scene", setup_log):
        xml = core.scene_xml(cell.config, seed)
        dscene = rt.build_device_scene(rt.load_scene_from_string(xml), device=dev)
    cfg = rt.RenderConfig(**core.render_settings(cell.config, seed))
    cam = cell.traffic["camera"]
    camera = rt.Camera(float(cam["zoom"]), float(cam["offset_x"]), float(cam["offset_y"]))
    with core.Span("tables", setup_log):
        tables = sharded.build_cand_tables_sharded(mesh, dscene, camera, cfg)
        gl = sharded.seg_max_count_sharded(mesh, dscene, tables)
        if gl is not None:
            tables = rt.narrow_cand_tables(tables, gl)
    rows = dscene.height // world
    box = {"state": sharded.frame_state_sharded(
        mesh, rt.init_frame_state(dscene.width, dscene.height, device=dev))}

    def frame():
        st = box["state"]
        image, nxt = sharded.render_frame_sharded(mesh, dscene, camera, st, cfg,
                                                  cand_tables=tables, gather_len=gl)
        box["state"] = nxt
        return st, image, nxt

    check = cell.workload["check"]
    kept: list = []  # the checked frames' (counter, image, next state)
    with core.Span("warmup", setup_log):
        # each frame waited for; the quickest after the first times a frame
        times = []
        for i in range(int(cell.traffic["warmup_frames"])):
            t = time.perf_counter()
            st, image, nxt = frame()
            core._sync(dev)
            times.append(time.perf_counter() - t)
            if i == 0 and check.get("start"):
                kept.append((st.frame, image, nxt.prev_image))
        frame_s = min(times[1:] or times)
    # rank 0's frame count, on every rank
    trace_frames = int(cell.workload["trace_frames"]) if job["trace"] else 0
    count = torch.tensor([max(2, trace_frames, math.ceil(job["seconds"] / frame_s))],
                         dtype=torch.int64, device=dev)
    dist.broadcast(count, 0, group=sharded.group(mesh))
    n = int(count.item())
    plan = _plan(random.Random(seed), n, sum(check["frames"].values()), bool(check.get("start")),
                 world, rows, int(check["band_rows"]))
    picks = {i for _, i, _ in plan if i >= 0}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    prof = rec = None
    if job["trace"]:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA if dev.type == "cuda"
                                   else ProfilerActivity.CPU])
        prof.start()
        frame()  # primed, waited for: the profiler's start lands here
        core._sync(dev)
        rec = []
    group = sharded.group(mesh)
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[dev.index])
    else:
        dist.barrier(group=group)
    barrier_at = time.time()
    pending = None
    traced = 0
    host: dict[str, float] = {}
    t0 = time.perf_counter()
    for i in range(n):
        with core.Span("enqueue", host, rec):
            st, image, nxt = frame()
        fence = core._Fence(dev)
        if pending is not None:
            with core.Span("wait", rec=rec):
                pending.wait()
        pending = fence
        if i in picks:
            kept.append((st.frame, image, nxt.prev_image))
        if prof is not None and i + 1 == trace_frames:
            with core.Span("wait", rec=rec):
                pending.wait()
            prof.stop()
            traced, spans, rec = i + 1, rec, None
    pending.wait()
    wall = time.perf_counter() - t0
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    exchange = list(sharded.EXCHANGE_LOG)

    # this rank's rows of each checked band, as host arrays
    r_lo, r_hi = rank * rows, rank * rows + rows
    band = int(check["band_rows"])
    parts = []
    for k, ((kind, _, r0), (index, image, state)) in enumerate(zip(plan, kept)):
        lo, hi = max(r0, r_lo), min(r0 + band, r_hi)
        if lo < hi:
            parts.append((k, kind, index, r0, lo,
                          image[lo - r_lo: hi - r_lo].float().cpu().numpy(),
                          state[lo - r_lo: hi - r_lo].float().cpu().numpy()))
    out = {"rank": rank, "frames": n, "wall": wall, "barrier_at": barrier_at,
           "warm_frame_s": frame_s, "enqueue_ms": host["enqueue"] * 1e3 / n,
           "setup_log": setup_log, "memory_peak": int(memory_peak),
           "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
           "device": f"{dev.type}:{rank if dev.index is None else dev.index}",
           "parts": parts, "row0": r_lo, "rows": rows, "exchange": exchange, "trace": None}
    if prof is not None:
        ops, spans, window_s = core.collect(prof, spans)
        out["trace"] = (traced, window_s, ops, spans)
    out["forbidden"] = core.forbidden_modules()
    return out


def compare(cell: core.Cell, xml: str, settings: dict, items: list, dev,
            mode: str = "program") -> list[dict]:
    """Each checked band, (kind, frame, first row, display rows, state
    rows) as host arrays, against ``reference/plain_frame.py``: one dict of
    the compared numbers per band.  ``mode`` "control" compares the
    reference computed a precision lower in the program's place."""
    import torch

    from perfbench.reference import frame as ref
    from perfbench.reference.config import Camera, RenderConfig
    from perfbench.reference.plain_frame import blurred_band

    cfg = RenderConfig(**settings)
    cam = cell.traffic["camera"]
    camera = Camera(float(cam["zoom"]), float(cam["offset_x"]), float(cam["offset_y"]))
    scene = ref.load_scene(xml, cfg, dev)
    rows = []
    for kind, index, r0, image, state in items:
        r1 = r0 + image.shape[0]
        with torch.no_grad():
            shown, nxt_ref = blurred_band(scene, camera, cfg, index, r0, r1)
            if mode == "control":
                image, state = blurred_band(scene, camera, cfg, index, r0, r1, ref.CONTROL)
            else:
                image, state = torch.from_numpy(image).to(dev), torch.from_numpy(state).to(dev)
        dm, da = core._stats(image, shown)
        sm, sa = core._stats(state, nxt_ref)
        rows.append({"frame": index, "kind": kind, "row": r0, "display_max": dm,
                     "display_mean": da, "state_max": sm, "state_mean": sa})
    return rows


def _items(ranks: list[dict], band: int) -> list:
    """The checked bands from the ranks' parts, in the plan's order."""
    by_item: dict[int, list] = {}
    for r in ranks:
        for k, kind, index, r0, lo, image, state in r["parts"]:
            by_item.setdefault(k, []).append((lo, kind, index, r0, image, state))
    items = []
    for k in sorted(by_item):
        got = sorted(by_item[k], key=lambda p: p[0])
        _, kind, index, r0, _, _ = got[0]
        image = np.concatenate([p[4] for p in got])
        state = np.concatenate([p[5] for p in got])
        if image.shape[0] != band or got[0][0] != r0:
            raise RuntimeError(f"checked band {k} at row {r0}: the ranks sent rows "
                               f"{[(p[0], p[4].shape[0]) for p in got]}")
        items.append((kind, index, r0, image, state))
    return items


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, dev_name: str = "cuda",
        t_start: float | None = None, mode: str = "program", rank_setup=None,
        timeout: float | None = None) -> dict:
    """One run of a ``still_bands`` cell; returns the result line's object,
    as ``core.run``.  ``rank_setup``: a function (importable, no arguments)
    each rank calls first (the tests break the path with it); ``timeout``:
    the ranks' limit in seconds (default the window plus RANKS_EXTRA_S)."""
    if t_start is None:
        t_start = time.perf_counter()
    t_start_unix = time.time() - (time.perf_counter() - t_start)
    world = int(cell.traffic["ranks"])
    if world != int(cell.workload["chips"]):
        raise ValueError(f"traffic of {world} ranks in a cell of {cell.workload['chips']} chips")
    setup_log: dict[str, float] = {}
    if dev_name != "cpu":
        # the kernels built once, before the ranks load them
        from raytracingdiffusioncurves_torch.ops import _build

        with core.Span("build", setup_log):
            _build.build_all()
    job = {"cell": cell, "seed": seed, "seconds": seconds, "trace": trace,
           "rank_setup": rank_setup, "t_start_unix": t_start_unix}
    ranks = core.run_ranks(__file__, world, job, dev_name,
                           seconds + RANKS_EXTRA_S if timeout is None else timeout)
    found = {r["rank"]: r["forbidden"] for r in ranks if r["forbidden"]}
    if found:
        raise RuntimeError(f"modules that must not load in a run, by rank: {found}")
    n = ranks[0]["frames"]
    if any(r["frames"] != n for r in ranks):
        raise RuntimeError(f"ranks rendered {[r['frames'] for r in ranks]} frames")
    setup_s = max(r["barrier_at"] for r in ranks) - t_start_unix
    wall = max(r["wall"] for r in ranks)
    print("ranks " + json.dumps([{k: r[k] for k in ("rank", "frames", "wall", "warm_frame_s",
                                                     "enqueue_ms", "memory_peak", "setup_log")}
                                 for r in ranks]), file=sys.stderr)

    import torch

    dev = torch.device(dev_name)
    metrics = {"frame_ms": {"value": wall * 1e3 / n, "unit": "ms"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": ranks[0]["kind"],
              "count": len({r["device"] for r in ranks}),
              "memory_peak_bytes": max(r["memory_peak"] for r in ranks)}
    out = {"correct": False, "attempted": n, "failed": 0, "metrics": metrics, "device": device}
    if dev.type == "cuda":
        device["power_limit"] = core.power_limit()

    xml = core.scene_xml(cell.config, seed)
    settings = core.render_settings(cell.config, seed)
    tr = None
    if trace:
        per_rank = [core.RankTrace(r["rank"], *r["trace"], r["row0"], r["rows"], r["exchange"])
                    for r in ranks]
        slow = ranks_of.slowest(per_rank)
        merged_log = {k: max(r["setup_log"].get(k, 0.0) for r in ranks)
                      for k in ranks[0]["setup_log"]}
        tr = core.Trace(cell, slow.frames, slow.window_s, slow.device_ops, slow.spans,
                        merged_log, settings, xml, dev, ranks=per_rank)
        print("rank_traces " + json.dumps([{
            "rank": t.rank, "work_ms": ranks_of.work_ms(t), "busy_ms": t.busy_s * 1e3 / t.frames,
            "trace_ms": ranks_of.per_frame_ms(t, lambda n: layers.layer_of(n) == "trace"),
            "exchange_ms": ranks_of.per_frame_ms(t, ranks_of.is_exchange),
            "window_ms": t.window_s * 1e3 / t.frames} for t in per_rank]), file=sys.stderr)
        if dev.type == "cuda":
            device["busy_s"] = sum(t.busy_s for t in per_rank) / world
            device["window_s"] = sum(t.window_s for t in per_rank) / world

    items = _items(ranks, int(cell.workload["check"]["band_rows"]))
    del ranks
    t_check = time.perf_counter()
    rows = compare(cell, xml, settings, items, dev, mode)
    phases = dict(setup_log, setup=setup_s, window=wall, check=time.perf_counter() - t_check)
    limits = cell.workload["check"]["limits"]
    for r in rows:
        print("checked " + json.dumps(r), file=sys.stderr)
    bad = [r for r in rows if not all(r[k] <= limits[k] for k in core.NUMBERS)]
    out["correct"] = not bad
    out["failed"] = len(bad)

    if tr is not None:
        t_read = time.perf_counter()
        per_layer = {}
        for name, mod in core.load_readers(cell.root).items():
            got = mod.read(tr)
            if got is not None:
                per_layer[name] = {"value": got, "unit": mod.UNIT}
        out["metrics"] = per_layer
        out["breakdown"] = core.breakdown(tr)
        phases["readers"] = time.perf_counter() - t_read
    print("phases_s " + json.dumps(phases), file=sys.stderr)
    out["checks"] = {k: {"value": max(r[k] for r in rows), "limit": limits[k]}
                     for k in core.NUMBERS}
    return out
