"""The ``still_plain`` loop: one card, a static camera, the denoiser off:
``render_frame`` on tables hoisted in set-up, as the program's CLI renders
``<scene> <rpp> --no-denoiser`` on one device.

Set-up builds the configuration's scene (``scene.kind`` "endcapped":
``scenes_endcaps.py``, endcaps and per-curve weights on every curve; any
other kind as ``core.scene_xml`` builds it), the camera's tables
(``build_cand_tables``, ``seg_max_count``, ``narrow_cand_tables``) and the
first state, and warms up; no checkpoint is read.  The frames are chained
by ``core.StillLoop``: the host waits on frame i-1's completion event
before it enqueues frame i+1.  ``frame_ms`` and ``setup_s`` are ``core.run``'s
for the ``still`` kind.

The check: the start frame and a sample of the window's frames drawn from
the seed (``core.Sample``), each on a band of rows drawn from the seed,
display image and next state, against ``reference/plain_frame.py``'s
``blurred_band`` (``loops/still_bands.py``'s comparison).  A denoiser-off
frame does not read its history, so the reference follows no state of the
program.

A traced run profiles the window as ``core.run`` does, then, after the
window and outside all timing, makes one launch of the trace kernel's
counting instantiation on the hoisted tables (distance-ordered tables
only; ``stages.walk_stats``), and after the check rebuilds the scene and
tables once with the program's span recorder on, for the attributes of its
``scene.build_device`` and ``scene.cand_tables`` spans.  Both go to the
readers in the run's ``Trace`` (``PlainTrace``); ``stages.py``'s second
window, which drives the built-in loops only, does not run.
"""

import dataclasses
import json
import random
import sys
import time

from perfbench import core, scenes_endcaps, stages


def scene_xml(config: dict, seed: int) -> str:
    """The configuration's scene: geometry, blur and weights from its own
    seed, colours from the run's ``seed``."""
    sc = config["scene"]
    if sc["kind"] == "endcapped":
        return scenes_endcaps.endcapped_scene_xml(sc["seed"], config["width"],
                                                  config["height"], seed % (1 << 63))
    return core.scene_xml(config, seed)


# Loaded from its file (core.load_file), so not in sys.modules: without
# ``from __future__ import annotations``, dataclass reads real annotations.
@dataclasses.dataclass
class PlainTrace(core.Trace):
    """``core.Trace`` and what this loop counts besides: the counting
    launch's totals (``trace_cuda.STAT_NAMES``; None without one) and the
    attributes of the program's set-up spans, by span name (empty where the
    program records none)."""

    walk_stats: dict | None = None
    program: dict = dataclasses.field(default_factory=dict)


def program_attrs(xml: str, cfg, camera, dev) -> dict:
    """The attributes of the program's spans, by name, as the scene and the
    camera's tables are built once more with its recorder on; {} where the
    program has no recorder."""
    timing = stages.recorder()
    if timing is None:
        return {}
    import raytracingdiffusioncurves_torch as rt

    timing.drain()
    timing.enable()
    try:
        dscene = rt.build_device_scene(rt.load_scene_from_string(xml), device=dev)
        rt.build_cand_tables(dscene, camera, cfg)
    finally:
        timing.disable()
    return {s.name: dict(s.attrs) for s in timing.drain() if s.attrs}


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, dev_name: str = "cuda",
        t_start: float | None = None, mode: str = "program") -> dict:
    """One run of a ``still_plain`` cell; returns the result line's object,
    as ``core.run``."""
    if t_start is None:
        t_start = time.perf_counter()
    import torch

    import raytracingdiffusioncurves_torch as rt

    dev = torch.device(dev_name)
    setup_log: dict[str, float] = {}
    with core.Span("scene", setup_log):
        xml = scene_xml(cell.config, seed)
        dscene = rt.build_device_scene(rt.load_scene_from_string(xml), device=dev)
    settings = core.render_settings(cell.config, seed)
    cfg = rt.RenderConfig(**settings)
    if cfg.use_denoiser:
        raise ValueError(f"a still_plain cell renders with the denoiser off ({cell.name})")
    loop = core.StillLoop(rt, cell, dscene, cfg, None, dev, setup_log)
    with core.Span("warmup", setup_log):
        loop.warmup()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    rng = random.Random(seed)
    sample = core.Sample(dict(cell.workload["check"]["frames"]), rng)
    prof = None
    trace_frames = 0
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA if dev.type == "cuda"
                                   else ProfilerActivity.CPU])
        prof.start()
        loop.prime()
        loop.rec = spans = []
        trace_frames = int(cell.workload["trace_frames"])
    n, wall, _, traced = loop.window(seconds, sample, prof, trace_frames)
    if prof is not None and traced == 0:
        prof.stop()
        traced, loop.rec = n, None
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    metrics = {"frame_ms": {"value": wall * 1e3 / n, "unit": "ms"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
              "count": 1, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": False, "attempted": n, "failed": 0, "metrics": metrics, "device": device}
    if dev.type == "cuda":
        device["power_limit"] = core.power_limit()

    tr = None
    if prof is not None:
        ops, spans, window_s = core.collect(prof, spans)
        tr = PlainTrace(cell, traced, window_s, ops, spans, setup_log, settings, xml, dev)
        del prof
        if dev.type == "cuda":
            device["busy_s"] = tr.busy_s
            device["window_s"] = window_s
            tr.walk_stats = stages.walk_stats(loop, dscene, cfg, loop.state.frame - 1)

    # the checked bands as host arrays: (kind, frame, first row, image, state)
    band = int(cell.workload["check"]["band_rows"])
    items = []
    for it in ([loop.first] if cell.workload["check"].get("start") else []) + sample.items():
        r0 = rng.randrange(0, dscene.height - band + 1)
        items.append((it.kind, it.index, r0, it.image[r0: r0 + band].float().cpu().numpy(),
                      it.state[r0: r0 + band].float().cpu().numpy()))
    camera, loop_host = loop.camera, loop.host
    loop.release()
    del dscene, loop, sample
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    bands = core.load_file(cell.root / "loops" / "still_bands.py")
    rows = bands.compare(cell, xml, settings, items, dev, mode)
    phases = dict(setup_log, setup=setup_s, window=wall, check=time.perf_counter() - t_check,
                  enqueue_ms_per_frame=sum(loop_host.values()) * 1e3 / n)
    limits = cell.workload["check"]["limits"]
    for r in rows:
        print("checked " + json.dumps(r), file=sys.stderr)
    bad = [r for r in rows if not all(r[k] <= limits[k] for k in core.NUMBERS)]
    out["correct"] = not bad
    out["failed"] = len(bad)

    if tr is not None:
        t_read = time.perf_counter()
        tr.program = program_attrs(xml, cfg, camera, dev)
        print("program_attrs " + json.dumps(tr.program), file=sys.stderr)
        stages._last = (tr, None)  # stages.py's window drives the built-in loops only
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
