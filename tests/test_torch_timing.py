"""The port's span recorder (utils/timing.py) and the spans the program
records, on the CPU.

* Off (the default): ``span`` returns the shared no-op object and nothing is
  recorded; PhaseTimer still times.
* On: each span's parent, thread and attributes; spans past the capacity
  are dropped and counted.
* One ``render_frame`` with the UNet records ``frame`` over ``trace`` and
  ``post``, ``post`` over bilateral, UNet, blend and blur, in that order.
* An ``InteractiveSession`` records the grid build on its first (moving)
  frame, the own-table build with its blocking reads on the first resting
  frame, the grid gather on a later moving frame.
* The CLI's ``--profile`` writes the spans into the Chrome trace.
* The scene's build and the camera's table build carry their counts as
  attributes set inside the block (``set``; nothing while off).
"""

import json
import threading

import pytest

import raytracingdiffusioncurves_torch as rt
from raytracingdiffusioncurves_torch.cli import main
from raytracingdiffusioncurves_torch.utils import timing
from raytracingdiffusioncurves_torch.utils.scenes import (endcapped_scene_xml,
                                                          portal_dense_scene_xml,
                                                          seeded_scene_xml)

from conftest import make_scene_xml, simple_curve


@pytest.fixture()
def recorder():
    """The recorder on, and off and empty again after the test."""
    timing.drain()
    timing.enable()
    try:
        yield timing
    finally:
        timing.disable()
        timing.drain()


def _names(spans, parent):
    return [s.name for s in spans if s.parent == parent]


def test_off_records_nothing():
    timing.drain()
    assert timing.span("post.blur", frame=3) is timing.NOOP
    with timing.span("frame", frame=0) as s:
        with timing.span("trace"):
            pass
    assert s is timing.NOOP
    assert timing.drain() == [] and timing.dropped == 0
    t = timing.PhaseTimer()  # timed with the recorder off too
    with t.phase("frame"):
        pass
    assert t.phases["frame"][0] >= 0.0 and timing.drain() == []


def test_on_records_parents_threads_and_attributes(recorder):
    with timing.span("frame", frame=7):
        with timing.span("trace", frame=7):
            with timing.span("trace.launch", frame=7):
                pass
        with timing.span("post", frame=7):
            pass

    def other():
        with timing.span("session.event.drag", frame=8):
            pass

    worker = threading.Thread(target=other)
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()
    with timing.span("scene.parse"):
        pass
    spans = timing.drain()
    assert [s.name for s in spans] == ["frame", "trace", "trace.launch", "post",
                                       "session.event.drag", "scene.parse"]
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1, -1]
    main_id = threading.get_native_id()
    assert [s.thread == main_id for s in spans] == [True] * 4 + [False, True]
    assert [s.attrs.get("frame") for s in spans] == [7, 7, 7, 7, 8, None]
    for s in spans:
        assert 0 < s.start_ns <= s.end_ns
    assert spans[0].start_ns <= spans[1].start_ns and spans[2].end_ns <= spans[1].end_ns
    assert spans[3].end_ns <= spans[0].end_ns


def test_spans_past_the_capacity_are_dropped_and_counted(recorder, monkeypatch):
    monkeypatch.setattr(timing, "CAPACITY", 3)
    with timing.span("frame"):
        for _ in range(4):
            with timing.span("post"):
                pass
        with timing.span("sync.seg_max_count"):
            pass
    assert timing.dropped == 3
    spans = timing.drain()
    assert [s.name for s in spans] == ["frame", "post", "post"]
    assert [s.parent for s in spans] == [-1, 0, 0]
    assert timing.dropped == 0


def test_phase_timer_times_spans_of_its_own(recorder):
    t = timing.PhaseTimer()
    with t.phase("scene_load"):
        with timing.span("scene.parse"):
            pass
    spans = timing.drain()
    assert [s.name for s in spans] == ["scene.parse"] and spans[0].parent == -1
    (phase,) = t.spans
    assert isinstance(phase, timing.Span) and phase.name == "scene_load"
    assert phase.start_ns <= spans[0].start_ns <= spans[0].end_ns <= phase.end_ns
    assert json.loads(t.report())["scene_load"]["count"] == 1


def test_render_frame_records_its_stages(recorder):
    xml = seeded_scene_xml(0, 24, 24)
    dev = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    net = rt.net_for_params(rt.load_params("weights/denoiser_r3d.msgpack"), device="cpu")
    cfg = rt.RenderConfig(rays_per_pixel=2)
    state = rt.init_frame_state(24, 24, device="cpu")
    timing.drain()
    rt.render_frame(dev, rt.Camera(), state, cfg, denoiser=net)
    spans = timing.drain()
    assert spans[0].name == "frame" and spans[0].parent == -1
    assert _names(spans, 0) == ["trace", "post"]
    trace = next(i for i, s in enumerate(spans) if s.name == "trace")
    post = next(i for i, s in enumerate(spans) if s.name == "post")
    assert _names(spans, trace) == ["trace.tables", "trace.launch", "trace.normalize"]
    tables = next(i for i, s in enumerate(spans) if s.name == "trace.tables")
    assert _names(spans, tables)[0] == "scene.cand_tables"
    assert _names(spans, post) == ["post.bilateral", "post.unet", "post.blend", "post.blur"]
    # sync.* and scene.* spans carry no frame id: they sit under spans that do
    assert {s.attrs["frame"] for s in spans if not s.name.startswith(("sync.", "scene."))} == {0}
    ends = [s.end_ns for s in spans if s.parent == post]
    assert ends == sorted(ends)


def test_setup_records_parse_and_build(recorder):
    xml = seeded_scene_xml(0, 24, 24)
    rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    assert [s.name for s in timing.drain()] == ["scene.parse", "scene.build_device"]


def test_set_adds_attributes_inside_the_block(recorder):
    with timing.span("scene.build_device", a=1) as sp:
        sp.set(b=2)
    timing.disable()
    with timing.span("scene.build_device") as off:
        off.set(b=3)
    assert off is timing.NOOP
    assert [(s.name, s.attrs) for s in timing.drain()] == [("scene.build_device", {"a": 1, "b": 2})]


@pytest.mark.parametrize("make, rpp, attrs, tables", [
    # 256 sub-segments: uncapped distance-ordered lists
    (endcapped_scene_xml, 16, {"sub_segments": 256, "endcap_sub_segments": 128,
                               "weighted_curves": 4, "portal_curves": 0,
                               "portal_sub_segments": 0},
     {"table_kind": "seg", "order": "dist", "cand_len": 256, "wedges": 4, "wedge_shift": 0}),
    # 128 sub-segments: slot mode
    (seeded_scene_xml, 128, {"sub_segments": 128, "endcap_sub_segments": 0,
                             "weighted_curves": 0, "portal_curves": 0, "portal_sub_segments": 0},
     {"table_kind": "seg", "order": "id", "cand_len": 128, "wedges": 32, "wedge_shift": 0}),
    # 1536 sub-segments, 32 of them the portal pair's: capped lists
    (portal_dense_scene_xml, 16, {"sub_segments": 1536, "endcap_sub_segments": 0,
                                  "weighted_curves": 0, "portal_curves": 2,
                                  "portal_sub_segments": 32},
     {"table_kind": "seg", "order": "dist", "cand_len": 256, "wedges": 4, "wedge_shift": 0}),
])
def test_setup_spans_carry_the_scenes_and_tables_counts(recorder, make, rpp, attrs, tables):
    dev = rt.build_device_scene(rt.load_scene_from_string(make(0, 64, 48)), device="cpu")
    rt.build_cand_tables(dev, rt.Camera(), rt.RenderConfig(rays_per_pixel=rpp))
    got = {s.name: s.attrs for s in timing.drain()}
    assert got["scene.build_device"] == attrs and got["scene.cand_tables"] == tables


def test_session_records_grid_build_own_tables_and_syncs(recorder):
    xml = seeded_scene_xml(0, 48, 48)
    dev = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    cfg = rt.RenderConfig(rays_per_pixel=8, use_denoiser=False)  # slot-mode lists
    s = rt.InteractiveSession(dev, cfg)
    timing.drain()

    def frame_spans():
        s.render()
        spans = timing.drain()
        root = next(i for i, x in enumerate(spans) if x.name == "session.render")
        accel = next(i for i, x in enumerate(spans) if x.name == "session.accel")
        assert spans[accel].parent == root
        assert _names(spans, root) == ["session.accel", "frame"]
        return spans, accel

    spans, accel = frame_spans()  # the first frame moves: the grid is built
    assert _names(spans, accel) == ["session.grid_build", "session.grid_gather"]
    build = next(i for i, x in enumerate(spans) if x.name == "session.grid_build")
    assert "sync.seg_max_count" in _names(spans, build)
    spans, accel = frame_spans()  # the first resting frame builds its own tables
    assert _names(spans, accel) == ["session.own_tables"]
    own = next(i for i, x in enumerate(spans) if x.name == "session.own_tables")
    assert "sync.seg_max_count" in _names(spans, own)
    assert any(x.name == "sync.wedge_dirs" for x in spans)
    assert {x.attrs["frame"] for x in spans if x.name.startswith(("session", "frame"))} == {1}
    spans, accel = frame_spans()  # resting again: the same tables
    assert _names(spans, accel) == []
    s.drag(3.0, 2.0)
    drag = timing.drain()
    assert [(x.name, x.attrs["frame"]) for x in drag] == [("session.event.drag", 3)]
    spans, accel = frame_spans()  # moving on the same grid: a gather
    assert _names(spans, accel) == ["session.grid_gather"]
    assert not any(x.name.startswith("sync.") for x in spans)


def test_cli_profile_writes_the_spans_into_the_chrome_trace(tmp_path, capsys):
    xml = make_scene_xml([simple_curve([(10, 14), (30, 25), (40, 40), (50, 52)])], 32, 32)
    scene = tmp_path / "scene.xml"
    scene.write_text(f"<!DOCTYPE CurveSetXML>\n{xml}")
    logdir = tmp_path / "prof"
    assert main([str(scene), "2", "--no-denoiser", "--device", "cpu", "--frames", "3",
                 "--out", str(tmp_path / "o.png"), "--profile", str(logdir), "--stats"]) == 0
    assert timing.span("frame") is timing.NOOP and timing.drain() == []
    trace = json.loads((logdir / "trace.json").read_text())
    ours = [e for e in trace["traceEvents"] if e.get("pid") == "program spans"]
    frames = [e for e in ours if e.get("name") == "frame"]
    assert [e["args"]["frame"] for e in frames] == [1, 2]
    assert {"trace", "trace.launch", "trace.normalize", "post"} <= {e["name"] for e in ours}
    # on the profiler's clock: the spans fall among the profiler's own events
    times = [e["ts"] for e in trace["traceEvents"] if e.get("ph") == "X" and e not in ours]
    assert min(times) - 1e6 < frames[0]["ts"] < max(times) + 1e6
    lines = capsys.readouterr().out.splitlines()
    phases = json.loads(next(ln for ln in lines if ln.startswith('{"scene_load"')))
    assert set(phases) == {"scene_load", "device_build", "accel_build", "first_frame", "frame"}
