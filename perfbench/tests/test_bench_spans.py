"""The program's spans in a traced run (perfbench/stages.py): device
operations assigned to the span open on their launching thread, the readers
of the spans, and the idle gaps labelled by the program's stages; on a
synthetic window, and in a tiny traced run on the CPU."""

import pytest

from perfbench import core, stages
from perfbench.tests.cells import tiny_root
from raytracingdiffusioncurves_torch.utils.timing import Span

MAIN, OTHER = 100, 200


@pytest.fixture
def window():
    """Makes (Trace, Stages) pairs whose Stages ``stages.of`` returns; the
    cache is emptied after the test."""

    def make(cell: str, program_spans, ops, launches, frames=1):
        """ops: (name, start, duration, correlation id)."""
        tr = core.Trace(core.load_cell(cell), frames, 1e-6, [], [], {}, {}, "", "cpu")
        st = stages.Stages(tr.kind, frames, [o[:3] for o in ops], [("enqueue", 0, 1000)],
                           program_spans, launches, [o[3] for o in ops])
        stages._last = (tr, st)
        return tr, st

    yield make
    stages._last = (None, None)


def _frame_spans():
    return [
        Span("frame", 10, 900, -1, MAIN, {"frame": 0}),  # 0
        Span("trace", 20, 300, 0, MAIN, {"frame": 0}),  # 1
        Span("trace.launch", 30, 290, 1, MAIN, {"frame": 0}),  # 2
        Span("post", 300, 880, 0, MAIN, {"frame": 0}),  # 3
        Span("post.bilateral", 310, 500, 3, MAIN, {"frame": 0}),  # 4
        Span("post.blur", 500, 870, 3, MAIN, {"frame": 0}),  # 5
        Span("post", 305, 310, -1, OTHER, {}),  # 6: another thread's
    ]


def test_operations_go_to_the_innermost_span_of_their_launching_thread(window):
    ops = [("trace_kernel", 400, 200, 1), ("add", 610, 10, 2), ("exp", 620, 10, 3),
           ("mul", 640, 10, 4), ("copy", 650, 10, 5), ("fill", 660, 10, 6)]
    launches = {1: (100, MAIN),  # in trace.launch
                2: (305, MAIN),  # post opened at 300, bilateral at 310: post
                3: (310, MAIN),  # a start comes before a launch at the same instant
                4: (600, None),  # a thread the profiler could not name
                5: (950, MAIN)}  # after every span; 6 has no launch event
    tr, st = window("arch1080_still", _frame_spans(), ops, launches)
    assert st.op_spans() == [2, 3, 4, -1, -1, -1]
    assert stages.launched_in(st, "post") == [1, 2]
    assert stages.launched_in(st, "trace") == [0]
    assert stages.enclosing(st, "frame") == [0, 0, 0, -1, -1, -1]
    metrics = core.load_readers()
    assert metrics["post_launches.still"].read(tr) == 2.0
    assert metrics["host_trace_ms.still"].read(tr) == 280 * 1e-6
    # another thread's post span counts as host time too
    assert metrics["host_post_ms.still"].read(tr) == (580 + 5) * 1e-6
    assert metrics["trace_slots_per_ray.still"].read(tr) is None  # no counting launch
    assert stages.covered_share(st, "frame") == (280 + 580) / 890


def test_without_launch_events_nothing_is_assigned(window):
    ops = [("add", 610, 10, 2)]
    for launches in ({}, {2: (305, None)}):
        tr, st = window("arch1080_still", _frame_spans(), ops, launches)
        assert st.op_spans() == [-1]
        assert stages.launched_in(st, "post") is None
        assert core.load_readers()["post_launches.still"].read(tr) is None


def test_session_readers(window):
    spans = [
        Span("session.event.drag", 5, 9, -1, MAIN, {"frame": 4}),  # 0
        Span("session.render", 10, 900, -1, MAIN, {"frame": 4}),  # 1
        Span("session.accel", 20, 200, 1, MAIN, {"frame": 4}),  # 2
        Span("session.grid_build", 30, 150, 2, MAIN, {"frame": 4}),  # 3
        Span("sync.seg_max_count", 100, 140, 3, MAIN, {}),  # 4
        Span("session.grid_gather", 160, 190, 2, MAIN, {"frame": 4}),  # 5
        Span("frame", 200, 890, 1, MAIN, {"frame": 4}),  # 6
    ]
    ops = [("radix", 40, 100, 1), ("max", 145, 5, 2), ("narrow", 148, 52, 3),
           ("gather", 195, 10, 4), ("trace_kernel", 300, 400, 5)]
    launches = {1: (35, MAIN), 2: (120, MAIN), 3: (145, MAIN), 4: (170, MAIN), 5: (210, MAIN)}
    tr, _ = window("arch1080_zoompan", spans, ops, launches, frames=2)
    metrics = core.load_readers()
    # the build: from its start (30) to its last operation's end (200)
    assert metrics["grid_build_ms.session"].read(tr) == 170 * 1e-6
    assert metrics["accel_device_ms.session"].read(tr) == (100 + 5 + 52 + 10) * 1e-6 / 2
    assert metrics["host_accel_ms.session"].read(tr) == 180 * 1e-6 / 2
    assert metrics["syncs_per_frame.session"].read(tr) == 0.5
    assert metrics["host_post_ms.session"].read(tr) is None  # no post span
    assert metrics["post_launches.still"].read(tr) is None  # not a still cell


def test_idle_gaps_carry_the_programs_stage(window):
    ops = [("a", 0, 100, 1), ("b", 400, 100, 2), ("c", 520, 10, 3)]
    spans = [Span("post", 50, 520, -1, MAIN, {}), Span("post.bilateral", 90, 450, 0, MAIN, {})]
    _, st = window("arch1080_still", spans, ops, {})
    gaps = stages.idle_gaps(st)
    # 100-400 opens in post.bilateral, 500-520 in post, 530-1000 in the
    # harness's enqueue alone
    assert [g[0] for g in gaps] == ["enqueue", "post.bilateral", "post"]
    assert [round(g[1] * 1e9) for g in gaps] == [470, 300, 20]
    _, bare = window("arch1080_still", [], ops, {})
    assert [g[0] for g in stages.idle_gaps(bare)] == ["enqueue"] * 3


def test_without_a_recorder_nothing_runs(window, monkeypatch):
    tr, _ = window("arch1080_still", [], [], {})
    stages._last = (None, None)
    monkeypatch.setattr(stages, "recorder", lambda: None)
    assert stages.of(tr) is None
    assert all(mod.read(tr) is None for name, mod in core.load_readers().items()
               if name in NEW)


NEW = ("host_trace_ms.still", "host_trace_ms.session", "host_post_ms.still",
       "host_post_ms.session", "host_accel_ms.session", "accel_device_ms.session",
       "grid_build_ms.session", "syncs_per_frame.session", "post_launches.still",
       "scene_build_s", "trace_slots_per_ray.still", "trace_lane_use.still")


@pytest.mark.parametrize("cell, present", [
    ("tiny_still", {"host_trace_ms.still", "host_post_ms.still", "scene_build_s"}),
    ("tiny_zoompan", {"host_trace_ms.session", "host_post_ms.session",
                      "host_accel_ms.session", "syncs_per_frame.session", "scene_build_s"}),
])
def test_tiny_traced_run_reads_the_host_spans(tmp_path, cell, present):
    # the program's spans read on the CPU; what needs the launch calls or
    # the card's counting launch does not
    root = tiny_root(tmp_path)
    out = core.run(core.load_cell(cell, root), seed=2**31 + 11, seconds=0.2, trace=True,
                   dev_name="cpu")
    assert out["correct"]
    got = set(out["metrics"]) & set(NEW)
    assert got == present
    assert all(out["metrics"][k]["value"] > 0 for k in present - {"syncs_per_frame.session"})
    # the recorder is off again: the program's spans cost nothing after
    assert stages.recorder()._on is False
