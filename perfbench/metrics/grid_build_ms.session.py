"""Ms per world-grid build in a second traced window of the run
(perfbench/stages.py): from the start of its ``session.grid_build`` span to
the end of the last device operation launched in it (or of the span, where
that comes later). Moves session_frame_p95_ms."""

from perfbench import stages

UNIT = "ms"


def read(tr):
    if tr.kind != "session":
        return None
    st = stages.of(tr)
    if not stages.attributed(st):
        return None
    builds = [i for i in stages.windowed(st)
              if st.program_spans[i].name == "session.grid_build"]
    if not builds:
        return None
    end = {i: st.program_spans[i].end_ns for i in builds}
    for (_, s, d), i in zip(st.device_ops, stages.enclosing(st, "session.grid_build")):
        if i in end:
            end[i] = max(end[i], s + d)
    return sum(end[i] - st.program_spans[i].start_ns for i in builds) * 1e-6 / len(builds)
