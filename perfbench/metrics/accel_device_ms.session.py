"""Device ms per session frame of the operations launched inside the
program's ``session.accel`` spans (grid builds and gathers, own-table
builds), matched to their spans by each launch call's correlation id in a
second traced window of the run (perfbench/stages.py). Moves
session_frame_p95_ms."""

from perfbench import stages

UNIT = "ms"


def read(tr):
    if tr.kind != "session":
        return None
    st = stages.of(tr)
    ops = stages.launched_in(st, "session.accel")
    if ops is None or st.frames <= 0:
        return None
    return sum(st.device_ops[k][2] for k in ops) * 1e-6 / st.frames
