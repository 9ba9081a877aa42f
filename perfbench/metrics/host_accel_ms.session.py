"""Host ms per session frame inside the program's ``session.accel`` spans:
table selection, world-grid builds and gathers, own-table builds with
their syncs; from the program's span recorder in a second traced window of
the run (perfbench/stages.py). Moves session_frame_ms."""

from perfbench import stages

UNIT = "ms"


def read(tr):
    return stages.host_ms(tr, "session", "session.accel")
