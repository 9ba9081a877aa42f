"""Host ms per session frame inside the program's ``trace`` spans (in-frame
table builds, the launch's argument work, the normalization), from the
program's span recorder in a second traced window of the run
(perfbench/stages.py). Moves session_frame_ms."""

from perfbench import stages

UNIT = "ms"


def read(tr):
    return stages.host_ms(tr, "session", "trace")
