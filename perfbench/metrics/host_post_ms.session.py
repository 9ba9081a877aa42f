"""Host ms per session frame inside the program's ``post`` spans: warp,
bilateral, UNet, blend and blur enqueued; from the program's span recorder
in a second traced window of the run (perfbench/stages.py). Moves
session_frame_ms."""

from perfbench import stages

UNIT = "ms"


def read(tr):
    return stages.host_ms(tr, "session", "post")
