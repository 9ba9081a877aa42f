"""Device ms per session frame of the plain-torch operations (post-processing,
warp, grid gathers, table builds). Moves session_frame_ms."""

from perfbench import layers

UNIT = "ms"


def read(tr):
    return layers.per_frame_ms(tr, "torch") if tr.kind == "session" else None
