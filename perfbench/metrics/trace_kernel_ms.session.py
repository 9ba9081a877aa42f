"""Device ms per session frame of the trace kernel. Moves session_frame_ms."""

from perfbench import layers

UNIT = "ms"


def read(tr):
    return layers.per_frame_ms(tr, "trace") if tr.kind == "session" else None
