"""Device ms per portal still frame of the trace kernel (primary rays and
portal bounces in one launch). Moves frame_ms."""

from perfbench import layers

UNIT = "ms"


def read(tr):
    return layers.per_frame_ms(tr, "trace") if tr.kind == "still_portals" else None
