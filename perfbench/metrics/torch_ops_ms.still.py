"""Device ms per still frame of every operation that is neither the trace nor
the conv kernel: the plain-torch post-processing. Moves frame_ms."""

from perfbench import layers

UNIT = "ms"


def read(tr):
    return layers.per_frame_ms(tr, "torch") if tr.kind == "still" else None
