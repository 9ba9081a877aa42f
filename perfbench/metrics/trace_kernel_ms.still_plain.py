"""Device ms per denoiser-off still frame of the trace kernel. Moves
frame_ms."""

from perfbench import layers

UNIT = "ms"


def read(tr):
    return layers.per_frame_ms(tr, "trace") if tr.kind == "still_plain" else None
