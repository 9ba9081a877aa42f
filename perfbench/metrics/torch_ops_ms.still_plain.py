"""Device ms per denoiser-off still frame of every operation other than the
trace kernel: the plain-torch tail (normalize, the variable blur). Moves
frame_ms."""

from perfbench import layers

UNIT = "ms"


def read(tr):
    return layers.per_frame_ms(tr, "torch") if tr.kind == "still_plain" else None
