"""Share of the denoiser-off still window in which the device ran nothing:
1 - the union of its operations' intervals over the traced window. Moves
frame_ms."""

from perfbench import layers

UNIT = "%"


def read(tr):
    return layers.idle_share(tr, "still_plain")
