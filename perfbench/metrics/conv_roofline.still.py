"""The nine UNet layers' least time (roofline.conv_bound_s) over the conv
kernel's device time per still frame. Moves frame_ms."""

from perfbench import layers

UNIT = "%"


def read(tr):
    return layers.roofline_share(tr, "still", "conv", lambda: layers.conv_bound_s(tr))
