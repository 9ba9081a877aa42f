"""The nine UNet layers' least time over the conv kernel's device time per
session frame. Moves session_frame_ms."""

from perfbench import layers

UNIT = "%"


def read(tr):
    return layers.roofline_share(tr, "session", "conv", lambda: layers.conv_bound_s(tr))
