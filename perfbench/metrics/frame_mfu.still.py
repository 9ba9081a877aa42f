"""The still frame's least time over its traced time: the trace's bound, the
UNet layers' bound and the post-processing's least bytes at the HBM rate
(roofline.frame_counts), against the published H100 peaks.  Moves
frame_ms."""

from perfbench import layers

UNIT = "%"


def read(tr):
    per_frame = layers.frame_s(tr)
    if tr.kind != "still" or per_frame is None or not tr.device_ops:
        return None
    return 100.0 * tr.counts()["frame_bound_s"] / per_frame
