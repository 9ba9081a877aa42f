"""The denoiser-off still frame's least time over its traced time: the
trace's bound (roofline.frame_counts) plus the denoiser-off tail's least
bytes (roofline.PLAIN_POST_BYTES_PER_PIXEL: normalize and blur) at the HBM
rate, against the published H100 peaks. Moves frame_ms."""

from perfbench import layers, roofline

UNIT = "%"


def read(tr):
    per_frame = layers.frame_s(tr)
    if tr.kind != "still_plain" or per_frame is None or not tr.device_ops:
        return None
    n_px = tr.cell.config["width"] * tr.cell.config["height"]
    bound_s = tr.counts()["trace_bound_s"] \
        + roofline.PLAIN_POST_BYTES_PER_PIXEL * n_px / roofline.HBM_BYTES
    return 100.0 * bound_s / per_frame
