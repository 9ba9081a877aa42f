"""The trace's least time (roofline.frame_counts on the cell's own scene,
endcap loops included: operations at the float32 peak or bytes at the HBM
rate) over the trace kernel's device time per denoiser-off still frame.
Moves frame_ms."""

from perfbench import layers

UNIT = "%"


def read(tr):
    return layers.roofline_share(tr, "still_plain", "trace", lambda: tr.counts()["trace_bound_s"])
