"""The slowest rank's band: its trace's least time (roofline.band_counts:
operations at the float32 peak or bytes at the HBM rate) over its trace
kernel's device time per frame. Moves frame_ms."""

from perfbench import layers, ranks

UNIT = "%"


def read(tr):
    got = ranks.of(tr)
    if got is None:
        return None
    slow = ranks.slowest(got)
    ms = ranks.per_frame_ms(slow, lambda n: layers.layer_of(n) == "trace")
    if ms is None:
        return None
    bound_s = ranks.band_counts(tr)[got.index(slow)]["trace_bound_s"]
    return 100.0 * bound_s * 1e3 / ms
