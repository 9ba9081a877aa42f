"""The whole frame's least time on one card over the cards' seconds per
frame (the ranks times the slowest rank's traced seconds per frame): the
trace's bound summed over the bands' operations, plus the denoiser-off
tail's least bytes (roofline.PLAIN_POST_BYTES_PER_PIXEL) at the HBM rate,
against the published H100 peaks. Moves frame_ms."""

from perfbench import ranks, roofline

UNIT = "%"


def read(tr):
    got = ranks.of(tr)
    if got is None or not all(r.device_ops and r.frames > 0 and r.window_s > 0 for r in got):
        return None
    counts = ranks.band_counts(tr)
    n_px = tr.cell.config["width"] * tr.cell.config["height"]
    ops = sum(c["trace_flop"] for c in counts)
    nbytes = counts[0]["segment_bytes"] + roofline.PIXEL_SUM_BYTES * n_px
    bound_s = max(ops / roofline.FP32_FLOPS, nbytes / roofline.HBM_BYTES) \
        + roofline.PLAIN_POST_BYTES_PER_PIXEL * n_px / roofline.HBM_BYTES
    per_frame = max(r.window_s / r.frames for r in got)
    return 100.0 * bound_s / (len(got) * per_frame)
