"""The largest share, over ranks, of a rank's traced window in which its
device ran nothing. Moves frame_ms."""

from perfbench import ranks

UNIT = "%"


def read(tr):
    got = ranks.of(tr)
    if got is None or not all(r.device_ops and r.window_s > 0 for r in got):
        return None
    return max(100.0 * (1.0 - r.busy_s / r.window_s) for r in got)
