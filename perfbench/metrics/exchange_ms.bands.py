"""Device ms per frame of the NCCL kernels (the halo exchange's
all_gather) on the slowest rank: the exchange's own time, since no rank is
late for the slowest one. Moves frame_ms."""

from perfbench import ranks

UNIT = "ms"


def read(tr):
    got = ranks.of(tr)
    if got is None:
        return None
    return ranks.per_frame_ms(ranks.slowest(got), ranks.is_exchange)
