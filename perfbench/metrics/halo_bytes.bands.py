"""MB a rank's halo exchanges gather in one frame, as the program counts
them (``parallel.sharded.EXCHANGE_LOG`` of the window's last frame: every
rank's edge strips), the largest over ranks. Moves frame_ms."""

from perfbench import ranks

UNIT = "MB"


def read(tr):
    got = ranks.of(tr)
    if got is None:
        return None
    per_rank = [sum(nbytes for kind, nbytes, _ in r.exchange if kind == "halo") for r in got]
    return max(per_rank) * 1e-6 if max(per_rank) > 0 else None
