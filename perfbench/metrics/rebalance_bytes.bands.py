"""MB a rank's rebalance exchange gathers in one frame, as the program counts
it (``parallel.sharded.EXCHANGE_LOG`` of the window's last frame: the strips
of trace sums that the ranks traced for other ranks' output bands), the
largest over ranks; None where no rank logged one (a program whose trace
follows the output bands). Moves frame_ms."""

from perfbench import ranks

UNIT = "MB"


def read(tr):
    got = ranks.of(tr)
    if got is None:
        return None
    per_rank = [sum(nbytes for kind, nbytes, _ in r.exchange if kind == "rebalance") for r in got]
    return max(per_rank) * 1e-6 if max(per_rank) > 0 else None
