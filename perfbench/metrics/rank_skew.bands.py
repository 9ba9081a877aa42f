"""The slowest rank's device work per frame (its operations other than the
collectives) over the ranks' mean, minus 1, in %: the imbalance of the
bands' work, which the others wait out in the collectives. Moves
frame_ms."""

from perfbench import ranks

UNIT = "%"


def read(tr):
    got = ranks.of(tr)
    if got is None or not all(r.frames > 0 for r in got):
        return None
    work = [ranks.work_ms(r) for r in got]
    mean = sum(work) / len(work)
    return 100.0 * (max(work) / mean - 1.0) if mean > 0 else None
