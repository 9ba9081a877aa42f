"""What the readers of a cell across cards share: each rank's traced window
(``core.RankTrace``), the slowest rank (the most device work per frame, the
collectives' kernels left out), and the trace's least time on each rank's
band (``roofline.band_counts``)."""

from __future__ import annotations

from perfbench import core, roofline

KIND = "still_bands"


def of(tr) -> list | None:
    """The ranks' traced windows of a ``still_bands`` run, or None."""
    if tr.kind != KIND or not tr.ranks:
        return None
    return tr.ranks


def is_exchange(name: str) -> bool:
    """A collective's kernel (NCCL's: ``ncclDevKernel_AllGather_...``).  It
    runs from its launch until every rank has joined it, so on a rank that
    is ahead it holds the card while it waits."""
    return "nccl" in name.lower()


def work_ms(r) -> float:
    """A rank's device ms per traced frame of its own work: the union of its
    operations other than the collectives (whose time on a rank that is
    ahead is the wait for the others)."""
    return core.union_ns([(s, s + d) for n, s, d in r.device_ops
                          if not is_exchange(n)]) * 1e-6 / r.frames


def slowest(ranks: list):
    """The rank with the most device work per frame: the one the others'
    collectives wait for."""
    return max(ranks, key=work_ms)


def per_frame_ms(r, match) -> float | None:
    """Device ms per traced frame of a rank's operations whose name
    ``match`` accepts, or None where none ran."""
    ns = sum(d for name, _, d in r.device_ops if match(name))
    return ns * 1e-6 / r.frames if ns > 0 and r.frames > 0 else None


_last: tuple = (None, None)  # (the Trace, its bands' counts)


def band_counts(tr) -> list[dict]:
    """``roofline.band_counts`` of every rank's band, by rank, computed once
    per traced run."""
    global _last
    if _last[0] is not tr:
        _last = (tr, [roofline.band_counts(tr.cell.config, tr.xml, tr.settings,
                                           tr.cell.traffic["camera"], tr.dev, r.row0, r.rows)
                      for r in tr.ranks])
    return _last[1]
