"""Portal continuation rays (bounce >= 1) per live primary ray, %, from the
counting launch after the window of a traced portal still run
(loops/still_portals.py): the kernel's ``bounce_rays`` over its
``live_rays``; None on a program without the bounce counters. Moves
frame_ms."""

UNIT = "%"


def read(tr):
    w = getattr(tr, "walk_stats", None) if tr.kind == "still_portals" else None
    if not w or "bounce_rays" not in w or not w.get("live_rays"):
        return None
    return 100.0 * w["bounce_rays"] / w["live_rays"]
