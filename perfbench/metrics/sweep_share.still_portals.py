"""The share of the walk's lane-slots spent in the portal bounces' full
sweeps, %, from the same counting launch as portal_rays.still_portals:
``sweep_warp_slots`` over ``warp_slots`` (the primary rays' list walk) plus
``sweep_warp_slots``. Moves frame_ms."""

UNIT = "%"


def read(tr):
    w = getattr(tr, "walk_stats", None) if tr.kind == "still_portals" else None
    if not w or "sweep_warp_slots" not in w:
        return None
    total = w["warp_slots"] + w["sweep_warp_slots"]
    return 100.0 * w["sweep_warp_slots"] / total if total else None
