"""List slots over warp slots (each ray's share of its warp's longest list
walk), %, from the same counting launch as trace_slots_per_ray.still_plain:
the share of lane-slots of the list walk that did work. Moves frame_ms."""

UNIT = "%"


def read(tr):
    w = getattr(tr, "walk_stats", None) if tr.kind == "still_plain" else None
    if not w or not w.get("warp_slots"):
        return None
    return 100.0 * w["list_slots"] / w["warp_slots"]
