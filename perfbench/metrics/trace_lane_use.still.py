"""List slots over warp slots (each ray's share of its warp's longest list
walk), %, from the same counting launch as trace_slots_per_ray.still: the
share of lane-slots of the list walk that did work. Moves frame_ms."""

from perfbench import stages

UNIT = "%"


def read(tr):
    if tr.kind != "still":
        return None
    st = stages.of(tr)
    w = st.walk_stats if st is not None else None
    if not w or not w.get("warp_slots"):
        return None
    return 100.0 * w["list_slots"] / w["warp_slots"]
