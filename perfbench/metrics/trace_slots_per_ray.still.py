"""List slots tested per live primary ray, from one launch of the trace
kernel's counting instantiation on the still loop's hoisted tables at the
last frame of a second traced window of the run (perfbench/stages.py;
distance-ordered tables only). Moves frame_ms."""

from perfbench import stages

UNIT = "slots/ray"


def read(tr):
    if tr.kind != "still":
        return None
    st = stages.of(tr)
    w = st.walk_stats if st is not None else None
    if not w or not w.get("live_rays"):
        return None
    return w["list_slots"] / w["live_rays"]
