"""List slots tested per live primary ray, from one launch of the trace
kernel's counting instantiation on the hoisted tables after the window of a
traced denoiser-off still run (loops/still_plain.py; distance-ordered
tables only). Moves frame_ms."""

UNIT = "slots/ray"


def read(tr):
    w = getattr(tr, "walk_stats", None) if tr.kind == "still_plain" else None
    if not w or not w.get("live_rays"):
        return None
    return w["list_slots"] / w["live_rays"]
