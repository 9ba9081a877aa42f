"""Sub-segments of the scene's portal curves, as the program counts them
(the ``portal_sub_segments`` attribute of its ``scene.build_device`` span,
from a rebuild with its recorder on after the check of a traced portal
still run, loops/still_portals.py): a count that repeats exactly; None on a
program that records no such attribute. Moves frame_ms."""

UNIT = "sub-segments"


def read(tr):
    if tr.kind != "still_portals":
        return None
    return getattr(tr, "program", {}).get("scene.build_device", {}).get("portal_sub_segments")
