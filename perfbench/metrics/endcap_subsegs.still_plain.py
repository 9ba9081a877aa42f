"""Sub-segments of the scene's endcap loops, as the program counts them
(the ``endcap_sub_segments`` attribute of its ``scene.build_device`` span,
from a rebuild with its recorder on after the check of a traced
denoiser-off still run, loops/still_plain.py): a count that repeats
exactly. Moves frame_ms."""

UNIT = "sub-segments"


def read(tr):
    if tr.kind != "still_plain":
        return None
    return getattr(tr, "program", {}).get("scene.build_device", {}).get("endcap_sub_segments")
