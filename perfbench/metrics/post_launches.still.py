"""Device operations per still frame launched inside the program's
``post`` spans (the bilateral's and the blur's small launches, the UNet's
glue and convolutions), matched to their spans by each launch call's
correlation id in a second traced window of the run (perfbench/stages.py).
Moves frame_ms."""

from perfbench import stages

UNIT = "launches"


def read(tr):
    if tr.kind != "still":
        return None
    st = stages.of(tr)
    ops = stages.launched_in(st, "post")
    return None if ops is None or st.frames <= 0 else len(ops) / st.frames
