"""The program's ``sync.*`` spans (host reads that wait for the card) that
start in a second traced window of the run (perfbench/stages.py), per
session frame. Moves session_frame_ms."""

from perfbench import stages

UNIT = "syncs"


def read(tr):
    if tr.kind != "session":
        return None
    st = stages.of(tr)
    if st is None or st.frames <= 0 or not st.program_spans:
        return None
    syncs = [i for i in stages.windowed(st) if st.program_spans[i].name.startswith("sync.")]
    return len(syncs) / st.frames
