"""Seconds of set-up in the program's ``scene.parse`` and
``scene.build_device`` spans (the XML parsed, the curves flattened into
the device tables), as the second traced window of the run builds the
cell's scene again (perfbench/stages.py). Moves setup_s."""

from perfbench import stages

UNIT = "s"
SPANS = ("scene.parse", "scene.build_device")


def read(tr):
    st = stages.of(tr)
    if st is None:
        return None
    got = [p.end_ns - p.start_ns for p in st.program_spans if p.name in SPANS]
    return sum(got) * 1e-9 if got else None
