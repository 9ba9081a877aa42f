"""The portal trace's least time (roofline_portals.frame_counts: every
trace of each ray's chain through the frozen reference, operations at the
float32 peak or bytes at the HBM rate) over the trace kernel's device time
per portal still frame. Moves frame_ms."""

import json
import sys

from perfbench import layers, roofline_portals

UNIT = "%"


def _bound_s(tr) -> float:
    counts = roofline_portals.frame_counts(tr.xml, tr.settings, tr.cell.traffic["camera"], tr.dev)
    print("portal_counts " + json.dumps(counts), file=sys.stderr)
    return counts["trace_bound_s"]


def read(tr):
    return layers.roofline_share(tr, "still_portals", "trace", lambda: _bound_s(tr))
