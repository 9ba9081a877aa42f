"""Share of the session window in which the device ran nothing. Moves session_frame_ms."""

from perfbench import layers

UNIT = "%"


def read(tr):
    return layers.idle_share(tr, "session")
