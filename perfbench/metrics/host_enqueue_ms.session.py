"""Host ms per session frame inside the harness's span around the session's
render (event and wait excluded). Moves session_frame_ms."""

from perfbench import layers

UNIT = "ms"


def read(tr):
    return layers.enqueue_ms(tr, "session")
