"""Host ms per still frame inside the harness's span around render_frame,
before its wait. Moves frame_ms."""

from perfbench import layers

UNIT = "ms"


def read(tr):
    return layers.enqueue_ms(tr, "still")
