"""Device ms per frame of the trace kernel on the slowest rank (the most
device work per frame) of a cell across cards. Moves frame_ms."""

from perfbench import layers, ranks

UNIT = "ms"


def read(tr):
    got = ranks.of(tr)
    if got is None:
        return None
    return ranks.per_frame_ms(ranks.slowest(got), lambda n: layers.layer_of(n) == "trace")
