"""Seconds of set-up in the harness's spans around the scene's generation,
parsing and flattening, the tables (or the session) and the checkpoint's
weights.  Moves setup_s."""

UNIT = "s"
SPANS = ("scene", "weights", "tables")


def read(tr):
    got = [tr.setup_log[k] for k in SPANS if k in tr.setup_log]
    return sum(got) if got else None
