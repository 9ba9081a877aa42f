"""The ``still_portals`` loop: ``loops/still_plain.py`` on the portal scene.

One card, a static camera, the denoiser off: ``render_frame`` on tables
hoisted in set-up, at most two frames in flight, as the program's CLI
renders ``<scene> <rpp> --no-denoiser``.  Everything but the scene is the
``still_plain`` loop's: the chain, the check against
``reference/plain_frame.py`` (whose trace follows portals), the counting
launch after a traced window (its counters of the portal bounces included,
where the program has them) and the attributes of the program's set-up
spans.  The scene is ``scenes_portals.py``'s: the configuration's
``scene.kind`` must be ``lady_bug_portals``.
"""

import pathlib

from perfbench import core, scenes_portals

# still_plain.py, loaded as a module of this loop's own: its ``scene_xml``
# is this file's below.
_plain = core.load_file(pathlib.Path(__file__).resolve().parent / "still_plain.py")


def scene_xml(config: dict, seed: int) -> str:
    """The configuration's portal scene: geometry, blur and the portal pair
    from its own seed, colours from the run's ``seed``."""
    sc = config["scene"]
    if sc["kind"] != "lady_bug_portals":
        raise ValueError(f"a still_portals cell renders the portal scene, not {sc['kind']!r}")
    return scenes_portals.portal_dense_scene_xml(sc["seed"], config["width"], config["height"],
                                                 seed % (1 << 63))


_plain.scene_xml = scene_xml


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, dev_name: str = "cuda",
        t_start: float | None = None, mode: str = "program") -> dict:
    """One run of a ``still_portals`` cell; returns the result line's
    object, as ``core.run``."""
    return _plain.run(cell, seed, seconds, trace, dev_name, t_start, mode)
