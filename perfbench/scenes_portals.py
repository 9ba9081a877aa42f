"""The benchmark's portal scene, generated from a seed: a frozen copy of the
program's ``portal_dense_scene_xml`` (``utils/scenes.py``), so that the
work the benchmark hands the program cannot change with the program.

The lady_bug drawing of ``scenes.dense_scene_xml`` with the reference's
portal extension as its PortalDemo.xml uses it: two straight one-cubic
curves appended, A in the left margin beside the head and B in the right
margin below the aphid, each ``connects`` to the other, with the default
weights.  As in ``scenes.py``, the geometry and blur come from ``seed`` and
the side colours from ``colour_seed`` alone; the pair's blur and colours
come from streams of their own, ``(seed, PORTAL_STREAM)`` and
``(colour_seed, PORTAL_STREAM)``, so that the drawing is
``scenes.dense_scene_xml``'s exactly.
"""

from __future__ import annotations

import numpy as np

from perfbench.scenes import _curve_xml, dense_scene_xml

PORTAL_STREAM = 2
# Each portal's ends in image space (column, row) as shares of the canvas.
PORTAL_PAIR = (((0.06, 0.30), (0.06, 0.80)), ((0.90, 0.30), (0.90, 0.80)))


def portal_dense_scene_xml(seed: int, width: int, height: int, colour_seed: int) -> str:
    """Orzan curve_set XML of the lady_bug drawing at ``width`` x
    ``height`` with the portal pair appended (curves n and n + 1 of n + 2,
    each connecting to the other)."""
    doc = dense_scene_xml(seed, width, height, "lady_bug", colour_seed)
    head, body = doc.split(">", 1)
    n = body.count("<curve ")
    rng = np.random.default_rng([seed, PORTAL_STREAM])
    colours = np.random.default_rng([colour_seed, PORTAL_STREAM])
    size = np.array([width, height], np.float64)
    portals = []
    for k, ends in enumerate(PORTAL_PAIR):
        a, b = (np.asarray(e, np.float64) * size for e in ends)
        # an Orzan save stores (row, column)
        pts = [(float(p[1]), float(p[0])) for p in (a + (b - a) * i / 3.0 for i in range(4))]
        rng.integers(0, 256, (4, 3))  # the geometry stream's colour draw, unused
        cols = colours.integers(0, 256, (4, 3))
        blur = rng.uniform(0.5, 2.0, 2)
        portals.append(_curve_xml(pts, left=(tuple(cols[0]), tuple(cols[1])),
                                  right=(tuple(cols[2]), tuple(cols[3])), blur=tuple(blur),
                                  connects=n + 1 - k))
    head = head.replace(f'nb_curves="{n}"', f'nb_curves="{n + 2}"')
    return head + ">" + body[: -len("</curve_set>")] + "".join(portals) + "</curve_set>"
