"""The benchmark's endcapped scene, generated from a seed: a frozen copy of
the program's ``endcapped_scene_xml`` (``utils/scenes.py``), so that the
work the benchmark hands the program cannot change with the program.

The seeded arch class of ``scenes.seeded_scene_xml`` with the features of
the reference's arch.xml: an endcap on every curve, and on each curve a
two-knot weight (in [0.5, 2.0]) and weight degree (in [0.3, 1.1]).  As in
``scenes.py``, the geometry and blur come from ``seed`` and the side
colours from ``colour_seed`` alone; the weights come from a stream of their
own, ``(seed, WEIGHT_STREAM)``, so that ``seed`` gives the original's
geometry, blur and weights exactly.
"""

from __future__ import annotations

import numpy as np

from perfbench.scenes import N_CURVES, SEGMENTS_PER_CURVE, _curve_xml, _document

WEIGHT_STREAM = 1


def endcapped_scene_xml(seed: int, width: int, height: int, colour_seed: int) -> str:
    """Orzan curve_set XML of the endcapped scene at ``width`` x
    ``height``: ``scenes.seeded_scene_xml(seed, width, height,
    colour_seed)`` with ``use_endcap="true"`` and a weight and weight-degree
    table on every curve."""
    rng = np.random.default_rng(seed)
    colours = np.random.default_rng(colour_seed)
    weights = np.random.default_rng([seed, WEIGHT_STREAM])
    size = np.array([width, height], np.float64)
    step = 0.1 * min(width, height)
    curves = []
    for _ in range(N_CURVES):
        p = rng.uniform(0.2, 0.8, 2) * size
        heading = rng.uniform(0.0, 2.0 * np.pi)
        pts = [p.copy()]
        for _ in range(3 * SEGMENTS_PER_CURVE):
            heading += rng.normal(0.0, 0.25)
            p = np.clip(p + step * np.array([np.cos(heading), np.sin(heading)]), 0.0, size)
            pts.append(p.copy())
        rng.integers(0, 256, (4, 3))  # the geometry stream's colour draw, unused
        cols = colours.integers(0, 256, (4, 3))
        blur = rng.uniform(0.5, 2.0, 2)
        weight = tuple(float(v) for v in np.round(weights.uniform(0.5, 2.0, 2), 3))
        degree = tuple(float(v) for v in np.round(weights.uniform(0.3, 1.1, 2), 3))
        curves.append(
            _curve_xml(
                [tuple(q) for q in pts],
                left=(tuple(cols[0]), tuple(cols[1])),
                right=(tuple(cols[2]), tuple(cols[3])),
                blur=tuple(blur),
                weight=weight,
                weight_degree=degree,
                use_endcap=True,
            )
        )
    return _document(width, height, curves)
