"""A seeded test scene, generated in the repository.

The reference scene files are not shipped, so the port's checks render a
scene made from a seed: four curves of two cubic Bezier segments each,
drawn as gentle chains across the canvas, with random left/right colours
and nonzero blur on the curves' end knots.  At 1024^2 x 128 rays per pixel
it flattens to exactly 128 sub-segments (s_pad = 128), so it takes the
per-(tile, wedge) segment candidate lists of the main path.  The XML
follows the Orzan curve_set conventions of the JAX package's tests.

``portal_weights_scene_xml`` is a second, small scene for the portal and
per-curve weight paths.
"""

from __future__ import annotations

import numpy as np

N_CURVES = 4
SEGMENTS_PER_CURVE = 2


def _curve_xml(points, left, right, blur, weight=None, weight_degree=None,
               use_endcap=False, connects=None) -> str:
    n_segs = (len(points) - 1) // 3
    end = 10 * n_segs  # globalID of the last knot (u = globalID / 10)
    attrs = f'use_endcap="{"true" if use_endcap else "false"}"'
    if connects is not None:
        attrs += f' connects="{connects}"'
    parts = [f"<curve {attrs}>", "<control_points_set>"]
    parts += [f'<control_point x="{x:.2f}" y="{y:.2f}"/>' for x, y in points]
    parts.append("</control_points_set>")
    for tag_set, tag, (c0, c1) in (
        ("left_colors_set", "left_color", left),
        ("right_colors_set", "right_color", right),
    ):
        parts.append(f"<{tag_set}>")
        for gid, (r, g, b) in ((0, c0), (end, c1)):
            parts.append(f'<{tag} R="{r}" G="{g}" B="{b}" globalID="{gid}"/>')
        parts.append(f"</{tag_set}>")
    parts.append("<blur_points_set>")
    parts += [
        f'<best_scale value="{v:.3f}" globalID="{gid}"/>'
        for gid, v in ((0, blur[0]), (end, blur[1]))
    ]
    parts.append("</blur_points_set>")
    for tag_set, tag, knots in (
        ("weight_set", "weight", weight),
        ("weight_degree_set", "weight_degree", weight_degree),
    ):
        if knots is not None:
            parts.append(f"<{tag_set}>")
            parts += [
                f'<{tag} w="{v}" globalID="{gid}"/>' for gid, v in ((0, knots[0]), (end, knots[1]))
            ]
            parts.append(f"</{tag_set}>")
    parts.append("</curve>")
    return "".join(parts)


def _document(width: int, height: int, curves: list[str]) -> str:
    return (
        f'<curve_set image_width="{width}" image_height="{height}" '
        f'nb_curves="{len(curves)}">' + "".join(curves) + "</curve_set>"
    )


def portal_weights_scene_xml(width: int = 256, height: int = 256) -> str:
    """A small scene for the paths the main-path scene does not take: two
    portal curves that connect to each other among four striped curves
    (continuation rays), plus an endcapped curve with varying weight and
    weight degree (the generic wm * t^-wd weight).  Geometry is laid out on
    a 64-unit grid and scaled to the canvas."""
    sx, sy = width / 64.0, height / 64.0

    def pts(*p):
        return [(x * sx, y * sy) for x, y in p]

    white = ((255, 255, 255), (255, 255, 255))
    curves = [
        _curve_xml(pts((10 + i, 5), (12 + i, 25), (14 + i, 45), (16 + i, 60)),
                   left=((255, 40, 0), (0, 40, 255)), right=white, blur=(0.5, 1.5))
        for i in range(0, 12, 3)
    ]
    curves.append(_curve_xml(pts((30, 10), (32, 20), (34, 30), (36, 40)),
                             left=((128, 255, 0), (128, 255, 0)), right=white,
                             blur=(0.0, 0.0), connects=5))
    curves.append(_curve_xml(pts((50, 10), (52, 20), (54, 30), (56, 40)),
                             left=white, right=white, blur=(0.0, 0.0), connects=4))
    curves.append(_curve_xml(pts((0, 50), (20, 52), (40, 48), (60, 50)),
                             left=((200, 10, 50), (10, 10, 200)),
                             right=((0, 255, 0), (255, 255, 0)), blur=(1.0, 3.0),
                             weight=(0.5, 2.0), weight_degree=(0.3, 1.1), use_endcap=True))
    return _document(width, height, curves)


def seeded_scene_xml(seed: int = 0, width: int = 1024, height: int = 1024) -> str:
    """Orzan curve_set XML of the seeded scene at ``width`` x ``height``
    (the geometry scales with the canvas, so every size is the same
    picture)."""
    rng = np.random.default_rng(seed)
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
        cols = rng.integers(0, 256, (4, 3))
        blur = rng.uniform(0.5, 2.0, 2)
        curves.append(
            _curve_xml(
                [tuple(q) for q in pts],
                left=(tuple(cols[0]), tuple(cols[1])),
                right=(tuple(cols[2]), tuple(cols[3])),
                blur=tuple(blur),
            )
        )
    return _document(width, height, curves)
