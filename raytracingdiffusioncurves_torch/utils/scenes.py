"""A seeded test scene, generated in the repository.

The reference scene files are not shipped, so the port's checks render a
scene made from a seed: four curves of two cubic Bezier segments each,
drawn as gentle chains across the canvas, with random left/right colours
and nonzero blur on the curves' end knots.  At 1024^2 x 128 rays per pixel
it flattens to exactly 128 sub-segments (s_pad = 128), so it takes the
per-(tile, wedge) segment candidate lists of the main path.  The XML
follows the Orzan curve_set conventions of the JAX package's tests.

``endcapped_scene_xml`` is the same scene with the reference arch.xml's
features: endcaps on every curve and per-curve weight and weight degree.

``portal_weights_scene_xml`` is a small scene for the portal and
per-curve weight paths.

``dense_scene_xml`` draws line art of the density of the reference's
lady_bug and dolphin scenes (over a thousand, and several thousand,
sub-segments), which take the capped, distance-ordered candidate lists.

``portal_dense_scene_xml`` is the lady_bug drawing with one pair of portal
curves, the reference's portal extension at a dense scene's size.
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


def _seeded_curves(seed: int, width: int, height: int) -> list[dict]:
    """The seeded scene's curves in draw order, as ``_curve_xml``'s keyword
    arguments."""
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
        curves.append(dict(
            points=[tuple(q) for q in pts],
            left=(tuple(cols[0]), tuple(cols[1])),
            right=(tuple(cols[2]), tuple(cols[3])),
            blur=tuple(blur),
        ))
    return curves


def seeded_scene_xml(seed: int = 0, width: int = 1024, height: int = 1024) -> str:
    """Orzan curve_set XML of the seeded scene at ``width`` x ``height``
    (the geometry scales with the canvas, so every size is the same
    picture)."""
    return _document(width, height, [_curve_xml(**c) for c in _seeded_curves(seed, width, height)])


# The random stream of endcapped_scene_xml's weights: (seed, WEIGHT_STREAM),
# apart from the geometry's (seed).
WEIGHT_STREAM = 1


def endcapped_scene_xml(seed: int = 0, width: int = 1024, height: int = 1024) -> str:
    """The seeded scene with the features of the reference's arch.xml:
    geometry, colours and blur exactly ``seeded_scene_xml``'s, an endcap
    on every curve, and on each curve a two-knot weight (in [0.5, 2.0]) and
    weight degree (in [0.3, 1.1]), the ranges of ``portal_weights_scene_xml``,
    drawn from a stream of their own.  The eight endcap loops double the
    sub-segments (256 at 1024^2), past slot mode: the scene takes
    distance-ordered segment lists, uncapped."""
    weights = np.random.default_rng([seed, WEIGHT_STREAM])
    curves = []
    for c in _seeded_curves(seed, width, height):
        weight = tuple(float(v) for v in np.round(weights.uniform(0.5, 2.0, 2), 3))
        degree = tuple(float(v) for v in np.round(weights.uniform(0.3, 1.1, 2), 3))
        curves.append(_curve_xml(**c, weight=weight, weight_degree=degree, use_endcap=True))
    return _document(width, height, curves)


# Circle as cubic Bezier arcs: handle length for a quarter turn.
_KAPPA = 4.0 / 3.0 * (np.sqrt(2.0) - 1.0)


def _closed_outline(cx, cy, rx, ry, n_arcs=4, wobble=None):
    """Control points (3 * n_arcs + 1, closed) of an ellipse-like outline
    around (cx, cy); ``wobble`` (n_arcs,) scales each knot's radius."""
    wobble = np.ones(n_arcs) if wobble is None else wobble
    k = 4.0 / 3.0 * np.tan(np.pi / (2.0 * n_arcs))
    ang = 2.0 * np.pi * np.arange(n_arcs + 1) / n_arcs
    rad = np.append(wobble, wobble[0])
    knots = np.stack([cx + rx * rad * np.cos(ang), cy + ry * rad * np.sin(ang)], axis=1)
    tang = np.stack([-rx * rad * np.sin(ang), ry * rad * np.cos(ang)], axis=1) * k
    pts = [knots[0]]
    for i in range(n_arcs):
        pts += [knots[i] + tang[i], knots[i + 1] - tang[i + 1], knots[i + 1]]
    return [tuple(q) for q in pts]


def _strand(p0, heading, step, n_segs, rng, turn=0.2):
    """Control points of an open strand of ``n_segs`` cubic segments that
    starts at p0 and wanders along ``heading``."""
    p = np.asarray(p0, np.float64)
    pts = [p.copy()]
    for _ in range(3 * n_segs):
        heading += rng.normal(0.0, turn)
        p = p + step * np.array([np.cos(heading), np.sin(heading)])
        pts.append(p.copy())
    return [tuple(q) for q in pts]


def _aphid(centre, size, heading, rng):
    """Shapes of a small insect drawn around ``centre`` (pixels), its body
    ``size`` pixels from middle to tip, facing ``heading``: body and head
    outlines, six legs, two antennae, two tail tubes and two back stripes,
    20 cubic segments inside a circle of about 1.7 ``size``."""
    c, s = np.cos(heading), np.sin(heading)

    def loc(u, v):  # body frame (u along the heading) -> pixels
        return centre[0] + (u * c - v * s) * size, centre[1] + (u * s + v * c) * size

    def outline(u, ru, rv):
        return [loc(u + x, y) for x, y in _closed_outline(0.0, 0.0, ru, rv, 4)]

    shapes = [outline(0.0, 1.0, 0.65), outline(1.25, 0.32, 0.36)]
    for side in (-1.0, 1.0):
        for i in range(3):
            shapes.append(_strand(loc(-0.5 + 0.5 * i, side * 0.62),
                                  heading + side * (np.pi / 2 + 0.35 * (1 - i)),
                                  0.28 * size, 1, rng))
        shapes.append(_strand(loc(1.5, side * 0.2), heading + side * 0.6, 0.3 * size, 1, rng))
        shapes.append(_strand(loc(-0.9, side * 0.3), heading + np.pi - side * 0.4,
                              0.15 * size, 1, rng))
        shapes.append(_strand(loc(-0.6, side * 0.25), heading, 0.35 * size, 1, rng, turn=0.05))
    return shapes


def dense_scene_xml(seed: int = 0, width: int = 1920, height: int = 1088,
                    kind: str = "lady_bug", colour_seed: int | None = None) -> str:
    """Orzan curve_set XML of a seeded line drawing of a dense-scene class
    (geometry on a unit canvas scaled to ``width`` x ``height``; no portals;
    random side colours, nonzero blur).  A frame just inside the canvas
    closes the picture, so nearly every ray hits something near.

    ``kind="lady_bug"``: a beetle — frame, body and head outlines, a centre
    line, rows of spots on the wing cases, legs and antennae — and, in the
    empty corner behind its tail, an aphid a twentieth of its length: 94
    cubic segments, 1024 < s_pad <= 1536 under the default flattening at
    1920x1088 (2-level candidate lists of 256 slots).  The aphid's 320
    sub-segments fit inside one direction wedge of every tile that sees it
    from afar, so those cells' lists overflow, and the rays of such a cell
    that pass beside it look past the list's horizon.
    ``kind="dolphin"``: a field of scales between wavy strands: 460 cubic
    segments, 4096 < s_pad <= 9216 (4-level lists of 512 slots, the
    dense block geometry).

    ``colour_seed``: None draws the side colours from ``seed``'s stream
    with the geometry; a seed draws them from a stream of their own, the
    geometry stream making its colour draws all the same, so the geometry
    and blur stay ``seed``'s (the benchmark's frozen copy,
    ``perfbench/scenes.py``, always splits them so)."""
    if kind not in ("lady_bug", "dolphin"):
        raise ValueError(f"kind must be 'lady_bug' or 'dolphin', got {kind!r}")
    rng = np.random.default_rng(seed)
    colours = None if colour_seed is None else np.random.default_rng(colour_seed)
    size = np.array([width, height], np.float64)
    unit = float(min(width, height))
    centre = 0.5 * size
    shapes: list[list[tuple[float, float]]] = []

    def at(u, v):  # unit-canvas offsets from the centre -> pixels
        return centre[0] + u * unit, centre[1] + v * unit

    # the frame: four straight cubics, closed
    m = 0.02 * unit
    corners = [(m, m), (width - m, m), (width - m, height - m), (m, height - m), (m, m)]
    frame = [corners[0]]
    for a, b in zip(corners[:-1], corners[1:]):
        a, b = np.asarray(a), np.asarray(b)
        frame += [tuple(a + (b - a) / 3.0), tuple(a + 2.0 * (b - a) / 3.0), tuple(b)]
    shapes.append(frame)

    if kind == "lady_bug":
        bx, by = at(0.0, 0.03)
        shapes.append(_closed_outline(bx, by, 0.42 * unit, 0.33 * unit, 8,
                                      rng.uniform(0.97, 1.03, 8)))
        hx, hy = at(-0.50, 0.03)
        shapes.append(_closed_outline(hx, hy, 0.10 * unit, 0.13 * unit, 4))
        # centre line between the wing cases
        shapes.append(_strand(at(-0.40, 0.03), 0.0, 0.80 * unit / 6.0, 2, rng, turn=0.03))
        # spots: two rows on each wing case
        for row, v in enumerate((-0.17, -0.06, 0.12, 0.23)):
            for col in range(3):
                u = -0.24 + 0.22 * col + rng.uniform(-0.02, 0.02)
                r = rng.uniform(0.028, 0.045) * unit
                sx, sy = at(u, v + rng.uniform(-0.01, 0.01))
                shapes.append(_closed_outline(sx, sy, r, r * rng.uniform(0.8, 1.2), 4))
        # legs (three a side) and two antennae
        for side in (-1.0, 1.0):
            for i in range(3):
                u = -0.25 + 0.25 * i
                shapes.append(_strand(at(u, 0.03 + side * 0.33), side * (np.pi / 2 + 0.3 * (i - 1)),
                                      0.035 * unit, 1, rng))
            shapes.append(_strand(at(-0.58, 0.03 + side * 0.07), np.pi + side * 0.5,
                                  0.03 * unit, 1, rng))
        shapes += _aphid(at(0.62, -0.30), 0.016 * unit, 2.6, rng)
    else:
        # scales: a jittered grid of small closed outlines
        nx, ny = 12, 7
        for iy in range(ny):
            for ix in range(nx):
                u = (ix + 0.5 + 0.5 * (iy % 2)) / (nx + 0.5) * (width - 6 * m) + 3 * m
                v = (iy + 0.5) / ny * (height - 6 * m) + 3 * m
                r = rng.uniform(0.020, 0.030) * unit
                shapes.append(_closed_outline(u + rng.uniform(-0.008, 0.008) * unit,
                                              v + rng.uniform(-0.008, 0.008) * unit,
                                              r, r * rng.uniform(0.8, 1.2), 4,
                                              rng.uniform(0.9, 1.1, 4)))
        # wavy strands between the rows of scales: control points sampled
        # from a sine of random phase, low enough to stay clear of the scales
        n_pts = 3 * 15 + 1
        xs = np.linspace(3 * m, width - 3 * m, n_pts)
        for iy in range(ny + 1):
            v = iy / ny * (height - 6 * m) + 3 * m
            amp = rng.uniform(0.010, 0.018) * unit
            ys = v + amp * np.sin(rng.uniform(0.0, 2.0 * np.pi) + xs * rng.uniform(5.0, 9.0) / unit)
            shapes.append(list(zip(xs, ys + rng.normal(0.0, 0.001 * unit, n_pts))))

    curves = []
    for pts in shapes:
        # The picture is laid out in image space (column, row); an Orzan
        # save stores control points as (row, column), which the loader
        # swaps back (RenderConfig.diffusion_curve_save, the default).
        pts = [(float(np.clip(y, 0.0, height)), float(np.clip(x, 0.0, width))) for x, y in pts]
        cols = rng.integers(0, 256, (4, 3))
        if colours is not None:
            cols = colours.integers(0, 256, (4, 3))
        blur = rng.uniform(0.5, 2.0, 2)
        curves.append(
            _curve_xml(
                pts,
                left=(tuple(cols[0]), tuple(cols[1])),
                right=(tuple(cols[2]), tuple(cols[3])),
                blur=tuple(blur),
            )
        )
    return _document(width, height, curves)


# The random stream of portal_dense_scene_xml's portal pair: (seed,
# PORTAL_STREAM), apart from the drawing's (seed).
PORTAL_STREAM = 2
# The portal pair, each curve's ends in image space (column, row) as shares
# of the canvas: A in the left margin beside the head, B in the right
# margin below the aphid.
PORTAL_PAIR = (((0.06, 0.30), (0.06, 0.80)), ((0.90, 0.30), (0.90, 0.80)))


def portal_dense_scene_xml(seed: int = 0, width: int = 1920, height: int = 1080,
                           colour_seed: int | None = None) -> str:
    """The lady_bug drawing of ``dense_scene_xml(seed, width, height,
    "lady_bug", colour_seed)`` with the reference's portal extension as its
    PortalDemo.xml uses it: two straight one-cubic curves appended
    (``PORTAL_PAIR``), each ``connects`` to the other, with the default
    weights.  Their side colours (in [0, 255]) and blur (in [0.5, 2.0])
    come from streams of their own, ``(seed, PORTAL_STREAM)`` and, where
    ``colour_seed`` is given, ``(colour_seed, PORTAL_STREAM)`` for the
    colours, split as the drawing's are; so the drawing is
    ``dense_scene_xml``'s exactly.  Rays that meet a portal continue from
    the other one (``RenderConfig.max_trace_depth`` bounces), through the
    trace's full sweep of every sub-segment."""
    doc = dense_scene_xml(seed, width, height, "lady_bug", colour_seed)
    head, body = doc.split(">", 1)
    n = body.count("<curve ")
    rng = np.random.default_rng([seed, PORTAL_STREAM])
    colours = None if colour_seed is None else np.random.default_rng([colour_seed, PORTAL_STREAM])
    size = np.array([width, height], np.float64)
    portals = []
    for k, ends in enumerate(PORTAL_PAIR):
        a, b = (np.asarray(e, np.float64) * size for e in ends)
        # an Orzan save stores (row, column), as dense_scene_xml's curves
        pts = [(float(p[1]), float(p[0])) for p in (a + (b - a) * i / 3.0 for i in range(4))]
        cols = rng.integers(0, 256, (4, 3))
        if colours is not None:
            cols = colours.integers(0, 256, (4, 3))
        blur = rng.uniform(0.5, 2.0, 2)
        portals.append(_curve_xml(pts, left=(tuple(cols[0]), tuple(cols[1])),
                                  right=(tuple(cols[2]), tuple(cols[3])), blur=tuple(blur),
                                  connects=n + 1 - k))
    head = head.replace(f'nb_curves="{n}"', f'nb_curves="{n + 2}"')
    return head + ">" + body[: -len("</curve_set>")] + "".join(portals) + "</curve_set>"
