"""Orzan diffusion-curve XML loader.

Produces the same SoA scene schema as the reference's device upload
(``struct Params``, params.h:37-101), built by the scene loop in
optixHello.cpp:211-515 with helpers :1302-1351.  Bit-for-bit table parity is
the goal here — including the reference's quirks (trailing color duplication,
endcap color slot permutation, ``globalID/10 (+1 with endcap)`` knot
positions) — because the attribute tables are a *spec*, not an algorithm.

One deliberate representation change: segments are kept as cubic **Bezier**
control points.  The reference converts to B-spline control points
(optixHello.cpp:76-79) only because OptiX's built-in primitive is a B-spline;
both trace the identical curve (proved in tests/test_geometry.py).
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np

from ..utils.timing import spanned
from . import geometry


@dataclasses.dataclass
class AttrTable:
    """CSR-style per-curve attribute table (params.h:72-92): for curve c,
    knots ``u[start:start+count]`` and values ``values[start:start+count]``
    with ``start, count = index[c]``."""

    index: np.ndarray  # (n_curves, 2) int64: (start, count)
    u: np.ndarray  # (total,) float32 knot positions in curve_u space
    values: np.ndarray  # (total, C) float32

    @property
    def channels(self) -> int:
        return self.values.shape[1]


@dataclasses.dataclass
class SceneTables:
    """Host-side scene: the complete device-visible world of the reference."""

    width: int
    height: int
    # (n_segments, 4, 2) cubic Bezier control points, scene-centered coords.
    vertices: np.ndarray
    # (n_segments,) curve id of each segment (params.h:65).
    curve_map: np.ndarray
    # (n_segments,) position of the segment within its curve (params.h:66).
    curve_index: np.ndarray
    # (n_curves,) portal target curve id or -1 (params.h:69).
    curve_connect: np.ndarray
    # (n_curves,) first global segment id of each curve (params.h:70).
    curve_first_segment: np.ndarray
    # (n_curves,) number of segments in each curve (incl. endcaps).
    curve_segment_count: np.ndarray

    color_left: AttrTable
    color_right: AttrTable
    blur: AttrTable
    weight: AttrTable
    weight_degree: AttrTable

    diffusion_curve_save: bool = True

    def with_size(self, width: int, height: int) -> "SceneTables":
        """A copy of this scene rendered at ``width`` x ``height`` pixels.

        The scene geometry lives in scene-centered world units (the camera
        maps pixels to world, DeviceCode.cu:103-107), so overriding the
        canvas size is purely a viewport change — the table arrays are
        shared, not copied.
        """
        return dataclasses.replace(self, width=int(width), height=int(height))

    @property
    def n_segments(self) -> int:
        return self.vertices.shape[0]

    @property
    def n_curves(self) -> int:
        return self.curve_connect.shape[0]

    @property
    def has_portals(self) -> bool:
        return bool((self.curve_connect >= 0).any())

    @property
    def max_blur(self) -> float:
        return float(self.blur.values.max(initial=0.0))


class _AttrBuilder:
    """Accumulates one attribute across curves, mirroring the reference's
    ``std::vector`` + index bookkeeping."""

    def __init__(self, channels: int):
        self.channels = channels
        self.index: list[list[int]] = []  # per curve [start, count]
        self.u: list[float] = []
        self.values: list = []

    def begin_curve(self):
        self.index.append([len(self.u), 0])

    def push(self, u: float, value):
        self.u.append(float(u))
        self.values.append(value)
        self.index[-1][1] += 1

    def finish(self) -> AttrTable:
        vals = np.asarray(self.values, dtype=np.float32).reshape(-1, self.channels)
        return AttrTable(
            index=np.asarray(self.index, dtype=np.int64).reshape(-1, 2),
            u=np.asarray(self.u, dtype=np.float32),
            values=vals,
        )


def _read_point(node: ET.Element, width: int, height: int, save: bool) -> np.ndarray:
    """Read a control point, swapping x<->y for diffusion-curve saves and
    centering on the image (optixHello.cpp:1318-1325)."""
    x = float(node.get("y" if save else "x")) - width // 2
    y = float(node.get("x" if save else "y")) - height // 2
    return np.array([x, y], dtype=np.float32)


def _read_color(node: ET.Element, save: bool) -> list[float]:
    """Read an RGB color, swapping R<->B for diffusion-curve saves
    (optixHello.cpp:1302-1311). The reference parses channels with atoi."""
    return [
        int(float(node.get("B" if save else "R"))) / 255.0,
        int(float(node.get("G"))) / 255.0,
        int(float(node.get("R" if save else "B"))) / 255.0,
    ]


def _attr_u(node: ET.Element, use_endcap: bool) -> float:
    """Knot position: globalID/10, shifted +1 when the curve has endcaps
    (optixHello.cpp:1303,1347)."""
    return float(node.get("globalID")) / 10.0 + (1.0 if use_endcap else 0.0)


@spanned("scene.parse")
def load_scene(
    path: str,
    diffusion_curve_save: bool = True,
    endcap_size: float = 8.0,
    default_weight_degree: float = 0.5,
    suppress_endcaps: bool = False,
) -> SceneTables:
    """Parse an Orzan-format diffusion-curve XML into ``SceneTables``.

    Mirrors the scene loop optixHello.cpp:211-515.  Parsed by the C++
    loader (scene/native/loader.cpp, built with g++ at first use) where it
    builds, else by this module's parser; both give bitwise equal tables
    (tests/test_torch_native_loader.py).
    ``suppress_endcaps`` ignores every curve's ``use_endcap`` (the
    reference's USE_ENDCAP compile-time define set to false, params.hpp —
    how ``screencaps/no_cap.png`` was produced): no cap geometry AND no
    +1 knot shift.
    """
    from . import native_loader

    if native_loader.available():
        return native_loader.load_scene_native(
            path,
            diffusion_curve_save=diffusion_curve_save,
            endcap_size=endcap_size,
            default_weight_degree=default_weight_degree,
            suppress_endcaps=suppress_endcaps,
        )
    root = ET.parse(path).getroot()
    return build_scene(
        root,
        diffusion_curve_save=diffusion_curve_save,
        endcap_size=endcap_size,
        default_weight_degree=default_weight_degree,
        suppress_endcaps=suppress_endcaps,
    )


@spanned("scene.parse")
def load_scene_from_string(text: str, **kwargs) -> SceneTables:
    return build_scene(ET.fromstring(text), **kwargs)


def build_scene(
    curve_set: ET.Element,
    diffusion_curve_save: bool = True,
    endcap_size: float = 8.0,
    default_weight_degree: float = 0.5,
    suppress_endcaps: bool = False,
) -> SceneTables:
    save = diffusion_curve_save
    width = int(curve_set.get("image_width"))
    height = int(curve_set.get("image_height"))

    vertices: list[np.ndarray] = []  # (4,2) per segment
    curve_map: list[int] = []
    curve_index: list[int] = []
    curve_connect: list[int] = []
    curve_first_segment: list[int] = []
    curve_segment_count: list[int] = []

    color_left = _AttrBuilder(3)
    color_right = _AttrBuilder(3)
    blur = _AttrBuilder(1)
    weight = _AttrBuilder(1)
    weight_degree = _AttrBuilder(1)

    n_segments_total = 0

    for curve_id, curve in enumerate(curve_set):
        ctrl_nodes = list(curve.find("control_points_set"))
        use_endcap = (
            not suppress_endcaps
            and (curve.get("use_endcap") or "") == "true"
        )
        curve_connect.append(int(curve.get("connects", "-1")))
        curve_first_segment.append(n_segments_total)

        points = np.stack([_read_point(n, width, height, save) for n in ctrl_nodes])
        # Segments take points [3i : 3i+4] (push4Points advances 3 per call,
        # optixHello.cpp:277-286,1314-1332).
        n_interior = (len(points) - 1) // 3
        seg_points = [points[3 * i : 3 * i + 4] for i in range(n_interior)]

        curve_segment = 0

        def emit_segment(bezier4: np.ndarray):
            nonlocal curve_segment
            vertices.append(np.asarray(bezier4, np.float32))
            curve_map.append(curve_id)
            curve_index.append(curve_segment)
            curve_segment += 1

        # Start endcap: degenerate loop at the first point, bulging against
        # the reversed start tangent (optixHello.cpp:229-274).
        if use_endcap:
            emit_segment(
                geometry.make_endcap_segment(seg_points[0], at_start=True, endcap_size=endcap_size)
            )
        for sp in seg_points:
            emit_segment(sp)
        # End endcap: same at the last point, tangent at t = 1 - 1e-3
        # (optixHello.cpp:290-329).
        if use_endcap:
            emit_segment(
                geometry.make_endcap_segment(seg_points[-1], at_start=False, endcap_size=endcap_size)
            )

        n_curve_segs = curve_segment

        # ---- colors (optixHello.cpp:332-410) ----
        color_left.begin_curve()
        color_right.begin_curve()
        lstart = color_left.index[-1][0]
        rstart = color_right.index[-1][0]

        # Reserve endcap color slots; counts are bumped later (:338-348).
        if use_endcap:
            for b, u0 in ((color_right, 0.0), (color_right, 1.0)):
                b.u.append(u0)
                b.values.append([0.0, 0.0, 0.0])
            for b, u0 in ((color_left, 0.0), (color_left, 1.0)):
                b.u.append(u0)
                b.values.append([0.0, 0.0, 0.0])

        for node in curve.find("left_colors_set"):
            color_left.push(_attr_u(node, use_endcap), _read_color(node, save))
        for node in curve.find("right_colors_set"):
            color_right.push(_attr_u(node, use_endcap), _read_color(node, save))

        # Diffusion-curve saves duplicate the last color at the end-of-curve
        # parameter so interpolation covers the full u range (:370-378).
        if save:
            dup_u = n_curve_segs - (1 if use_endcap else 0)
            color_right.push(dup_u, list(color_right.values[-1]))
            color_left.push(dup_u, list(color_left.values[-1]))

        # Endcap color permutation: caps inherit the adjacent interior colors
        # (:382-407).  Transcribed literally; indices are into the *global*
        # value lists exactly as the reference indexes its std::vectors.
        if use_endcap:
            L, R = color_left.values, color_right.values
            L[lstart] = list(L[lstart + 2])
            L[lstart + 1] = list(R[rstart + 2])
            color_left.index[-1][1] += 2
            R[rstart] = list(L[lstart + 2])
            R[rstart + 1] = list(R[rstart + 2])
            color_right.index[-1][1] += 2

            L.append(list(R[-1]))
            L.append(list(L[-2]))
            color_left.index[-1][1] += 2
            R.append(list(R[-1]))
            R.append(list(L[-3]))
            color_right.index[-1][1] += 2

            color_right.u.extend([n_curve_segs - 1.0, float(n_curve_segs)])
            color_left.u.extend([n_curve_segs - 1.0, float(n_curve_segs)])

        # ---- blur (:413-437) ----
        blur.begin_curve()
        bstart = blur.index[-1][0]
        if use_endcap:
            blur.push(0.0, [0.0])
        for node in curve.find("blur_points_set"):
            blur.push(_attr_u(node, use_endcap), [float(node.get("value"))])
        if use_endcap:
            blur.values[bstart] = list(blur.values[bstart + 1])
            blur.push(float(n_curve_segs), list(blur.values[-1]))

        # ---- weight multiplier (:440-474) ----
        weight.begin_curve()
        wstart = weight.index[-1][0]
        wset = curve.find("weight_set")
        if wset is not None:
            if use_endcap:
                weight.push(0.0, [0.0])
            for node in wset:
                weight.push(_attr_u(node, use_endcap), [float(node.get("w"))])
            if use_endcap:
                weight.values[wstart] = list(weight.values[wstart + 1])
                weight.push(float(n_curve_segs), list(weight.values[-1]))
        else:
            weight.push(0.0, [1.0])
            weight.push(float(n_curve_segs), [1.0])

        # ---- weight degree (:477-511) ----
        weight_degree.begin_curve()
        dstart = weight_degree.index[-1][0]
        dset = curve.find("weight_degree_set")
        if dset is not None:
            if use_endcap:
                weight_degree.push(0.0, [default_weight_degree])
            for node in dset:
                weight_degree.push(_attr_u(node, use_endcap), [float(node.get("w"))])
            if use_endcap:
                weight_degree.values[dstart] = list(weight_degree.values[dstart + 1])
                weight_degree.push(float(n_curve_segs), list(weight_degree.values[-1]))
        else:
            weight_degree.push(0.0, [default_weight_degree])
            weight_degree.push(float(n_curve_segs), [default_weight_degree])

        curve_segment_count.append(n_curve_segs)
        n_segments_total += n_curve_segs

    return SceneTables(
        width=width,
        height=height,
        vertices=np.stack(vertices).astype(np.float32),
        curve_map=np.asarray(curve_map, np.int32),
        curve_index=np.asarray(curve_index, np.int32),
        curve_connect=np.asarray(curve_connect, np.int32),
        curve_first_segment=np.asarray(curve_first_segment, np.int32),
        curve_segment_count=np.asarray(curve_segment_count, np.int32),
        color_left=color_left.finish(),
        color_right=color_right.finish(),
        blur=blur.finish(),
        weight=weight.finish(),
        weight_degree=weight_degree.finish(),
        diffusion_curve_save=save,
    )


def interpolate_table(table: AttrTable, curve: int, u: float) -> np.ndarray:
    """Piecewise-linear attribute lookup with the reference's exact scan
    semantics (``interpolate``, DeviceCode.cu:36-44): starting at the curve's
    first knot, advance while ``ind < start+count`` and ``us[ind+1] < u``,
    then lerp values[ind] -> values[ind+1] by (u-us[ind])/(us[ind+1]-us[ind]).
    Note the scan may step one slot past the curve's own knots when u exceeds
    them all (a latent reference behaviour we reproduce deliberately)."""
    start, count = int(table.index[curve][0]), int(table.index[curve][1])
    us, vals = table.u, table.values
    ind = start
    while ind < start + count and ind + 1 < len(us) and us[ind + 1] < u:
        ind += 1
    ind1 = min(ind + 1, len(us) - 1)
    denom = us[ind1] - us[ind]
    ratio = (u - us[ind]) / denom if denom != 0 else 0.0
    return vals[ind] * (1.0 - ratio) + vals[ind1] * ratio
