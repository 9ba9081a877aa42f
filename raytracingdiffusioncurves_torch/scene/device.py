"""SceneTables -> DeviceScene: the scene tables the trace kernels read.

Design (replaces OptiX's BVH + implicit B-spline intersector,
optixHello.cpp:764-830 + DeviceCode.cu), identical to the JAX package's
``scene/device.py`` so both packages trace the same tables bit for bit:

* Every cubic Bezier segment is flattened into straight line *sub-segments*.
  Breakpoints are the union of ``flatten_subdivisions`` uniform parameter
  values and every attribute knot that falls inside the segment, so the
  piecewise-linear attribute tables (DeviceCode.cu:36-44) are reproduced
  *exactly* by lerping precomputed endpoint values — no per-hit knot search
  on device.

* Ray/sub-segment intersection is bilinear in per-ray and per-segment
  quantities: with e = p1 - p0 the three cross products of the 2x2 solve
  are a handful of multiply-adds per (ray, segment) pair.  ``seg_consts``
  holds the per-segment coefficients.

* Everything a hit needs to shade (normals, colors, blur/weight tables,
  portal exit geometry, refinement control points) is one column of
  ``shade_all_t`` (ALLT_ROWS, S_pad), read by the winner's segment id.

* The CUDA trace kernel reads the same values as packed per-segment
  records, built once per scene from those two tables (``pack_records``):
  ``walk_records`` (S_pad, WALK_COLS), the seg_consts columns of the
  per-pair test and the segment's id, 32 bytes that a warp stages into
  shared memory with two 16-byte copies; ``shade_records`` (S_pad,
  ALLT_ROWS), shade_all_t's columns made contiguous, so a winner's values
  arrive as 16-byte loads.

The tables are built in numpy float64 exactly as the JAX package builds
them, rounded once to float32 and moved to a torch device.  Padding rows
are invalid and can never be hit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.devices import resolve_device
from ..utils import timing
from . import geometry
from .xml_loader import AttrTable, SceneTables

# --- shade_table column layout ---
# fmt: off
COL_D0X, COL_D0Y, COL_D1X, COL_D1Y = 0, 1, 2, 3          # curve derivative at ends
COL_CL0, COL_CL1 = 4, 7                                   # left color rgb at ends
COL_CR0, COL_CR1 = 10, 13                                 # right color rgb at ends
COL_BLUR0, COL_BLUR1 = 16, 17
COL_WM0, COL_WM1 = 18, 19                                 # weight multiplier
COL_WD0, COL_WD1 = 20, 21                                 # weight degree
COL_PORTAL = 22                                           # 1.0 if curve connects
COL_EXP0X, COL_EXP0Y, COL_EXP1X, COL_EXP1Y = 23, 24, 25, 26  # portal exit pos
COL_EXD0X, COL_EXD0Y, COL_EXD1X, COL_EXD1Y = 27, 28, 29, 30  # exit derivative
COL_VALID = 31
SHADE_COLS = 32
# fmt: on

# --- seg_consts column layout: per-segment intersection coefficients ---
# Solving o + t*d = p0 + s*e (e = p1 - p0), with cross(a,b) = ax*by - ay*bx:
#   denom = cross(d, e) =  dx*ey - dy*ex
#   num_t = cross(p0-o, e) = C1 - ox*ey + oy*ex,   C1 = p0x*ey - p0y*ex
#   num_s = cross(p0-o, d) = dy*p0x - dx*p0y + (oy*dx - ox*dy)
#   t = num_t/denom, s = num_s/denom
CONST_EX, CONST_EY, CONST_C1, CONST_P0X, CONST_P0Y, CONST_VALID = 0, 1, 2, 3, 4, 5
# Conservative capsule band: max distance from the exact cubic (over the
# sub-segment's parameter window) to its chord segment, plus the reference's
# tube radius curve_width = 1e-3 (optixHello.cpp:95).  The exact-silhouette
# sweep widens its acceptance by this much and lets Newton's residual decide
# hit/miss, so hit/miss no longer follows the flattening chords.
CONST_BAND = 6
# Quadratic ordering correction: 4 * cross(e, B(mid) - p0) — the signed
# apex deviation of the parabola through the window's endpoints and
# midpoint, premultiplied so the sweep's ordering key becomes
# t_est = (num_t - QUAD * s(1-s)) / denom, a 2nd-order-accurate hit
# distance.  Chord-t ordering errors of up to the full sagitta made the
# closest-crossing winner flip sides along silhouette grazings; the
# parabola correction shrinks that by ~an order of magnitude.
CONST_QUAD = 7
CONST_COLS = 9

# shade_all_t rows: SHADE_COLS shade rows, the 5 geometry consts, then the
# hit-refinement block: source cubic control points (8), portal target cubic
# control points (8), and the sub-segment's parameter window [t0, dt] (2).
ALLT_CONSTS = SHADE_COLS  # rows 32..36: EX, EY, C1, P0X, P0Y
ALLT_SRC_CTRL = 37  # rows 37..44: x0,y0,x1,y1,x2,y2,x3,y3
ALLT_TGT_CTRL = 45  # rows 45..52: portal target control points
ALLT_T0, ALLT_DT = 53, 54  # cubic parameter window of the sub-segment
# The winner's silhouette band (CONST_BAND), needed post-gather by the
# exact-silhouette root isolation to widen its parameter window so crossings
# just beyond a window edge resolve identically no matter which adjacent
# candidate won the (near-tied) sweep ordering — the backends' ordering keys
# round differently, and without the margin those ties flipped hit/side.
ALLT_BAND = 55
ALLT_ROWS = 64  # row count of shade_all_t, as in the JAX package

# walk_records columns: the seg_consts columns the kernel's per-pair test
# reads, then the segment id (int32 bits in a float32 slot).
WALK_CONST_COLS = (CONST_EX, CONST_EY, CONST_C1, CONST_P0X, CONST_P0Y, CONST_BAND, CONST_QUAD)
WALK_ID = 7
WALK_COLS = 8

# Sub-segment counts pad to this granularity (the chunk of the JAX package's
# culling sweep; kept so s_pad and chunk_bounds match it).
SEG_ALIGN = 64


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


ARRAY_FIELDS = ("seg_consts", "shade_table", "shade_all_t", "chunk_bounds")
META_FIELDS = (
    "width", "height", "n_sub", "s_pad", "has_portals", "max_blur",
    "uniform_wd", "uniform_wm",
)


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """Scene as consumed by the trace kernels: four float32 tensors on one
    device plus scalar metadata (the same fields as the JAX package's
    DeviceScene), and the CUDA kernel's packed records of two of them
    (pack_records)."""

    seg_consts: torch.Tensor  # (S_pad, CONST_COLS) f32
    shade_table: torch.Tensor  # (S_pad, SHADE_COLS) f32
    shade_all_t: torch.Tensor  # (ALLT_ROWS, S_pad) f32: shade_table.T + consts
    # (S_pad/SEG_ALIGN, 4) f32 bounding circles [cx, cy, radius, 0] per
    # segment chunk (bands included).
    chunk_bounds: torch.Tensor
    walk_records: torch.Tensor  # (S_pad, WALK_COLS) f32
    shade_records: torch.Tensor  # (S_pad, ALLT_ROWS) f32: shade_all_t.T
    width: int
    height: int
    n_sub: int
    s_pad: int
    has_portals: bool
    max_blur: float
    # Set when every sub-segment carries the same weight degree / weight
    # multiplier (most scenes: 0.5 and 1, optixHello.cpp:94,466-472);
    # None = mixed.  Metadata only: the kernels read the per-hit values.
    uniform_wd: float | None = None
    uniform_wm: float | None = None

    @property
    def device(self) -> torch.device:
        return self.seg_consts.device


def pack_records(seg_consts: torch.Tensor, shade_all_t: torch.Tensor) -> dict[str, torch.Tensor]:
    """The CUDA kernel's per-segment records, bit copies of the scene
    tables on their device: ``walk_records`` (S_pad, WALK_COLS) holds
    seg_consts' WALK_CONST_COLS and, in column WALK_ID, the segment's index
    as int32 bits; ``shade_records`` (S_pad, ALLT_ROWS) is shade_all_t
    transposed, contiguous."""
    s_pad = seg_consts.shape[0]
    walk = torch.empty((s_pad, WALK_COLS), dtype=torch.float32, device=seg_consts.device)
    walk[:, :WALK_ID] = seg_consts[:, list(WALK_CONST_COLS)]
    walk.view(torch.int32)[:, WALK_ID] = torch.arange(
        s_pad, dtype=torch.int32, device=seg_consts.device
    )
    return {"walk_records": walk, "shade_records": shade_all_t.T.contiguous()}


def from_jax_arrays(
    arrays: dict[str, np.ndarray], meta: dict, device=None
) -> DeviceScene:
    """DeviceScene from the JAX package's tables: ``arrays`` maps the four
    array field names to numpy arrays (``np.asarray`` of the JAX scene's
    fields), ``meta`` the metadata field names to their values.  The scene
    tables play the role weights play in a model: this carries a scene
    built by the JAX package across unchanged, bit for bit."""
    dev = resolve_device(device)
    tensors = {
        f: torch.from_numpy(np.array(arrays[f], np.float32, order="C")).to(dev)
        for f in ARRAY_FIELDS
    }
    m = {f: meta[f] for f in META_FIELDS}
    return DeviceScene(
        **tensors,
        **pack_records(tensors["seg_consts"], tensors["shade_all_t"]),
        width=int(m["width"]),
        height=int(m["height"]),
        n_sub=int(m["n_sub"]),
        s_pad=int(m["s_pad"]),
        has_portals=bool(m["has_portals"]),
        max_blur=float(m["max_blur"]),
        uniform_wd=None if m["uniform_wd"] is None else float(m["uniform_wd"]),
        uniform_wm=None if m["uniform_wm"] is None else float(m["uniform_wm"]),
    )


def _capsule_bands(rr: np.ndarray, p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """Conservative max distance from each sub-segment's exact cubic to its
    chord segment (float64, build time).

    ``rr`` is the stacked refine rows: source control points x0,y0..x3,y3 at
    [:8], the parameter window t0 at [16] and dt at [17].  Dense sampling
    plus an analytic second-derivative pad keeps the bound conservative
    between samples; the reference's tube radius curve_width = 1e-3
    (optixHello.cpp:95) is folded in.
    """
    n = rr.shape[0]
    cx = rr[:, 0:8:2]  # (n, 4)
    cy = rr[:, 1:8:2]
    t0 = rr[:, 16]
    dt = rr[:, 17]
    k = 33
    taus = t0[:, None] + dt[:, None] * np.linspace(0.0, 1.0, k)[None, :]
    mt = 1.0 - taus
    b0 = mt**3
    b1 = 3.0 * mt**2 * taus
    b2 = 3.0 * mt * taus**2
    b3 = taus**3
    bx = b0 * cx[:, :1] + b1 * cx[:, 1:2] + b2 * cx[:, 2:3] + b3 * cx[:, 3:4]
    by = b0 * cy[:, :1] + b1 * cy[:, 1:2] + b2 * cy[:, 2:3] + b3 * cy[:, 3:4]
    # point-to-segment distance
    e = p1 - p0  # (n, 2)
    ee = np.maximum((e * e).sum(axis=1), 1e-30)[:, None]
    px = bx - p0[:, :1]
    py = by - p0[:, 1:2]
    s = np.clip((px * e[:, :1] + py * e[:, 1:2]) / ee, 0.0, 1.0)
    ddx = px - s * e[:, :1]
    ddy = py - s * e[:, 1:2]
    d_samp = np.sqrt(ddx * ddx + ddy * ddy).max(axis=1)
    # between-samples pad: |B(tau)| deviates from the sampled piecewise-
    # linear by at most |B''|_max * (dtau/2)^2 / 2 over each sample gap.
    a2x = np.abs(cx[:, 2] - 2 * cx[:, 1] + cx[:, 0])
    a2y = np.abs(cy[:, 2] - 2 * cy[:, 1] + cy[:, 0])
    b2x = np.abs(cx[:, 3] - 2 * cx[:, 2] + cx[:, 1])
    b2y = np.abs(cy[:, 3] - 2 * cy[:, 2] + cy[:, 1])
    bpp = 6.0 * np.sqrt(
        np.maximum(a2x, b2x) ** 2 + np.maximum(a2y, b2y) ** 2
    )  # global-parameter second-derivative bound
    pad = bpp * (np.abs(dt) / (k - 1) / 2.0) ** 2 / 2.0
    return d_samp + pad + 1e-3


def _attr_limits(table: AttrTable, curve: int, u0: float, u1: float) -> tuple[np.ndarray, np.ndarray]:
    """Values of the piecewise-linear attribute at u0 and u1, using the linear
    piece that covers the open interval (u0, u1).

    The interval never straddles a knot (knots are flattening breakpoints), so
    locating the piece at the midpoint and evaluating its linear form at both
    endpoints yields the exact one-sided limits — this matches the reference's
    scan (DeviceCode.cu:36-44) for every u strictly inside the interval.
    """
    start, count = int(table.index[curve][0]), int(table.index[curve][1])
    us, vals = table.u, table.values
    mid = 0.5 * (u0 + u1)
    # Literal reference scan (DeviceCode.cu:39-41).  It must NOT be replaced
    # by a binary search: shipped scenes contain non-monotonic knot sequences
    # (e.g. lady_bug.xml left colors, dolphin.xml blur) and the linear scan's
    # behaviour on those is part of the spec.
    ind = start
    while ind < start + count and ind + 1 < len(us) and us[ind + 1] < mid:
        ind += 1
    ind1 = min(ind + 1, len(us) - 1)
    denom = float(us[ind1]) - float(us[ind])
    if denom == 0.0:
        return vals[ind].astype(np.float64), vals[ind].astype(np.float64)
    v0, v1 = vals[ind].astype(np.float64), vals[ind1].astype(np.float64)
    r0 = (u0 - float(us[ind])) / denom
    r1 = (u1 - float(us[ind])) / denom
    return v0 + (v1 - v0) * r0, v0 + (v1 - v0) * r1


def _segment_breakpoints(scene: SceneTables, seg: int, k: int) -> np.ndarray:
    """Parameter breakpoints in [0, 1] for flattening segment ``seg``: K
    uniform intervals plus every attribute knot interior to the segment."""
    curve = int(scene.curve_map[seg])
    base_u = float(scene.curve_index[seg])
    ts = set(np.linspace(0.0, 1.0, k + 1).tolist())
    for table in (scene.color_left, scene.color_right, scene.blur, scene.weight, scene.weight_degree):
        start, count = int(table.index[curve][0]), int(table.index[curve][1])
        for knot in table.u[start : start + count]:
            t = float(knot) - base_u
            if 1e-6 < t < 1.0 - 1e-6:
                ts.add(t)
    return np.array(sorted(ts), dtype=np.float64)


def build_device_scene(
    scene: SceneTables,
    flatten_subdivisions: int = 16,
    max_sagitta: float = 0.25,
    min_subdivisions: int | None = None,
    device=None,
) -> DeviceScene:
    """Flatten a loaded scene into the device tables (on ``device``,
    default CUDA; raises when CUDA is requested and absent).

    ``min_subdivisions``: the per-segment subdivision FLOOR.  Default (None)
    keeps ``flatten_subdivisions`` as the floor (every cubic gets at least
    that many chords, however straight).  Dense scenes pass a small floor
    (2-4) to let the bounded-sagitta rule alone size each segment: hit/miss
    and hit attributes stay exact regardless (exact silhouettes: band-widened
    sweep + root isolation decide against the true cubic; attribute knots
    remain flattening breakpoints, so endpoint attribute limits are exact) —
    only closest-hit ordering near quantized-key ties can flip, the same
    MC-noise class as backend transcendental differences.  Measured: dolphin
    28.8k -> 11.5k sub-segments, lady_bug 2.6k -> 1.3k.

    Recorded as the span ``scene.build_device`` with the attributes
    ``sub_segments``, ``endcap_sub_segments`` (those of the curves' endcap
    loops), ``weighted_curves`` (curves whose weight or weight-degree
    table leaves the defaults 1 and 0.5), ``portal_curves`` (curves that
    connect to another) and ``portal_sub_segments`` (theirs)."""
    with timing.span("scene.build_device") as sp:
        out, subs = _build_device_scene(scene, flatten_subdivisions, max_sagitta,
                                        min_subdivisions, device)
        if sp is not timing.NOOP:  # counted only while the recorder is on
            portal = scene.curve_connect >= 0
            sp.set(sub_segments=out.n_sub,
                   endcap_sub_segments=int(subs[endcap_segments(scene)].sum()),
                   weighted_curves=weighted_curves(scene),
                   portal_curves=int(portal.sum()),
                   portal_sub_segments=int(subs[portal[scene.curve_map]].sum()))
        return out


# The weight and weight degree of a curve without tables of its own
# (optixHello.cpp:94,466-472).
DEFAULT_WM, DEFAULT_WD = 1.0, 0.5


def endcap_segments(scene: SceneTables) -> np.ndarray:
    """(n_segments,) bool: the endcap loops the loader synthesized, a
    curve's first or last segment whose control polygon closes on its end
    point (geometry.make_endcap_segment)."""
    v = scene.vertices
    first = scene.curve_index == 0
    last = scene.curve_index == scene.curve_segment_count[scene.curve_map] - 1
    closed = np.all(v[:, 0] == v[:, 3], axis=1)
    return (first | last) & closed


def weighted_curves(scene: SceneTables) -> int:
    """Curves whose weight or weight-degree knots leave DEFAULT_WM and
    DEFAULT_WD."""
    n = 0
    for c in range(scene.n_curves):
        for table, default in ((scene.weight, DEFAULT_WM), (scene.weight_degree, DEFAULT_WD)):
            start, count = table.index[c]
            if np.any(table.values[start:start + count] != np.float32(default)):
                n += 1
                break
    return n


def _build_device_scene(scene, flatten_subdivisions, max_sagitta, min_subdivisions, device):
    """build_device_scene's tables, and the sub-segments of each segment."""
    dev = resolve_device(device)
    if min_subdivisions is None:
        min_subdivisions = flatten_subdivisions
    rows: list[np.ndarray] = []  # shade rows
    p0s: list[np.ndarray] = []
    p1s: list[np.ndarray] = []
    refine_rows: list[np.ndarray] = []  # ALLT_SRC_CTRL..ALLT_DT block
    subs = np.zeros(scene.n_segments, np.int64)

    for seg in range(scene.n_segments):
        curve = int(scene.curve_map[seg])
        ctrl = scene.vertices[seg].astype(np.float64)
        base_u = float(scene.curve_index[seg])
        connect = int(scene.curve_connect[curve])
        is_portal = connect >= 0

        if is_portal:
            # Portal exit segment: same position within the target curve
            # (DeviceCode.cu:228: curve_map_inverse[target] + curve_index).
            # The reference does not bounds-check a shorter target curve; we
            # clamp to the target's last segment (documented deviation).
            tgt_first = int(scene.curve_first_segment[connect])
            tgt_count = int(scene.curve_segment_count[connect])
            tgt_seg = tgt_first + min(int(scene.curve_index[seg]), tgt_count - 1)
            tgt_ctrl = scene.vertices[tgt_seg].astype(np.float64)

        # Bounded-sagitta adaptive flattening: flatten_subdivisions is the
        # MINIMUM; curvier cubics subdivide until each chord's deviation
        # bound bpp * dt^2 / 8 <= max_sagitta, capping the exact-silhouette
        # band (= the closest-hit ordering error bound) scene-wide.
        a2 = ctrl[2] - 2.0 * ctrl[1] + ctrl[0]
        b2 = ctrl[3] - 2.0 * ctrl[2] + ctrl[1]
        bpp = 6.0 * max(np.linalg.norm(a2), np.linalg.norm(b2))
        k_seg = int(
            min(
                max(min_subdivisions, np.ceil(np.sqrt(bpp / (8.0 * max_sagitta)))),
                max(4 * flatten_subdivisions, 64),
            )
        )
        ts = _segment_breakpoints(scene, seg, k_seg)
        subs[seg] = len(ts) - 1
        pts = geometry.bezier_point(ctrl, ts)  # (B+1, 2)
        ders = geometry.bezier_derivative(ctrl, ts)
        if is_portal:
            ex_pts = geometry.bezier_point(tgt_ctrl, ts)
            ex_ders = geometry.bezier_derivative(tgt_ctrl, ts)

        for j in range(len(ts) - 1):
            u0, u1 = base_u + ts[j], base_u + ts[j + 1]
            row = np.zeros(SHADE_COLS, np.float64)
            row[COL_D0X : COL_D0Y + 1] = ders[j]
            row[COL_D1X : COL_D1Y + 1] = ders[j + 1]
            cl0, cl1 = _attr_limits(scene.color_left, curve, u0, u1)
            cr0, cr1 = _attr_limits(scene.color_right, curve, u0, u1)
            b0, b1 = _attr_limits(scene.blur, curve, u0, u1)
            w0, w1 = _attr_limits(scene.weight, curve, u0, u1)
            d0, d1 = _attr_limits(scene.weight_degree, curve, u0, u1)
            row[COL_CL0 : COL_CL0 + 3] = cl0
            row[COL_CL1 : COL_CL1 + 3] = cl1
            row[COL_CR0 : COL_CR0 + 3] = cr0
            row[COL_CR1 : COL_CR1 + 3] = cr1
            row[COL_BLUR0], row[COL_BLUR1] = b0[0], b1[0]
            row[COL_WM0], row[COL_WM1] = w0[0], w1[0]
            row[COL_WD0], row[COL_WD1] = d0[0], d1[0]
            row[COL_PORTAL] = 1.0 if is_portal else 0.0
            if is_portal:
                row[COL_EXP0X : COL_EXP0Y + 1] = ex_pts[j]
                row[COL_EXP1X : COL_EXP1Y + 1] = ex_pts[j + 1]
                row[COL_EXD0X : COL_EXD0Y + 1] = ex_ders[j]
                row[COL_EXD1X : COL_EXD1Y + 1] = ex_ders[j + 1]
            row[COL_VALID] = 1.0
            rows.append(row)
            p0s.append(pts[j])
            p1s.append(pts[j + 1])
            rrow = np.zeros(ALLT_ROWS - ALLT_SRC_CTRL, np.float64)
            rrow[0:8] = ctrl.reshape(-1)
            if is_portal:
                rrow[8:16] = tgt_ctrl.reshape(-1)
            rrow[ALLT_T0 - ALLT_SRC_CTRL] = ts[j]
            rrow[ALLT_DT - ALLT_SRC_CTRL] = ts[j + 1] - ts[j]
            refine_rows.append(rrow)

    n_sub = len(rows)

    # Morton-order the sub-segments so each 64-chunk is spatially tight:
    # chunk bounding circles shrink and the kernel's wedge/distance culling
    # rejects far more chunks.  A pure permutation — both trace paths index
    # the same permuted tables, so winner tie-breaks stay consistent.
    if n_sub > SEG_ALIGN:
        mids = 0.5 * (np.stack(p0s) + np.stack(p1s))
        lo = mids.min(axis=0)
        span = np.maximum(mids.max(axis=0) - lo, 1e-6)
        q = np.clip(((mids - lo) / span * 1023.0).astype(np.uint32), 0, 1023)

        def _spread(v):  # interleave 10 bits with zeros
            v = (v | (v << 16)) & np.uint32(0x030000FF)
            v = (v | (v << 8)) & np.uint32(0x0300F00F)
            v = (v | (v << 4)) & np.uint32(0x030C30C3)
            v = (v | (v << 2)) & np.uint32(0x09249249)
            return v

        morton = _spread(q[:, 0]) | (_spread(q[:, 1]) << np.uint32(1))
        order = np.argsort(morton, kind="stable")
        rows = [rows[i] for i in order]
        p0s = [p0s[i] for i in order]
        p1s = [p1s[i] for i in order]
        refine_rows = [refine_rows[i] for i in order]

    # Scenes that fit one chunk pad only to a multiple of 8;
    # larger scenes pad to the chunk granule so culling stays uniform.
    if n_sub <= SEG_ALIGN:
        s_pad = max(_pad_to(n_sub, 8), 8)
    else:
        s_pad = _pad_to(n_sub, SEG_ALIGN)

    shade = np.zeros((s_pad, SHADE_COLS), np.float64)
    shade[:n_sub] = np.stack(rows)
    p0 = np.zeros((s_pad, 2), np.float64)
    p1 = np.zeros((s_pad, 2), np.float64)
    p0[:n_sub] = np.stack(p0s)
    p1[:n_sub] = np.stack(p1s)
    consts = np.zeros((s_pad, CONST_COLS), np.float64)
    e = p1 - p0
    consts[:, CONST_EX] = e[:, 0]
    consts[:, CONST_EY] = e[:, 1]
    consts[:, CONST_C1] = p0[:, 0] * e[:, 1] - p0[:, 1] * e[:, 0]
    consts[:, CONST_P0X] = p0[:, 0]
    consts[:, CONST_P0Y] = p0[:, 1]
    consts[:, CONST_VALID] = shade[:, COL_VALID]
    if n_sub:
        rr = np.stack(refine_rows)
        consts[:n_sub, CONST_BAND] = _capsule_bands(rr, p0[:n_sub], p1[:n_sub])
        # signed mid-window deviation for the quadratic ordering key
        cxr, cyr = rr[:, 0:8:2], rr[:, 1:8:2]
        tm = rr[:, 16] + 0.5 * rr[:, 17]
        mt = 1.0 - tm
        w = np.stack([mt**3, 3 * mt**2 * tm, 3 * mt * tm**2, tm**3], axis=1)
        bmx = (w * cxr).sum(axis=1)
        bmy = (w * cyr).sum(axis=1)
        consts[:n_sub, CONST_QUAD] = 4.0 * (
            e[:n_sub, 0] * (bmy - p0[:n_sub, 1])
            - e[:n_sub, 1] * (bmx - p0[:n_sub, 0])
        )

    shade_all_t = np.zeros((ALLT_ROWS, s_pad), np.float64)
    shade_all_t[:SHADE_COLS] = shade.T
    shade_all_t[SHADE_COLS : SHADE_COLS + 5] = consts[:, :5].T
    shade_all_t[ALLT_SRC_CTRL:, :n_sub] = np.stack(refine_rows).T
    shade_all_t[ALLT_BAND, :n_sub] = consts[:n_sub, CONST_BAND]

    n_chunks = max(1, -(-s_pad // SEG_ALIGN))
    chunk_bounds = np.zeros((n_chunks, 4), np.float64)
    for c in range(n_chunks):
        lo, hi = c * SEG_ALIGN, min((c + 1) * SEG_ALIGN, n_sub)
        if lo >= n_sub:
            # all-padding chunk: unhittable, park it at infinity
            chunk_bounds[c] = [1e30, 1e30, 0.0, 0.0]
            continue
        pts = np.concatenate([p0[lo:hi], p1[lo:hi]], axis=0)
        mn, mx = pts.min(axis=0), pts.max(axis=0)
        center = 0.5 * (mn + mx)
        radius = float(np.max(np.linalg.norm(pts - center, axis=1)))
        # + the largest silhouette band in the chunk: the band-widened sweep
        # can accept hits up to that far beyond the chords, and culling must
        # stay conservative with respect to everything the sweep accepts.
        radius += float(np.max(consts[lo:hi, CONST_BAND]))
        chunk_bounds[c] = [center[0], center[1], radius, 0.0]

    wds = np.concatenate([shade[:n_sub, COL_WD0], shade[:n_sub, COL_WD1]])
    wds32 = wds.astype(np.float32)
    uniform_wd = float(wds32[0]) if n_sub and np.all(wds32 == wds32[0]) else None
    wms = np.concatenate([shade[:n_sub, COL_WM0], shade[:n_sub, COL_WM1]])
    wms32 = wms.astype(np.float32)
    uniform_wm = float(wms32[0]) if n_sub and np.all(wms32 == wms32[0]) else None

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    seg_consts, shade_all_t = put(consts), put(shade_all_t)
    return DeviceScene(
        seg_consts=seg_consts,
        shade_table=put(shade),
        shade_all_t=shade_all_t,
        chunk_bounds=put(chunk_bounds),
        **pack_records(seg_consts, shade_all_t),
        width=scene.width,
        height=scene.height,
        n_sub=n_sub,
        s_pad=s_pad,
        has_portals=scene.has_portals,
        max_blur=scene.max_blur,
        uniform_wd=uniform_wd,
        uniform_wm=uniform_wm,
    ), subs


def intersect_consts(
    consts_slice: torch.Tensor,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    min_hit: float = 0.0,
    band_scale: float | torch.Tensor = 0.0,
):
    """Intersect rays against a (S, CONST_COLS) slice of seg_consts.

    origins/dirs: (N, 2).  Returns (denom, t, t_est, s, valid) each (N, S).
    The plain PyTorch twin of the CUDA trace kernel's per-pair test
    (csrc/trace.cu ``seg_test``), operation for operation the JAX package's
    ``intersect_consts``.

    Validity is division-free sign algebra (so hit acceptance does not
    depend on how a reciprocal rounds):
      * s in [0, 1]   <=>  num_s * (denom - num_s) >= 0
      * t  > min_hit  <=>  (num_t - min_hit * denom) * denom > 0
    The second product is also the denom != 0 guard (parallel rays and e = 0
    padding rows yield 0, never > 0).

    ``band_scale`` > 0 (a float or an (N,) tensor, ~|d| per ray) enables the
    exact-silhouette band: acceptance widens by h = band_scale * CONST_BAND
    in num_s units, and the t cut relaxes by the same margin.  Downstream
    root isolation rejects the non-crossing candidates.
    """
    ex = consts_slice[:, CONST_EX][None, :]
    ey = consts_slice[:, CONST_EY][None, :]
    c1 = consts_slice[:, CONST_C1][None, :]
    p0x = consts_slice[:, CONST_P0X][None, :]
    p0y = consts_slice[:, CONST_P0Y][None, :]

    ox, oy = origins[:, 0:1], origins[:, 1:2]
    dx, dy = dirs[:, 0:1], dirs[:, 1:2]

    denom = dx * ey - dy * ex
    num_t = c1 - ox * ey + oy * ex
    num_s = dy * p0x - dx * p0y + (oy * dx - ox * dy)
    if isinstance(band_scale, (int, float)) and band_scale == 0.0:
        valid = (num_s * (denom - num_s) >= 0.0) & (
            (num_t - min_hit * denom) * denom > 0.0
        )
    else:
        scale = torch.as_tensor(
            band_scale, dtype=torch.float32, device=denom.device
        ).reshape(-1, 1)
        h = consts_slice[:, CONST_BAND][None, :] * scale  # (N or 1, S)
        # Sign-free identity: with ms = sign(denom) * h,
        #   (num_s + ms)(denom - num_s + ms) = prod_s + h*|denom| + h^2,
        # so the widened s-window test needs no select.
        had = h * torch.abs(denom)
        valid = (num_s * (denom - num_s) + had + h * h >= 0.0) & (
            (num_t - min_hit * denom) * denom + had > 0.0
        )
    inv = torch.where(denom == 0.0, 0.0, 1.0 / denom)
    t = num_t * inv
    s = num_s * inv
    # Quadratic-corrected ordering estimate (CONST_QUAD): 2nd-order-accurate
    # hit distance, the closest-hit ranking key.
    q = consts_slice[:, CONST_QUAD][None, :]
    t_est = (num_t - q * s * (1.0 - s)) * inv
    return denom, t, t_est, s, valid
