"""The trace kernel's host side: block geometry, acceleration tables, and
the dispatch between the CUDA kernel and its plain PyTorch version.

``trace_sums_flat`` computes, for every pixel of a row band, the weighted
sums (sum c*w, sum w, sum blur*w) over its fan of rays.  On a CUDA tensor it
launches the hand-written kernel ``csrc/trace.cu`` (which replaces the JAX
package's Pallas kernel ``ops/trace_pallas.py::_trace_kernel``); on a CPU
tensor it runs the plain version (``ops/intersect.py``), chunked over
pixel blocks.  There is no fallback between the two: a CUDA tensor either
goes through the kernel or raises.

The block geometry (``_choose_block``, ``_grid_geom``) is the JAX
package's, kept identical so the (tile, wedge) grid and the candidate
tables compare 1:1 between the two packages.  ``build_cand_tables`` builds
one camera's tables; ``build_cand_grid`` the same tables for a world grid
of cells, from which ``grid_tables`` selects a moving camera's.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import Camera, RenderConfig
from ..scene import device as dev
from ..utils.timing import span
from . import candidates as cand_mod
from . import intersect

# Segment chunk of the JAX package's culling sweep (scene/device.py
# SEG_ALIGN): decides "multi-chunk" scenes, which take the narrow wedge.
SEG_CHUNK = 64
# Samples per direction wedge (single-chunk / multi-chunk scenes).
WEDGE_SAMPLES = 16
WEDGE_SAMPLES_MULTICHUNK = 4
# Pixel tile width; tile height is PXB / TILE_W.
TILE_W = 16
# Scenes beyond this many padded sub-segments take 2-sample wedges and
# 1024-ray blocks (the JAX package's dense-scene geometry).
DENSE_SPAD = 4096
# Slots of one level of a capped candidate list; scenes within one level
# keep every candidate (slot mode).
LEVEL_SLOTS = 128
# Segment-list tables larger than this are not built: the scene takes coarser
# wedges, else chunk lists (or, within one chunk, the full sweep) instead.
_CAND_TABLE_BYTES_CAP = 2 << 30
# Most adjacent wedges that share one table entry (wedge coarsening; the
# JAX package's _WEDGE_COARSE_MAX).
WEDGE_COARSE_MAX = 16
# (rays x segments) pairs per chunk of the plain version (CPU, CUDA): bounds
# its intermediates to tens of MB on the CPU, a few GB on the card.
_PLAIN_CHUNK_PAIRS = (1 << 21, 1 << 25)
# Per-pixel counters of the statistics launch, in the order the kernel
# writes them.
STAT_NAMES = (
    "live_rays", "list_slots", "fallback_rays", "chunks", "chunk_pairs",
    "clean_hits", "grazes", "warp_slots", "bounce_rays", "sweep_slots", "sweep_warp_slots",
)
# The kernel's instantiations, in rtdc_trace_info's order.
KERNEL_INSTANCES = ("id_order", "dist_order", "dist_order_stats")

# Launches of the CUDA trace kernel since the last reset (one per
# trace_sums_flat call on a CUDA tensor).  The tests read it to show that a
# path went through the kernel.
LAUNCHES = 0


def reset_launch_count() -> None:
    global LAUNCHES
    LAUNCHES = 0


class CandTables(NamedTuple):
    """Camera-dependent acceleration tables of one (camera, pixel band), per
    (tile, table wedge) cell.  W below is the table wedge count: the fan's
    wedges, or with a wedge shift k (table_layout) n_wedges >> k, each entry
    shared by 2^k adjacent wedges.  Three shapes, by the scene's kind
    (accel_kind):

    * slot-mode segment lists (s_pad <= LEVEL_SLOTS): ``ids`` (T, W, L)
      int32 global segment ids in ascending order, padded with s_pad, and
      ``counts`` (T, W) int32; every other field None.
    * capped segment lists (larger scenes): ``ids`` sorted by ``lbs``
      (T, W, L) float32, the conservative lower-bound distance of each slot
      (1e30 past the count); ``counts`` capped at cand_len + 1 (more than
      cand_len: segments were dropped); ``horizon`` (T, W) float32, the
      bound of the first dropped segment; where a list can overflow, the
      chunk lists ``chunk_ids`` / ``chunk_lbs`` (T, W, C) and
      ``chunk_counts`` (T, W) of the chunks that hold dropped segments.
    * chunk lists only: ``ids``, ``counts``, ``lbs``, ``horizon`` None.

    ``circle`` (4,) float32, on the device, for the distance-ordered walks:
    the scene's enclosing circle (cx, cy, r) and the largest key slack of
    the key guard (0 without it).  The kernel reads the first min(count, L)
    entries of each list unchecked: build the tables with
    build_cand_tables.

    ``row_cuts``: set on a rank's tables of a row split by work
    (``parallel/sharded.py::build_cand_tables_sharded``): the frame's row
    cuts 0 = c_0 < c_1 < ... < c_n = H, rank r's tables covering rows
    [c_r, c_r+1); None from every other table build, for tables of the
    band their caller names."""

    ids: torch.Tensor | None
    counts: torch.Tensor | None
    lbs: torch.Tensor | None = None
    horizon: torch.Tensor | None = None
    chunk_ids: torch.Tensor | None = None
    chunk_lbs: torch.Tensor | None = None
    chunk_counts: torch.Tensor | None = None
    circle: torch.Tensor | None = None
    row_cuts: tuple[int, ...] | None = None

    @property
    def dist_ordered(self) -> bool:
        """Walked in distance order with a per-ray exit (capped segment
        lists, chunk lists) rather than in id order to the end."""
        return self.lbs is not None or self.chunk_ids is not None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self if isinstance(t, torch.Tensor))


# The CandTables fields indexed by (tile or cell, table wedge).
_CELL_FIELDS = ("ids", "counts", "lbs", "horizon", "chunk_ids", "chunk_lbs", "chunk_counts")


def _cand_len_for(s_pad: int) -> int:
    """Slots of a scene's segment lists, as the JAX package chooses them:
    every segment within one level (slot mode), else 2 levels up to 4096
    padded sub-segments and 4 beyond, never more levels than the scene
    fills."""
    if s_pad <= LEVEL_SLOTS:
        return s_pad
    levels = 2 if s_pad <= 4096 else 4
    return LEVEL_SLOTS * min(levels, -(-s_pad // LEVEL_SLOTS))


def _choose_block(
    rpp: int, rays_per_block: int, multi_chunk: bool = False,
    dense: bool = False,
) -> tuple[int, int, int, int]:
    """Returns (R rays/block, PXB pixels/block, SW samples/wedge, W
    wedges/pixel), exactly as the JAX package chooses them.  R = PXB * SW,
    a multiple of 128; PXB a multiple of TILE_W so every block covers whole
    tile rows."""
    base = WEDGE_SAMPLES_MULTICHUNK if multi_chunk else WEDGE_SAMPLES
    if dense:
        base = min(base, 2)
        rays_per_block = min(rays_per_block, 1024)
    sw = math.gcd(rpp, base)
    w = rpp // sw
    if w > 32:
        rays_per_block = min(rays_per_block, 2048)
    pxb = max(rays_per_block // sw, 1)
    m = TILE_W * (128 // math.gcd(sw, 128)) // math.gcd(TILE_W, 128 // math.gcd(sw, 128))
    pxb = ((pxb + m - 1) // m) * m
    return pxb * sw, pxb, sw, w


def _grid_geom(scene: dev.DeviceScene, config: RenderConfig, w: int, n_px: int):
    """Static block/tile geometry shared by trace_sums_flat and
    build_cand_tables: (R, pxb, sw, n_wedges, tile_h, tiles_x, tiles_y,
    n_tiles)."""
    R, pxb, sw, n_wedges = _choose_block(
        config.rays_per_pixel, config.rays_per_block,
        multi_chunk=scene.s_pad > SEG_CHUNK,
        dense=scene.s_pad > DENSE_SPAD,
    )
    if n_px % w != 0:
        raise ValueError(f"n_px {n_px} must cover whole rows of width {w}")
    tile_h = pxb // TILE_W
    tiles_x = -(-w // TILE_W)
    n_rows = n_px // w
    tiles_y = -(-n_rows // tile_h)
    return R, pxb, sw, n_wedges, tile_h, tiles_x, tiles_y, tiles_x * tiles_y


def n_traces(scene: dev.DeviceScene, config: RenderConfig) -> int:
    """Traces of a ray's portal chain: the primary and up to
    ``max_trace_depth`` continuations where the scene has portals."""
    return (config.max_trace_depth + 1) if scene.has_portals else 1


def _n_chunks(s_pad: int) -> int:
    return s_pad // SEG_CHUNK if s_pad >= SEG_CHUNK else 1


def _seg_table_bytes(s_pad: int, n_tiles: int, n_wedges: int) -> int:
    """Bytes of a scene's segment-list tables, chunk lists included."""
    cand_len = min(_cand_len_for(s_pad), s_pad)
    per_cell = cand_len * 4 + 4  # ids, count
    if s_pad > LEVEL_SLOTS:
        per_cell += cand_len * 4 + 4  # lbs, horizon
        if cand_len < s_pad:
            per_cell += _n_chunks(s_pad) * 8 + 4  # chunk ids, lbs, count
    return n_tiles * n_wedges * per_cell


def accel_kind(
    scene: dev.DeviceScene, config: RenderConfig, n_px: int | None = None,
    wedge_shift: int | None = None,
):
    """Which acceleration tables the scene gets, as the JAX package decides:
    "seg" (per-(tile, table wedge) segment lists, plus chunk lists where a
    list can overflow), "chunk" (chunk lists only: more than CAND_MAX_SPAD
    sub-segments, or no wedge coarsening brings the lists within
    CAND_MAX_WEDGES wedges and the byte cap) or None (the kernel's full
    sweep).  The arguments are table_layout's."""
    return table_layout(scene, config, n_px, wedge_shift)[0]


def table_layout(
    scene: dev.DeviceScene, config: RenderConfig, n_px: int | None = None,
    wedge_shift: int | None = None,
) -> tuple[str | None, int]:
    """(kind, wedge shift) of the tables of the band of ``n_px`` pixels
    (default: the whole frame).  Segment lists of shift k are shared by 2^k
    adjacent wedges: they hold what any ray of the wider wedge can hit, and
    divide table memory by 2^k.  The shift is 0 for every other kind.

    ``wedge_shift`` None takes the rule, decided once on the full frame so
    that every band of it shares one table structure: the smallest k with
    2^k <= WEDGE_COARSE_MAX dividing the wedge count at which segment lists
    exist (use_candidates over n_wedges >> k wedges) and fit
    _CAND_TABLE_BYTES_CAP; with none, shift 0 and the band's own fine
    choice.  Wherever fine lists exist and fit, k is 0.  This differs from
    the JAX package's _wedge_coarse_shift in its byte rule alone: that one
    counts its TPU layout against a 10 GiB cap and goes on to a larger k
    whose tables fit a 3 GiB target, sized for a 16 GB chip; the port
    counts its own tables against one 2 GiB cap.  An int forces the shift
    (0: fine tables, which past CAND_MAX_WEDGES wedges are chunk lists)."""
    w = scene.width
    frame_px = scene.height * w
    n_px = frame_px if n_px is None else n_px
    _, _, _, n_wedges, _, _, _, n_tiles = _grid_geom(scene, config, w, n_px)
    if wedge_shift is None:
        frame_tiles = _grid_geom(scene, config, w, frame_px)[7]
        wedge_shift = _coarse_shift(scene.s_pad, frame_tiles, n_wedges) or 0
    elif wedge_shift < 0 or n_wedges % (1 << wedge_shift) != 0:
        raise ValueError(f"wedge shift {wedge_shift} does not divide {n_wedges} wedges")
    kind = _table_kind(scene, n_tiles, n_wedges >> wedge_shift)
    return kind, wedge_shift if kind == "seg" else 0


def _coarse_shift(s_pad: int, n_cells: int, n_wedges: int) -> int | None:
    """table_layout's rule: the smallest wedge shift whose segment lists
    exist and fit the byte cap, or None."""
    k = 0
    while (1 << k) <= WEDGE_COARSE_MAX and n_wedges % (1 << k) == 0:
        w_t = n_wedges >> k
        if (cand_mod.use_candidates(s_pad, w_t)
                and _seg_table_bytes(s_pad, n_cells, w_t) <= _CAND_TABLE_BYTES_CAP):
            return k
        k += 1
    return None


def table_wedge_shift(tables: CandTables, n_wedges: int) -> int:
    """The wedge shift of built tables, read off their shape (T, n_wedges >>
    shift, ...) as the JAX package derives it, so hoisted, in-frame and band
    tables cannot disagree with the launch."""
    w_t = (tables.ids if tables.ids is not None else tables.chunk_ids).shape[1]
    ratio = n_wedges // w_t if w_t > 0 else 0
    if ratio < 1 or ratio * w_t != n_wedges or ratio & (ratio - 1):
        raise ValueError(f"tables of {w_t} wedges do not coarsen {n_wedges} wedges")
    return ratio.bit_length() - 1


def _table_kind(scene: dev.DeviceScene, n_cells: int, n_wedges: int):
    """accel_kind for tables of ``n_cells`` origin circles (pixel tiles or
    world-grid cells) x ``n_wedges`` wedges."""
    if (
        cand_mod.use_candidates(scene.s_pad, n_wedges)
        and _seg_table_bytes(scene.s_pad, n_cells, n_wedges) <= _CAND_TABLE_BYTES_CAP
    ):
        return "seg"
    if _n_chunks(scene.s_pad) > 1:
        return "chunk"
    return None


def scene_circle(scene: dev.DeviceScene, key_guard: bool = True) -> torch.Tensor:
    """(cx, cy, r, slack) float32 on the scene's device: a circle that
    encloses every valid chunk circle (bands included), hence every point a
    ray can hit, and the largest key slack of the key guard (candidates.py;
    0 for tables built without it).  A ray stops looking past the distance at which it leaves
    the circle, plus the slack: an ordering key can overshoot its hit."""
    cbx, cby, cbr = scene.chunk_bounds[:, 0], scene.chunk_bounds[:, 1], scene.chunk_bounds[:, 2]
    cvalid = cbx < 1e29
    big = 1e30
    xmin = torch.min(torch.where(cvalid, cbx - cbr, big))
    xmax = torch.max(torch.where(cvalid, cbx + cbr, -big))
    ymin = torch.min(torch.where(cvalid, cby - cbr, big))
    ymax = torch.max(torch.where(cvalid, cby + cbr, -big))
    scx = 0.5 * (xmin + xmax)
    scy = 0.5 * (ymin + ymax)
    scr = torch.max(
        torch.where(cvalid, torch.sqrt((cbx - scx) ** 2 + (cby - scy) ** 2) + cbr, 0.0)
    )
    slack = torch.zeros_like(scr)
    if key_guard:
        slack = cand_mod.key_slack(scene.seg_consts, cand_mod.KEY_GUARD_SIN).max()
    return torch.stack([scx, scy, scr, slack])


def build_cand_tables(
    scene: dev.DeviceScene,
    camera: Camera,
    config: RenderConfig,
    px_start: int = 0,
    n_px: int | None = None,
    key_guard: bool = True,
    wedge_shift: int | None = None,
) -> CandTables | None:
    """Build the camera-dependent acceleration tables for trace_sums_flat's
    ``cand_tables`` argument (the analogue of the reference's accel build,
    optixHello.cpp:764-830): they depend only on (scene, camera, config,
    pixel band), so a static camera builds them once.  Returns None for
    scenes that take the full sweep.  Tables built for a different camera
    or band mis-cull silently: callers own the invalidation.

    ``key_guard``: distance-ordered tables get the key guard of
    candidates.py: their lower bounds then bound each segment's ordering
    key, which makes the kernel's early exits exact.  False builds the JAX
    package's tables (distance bounds), under which a far chord that a ray
    grazes nearly parallel can be missed although the full sweep picks it;
    only the tests that hold the tables against the JAX package and pin
    that fault ask for them.

    ``wedge_shift``: table_layout's; None takes the full frame's rule, so a
    band's tables have the frame's structure.  Segment lists of shift k are
    built at the wider wedge of sw << k samples (the JAX package's sw_t):
    the cone tests, the key guard's hazards and the chunk lists all see the
    coarse wedge's angular span.

    Recorded as the span ``scene.cand_tables`` with the attributes
    ``table_kind`` ("seg" or "chunk"), ``order`` ("id": slot-mode lists;
    "dist": distance-ordered lists or chunk lists), ``cand_len`` (the
    lists' slots; 0 for chunk lists only), ``wedges`` (the fan's wedges) and
    ``wedge_shift``."""
    w, h = scene.width, scene.height
    n_px = h * w if n_px is None else n_px
    kind, shift = table_layout(scene, config, n_px, wedge_shift)
    if kind is None:
        return None
    _, _, sw, n_wedges, tile_h, tiles_x, tiles_y, _ = _grid_geom(scene, config, w, n_px)
    grid = (
        w, h, camera.zoom_factor, camera.offset_x, camera.offset_y,
        config.rays_per_pixel, sw << shift, tiles_x, tiles_y, TILE_W, tile_h, px_start,
        config.diffusion_curve_save,
    )
    seg = kind == "seg"
    with span("scene.cand_tables", table_kind=kind,
              order="id" if seg and scene.s_pad <= LEVEL_SLOTS else "dist",
              cand_len=min(_cand_len_for(scene.s_pad), scene.s_pad) if seg else 0,
              wedges=n_wedges, wedge_shift=shift):
        return _build_tables(scene, config, kind, grid, None, key_guard)


def _build_tables(scene, config, kind, grid, circles, key_guard) -> CandTables:
    """The tables of one kind: ``grid`` holds segment_ids' camera and tile
    arguments, ``circles`` (or None: the pixel tiles') the origin circles."""
    sw = grid[6]
    seg = (None, None, None, None)
    keep = None
    guard_sin = cand_mod.KEY_GUARD_SIN if key_guard else None
    if kind == "seg":
        cand_len = _cand_len_for(scene.s_pad)
        if scene.s_pad <= LEVEL_SLOTS:
            ids, counts, _, _, _ = cand_mod.segment_ids(
                scene.seg_consts, *grid, cand_len=cand_len, order="id", circles=circles
            )
            return CandTables(ids, counts)
        overflows = cand_len < scene.s_pad
        ids, counts, lbs, horizon, cmax = cand_mod.segment_ids(
            scene.seg_consts, *grid, cand_len=cand_len, order="dist",
            chunk_cover=overflows, key_guard=guard_sin, circles=circles,
        )
        seg = (ids, counts, lbs, horizon)
        if not overflows:
            return CandTables(*seg, circle=scene_circle(scene, key_guard))
        # a chunk stays in the walk iff one of its passing segments was
        # dropped from the list (lb >= horizon; ties keep)
        keep = cmax >= horizon[..., None]
    slack = hazard = None
    if key_guard:
        slack, hazard = cand_mod.chunk_guard(
            scene.seg_consts, config.rays_per_pixel, sw, guard_sin
        )
    chunk_ids, chunk_lbs, chunk_counts = cand_mod.chunk_candidates(
        scene.chunk_bounds, *grid, keep=keep, slack=slack, hazard=hazard, circles=circles
    )
    if key_guard and kind == "seg":
        # horizon 0: a hazard may have been dropped, and its key has no bound
        live = chunk_lbs < cand_mod.FAR_LB
        chunk_lbs = torch.where((horizon[..., None] <= 0.0) & live, 0.0, chunk_lbs)
    return CandTables(
        *seg, chunk_ids, chunk_lbs, chunk_counts, scene_circle(scene, key_guard)
    )


def seg_max_count(scene: dev.DeviceScene, cand_tables: CandTables | None) -> int | None:
    """Largest per-(tile, wedge) candidate count of slot-mode tables (one
    host sync), or None when the tables are not slot-mode segment lists
    (none, capped lists, chunk lists): those are walked as built.  Passed to
    trace_sums_flat as ``gather_len`` it lets the kernel read lists narrowed
    to that length."""
    if cand_tables is None or scene.s_pad > LEVEL_SLOTS or cand_tables.dist_ordered:
        return None
    with span("sync.seg_max_count"):
        return int(cand_tables.counts.max())


def narrow_cand_tables(cand_tables: CandTables, gather_len: int) -> CandTables:
    """Slot-mode tables with each list cut to ``gather_len`` slots (call
    with seg_max_count's value; an under-certified length drops candidates).
    Distance-ordered tables pass through unchanged; every other field
    (``row_cuts`` too) is kept."""
    gl = max(int(gather_len), 1)
    if cand_tables.dist_ordered or cand_tables.ids.shape[-1] <= gl:
        return cand_tables
    return cand_tables._replace(ids=cand_tables.ids[..., :gl].contiguous())


def tile_rows(scene: dev.DeviceScene, config: RenderConfig) -> int:
    """Pixel rows of one row of the kernel's tiles (tile_h)."""
    return _grid_geom(scene, config, scene.width, scene.width)[4]


# ---------------------------------------------------------------------------
# world grid: tables for a moving camera
# ---------------------------------------------------------------------------

# The coverage circle of a grid cell is taken this share larger than the
# exact largest tile circle, plus this many float32 steps of the grid box's
# largest coordinate: tile radii and centres and cell centres are float32
# roundings of the exact values, off by a few steps of the coordinates.
_COVER_REL = 1e-3
_COVER_ULPS = 64


class WorldGrid(NamedTuple):
    """Camera-independent candidate tables: the tables of build_cand_tables
    built for a uniform world-space grid of cells instead of one camera's
    pixel tiles (the JAX package's ``trace_pallas.WorldGrid``; the analogue
    of the reference's world-space BVH, optixHello.cpp:764-830, built once
    and never rebuilt while the view moves).

    ``tables`` is a CandTables over (nx * ny cells, wedges), cell id
    iy * nx + ix.  A cell's lists were built for its coverage circle: every
    origin of a tile whose centre lies in the cell at a zoom up to
    ``zoom_max``, so they hold a superset of any such tile's candidates.
    grid_tables selects a camera's per-(tile, wedge) tables with one gather;
    grid_covers tells whether the grid serves a camera.  ``gather_len``:
    the largest count of slot-mode lists over the whole grid (the lists are
    narrowed to it), else None."""

    tables: CandTables
    x0: float
    y0: float
    pitch_x: float
    pitch_y: float
    nx: int
    ny: int
    zoom_max: float
    gather_len: int | None

    @property
    def nbytes(self) -> int:
        return self.tables.nbytes


def build_cand_grid(
    scene: dev.DeviceScene,
    config: RenderConfig,
    x0: float,
    y0: float,
    x1: float,
    y1: float,
    zoom_max: float = 1.0,
    key_guard: bool = True,
) -> WorldGrid | None:
    """Build the world grid whose cells cover tile centres in [x0, x1] x
    [y0, y1] for cameras with zoom <= zoom_max (the JAX package's
    build_cand_grid, with the key guard of build_cand_tables).  Cells are
    one tile at zoom_max, TILE_W x tile_h pixels; the table kind is chosen
    over the grid's cells, so a grid past the byte cap takes chunk lists
    where one camera's tables are segment lists.  Returns None for scenes
    that take the full sweep.  One host sync for slot-mode lists (the
    largest count)."""
    w, h = scene.width, scene.height
    _, _, sw, n_wedges, tile_h, _, _, _ = _grid_geom(scene, config, w, h * w)
    pitch_x = TILE_W * zoom_max
    pitch_y = tile_h * zoom_max
    nx = max(1, int(math.ceil((x1 - x0) / pitch_x)))
    ny = max(1, int(math.ceil((y1 - y0) / pitch_y)))
    kind = _table_kind(scene, nx * ny, n_wedges)
    if kind is None:
        return None
    circles = _cell_circles(x0, y0, x1, y1, pitch_x, pitch_y, nx, ny, zoom_max, tile_h,
                            scene.device)
    grid = (
        w, h, 1.0, 0.0, 0.0, config.rays_per_pixel, sw, nx, ny, TILE_W, tile_h, 0,
        config.diffusion_curve_save,
    )
    tables = _build_tables(scene, config, kind, grid, circles, key_guard)
    gather_len = seg_max_count(scene, tables)
    if gather_len is not None:
        tables = narrow_cand_tables(tables, gather_len)
    return WorldGrid(tables, float(x0), float(y0), float(pitch_x), float(pitch_y), nx, ny,
                     float(zoom_max), gather_len)


def _cell_circles(x0, y0, x1, y1, pitch_x, pitch_y, nx, ny, zoom_max, tile_h, device):
    """(bcx, bcy, br) (nx * ny,) float32: each cell's centre and coverage
    radius, half the cell's diagonal plus the largest tile circle at
    zoom_max (TILE_W x tile_h pixels, AA jitter included), with the float32
    margin above."""
    cx = x0 + (torch.arange(nx, dtype=torch.float32, device=device) + 0.5) * pitch_x
    cy = y0 + (torch.arange(ny, dtype=torch.float32, device=device) + 0.5) * pitch_y
    r_max = 0.5 * zoom_max * math.hypot(TILE_W, tile_h) * (1.0 + _COVER_REL)
    extent = max(abs(x0), abs(x1), abs(y0), abs(y1), 1.0)
    cover = (0.5 * math.hypot(pitch_x, pitch_y) + r_max
             + _COVER_ULPS * float(np.spacing(np.float32(extent))))
    bcx = cx[None, :].expand(ny, nx).reshape(-1)
    bcy = cy[:, None].expand(ny, nx).reshape(-1)
    return bcx, bcy, torch.full((nx * ny,), cover, dtype=torch.float32, device=device)


def grid_cells(grid: WorldGrid, scene: dev.DeviceScene, camera: Camera, config: RenderConfig,
               px_start: int = 0, n_px: int | None = None) -> torch.Tensor:
    """(T,) int64 on the scene's device: the cell of each pixel tile of the
    band, the one that holds the tile's centre (clamped into the grid)."""
    w, h = scene.width, scene.height
    n_px = h * w if n_px is None else n_px
    _, _, _, _, tile_h, tiles_x, tiles_y, _ = _grid_geom(scene, config, w, n_px)
    bcx, bcy, _ = cand_mod._tile_circles(
        w, h, camera.zoom_factor, camera.offset_x, camera.offset_y, tiles_x, tiles_y,
        TILE_W, tile_h, px_start, config.diffusion_curve_save, device=scene.device,
    )
    ix = torch.clamp(torch.floor((bcx - grid.x0) / grid.pitch_x), 0, grid.nx - 1)
    iy = torch.clamp(torch.floor((bcy - grid.y0) / grid.pitch_y), 0, grid.ny - 1)
    return (iy * grid.nx + ix).to(torch.int64)


def grid_tables(
    grid: WorldGrid,
    scene: dev.DeviceScene,
    camera: Camera,
    config: RenderConfig,
    px_start: int = 0,
    n_px: int | None = None,
) -> CandTables:
    """This camera's per-(tile, wedge) tables selected from the world grid:
    one index_select per table field by cell id, enqueued with no host sync.
    The scene circle does not depend on the camera and is shared.  Pass the
    result to trace_sums_flat with ``gather_len = grid.gather_len``.  The
    caller owns validity (grid_covers), and a band must start on a tile
    row."""
    cid = grid_cells(grid, scene, camera, config, px_start, n_px)
    t = grid.tables
    return t._replace(**{name: getattr(t, name).index_select(0, cid) for name in _CELL_FIELDS
                         if getattr(t, name) is not None})


def grid_covers(
    grid: WorldGrid,
    scene: dev.DeviceScene,
    camera: Camera,
    config: RenderConfig,
) -> bool:
    """Whether the grid serves this camera: the zoom within zoom_max and
    every tile centre inside the grid box.  Computed on the host from the
    camera's floats (the tile circles in CPU float32, as the card computes
    them), so it never waits for the card."""
    if float(camera.zoom_factor) > grid.zoom_max * (1 + 1e-6):
        return False
    w, h = scene.width, scene.height
    _, _, _, _, tile_h, tiles_x, tiles_y, _ = _grid_geom(scene, config, w, h * w)
    bcx, bcy, _ = cand_mod._tile_circles(
        w, h, float(camera.zoom_factor), float(camera.offset_x), float(camera.offset_y),
        tiles_x, tiles_y, TILE_W, tile_h, 0, config.diffusion_curve_save, device="cpu",
    )
    return bool(
        (bcx.min() >= grid.x0) & (bcx.max() <= grid.x0 + grid.nx * grid.pitch_x)
        & (bcy.min() >= grid.y0) & (bcy.max() <= grid.y0 + grid.ny * grid.pitch_y)
    )


def trace_sums_flat(
    scene: dev.DeviceScene,
    camera: Camera,
    config: RenderConfig,
    frame: int,
    px_start: int,
    n_px: int,
    cand_tables: CandTables | None = None,
    gather_len: int | None = None,
):
    """Trace pixels [px_start, px_start + n_px) (whole rows) of the scene's
    pixel grid; returns flat (color_sum (n_px, 3), weight_sum (n_px,),
    blur_sum (n_px,)) on the scene's device.

    ``cand_tables``: build_cand_tables output for THIS (camera, px_start,
    n_px), walked by primary rays; None walks every segment for every ray
    (the full sweep — the same sums, bit for bit).  ``gather_len``:
    certified max per-cell count of slot-mode tables (seg_max_count); lists
    are read up to that length."""
    w = scene.width
    if px_start % w != 0:
        raise ValueError(f"px_start {px_start} must start a row of width {w}")
    if cand_tables is not None and gather_len is not None:
        cand_tables = narrow_cand_tables(cand_tables, gather_len)
    if scene.device.type == "cuda":
        return _trace_sums_cuda(scene, camera, config, frame, px_start, n_px, cand_tables)
    if scene.device.type != "cpu":
        raise RuntimeError(f"no trace path for device {scene.device}")
    return trace_sums_plain(scene, camera, config, frame, px_start, n_px, cand_tables)


def trace_walk_stats(
    scene: dev.DeviceScene,
    camera: Camera,
    config: RenderConfig,
    frame: int,
    px_start: int,
    n_px: int,
    cand_tables: CandTables,
) -> dict[str, int]:
    """One launch of the kernel's counting instantiation over
    distance-ordered tables: totals over the band's primary rays of
    STAT_NAMES — rays of non-empty cells, list slots tested, rays that
    walked at least one chunk of the chunk lists (the horizon fallback, or
    the whole walk where there are chunk lists only), chunks walked, (ray,
    segment) pairs tested there, rays whose two chains agreed on the
    winner, rays shaded through root isolation, and per ray the list slots
    of the longest list walk in its warp (the warp walks that long: list
    slots / warp slots is the share of lane-slots that did work); then the
    portal bounces: continuation rays traced (bounce >= 1), the
    sub-segments they tested (every one: bounces walk no list), and the
    lane-slots of the warps' bounce sweeps (each sweep n_sub slots for every
    lane that holds a pixel).  For measurement outside any timed window (one
    host sync); CUDA only."""
    if scene.device.type != "cuda":
        raise RuntimeError("the statistics launch runs only on a CUDA device")
    if cand_tables is None or not cand_tables.dist_ordered:
        raise ValueError("walk statistics need distance-ordered tables")
    stats = torch.zeros((len(STAT_NAMES), n_px), dtype=torch.int32, device=scene.device)
    _trace_sums_cuda(scene, camera, config, frame, px_start, n_px, cand_tables, stats)
    totals = stats.sum(dim=1, dtype=torch.int64).tolist()
    return dict(zip(STAT_NAMES, totals))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _allowed_mask(scene, cand_tables: CandTables, pixel_rel, sample_ids, tile_h, tiles_x, sw,
                  n_wedges):
    """(N, S) bool: segment j is one that ray n's (tile, table wedge) tables
    declare hittable — a slot of the cell's segment list or a member of one
    of the cell's listed chunks.  The table wedge of a ray is its wedge
    shifted by the tables' wedge shift."""
    w = scene.width
    s_pad = scene.s_pad
    row_rel = pixel_rel // w
    col = pixel_rel % w
    tile = (row_rel // tile_h) * tiles_x + col // TILE_W
    wedge = (sample_ids // sw) >> table_wedge_shift(cand_tables, n_wedges)
    n = tile.shape[0]
    device = tile.device
    allowed = torch.zeros((n, s_pad), dtype=torch.bool, device=device)
    if cand_tables.ids is not None:
        ids = cand_tables.ids[tile, wedge].to(torch.int64)  # (N, L)
        n_slots = ids.shape[-1]
        cnt = torch.clamp(cand_tables.counts[tile, wedge].to(torch.int64), max=n_slots)
        slot = torch.arange(n_slots, device=device)
        ids = torch.where(slot[None, :] < cnt[:, None], ids, s_pad)
        listed = torch.zeros((n, s_pad + 1), dtype=torch.bool, device=device)
        listed.scatter_(1, ids, True)
        allowed |= listed[:, :s_pad]
    if cand_tables.chunk_ids is not None:
        cids = cand_tables.chunk_ids[tile, wedge].to(torch.int64)  # (N, C)
        n_chunks = cids.shape[-1]
        ccnt = cand_tables.chunk_counts[tile, wedge].to(torch.int64)
        slot = torch.arange(n_chunks, device=device)
        cids = torch.where(slot[None, :] < ccnt[:, None], cids, n_chunks)
        chunks = torch.zeros((n, n_chunks + 1), dtype=torch.bool, device=device)
        chunks.scatter_(1, cids, True)
        allowed |= chunks[:, :n_chunks].repeat_interleave(SEG_CHUNK, dim=1)[:, :s_pad]
    return allowed


def trace_sums_plain(
    scene: dev.DeviceScene,
    camera: Camera,
    config: RenderConfig,
    frame: int,
    px_start: int,
    n_px: int,
    cand_tables: CandTables | None = None,
):
    """The plain PyTorch version of the trace kernel, on any device:
    broadcast (rays x segments) tensors, chunked over whole pixels so the
    intermediates stay bounded.  With ``cand_tables`` the primary rays
    consider exactly the segments their cell's tables declare hittable (the
    segment list and the members of the listed chunks) and take the exact
    (key, id) minimum over them, with none of the kernel's early exits: the
    kernel's arithmetic without its shortcuts.  Conservative tables give
    the sums of the full sweep bit for bit.

    The chunks lie on the frame's pixel grid: chunk k holds the frame's
    pixels [k P, (k + 1) P), P the largest divisor of a tile row's pixels
    within the pair budget, cut to the call's pixels.  PyTorch's CPU
    kernels round a vector body and its tail differently, so a pixel's last
    bit can depend on its chunk; on this grid a call on any run of whole
    tile rows computes each pixel in the chunk the whole frame's call does."""
    w = scene.width
    rpp = config.rays_per_pixel
    device = scene.device
    rays_per_chunk = _PLAIN_CHUNK_PAIRS[device.type == "cuda"] // max(scene.s_pad, LEVEL_SLOTS)
    _, _, sw, n_wedges, tile_h, tiles_x, _, _ = _grid_geom(scene, config, w, n_px)
    pitch = _largest_divisor(tile_h * w, max(1, rays_per_chunk // rpp))
    csum = torch.empty((n_px, 3), dtype=torch.float32, device=device)
    wsum = torch.empty((n_px,), dtype=torch.float32, device=device)
    bsum = torch.empty((n_px,), dtype=torch.float32, device=device)
    p0 = 0
    while p0 < n_px:
        npx = min(((px_start + p0) // pitch + 1) * pitch - px_start, n_px) - p0
        pixel_rel = (p0 + torch.arange(npx, device=device)).repeat_interleave(rpp)
        sample_ids = torch.arange(rpp, device=device).repeat(npx)
        origins, dirs = intersect.make_rays(
            px_start + pixel_rel, sample_ids, w, scene.height, camera, config, frame
        )
        allowed = None
        if cand_tables is not None:
            allowed = _allowed_mask(
                scene, cand_tables, pixel_rel, sample_ids, tile_h, tiles_x, sw, n_wedges
            )
        color, weight, blur = intersect.trace_full(scene, origins, dirs, config, allowed)
        color = color.reshape(npx, rpp, 3)
        weight = weight.reshape(npx, rpp)
        blur = blur.reshape(npx, rpp)
        csum[p0 : p0 + npx] = torch.sum(color * weight[..., None], dim=1)
        wsum[p0 : p0 + npx] = torch.sum(weight, dim=1)
        bsum[p0 : p0 + npx] = torch.sum(blur * weight, dim=1)
        p0 += npx
    return csum, wsum, bsum


def _largest_divisor(n: int, most: int) -> int:
    """The largest divisor of ``n`` not above ``most`` (>= 1)."""
    return max(q for d in range(1, math.isqrt(n) + 1) if n % d == 0
               for q in (d, n // d) if q <= most)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, dtype, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _table_pointers(tables: CandTables | None, n_tiles: int, n_wedges: int):
    """Checked device pointers of the tables in the kernel's argument
    order: (ids, counts, cand_len, lbs, horizon, chunk_ids, chunk_lbs,
    chunk_counts, chunk_slots, circle), and the tables' wedge count (W >>
    their wedge shift; W without tables); None and 0 for what a kind
    lacks."""
    if tables is None:
        return (None, None, 0, None, None, None, None, None, 0, None), n_wedges
    cells = (n_tiles, n_wedges >> table_wedge_shift(tables, n_wedges))
    ids_ptr = cnt_ptr = lbs_ptr = hor_ptr = None
    cand_len = 0
    if tables.ids is not None:
        _check(tables.ids, "cand ids", torch.int32)
        if tuple(tables.ids.shape[:2]) != cells:
            raise ValueError(
                f"cand ids shape {tuple(tables.ids.shape)} does not match the "
                f"{cells} tile/wedge grid"
            )
        cand_len = tables.ids.shape[-1]
        _check(tables.counts, "cand counts", torch.int32, cells)
        ids_ptr, cnt_ptr = tables.ids.data_ptr(), tables.counts.data_ptr()
        if tables.lbs is not None:
            _check(tables.lbs, "cand lbs", torch.float32, tables.ids.shape)
            _check(tables.horizon, "cand horizon", torch.float32, cells)
            lbs_ptr, hor_ptr = tables.lbs.data_ptr(), tables.horizon.data_ptr()
    cid_ptr = clb_ptr = ccnt_ptr = None
    chunk_slots = 0
    if tables.chunk_ids is not None:
        _check(tables.chunk_ids, "chunk ids", torch.int32)
        if tuple(tables.chunk_ids.shape[:2]) != cells:
            raise ValueError(
                f"chunk ids shape {tuple(tables.chunk_ids.shape)} does not match the "
                f"{cells} tile/wedge grid"
            )
        chunk_slots = tables.chunk_ids.shape[-1]
        _check(tables.chunk_lbs, "chunk lbs", torch.float32, tables.chunk_ids.shape)
        _check(tables.chunk_counts, "chunk counts", torch.int32, cells)
        cid_ptr, clb_ptr, ccnt_ptr = (
            tables.chunk_ids.data_ptr(), tables.chunk_lbs.data_ptr(),
            tables.chunk_counts.data_ptr(),
        )
    circle_ptr = None
    if tables.dist_ordered:
        if tables.circle is None:
            raise ValueError("distance-ordered tables need the scene circle")
        _check(tables.circle, "scene circle", torch.float32, (4,))
        circle_ptr = tables.circle.data_ptr()
    if ids_ptr is None and cid_ptr is None:
        raise ValueError("candidate tables hold neither segment nor chunk lists")
    return (ids_ptr, cnt_ptr, cand_len, lbs_ptr, hor_ptr, cid_ptr, clb_ptr, ccnt_ptr,
            chunk_slots, circle_ptr), cells[1]


def launch_args(scene, camera, config, frame, px_start, n_px, cand_tables, out, stats=None):
    """The arguments of csrc/trace.cu's rtdc_trace_sums after its first two
    (the scene's records), checked: the scene's sizes, the tables' device
    pointers, ``stats`` (or None), the (5, n_px) float32 ``out``, the launch
    geometry with the tables' wedge count, camera and config, and the
    current stream."""
    w, h = scene.width, scene.height
    _, pxb, sw, n_wedges, tile_h, tiles_x, tiles_y, n_tiles = _grid_geom(
        scene, config, w, n_px
    )
    table_args, tab_wedges = _table_pointers(cand_tables, n_tiles, n_wedges)
    stats_ptr = None
    if stats is not None:
        _check(stats, "stats", torch.int32, (len(STAT_NAMES), n_px))
        stats_ptr = stats.data_ptr()
    _check(out, "out", torch.float32, (5, n_px))
    stream = torch.cuda.current_stream(scene.device).cuda_stream
    return (
        scene.s_pad, scene.n_sub,
        *table_args, stats_ptr,
        out.data_ptr(), n_px,
        w, h, px_start, tiles_x, tiles_y, tile_h, pxb,
        config.rays_per_pixel, sw, n_wedges, tab_wedges,
        float(camera.zoom_factor), float(camera.offset_x), float(camera.offset_y),
        int(frame) & 0xFFFFFFFF, int(config.seed) & 0xFFFFFFFF,
        int(config.use_aa), int(config.diffusion_curve_save),
        int(config.exact_silhouettes), n_traces(scene, config),
        float(config.min_hit_distance), ctypes.c_void_p(stream),
    )


def _trace_sums_cuda(scene, camera, config, frame, px_start, n_px, cand_tables, stats=None):
    """Launch csrc/trace.cu on the scene's card; one launch per call.
    ``stats``: (len(STAT_NAMES), n_px) int32 zeros selects the counting
    instantiation, which adds its per-pixel counters there."""
    global LAUNCHES
    from . import _build  # builds csrc/trace.cu on first use

    s_pad = scene.s_pad
    _check(scene.walk_records, "walk_records", torch.float32, (s_pad, dev.WALK_COLS))
    _check(scene.shade_records, "shade_records", torch.float32, (s_pad, dev.ALLT_ROWS))
    for name in ("walk_records", "shade_records"):
        if getattr(scene, name).data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((5, n_px), dtype=torch.float32, device=scene.device)
    args = launch_args(scene, camera, config, frame, px_start, n_px, cand_tables, out, stats)
    lib = _build.load("trace")
    err = lib.rtdc_trace_sums(scene.walk_records.data_ptr(), scene.shade_records.data_ptr(), *args)
    if err != 0:
        raise RuntimeError(f"trace kernel launch failed: {_build.error_string(lib, err)}")
    LAUNCHES += 1
    return out[0:3].T, out[3], out[4]


def trace_kernel_info() -> list[dict]:
    """What the build made of each instantiation of the trace kernel
    (KERNEL_INSTANCES): registers per thread, local (spilled) bytes per
    thread, static and dynamic shared memory per block, blocks per SM at
    the launch's block size, that block size; from cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor on the card."""
    from . import _build

    lib = _build.load("trace")
    if lib.rtdc_trace_info(-1, None) != len(KERNEL_INSTANCES):
        raise RuntimeError("the trace library's instantiations do not match KERNEL_INSTANCES")
    keys = ("registers", "local_bytes", "static_smem_bytes", "dynamic_smem_bytes",
            "blocks_per_sm", "block_threads")
    out = []
    for i, name in enumerate(KERNEL_INSTANCES):
        vals = (ctypes.c_int * len(keys))()
        err = lib.rtdc_trace_info(i, vals)
        if err != 0:
            raise RuntimeError(f"trace kernel attributes: {_build.error_string(lib, err)}")
        out.append({"name": name, **dict(zip(keys, vals))})
    return out
