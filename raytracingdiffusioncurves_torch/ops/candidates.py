"""Per-(tile, wedge) candidate lists — the acceleration structure of the
trace kernel.

The reference culls per ray through OptiX's BVH (optixHello.cpp:764-830).
Here rays are culled per *cell*: every ray of a (pixel tile x direction
wedge) cell originates inside one circle and points into one angular
wedge, so the set of segments it can possibly hit is a function of the
cell only.  This prepass tests every segment's bounding circle against each
cell's cone and compacts the passing segment ids into fixed-length lists;
the CUDA trace kernel then walks a cell's list instead of every segment.

Two list orders (``segment_ids``):

* ``order="id"`` — ascending segment id, every passing segment kept (the
  list is as long as the scene).  Scenes of at most 128 padded sub-segments
  use it; ``narrow_cand_tables`` cuts the lists to the largest count.
* ``order="dist"`` — ascending conservative lower-bound distance
  ``lb = max(dist - reach, 0)`` from the tile's origin circle to the
  band-widened segment (stable: equal ``lb`` keeps ascending id), cut to
  ``cand_len`` slots.  Each cell also records its **horizon**, the ``lb`` of
  the first segment that did not fit (1e30 when none was dropped): a ray
  whose best hit is nearer than the horizon cannot be beaten by a dropped
  segment.  Dense scenes use it; a ray whose best hit is still beyond the
  horizon continues into the cell's chunk list.

``chunk_candidates`` builds the chunk lists: for each cell the chunks of
SEG_ALIGN consecutive segments (``scene.chunk_bounds``) that pass the cone
test, sorted by their own lower-bound distance.  With ``keep`` (from
``segment_ids(chunk_cover=True)``) chunks whose passing segments all sit
inside the segment list are left out.

Exactness: the circle/cone test is conservative (the JAX package's
``ops/candidates.py`` math, operation for operation, so without
``key_guard`` the tables equal its ``_segment_ids`` and
``chunk_candidates``), every dropped segment has ``lb >= horizon`` and lies
in a kept chunk.

**The key guard.**  The kernel stops a ray's walk at the first slot whose
``lb`` exceeds the ray's best ordering key, so ``lb`` has to bound a
segment's *key* from below, not just its distance.  The key is no distance:
it is the ray parameter of the crossing with the chord's *line*, corrected
by a parabola term (scene/device.py CONST_QUAD), and the band-widened
acceptance admits crossings up to band / |sin(theta)| beyond the chord's
ends, theta being the angle between ray and chord.  For a ray that runs
nearly parallel to a far chord and passes within its band, the key comes
out anywhere, down to the clamp 1e-30, and such a segment wins the band
chain of the full sweep although every distance bound says it is far; the
crossing may even lie behind the origin, by up to band / (|chord|
|sin(theta)|), where the forward cone of the wedge does not look.
With ``key_guard = sigma`` the tables are conservative with respect to
what the sweep accepts, and the bounds become bounds of the key:

* a segment whose chord can be within asin(sigma) of parallel to some ray
  of the wedge (a *hazard* of the cell) passes the cone test on the
  backward cone too and gets ``lb = 0``: it sorts first and is always
  tested;
* every other segment has |sin(theta)| >= sigma for all rays of the wedge,
  so it is accepted from at most ``slack`` behind the origin (it passes
  when its circle comes within ``slack`` of the tile's), and its key is at
  least ``lb - slack``, with the per-segment ``key_slack`` below; the
  tables store ``max(lb - slack, 0)``;
* a chunk passes and is bounded like a segment, with its largest member
  slack, and is a hazard where a member is; where a cell's horizon is 0
  (hazards may have been dropped from the list) its chunk bounds are 0
  too, and without segment lists a hazard chunk gets 0.

With the guard, list + chunk walk find the full sweep's winners for every
ray (tests/test_torch_trace_dense.py walks them in plain tensor code).

Layout: ids (T, W, L) int32 global segment ids padded with s_pad, lbs
(T, W, L) float32 padded with 1e30, counts and horizon (T, W); chunk ids and
lbs (T, W, C).  The TPU layout's transposed per-cell consts, per-group lbs
and bf16 shade tables are not carried over: the kernel reads scene rows by
id.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..scene import device as dev
from ..utils.timing import span

# Candidate lists pay off only when the full sweep is longer than this.
CAND_LEN = 32
# Largest wedge count that gets segment lists (the JAX package's cap; its
# tables are per wedge and the two packages must pick the same kind).
CAND_MAX_WEDGES = 64
# Largest scene (padded sub-segments) that gets segment lists; larger scenes
# take chunk lists only.
CAND_MAX_SPAD = 32768
# Lower bound of a slot or chunk that holds nothing.
FAR_LB = 1e30
# Elements of one (wedges x tiles x segments) batch of the prepass.
_BATCH_ELEMS = 1 << 24
# Sine of the key guard: chords within asin(0.05) = 2.9 degrees of a
# ray's direction count as parallel.  Smaller means fewer hazards per cell
# (always-tested slots) and a larger slack (slack ~ band / sigma).
KEY_GUARD_SIN = 0.05


def use_candidates(s_pad: int, n_wedges: int) -> bool:
    """Whether a scene gets segment candidate lists: the full sweep must be
    longer than a list and the wedge must actually narrow directions."""
    return CAND_LEN < s_pad <= CAND_MAX_SPAD and 1 < n_wedges <= CAND_MAX_WEDGES


def _tile_circles(
    width, height, zoom, off_x, off_y, tiles_x, tiles_y, tile_w, tile_h,
    px_start, diffusion_save, device=None,
):
    """(bcx, bcy, br) each (T,) float32: world-space bounding circles of
    every pixel tile's ray origins (AA jitter [0, zoom) included), in the
    kernel's row-major tile order tile = tile_row * tiles_x + tile_col."""
    f32 = torch.float32
    zoom = float(np.float32(zoom))
    off_x = float(np.float32(off_x))
    off_y = float(np.float32(off_y))

    tc = torch.arange(tiles_x, dtype=torch.int64, device=device)
    tr = torch.arange(tiles_y, dtype=torch.int64, device=device)
    col0 = (tc * tile_w - width // 2).to(f32)
    x_a = col0 * zoom + off_x
    x_b = (col0 + float(tile_w - 1)) * zoom + off_x + zoom  # + [0, zoom) jitter
    x_lo = torch.minimum(x_a, x_b)
    x_hi = torch.maximum(x_a, x_b)

    row0 = px_start // width + tr * tile_h
    if diffusion_save:
        ya = ((height - row0) - height // 2).to(f32) * zoom + off_y
        yb = ((height - (row0 + tile_h - 1)) - height // 2).to(f32) * zoom + off_y
    else:
        ya = (row0 - height // 2).to(f32) * zoom + off_y
        yb = ((row0 + tile_h - 1) - height // 2).to(f32) * zoom + off_y
    y_lo = torch.minimum(torch.minimum(ya, yb), torch.minimum(ya, yb) + zoom)
    y_hi = torch.maximum(torch.maximum(ya, yb), torch.maximum(ya, yb) + zoom)

    cx = 0.5 * (x_lo + x_hi)  # (Tx,)
    cy = 0.5 * (y_lo + y_hi)  # (Ty,)
    rx = 0.5 * (x_hi - x_lo)
    ry = 0.5 * (y_hi - y_lo)
    bcx = cx[None, :].expand(tiles_y, tiles_x).reshape(-1)
    bcy = cy[:, None].expand(tiles_y, tiles_x).reshape(-1)
    br = torch.sqrt(
        (rx * rx)[None, :].expand(tiles_y, tiles_x).reshape(-1)
        + (ry * ry)[:, None].expand(tiles_y, tiles_x).reshape(-1)
    )
    return bcx, bcy, br


def _origin_circles(circles, width, height, zoom, off_x, off_y, tiles_x, tiles_y, tile_w,
                    tile_h, px_start, diffusion_save, device):
    """The given (bcx, bcy, br) circles on ``device``, or the pixel tiles'."""
    if circles is not None:
        return tuple(torch.as_tensor(c, dtype=torch.float32, device=device) for c in circles)
    return _tile_circles(
        width, height, zoom, off_x, off_y, tiles_x, tiles_y, tile_w, tile_h,
        px_start, diffusion_save, device=device,
    )


def _wedge_dirs(rpp: int, sw: int):
    """Wedge center unit vectors (as two float64 numpy arrays rounded to
    f32) + half-width cos/sin as f32-exact Python floats."""
    n_wedges = rpp // sw
    sector = 2.0 * math.pi / rpp
    hw = math.pi * sw / rpp
    wc = sector * (np.arange(n_wedges) * sw + 0.5 * sw)
    return (
        np.cos(wc).astype(np.float32),
        np.sin(wc).astype(np.float32),
        float(np.float32(math.cos(hw))),
        float(np.float32(math.sin(hw))),
    )


def _upload_dirs(wcx: np.ndarray, wcy: np.ndarray, device):
    """_wedge_dirs' centre vectors as tensors on ``device``: a copy from
    pageable host memory, which blocks the host until the card has run
    what was queued before it."""
    with span("sync.wedge_dirs"):
        return torch.from_numpy(wcx).to(device), torch.from_numpy(wcy).to(device)


def key_slack(consts: torch.Tensor, guard_sin: float) -> torch.Tensor:
    """(S,) float32: how far below its distance bound a segment's ordering
    key can lie for a ray at |sin(theta)| >= guard_sin to its chord (0 for
    invalid rows).  With b the band, e the chord and d = b / (|e| sigma) the
    widest overshoot of the chord parameter: the crossing with the chord's
    line lies within b / sigma of the chord, or up to d behind the origin;
    the parabola term moves the key by at most 4 b max(1/4, d (1 + d)) /
    sigma.  1% and 1e-3 on top cover float32 rounding and the directions'
    5e-7 deviation from unit length."""
    b = consts[:, dev.CONST_BAND]
    ex, ey = consts[:, dev.CONST_EX], consts[:, dev.CONST_EY]
    chord = torch.clamp(torch.sqrt(ex * ex + ey * ey), min=1e-12)
    d = b / (chord * guard_sin)
    slack = b / guard_sin + d + 4.0 * b * torch.clamp(d * (1.0 + d), min=0.25) / guard_sin
    return torch.where(consts[:, dev.CONST_VALID] > 0.0, slack * 1.01 + 1e-3, 0.0)


def parallel_hazards(consts: torch.Tensor, rpp: int, sw: int, guard_sin: float) -> torch.Tensor:
    """(W, S) bool: the segment's chord can be within asin(guard_sin) of
    parallel to a ray of the wedge (directions within the wedge's half-width
    of its centre; 1e-4 rad on top for the sincos error)."""
    ex, ey = consts[:, dev.CONST_EX], consts[:, dev.CONST_EY]
    chord = torch.clamp(torch.sqrt(ex * ex + ey * ey), min=1e-12)
    wcx, wcy, _, _ = _wedge_dirs(rpp, sw)
    reach = math.pi * sw / rpp + math.asin(min(guard_sin, 1.0)) + 1e-4
    if reach >= 0.5 * math.pi:
        return torch.ones((wcx.shape[0], consts.shape[0]), dtype=torch.bool, device=consts.device)
    wcx, wcy = _upload_dirs(wcx, wcy, consts.device)
    wcx, wcy = wcx[:, None], wcy[:, None]
    sin_to_centre = torch.abs(wcx * (ey / chord)[None, :] - wcy * (ex / chord)[None, :])
    return sin_to_centre <= math.sin(reach)


def chunk_guard(consts: torch.Tensor, rpp: int, sw: int, guard_sin: float):
    """The key guard at chunk granularity: (slack (C,), a chunk's largest
    member slack; hazard (W, C) bool, some valid member is a hazard of the
    wedge).  consts rows are padded to whole chunks."""
    n_chunks = consts.shape[0] // dev.SEG_ALIGN
    slack = key_slack(consts, guard_sin).reshape(n_chunks, dev.SEG_ALIGN).amax(dim=-1)
    hazard = parallel_hazards(consts, rpp, sw, guard_sin) & (consts[:, dev.CONST_VALID] > 0.0)
    return slack, hazard.reshape(-1, n_chunks, dev.SEG_ALIGN).any(dim=-1)


def _cone_terms(cxs, cys, rs, bcx, bcy, br):
    """Circle-vs-tile terms of the cone test for bounding circles (cxs,
    cys, rs) (S,) against tile circles (TB,): (dist - reach, dnx, dny,
    cos_chw, sin_chw), each (TB, S).  The circles overlap where dist - reach
    <= 0."""
    dcx = cxs[None, :] - bcx[:, None]
    dcy = cys[None, :] - bcy[:, None]
    dist = torch.sqrt(dcx * dcx + dcy * dcy)
    inv_dist = 1.0 / torch.clamp(dist, min=1e-6)
    reach = rs[None, :] + br[:, None]
    sin_chw = torch.clamp(reach * inv_dist, 0.0, 1.0)
    cos_chw = torch.sqrt(torch.clamp(1.0 - sin_chw * sin_chw, min=0.0))
    return dist - reach, dcx * inv_dist, dcy * inv_dist, cos_chw, sin_chw


def _passing(gap, dnx, dny, cos_chw, sin_chw, wcx, wcy, cos_hw, sin_hw, valid,
             slack=None, hazard=None):
    """(W, TB, S) bool: the circles that pass each wedge's cone test.
    ``gap`` = dist - reach.  With the key guard's ``slack`` (S,) and
    ``hazard`` (W, S): circles within slack of the tile's pass, and hazards
    pass on the backward cone too."""
    cos_d = dnx[None] * wcx + dny[None] * wcy
    cos_lim = (cos_hw * cos_chw - sin_hw * sin_chw)[None]
    if slack is None:
        return valid[None, None, :] & ((gap <= 0.0)[None] | (cos_d >= cos_lim))
    near = (gap <= slack[None, :])[None]
    back = hazard[:, None, :] & (cos_d <= -cos_lim)
    return valid[None, None, :] & (near | (cos_d >= cos_lim) | back)


def _bounds(gap, slack=None, hazard=None):
    """(W or 1, TB, S) lower bounds: of the distance, max(gap, 0), or with
    the key guard's ``slack`` of the ordering key, max(gap - slack, 0), and
    0 for the ``hazard`` (W, S) circles."""
    if slack is None:
        return torch.clamp(gap, min=0.0)[None]
    lb = torch.clamp(gap - slack[None, :], min=0.0)[None]
    if hazard is not None:
        lb = torch.where(hazard[:, None, :], 0.0, lb)
    return lb


def segment_ids(
    consts: torch.Tensor,
    width: int,
    height: int,
    zoom,
    off_x,
    off_y,
    rpp: int,
    sw: int,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    px_start: int,
    diffusion_save: bool,
    cand_len: int,
    order: str = "id",
    chunk_cover: bool = False,
    key_guard: float | None = None,
    circles=None,
):
    """Per-(tile, wedge) passing segment ids: the JAX package's
    ``_segment_ids`` in (T, W) layout.

    Returns (ids (T, W, L) int32 padded with s_pad, L = min(cand_len,
    s_pad); counts (T, W) int32 capped at cand_len + 1; lbs (T, W, L)
    float32 lower-bound distances padded with 1e30; horizon (T, W) float32
    or None; cmax (T, W, n_chunks) float32 or None).

    ``order``: "id" sorts slots by ascending segment id; "dist" by ascending
    lower-bound distance (stable, so equal lbs stay id-ordered) and returns
    the horizon: the lb of the first segment that did not fit the list (1e30
    when nothing was dropped).  ``chunk_cover`` also returns cmax: each
    SEG_ALIGN-aligned chunk's largest passing-segment lb (-1 when none
    pass); a chunk with cmax < horizon has every hittable segment inside the
    list.  Requires s_pad % SEG_ALIGN == 0.  ``key_guard``: sine of the key
    guard (module docstring); the lower bounds then bound each segment's
    ordering key.  None gives the JAX package's distance bounds.
    ``circles``: optional (bcx, bcy, br) (T,) float32 origin circles in
    place of the pixel tiles' (camera and tile arguments then unused): the
    world grid's cells (trace_cuda.build_cand_grid)."""
    if order not in ("id", "dist"):
        raise ValueError(f"order must be 'id' or 'dist', got {order!r}")
    f32 = torch.float32
    device = consts.device
    s_pad = consts.shape[0]
    if chunk_cover and s_pad % dev.SEG_ALIGN != 0:
        raise ValueError(f"chunk_cover needs s_pad % {dev.SEG_ALIGN} == 0, got {s_pad}")
    bcx, bcy, br = _origin_circles(
        circles, width, height, zoom, off_x, off_y, tiles_x, tiles_y, tile_w,
        tile_h, px_start, diffusion_save, device,
    )
    n_tiles = bcx.shape[0]

    # --- segment bounding circles from the intersection constants ---
    p0x = consts[:, dev.CONST_P0X]
    p0y = consts[:, dev.CONST_P0Y]
    ex = consts[:, dev.CONST_EX]
    ey = consts[:, dev.CONST_EY]
    valid = consts[:, dev.CONST_VALID] > 0.0
    mx = p0x + 0.5 * ex
    my = p0y + 0.5 * ey
    # chord half-length + silhouette band: the exact cubic can bulge up to
    # CONST_BAND beyond the chord, and the band-widened sweep can accept
    # hits there — the cull stays conservative with respect to it.
    sr = 0.5 * torch.sqrt(ex * ex + ey * ey) + consts[:, dev.CONST_BAND]

    wcx, wcy, cos_hw, sin_hw = _wedge_dirs(rpp, sw)
    n_wedges = wcx.shape[0]
    wcx, wcy = _upload_dirs(wcx, wcy, device)
    wcx, wcy = wcx[:, None, None], wcy[:, None, None]  # (W, 1, 1)
    iota = torch.arange(s_pad, dtype=torch.int32, device=device)
    n_list = min(cand_len, s_pad)
    slack = hazard = None
    if key_guard is not None:
        slack = key_slack(consts, key_guard)
        hazard = parallel_hazards(consts, rpp, sw, key_guard)  # (W, S)

    # Tile batches bound the (W, TB, S) working set.
    tb = max(1, min(n_tiles, _BATCH_ELEMS // max(s_pad * n_wedges, 1)))
    ids_out = torch.empty((n_tiles, n_wedges, n_list), dtype=torch.int32, device=device)
    lbs_out = torch.empty((n_tiles, n_wedges, n_list), dtype=f32, device=device)
    cnt_out = torch.empty((n_tiles, n_wedges), dtype=torch.int32, device=device)
    hor_out = cmax_out = None
    if order == "dist":
        hor_out = torch.full((n_tiles, n_wedges), FAR_LB, dtype=f32, device=device)
    if chunk_cover:
        cmax_out = torch.empty(
            (n_tiles, n_wedges, s_pad // dev.SEG_ALIGN), dtype=f32, device=device
        )
    for t0 in range(0, n_tiles, tb):
        t1 = min(n_tiles, t0 + tb)
        # --- cone test per wedge, batched as (W, TB, S) ---
        terms = _cone_terms(mx, my, sr, bcx[t0:t1], bcy[t0:t1], br[t0:t1])
        mask = _passing(*terms, wcx, wcy, cos_hw, sin_hw, valid, slack, hazard)
        lb = _bounds(terms[0], slack, hazard)
        lb_m = torch.where(mask, lb, FAR_LB)
        if order == "dist":
            lbs_s, ids_s = torch.sort(lb_m, dim=-1, stable=True)
            if s_pad > cand_len:
                hor_out[t0:t1] = lbs_s[..., cand_len].permute(1, 0)
            lbs_s = lbs_s[..., :n_list]
            # masked entries keep their id through the sort: park them
            ids = torch.where(lbs_s < FAR_LB, ids_s[..., :n_list].to(torch.int32), s_pad)
        else:
            key = torch.where(mask, iota, s_pad)
            ids = torch.sort(key, dim=-1).values[..., :n_list]
            lbs_s = torch.where(
                ids < s_pad,
                torch.gather(lb_m, -1, torch.clamp(ids, max=s_pad - 1).to(torch.int64)),
                FAR_LB,
            )
        ids_out[t0:t1] = ids.permute(1, 0, 2)
        lbs_out[t0:t1] = lbs_s.permute(1, 0, 2)
        count = torch.clamp(mask.sum(dim=-1), max=cand_len + 1)
        cnt_out[t0:t1] = count.permute(1, 0).to(torch.int32)
        if chunk_cover:
            cm = torch.where(mask, lb, -1.0)
            cm = cm.reshape(n_wedges, t1 - t0, s_pad // dev.SEG_ALIGN, dev.SEG_ALIGN)
            cmax_out[t0:t1] = cm.amax(dim=-1).permute(1, 0, 2)
    return ids_out, cnt_out, lbs_out, hor_out, cmax_out


def chunk_candidates(
    chunk_bounds: torch.Tensor,
    width: int,
    height: int,
    zoom,
    off_x,
    off_y,
    rpp: int,
    sw: int,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    px_start: int,
    diffusion_save: bool,
    keep: torch.Tensor | None = None,
    slack: torch.Tensor | None = None,
    hazard: torch.Tensor | None = None,
    circles=None,
):
    """Chunk-granularity candidate lists (the JAX package's
    ``chunk_candidates``).

    Returns (ids (T, W, C) int32, lbs (T, W, C) float32, counts (T, W)
    int32): for each (tile, wedge), the chunk ids that pass the cone test
    sorted by conservative lower-bound distance (stable), their bounds (1e30
    past the count), and how many passed.  The trace kernel walks the first
    ``count`` entries and stops once the next bound exceeds the ray's best
    hit.  Primary rays only (unit directions).

    ``keep``: optional (T, W, C) bool; chunks marked False (every hittable
    segment already sits in the cell's segment list) are left out.
    ``slack`` (C,) and ``hazard`` (W, C) bool belong to the key guard
    (both or neither): a chunk within its slack of the tile passes, a hazard
    of the wedge passes on the backward cone too, and a chunk's bound drops
    by its slack.  Without ``keep`` (chunk lists alone) a hazard chunk also
    gets bound 0 and is always walked; with it the cell's segment list holds
    the hazards (bound 0, first).  ``circles``: as in segment_ids."""
    device = chunk_bounds.device
    n_chunks = chunk_bounds.shape[0]
    bcx, bcy, br = _origin_circles(
        circles, width, height, zoom, off_x, off_y, tiles_x, tiles_y, tile_w,
        tile_h, px_start, diffusion_save, device,
    )
    n_tiles = bcx.shape[0]
    wcx, wcy, cos_hw, sin_hw = _wedge_dirs(rpp, sw)
    n_wedges = wcx.shape[0]
    wcx, wcy = _upload_dirs(wcx, wcy, device)
    wcx, wcy = wcx[:, None, None], wcy[:, None, None]  # (W, 1, 1)

    cxs, cys, rs = chunk_bounds[:, 0], chunk_bounds[:, 1], chunk_bounds[:, 2]
    valid = cxs < 1e29  # padding chunks are parked at 1e30

    tb = max(1, min(n_tiles, _BATCH_ELEMS // max(n_chunks * n_wedges, 1)))
    ids_out = torch.empty((n_tiles, n_wedges, n_chunks), dtype=torch.int32, device=device)
    lbs_out = torch.empty((n_tiles, n_wedges, n_chunks), dtype=torch.float32, device=device)
    cnt_out = torch.empty((n_tiles, n_wedges), dtype=torch.int32, device=device)
    for t0 in range(0, n_tiles, tb):
        t1 = min(n_tiles, t0 + tb)
        terms = _cone_terms(cxs, cys, rs, bcx[t0:t1], bcy[t0:t1], br[t0:t1])
        if n_wedges > 1:
            # cos-monotonicity needs hw + chw <= pi, i.e. hw <= pi/2: true
            # for every wedge count >= 2
            mask = _passing(*terms, wcx, wcy, cos_hw, sin_hw, valid, slack, hazard)
        else:
            # single wedge = full circle: distance ordering only
            mask = valid[None, None, :].expand(1, t1 - t0, n_chunks)
        lb = _bounds(terms[0], slack, hazard if keep is None else None)
        if keep is not None:
            mask = mask & keep[t0:t1].permute(1, 0, 2)
        lbs_s, ids_s = torch.sort(torch.where(mask, lb, FAR_LB), dim=-1, stable=True)
        ids_out[t0:t1] = ids_s.permute(1, 0, 2).to(torch.int32)
        lbs_out[t0:t1] = lbs_s.permute(1, 0, 2)
        cnt_out[t0:t1] = mask.sum(dim=-1).permute(1, 0).to(torch.int32)
    return ids_out, lbs_out, cnt_out
