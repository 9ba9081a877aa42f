"""Per-(tile, wedge) segment candidate lists — the acceleration structure of
the main path.

The reference culls per ray through OptiX's BVH (optixHello.cpp:764-830).
Here rays are culled per *cell*: every ray of a (pixel tile x direction
wedge) cell originates inside one circle and points into one angular
wedge, so the set of segments it can possibly hit is a function of the
cell only.  This prepass tests every segment's bounding circle against each
cell's cone and compacts the passing segment ids, in ascending id order,
into fixed-length lists; the CUDA trace kernel then walks a cell's list
instead of every segment.

Exactness: the circle/cone test is conservative (the JAX package's
``ops/candidates.py`` math, operation for operation, so the lists are
identical to its ``_segment_ids(order="id")``), and lists hold every
passing segment (no cap), so the kernel's winners equal the full sweep's.

Layout: ids (T, W, L) int32, global segment ids padded with s_pad, and
counts (T, W) int32.  The TPU layout's transposed per-cell consts and bf16
shade tables are not carried over: the kernel reads scene rows by id.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..scene import device as dev

# Candidate lists pay off only when the full sweep is longer than this.
CAND_LEN = 32
# Largest wedge count that gets candidate lists (the JAX package's cap; its
# tables are per wedge and the two packages must pick the same kind).
CAND_MAX_WEDGES = 64
# Largest scene (padded sub-segments) whose lists this port builds: lists
# hold every passing segment in ascending id order, so one list is at most
# s_pad long.  Larger scenes (the JAX package's capped, distance-ordered
# multi-level lists) take the kernel's full sweep for now.
CAND_MAX_SPAD = 128


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
):
    """Per-(tile, wedge) passing segment ids in ascending id order.

    Returns (ids (T, W, L) int32 padded with s_pad, counts (T, W) int32
    capped at cand_len + 1).  The JAX package's ``_segment_ids`` with
    ``order="id"``, in (T, W) layout."""
    f32 = torch.float32
    device = consts.device
    s_pad = consts.shape[0]
    bcx, bcy, br = _tile_circles(
        width, height, zoom, off_x, off_y, tiles_x, tiles_y, tile_w,
        tile_h, px_start, diffusion_save, device=device,
    )
    n_tiles = tiles_x * tiles_y

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
    wcx = torch.from_numpy(wcx).to(device)[:, None, None]  # (W, 1, 1)
    wcy = torch.from_numpy(wcy).to(device)[:, None, None]
    iota = torch.arange(s_pad, dtype=torch.int32, device=device)

    # Tile batches bound the (W, TB, S) working set at ~16M elements.
    tb = max(1, min(n_tiles, (1 << 24) // max(s_pad * n_wedges, 1)))
    ids_out = torch.empty((n_tiles, n_wedges, cand_len), dtype=torch.int32, device=device)
    cnt_out = torch.empty((n_tiles, n_wedges), dtype=torch.int32, device=device)
    for t0 in range(0, n_tiles, tb):
        t1 = min(n_tiles, t0 + tb)
        dcx = mx[None, :] - bcx[t0:t1, None]  # (TB, S)
        dcy = my[None, :] - bcy[t0:t1, None]
        dist = torch.sqrt(dcx * dcx + dcy * dcy)
        inv_dist = 1.0 / torch.clamp(dist, min=1e-6)
        reach = sr[None, :] + br[t0:t1, None]
        sin_chw = torch.clamp(reach * inv_dist, 0.0, 1.0)
        cos_chw = torch.sqrt(torch.clamp(1.0 - sin_chw * sin_chw, min=0.0))
        overlap = dist <= reach
        dnx = dcx * inv_dist
        dny = dcy * inv_dist
        # --- cone test per wedge, batched as (W, TB, S) ---
        cos_d = dnx[None] * wcx + dny[None] * wcy
        cos_lim = cos_hw * cos_chw - sin_hw * sin_chw
        mask = valid[None, None, :] & (overlap[None] | (cos_d >= cos_lim[None]))
        key = torch.where(mask, iota, s_pad)
        ids = torch.sort(key, dim=-1).values[..., :cand_len]
        count = torch.clamp(mask.sum(dim=-1), max=cand_len + 1)
        ids_out[t0:t1] = ids.permute(1, 0, 2)
        cnt_out[t0:t1] = count.permute(1, 0).to(torch.int32)
    return ids_out, cnt_out
