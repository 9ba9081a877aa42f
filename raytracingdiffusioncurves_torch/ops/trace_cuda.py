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
tables compare 1:1 between the two packages.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..config import Camera, RenderConfig
from ..scene import device as dev
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
# Candidate tables larger than this take the full sweep instead.
_CAND_TABLE_BYTES_CAP = 2 << 30
# Rays per chunk of the plain version (CPU, CUDA): bounds its (rays x
# segments) intermediates to tens of MB on the CPU, a few GB on the card.
_PLAIN_CHUNK_RAYS = (1 << 14, 1 << 18)

# Launches of the CUDA trace kernel since the last reset (one per
# trace_sums_flat call on a CUDA tensor).  chip_smoke.py reads it to show
# that the main path went through the kernel.
LAUNCHES = 0


def reset_launch_count() -> None:
    global LAUNCHES
    LAUNCHES = 0


class CandTables(NamedTuple):
    """Camera-dependent acceleration tables of one (camera, pixel band):
    ids (T, W, L) int32 global segment ids in ascending order, padded with
    s_pad; counts (T, W) int32.  The kernel reads the first min(count, L)
    ids of each list unchecked: build the tables with build_cand_tables."""

    ids: torch.Tensor
    counts: torch.Tensor


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


def _n_traces(scene: dev.DeviceScene, config: RenderConfig) -> int:
    return (config.max_trace_depth + 1) if scene.has_portals else 1


def accel_kind(scene: dev.DeviceScene, config: RenderConfig, n_px: int | None = None):
    """"seg" when the scene gets per-(tile, wedge) segment lists, else None
    (the kernel's full sweep)."""
    w = scene.width
    n_px = scene.height * w if n_px is None else n_px
    _, _, _, n_wedges, _, _, _, n_tiles = _grid_geom(scene, config, w, n_px)
    if not cand_mod.use_candidates(scene.s_pad, n_wedges):
        return None
    if n_tiles * n_wedges * scene.s_pad * 4 > _CAND_TABLE_BYTES_CAP:
        return None
    return "seg"


def build_cand_tables(
    scene: dev.DeviceScene,
    camera: Camera,
    config: RenderConfig,
    px_start: int = 0,
    n_px: int | None = None,
) -> CandTables | None:
    """Build the camera-dependent acceleration tables for trace_sums_flat's
    ``cand_tables`` argument (the analogue of the reference's accel build,
    optixHello.cpp:764-830): they depend only on (scene, camera, config,
    pixel band), so a static camera builds them once.  Returns None for
    scenes that take the full sweep.  Tables built for a different camera
    or band mis-cull silently: callers own the invalidation."""
    w, h = scene.width, scene.height
    n_px = h * w if n_px is None else n_px
    if accel_kind(scene, config, n_px) != "seg":
        return None
    _, _, sw, _, tile_h, tiles_x, tiles_y, _ = _grid_geom(scene, config, w, n_px)
    ids, counts = cand_mod.segment_ids(
        scene.seg_consts, w, h, camera.zoom_factor, camera.offset_x,
        camera.offset_y, config.rays_per_pixel, sw, tiles_x, tiles_y,
        TILE_W, tile_h, px_start, config.diffusion_curve_save,
        cand_len=scene.s_pad,
    )
    return CandTables(ids, counts)


def seg_max_count(scene: dev.DeviceScene, cand_tables: CandTables | None) -> int | None:
    """Largest per-(tile, wedge) candidate count of the tables (one host
    sync), or None without tables.  Passed to trace_sums_flat as
    ``gather_len`` it lets the kernel read lists narrowed to that length."""
    del scene
    if cand_tables is None:
        return None
    return int(cand_tables.counts.max())


def narrow_cand_tables(cand_tables: CandTables, gather_len: int) -> CandTables:
    """Tables with each list cut to ``gather_len`` slots (call with
    seg_max_count's value; an under-certified length drops candidates)."""
    gl = max(int(gather_len), 1)
    if cand_tables.ids.shape[-1] <= gl:
        return cand_tables
    return CandTables(cand_tables.ids[..., :gl].contiguous(), cand_tables.counts)


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
    certified max per-cell count (seg_max_count); lists are read up to that
    length."""
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


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _allowed_mask(scene, cand_tables: CandTables, pixel_rel, sample_ids, tile_h, tiles_x, sw):
    """(N, S) bool: segment j is in ray n's (tile, wedge) list."""
    w = scene.width
    row_rel = pixel_rel // w
    col = pixel_rel % w
    tile = (row_rel // tile_h) * tiles_x + col // TILE_W
    wedge = sample_ids // sw
    ids = cand_tables.ids[tile, wedge].to(torch.int64)  # (N, L)
    n_slots = ids.shape[-1]
    cnt = torch.clamp(cand_tables.counts[tile, wedge].to(torch.int64), max=n_slots)
    slot = torch.arange(n_slots, device=ids.device)
    ids = torch.where(slot[None, :] < cnt[:, None], ids, scene.s_pad)
    allowed = torch.zeros(
        (ids.shape[0], scene.s_pad + 1), dtype=torch.bool, device=ids.device
    )
    allowed.scatter_(1, ids, True)
    return allowed[:, : scene.s_pad]


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
    intermediates stay bounded.  With ``cand_tables`` the primary rays only
    consider their cell's list (the kernel's list mode)."""
    w = scene.width
    rpp = config.rays_per_pixel
    device = scene.device
    rays_per_chunk = _PLAIN_CHUNK_RAYS[device.type == "cuda"]
    px_chunk = max(1, min(n_px, rays_per_chunk // rpp))
    _, _, sw, _, tile_h, tiles_x, _, _ = _grid_geom(scene, config, w, n_px)
    csum = torch.empty((n_px, 3), dtype=torch.float32, device=device)
    wsum = torch.empty((n_px,), dtype=torch.float32, device=device)
    bsum = torch.empty((n_px,), dtype=torch.float32, device=device)
    for p0 in range(0, n_px, px_chunk):
        npx = min(px_chunk, n_px - p0)
        pixel_rel = (p0 + torch.arange(npx, device=device)).repeat_interleave(rpp)
        sample_ids = torch.arange(rpp, device=device).repeat(npx)
        origins, dirs = intersect.make_rays(
            px_start + pixel_rel, sample_ids, w, scene.height, camera, config, frame
        )
        allowed = None
        if cand_tables is not None:
            allowed = _allowed_mask(
                scene, cand_tables, pixel_rel, sample_ids, tile_h, tiles_x, sw
            )
        color, weight, blur = intersect.trace_full(scene, origins, dirs, config, allowed)
        color = color.reshape(npx, rpp, 3)
        weight = weight.reshape(npx, rpp)
        blur = blur.reshape(npx, rpp)
        csum[p0 : p0 + npx] = torch.sum(color * weight[..., None], dim=1)
        wsum[p0 : p0 + npx] = torch.sum(weight, dim=1)
        bsum[p0 : p0 + npx] = torch.sum(blur * weight, dim=1)
    return csum, wsum, bsum


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


def _trace_sums_cuda(scene, camera, config, frame, px_start, n_px, cand_tables):
    """Launch csrc/trace.cu on the scene's card; one launch per call."""
    global LAUNCHES
    from . import _build  # builds csrc/trace.cu on first use

    w, h = scene.width, scene.height
    _, pxb, sw, n_wedges, tile_h, tiles_x, tiles_y, n_tiles = _grid_geom(
        scene, config, w, n_px
    )
    s_pad = scene.s_pad
    _check(scene.seg_consts, "seg_consts", torch.float32, (s_pad, dev.CONST_COLS))
    _check(scene.shade_all_t, "shade_all_t", torch.float32, (dev.ALLT_ROWS, s_pad))
    if cand_tables is not None:
        ids, counts = cand_tables
        _check(ids, "cand ids", torch.int32)
        _check(counts, "cand counts", torch.int32, (n_tiles, n_wedges))
        if ids.shape[:2] != (n_tiles, n_wedges):
            raise ValueError(
                f"cand ids shape {tuple(ids.shape)} does not match the "
                f"({n_tiles}, {n_wedges}) tile/wedge grid"
            )
        ids_ptr, cnt_ptr, cand_len = ids.data_ptr(), counts.data_ptr(), ids.shape[-1]
    else:
        ids_ptr, cnt_ptr, cand_len = None, None, 0
    out = torch.empty((5, n_px), dtype=torch.float32, device=scene.device)
    lib = _build.load("trace")
    stream = torch.cuda.current_stream(scene.device).cuda_stream
    err = lib.rtdc_trace_sums(
        scene.seg_consts.data_ptr(), scene.shade_all_t.data_ptr(),
        s_pad, scene.n_sub,
        ids_ptr, cnt_ptr, cand_len,
        out.data_ptr(), n_px,
        w, h, px_start, tiles_x, tiles_y, tile_h, pxb,
        config.rays_per_pixel, sw, n_wedges,
        float(camera.zoom_factor), float(camera.offset_x), float(camera.offset_y),
        int(frame) & 0xFFFFFFFF, int(config.seed) & 0xFFFFFFFF,
        int(config.use_aa), int(config.diffusion_curve_save),
        int(config.exact_silhouettes), _n_traces(scene, config),
        float(config.min_hit_distance), ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"trace kernel launch failed: {_build.error_string(lib, err)}")
    LAUNCHES += 1
    return out[0:3].T, out[3], out[4]
