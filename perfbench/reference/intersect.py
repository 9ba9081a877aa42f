"""Ray generation, closest-hit search and shading — the plain PyTorch trace.

This is the plain version of the CUDA trace kernel (csrc/trace.cu): the
same per-ray math written as broadcast tensor operations over (rays x
segments), operation for operation the JAX package's ``ops/intersect.py``
(its brute-force oracle).  ``make_rays`` is the raygen front half of the
reference (DeviceCode.cu:85-150), ``trace_and_shade`` replaces BVH traversal
+ __closesthit__/__miss__ (:185-342), and ``trace_full`` is the bounded
*iterative* portal loop.

``allowed`` (optional, (N, S) bool) restricts the primary rays' closest-hit
search to the segments of their (tile, wedge) candidate list — the plain
version of the kernel's candidate-list mode.  Portal continuation rays
always search the whole scene.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import device as dev
from . import fastmath, refine, rng
from .config import Camera, RenderConfig


class Hit(NamedTuple):
    """Per-ray closest-hit result, shaded."""

    hit: torch.Tensor  # bool: any valid intersection
    t: torch.Tensor  # ray parameter of the hit (= distance for unit dirs)
    color: torch.Tensor  # (N, 3) side color at the hit
    blur: torch.Tensor  # (N,)
    weight_mult: torch.Tensor  # (N,)
    weight_degree: torch.Tensor  # (N,)
    is_portal: torch.Tensor  # bool
    exit_origin: torch.Tensor  # (N, 2) portal exit point
    exit_dir: torch.Tensor  # (N, 2) portal exit direction (reference-scaled)


def sector_angle(rays_per_pixel: int) -> float:
    """2*pi/N in float32, as raygen computes it (an exact f32 value)."""
    return float(np.float32(2.0 * np.pi) / np.float32(rays_per_pixel))


def make_rays(
    pixel_ids: torch.Tensor,
    sample_ids: torch.Tensor,
    width: int,
    height: int,
    camera: Camera,
    config: RenderConfig,
    frame: int = 0,
):
    """Stratified per-pixel ray fan (raygen, DeviceCode.cu:85-150).

    pixel_ids: (N,) int flat pixel index (row * width + col)
    sample_ids: (N,) int index of the ray within the pixel's fan

    Returns (origins (N,2), dirs (N,2)) float32: world origin
    ((col - w/2) * zoom + off_x, ...) with the y axis flipped for
    diffusion-curve saves (:103-107); base direction rotated 2*pi/N per
    sample with a uniform random rotation inside each 2*pi/N sector, plus a
    [0, zoom) origin jitter when AA is on (:117-137).
    """
    zoom, off_x, off_y = camera.zoom_factor, camera.offset_x, camera.offset_y
    pixel_ids = pixel_ids.to(torch.int64)
    sample_ids = sample_ids.to(torch.int64)
    col = pixel_ids % width
    row = pixel_ids // width

    ox = (col - width // 2).to(torch.float32) * zoom + off_x
    if config.diffusion_curve_save:
        oy = ((height - row) - height // 2).to(torch.float32) * zoom + off_y
    else:
        oy = (row - height // 2).to(torch.float32) * zoom + off_y

    # RNG stream keyed on the flat GLOBAL ray id: every path (plain, kernel,
    # any pixel range) draws the same jitter for the same ray.
    ray_ids = pixel_ids * config.rays_per_pixel + sample_ids
    u_rot, u_x, u_y = rng.uniform3(config.seed, ray_ids, frame)
    sector = sector_angle(config.rays_per_pixel)
    samp = sample_ids.to(torch.float32)
    theta = sector * (samp + u_rot if config.use_aa else samp + 0.0)
    sin_t, cos_t = fastmath.sincos(theta)
    dirs = torch.stack([cos_t, sin_t], dim=-1)

    if config.use_aa:
        ox = ox + u_x * zoom
        oy = oy + u_y * zoom

    return torch.stack([ox, oy], dim=-1), dirs


def closest_hit(
    scene: dev.DeviceScene,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    min_hit_distance: float,
    band_scale=0.0,
    allowed: torch.Tensor | None = None,
):
    """Closest intersection of each ray against every sub-segment (or the
    ``allowed`` ones).

    Returns (best_idx (N,) int64, t (N,), s (N,) chord parameter, hit (N,)
    bool).  The ranking key is the quadratic-corrected t_est, clamped to
    1e-30 (band candidates can sit at t <= 0); ties take the lowest segment
    id (argmin's first minimum), the order the kernel walks in.
    """
    _, t, t_est, s, valid = dev.intersect_consts(
        scene.seg_consts, origins, dirs, min_hit=min_hit_distance,
        band_scale=band_scale,
    )
    if allowed is not None:
        valid = valid & allowed
    rank = torch.where(valid, torch.clamp(t_est, min=1e-30), float("inf"))
    best = torch.argmin(rank, dim=1)
    ar = torch.arange(t.shape[0], device=t.device)
    hit = torch.isfinite(rank[ar, best])
    best_t = torch.where(hit, t[ar, best], float("inf"))
    best_s = torch.clamp(s[ar, best], 0.0, 1.0)
    return best, best_t, best_s, hit


def closest_hits(scene, origins, dirs, min_hit_distance: float, band_scale: torch.Tensor):
    """``closest_hit`` with the band (``band_scale``) and without it, from
    one evaluation of the shared products: the same values, bit for bit,
    as the two calls, in about half the passes over the (rays x segments)
    products."""
    c = scene.seg_consts
    ex, ey = c[:, dev.CONST_EX][None, :], c[:, dev.CONST_EY][None, :]
    c1 = c[:, dev.CONST_C1][None, :]
    p0x, p0y = c[:, dev.CONST_P0X][None, :], c[:, dev.CONST_P0Y][None, :]
    ox, oy = origins[:, 0:1], origins[:, 1:2]
    dx, dy = dirs[:, 0:1], dirs[:, 1:2]
    denom = dx * ey - dy * ex
    num_t = c1 - ox * ey + oy * ex
    num_s = dy * p0x - dx * p0y + (oy * dx - ox * dy)
    prod_s = num_s * (denom - num_s)
    prod_t = (num_t - min_hit_distance * denom) * denom
    h = c[:, dev.CONST_BAND][None, :] * band_scale.reshape(-1, 1)
    had = h * torch.abs(denom)
    valid_b = (prod_s + had + h * h >= 0.0) & (prod_t + had > 0.0)
    del had, h
    valid_s = (prod_s >= 0.0) & (prod_t > 0.0)
    del prod_s, prod_t
    inv = torch.where(denom == 0.0, 0.0, 1.0 / denom)
    del denom
    s = num_s * inv
    del num_s
    q = c[:, dev.CONST_QUAD][None, :]
    key = torch.clamp((num_t - q * s * (1.0 - s)) * inv, min=1e-30)
    ar = torch.arange(origins.shape[0], device=origins.device)
    out = []
    for valid in (valid_b, valid_s):
        rank = torch.where(valid, key, float("inf"))
        best = torch.argmin(rank, dim=1)
        hit = torch.isfinite(rank[ar, best])
        best_t = torch.where(hit, num_t[ar, best] * inv[ar, best], float("inf"))
        best_s = torch.clamp(s[ar, best], 0.0, 1.0)
        out.append((best, best_t, best_s, hit))
    return out


def shade(
    scene: dev.DeviceScene,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    best: torch.Tensor,
    t: torch.Tensor,
    s: torch.Tensor,
    hit: torch.Tensor,
    config: RenderConfig,
    refine_exact: bool | None = None,
) -> Hit:
    """Closest-hit shading (DeviceCode.cu:194-342): refinement onto the
    exact cubic, attribute lerp, side test against the curve normal, and
    portal exit ray computation."""
    rows = scene.shade_all_t[:, best]  # (ALLT_ROWS, N)

    def g(row):
        return rows[row]

    ox, oy = origins[:, 0], origins[:, 1]
    dx, dy = dirs[:, 0], dirs[:, 1]

    t0 = g(dev.ALLT_T0)
    dt = g(dev.ALLT_DT)
    cx = tuple(g(dev.ALLT_SRC_CTRL + 2 * i) for i in range(4))
    cy = tuple(g(dev.ALLT_SRC_CTRL + 2 * i + 1) for i in range(4))
    if refine_exact is None:
        refine_exact = config.exact_silhouettes
    if refine_exact:
        # Exact silhouettes: band-only candidates need root isolation on the
        # exact cubic; a strict chord hit is a guaranteed crossing.
        gex = g(dev.SHADE_COLS + dev.CONST_EX)
        gey = g(dev.SHADE_COLS + dev.CONST_EY)
        band = g(dev.ALLT_BAND)
        chord = torch.sqrt(gex * gex + gey * gey)
        margin = torch.clamp(
            refine.MARGIN_SCALE * band * dt / torch.clamp(chord, min=1e-9),
            0.0, 1.0,
        )
        tau, t_ref, _, _, dbx, dby, conv = refine.refine_hit_exact(
            cx, cy, t0 + s * dt, t0, dt, ox, oy, dx, dy, t,
            config.min_hit_distance, margin=margin,
        )
        gc1 = g(dev.SHADE_COLS + dev.CONST_C1)
        gp0x = g(dev.SHADE_COLS + dev.CONST_P0X)
        gp0y = g(dev.SHADE_COLS + dev.CONST_P0Y)
        gden = dx * gey - dy * gex
        gnum_t = gc1 - ox * gey + oy * gex
        gnum_s = dy * gp0x - dx * gp0y + (oy * dx - ox * dy)
        strict = (gnum_s * (gden - gnum_s) >= 0.0) & (
            (gnum_t - config.min_hit_distance * gden) * gden > 0.0
        )
        hit = hit & (conv | strict)
    else:
        tau, t_ref, _, _, dbx, dby = refine.refine_hit(
            cx, cy, t0 + s * dt, ox, oy, dx, dy, t, config.min_hit_distance
        )
    t = torch.where(hit, t_ref, t)
    sf = torch.clamp((tau - t0) / torch.where(dt == 0.0, 1.0, dt), 0.0, 1.0)

    def lerp(c0, c1):
        a = rows[c0]
        return a + (rows[c1] - a) * sf

    # Exact right-hand normal (dy, -dx) at the refined parameter
    # (calculateSplineNormal, DeviceCode.cu:64-68); side test with the
    # diffusion-save flip (isRayRight, DeviceCode.cu:78-83).
    nx, ny = dby, -dbx
    ndotd = nx * dx + ny * dy
    is_right = (ndotd <= 0.0) ^ bool(config.diffusion_curve_save)

    color_l = torch.stack([lerp(dev.COL_CL0 + i, dev.COL_CL1 + i) for i in range(3)], -1)
    color_r = torch.stack([lerp(dev.COL_CR0 + i, dev.COL_CR1 + i) for i in range(3)], -1)
    color = torch.where(is_right[:, None], color_r, color_l)

    blur = lerp(dev.COL_BLUR0, dev.COL_BLUR1)
    wm = lerp(dev.COL_WM0, dev.COL_WM1)
    wd = lerp(dev.COL_WD0, dev.COL_WD1)
    is_portal = g(dev.COL_PORTAL) > 0.0

    # Portal exit (DeviceCode.cu:227-257) at the refined parameter on the
    # exact target cubic.  The reference's "sin" is nx*dy + ny*dx — not a
    # cross product — and the rotated direction is not renormalized; both
    # reproduced verbatim.
    nlen = torch.clamp(torch.sqrt(nx * nx + ny * ny), min=1e-30)
    nxu, nyu = nx / nlen, ny / nlen
    ray_cos = nxu * dx + nyu * dy
    ray_sin = nxu * dy + nyu * dx
    tcx = tuple(g(dev.ALLT_TGT_CTRL + 2 * i) for i in range(4))
    tcy = tuple(g(dev.ALLT_TGT_CTRL + 2 * i + 1) for i in range(4))
    ex_x, ex_y, ex_dbx, ex_dby = refine.bezier_and_derivative(tcx, tcy, tau)
    tnx, tny = ex_dby, -ex_dbx
    tlen = torch.clamp(torch.sqrt(tnx * tnx + tny * tny), min=1e-30)
    tnx, tny = tnx / tlen, tny / tlen
    exit_dir = torch.stack(
        [tnx * ray_cos - tny * ray_sin, tny * ray_cos + tnx * ray_sin], dim=-1
    )
    exit_origin = torch.stack([ex_x, ex_y], dim=-1)

    return Hit(
        hit=hit,
        t=torch.where(hit, t, 1.0),
        color=color,
        blur=blur,
        weight_mult=wm,
        weight_degree=wd,
        is_portal=is_portal & hit,
        exit_origin=exit_origin,
        exit_dir=exit_dir,
    )


def trace_and_shade(scene, origins, dirs, config: RenderConfig, allowed=None) -> Hit:
    if not config.exact_silhouettes:
        best, t, s, hit = closest_hit(
            scene, origins, dirs, config.min_hit_distance, allowed=allowed
        )
        return shade(scene, origins, dirs, best, t, s, hit, config)

    # Exact silhouettes: two winner chains.  The band-widened winner is
    # verified by root isolation in shade(); rays whose band winner is
    # rejected fall back to the STRICT winner, a guaranteed crossing.
    # Per-ray |d| scales the band (~1 for unit primaries; portal
    # continuation rays are not renormalized, PARITY #11).
    band_scale = torch.sqrt(dirs[:, 0] * dirs[:, 0] + dirs[:, 1] * dirs[:, 1])
    if allowed is None:
        (best_b, t_b, s_b, hit_b), (best_s, t_s, s_s, hit_s) = closest_hits(
            scene, origins, dirs, config.min_hit_distance, band_scale)
    else:
        best_b, t_b, s_b, hit_b = closest_hit(
            scene, origins, dirs, config.min_hit_distance, band_scale=band_scale,
            allowed=allowed,
        )
        best_s, t_s, s_s, hit_s = closest_hit(
            scene, origins, dirs, config.min_hit_distance, allowed=allowed
        )
    hb = shade(scene, origins, dirs, best_b, t_b, s_b, hit_b, config)
    hs = shade(scene, origins, dirs, best_s, t_s, s_s, hit_s, config,
               refine_exact=False)
    # Per-ray CLEAN rule: when the band winner IS the strict winner the hit
    # is a guaranteed crossing and the cheap Newton refine decides; root
    # isolation answers only for band-only winners (grazes).
    clean = hit_b & hit_s & (best_b == best_s)
    use_s = (hit_b & ~hb.hit & hit_s) | clean

    def pick(a, b):
        m = use_s[:, None] if a.ndim == 2 else use_s
        return torch.where(m, a, b)

    return Hit(*(pick(a, b) for a, b in zip(hs, hb)))


def trace_full(
    scene: dev.DeviceScene,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    config: RenderConfig,
    allowed: torch.Tensor | None = None,
):
    """Full trace with bounded portal continuation.

    Returns per-ray (color (N,3), weight (N,), blur (N,)).  Across portal
    traversals the color filters multiply (DeviceCode.cu:307-309), the blur
    values multiply (:311), and the weights combine harmonically —
    1/(1/w_child + 1/w_self) (:310).  A ray that exhausts max_trace_depth
    while still on a portal is a miss (:313-320).
    """
    n = origins.shape[0]
    f32 = torch.float32
    kw = dict(dtype=f32, device=origins.device)
    filt = torch.ones((n, 3), **kw)
    inv_w = torch.zeros((n,), **kw)
    blur_prod = torch.ones((n,), **kw)
    out_color = torch.zeros((n, 3), **kw)
    out_w = torch.zeros((n,), **kw)
    out_blur = torch.zeros((n,), **kw)
    alive = torch.ones((n,), dtype=torch.bool, device=origins.device)

    n_traces = (config.max_trace_depth + 1) if scene.has_portals else 1
    for bounce in range(n_traces):
        h = trace_and_shade(
            scene, origins, dirs, config, allowed if bounce == 0 else None
        )
        w_self = h.weight_mult * torch.pow(h.t, -h.weight_degree)
        terminal = alive & h.hit & ~h.is_portal
        # IEEE semantics are load-bearing, as in the reference
        # (DeviceCode.cu:310): w_self == 0 => 1/0 = inf => weight 0, so
        # weight-0 curves occlude without contributing.
        w_final = 1.0 / (inv_w + 1.0 / w_self)
        out_color = torch.where(terminal[:, None], filt * h.color, out_color)
        out_w = torch.where(terminal, w_final, out_w)
        out_blur = torch.where(terminal, blur_prod * h.blur, out_blur)
        cont = alive & h.hit & h.is_portal
        filt = torch.where(cont[:, None], filt * h.color, filt)
        inv_w = torch.where(cont, inv_w + 1.0 / w_self, inv_w)
        blur_prod = torch.where(cont, blur_prod * h.blur, blur_prod)
        origins = torch.where(cont[:, None], h.exit_origin, origins)
        dirs = torch.where(cont[:, None], h.exit_dir, dirs)
        alive = cont

    return out_color, out_w, out_blur
