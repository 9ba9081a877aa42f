"""The least time a frame could take on one H100, from the cell's inputs and
shapes alone: never from the program's tables, counters or kernels.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the full 700 W): 67e12 FLOP/s
in float32 outside the tensor cores, 989e12 FLOP/s in bf16 on them, 3.35e12
B/s of HBM.  A share against them is stated with the card's power limit.

* Trace: the larger of its operations at the float32 peak and its bytes at
  the HBM rate.  Operations: each ray's raygen and shading, plus one pair
  test for each sub-segment whose bounding circle the ray crosses before
  its closest hit: no correct closest-hit search can skip those tests.
  They are counted with the reference's own code on every ROW_STRIDE-th
  row, and scaled.  Bytes: each sub-segment's record and each pixel's
  output sums, each once.
* Conv: per UNet layer the larger of 2*9*Cin*Cout*Hout*Wout FLOP at the
  bf16 peak and its bytes (inputs at the resolution they are stored in,
  bf16 weights and bias, the bf16 output, each once) at the HBM rate;
  summed over the nine layers.
* Post-processing: the least bytes of its passes at the HBM rate.
* A band of rows (``band_counts``, a cell across cards): the trace of its
  rows alone, every sub-segment's record read once and the band's pixel
  sums written once.
"""

from __future__ import annotations

import math

import torch

FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12
ROW_STRIDE = 64

# Floating-point operations, counted from the plain code's formulas
# (reference/intersect.py, refine.py, fastmath.py), a compare counting one.
# Raygen: origin 2 x (subtract, multiply, add) = 6; antialias jitter 2 x
# (multiply, add) = 4; the fan angle sector * (sample + u) = 2; sincos's
# range reduction 6 and two degree-3 polynomials in z = d^2 with their
# final terms 1 + 9 + 10, sign flips 2 = 28.
RAYGEN_FLOP = 6 + 4 + 2 + 28
# One pair test: denom = dx*ey - dy*ex (3), num_t = c1 - ox*ey + oy*ex (4),
# num_s = dy*p0x - dx*p0y + (oy*dx - ox*dy) (7), s in [0, 1] by
# num_s * (denom - num_s) >= 0 (3), t > min_hit by
# (num_t - min_hit * denom) * denom > 0 (4), the compare with the best (1).
PAIR_FLOP = 3 + 4 + 7 + 3 + 4 + 1
# Shading a hit: one Newton step on the cubic (a Bezier point and
# derivative 47 before and 47 after, F and F' 7, the step 2, the clamp 1),
# the hit distance (dot products and a divide, 9), the chord parameter
# 2, the side test 3, the chosen side's colour lerp 9 and blur, weight and
# weight degree 9, the weight w * t^-wd 4, and the five sums 9.
SHADE_FLOP = 47 + 47 + 7 + 2 + 1 + 9 + 2 + 3 + 9 + 9 + 4 + 9
# A sub-segment as the trace needs it: the pair test's 7 floats, the
# cubic's 8 control values, its parameter window 2, its band 1, both sides'
# colours at both ends 12, blur, weight and weight degree at both ends 6:
# 36 float32.  A pixel's output: 3 colour sums, the weight sum and the
# blur sum, float32.
SEGMENT_BYTES = 36 * 4
PIXEL_SUM_BYTES = 5 * 4
# Least bytes per pixel of the post-processing passes, each pass reading
# its inputs and writing its outputs once (float32 unless said): normalize
# (sums 20 in; image 16 and blur map 4 out) 40; bilateral (3 channels in
# and out) 24; the UNet's input (noisy, warped history and bilateral 3
# channels each and the blur map in; the analytic pass 12 and the 11-channel
# bf16 input 22 out) 74; the residual and blend (analytic 12, bf16 residual
# 6 and image 16 in; next state 16 out) 50; the blur (state 16 and blur map
# 4 in; display 16 out) 36.
POST_BYTES_PER_PIXEL = 40 + 24 + 74 + 50 + 36
# The same with the denoiser off: normalize 40 and the blur 36.
PLAIN_POST_BYTES_PER_PIXEL = 40 + 36


def unet_layers(height: int, width: int, base: int = 24, cin: int = 11):
    """(name, [(Cin_g, H_g, W_g) per input group as stored], Cout, H_out,
    W_out) of the nine layers at a frame of height x width (multiples of 4)."""
    h1, w1 = height // 2, width // 2
    h2, w2 = height // 4, width // 4
    c = base
    return [
        ("enc0a", [(cin, height, width)], c, height, width),
        ("enc0b", [(c, height, width)], c, height, width),
        ("enc1a", [(c, height, width)], 2 * c, h1, w1),
        ("enc1b", [(2 * c, h1, w1)], 2 * c, h1, w1),
        ("enc2a", [(2 * c, h1, w1)], 4 * c, h2, w2),
        ("enc2b", [(4 * c, h2, w2)], 4 * c, h2, w2),
        ("dec1", [(4 * c, h2, w2), (2 * c, h1, w1)], 2 * c, h1, w1),
        ("dec0", [(2 * c, h1, w1), (c, height, width)], c, height, width),
        ("out", [(c, height, width)], 3, height, width),
    ]


def conv_bound_s(height: int, width: int) -> float:
    total = 0.0
    for _, groups, cout, ho, wo in unet_layers(height, width):
        cin = sum(g[0] for g in groups)
        flop = 2 * 9 * cin * cout * ho * wo
        nbytes = sum(2 * c * h * w for c, h, w in groups) + 2 * (9 * cin * cout + cout) \
            + 2 * cout * ho * wo
        total += max(flop / BF16_FLOPS, nbytes / HBM_BYTES)
    return total


def crossings(scene, origins, dirs, t_hit):
    """Per ray, the sub-segments whose bounding circle (the chord's midpoint,
    half its length plus its silhouette band) the ray enters before
    ``t_hit``."""
    from perfbench.reference import device as dv

    c = scene.seg_consts
    ex, ey = c[:, dv.CONST_EX], c[:, dv.CONST_EY]
    mx = c[:, dv.CONST_P0X] + 0.5 * ex
    my = c[:, dv.CONST_P0Y] + 0.5 * ey
    r = 0.5 * torch.sqrt(ex * ex + ey * ey) + c[:, dv.CONST_BAND]
    valid = c[:, dv.CONST_VALID] > 0
    px = mx[None, :] - origins[:, 0:1]
    py = my[None, :] - origins[:, 1:2]
    along = px * dirs[:, 0:1] + py * dirs[:, 1:2]  # unit directions
    d2 = px * px + py * py - along * along
    r2 = (r * r)[None, :]
    inside = d2 <= r2
    t_in = along - torch.sqrt(torch.clamp(r2 - d2, min=0.0))
    t_out = along + torch.sqrt(torch.clamp(r2 - d2, min=0.0))
    hit = inside & valid[None, :] & (t_out > 0) & (t_in < t_hit[:, None])
    return hit.sum(dim=1)


def trace_ops(scene, camera, cfg, dev, pairs_per_chunk: int = 1 << 26, row0: int = 0,
              n_rows: int | None = None) -> tuple[float, int]:
    """(operations of rows [row0, row0 + n_rows), rays counted) from every
    ROW_STRIDE-th of those rows, scaled to every row; by default the whole
    frame."""
    from perfbench.reference import intersect

    w, h, rpp = scene.width, scene.height, cfg.rays_per_pixel
    n_rows = h - row0 if n_rows is None else n_rows
    # a band under ROW_STRIDE // 2 rows: its middle row
    rows = list(range(row0 + ROW_STRIDE // 2, row0 + n_rows, ROW_STRIDE)) or [row0 + n_rows // 2]
    px = torch.tensor([r * w + x for r in rows for x in range(w)], device=dev)
    n_px = px.numel()
    chunk = max(1, pairs_per_chunk // (scene.s_pad * rpp))
    ops = 0.0
    for p0 in range(0, n_px, chunk):
        pix = px[p0: p0 + chunk].repeat_interleave(rpp)
        sample = torch.arange(rpp, device=dev).repeat(min(chunk, n_px - p0))
        origins, dirs = intersect.make_rays(pix, sample, w, h, camera, cfg, 0)
        _, t, _, hit = intersect.closest_hit(scene, origins, dirs, cfg.min_hit_distance)
        n_cross = crossings(scene, origins, dirs, torch.where(hit, t, math.inf))
        ops += float(RAYGEN_FLOP * pix.numel() + SHADE_FLOP * int(hit.sum())
                     + PAIR_FLOP * int(n_cross.sum()))
    return ops * (n_rows / len(rows)), n_px * rpp


def frame_counts(config: dict, xml: str, settings: dict, camera: dict, dev) -> dict:
    """Operations, bytes and least seconds of one frame at ``camera`` (zoom,
    offset_x, offset_y), each layer and the whole."""
    from perfbench.reference import frame as ref
    from perfbench.reference.config import Camera, RenderConfig

    cfg = RenderConfig(**settings)
    cam = Camera(float(camera["zoom"]), float(camera["offset_x"]), float(camera["offset_y"]))
    with torch.no_grad():
        scene = ref.load_scene(xml, cfg, dev)
        ops, _ = trace_ops(scene, cam, cfg, dev)
    n_px = scene.width * scene.height
    trace_bytes = SEGMENT_BYTES * scene.n_sub + PIXEL_SUM_BYTES * n_px
    trace_s = max(ops / FP32_FLOPS, trace_bytes / HBM_BYTES)
    conv_s = conv_bound_s(scene.height, scene.width)
    post_s = POST_BYTES_PER_PIXEL * n_px / HBM_BYTES
    return {"trace_flop": ops, "trace_bytes": trace_bytes, "trace_bound_s": trace_s,
            "conv_bound_s": conv_s, "post_bound_s": post_s,
            "frame_bound_s": trace_s + conv_s + post_s}


def band_counts(config: dict, xml: str, settings: dict, camera: dict, dev, row0: int,
                n_rows: int) -> dict:
    """Operations, bytes and least seconds of the trace of rows [row0, row0 +
    n_rows) of one frame at ``camera``: a band's share of the frame's trace
    (every sub-segment's record read once by the band, its pixels' sums
    written once)."""
    from perfbench.reference import frame as ref
    from perfbench.reference.config import Camera, RenderConfig

    cfg = RenderConfig(**settings)
    cam = Camera(float(camera["zoom"]), float(camera["offset_x"]), float(camera["offset_y"]))
    with torch.no_grad():
        scene = ref.load_scene(xml, cfg, dev)
        ops, _ = trace_ops(scene, cam, cfg, dev, row0=row0, n_rows=n_rows)
    segment_bytes = SEGMENT_BYTES * scene.n_sub
    trace_bytes = segment_bytes + PIXEL_SUM_BYTES * n_rows * scene.width
    return {"trace_flop": ops, "trace_bytes": trace_bytes, "segment_bytes": segment_bytes,
            "trace_bound_s": max(ops / FP32_FLOPS, trace_bytes / HBM_BYTES)}
