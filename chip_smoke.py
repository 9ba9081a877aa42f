"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each kernel
against its plain PyTorch version on the card, and drives the port's three
paths through the public entry points, checking the images:

* the static-camera headline frame: seeded scene at 1024^2, 128 rays per
  pixel, AA, blur and exact silhouettes on, denoiser off, hoisted
  acceleration tables, chained frames;
* the denoised frame: the same scene at 1920x1088, 8 rays per pixel, with
  the shipped UNet (weights/denoiser_r3d.msgpack) as a short sequence (first
  frame, resting frames, a zoom step with a non-zero flow, resting frames),
  then the same sequence with the analytic denoiser, then progressive
  passes; the blur kernel against its plain version on that frame ([blur]);
* the dense-scene frame (BASELINE config 3): a generated line drawing of
  the lady_bug class (1536 padded sub-segments) at 1920x1088, 256 rays per
  pixel, the default config with the shipped UNet: capped distance-ordered
  candidate lists with a per-ray exit and the horizon fallback into the
  sorted chunk lists, held against the kernel's own full sweep bit for bit
  and against the plain version; also a dolphin-class scene (7360) at 64
  rays per pixel, the chunk-lists-only kind (wedge shift 0), and the
  lady_bug-class scene at 8 rays per pixel (two wedges, where no ray
  leaves its list early);
* BASELINE config 5: the seeded (arch-class) scene at 3840x2160, 1024 rays
  per pixel, blur on, denoiser off, hoisted tables narrowed by
  seg_max_count: 256 wedges, so the segment lists are wedge-coarsened
  (shift 2: four wedges share a table entry).  Coarse lists against the
  kernel's full sweep bitwise on the whole frame, the kernel against the
  plain version on the last tile row (ray ids past 2^32), the blur kernel
  against its plain version on the whole frame and on the first, second
  and last of four row bands with their halos ([blur:bands:config5]),
  chained frames in
  turns with the route without coarsening (chunk lists), the card alone,
  the bound ([config5:*]); the lady_bug class at shift 3 on a band against
  the full sweep, with its [dense_stats]; the CLI at that frame
  ([cli:config5]);
* the interactive session: an InteractiveSession of the denoised frame on a
  scripted zoom / pan sequence ([grid:denoised]) and of the dense-scene
  frame ([grid:dense]), whose moving frames take their tables from the world
  grid (build_cand_grid, grid_tables) and are held bitwise against the
  kernel's full sweep and the camera's own tables, and timed against a
  session that rebuilds the camera's tables on each move; a session saved
  and resumed ([session_resume]); the MJPEG viewer on a local port
  ([http_viewer]); the native scene loader against the Python one
  ([native_loader]); the CLI in a subprocess ([cli:*]);
* the denoiser trainer: a dataset from three generated scenes at 192^2
  through train_denoiser.generate (three trace launches per example,
  [train:gen]; the trace kernel against its plain version at gen's launch
  shapes, [train:gen_parity:*]); the train step's convolution against the
  plain version on the UNet's nine layers ([train:conv]); the UNet at the
  shipped width, batch 32, crop 64: 30 steps on one batch under 0.7x the
  first loss, ms per step, kernels per step ([train:step]); train() for
  300 steps with validation through the conv kernel ([train:fit]); the
  written checkpoint through load_params / net_for_params / apply_denoiser
  at 1920x1088, kernel vs plain route ([train:checkpoint]);
* row-band rendering: two gloo ranks on cuda:0 (parallel/sharded.py; two
  ranks on one card, no scaling figure): the gloo collectives on CUDA
  tensors ([sharded:gloo_cuda]), the denoiser-off frame with per-band
  tables, a progressive pass, the dense frame with the shipped UNet, a
  zoom step of the denoised frame (the history gathered and warped) and
  BASELINE config 5 through render_frame_sharded, each bitwise equal to one
  process and each rank's post-processing reading its band and halo rows
  alone, with no whole-frame collective on a resting frame
  ([sharded:frame], [sharded:progressive], [sharded:dense],
  [sharded:warp], [sharded:config5]: rows_processed, halo bytes); each
  rank's post-processing timed in turns beside the one-process tail
  ([sharded:tail]); and the data-parallel train step (2 x 16) against the
  one-process step on the 32 ([sharded:train_step]).

After the build, [trace_kernel:*] prints each instantiation of the trace
kernel as built: registers, local (spilled) bytes and shared memory per
thread block, and blocks per SM.  [bound], [denoised_trace_bound] and
[dense_bound] give each path's trace launch its least time on the card from
the run's own counts; [dense_stats] also the share of the warps' list slots
that did work (warp_slot_efficiency: a warp walks as long as its longest
walk).

Each phase prints one line; any failure raises (exit code != 0).  The line
before the last is a JSON object with each kernel's numbers; the last line
is {"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA device is visible.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np

import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
    sys.exit(2)

import raytracingdiffusioncurves_torch as rt  # noqa: E402
from raytracingdiffusioncurves_torch.cli import shipped_weights  # noqa: E402
from raytracingdiffusioncurves_torch.models import denoiser, renderer, train_denoiser  # noqa: E402
from raytracingdiffusioncurves_torch.ops import (  # noqa: E402
    _build,
    blur,
    blur_cuda,
    conv_cuda,
    denoise,
    flow,
    intersect,
    trace_cuda,
)
from raytracingdiffusioncurves_torch.utils.scenes import (  # noqa: E402
    dense_scene_xml,
    portal_weights_scene_xml,
    seeded_scene_xml,
)
from raytracingdiffusioncurves_torch.viewer import ZOOM_STEP  # noqa: E402

SIZE, RPP = 1024, 128
BAND_ROW, BAND_ROWS = 480, 64
N_FRAMES = 10
# The denoised frame: the resolution of BASELINE configs 3 and 4, config 4's
# rays per pixel, the shipped UNet.
DN_W, DN_H, DN_RPP = 1920, 1088, 8
DN_FRAMES = 10
# The dense-scene frame: BASELINE config 3's size and rays per pixel on the
# lady_bug-class scene; the dolphin-class scene at 64 rays per pixel.
DENSE_RPP, DENSE_RPP_DOLPHIN, DENSE_FRAMES = 256, 64, 5
DENSE_TILE_ROWS = 32  # rows of one pixel tile at both dense launch shapes
CONV_REPS = 20  # timed calls per layer: a layer takes 0.1-0.3 ms
# Frames timed on the card alone, each queued behind a sleep of SLEEP_CYCLES
# clock cycles (~50-100 ms at the H100's clocks; a frame's enqueue takes
# 4-14 ms); the card-alone time is their median.
DEVICE_FRAMES, SLEEP_CYCLES = 5, 100_000_000
WEIGHTS = pathlib.Path(__file__).resolve().parent / "weights" / "denoiser_r3d.msgpack"
# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).  The
# 67e12 FP32 FLOP/s count a fused multiply-add as two operations; the trace
# kernel is built with --fmad=false, so each multiply and add it counts
# below issues as an instruction of its own, at half that rate.
# The convolution's bound takes the dense bf16 tensor-core rate, 989e12
# FLOP/s (same data sheet), the fastest the card can do its multiply-adds.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_FP32_UNFUSED_PER_S = PEAK_FP32_PER_S / 2
PEAK_BF16_TENSOR_PER_S = 989e12
# Minimal FP32 arithmetic (add, sub, mul, div, sqrt; compares, min/max and
# integer hash work not counted) of the trace kernel, counted from
# csrc/trace.cu.  Per (ray, candidate) pair of the exact-silhouette walk:
# denom (3), num_t (4), num_s (4), the strict tests (5) and the band tests
# (6).  Per primary ray of a non-empty cell: the jitter scaling (3), angle
# (2), origin (4), sincos (23), |d| (3) and the hoisted cross term (3).
# Per ray whose band and strict chains pick one winner: shade() with the
# Newton refine (159: chord 16, two Bezier evaluations 94, Newton step and
# check 26, side colour and interpolations 23) and the weight and sums (18,
# powf counted as one).  Per ray with a band-only winner (a graze): shade()
# with root isolation (448: chord 16, margin 7, refine_hit_exact 397,
# strict test 5, interpolations 23).  Not counted: the ordering keys of
# accepted pairs, the sums of grazes, the strict fallback of a rejected
# graze; so the bound is a lower bound.
OPS_PER_PAIR = 22
OPS_PER_RAY = 38
OPS_PER_HIT = 177
OPS_PER_GRAZE = 448


def phase(label: str, **vals):
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in vals.items()), flush=True)


def require(cond, what: str):
    """A check of this run's result; raises (never stripped like assert)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int, warm_up: bool = False):
    """(mean milliseconds per call of fn() on the card (CUDA events), the
    last call's result).  ``warm_up`` runs fn() once before the timing, for
    a function's first call in the process (library load, cuBLAS set-up)."""
    if warm_up:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def parity(ref, got, frac=3e-5):
    """The JAX package's assert_parity bars (tests/test_pallas.py:32) on
    normalized (image, blur_map): fewer than 3e-5 of values off by more than
    1e-3, mean image difference below 1e-4.  Returns max |diff|."""
    (img_r, bm_r), (img_g, bm_g) = ref, got
    require(not torch.isnan(img_g).any(), "NaN in kernel image")
    d = (img_r - img_g).abs()
    db = (bm_r - bm_g).abs()
    frac_off = float((d > 1e-3).float().mean())
    require(frac_off < frac, f"image diff frac {frac_off}")
    require(float(d.mean()) < 1e-4, f"image mean diff {float(d.mean())}")
    require(float((db > 1e-3).float().mean()) < frac, "blur map diff frac")
    return max(float(d.max()), float(db.max()))


def normalized(sums, rows, width, config):
    c, w, b = sums
    return renderer.normalize_sums(
        c.reshape(rows, width, 3), w.reshape(rows, width), b.reshape(rows, width), config
    )


def shaded_rays(scene, cam, cfg, tables, row_step=1):
    """(clean, graze) primary rays of one frame 0 of the main path: clean
    rays have one winner on both chains (shade with the Newton refine),
    grazes a band-only winner (root isolation).  Plain PyTorch on the card,
    for the bound.  ``row_step`` > 1 counts every row_step-th pixel row
    only and scales the counts by the frame's rows over the rows counted
    (an estimate, for frames too large to count whole)."""
    w, rpp = scene.width, cfg.rays_per_pixel
    n_px = w * scene.height
    _, _, sw, n_wedges, tile_h, tiles_x, _, _ = trace_cuda._grid_geom(scene, cfg, w, n_px)
    dev = scene.device
    clean = torch.zeros((), dtype=torch.int64, device=dev)
    graze = torch.zeros((), dtype=torch.int64, device=dev)
    px_chunk = (1 << 18) // rpp
    rows = range(0, scene.height, row_step)
    spans = [(0, n_px)] if row_step == 1 else [(r * w, (r + 1) * w) for r in rows]
    starts = [(p0, min(px_chunk, e - p0)) for b, e in spans for p0 in range(b, e, px_chunk)]
    for p0, npx in starts:
        pix = (p0 + torch.arange(npx, device=dev)).repeat_interleave(rpp)
        samples = torch.arange(rpp, device=dev).repeat(npx)
        o, d = intersect.make_rays(pix, samples, w, scene.height, cam, cfg, 0)
        allowed = trace_cuda._allowed_mask(scene, tables, pix, samples, tile_h, tiles_x, sw,
                                           n_wedges)
        band = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
        wb, _, _, hb = intersect.closest_hit(scene, o, d, cfg.min_hit_distance, band, allowed)
        ws, _, _, hs = intersect.closest_hit(scene, o, d, cfg.min_hit_distance, allowed=allowed)
        same = hb & hs & (wb == ws)
        clean += same.sum()
        graze += (hb & ~same).sum()
    scale = scene.height / len(rows)
    return round(int(clean) * scale), round(int(graze) * scale)


def record_bytes(scene):
    """Bytes of the scene's records, the kernel's only scene input."""
    return (scene.walk_records.numel() + scene.shade_records.numel()) * 4


def list_bound(label, scene, cam, cfg, tables, trace_ms, shade_row_step=1):
    """[bound]-style line of a frame 0 launch over slot-mode lists (the
    denoiser-off and denoised frames, BASELINE config 5), from this run's
    data: every ray of a cell tests each of its list's slots (a coarse
    cell's list serves the rays of its 2^shift wedges), ray counts from the
    cells that are not empty, clean hits and grazes counted by the plain
    version (on every ``shade_row_step``-th row, scaled: shaded_rays);
    operations at the unfused FP32 rate (OPS_* above), bytes: records,
    lists and output once.  Returns (ops_ms, bytes_ms)."""
    w, rpp = scene.width, cfg.rays_per_pixel
    n_px = w * scene.height
    counts = tables.counts
    rays_per_cell = trace_cuda._grid_geom(scene, cfg, w, n_px)[1] * (rpp // counts.shape[1])
    pairs = float(counts.double().sum()) * rays_per_cell
    live_rays = float((counts > 0).double().sum()) * rays_per_cell
    clean, grazes = shaded_rays(scene, cam, cfg, tables, shade_row_step)
    ops = OPS_PER_PAIR * pairs + OPS_PER_RAY * live_rays + OPS_PER_HIT * clean + OPS_PER_GRAZE * grazes
    table_bytes = tables.ids.numel() * 4 + counts.numel() * 4
    n_bytes = record_bytes(scene) + table_bytes + 5 * n_px * 4
    ops_ms, bytes_ms = ops / PEAK_FP32_UNFUSED_PER_S * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    phase(label, rays=n_px * rpp, wedges=counts.shape[1], pairs=f"{pairs:.4e}",
          live_rays=f"{live_rays:.4e}", clean_hits=clean,
          grazes=grazes, shade_rows=f"1/{shade_row_step}", fp32_ops=f"{ops:.4e}", walk_ops=f"{OPS_PER_PAIR * pairs:.4e}",
          raygen_ops=f"{OPS_PER_RAY * live_rays:.4e}",
          shade_ops=f"{OPS_PER_HIT * clean + OPS_PER_GRAZE * grazes:.4e}",
          bytes=n_bytes, ops_ms=f"{ops_ms:.4f}", bytes_ms=f"{bytes_ms:.4f}",
          bound_ms=f"{bound_ms:.4f}", kernel_ms=f"{trace_ms:.3f}",
          share_of_bound=f"{bound_ms / trace_ms:.4f}")
    return ops_ms, bytes_ms


def unet_layers(h, w, base=24, cin0=11):
    """The nine convolutions of the UNet on an (h, w) frame: (name, input
    height and width as the taps see them, channels per group, Cout, stride,
    relu, upsample flag per group)."""
    c = base
    return [
        ("enc0a", h, w, (cin0,), c, 1, True, (False,)),
        ("enc0b", h, w, (c,), c, 1, True, (False,)),
        ("enc1a", h, w, (c,), 2 * c, 2, True, (False,)),
        ("enc1b", h // 2, w // 2, (2 * c,), 2 * c, 1, True, (False,)),
        ("enc2a", h // 2, w // 2, (2 * c,), 4 * c, 2, True, (False,)),
        ("enc2b", h // 4, w // 4, (4 * c,), 4 * c, 1, True, (False,)),
        ("dec1", h // 2, w // 2, (4 * c, 2 * c), 2 * c, 1, True, (True, False)),
        ("dec0", h, w, (2 * c, c), c, 1, True, (True, False)),
        ("out", h, w, (c,), 3, 1, False, (False,)),
    ]


def conv_close(ref, got, bias):
    """Kernel vs plain version of the convolution.  Both multiply the same
    bf16 values; only the order of the float32 sum differs, which moves the
    rounded accumulator by at most one bf16 step before the bias is added,
    and the sum with the bias is rounded once more.  Bar: at least 99% of
    values bitwise equal, none off by more than one step of the accumulator
    plus one of the result, |diff| <= 2^-7 * (2 |y| + |bias|).  Returns
    (share equal, largest difference as a share of that bar, max |diff|)."""
    ref, got = ref.float(), got.float()
    require(bool(torch.isfinite(got).all()), "finite conv output")
    d = (ref - got).abs()
    step = 2.0**-7 * (2.0 * torch.maximum(ref.abs(), got.abs()) + bias.float().abs())
    steps = float((d / step.clamp_min(1e-30)).max())
    equal = float((ref == got).float().mean())
    require(equal >= 0.99, f"conv bitwise-equal share {equal}")
    require(steps <= 1.0, f"conv off by {steps} of the rounding bar")
    return equal, steps, float(d.max())


def library_conv(xs, ks, b, stride, ups):
    """The one PyTorch call that computes the layer (F.conv2d on bf16
    channels_last, bias included), as a closure over inputs laid out for it
    outside the timing: groups concatenated, upsample materialized, the
    SAME padding applied.  A yardstick only: the port never calls it."""
    parts = [x.repeat_interleave(2, 0).repeat_interleave(2, 1) if u else x for x, u in zip(xs, ups)]
    x = torch.cat(parts, dim=-1)
    _, top, bottom = conv_cuda.same_padding(x.shape[0], stride)
    _, left, right = conv_cuda.same_padding(x.shape[1], stride)
    x = F.pad(x, (0, 0, left, right, top, bottom)).permute(2, 0, 1)[None].contiguous(
        memory_format=torch.channels_last)
    k = torch.cat(ks, dim=2).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(x, k, b, stride=stride)


def measure_conv(name, kernel_fn, xs, ks, b, stride, relu, ups):
    """One row of [conv_parity]: ``kernel_fn()`` (an entry point of the
    kernel on these inputs) against the plain version, timed beside the
    plain version and the library call, with the card's bound for the
    layer: 2*9*Cin*Cout*H_out*W_out FLOP at the tensor-core peak, and every
    input, the kernels, the bias and the output moved once."""
    before = conv_cuda.LAUNCHES
    ms, got = cuda_ms(kernel_fn, CONV_REPS, warm_up=True)
    require(conv_cuda.LAUNCHES == before + CONV_REPS + 1, f"{name}: one launch per call")
    plain_ms, ref = cuda_ms(lambda: conv_cuda.conv3x3_plain(xs, ks, b, stride, relu, ups), 1,
                            warm_up=True)
    equal, steps, err = conv_close(ref, got, b)
    lib_ms, lib_out = cuda_ms(library_conv(xs, ks, b, stride, ups), CONV_REPS, warm_up=True)
    lib_out = lib_out[0].permute(1, 2, 0)
    lib_err = float((torch.relu(lib_out) if relu else lib_out).float().sub(got.float()).abs().max())
    cins = [x.shape[2] for x in xs]
    h_out, w_out, cout = got.shape
    flops = 2 * 9 * sum(cins) * cout * h_out * w_out
    n_bytes = 2 * (sum(x.numel() for x in xs) + got.numel() + sum(k.numel() for k in ks) + cout)
    ops_ms = flops / PEAK_BF16_TENSOR_PER_S * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    h_in, w_in = xs[-1].shape[0] << int(ups[-1]), xs[-1].shape[1] << int(ups[-1])
    phase(f"conv_parity:{name}", shape=f"{h_in}x{w_in}x{'+'.join(map(str, cins))}->{cout}",
          stride=stride, upsampled=sum(ups), bitwise_equal=f"{equal:.6f}",
          max_share_of_rounding_bar=f"{steps:.3f}", max_abs_err=f"{err:.3e}",
          library_max_abs_diff=f"{lib_err:.3e}")
    return dict(name=name, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, equal=equal,
                steps=steps, err=err, flops=flops, bytes=n_bytes, ops_ms=ops_ms,
                bytes_ms=bytes_ms)


def conv_edge_cases(gen):
    """[conv_parity:edge_*]: the kernel's edges at small size, seeded inputs
    against the plain version under the same bars: Cin not a multiple of 8
    (plain loads), an image smaller than one tile, one output row, stride
    2 on an odd size that is no multiple of the tile, stride 2 over an
    upsampled group, Cout above one block's 96 channels, and contiguous
    operands at a storage offset of 2 or 8 bytes, which breaks 16-byte
    alignment (plain loads)."""
    bf = torch.bfloat16
    cases = [  # name, h, w, channels per group, Cout, stride, relu, upsample, offset
        ("edge_cin44_cout96", 24, 40, (44,), 96, 1, True, (False,), 0),
        ("edge_smaller_than_tile", 3, 5, (24,), 24, 1, True, (False,), 0),
        ("edge_one_row", 1, 37, (48,), 48, 1, True, (False,), 0),
        ("edge_stride2_odd", 37, 53, (24,), 48, 2, True, (False,), 0),
        ("edge_stride2_upsampled", 18, 22, (48, 24), 24, 2, True, (True, False), 0),
        ("edge_cout136", 20, 24, (16,), 136, 1, True, (False,), 0),
        ("edge_offset_2_bytes", 21, 35, (48, 24), 48, 1, True, (False, False), 1),
        ("edge_offset_8_bytes", 21, 35, (48, 24), 48, 1, True, (False, False), 4),
    ]

    def at_offset(t, offset):
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        out = buf[offset:].view(t.shape)
        out.copy_(t)
        require(out.is_contiguous() and (offset == 0 or out.data_ptr() % 16 != 0),
                "edge case operand layout")
        return out

    rows = []
    for name, h, w, cins, cout, stride, relu, ups, offset in cases:
        xs = [at_offset(torch.randn((h >> int(u), w >> int(u), c), generator=gen,
                                    device="cuda").to(bf), offset) for c, u in zip(cins, ups)]
        ks = [at_offset((torch.randn((3, 3, c, cout), generator=gen, device="cuda") * 0.1).to(bf),
                        offset) for c in cins]
        b = torch.randn((cout,), generator=gen, device="cuda").to(bf)
        before = conv_cuda.LAUNCHES
        got = conv_cuda.conv3x3(xs, ks, b, stride, relu, ups)
        torch.cuda.synchronize()
        require(conv_cuda.LAUNCHES == before + 1, f"{name}: one launch")
        ref = conv_cuda.conv3x3_plain(xs, ks, b, stride, relu, ups)
        require(got.shape == ref.shape and got.is_contiguous(), f"{name}: output shape")
        equal, steps, err = conv_close(ref, got, b)
        phase(f"conv_parity:{name}", shape=f"{h}x{w}x{'+'.join(map(str, cins))}->{cout}",
              stride=stride, upsampled=sum(ups), storage_offset_bytes=2 * offset,
              bitwise_equal=f"{equal:.6f}", max_share_of_rounding_bar=f"{steps:.3f}",
              max_abs_err=f"{err:.3e}")
        rows.append(dict(name=name, equal=equal, steps=steps, err=err))
    return rows


def conv_phases(net, smi):
    """[conv_parity] and [conv_bound]: every layer shape of the shipped UNet
    at the denoised frame's size, and the one-group entry conv3x3_same, on
    seeded inputs on the card with the shipped weights.  Returns the
    per-layer rows and the kernels-JSON entry (without launches)."""
    require(not torch.backends.cuda.matmul.allow_tf32,
            "the plain version needs full float32 matmuls (TF32 off)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    rows = []
    for name, h, w, cins, cout, stride, relu, ups in unet_layers(DN_H, DN_W):
        layer = getattr(net, name)
        require(tuple(layer.kernel.shape) == (3, 3, sum(cins), cout), f"{name} kernel shape")
        ks = [k.contiguous() for k in torch.split(layer.kernel.to(bf), cins, dim=2)]
        b = layer.bias.to(bf)
        xs = [torch.randn((h >> int(u), w >> int(u), c), generator=gen, device="cuda").to(bf)
              for c, u in zip(cins, ups)]
        rows.append(measure_conv(
            name, lambda: conv_cuda.conv3x3(xs, ks, b, stride, relu, ups),
            xs, ks, b, stride, relu, ups))
    # conv3x3_same, the one-group entry, at a half-size 44 -> 96 layer (the
    # widest shape of the JAX package's own test of it) with seeded weights
    x = torch.randn((DN_H // 2, DN_W // 2, 44), generator=gen, device="cuda").to(bf)
    k = (torch.randn((3, 3, 44, 96), generator=gen, device="cuda") * 0.1).to(bf)
    b = torch.randn((96,), generator=gen, device="cuda").to(bf)
    same = measure_conv("conv3x3_same", lambda: conv_cuda.conv3x3_same(x, k, b),
                        [x], [k], b, 1, True, (False,))
    del xs, x
    edges = conv_edge_cases(gen)
    phase("conv_parity", layers=len(rows) + 1, edge_cases=len(edges),
          min_bitwise_equal=f"{min(r['equal'] for r in rows + [same] + edges):.6f}",
          max_share_of_rounding_bar=f"{max(r['steps'] for r in rows + [same] + edges):.3f}",
          bar="equal>=0.99,diff<=2^-7*(2|y|+|b|)")
    instances = conv_cuda.kernel_instances()
    for i in instances:
        phase(f"conv_kernel:np{i['np']}_s{i['stride']}", tile=f"{i['tile_rows']}x{i['tile_cols']}",
              registers=i["registers"], dynamic_smem_bytes=i["dynamic_smem_bytes"],
              static_smem_bytes=i["static_smem_bytes"], local_bytes=i["local_bytes"])

    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms", "flops", "bytes",
                                                  "ops_ms", "bytes_ms")}
    bound_ms = sum(max(r["ops_ms"], r["bytes_ms"]) for r in rows)
    for r in rows + [same]:
        phase(f"conv_bound:{r['name']}", flops=f"{r['flops']:.4e}", bytes=r["bytes"],
              ops_ms=f"{r['ops_ms']:.4f}", bytes_ms=f"{r['bytes_ms']:.4f}",
              kernel_ms=f"{r['ms']:.3f}",
              share_of_bound=f"{max(r['ops_ms'], r['bytes_ms']) / r['ms']:.4f}")
    phase("conv_bound", flops=f"{total['flops']:.4e}", bytes=total["bytes"],
          ops_ms=f"{total['ops_ms']:.4f}", bytes_ms=f"{total['bytes_ms']:.4f}",
          bound_ms=f"{bound_ms:.4f}", kernel_ms=f"{total['ms']:.3f}",
          share_of_bound=f"{bound_ms / total['ms']:.4f}")
    entry = {
        "name": "conv3x3",
        "route": "cuda",
        "source": "raytracingdiffusioncurves_torch/csrc/conv3x3.cu",
        "replaces": "raytracingdiffusioncurves_tpu/ops/conv_pallas.py:279",
        "replaces_also": "raytracingdiffusioncurves_tpu/ops/conv_pallas.py:63",
        "max_abs_err": max(r["err"] for r in rows),
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": "operations" if total["ops_ms"] >= total["bytes_ms"] else "bytes",
        "library_ms": total["library_ms"],
        "min_bitwise_equal": min(r["equal"] for r in rows),
        "max_share_of_rounding_bar": max(r["steps"] for r in rows),
        "layers": {r["name"]: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "equal", "steps")}
                   | {"bound_ms": max(r["ops_ms"], r["bytes_ms"])} for r in rows},
        "instantiations": instances,
        "edge_cases": {r["name"]: {k: r[k] for k in ("equal", "steps", "err")} for r in edges},
        "conv3x3_same": {k: same[k] for k in ("ms", "plain_ms", "library_ms", "err")}
        | {"bound_ms": max(same["ops_ms"], same["bytes_ms"])},
        "card": smi,
    }
    return rows, entry


def timed_frames(step, n):
    """Run step() n times; (device ms per call from CUDA events, host
    enqueue ms per call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t_host = time.perf_counter()
    start.record()
    for _ in range(n):
        step()
    end.record()
    enqueue_ms = (time.perf_counter() - t_host) * 1e3 / n
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, enqueue_ms


def device_frames_ms(step, n=DEVICE_FRAMES):
    """Device ms of each of n frames with the host out of the way: each
    frame is queued behind a sleep kernel that outlasts its enqueue, so the
    card runs it from a full queue.  Raises if the card reached a frame
    before the host had queued all of it."""
    readings = []
    for _ in range(n):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        step()
        end.record()
        require(not start.query(), "device frame time: the sleep ended before the frame was queued")
        torch.cuda.synchronize()
        readings.append(start.elapsed_time(end))
    return readings


def device_frame_ms(step, n=DEVICE_FRAMES):
    """Device ms of one frame on the card alone: the median of
    device_frames_ms, so that one frame slowed by something outside the
    program (a clock dip, another process querying the card) does not stand for
    the frame."""
    return float(np.median(device_frames_ms(step, n)))


def denoised_sequence(label, dscene, cfg, net, n_frames=DN_FRAMES, path="denoised_path"):
    """A denoised frame as a short sequence through rt.render_frame: frame
    0 (no history), a resting frame under the sync check, n_frames chained
    resting frames (timed, launches counted), a zoom step (tables rebuilt,
    history warped by a non-zero flow), resting frames at the new camera.
    ``net``: the module with the checkpoint's weights on the card, or None
    for the analytic denoiser.  Returns the numbers of the timed loop."""
    w, h = dscene.width, dscene.height
    cam = rt.Camera()
    tables = rt.build_cand_tables(dscene, cam, cfg)
    gl = rt.seg_max_count(dscene, tables)
    kw = dict(denoiser=net, cand_tables=tables, gather_len=gl)
    holder = {"state": rt.init_frame_state(w, h), "img": None}

    def step():
        holder["img"], holder["state"] = rt.render_frame(dscene, cam, holder["state"], cfg, **kw)

    step()  # frame 0: no history
    torch.cuda.synchronize()
    require(holder["state"].frame == 1 and holder["state"].flow_is_zero, "frame 0 state")
    # A resting frame queues on the card without waiting for it: any
    # synchronizing call inside render_frame raises here.
    torch.cuda.set_sync_debug_mode("error")
    step()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    trace_cuda.reset_launch_count()
    conv_cuda.reset_launch_count()
    frame_ms, enqueue_ms = timed_frames(step, n_frames)
    trace_launches, conv_launches = trace_cuda.LAUNCHES, conv_cuda.LAUNCHES
    want_convs = 9 * n_frames if net is not None else 0
    require(trace_launches == n_frames, f"{label}: trace launches {trace_launches}")
    require(conv_launches == want_convs, f"{label}: conv launches {conv_launches} != {want_convs}")
    device_readings = device_frames_ms(step)
    device_ms = float(np.median(device_readings))
    # The card alone cannot take longer than the chained frame, which also
    # waits for the host: a reading above it (beyond noise) is a fault of
    # the measurement, not an idle share of 0.
    require(device_ms <= frame_ms * 1.02,
            f"{label}: the card alone {device_ms:.3f} ms (median of "
            f"{', '.join(f'{v:.3f}' for v in device_readings)}) > chained {frame_ms:.3f} ms")

    # The last frame again, by hand: prev_image is the denoised un-blurred
    # frame, the displayed image its blur, the flow all zero.
    # Its host time is that of enqueueing one frame into an empty launch
    # queue (the timed loop ended with a synchronize): the host's own cost,
    # where the loop's figure includes waiting for a full queue.
    before = holder["state"]
    t_host = time.perf_counter()
    step()
    drained_ms = (time.perf_counter() - t_host) * 1e3
    img, state = holder["img"], holder["state"]
    raw, bmap = rt.trace_image(dscene, cam, cfg, before.frame, tables, gl)
    if net is not None:
        den = rt.apply_denoiser(net, raw, before.prev_image, bmap, mix=cfg.corrected_image_mix,
                                noise=denoiser.noise_level(cfg.rays_per_pixel), frame=before.frame)
    else:
        den = rt.temporal_denoise(raw, before.prev_image, before.flow, before.frame,
                                  cfg.corrected_image_mix, flow_is_zero=True)
    require(torch.equal(den, state.prev_image), f"{label}: prev_image is the denoised frame")
    radius = blur.blur_radius(dscene.max_blur)
    require(torch.equal(blur.variable_gaussian_blur(den, bmap, radius), img),
            f"{label}: displayed image is the blurred denoised frame")
    require(not torch.equal(img, state.prev_image), f"{label}: blur left the frame unchanged")
    require(img.shape == (h, w, 4) and bool(torch.isfinite(img).all()),
            f"{label}: finite (H, W, 4) image")
    require(state.flow_is_zero and not bool(state.flow.any()), f"{label}: flow zero after a frame")
    raw_err = float((raw[..., :3] - den[..., :3]).abs().mean())
    require(raw_err > 1e-4, f"{label}: the denoiser changed the frame ({raw_err})")
    spread = float(img[..., :3].std())
    require(spread > 0.01, f"{label}: spread {spread}")

    # Zoom step: new camera, tables rebuilt, flow written, history warped.
    cam = rt.Camera(zoom_factor=0.9)
    torch.cuda.synchronize()
    t_build = time.perf_counter()
    tables = rt.build_cand_tables(dscene, cam, cfg)
    gl = rt.seg_max_count(dscene, tables)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t_build
    kw.update(cand_tables=tables, gather_len=gl)
    moved = dataclasses.replace(state, flow=rt.add_zoom_flow(state.flow, 1.0, 0.9))
    require(not moved.flow_is_zero and bool(moved.flow.any()), f"{label}: zoom flow is non-zero")
    warped = rt.warp_separable(moved.prev_image, moved.flow)
    warp_diff = float((warped - moved.prev_image).abs().max())
    require(warp_diff > 1e-3, f"{label}: warped history differs from the unwarped ({warp_diff})")
    holder["state"] = moved
    zoom_ms, _ = timed_frames(step, 1)
    require(holder["state"].flow_is_zero and not bool(holder["state"].flow.any()),
            f"{label}: flow zero after the zoom frame")
    rest_ms, _ = timed_frames(step, 3)
    require(bool(torch.isfinite(holder["img"]).all()), f"{label}: finite image after the zoom")
    require(holder["state"].frame == n_frames + DEVICE_FRAMES + 7,
            f"{label}: frame counter {holder['state'].frame}")
    phase(f"{path}:{label}", frames=n_frames, ms_per_frame=f"{frame_ms:.3f}",
          host_enqueue_ms_per_frame=f"{enqueue_ms:.3f}",
          host_enqueue_ms_one_frame_queue_empty=f"{drained_ms:.3f}",
          device_ms_per_frame_queue_full=f"{device_ms:.3f}",
          device_ms_frames=",".join(f"{v:.3f}" for v in device_readings),
          device_idle_share=f"{1.0 - device_ms / frame_ms:.4f}", no_host_sync=True,
          trace_launches=trace_launches, conv_launches=conv_launches,
          conv_launches_per_frame=conv_launches // n_frames, zoom_frame_ms=f"{zoom_ms:.3f}",
          zoom_tables_rebuild_s=f"{rebuild_s:.3f}",
          frames_after_zoom_ms=f"{rest_ms:.3f}", warp_max_shift=f"{warp_diff:.4f}",
          mean_change_by_denoiser=f"{raw_err:.5f}", image_std=f"{spread:.4f}",
          prev_image="denoised_unblurred(bitwise)", flow_after_frame="zero")
    return dict(frame_ms=frame_ms, enqueue_ms=enqueue_ms, drained_ms=drained_ms,
                device_ms=device_ms, conv_launches=conv_launches,
                trace_launches=trace_launches, state=holder["state"], cam=cam, tables=tables, gl=gl,
                zoom_ms=zoom_ms, rebuild_s=rebuild_s)


def denoised_trace_parity(label, dscene, cam, cfg, frame):
    """The trace kernel as the denoised frame launches it (whole frame,
    hoisted lists read up to seg_max_count) against its plain version and
    against its own full sweep, for one camera.  Same bars as the
    denoiser-off frame: assert_parity on the normalized image and blur map,
    lists == full sweep bit for bit."""
    n_px = DN_W * DN_H
    tables = rt.build_cand_tables(dscene, cam, cfg)
    gl = rt.seg_max_count(dscene, tables)
    geom = trace_cuda._grid_geom(dscene, cfg, DN_W, n_px)
    kern = trace_cuda.trace_sums_flat(dscene, cam, cfg, frame, 0, n_px, tables, gl)
    full = trace_cuda.trace_sums_flat(dscene, cam, cfg, frame, 0, n_px, None)
    torch.cuda.synchronize()
    for a, b in zip(kern, full):
        require(torch.equal(a, b), f"denoised frame, {label}: kernel with lists != full sweep")
    plain_ms, plain = cuda_ms(
        lambda: trace_cuda.trace_sums_plain(dscene, cam, cfg, frame, 0, n_px, tables), 1)
    err = parity(normalized(plain, DN_H, DN_W, cfg), normalized(kern, DN_H, DN_W, cfg))
    sums_err = max(float((a - b).abs().max()) for a, b in zip(plain, kern))
    require(float(kern[1].sum()) > 0.0, f"denoised frame, {label}: the trace has weight")
    phase(f"denoised_trace_parity:{label}", rays=n_px * DN_RPP, zoom=cam.zoom_factor, frame=frame,
          wedges=geom[3], tiles=geom[7], tile=f"{geom[4]}x{trace_cuda.TILE_W}",
          lists=tuple(tables.ids.shape), gather_len=gl, max_abs_err=f"{err:.3e}",
          sums_max_abs_err=f"{sums_err:.3e}", lists_eq_full="bitwise", plain_ms=f"{plain_ms:.1f}")
    return dict(max_abs_err=err, plain_ms=plain_ms)


def progressive_sequence(dscene, cfg, net):
    """render_frame_progressive with the learned denoiser: three
    accumulating passes, then a reset."""
    cam = rt.Camera()
    tables = rt.build_cand_tables(dscene, cam, cfg)
    gl = rt.seg_max_count(dscene, tables)
    state = rt.init_frame_state(DN_W, DN_H)
    prog = rt.init_progressive_state(DN_W, DN_H)
    sums = []
    conv_cuda.reset_launch_count()
    for reset in (True, False, False, True):
        img, state, prog = rt.render_frame_progressive(
            dscene, cam, state, prog, cfg, reset, denoiser=net,
            cand_tables=tables, gather_len=gl)
        sums.append((prog.passes, float(prog.weight_sum.sum())))
        require(bool(torch.isfinite(img).all()), "progressive: finite image")
    require([p for p, _ in sums] == [1, 2, 3, 1], f"progressive passes {sums}")
    require(2.5 * sums[0][1] < sums[2][1] < 3.5 * sums[0][1], f"three passes accumulate: {sums}")
    require(0.8 * sums[0][1] < sums[3][1] < 1.2 * sums[0][1], f"reset drops the history: {sums}")
    require(conv_cuda.LAUNCHES == 36, f"progressive conv launches {conv_cuda.LAUNCHES}")
    phase("denoised_path:progressive", passes=[p for p, _ in sums],
          weight_sums=[f"{w:.4e}" for _, w in sums], conv_launches=conv_cuda.LAUNCHES)


def blur_phase(den, bmap, radius):
    """[blur]: the kernel (csrc/blur.cu) against its plain version, bitwise,
    on the denoised frame and its blur map, and both timed there and on its
    first 1080 rows (the benchmark's frames); the bound reads the frame and
    the map once and writes the frame (36 B a pixel) at 3.35e12 B/s."""
    plain_ms, want = cuda_ms(lambda: blur.variable_gaussian_blur_plain(den, bmap, radius), 3)
    blur_cuda.reset_launch_count()
    got = blur.variable_gaussian_blur(den, bmap, radius)
    torch.cuda.synchronize()
    require(blur_cuda.LAUNCHES == 1 and torch.equal(got, want),
            "blur kernel vs plain version: not bitwise equal, or not one launch")
    kernel_ms, _ = cuda_ms(lambda: blur.variable_gaussian_blur(den, bmap, radius), 20)
    n = 1080
    d, b = den[:n], bmap[:n]
    kernel_n_ms, got = cuda_ms(lambda: blur.variable_gaussian_blur(d, b, radius), 50)
    plain_n_ms, want = cuda_ms(lambda: blur.variable_gaussian_blur_plain(d, b, radius), 3)
    require(torch.equal(got, want), f"blur kernel vs plain version on {n} rows: not bitwise equal")
    t0 = time.perf_counter()
    for _ in range(100):
        blur.variable_gaussian_blur(d, b, radius)
    host_us = (time.perf_counter() - t0) * 1e4
    torch.cuda.synchronize()
    h, w = den.shape[:2]
    phase("blur", size=f"{w}x{h}", radius=radius, bitwise=True, launches_per_call=1,
          kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.3f}",
          **{f"kernel_{n}_ms": f"{kernel_n_ms:.4f}", f"plain_{n}_ms": f"{plain_n_ms:.3f}",
             f"bound_{n}_ms": f"{n * w * 36 / 3.35e9:.4f}"},
          host_us_per_call=f"{host_us:.1f}")


def blur_bands_phase(label, image, bmap, radius, n_bands):
    """[blur:bands:<label>]: the band form (``halo=(top, bottom)``) as the
    sharded tail calls it, on a band's rows plus the radius's rows that its
    neighbours send, cut at the frame's edges: the first, the second and the
    last of ``n_bands`` bands, each bitwise the plain version on the same
    band inputs and its rows of the whole frame's blur, which is bitwise the
    plain version too."""
    h = image.shape[0]
    rows = h // n_bands
    whole = blur.variable_gaussian_blur(image, bmap, radius)
    require(torch.equal(whole, blur.variable_gaussian_blur_plain(image, bmap, radius)),
            f"blur:bands:{label}: whole frame, kernel vs plain version: not bitwise equal")
    halos = []
    for r0 in (0, rows, h - rows):
        top, bottom = min(radius, r0), min(radius, h - r0 - rows)
        band = slice(r0 - top, r0 + rows + bottom)
        blur_cuda.reset_launch_count()
        got = blur.variable_gaussian_blur(image[band], bmap[band], radius, halo=(top, bottom))
        want = blur.variable_gaussian_blur_plain(image[band], bmap[band], radius,
                                                 halo=(top, bottom))
        torch.cuda.synchronize()
        require(blur_cuda.LAUNCHES == 1 and torch.equal(got, want),
                f"blur:bands:{label}: band at row {r0}, kernel vs plain version: not bitwise "
                "equal, or not one launch")
        require(torch.equal(got, whole[r0:r0 + rows]),
                f"blur:bands:{label}: band at row {r0} != its rows of the whole frame's blur")
        halos.append((r0, top, bottom))
    require(any(t == b == radius for _, t, b in halos),
            f"blur:bands:{label}: no band with the whole halo on both sides: {halos}")
    phase(f"blur:bands:{label}", size=f"{image.shape[1]}x{h}", radius=radius, bands=n_bands,
          band_rows=rows, checked=[f"{r0}+{rows}:{t}/{b}" for r0, t, b in halos],
          band_eq_plain="bitwise", band_eq_whole="bitwise", whole_eq_plain="bitwise")


def denoise_phases(smi):
    """The denoised frame: [conv_parity], [conv_bound], [denoise_parity],
    [denoised_trace_parity], [denoised_path], [denoise_breakdown].  Returns
    the kernels-JSON entry of the convolution kernel and the trace kernel's
    numbers at this frame's shape."""
    t0 = time.perf_counter()
    dscene = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, DN_W, DN_H)))
    net = rt.net_for_params(rt.load_params(str(WEIGHTS)))  # built once, on the card
    require(isinstance(net, rt.UNetDenoiser) and net.base == 24, "shipped weights: UNet, base 24")
    cfg = rt.RenderConfig(rays_per_pixel=DN_RPP)  # the defaults: denoiser, AA, blur, exact on
    require(cfg.use_denoiser and cfg.use_blur and cfg.use_aa and cfg.exact_silhouettes,
            "default config")
    torch.cuda.synchronize()
    phase("denoise_setup", seconds=f"{time.perf_counter() - t0:.3f}", size=f"{DN_W}x{DN_H}",
          rpp=DN_RPP, weights=WEIGHTS.name,
          params=sum(p.numel() for p in net.parameters()))

    rows, entry = conv_phases(net, smi)

    # --- the trace kernel at this frame's own launch shape (non-square, 8
    # rays per pixel, default rays_per_block), at both cameras of the
    # sequence ---
    trace_rest = denoised_trace_parity("rest", dscene, rt.Camera(), cfg, 0)
    trace_zoom = denoised_trace_parity("zoom", dscene, rt.Camera(zoom_factor=0.9), cfg, 13)
    phase("denoised_trace_parity", size=f"{DN_W}x{DN_H}", rpp=DN_RPP,
          max_abs_err=f"{max(trace_rest['max_abs_err'], trace_zoom['max_abs_err']):.3e}",
          lists_eq_full="bitwise", cameras="rest,zoom0.9")

    learned = denoised_sequence("learned", dscene, cfg, net)
    analytic = denoised_sequence("analytic", dscene, cfg, None)
    progressive_sequence(dscene, cfg, net)
    phase("denoised_path", learned_ms_per_frame=f"{learned['frame_ms']:.3f}",
          analytic_ms_per_frame=f"{analytic['frame_ms']:.3f}",
          conv_launches_per_frame=learned["conv_launches"] // DN_FRAMES)

    # --- apply_denoiser on a traced frame: kernel route vs plain route ---
    state, cam, tables, gl = (learned[k] for k in ("state", "cam", "tables", "gl"))
    raw, bmap = rt.trace_image(dscene, cam, cfg, state.frame, tables, gl)
    noise = denoiser.noise_level(DN_RPP)
    args = (net, raw, state.prev_image, bmap, 1.0, noise, state.frame)
    a = denoiser._apply_denoiser(*args, conv_cuda.conv3x3)
    b = denoiser._apply_denoiser(*args, conv_cuda.conv3x3_plain)
    # The network's output is a bf16 residual: where a layer's accumulator
    # moved by a step, single values of it move by one bf16 step, 3.9e-3
    # below 1 and 7.8e-3 from 1 to 2.  Bar: max below 1e-2, fewer than 1e-4
    # of values above 5e-3, mean below 1e-4.
    d = (a - b).abs()
    dmax, dmean, dbig = float(d.max()), float(d.mean()), float((d > 5e-3).float().mean())
    require(bool(torch.isfinite(a).all()) and dmax < 1e-2 and dbig < 1e-4 and dmean < 1e-4,
            f"apply_denoiser kernel route vs plain route: max {dmax} mean {dmean} "
            f"share above 5e-3 {dbig}")
    phase("denoise_parity", size=f"{DN_W}x{DN_H}", max_abs_diff=f"{dmax:.3e}",
          mean_abs_diff=f"{dmean:.3e}", share_above_5e3=f"{dbig:.3e}",
          share_equal=f"{float((a == b).float().mean()):.6f}",
          bar="max<1e-2,share(>5e-3)<1e-4,mean<1e-4")

    # --- where the denoised frame's time goes (each stage timed alone) ---
    n_px = DN_W * DN_H
    trace_ms, _ = cuda_ms(lambda: trace_cuda.trace_sums_flat(dscene, cam, cfg, 0, 0, n_px, tables, gl), 5)
    zoomed = rt.add_zoom_flow(state.flow, 1.0, 0.9)
    warp_ms, _ = cuda_ms(lambda: flow.warp_separable(state.prev_image, zoomed), 3)
    bil_ms, spatial = cuda_ms(lambda: denoise.spatial_bilateral(raw[..., :3]), 20)
    bil_plain_ms, spatial_plain = cuda_ms(lambda: denoise.spatial_bilateral_plain(raw[..., :3]), 3)
    require(torch.equal(spatial, spatial_plain),
            "bilateral kernel vs plain version: not bitwise equal")
    prev = state.prev_image[..., :3]
    analytic_img = prev + (spatial - prev) * denoise.TEMPORAL_ALPHA
    aux = torch.stack([bmap, torch.full_like(bmap, noise)], dim=-1)
    unet_ms, _ = cuda_ms(lambda: net(raw[None, ..., :3], prev[None], aux[None], analytic_img[None]), 3)
    whole_ms, den = cuda_ms(lambda: denoiser._apply_denoiser(*args, conv_cuda.conv3x3), 3)
    radius = blur.blur_radius(dscene.max_blur)
    blur_ms, _ = cuda_ms(lambda: blur.variable_gaussian_blur(den, bmap, radius), 3)
    tden_ms, _ = cuda_ms(lambda: denoise.temporal_denoise(raw, state.prev_image, state.flow,
                                                          state.frame, 1.0, True), 3)
    phase("denoise_breakdown", trace_ms=f"{trace_ms:.3f}", warp_ms=f"{warp_ms:.3f}",
          bilateral_ms=f"{bil_ms:.3f}", bilateral_plain_ms=f"{bil_plain_ms:.3f}",
          unet_ms=f"{unet_ms:.3f}",
          convs_ms=f"{sum(r['ms'] for r in rows):.3f}", apply_denoiser_ms=f"{whole_ms:.3f}",
          temporal_denoise_ms=f"{tden_ms:.3f}", blur_ms=f"{blur_ms:.3f}", blur_radius=radius,
          **{f"{r['name']}_ms": f"{r['ms']:.3f}" for r in rows})
    blur_phase(den, bmap, radius)
    phase("denoise_breakdown:library", call="F.conv2d(bf16,channels_last)",
          total_ms=f"{sum(r['library_ms'] for r in rows):.3f}",
          **{f"{r['name']}_ms": f"{r['library_ms']:.3f}" for r in rows})
    phase("denoise_breakdown:plain", total_ms=f"{sum(r['plain_ms'] for r in rows):.1f}",
          **{f"{r['name']}_ms": f"{r['plain_ms']:.1f}" for r in rows})
    # the trace launch timed above: the camera after the zoom step, frame 0
    t_ops_ms, t_bytes_ms = list_bound("denoised_trace_bound", dscene, cam, cfg,
                                      trace_cuda.narrow_cand_tables(tables, gl), trace_ms)

    entry.update(launches=learned["conv_launches"],
                 launches_per_frame=learned["conv_launches"] // DN_FRAMES,
                 denoised_frame_ms=learned["frame_ms"],
                 denoised_host_enqueue_ms=learned["enqueue_ms"],
                 denoised_host_enqueue_queue_empty_ms=learned["drained_ms"],
                 denoised_device_ms=learned["device_ms"],
                 analytic_device_ms=analytic["device_ms"],
                 analytic_frame_ms=analytic["frame_ms"],
                 denoise_parity_max_abs_diff=dmax, unet_ms=unet_ms)
    trace_entry = dict(denoised_launches=learned["trace_launches"],
                       denoised_max_abs_err=trace_rest["max_abs_err"],
                       denoised_zoom_max_abs_err=trace_zoom["max_abs_err"],
                       denoised_ms=trace_ms, denoised_plain_ms=trace_rest["plain_ms"],
                       denoised_bound_ms=max(t_ops_ms, t_bytes_ms),
                       denoised_bound_by="operations" if t_ops_ms >= t_bytes_ms else "bytes")
    return entry, trace_entry


# ---------------------------------------------------------------------------
# the dense-scene frame
# ---------------------------------------------------------------------------


def dense_setup(kind, rpp):
    """[dense_setup]: the generated scene of one class on the card with its
    full-frame tables at the rest camera; asserts the premise (a list
    overflows, so the horizon fallback has work)."""
    t0 = time.perf_counter()
    dscene = rt.build_device_scene(rt.load_scene_from_string(dense_scene_xml(0, DN_W, DN_H, kind)))
    cfg = rt.RenderConfig(rays_per_pixel=rpp)  # the defaults: denoiser, AA, blur, exact on
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    accel = trace_cuda.accel_kind(dscene, cfg)
    require(accel == "seg", f"{kind}: segment lists, got {accel}")
    cand_len = trace_cuda._cand_len_for(dscene.s_pad)
    t0 = time.perf_counter()
    tables = rt.build_cand_tables(dscene, rt.Camera(), cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(rt.seg_max_count(dscene, tables) is None, f"{kind}: capped lists are not narrowed")
    counts = tables.counts
    over = float((counts > cand_len).float().mean())
    require(int(counts.max()) > cand_len, f"{kind}: no cell overflows cand_len {cand_len}")
    require(tables.ids.shape[-1] == cand_len and tables.chunk_ids is not None,
            f"{kind}: capped lists with chunk lists")
    geom = trace_cuda._grid_geom(dscene, cfg, DN_W, DN_W * DN_H)
    require(geom[4] == DENSE_TILE_ROWS, f"{kind}: tile height {geom[4]}")
    phase(f"dense_setup:{kind}", n_sub=dscene.n_sub, s_pad=dscene.s_pad,
          chunks=dscene.chunk_bounds.shape[0], kind=accel, cand_len=cand_len,
          tiles=geom[7], wedges=geom[3], samples_per_wedge=geom[2],
          mean_count=f"{float(counts.clamp(max=cand_len).float().mean()):.2f}",
          max_count=int(counts.max()), cells_past_cand_len=f"{over:.4f}",
          mean_chunks=f"{float(tables.chunk_counts.float().mean()):.2f}",
          hazard_slots=f"{float((tables.lbs == 0.0).float().sum(-1).mean()):.2f}",
          key_slack_max=f"{float(tables.circle[3]):.3f}", table_bytes=tables.nbytes,
          scene_seconds=f"{scene_s:.3f}", build_seconds=f"{build_s:.3f}")
    return dscene, cfg, tables, build_s


def dense_band_parity(label, dscene, cfg, cam, frame, row0, rows, plain_rows, whole=None,
                      need_fallback=False):
    """Kernel with the band's own tables vs the kernel's full sweep on
    ``rows`` rows from ``row0`` (bitwise), and vs the plain version on the
    first ``plain_rows`` of them (assert_parity bars).  ``whole``: sums of
    the whole frame at this camera and frame; the band must equal its rows
    of them bitwise (tiles align: row0 is a multiple of the tile height).
    ``need_fallback``: the band's counting launch must show rays that
    continued into the chunk lists."""
    w = dscene.width
    px0, n_band = row0 * w, rows * w
    tabs = trace_cuda.build_cand_tables(dscene, cam, cfg, px0, n_band)
    kern = trace_cuda.trace_sums_flat(dscene, cam, cfg, frame, px0, n_band, tabs)
    sweep_ms, full = cuda_ms(
        lambda: trace_cuda.trace_sums_flat(dscene, cam, cfg, frame, px0, n_band, None), 1)
    for a, b in zip(kern, full):
        require(torch.equal(a, b), f"dense {label}: kernel with lists != kernel full sweep")
    if whole is not None:
        for a, b in zip(kern, whole):
            require(torch.equal(a, b[px0:px0 + n_band]),
                    f"dense {label}: band launch != its rows of the whole-frame launch")
    n_plain = plain_rows * w
    ptabs = tabs if plain_rows == rows else trace_cuda.build_cand_tables(dscene, cam, cfg, px0, n_plain)
    plain_ms, plain = cuda_ms(
        lambda: trace_cuda.trace_sums_plain(dscene, cam, cfg, frame, px0, n_plain, ptabs), 1)
    kern_p = tuple(a[:n_plain] for a in kern)
    err = parity(normalized(plain, plain_rows, w, cfg), normalized(kern_p, plain_rows, w, cfg))
    sums_err = max(float((a - b).abs().max()) for a, b in zip(plain, kern_p))
    require(float(kern[1].sum()) > 0.0, f"dense {label}: the band has weight")
    st = trace_cuda.trace_walk_stats(dscene, cam, cfg, frame, px0, n_band, tabs)
    require(not need_fallback or st["fallback_rays"] > 0,
            f"dense {label}: no ray entered the chunk fallback")
    cand_len = tabs.ids.shape[-1]
    phase(f"dense_parity:{label}", zoom=cam.zoom_factor, frame=frame, rows=f"{row0}+{rows}",
          rays=n_band * cfg.rays_per_pixel, lists_eq_full="bitwise",
          cells_past_cand_len=f"{float((tabs.counts > cand_len).float().mean()):.4f}",
          slots_per_ray=f"{st['list_slots'] / max(st['live_rays'], 1):.2f}",
          fallback_rays=st["fallback_rays"],
          fallback_share=f"{st['fallback_rays'] / max(st['live_rays'], 1):.5f}",
          chunks_per_fallback_ray=f"{st['chunks'] / max(st['fallback_rays'], 1):.2f}",
          full_sweep_ms=f"{sweep_ms:.1f}", plain_rows=plain_rows,
          plain_rays=n_plain * cfg.rays_per_pixel, max_abs_err=f"{err:.3e}",
          sums_max_abs_err=f"{sums_err:.3e}", plain_ms=f"{plain_ms:.1f}")
    return dict(max_abs_err=err, plain_ms=plain_ms, plain_rays=n_plain * cfg.rays_per_pixel)


def dense_stats(label, dscene, cfg, cam, tables, trace_ms, need_fallback):
    """[dense_stats] and [dense_bound] of one full-frame launch: the
    counting instantiation's totals, and the card's least time for that
    work: operations at the unfused FP32 rate (OPS_* above: per pair tested,
    per ray of a non-empty cell, per clean hit, per graze), and bytes: the
    scene's rows, the table entries the walks read (per cell the mean prefix
    of ids and lbs its rays tested, chunk entries alike, counts and
    horizons) and the output."""
    n_px = dscene.width * dscene.height
    st = trace_cuda.trace_walk_stats(dscene, cam, cfg, 0, 0, n_px, tables)
    rays = n_px * cfg.rays_per_pixel
    live = st["live_rays"]
    require(0 < live <= rays, f"{label}: live rays {live}")
    require(not need_fallback or st["fallback_rays"] > 0,
            f"{label}: no ray entered the chunk fallback")
    require(st["clean_hits"] + st["grazes"] > 0.5 * rays, f"{label}: most rays hit something")
    pairs = st["list_slots"] + st["chunk_pairs"]
    cells = tables.counts.numel()
    require(st["list_slots"] <= st["warp_slots"] <= 32 * st["list_slots"],
            f"{label}: warp slots {st['warp_slots']} against list slots {st['list_slots']}")
    warp_eff = st["list_slots"] / max(st["warp_slots"], 1)
    phase(f"dense_stats:{label}", rays=rays, live_rays=live,
          slots_per_ray=f"{st['list_slots'] / live:.2f}",
          warp_slots_per_ray=f"{st['warp_slots'] / live:.2f}",
          warp_slot_efficiency=f"{warp_eff:.4f}",
          fallback_share=f"{st['fallback_rays'] / live:.5f}",
          chunks_per_fallback_ray=f"{st['chunks'] / max(st['fallback_rays'], 1):.2f}",
          pairs_per_ray=f"{pairs / live:.2f}", pairs=f"{pairs:.4e}",
          full_sweep_pairs=f"{rays * dscene.n_sub:.4e}",
          hits=st["clean_hits"] + st["grazes"], grazes=st["grazes"],
          hit_share=f"{(st['clean_hits'] + st['grazes']) / rays:.4f}")
    ops = (OPS_PER_PAIR * pairs + OPS_PER_RAY * live + OPS_PER_HIT * st["clean_hits"]
           + OPS_PER_GRAZE * st["grazes"])
    table_read = cells * (8 * st["list_slots"] / live + 8 * st["chunks"] / live + 12)
    n_bytes = record_bytes(dscene) + table_read + 5 * n_px * 4
    ops_ms, bytes_ms = ops / PEAK_FP32_UNFUSED_PER_S * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    phase(f"dense_bound:{label}", fp32_ops=f"{ops:.4e}", walk_ops=f"{OPS_PER_PAIR * pairs:.4e}",
          raygen_ops=f"{OPS_PER_RAY * live:.4e}",
          shade_ops=f"{OPS_PER_HIT * st['clean_hits'] + OPS_PER_GRAZE * st['grazes']:.4e}",
          bytes=int(n_bytes), table_bytes_read=int(table_read), ops_ms=f"{ops_ms:.4f}",
          bytes_ms=f"{bytes_ms:.4f}", bound_ms=f"{bound_ms:.4f}", kernel_ms=f"{trace_ms:.3f}",
          share_of_bound=f"{bound_ms / trace_ms:.4f}",
          pairs_per_s=f"{pairs / (trace_ms * 1e-3):.4e}")
    return dict(bound_ms=bound_ms, bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                slots_per_ray=st["list_slots"] / live, fallback_share=st["fallback_rays"] / live,
                warp_slot_efficiency=warp_eff)


def dense_few_wedges(dscene, cam):
    """[dense_few_wedges]: the dense scene at the denoised frame's 8 rays
    per pixel, two wedges of half a turn: every chord is parallel to some
    ray of its wedge, so the key guard bounds every slot with 0 and no ray
    leaves its list early — the guard's worst case, timed against the
    kernel's full sweep of the same launch."""
    cfg = rt.RenderConfig(rays_per_pixel=DN_RPP)
    n_px = dscene.width * dscene.height
    require(trace_cuda.accel_kind(dscene, cfg) == "seg", "few wedges: segment lists")
    tables = rt.build_cand_tables(dscene, cam, cfg)
    ms, kern = cuda_ms(lambda: trace_cuda.trace_sums_flat(dscene, cam, cfg, 0, 0, n_px, tables), 3)
    sweep_ms, full = cuda_ms(
        lambda: trace_cuda.trace_sums_flat(dscene, cam, cfg, 0, 0, n_px, None), 3)
    for a, b in zip(kern, full):
        require(torch.equal(a, b), "few wedges: kernel with lists != kernel full sweep")
    st = trace_cuda.trace_walk_stats(dscene, cam, cfg, 0, 0, n_px, tables)
    live = max(st["live_rays"], 1)
    pairs_per_ray = (st["list_slots"] + st["chunk_pairs"]) / live
    cand_len = tables.ids.shape[-1]
    phase("dense_few_wedges", rpp=DN_RPP, wedges=tables.ids.shape[1], rays=n_px * DN_RPP,
          lists_eq_full="bitwise", kernel_ms=f"{ms:.3f}", full_sweep_ms=f"{sweep_ms:.3f}",
          slots_per_ray=f"{st['list_slots'] / live:.2f}",
          fallback_share=f"{st['fallback_rays'] / live:.5f}",
          chunks_per_fallback_ray=f"{st['chunks'] / max(st['fallback_rays'], 1):.2f}",
          pairs_per_ray=f"{pairs_per_ray:.2f}", full_sweep_pairs_per_ray=dscene.n_sub,
          cells_past_cand_len=f"{float((tables.counts > cand_len).float().mean()):.4f}",
          hazard_slots=f"{float((tables.lbs == 0.0).float().sum(-1).mean()):.2f}",
          table_bytes=tables.nbytes)
    return dict(ms=ms, sweep_ms=sweep_ms, pairs_per_ray=pairs_per_ray)


def dense_phases():
    """The dense-scene frame: [dense_setup], [dense_parity], [dense_path],
    [dense_breakdown], [dense_stats], [dense_bound].  Returns the trace
    kernel's dense_* numbers for the kernels JSON."""
    net = rt.net_for_params(rt.load_params(str(WEIGHTS)))
    cam, zoomed = rt.Camera(), rt.Camera(zoom_factor=0.9)
    n_px = DN_W * DN_H

    # --- lady_bug class, 256 rays per pixel: BASELINE config 3 ---
    dscene, cfg, tables, build_s = dense_setup("lady_bug", DENSE_RPP)
    require(cfg.use_denoiser and cfg.use_blur and cfg.use_aa and cfg.exact_silhouettes,
            "default config")
    # (a) the whole frame: lists == the kernel's own full sweep, bit for bit
    kern = trace_cuda.trace_sums_flat(dscene, cam, cfg, 0, 0, n_px, tables)
    sweep_ms, full = cuda_ms(
        lambda: trace_cuda.trace_sums_flat(dscene, cam, cfg, 0, 0, n_px, None), 1)
    for a, b in zip(kern, full):
        require(torch.equal(a, b), "dense frame: kernel with lists != kernel full sweep")
    differing = int((kern[1] != full[1]).sum())
    phase("dense_parity:lady_bug_frame", rays=n_px * DENSE_RPP, lists_eq_full="bitwise",
          differing_pixels=differing, full_sweep_ms=f"{sweep_ms:.1f}",
          full_sweep_pairs=f"{n_px * DENSE_RPP * dscene.n_sub:.4e}")
    del full
    # (b) two tile rows vs the plain version, at both cameras of the sequence
    band0 = 16 * DENSE_TILE_ROWS
    rest = dense_band_parity("lady_bug_rest", dscene, cfg, cam, 0, band0, 2 * DENSE_TILE_ROWS,
                             2 * DENSE_TILE_ROWS, whole=kern)
    zoom = dense_band_parity("lady_bug_zoom", dscene, cfg, zoomed, 7, band0, 2 * DENSE_TILE_ROWS,
                             2 * DENSE_TILE_ROWS)
    del kern
    # A zoomed-out view (the drawing a third of the frame wide): tiles cover
    # nine times the area and see the whole drawing inside one wedge, so
    # many more lists overflow than at the rest camera, where only the cells
    # that see the aphid from afar do.
    dense_band_parity("lady_bug_wide", dscene, cfg, rt.Camera(zoom_factor=3.0), 3, band0,
                      2 * DENSE_TILE_ROWS, DENSE_TILE_ROWS, need_fallback=True)

    # --- the frame through the public entry points ---
    seq = denoised_sequence("learned", dscene, cfg, net, DENSE_FRAMES, "dense_path")
    require(seq["trace_launches"] == DENSE_FRAMES and seq["conv_launches"] == 9 * DENSE_FRAMES,
            "dense path: 1 trace and 9 conv launches per frame")

    # --- where the dense frame's time goes (each stage timed alone) ---
    trace_ms, sums = cuda_ms(
        lambda: trace_cuda.trace_sums_flat(dscene, cam, cfg, 0, 0, n_px, tables), 3)
    raw, bmap = normalized(sums, DN_H, DN_W, cfg)
    state = seq["state"]
    noise = denoiser.noise_level(DENSE_RPP)
    den_ms, den = cuda_ms(lambda: rt.apply_denoiser(net, raw, state.prev_image, bmap, mix=1.0,
                                                    noise=noise, frame=state.frame), 3)
    radius = blur.blur_radius(dscene.max_blur)
    blur_ms, _ = cuda_ms(lambda: blur.variable_gaussian_blur(den, bmap, radius), 3)
    phase("dense_breakdown", trace_ms=f"{trace_ms:.3f}", apply_denoiser_ms=f"{den_ms:.3f}",
          blur_ms=f"{blur_ms:.3f}", blur_radius=radius,
          frame_ms=f"{seq['frame_ms']:.3f}", device_ms_per_frame=f"{seq['device_ms']:.3f}",
          host_enqueue_ms=f"{seq['enqueue_ms']:.3f}",
          host_enqueue_ms_queue_empty=f"{seq['drained_ms']:.3f}",
          trace_share_of_frame=f"{trace_ms / seq['frame_ms']:.4f}",
          rays_per_s=f"{n_px * DENSE_RPP / (trace_ms * 1e-3):.4e}",
          table_build_seconds=f"{build_s:.3f}")
    lb_stats = dense_stats("lady_bug", dscene, cfg, cam, tables, trace_ms, need_fallback=True)
    path = {k: seq[k] for k in ("frame_ms", "enqueue_ms", "drained_ms", "device_ms", "zoom_ms",
                                "rebuild_s", "trace_launches")}
    del tables, sums, raw, bmap, den, seq, state
    few = dense_few_wedges(dscene, cam)

    # (d) chunk lists only: more than 64 wedges, no segment lists
    cscene = rt.build_device_scene(rt.load_scene_from_string(dense_scene_xml(0, 256, 256, "lady_bug")))
    ccfg = rt.RenderConfig(rays_per_pixel=512, use_denoiser=False)
    require(trace_cuda.accel_kind(cscene, ccfg, wedge_shift=0) == "chunk",
            "chunk lists only at 128 wedges, wedge shift 0")
    ctabs = rt.build_cand_tables(cscene, cam, ccfg, wedge_shift=0)
    require(ctabs.ids is None and ctabs.chunk_ids is not None, "chunk kind: chunk lists alone")
    c_n = 256 * 256
    c_ms, ck = cuda_ms(lambda: trace_cuda.trace_sums_flat(cscene, cam, ccfg, 0, 0, c_n, ctabs), 1)
    c_sweep_ms, cf = cuda_ms(lambda: trace_cuda.trace_sums_flat(cscene, cam, ccfg, 0, 0, c_n, None), 1)
    for a, b in zip(ck, cf):
        require(torch.equal(a, b), "chunk kind: kernel with chunk lists != kernel full sweep")
    c_rows = 64
    cband = trace_cuda.build_cand_tables(cscene, cam, ccfg, 0, c_rows * 256, wedge_shift=0)
    c_plain_ms, cp = cuda_ms(
        lambda: trace_cuda.trace_sums_plain(cscene, cam, ccfg, 0, 0, c_rows * 256, cband), 1)
    c_err = parity(normalized(cp, c_rows, 256, ccfg),
                   normalized(tuple(a[:c_rows * 256] for a in ck), c_rows, 256, ccfg))
    cst = trace_cuda.trace_walk_stats(cscene, cam, ccfg, 0, 0, c_n, ctabs)
    phase("dense_parity:chunk_kind", s_pad=cscene.s_pad, size="256x256", rpp=512,
          wedges=ctabs.chunk_ids.shape[1], lists_eq_full="bitwise", max_abs_err=f"{c_err:.3e}",
          kernel_ms=f"{c_ms:.3f}", full_sweep_ms=f"{c_sweep_ms:.3f}", plain_ms=f"{c_plain_ms:.1f}",
          plain_rows=c_rows, chunks_per_ray=f"{cst['chunks'] / max(cst['live_rays'], 1):.2f}",
          mean_chunks_listed=f"{float(ctabs.chunk_counts.float().mean()):.2f}")
    del cscene, ctabs, ck, cf, cp, cband

    # --- dolphin class, 64 rays per pixel: the dense block geometry ---
    dol, dcfg, dtabs, dol_build_s = dense_setup("dolphin", DENSE_RPP_DOLPHIN)
    require(dol.s_pad > trace_cuda.DENSE_SPAD, "dolphin class: dense block geometry")
    # (c) eight tile rows vs the full sweep, one of them vs the plain version
    dol_par = dense_band_parity("dolphin", dol, dcfg, cam, 0, band0, 8 * DENSE_TILE_ROWS,
                                DENSE_TILE_ROWS, need_fallback=True)
    dol_ms, _ = cuda_ms(
        lambda: trace_cuda.trace_sums_flat(dol, cam, dcfg, 0, 0, n_px, dtabs), 3)
    phase("dense_breakdown:dolphin", trace_ms=f"{dol_ms:.3f}", rpp=DENSE_RPP_DOLPHIN,
          rays_per_s=f"{n_px * DENSE_RPP_DOLPHIN / (dol_ms * 1e-3):.4e}",
          table_build_seconds=f"{dol_build_s:.3f}")
    dol_stats = dense_stats("dolphin", dol, dcfg, cam, dtabs, dol_ms, need_fallback=True)

    band_rays = rest["plain_rays"]
    return dict(
        dense_launches=path["trace_launches"], dense_ms=trace_ms, dense_frame_ms=path["frame_ms"],
        dense_host_enqueue_ms=path["enqueue_ms"],
        dense_host_enqueue_queue_empty_ms=path["drained_ms"], dense_device_ms=path["device_ms"],
        dense_zoom_frame_ms=path["zoom_ms"],
        dense_zoom_tables_rebuild_s=path["rebuild_s"],
        dense_max_abs_err=rest["max_abs_err"], dense_zoom_max_abs_err=zoom["max_abs_err"],
        dense_plain_band_ms=rest["plain_ms"], dense_plain_band_rays=band_rays,
        dense_bound_ms=lb_stats["bound_ms"], dense_bound_by=lb_stats["bound_by"],
        dense_slots_per_ray=lb_stats["slots_per_ray"],
        dense_warp_slot_efficiency=lb_stats["warp_slot_efficiency"],
        dense_fallback_share=lb_stats["fallback_share"],
        dense_full_sweep_ms=sweep_ms, dense_table_build_s=build_s,
        dense_dolphin_ms=dol_ms, dense_dolphin_max_abs_err=dol_par["max_abs_err"],
        dense_dolphin_bound_ms=dol_stats["bound_ms"],
        dense_dolphin_slots_per_ray=dol_stats["slots_per_ray"],
        dense_dolphin_warp_slot_efficiency=dol_stats["warp_slot_efficiency"],
        dense_dolphin_table_build_s=dol_build_s,
        dense_chunk_kind_ms=c_ms, dense_chunk_kind_max_abs_err=c_err,
        dense_few_wedges_ms=few["ms"], dense_few_wedges_full_sweep_ms=few["sweep_ms"],
        dense_few_wedges_pairs_per_ray=few["pairs_per_ray"],
    )


# ---------------------------------------------------------------------------
# BASELINE config 5: 3840x2160, 1024 rays per pixel, wedge-coarsened tables
# ---------------------------------------------------------------------------

# benchmarks/run_all.py:267-286 on one card: the arch-class scene at
# 3840x2160, 1024 rays per pixel, blur on, denoiser off, AA and exact
# silhouettes on, tables hoisted and narrowed by seg_max_count.  256 wedges:
# segment lists exist only over coarser wedges (trace_cuda.table_layout:
# shift 2 on the seeded scene, 3 on the lady_bug class).
C5_W, C5_H, C5_RPP = 3840, 2160, 1024
C5_FRAMES, C5_ROUNDS = 3, 2  # timed frames per route and round; rounds in turns
C5_BAND_ROWS = 16  # the last tile row (2160 = 67 x 32 + 16): ray ids past 2^32
C5_LB_ROW, C5_LB_ROWS = 1024, 32  # the lady_bug class's band: one tile row
C5_SHADE_ROW_STEP = 64  # the bound counts clean hits and grazes on every 64th row


def config5_config():
    return rt.RenderConfig(rays_per_pixel=C5_RPP, use_blur=True, use_denoiser=False)


def config5_setup():
    """[config5:setup]: the scene on the card and its hoisted tables, as
    run_all.py's config 5 builds them (build_cand_tables, seg_max_count,
    narrow_cand_tables)."""
    t0 = time.perf_counter()
    scene = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, C5_W, C5_H)))
    cfg = config5_config()
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    require(cfg.use_aa and cfg.use_blur and cfg.exact_silhouettes and not cfg.use_denoiser,
            "config5: AA, blur, exact silhouettes on, denoiser off")
    kind, shift = trace_cuda.table_layout(scene, cfg)
    require(kind == "seg" and shift == 2, f"config5: kind {kind}, wedge shift {shift}")
    _, _, sw, n_wedges, _, _, _, n_tiles = trace_cuda._grid_geom(scene, cfg, C5_W, C5_W * C5_H)
    t0 = time.perf_counter()
    built = rt.build_cand_tables(scene, rt.Camera(), cfg)
    gl = rt.seg_max_count(scene, built)
    tables = rt.narrow_cand_tables(built, gl)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    built_bytes = built.nbytes
    require(built.ids.shape == (n_tiles, n_wedges >> shift, scene.s_pad),
            f"config5: tables {tuple(built.ids.shape)}")
    require(built_bytes == trace_cuda._seg_table_bytes(scene.s_pad, n_tiles, n_wedges >> shift),
            "config5: table bytes as counted by the rule")
    del built
    counts = tables.counts
    fine_bytes = trace_cuda._seg_table_bytes(scene.s_pad, n_tiles, n_wedges)
    phase("config5:setup", size=f"{C5_W}x{C5_H}", rpp=C5_RPP, n_sub=scene.n_sub,
          s_pad=scene.s_pad, kind=kind, wedge_shift=shift, wedges=n_wedges,
          table_wedges=n_wedges >> shift, samples_per_wedge=sw, tiles=n_tiles,
          table_bytes_built=built_bytes, table_gib_built=f"{built_bytes / 2**30:.3f}",
          fine_table_gib=f"{fine_bytes / 2**30:.3f}",
          cap_gib=f"{trace_cuda._CAND_TABLE_BYTES_CAP / 2**30:.3f}",
          gather_len=gl, table_bytes=tables.nbytes,
          mean_count=f"{float(counts.float().mean()):.3f}", max_count=int(counts.max()),
          empty_cells=f"{float((counts == 0).float().mean()):.4f}",
          scene_seconds=f"{scene_s:.3f}", build_seconds=f"{build_s:.3f}")
    return scene, cfg, tables, gl, dict(shift=shift, n_wedges=n_wedges, build_s=build_s,
                                        table_bytes=built_bytes, gather_len=gl)


def config5_frames(scene, cfg, tables, gl):
    """[config5:path]: render_frame chained through the public entry points,
    the coarse lists (the main path) and, in turns with it, the route
    without coarsening (chunk lists, a forced wedge shift of 0); the sync
    check; the card alone behind a sleep; each route's trace alone."""
    cam = rt.Camera()
    n_px = C5_W * C5_H
    ctables = rt.build_cand_tables(scene, cam, cfg, wedge_shift=0)
    n_wedges = trace_cuda._grid_geom(scene, cfg, C5_W, n_px)[3]
    require(ctables.ids is None and ctables.chunk_ids.shape[1] == n_wedges,
            "config5: forced shift 0 takes chunk lists at the fine wedge")
    routes = {"coarse": (tables, gl), "chunk": (ctables, None)}
    holders, steps = {}, {}
    for name, (tabs, g) in routes.items():
        holder = {"state": rt.init_frame_state(C5_W, C5_H)}

        def step(tabs=tabs, g=g, holder=holder):
            holder["img"], holder["state"] = rt.render_frame(
                scene, cam, holder["state"], cfg, cand_tables=tabs, gather_len=g)

        step()
        holders[name], steps[name] = holder, step
    first_frames = [holders["coarse"]["img"].cpu()]  # frames 0 and 1, for [sharded:config5]
    torch.cuda.synchronize()
    # a frame queues without waiting for the card: any host sync raises here
    torch.cuda.set_sync_debug_mode("error")
    steps["coarse"]()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    first_frames.append(holders["coarse"]["img"].cpu())
    frame0 = holders["coarse"]["state"].frame
    frame_ms = {n: [] for n in routes}
    enqueue_ms = {n: [] for n in routes}
    trace_ms = {n: [] for n in routes}
    launches = {n: 0 for n in routes}
    sums = {}
    for r in range(C5_ROUNDS):
        for name in (("coarse", "chunk") if r % 2 == 0 else ("chunk", "coarse")):
            trace_cuda.reset_launch_count()
            ms, enq = timed_frames(steps[name], C5_FRAMES)
            launches[name] += trace_cuda.LAUNCHES
            frame_ms[name].append(ms)
            enqueue_ms[name].append(enq)
            tabs, g = routes[name]
            ms, sums[name] = cuda_ms(
                lambda: trace_cuda.trace_sums_flat(scene, cam, cfg, 0, 0, n_px, tabs, g), 1)
            trace_ms[name].append(ms)
    require(launches["coarse"] == C5_ROUNDS * C5_FRAMES,
            f"config5: {launches['coarse']} trace launches in {C5_ROUNDS * C5_FRAMES} frames")
    for a, b in zip(sums["coarse"], sums["chunk"]):
        require(torch.equal(a, b), "config5: coarse lists != chunk lists")
    device_ms = device_frame_ms(steps["coarse"])
    state, img = holders["coarse"]["state"], holders["coarse"]["img"]
    require(state.frame == frame0 + C5_ROUNDS * C5_FRAMES + DEVICE_FRAMES,
            f"config5: frame counter {state.frame}")
    require(img.shape == (C5_H, C5_W, 4) and bool(torch.isfinite(img).all()),
            "config5: finite (H, W, 4) image")
    spread = float(img[..., :3].std())
    require(spread > 0.01, f"config5: spread {spread}")
    require(not torch.equal(img, state.prev_image), "config5: blur left the frame unchanged")
    mean = {n: sum(v) / len(v) for n, v in frame_ms.items()}
    idle = 1.0 - device_ms / mean["coarse"]
    phase("config5:path", frames=C5_FRAMES, rounds=C5_ROUNDS, trace_launches=launches["coarse"],
          ms_per_frame=f"{mean['coarse']:.3f}",
          ms_per_frame_rounds=",".join(f"{v:.3f}" for v in frame_ms["coarse"]),
          host_enqueue_ms=",".join(f"{v:.3f}" for v in enqueue_ms["coarse"]),
          device_ms_per_frame_queue_full=f"{device_ms:.3f}", device_idle_share=f"{idle:.4f}",
          trace_ms=",".join(f"{v:.3f}" for v in trace_ms["coarse"]),
          chunk_route_ms_per_frame=",".join(f"{v:.3f}" for v in frame_ms["chunk"]),
          chunk_route_trace_ms=",".join(f"{v:.3f}" for v in trace_ms["chunk"]),
          chunk_route_table_bytes=ctables.nbytes, coarse_eq_chunk="bitwise", no_host_sync=True,
          rays_per_s=f"{n_px * C5_RPP / (min(trace_ms['coarse']) * 1e-3):.4e}",
          image_std=f"{spread:.4f}")
    return dict(frame_ms=mean["coarse"], enqueue_ms=min(enqueue_ms["coarse"]),
                device_ms=device_ms, idle=idle, trace_ms=min(trace_ms["coarse"]),
                launches=launches["coarse"], chunk_frame_ms=mean["chunk"],
                chunk_trace_ms=min(trace_ms["chunk"]), first_frames=first_frames)


def config5_lady_bug():
    """[config5:lady_bug]: the lady_bug class at config 5's frame: wedge
    shift 3, capped distance-ordered coarse lists with coarse chunk lists;
    a band's lists == the kernel's full sweep bitwise and == its rows of the
    whole-frame launch; [dense_stats] / [dense_bound] of the frame."""
    cam = rt.Camera()
    t0 = time.perf_counter()
    dscene = rt.build_device_scene(
        rt.load_scene_from_string(dense_scene_xml(0, C5_W, C5_H, "lady_bug")))
    cfg = config5_config()
    kind, shift = trace_cuda.table_layout(dscene, cfg)
    require(kind == "seg" and shift == 3, f"config5 lady_bug: kind {kind}, wedge shift {shift}")
    tables = rt.build_cand_tables(dscene, cam, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_wedges = trace_cuda._grid_geom(dscene, cfg, C5_W, C5_W * C5_H)[3]
    require(tables.ids.shape[1] == n_wedges >> shift and tables.chunk_ids is not None,
            "config5 lady_bug: coarse capped lists with chunk lists")
    n_px = C5_W * C5_H
    trace_ms, whole = cuda_ms(
        lambda: trace_cuda.trace_sums_flat(dscene, cam, cfg, 0, 0, n_px, tables), 1)
    px0, n_band = C5_LB_ROW * C5_W, C5_LB_ROWS * C5_W
    btabs = trace_cuda.build_cand_tables(dscene, cam, cfg, px0, n_band)
    require(trace_cuda.table_wedge_shift(btabs, n_wedges) == shift,
            "config5 lady_bug: the band takes the frame's shift")
    kb = trace_cuda.trace_sums_flat(dscene, cam, cfg, 0, px0, n_band, btabs)
    sweep_ms, fb = cuda_ms(
        lambda: trace_cuda.trace_sums_flat(dscene, cam, cfg, 0, px0, n_band, None), 1)
    for a, b, c in zip(kb, fb, whole):
        require(torch.equal(a, b), "config5 lady_bug: band lists != the kernel's full sweep")
        require(torch.equal(a, c[px0:px0 + n_band]),
                "config5 lady_bug: band launch != its rows of the frame's")
    require(float(kb[1].sum()) > 0.0, "config5 lady_bug: the band has weight")
    cand_len = tables.ids.shape[-1]
    phase("config5:lady_bug", n_sub=dscene.n_sub, s_pad=dscene.s_pad, kind=kind,
          wedge_shift=shift, table_wedges=n_wedges >> shift, cand_len=cand_len,
          table_bytes=tables.nbytes, setup_seconds=f"{build_s:.3f}",
          cells_past_cand_len=f"{float((tables.counts > cand_len).float().mean()):.4f}",
          band=f"{C5_LB_ROW}+{C5_LB_ROWS}", band_rays=n_band * C5_RPP, lists_eq_full="bitwise",
          band_eq_frame="bitwise", band_full_sweep_ms=f"{sweep_ms:.1f}",
          frame_trace_ms=f"{trace_ms:.3f}")
    del whole, kb, fb, btabs
    st = dense_stats("config5_lady_bug", dscene, cfg, cam, tables, trace_ms, need_fallback=False)
    return dict(ms=trace_ms, shift=shift, table_bytes=tables.nbytes, bound_ms=st["bound_ms"],
                slots_per_ray=st["slots_per_ray"])


def config5_phases():
    """BASELINE config 5 on one card: [config5:setup], [config5:frame_parity],
    [config5:band_parity], [config5:path], [config5:bound],
    [config5:lady_bug] (with its [dense_stats] / [dense_bound]) and
    [cli:config5].  Returns (the trace kernel's config5_* numbers, the
    path's frames 0 and 1 on the host, which [sharded:config5] holds the
    bands against)."""
    scene, cfg, tables, gl, setup = config5_setup()
    cam = rt.Camera()
    n_px = C5_W * C5_H
    rays = n_px * C5_RPP
    # the whole frame: coarse lists == the kernel's own full sweep, bitwise
    kern = trace_cuda.trace_sums_flat(scene, cam, cfg, 0, 0, n_px, tables, gl)
    sweep_ms, full = cuda_ms(
        lambda: trace_cuda.trace_sums_flat(scene, cam, cfg, 0, 0, n_px, None), 1)
    for a, b in zip(kern, full):
        require(torch.equal(a, b), "config5 frame: coarse lists != the kernel's full sweep")
    require(float(kern[1].sum()) > 0.0, "config5 frame: the trace has weight")
    del full
    # the blur on the sharded cell's bands (four of 540 rows), kernel vs plain
    image, bmap = normalized(kern, C5_H, C5_W, cfg)
    blur_bands_phase("config5", image, bmap, blur.blur_radius(scene.max_blur), 4)
    del image, bmap
    phase("config5:frame_parity", rays=rays, lists_eq_full="bitwise",
          full_sweep_ms=f"{sweep_ms:.1f}", full_sweep_pairs=f"{rays * scene.n_sub:.4e}")
    # the last tile row, ray ids past 2^32: the kernel vs the plain version
    px0, n_band = (C5_H - C5_BAND_ROWS) * C5_W, C5_BAND_ROWS * C5_W
    btabs = trace_cuda.build_cand_tables(scene, cam, cfg, px0, n_band)
    require(trace_cuda.table_wedge_shift(btabs, setup["n_wedges"]) == setup["shift"],
            "config5: the band takes the frame's shift")
    kb = trace_cuda.trace_sums_flat(scene, cam, cfg, 0, px0, n_band, btabs)
    for a, b in zip(kb, kern):
        require(torch.equal(a, b[px0:px0 + n_band]), "config5: band launch != its rows of the frame's")
    del kern
    plain_ms, plain = cuda_ms(
        lambda: trace_cuda.trace_sums_plain(scene, cam, cfg, 0, px0, n_band, btabs), 1)
    err = parity(normalized(plain, C5_BAND_ROWS, C5_W, cfg), normalized(kb, C5_BAND_ROWS, C5_W, cfg))
    sums_err = max(float((a - b).abs().max()) for a, b in zip(plain, kb))
    phase("config5:band_parity", rows=f"{C5_H - C5_BAND_ROWS}+{C5_BAND_ROWS}",
          rays=n_band * C5_RPP, first_ray_id=px0 * C5_RPP,
          last_ray_id=(px0 + n_band) * C5_RPP - 1, wedge_shift=setup["shift"],
          band_eq_frame="bitwise", max_abs_err=f"{err:.3e}", sums_max_abs_err=f"{sums_err:.3e}",
          plain_ms=f"{plain_ms:.1f}")
    del plain, kb, btabs
    path = config5_frames(scene, cfg, tables, gl)
    ops_ms, bytes_ms = list_bound("config5:bound", scene, cam, cfg, tables, path["trace_ms"],
                                  shade_row_step=C5_SHADE_ROW_STEP)
    del scene, tables
    torch.cuda.empty_cache()
    lady = config5_lady_bug()
    torch.cuda.empty_cache()
    mean_ms, setup_ms, phases, metrics, img, wall_s = run_cli(
        "cli_config5", seeded_scene_xml(0, C5_W, C5_H), C5_RPP,
        ["--width", str(C5_W), "--height", str(C5_H), "--no-denoiser", "--frames", "4"])
    require(img.size == (C5_W, C5_H) and img.mode == "RGBA", f"cli config5: image {img.size}")
    require(phases["frame"]["count"] == 3 and metrics["counters"]["frames"] == 3,
            "cli config5: frames")
    phase("cli:config5", size=f"{C5_W}x{C5_H}", rpp=C5_RPP, weights="none",
          average_frame_time_ms=f"{mean_ms:.2f}", setup_ms=f"{setup_ms:.1f}",
          wall_s=f"{wall_s:.2f}", phases=json.dumps(phases), metrics=json.dumps(metrics))
    return path["first_frames"], dict(
        config5_launches=path["launches"], config5_ms=path["trace_ms"],
        config5_frame_ms=path["frame_ms"], config5_host_enqueue_ms=path["enqueue_ms"],
        config5_device_ms=path["device_ms"], config5_device_idle_share=path["idle"],
        config5_chunk_route_frame_ms=path["chunk_frame_ms"],
        config5_chunk_route_ms=path["chunk_trace_ms"],
        config5_full_sweep_ms=sweep_ms, config5_max_abs_err=err,
        config5_plain_band_ms=plain_ms, config5_plain_band_rays=n_band * C5_RPP,
        config5_bound_ms=max(ops_ms, bytes_ms),
        config5_bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        config5_wedge_shift=setup["shift"], config5_table_bytes=setup["table_bytes"],
        config5_table_build_s=setup["build_s"], config5_gather_len=setup["gather_len"],
        config5_lady_bug_ms=lady["ms"], config5_lady_bug_wedge_shift=lady["shift"],
        config5_lady_bug_table_bytes=lady["table_bytes"],
        config5_lady_bug_bound_ms=lady["bound_ms"],
        config5_lady_bug_slots_per_ray=lady["slots_per_ray"],
        config5_cli_average_frame_ms=mean_ms,
    )


# ---------------------------------------------------------------------------
# the interactive session: world grid, checkpoints, CLI, HTTP viewer, loader
# ---------------------------------------------------------------------------

# The scripted denoised sequence: three frames at rest (the first builds the
# grid), four zoom-in ticks, four drags, two fast zoom-outs of three ticks
# (the second passes the grid's zoom_max: a rebuild), three frames at rest.
GRID_DN_EVENTS = ([None] * 3 + [("scroll", 1.0)] * 4 + [("drag", 160.0, -90.0)] * 4
                  + [("scroll", -3.0)] * 2 + [None] * 3)
# The dense sequence: two frames at rest, a zoom step, three pan steps, rest.
GRID_DENSE_EVENTS = [None, None, ("scroll", 1.0), ("drag", 220.0, -130.0),
                     ("drag", -220.0, 130.0), ("drag", 220.0, -130.0), None]
# Files the session phases write (scene XMLs, images, checkpoints): inside
# the checkout, in a directory .gitignore lists.
SMOKE_DIR = pathlib.Path(__file__).resolve().parent / "build" / "smoke"


class RebuildSession(rt.InteractiveSession):
    """The grid's comparator: a session whose every camera change rebuilds
    the camera's own tables (build_cand_tables, seg_max_count,
    narrow_cand_tables: one host sync), as a caller of render_frame does
    without the world grid."""

    def accel_tables(self):
        if self.camera != self._cand_camera:
            self._cand_camera, self._cand_tables = self.camera, None
        return super().accel_tables()


class StaleGridSession(rt.InteractiveSession):
    """The JAX session's rule: the grid serves every camera it covers, at
    any depth of zoom below the one it was built for."""

    def grid_serves(self):
        return self.grid is not None and trace_cuda.grid_covers(
            self.grid, self.scene, self.camera, self.config)


def apply_event(session, ev):
    if ev is not None:
        getattr(session, ev[0])(*ev[1:])


def check_grid_frame(label, session, frame, band=None):
    """The trace sums of the session's camera on its grid tables == the
    kernel's full sweep == the camera's own tables, bitwise: on the whole
    frame, or on ``band`` (row0, rows) starting on a tile row."""
    scene, cfg, cam, grid = session.scene, session.config, session.camera, session.grid
    w = scene.width
    px0, n_px = (0, w * scene.height) if band is None else (band[0] * w, band[1] * w)
    picked = trace_cuda.grid_tables(grid, scene, cam, cfg, px0, n_px)
    own = trace_cuda.build_cand_tables(scene, cam, cfg, px0, n_px)
    a = trace_cuda.trace_sums_flat(scene, cam, cfg, frame, px0, n_px, picked, grid.gather_len)
    b = trace_cuda.trace_sums_flat(scene, cam, cfg, frame, px0, n_px, None)
    c = trace_cuda.trace_sums_flat(scene, cam, cfg, frame, px0, n_px, own,
                                   trace_cuda.seg_max_count(scene, own))
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, c):
        require(torch.equal(x, y), f"{label}: grid tables != full sweep at {cam}")
        require(torch.equal(x, z), f"{label}: grid tables != the camera's own tables at {cam}")
    require(float(a[1].sum()) > 0.0, f"{label}: the trace has weight")


def run_checked_sequence(label, session, events, bands=None):
    """The scripted events through the session, frame by frame.  A moving
    frame that the current grid serves enqueues under the sync check (the
    event, grid_covers, grid_tables and the frame with the UNet); each
    moving frame's sums on grid tables are held bitwise against the full
    sweep and the camera's own tables (``bands``: per moving frame, None
    for the whole frame or (row0, rows)).  Returns (moving frames served by
    an existing grid, grid builds)."""
    served = 0
    moving_i = 0
    for i, ev in enumerate(events):
        torch.cuda.synchronize()
        moving = i == 0 or ev is not None
        if moving and session.grid is not None:
            torch.cuda.set_sync_debug_mode("error")
            try:
                apply_event(session, ev)
                covered = session.grid_serves()
                if covered:
                    session.render(block=False)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if covered:
                served += 1
            else:
                session.render(block=False)
        else:
            apply_event(session, ev)
            session.render(block=False)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(session.last_image).all()), f"{label}: finite frame {i}")
        if moving:
            band = None if bands is None else bands[moving_i]
            check_grid_frame(f"{label} frame {i}", session, session.state.frame - 1, band)
            moving_i += 1
    return served, session.grid_builds


def timed_sequence(session, events):
    """The events with render(block=True): per frame (kind, wall ms); kind
    "first" (frame 0), "build" (a move that built a grid), "moving",
    "settle" (the first frame at rest after a move: it builds the camera's
    own tables) or "resting" (on those tables)."""
    out = []
    for i, ev in enumerate(events):
        builds = session.grid_builds
        apply_event(session, ev)
        session.render(block=True)
        if i == 0:
            kind = "first"
        elif ev is not None:
            kind = "build" if session.grid_builds > builds else "moving"
        else:
            kind = "resting" if out[-1][0] in ("settle", "resting") else "settle"
        out.append((kind, session.frame_times[-1] * 1e3))
    return out


def grid_and_rebuild_in_turns(dscene, cfg, net, events):
    """timed_sequence of a fresh session on the world grid and of one that
    rebuilds on each move, in turns (grid, rebuild, rebuild, grid): the rows
    of each, concatenated."""
    g_rows, r_rows = [], []
    for cls in (rt.InteractiveSession, RebuildSession, RebuildSession, rt.InteractiveSession):
        rows = timed_sequence(cls(dscene, cfg, denoiser=net), events)
        (g_rows if cls is rt.InteractiveSession else r_rows).extend(rows)
    return g_rows, r_rows


def mean_of(rows, kinds):
    """Mean ms of the rows of one kind, or of any kind in a tuple."""
    kinds = (kinds,) if isinstance(kinds, str) else kinds
    xs = [ms for k, ms in rows if k in kinds]
    return sum(xs) / len(xs) if xs else float("nan")


# The dense depth sequences: at rest, k zoom-in steps in one scroll, four
# pan steps at that depth.
DEPTH_PANS = [("drag", 220.0, -130.0), ("drag", -220.0, 130.0)] * 2


def depth_sequences(dscene, cfg, net):
    """The dense frame's full moving frames at zoom-in depths 1-4: the
    session (its grid serves one zoom-in step), the JAX session's rule (the
    stale grid serves every depth) and a rebuild of the camera's tables on
    each move, each sequence timed frame by frame, in turns (A B C C B A).
    Returns {depth: {variant: mean ms of the zoom and pan frames}}."""
    out = {}
    for k in ZOOM_DEPTHS[1:]:
        events = [None, ("scroll", float(k))] + DEPTH_PANS
        rows = {"session": [], "stale_grid": [], "rebuild": []}
        builds = {}
        order = (("session", rt.InteractiveSession), ("stale_grid", StaleGridSession),
                 ("rebuild", RebuildSession))
        for name, cls in order + order[::-1]:
            sess = cls(dscene, cfg, denoiser=net)
            rows[name].append(timed_sequence(sess, events)[1:])  # the zoom, the pans
            builds[name] = sess.grid_builds
            del sess
        moves = ("moving", "build")
        means = {n: mean_of([r for t in turns for r in t], moves) for n, turns in rows.items()}
        pans = {n: mean_of([r for t in turns for r in t[1:]], moves) for n, turns in rows.items()}
        require(builds["session"] == (1 if k < 2 else 2) and builds["stale_grid"] == 1,
                f"grid:dense depth {k}: grid builds {builds}")
        phase(f"grid:dense:depth_{k}_frames", frames=len(events) - 1,
              **{f"{n}_ms": f"{v:.3f}" for n, v in means.items()},
              **{f"{n}_pan_ms": f"{v:.3f}" for n, v in pans.items()},
              session_grid_builds=builds["session"],
              faster=min(means, key=means.get))
        out[k] = means
    return out


def chained_moving_ms(session, events):
    """The events with render(block=False) and a CUDA event pair around
    each frame: (device ms, host enqueue ms) per moving frame that an
    existing grid served, chained."""
    marks = []
    for i, ev in enumerate(events):
        builds = session.grid_builds
        t0 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        apply_event(session, ev)
        session.render(block=False)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        if i > 0 and ev is not None and session.grid_builds == builds:
            marks.append((start, end, host_ms))
    torch.cuda.synchronize()
    dev = [s.elapsed_time(e) for s, e, _ in marks]
    return sum(dev) / len(dev), sum(h for _, _, h in marks) / len(marks)


def moving_step(session, dx=40.0, dy=25.0):
    """A step that drags the camera back and forth inside the grid and
    enqueues the frame: a moving frame on every call."""
    sign = [1.0]

    def step():
        session.drag(sign[0] * dx, sign[0] * dy)
        sign[0] = -sign[0]
        session.render(block=False)

    return step


def mean_count(tables):
    """Mean list length over (tile, wedge) cells: the slots each ray of a
    slot-mode cell tests."""
    return float(tables.counts.float().mean())


# Zoom-in depths of the sweep: steps past the camera that built the grid
# (depth 0: that camera, 1.5x below the grid's zoom_max).
ZOOM_DEPTHS = (0, 1, 2, 3, 4)


def zoom_depth_sweep(label, dscene, cfg, grid, reps):
    """The trace on one grid's tables as the camera zooms in past the one
    that built it (the cells keep their zoom_max size while the tiles
    shrink), against the camera's own tables rebuilt there and against a
    fresh grid built there as the session builds one.  The sums of the
    three are held bitwise equal.  Returns one dict per depth."""
    n_px = dscene.width * dscene.height
    out = []
    for k in ZOOM_DEPTHS:
        cam = rt.Camera(grid.zoom_max / ZOOM_STEP ** (k + 1))
        require(trace_cuda.grid_covers(grid, dscene, cam, cfg), f"{label}: depth {k} covered")
        picked = trace_cuda.grid_tables(grid, dscene, cam, cfg)
        gather_ms, _ = cuda_ms(lambda: trace_cuda.grid_tables(grid, dscene, cam, cfg), reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        own = rt.build_cand_tables(dscene, cam, cfg)
        own_gl = rt.seg_max_count(dscene, own)
        if own_gl is not None:
            own = trace_cuda.narrow_cand_tables(own, own_gl)
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        fresh = rt.InteractiveSession(dscene, cfg, camera=cam)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fgrid = fresh.world_grid()
        torch.cuda.synchronize()
        fresh_build_s = time.perf_counter() - t0
        fpicked = trace_cuda.grid_tables(fgrid, dscene, cam, cfg)
        runs = {}
        for name, tabs, gl in (("grid", picked, grid.gather_len), ("own", own, own_gl),
                               ("fresh", fpicked, fgrid.gather_len)):
            runs[name] = cuda_ms(lambda: trace_cuda.trace_sums_flat(
                dscene, cam, cfg, 0, 0, n_px, tabs, gl), reps, warm_up=True)
        for x, y, z in zip(runs["grid"][1], runs["own"][1], runs["fresh"][1]):
            require(torch.equal(x, y) and torch.equal(x, z),
                    f"{label}: depth {k}: grid, own and fresh-grid sums differ")
        row = dict(depth=k, zoom=cam.zoom_factor, ratio=grid.zoom_max / cam.zoom_factor,
                   gather_ms=gather_ms, trace_ms_grid=runs["grid"][0],
                   trace_ms_own=runs["own"][0], trace_ms_fresh_grid=runs["fresh"][0],
                   own_rebuild_s=rebuild_s, fresh_grid_build_s=fresh_build_s)
        if grid.tables.dist_ordered:
            for name, tabs in (("grid", picked), ("own", own), ("fresh_grid", fpicked)):
                st = trace_cuda.trace_walk_stats(dscene, cam, cfg, 0, 0, n_px, tabs)
                live = max(st["live_rays"], 1)
                row[f"slots_per_ray_{name}"] = st["list_slots"] / live
                row[f"fallback_share_{name}"] = st["fallback_rays"] / live
        else:
            for name, tabs in (("grid", picked), ("own", own), ("fresh_grid", fpicked)):
                row[f"slots_per_ray_{name}"] = mean_count(tabs)
        # what a moving frame at this depth adds to the rest of the frame
        row["stale_grid_ms"] = gather_ms + runs["grid"][0]
        row["rebuild_own_ms"] = 1e3 * rebuild_s + runs["own"][0]
        row["fresh_grid_ms"] = gather_ms + runs["fresh"][0]
        phase(f"{label}:zoom_in_{k}", **{key: (f"{v:.4f}" if isinstance(v, float) else v)
                                          for key, v in row.items()})
        out.append(row)
        del picked, own, fresh, fgrid, fpicked, runs
    return out


def grid_denoised_phase(dscene, cfg, net):
    """[grid:denoised]: the seeded scene at 1920x1088 x 8 rays per pixel
    with the shipped UNet, an InteractiveSession on the scripted sequence
    GRID_DN_EVENTS: every moving frame checked; then the same sequence timed
    on the world grid and with a rebuild of the camera's tables on each
    move, a moving frame on the card alone, and the trace on grid tables
    against the camera's own."""
    n_px = dscene.width * dscene.height
    s = rt.InteractiveSession(dscene, cfg, denoiser=net)
    t0 = time.perf_counter()
    s.render()  # the first frame builds the grid
    first_s = time.perf_counter() - t0
    grid = s.grid
    require(grid is not None and not grid.tables.dist_ordered, "denoised grid: slot mode")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = trace_cuda.build_cand_grid(dscene, cfg, grid.x0, grid.y0,
                                       grid.x0 + grid.nx * grid.pitch_x,
                                       grid.y0 + grid.ny * grid.pitch_y, grid.zoom_max)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(again.gather_len == grid.gather_len and again.nx == grid.nx,
            "denoised grid: a second build is the same grid")
    del again

    # correctness: the sequence checked frame by frame, launches counted
    s = rt.InteractiveSession(dscene, cfg, denoiser=net)
    trace_cuda.reset_launch_count()
    conv_cuda.reset_launch_count()
    served, builds = run_checked_sequence("grid:denoised", s, GRID_DN_EVENTS)
    n_moving = sum(1 for i, ev in enumerate(GRID_DN_EVENTS) if i == 0 or ev is not None)
    # a frame: one launch; each moving frame's check: three more
    want_trace = len(GRID_DN_EVENTS) + 3 * n_moving
    require(trace_cuda.LAUNCHES == want_trace,
            f"grid:denoised: trace launches {trace_cuda.LAUNCHES} != {want_trace}")
    require(conv_cuda.LAUNCHES == 9 * len(GRID_DN_EVENTS),
            f"grid:denoised: conv launches {conv_cuda.LAUNCHES}")
    # grid builds: the first frame, the second and fourth zoom-in ticks (one
    # step past the camera each grid was built for) and both zoom-outs (past
    # zoom_max); every other moving frame is served by a grid
    require(builds == 5 and served == n_moving - 5,
            f"grid:denoised: {builds} grid builds, {served} frames served by a grid")
    require(s.camera.zoom_factor > ZOOM_STEP, "the sequence left the first grid's zoom range")

    # the trace at a moved camera: grid tables against the camera's own
    cam = rt.Camera(0.444, -60.0, 35.0)
    require(trace_cuda.grid_covers(grid, dscene, cam, cfg), "the first grid covers the probe")
    picked = trace_cuda.grid_tables(grid, dscene, cam, cfg)
    own = rt.build_cand_tables(dscene, cam, cfg)
    own_gl = rt.seg_max_count(dscene, own)
    own = trace_cuda.narrow_cand_tables(own, own_gl)
    grid_trace_ms, _ = cuda_ms(lambda: trace_cuda.trace_sums_flat(
        dscene, cam, cfg, 0, 0, n_px, picked, grid.gather_len), 5, warm_up=True)
    own_trace_ms, _ = cuda_ms(lambda: trace_cuda.trace_sums_flat(
        dscene, cam, cfg, 0, 0, n_px, own, own_gl), 5, warm_up=True)
    gather_ms, _ = cuda_ms(lambda: trace_cuda.grid_tables(grid, dscene, cam, cfg), 5, warm_up=True)
    t_ops_ms, t_bytes_ms = list_bound("grid_denoised_trace_bound", dscene, cam, cfg, picked,
                                      grid_trace_ms)
    depths = zoom_depth_sweep("grid:denoised", dscene, cfg, grid, 5)

    # timed: the world grid against a rebuild on each move, frames
    # synchronized, two sequences of each in turns
    g_rows, r_rows = grid_and_rebuild_in_turns(dscene, cfg, net, GRID_DN_EVENTS)
    chained_ms, enqueue_ms = chained_moving_ms(
        rt.InteractiveSession(dscene, cfg, denoiser=net), GRID_DN_EVENTS)
    alone = rt.InteractiveSession(dscene, cfg, denoiser=net)
    alone.render()
    device_ms = device_frame_ms(moving_step(alone))
    require(alone.grid_builds == 1, "the card-alone frames stayed in the grid")
    grid_moving, rebuild_moving = mean_of(g_rows, "moving"), mean_of(r_rows, "moving")
    phase("grid:denoised", size=f"{dscene.width}x{dscene.height}", rpp=cfg.rays_per_pixel,
          frames=len(GRID_DN_EVENTS), moving_frames=n_moving, served_by_grid=served,
          grid_builds=builds, grid=f"{grid.nx}x{grid.ny}", grid_cells=grid.nx * grid.ny,
          grid_bytes=grid.nbytes, grid_build_s=f"{build_s:.4f}", first_frame_s=f"{first_s:.3f}",
          zoom_max=grid.zoom_max, gather_len=grid.gather_len, own_gather_len=own_gl,
          selected_tables_bytes=picked.nbytes, gather_ms=f"{gather_ms:.4f}",
          slots_per_ray_grid=f"{mean_count(picked):.2f}",
          slots_per_ray_own=f"{mean_count(own):.2f}",
          trace_ms_grid=f"{grid_trace_ms:.3f}", trace_ms_own=f"{own_trace_ms:.3f}",
          moving_frame_ms_grid=f"{grid_moving:.3f}",
          moving_frame_ms_rebuild=f"{rebuild_moving:.3f}",
          moves_ms_grid=f"{mean_of(g_rows, ('moving', 'build')):.3f}",
          build_frame_ms_grid=f"{mean_of(g_rows, 'build'):.3f}",
          settle_frame_ms_grid=f"{mean_of(g_rows, 'settle'):.3f}",
          resting_frame_ms_grid=f"{mean_of(g_rows, 'resting'):.3f}",
          resting_frame_ms_rebuild=f"{mean_of(r_rows, 'resting'):.3f}",
          moving_frame_chained_device_ms=f"{chained_ms:.3f}",
          moving_frame_host_enqueue_ms=f"{enqueue_ms:.3f}",
          moving_frame_device_ms_queue_full=f"{device_ms:.3f}",
          faster="grid" if mean_of(g_rows, ("moving", "build")) < rebuild_moving else "rebuild",
          sums_eq_full_and_own="bitwise", no_host_sync=True,
          trace_launches=want_trace, conv_launches=9 * len(GRID_DN_EVENTS))
    return dict(grid_denoised_trace_ms=grid_trace_ms, grid_denoised_own_trace_ms=own_trace_ms,
                grid_denoised_slots_per_ray=mean_count(picked),
                grid_denoised_own_slots_per_ray=mean_count(own),
                grid_denoised_bound_ms=max(t_ops_ms, t_bytes_ms),
                grid_denoised_moving_frame_ms=grid_moving,
                grid_denoised_rebuild_moving_frame_ms=rebuild_moving,
                grid_denoised_moving_device_ms=device_ms,
                grid_denoised_build_s=build_s, grid_denoised_bytes=grid.nbytes,
                grid_denoised_launches=want_trace,
                grid_denoised_zoom_in_trace_ms=[r["trace_ms_grid"] for r in depths])


def grid_dense_phase(net):
    """[grid:dense]: the lady_bug-class scene at 1920x1088 x 256 rays per
    pixel with the shipped UNet through an InteractiveSession: the zoom
    step checked on the whole frame, the pan steps on two tile rows each,
    the plain version on half a tile row of grid tables; then the trace on
    grid tables against the camera's own, and the sequence timed against a
    rebuild on each move."""
    dscene = rt.build_device_scene(rt.load_scene_from_string(
        dense_scene_xml(0, DN_W, DN_H, "lady_bug")))
    cfg = rt.RenderConfig(rays_per_pixel=DENSE_RPP)
    n_px = DN_W * DN_H
    band0 = DENSE_TILE_ROWS * min(16, DN_H // DENSE_TILE_ROWS - 4)
    bands = [None, None, (band0, 2 * DENSE_TILE_ROWS),
             (band0 + 2 * DENSE_TILE_ROWS, 2 * DENSE_TILE_ROWS), (band0, 2 * DENSE_TILE_ROWS)]
    s = rt.InteractiveSession(dscene, cfg, denoiser=net)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = s.world_grid()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    kind = "seg" if grid.tables.ids is not None else "chunk"
    require(grid.tables.dist_ordered, "dense grid: distance order")
    del grid
    s = rt.InteractiveSession(dscene, cfg, denoiser=net)
    served, builds = run_checked_sequence("grid:dense", s, GRID_DENSE_EVENTS, bands)
    require(builds == 1 and served == 4, f"grid:dense: {builds} builds, {served} served")

    # the plain version on half a tile row of grid tables at the panned camera
    cam = s.camera
    rows, px0 = DENSE_TILE_ROWS // 2, band0 * DN_W
    picked_band = trace_cuda.grid_tables(s.grid, dscene, cam, cfg, px0, rows * DN_W)
    kern = trace_cuda.trace_sums_flat(dscene, cam, cfg, 5, px0, rows * DN_W, picked_band)
    plain_ms, plain = cuda_ms(lambda: trace_cuda.trace_sums_plain(
        dscene, cam, cfg, 5, px0, rows * DN_W, picked_band), 1)
    err = parity(normalized(plain, rows, DN_W, cfg), normalized(kern, rows, DN_W, cfg))
    del picked_band, kern, plain

    # the trace alone at the zoomed camera: grid tables against its own
    zcam = rt.Camera(1.0 / ZOOM_STEP)
    picked = trace_cuda.grid_tables(s.grid, dscene, zcam, cfg)
    own = rt.build_cand_tables(dscene, zcam, cfg)  # the allocations, then timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    own = rt.build_cand_tables(dscene, zcam, cfg)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    grid_trace_ms, _ = cuda_ms(lambda: trace_cuda.trace_sums_flat(
        dscene, zcam, cfg, 0, 0, n_px, picked), 3, warm_up=True)
    own_trace_ms, _ = cuda_ms(lambda: trace_cuda.trace_sums_flat(
        dscene, zcam, cfg, 0, 0, n_px, own), 3, warm_up=True)
    gather_ms, _ = cuda_ms(lambda: trace_cuda.grid_tables(s.grid, dscene, zcam, cfg), 3,
                           warm_up=True)
    g_st = dense_stats("grid_lady_bug", dscene, cfg, zcam, picked, grid_trace_ms,
                       need_fallback=False)
    o_st = trace_cuda.trace_walk_stats(dscene, zcam, cfg, 0, 0, n_px, own)
    o_live = max(o_st["live_rays"], 1)
    g_full = trace_cuda.trace_walk_stats(dscene, zcam, cfg, 0, 0, n_px, picked)
    chunks_per_fb = g_full["chunks"] / max(g_full["fallback_rays"], 1)
    grid_cells, grid_ny, grid_nx, grid_bytes = (s.grid.nx * s.grid.ny, s.grid.ny, s.grid.nx,
                                                s.grid.nbytes)
    del picked, own
    depths = zoom_depth_sweep("grid:dense", dscene, cfg, s.grid, 3)
    del s

    g_rows, r_rows = grid_and_rebuild_in_turns(dscene, cfg, net, GRID_DENSE_EVENTS)
    depth_frames = depth_sequences(dscene, cfg, net)
    alone = rt.InteractiveSession(dscene, cfg, denoiser=net)
    alone.render()
    device_ms = device_frame_ms(moving_step(alone, 120.0, 70.0))
    require(alone.grid_builds == 1, "the card-alone frames stayed in the grid")
    del alone
    grid_moving, rebuild_moving = mean_of(g_rows, "moving"), mean_of(r_rows, "moving")
    phase("grid:dense", kind=kind, grid=f"{grid_nx}x{grid_ny}", grid_cells=grid_cells,
          grid_bytes=grid_bytes, grid_build_s=f"{build_s:.4f}",
          own_tables_rebuild_s=f"{rebuild_s:.4f}", gather_ms=f"{gather_ms:.3f}",
          frames=len(GRID_DENSE_EVENTS), served_by_grid=served,
          sums_eq_full_and_own="bitwise(whole frame at the zoom, bands at the pans)",
          plain_rows=rows, max_abs_err=f"{err:.3e}", plain_ms=f"{plain_ms:.1f}",
          trace_ms_grid=f"{grid_trace_ms:.3f}", trace_ms_own=f"{own_trace_ms:.3f}",
          slots_per_ray_grid=f"{g_st['slots_per_ray']:.2f}",
          slots_per_ray_own=f"{o_st['list_slots'] / o_live:.2f}",
          fallback_share_grid=f"{g_st['fallback_share']:.5f}",
          fallback_share_own=f"{o_st['fallback_rays'] / o_live:.5f}",
          chunks_per_fallback_ray_grid=f"{chunks_per_fb:.2f}",
          warp_slot_efficiency_grid=f"{g_st['warp_slot_efficiency']:.4f}",
          moving_frame_ms_grid=f"{grid_moving:.3f}",
          moving_frame_ms_rebuild=f"{rebuild_moving:.3f}",
          settle_frame_ms_grid=f"{mean_of(g_rows, 'settle'):.3f}",
          moving_frame_device_ms_queue_full=f"{device_ms:.3f}",
          faster="grid" if mean_of(g_rows, ("moving", "build")) < rebuild_moving else "rebuild")
    return dict(grid_dense_trace_ms=grid_trace_ms, grid_dense_own_trace_ms=own_trace_ms,
                grid_dense_slots_per_ray=g_st["slots_per_ray"],
                grid_dense_own_slots_per_ray=o_st["list_slots"] / o_live,
                grid_dense_fallback_share=g_st["fallback_share"],
                grid_dense_warp_slot_efficiency=g_st["warp_slot_efficiency"],
                grid_dense_bound_ms=g_st["bound_ms"], grid_dense_bound_by=g_st["bound_by"],
                grid_dense_max_abs_err=err, grid_dense_plain_ms=plain_ms,
                grid_dense_moving_frame_ms=grid_moving,
                grid_dense_rebuild_moving_frame_ms=rebuild_moving,
                grid_dense_moving_device_ms=device_ms, grid_dense_build_s=build_s,
                grid_dense_bytes=grid_bytes, grid_dense_kind=kind,
                grid_dense_zoom_in_trace_ms=[r["trace_ms_grid"] for r in depths],
                grid_dense_depth_frame_ms={k: v["session"] for k, v in depth_frames.items()})


def session_resume_phase(dscene, cfg, net):
    """[session_resume]: a session saved after five frames and loaded again;
    the next frame from both is equal bitwise (the RNG is keyed on the
    frame counter, the tables of either are conservative)."""
    s = rt.InteractiveSession(dscene, cfg, denoiser=net)
    for ev in [None, None, ("scroll", 1.0), ("drag", 60.0, -40.0), None]:
        apply_event(s, ev)
        s.render()
    path = str(SMOKE_DIR / "session.npz")
    t0 = time.perf_counter()
    rt.save_session(path, s.state, s.camera)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, cam, params = rt.load_session(path)
    load_s = time.perf_counter() - t0
    require(params is None and cam == s.camera and state.frame == s.state.frame == 5,
            "session_resume: camera and frame")
    require(torch.equal(state.prev_image, s.state.prev_image) and torch.equal(state.flow, s.state.flow),
            "session_resume: state bitwise")
    resumed = rt.InteractiveSession(dscene, cfg, camera=cam, denoiser=net)
    resumed.state = state
    a = s.render()
    b = resumed.render()
    require(torch.equal(a, b) and torch.equal(s.state.prev_image, resumed.state.prev_image),
            "session_resume: the next frame differs")
    phase("session_resume", frames_before=5, bytes=pathlib.Path(path).stat().st_size,
          save_s=f"{save_s:.3f}", load_s=f"{load_s:.3f}", next_frame="bitwise")


def run_cli(label, xml, rpp, args):
    """``python3 -m raytracingdiffusioncurves_torch`` on a generated scene,
    as a subprocess; returns (printed mean frame ms, stats JSON lines, the
    image)."""
    from PIL import Image

    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    xml_path, png = SMOKE_DIR / f"{label}.xml", SMOKE_DIR / f"{label}.png"
    xml_path.write_text(xml)
    cmd = [sys.executable, "-m", "raytracingdiffusioncurves_torch", str(xml_path), str(rpp),
           *args, "--stats", "--out", str(png)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=pathlib.Path(__file__).resolve().parent)
    wall_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"cli {label}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.replace("\r", "\n").splitlines()
    setup = next(ln for ln in lines if ln.startswith("Setup took : "))
    mean = next(ln for ln in lines if ln.startswith("Average frame time : "))
    phases = json.loads(next(ln for ln in lines if ln.startswith('{"scene_load"')))
    metrics = json.loads(next(ln for ln in lines if ln.startswith('{"counters"')))
    require(lines[-1] == f"wrote {png}", f"cli {label}: last line {lines[-1]!r}")
    img = Image.open(png)
    return (float(mean.split(":")[1].strip()[:-2]), float(setup.split(":")[1].strip()[:-2]),
            phases, metrics, img, wall_s)


def cli_phase():
    """[cli]: the CLI as a user runs it, in a subprocess on the card: the
    seeded scene at 1024^2 x 128 rays per pixel without the denoiser (11
    frames: one of setup, ten timed), and at 1920x1088 x 8 rays per pixel
    with the shipped weights (the default)."""
    out = {}
    for label, (w, h), rpp, args in (
        ("cli_1024", (SIZE, SIZE), RPP, ["--no-denoiser", "--frames", "11"]),
        ("cli_denoised", (DN_W, DN_H), DN_RPP, ["--frames", "11"]),
    ):
        mean_ms, setup_ms, phases, metrics, img, wall_s = run_cli(
            label, seeded_scene_xml(0, w, h), rpp, args)
        require(img.size == (w, h) and img.mode == "RGBA", f"cli {label}: image {img.size}")
        require(phases["frame"]["count"] == 10 and metrics["counters"]["frames"] == 10,
                f"cli {label}: frames")
        weights = "none" if "--no-denoiser" in args else pathlib.Path(shipped_weights()).name
        phase(f"cli:{label}", size=f"{w}x{h}", rpp=rpp, weights=weights,
              average_frame_time_ms=f"{mean_ms:.2f}",
              setup_ms=f"{setup_ms:.1f}", wall_s=f"{wall_s:.2f}", phases=json.dumps(phases),
              metrics=json.dumps(metrics))
        out[label] = mean_ms
    return out


def http_viewer_phase(dscene, cfg, net):
    """[http_viewer]: HttpViewer on port 0 over the denoised session: five
    frames read from /stream, a scroll and a drag posted, a new frame that
    differs and a moved camera required.  The server stops in a finally and
    its threads are joined with a timeout."""
    import urllib.request

    from raytracingdiffusioncurves_torch.viewer_http import HttpViewer

    s = rt.InteractiveSession(dscene, cfg, denoiser=net)
    v = HttpViewer(s, port=0).start()
    try:
        base = f"http://127.0.0.1:{v.port}"
        first = v.wait_frame(timeout=120)
        with urllib.request.urlopen(base + "/stream", timeout=60) as r:
            raw, t0 = b"", time.perf_counter()
            while raw.count(b"--frame") < 6:  # five whole parts after the first boundary
                chunk = r.read(1 << 16)
                require(len(chunk) > 0, "http_viewer: the stream ended")
                raw += chunk
            stream_s = time.perf_counter() - t0
        cam0, f0 = s.camera, v.frames
        before, _ = v.wait_frame(after=f0 - 1, timeout=60)
        for ev in ({"type": "scroll", "y": 1.0}, {"type": "drag", "dx": 40.0, "dy": -25.0}):
            req = urllib.request.Request(base + "/event", data=json.dumps(ev).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                require(r.status == 204, "http_viewer: event accepted")
        after, _ = v.wait_frame(after=f0 + 3, timeout=60)
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        require(after != before and after[:2] == b"\xff\xd8", "http_viewer: a new frame differs")
        require(s.camera != cam0 and stats["zoom"] < cam0.zoom_factor,
                "http_viewer: the session's camera moved")
        later = sorted(v.loop_times[1:])  # the first pass builds the grid
        require(len(later) > 0, "http_viewer: render-loop passes")
        loop_ms = 1e3 * later[len(later) // 2]
        phase("http_viewer", size=f"{dscene.width}x{dscene.height}", first_jpeg_bytes=len(first),
              stream_fps=f"{5 / stream_s:.2f}", render_loop_median_ms=f"{loop_ms:.3f}",
              first_pass_ms=f"{1e3 * v.loop_times[0]:.1f}",
              frames=v.frames, loop_passes=len(v.loop_times), zoom=f"{stats['zoom']:.4f}",
              grid_builds=s.grid_builds)
    finally:
        v.stop()
    require(not any(t.is_alive() for t in v._threads), "http_viewer: threads stopped")
    return 5 / stream_s, loop_ms


def best_of(n, fn):
    """(fewest seconds of n calls of fn() on the host clock, the last result)."""
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def native_loader_phase():
    """[native_loader]: the port's C++ loader (built with g++ here) against
    the Python loader, bitwise, on the dense and the seeded scene."""
    from raytracingdiffusioncurves_torch.scene import native_loader, xml_loader

    t0 = time.perf_counter()
    require(native_loader.available(), "native loader builds")
    build_s = time.perf_counter() - t0
    times = {}
    for label, xml in (("lady_bug", dense_scene_xml(0, DN_W, DN_H, "lady_bug")),
                       ("seeded", seeded_scene_xml(0, SIZE, SIZE))):
        py_s, py = best_of(3, lambda: xml_loader.load_scene_from_string(xml))
        nat_s, nat = best_of(3, lambda: native_loader.load_scene_native(xml, is_text=True))
        for name in ("vertices", "curve_map", "curve_index", "curve_connect",
                     "curve_first_segment", "curve_segment_count"):
            a, b = getattr(py, name), getattr(nat, name)
            require(a.dtype == b.dtype and a.tobytes() == b.tobytes(), f"native {label}: {name}")
        for name in ("color_left", "color_right", "blur", "weight", "weight_degree"):
            for f in ("index", "u", "values"):
                a, b = getattr(getattr(py, name), f), getattr(getattr(nat, name), f)
                require(a.dtype == b.dtype and a.tobytes() == b.tobytes(),
                        f"native {label}: {name}.{f}")
        times[label] = (py_s, nat_s)
        phase(f"native_loader:{label}", segments=py.n_segments, python_s_best_of_3=f"{py_s:.5f}",
              native_s_best_of_3=f"{nat_s:.5f}", tables="bitwise")
    phase("native_loader", build_s=f"{build_s:.2f}", scenes=len(times), tables="bitwise")


def session_phases():
    """The interactive session's phases; returns the trace kernel's grid_*
    numbers for the kernels JSON."""
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    net = rt.net_for_params(rt.load_params(str(WEIGHTS)))
    dscene = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, DN_W, DN_H)))
    cfg = rt.RenderConfig(rays_per_pixel=DN_RPP)
    out = grid_denoised_phase(dscene, cfg, net)
    session_resume_phase(dscene, cfg, net)
    fps, loop_ms = http_viewer_phase(dscene, cfg, net)
    del dscene
    out |= grid_dense_phase(net)
    native_loader_phase()
    cli = cli_phase()
    out.update(session_cli_1024_frame_ms=cli["cli_1024"],
               session_cli_denoised_frame_ms=cli["cli_denoised"],
               session_http_stream_fps=fps, session_http_render_loop_ms=loop_ms)
    return out


# ---------------------------------------------------------------------------
# the denoiser trainer
# ---------------------------------------------------------------------------

# The trainer's data: three generated scenes at the JAX trainer's size, one
# camera per noise level each, 256 rays per pixel for the targets; a held-out
# scene for validation.  Training at the JAX defaults (train_denoiser.train)
# on the shipped UNet's architecture.
TRAIN_SIZE, TRAIN_CAMS, TRAIN_VAL_CAMS = 192, 5, 3
TRAIN_BATCH, TRAIN_CROP, TRAIN_LR, TRAIN_BASE = 32, 64, 2e-3, 24
TRAIN_STEPS, FIXED_STEPS, TIMED_STEPS = 300, 30, 20
TRAIN_DIR = SMOKE_DIR / "train"


def train_gen_phase():
    """[train:gen] and [train:gen_parity]: the dataset through
    train_denoiser.generate on the card (three trace launches per example),
    read back; the trace kernel against its plain version at the trainer's
    launch shapes.  Returns (dataset path, validation path, numbers)."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)  # generate resumes from shards
    TRAIN_DIR.mkdir(parents=True)
    s = TRAIN_SIZE
    xmls = {"seeded1": seeded_scene_xml(1, s, s), "seeded2": seeded_scene_xml(2, s, s),
            "lady_bug": dense_scene_xml(0, s, s, "lady_bug"), "val_seeded3": seeded_scene_xml(3, s, s)}
    paths = {}
    for name, xml in xmls.items():
        paths[name] = TRAIN_DIR / f"{name}.xml"
        paths[name].write_text(xml)
    scenes = [str(paths[n]) for n in ("seeded1", "seeded2", "lady_bug")]
    data, val = str(TRAIN_DIR / "data.npz"), str(TRAIN_DIR / "val.npz")
    n_ex = len(scenes) * TRAIN_CAMS
    trace_cuda.reset_launch_count()
    t0 = time.perf_counter()
    train_denoiser.generate(scenes, data, size=s, cams_per_scene=TRAIN_CAMS, seed=0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = trace_cuda.LAUNCHES
    require(launches == 3 * n_ex, f"train:gen: trace launches {launches} != {3 * n_ex}")
    train_denoiser.generate([str(paths["val_seeded3"])], val, size=s,
                            cams_per_scene=TRAIN_VAL_CAMS, seed=1)
    with np.load(data) as z, np.load(val) as zv:
        for k, c in (("noisy", 3), ("warped_prev", 3), ("aux", 2), ("target", 3)):
            require(z[k].shape == (n_ex, s, s, c) and z[k].dtype == np.float16
                    and zv[k].shape == (TRAIN_VAL_CAMS, s, s, c), f"train:gen: {k} {z[k].shape}")
            require(bool(np.isfinite(z[k]).all()), f"train:gen: finite {k}")
        spread = float(z["target"].astype(np.float32).std())
        require(spread > 0.01, f"train:gen: targets spread {spread}")
        noise = sorted(set(np.round(z["aux"][:, 0, 0, 1].astype(np.float64), 3).tolist()))
    phase("train:gen", scenes=len(scenes), examples=n_ex, size=f"{s}x{s}",
          rpp_levels=list(train_denoiser.RPP_LEVELS), rpp_target=256, trace_launches=launches,
          seconds=f"{gen_s:.3f}", s_per_example=f"{gen_s / n_ex:.4f}",
          val_examples=TRAIN_VAL_CAMS, noise_channel=noise, dtype="float16",
          target_std=f"{spread:.4f}")

    # the trace kernel as generate launches it: whole 192^2 frame, the
    # in-frame tables, the first camera of the first scene
    errs = []
    for name, rpp in (("seeded1", 4), ("seeded1", 256), ("lady_bug", 16)):
        dev = rt.build_device_scene(rt.load_scene(str(paths[name])).with_size(s, s),
                                    flatten_subdivisions=8)
        rng = np.random.default_rng([0, 0, 0])
        zoom = float(np.exp(rng.uniform(np.log(0.3), np.log(2.0))))
        off = rng.uniform(-100, 100, 2)
        cam = rt.Camera(zoom, float(off[0]), float(off[1]))
        cfg = rt.RenderConfig(rays_per_pixel=rpp, use_blur=False, use_denoiser=False, seed=0)
        tables = rt.build_cand_tables(dev, cam, cfg)
        kern = trace_cuda.trace_sums_flat(dev, cam, cfg, 0, 0, s * s, tables)
        full = trace_cuda.trace_sums_flat(dev, cam, cfg, 0, 0, s * s, None)
        torch.cuda.synchronize()
        for a, b in zip(kern, full):
            require(torch.equal(a, b), f"train:gen_parity {name}: kernel with lists != full sweep")
        plain = trace_cuda.trace_sums_plain(dev, cam, cfg, 0, 0, s * s, tables)
        err = parity(normalized(plain, s, s, cfg), normalized(kern, s, s, cfg))
        require(float(kern[1].sum()) > 0.0, f"train:gen_parity {name}: the trace has weight")
        errs.append(err)
        phase(f"train:gen_parity:{name}_rpp{rpp}", rays=s * s * rpp,
              kind=trace_cuda.accel_kind(dev, cfg), max_abs_err=f"{err:.3e}",
              lists_eq_full="bitwise")
    return data, val, dict(train_gen_launches=launches, train_gen_s_per_example=gen_s / n_ex,
                           train_gen_max_abs_err=max(errs))


def unet_train_conv_parity(net):
    """[train:conv]: conv3x3_train (the train step's convolution, F.conv2d)
    against conv3x3_plain image by image, on the UNet's nine layers at the
    crop size and batch, seeded inputs, under the conv bar.  ``net``: the
    shipped UNet (the training architecture), whose biases give the bar its
    |b| term as in [conv_parity]; a fresh model's zero biases leave no room
    for a float32 sum taken in another order where y is near 0."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    rows = []
    for name, h, w, cins, cout, stride, relu, ups in unet_layers(TRAIN_CROP, TRAIN_CROP, TRAIN_BASE):
        layer = getattr(net, name)
        ks = [k.contiguous() for k in torch.split(layer.kernel.detach().to(bf), cins, dim=2)]
        b = layer.bias.detach().to(bf)
        xs = [torch.randn((TRAIN_BATCH, h >> int(u), w >> int(u), c), generator=gen,
                          device="cuda").to(bf) for c, u in zip(cins, ups)]
        with torch.no_grad():
            got = denoiser.conv3x3_train(xs, ks, b, stride, relu, ups)
            ref = torch.stack([conv_cuda.conv3x3_plain([x[i] for x in xs], ks, b, stride, relu, ups)
                               for i in range(TRAIN_BATCH)])
        require(got.shape == ref.shape, f"train:conv {name}: shape {tuple(got.shape)}")
        rows.append((name,) + conv_close(ref, got, b))
    phase("train:conv", layers=len(rows), batch=TRAIN_BATCH, size=f"{TRAIN_CROP}x{TRAIN_CROP}",
          min_bitwise_equal=f"{min(r[1] for r in rows):.6f}",
          max_share_of_rounding_bar=f"{max(r[2] for r in rows):.3f}",
          bar="equal>=0.99,diff<=2^-7*(2|y|+|b|)")


def train_step_profile(model, opt, sched, batch, step_ms):
    """Kernels per train step and the card's busy time in it, from
    torch.profiler over three steps ("not measured" where the trace shows
    no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            denoiser.train_step(model, opt, sched, batch)
        torch.cuda.synchronize()
    # the kernels' own rows (the operators' rows repeat their kernels' time)
    events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
              and getattr(e, "self_device_time_total", 0) > 0]
    if not events:
        return {"kernels_per_step": "not measured", "device_busy_ms_per_step": "not measured"}
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / 3
    return {"kernels_per_step": sum(e.count for e in events) / 3,
            "device_busy_ms_per_step": busy_ms, "device_busy_share": busy_ms / step_ms}


def train_phases():
    """[train:gen], [train:gen_parity], [train:step], [train:conv],
    [train:fit], [train:checkpoint].  Returns the numbers for the kernels
    JSON: (trace entry additions, conv entry additions)."""
    data, val, trace_out = train_gen_phase()

    # --- the train step at the shipped width, on one fixed batch ---
    arrays = dict(np.load(data))
    batch = train_denoiser._crop_batch(arrays, np.random.default_rng(0), TRAIN_BATCH, TRAIN_CROP)
    np.savez(TRAIN_DIR / "batch.npz", **{k: v.cpu().numpy() for k, v in batch.items()})
    model, sched, opt = denoiser.create_train_state(
        torch.Generator().manual_seed(0), TRAIN_CROP, TRAIN_CROP, TRAIN_LR, arch="unet",
        base=TRAIN_BASE)
    unet_train_conv_parity(rt.net_for_params(rt.load_params(str(WEIGHTS))))
    with torch.no_grad():
        first = float(denoiser.loss_fn(model, batch))
    trace_cuda.reset_launch_count()
    conv_cuda.reset_launch_count()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(FIXED_STEPS):
        loss = denoiser.train_step(model, opt, sched, batch)
    last = float(loss)
    require(last < 0.7 * first, f"train:step: loss {last} not under 0.7x the first {first}")
    require(trace_cuda.LAUNCHES == 0 and conv_cuda.LAUNCHES == 0,
            "train:step: the train step launches no kernel of the repo (F.conv2d)")
    step_ms, _ = cuda_ms(lambda: denoiser.train_step(model, opt, sched, batch), TIMED_STEPS)
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        denoiser.train_step(model, opt, sched, batch)
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    torch.cuda.synchronize()
    prof = train_step_profile(model, opt, sched, batch, step_ms)
    phase("train:step", arch="unet", base=TRAIN_BASE, batch=TRAIN_BATCH, crop=TRAIN_CROP,
          lr=TRAIN_LR, params=sum(p.numel() for p in model.parameters()),
          first_loss=f"{first:.5f}", loss_after_30=f"{last:.5f}", ratio=f"{last / first:.4f}",
          bar="<0.7", ms_per_step=f"{step_ms:.3f}", host_enqueue_ms_per_step=f"{enqueue_ms:.3f}",
          peak_mem_mb=f"{torch.cuda.max_memory_allocated() / 2**20:.1f}", **prof)
    del model, opt, sched

    # --- train() on the dataset: crops, EMA, validation through the kernel ---
    ckpt = str(TRAIN_DIR / "denoiser.msgpack")
    conv_cuda.reset_launch_count()
    t0 = time.perf_counter()
    res = train_denoiser.train(data, val, ckpt, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                               crop=TRAIN_CROP, lr=TRAIN_LR, seed=0, arch="unet",
                               base=TRAIN_BASE)
    fit_s = time.perf_counter() - t0
    n_val = 1 + TRAIN_STEPS // 250 + (1 if (TRAIN_STEPS - 1) % 250 else 0)
    want_convs = 9 * TRAIN_VAL_CAMS * 2 * n_val
    val_launches = conv_cuda.LAUNCHES
    require(val_launches == want_convs,
            f"train:fit: validation conv launches {val_launches} != {want_convs}")
    require(np.isfinite(res["loss"]) and np.isfinite(res["best_val_psnr"]), f"train:fit {res}")
    phase("train:fit", steps=TRAIN_STEPS, seconds=f"{fit_s:.2f}",
          ms_per_step=f"{res['ms_per_step']:.3f}", loss=f"{res['loss']:.5f}",
          best_val_psnr=f"{res['best_val_psnr']:.3f}", noisy_psnr=f"{res['noisy_psnr']:.3f}",
          validations=n_val, val_conv_launches=val_launches)

    # --- the trained checkpoint through the inference module on the
    # 1920x1088 denoised frame: kernel route vs plain route ---
    params = rt.load_params(ckpt)
    net = rt.net_for_params(params)
    require(isinstance(net, rt.UNetDenoiser) and net.base == TRAIN_BASE, "trained UNet, base 24")
    dscene = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, DN_W, DN_H)))
    cfg = rt.RenderConfig(rays_per_pixel=DN_RPP)
    prev, _ = rt.trace_image(dscene, rt.Camera(), cfg, 0)
    raw, bmap = rt.trace_image(dscene, rt.Camera(), cfg, 1)
    args = (net, raw, prev, bmap, 1.0, denoiser.noise_level(DN_RPP), 1)
    conv_cuda.reset_launch_count()
    a = denoiser._apply_denoiser(*args, conv_cuda.conv3x3)
    require(conv_cuda.LAUNCHES == 9, f"train:checkpoint: conv launches {conv_cuda.LAUNCHES}")
    b = denoiser._apply_denoiser(*args, conv_cuda.conv3x3_plain)
    d = (a - b).abs()
    dmax, dmean, dbig = float(d.max()), float(d.mean()), float((d > 5e-3).float().mean())
    require(bool(torch.isfinite(a).all()) and dmax < 1e-2 and dbig < 1e-4 and dmean < 1e-4,
            f"trained checkpoint, kernel route vs plain route: max {dmax} mean {dmean} "
            f"share above 5e-3 {dbig}")
    phase("train:checkpoint", path=pathlib.Path(ckpt).name, bytes=pathlib.Path(ckpt).stat().st_size,
          size=f"{DN_W}x{DN_H}", max_abs_diff=f"{dmax:.3e}", mean_abs_diff=f"{dmean:.3e}",
          share_above_5e3=f"{dbig:.3e}", bar="max<1e-2,share(>5e-3)<1e-4,mean<1e-4")
    conv_out = dict(train_step_ms=step_ms, train_fit_ms_per_step=res["ms_per_step"],
                    train_val_launches=val_launches, train_checkpoint_max_abs_diff=dmax,
                    train_val_psnr=res["best_val_psnr"], train_noisy_psnr=res["noisy_psnr"])
    return trace_out, conv_out


# ---------------------------------------------------------------------------
# row-band rendering on two ranks
# ---------------------------------------------------------------------------

SHARDED_RANKS, SHARDED_FRAMES = 2, 5
TAIL_REPS = 5  # timed calls of a tail, each rank in its turn
C5_SHARDED_FRAMES = 2  # config-5 frames of the two ranks, checked, then timed


def main_path_config():
    return rt.RenderConfig(rays_per_pixel=RPP, rays_per_block=2048, use_aa=True,
                           use_blur=True, exact_silhouettes=True, use_denoiser=False)


def exchange_summary(log):
    """(rows of the largest band + halo region a stage read, bytes of the
    edge-strip exchanges, whole-frame gathers) of one frame's
    sharded.EXCHANGE_LOG."""
    halo = [e for e in log if e[0] == "halo"]
    return (max((rows for _, _, rows in halo), default=0), sum(b for _, b, _ in halo),
            sum(1 for e in log if e[0] == "gather"))


def logged_frame(sharded, frame_fn):
    """frame_fn() (a frame function, which clears the exchange log first)
    with the log copied after it (before any gather for display): (its
    result, the log)."""
    res = frame_fn()
    return res, list(sharded.EXCHANGE_LOG)


def tail_in_turns(mesh, image, blur_map, state, cfg, scene, net):
    """[sharded:tail] on one rank: the band's post-processing
    (renderer._postprocess with sharded.band_hooks) once with its halo
    exchanges recorded, then timed with the exchanges replayed, each rank
    in its turn while the other waits at a barrier, so the two processes do
    not share the card while one is timed: chained (CUDA events over TAIL_REPS calls: the host
    enqueues ~400 small launches per tail, so this reads the host as much
    as the card) and on the card alone (device_frame_ms: behind a sleep).
    The collectives themselves are not in the time.  Returns (chained ms,
    card-alone ms, rows of each band + halo region)."""
    from raytracingdiffusioncurves_torch.parallel import sharded

    regions = []
    hooks = sharded.band_hooks(mesh)

    def record(bands, halo, align=1):
        regions.append(hooks["exchange"](bands, halo, align))
        return regions[-1]

    renderer._postprocess(image, blur_map, state, cfg, scene, None, net, exchange=record,
                          warp=hooks["warp"])

    def replay():
        it = iter(regions)
        return renderer._postprocess(image, blur_map, state, cfg, scene, None, net,
                                     exchange=lambda *_: next(it), warp=hooks["warp"])

    ms = device_ms = None
    for turn in range(mesh.size()):
        torch.cuda.synchronize()
        torch.distributed.barrier()
        if turn == mesh.get_local_rank():
            ms, _ = cuda_ms(replay, TAIL_REPS, warm_up=True)
            device_ms = device_frame_ms(replay)
    torch.distributed.barrier()
    return ms, device_ms, [r[0].shape[0] for r, _, _ in regions]


def sharded_denoised(mesh, net):
    """[sharded:warp] and the denoised half of [sharded:tail] on one rank:
    the seeded 1920x1088 x 8 rpp frame with the shipped UNet, frames 0 and
    1 at rest from the band's state, the tail of frame 2 in turns, then a
    zoom step (per-band tables of the new camera, a non-zero flow: the
    history gathered and warped)."""
    from raytracingdiffusioncurves_torch.parallel import sharded

    dscene = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, DN_W, DN_H)))
    cfg = rt.RenderConfig(rays_per_pixel=DN_RPP)
    cam = rt.Camera()
    tables = sharded.build_cand_tables_sharded(mesh, dscene, cam, cfg)
    gl = sharded.seg_max_count_sharded(mesh, dscene, tables)
    st = sharded.frame_state_sharded(mesh, rt.init_frame_state(DN_W, DN_H))
    for _ in range(2):
        (img, st), rest_log = logged_frame(sharded, lambda: sharded.render_frame_sharded(
            mesh, dscene, cam, st, cfg, denoiser=net, cand_tables=tables, gather_len=gl))
    rest = img.cpu().numpy()
    image, bmap = sharded.trace_image_sharded(mesh, dscene, cam, cfg, st.frame, tables, gl)
    tail = tail_in_turns(mesh, image, bmap, st, cfg, dscene, net)
    zcam = rt.Camera(zoom_factor=0.9)
    ztables = sharded.build_cand_tables_sharded(mesh, dscene, zcam, cfg)
    zgl = sharded.seg_max_count_sharded(mesh, dscene, ztables)
    moved = dataclasses.replace(st, flow=sharded.add_zoom_flow_sharded(mesh, st.flow, 1.0, 0.9))
    require(not moved.flow_is_zero, "sharded: the zoom flow is non-zero")
    trace_cuda.reset_launch_count()
    conv_cuda.reset_launch_count()
    (img, st), zoom_log = logged_frame(sharded, lambda: sharded.render_frame_sharded(
        mesh, dscene, zcam, moved, cfg, denoiser=net, cand_tables=ztables, gather_len=zgl))
    torch.cuda.synchronize()
    return dict(rest=rest, rest_log=rest_log, zoom=img.cpu().numpy(), zoom_log=zoom_log,
                prev=st.prev_image.cpu().numpy(), frame=st.frame, flow_zero=st.flow_is_zero,
                launches=(trace_cuda.LAUNCHES, conv_cuda.LAUNCHES), tail=tail)


def sharded_dense(mesh, net):
    """[sharded:dense] and the dense half of [sharded:tail] on one rank: the
    dense frame with the shipped UNet from the band's first state, then the
    tail of that frame in turns."""
    from raytracingdiffusioncurves_torch.parallel import sharded

    cam = rt.Camera()
    dense = rt.build_device_scene(rt.load_scene_from_string(dense_scene_xml(0, DN_W, DN_H, "lady_bug")))
    dcfg = rt.RenderConfig(rays_per_pixel=DENSE_RPP)
    dtables = sharded.build_cand_tables_sharded(mesh, dense, cam, dcfg)
    st = sharded.frame_state_sharded(mesh, rt.init_frame_state(DN_W, DN_H))
    trace_cuda.reset_launch_count()
    conv_cuda.reset_launch_count()
    (img, _), log = logged_frame(sharded, lambda: sharded.render_frame_sharded(
        mesh, dense, cam, st, dcfg, denoiser=net, cand_tables=dtables))
    out = dict(image=img.cpu().numpy(), launches=trace_cuda.LAUNCHES,
               conv_launches=conv_cuda.LAUNCHES, log=log)
    image, bmap = sharded.trace_image_sharded(mesh, dense, cam, dcfg, 0, dtables)
    out["tail"] = tail_in_turns(mesh, image, bmap, st, dcfg, dense, net)
    return out


def sharded_config5(mesh):
    """[sharded:config5] on one rank: BASELINE config 5 through
    render_frame_sharded, as run_all.py's config5 runs it: per-band tables
    (the frame's wedge shift), narrowed by seg_max_count_sharded; frames 0
    and 1 gathered (rank 0 keeps them), then C5_SHARDED_FRAMES timed."""
    from raytracingdiffusioncurves_torch.parallel import sharded

    cam = rt.Camera()
    scene = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, C5_W, C5_H)))
    cfg = config5_config()
    tables = sharded.build_cand_tables_sharded(mesh, scene, cam, cfg)
    gl = sharded.seg_max_count_sharded(mesh, scene, tables)
    tables = trace_cuda.narrow_cand_tables(tables, gl)
    n_wedges = trace_cuda._grid_geom(scene, cfg, C5_W, C5_W * C5_H)[3]
    holder = {"state": sharded.frame_state_sharded(mesh, rt.init_frame_state(C5_W, C5_H))}

    def step():
        holder["img"], holder["state"] = sharded.render_frame_sharded(
            mesh, scene, cam, holder["state"], cfg, cand_tables=tables, gather_len=gl)

    trace_cuda.reset_launch_count()
    frames, logs = [], []
    for _ in range(2):
        _, log = logged_frame(sharded, step)
        logs.append(log)
        whole = sharded.gather_rows(mesh, holder["img"])
        frames.append(whole.cpu().numpy() if mesh.get_local_rank() == 0 else None)
        del whole
    launches = trace_cuda.LAUNCHES
    frame_ms, _ = timed_frames(step, C5_SHARDED_FRAMES)
    return dict(frames=frames, logs=logs, launches=launches, frame_ms=frame_ms, gather_len=gl,
                shift=trace_cuda.table_wedge_shift(tables, n_wedges))


def sharded_rank(rank, world):
    """One gloo rank on cuda:0 (the [sharded:*] phases): the denoiser-off
    frame with per-band tables, a progressive pass, the denoised frame with
    a zoom step, the dense frame, the tails in turns, config 5, the
    data-parallel train step.  Returns host copies of its bands and
    numbers."""
    from raytracingdiffusioncurves_torch.parallel import sharded

    torch.cuda.set_device(0)
    mesh = sharded.make_mesh(world)
    out = {}
    cam = rt.Camera()
    # gloo on CUDA tensors: the collectives the sharded path uses
    probe = torch.full((4,), float(rank), device="cuda")
    gathered = sharded.gather_rows(mesh, probe)
    count = torch.tensor([rank + 3], dtype=torch.int64, device="cuda")
    torch.distributed.all_reduce(count, op=torch.distributed.ReduceOp.MAX)
    require(gathered.device.type == "cuda" and gathered.tolist() == [0.0] * 4 + [1.0] * 4
            and int(count) == world + 2, "gloo collectives on CUDA tensors")

    dscene = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, SIZE, SIZE)))
    cfg = main_path_config()
    tables = sharded.build_cand_tables_sharded(mesh, dscene, cam, cfg)
    gl = sharded.seg_max_count_sharded(mesh, dscene, tables)
    tables = trace_cuda.narrow_cand_tables(tables, gl)
    state = sharded.frame_state_sharded(mesh, rt.init_frame_state(SIZE, SIZE))
    trace_cuda.reset_launch_count()
    frames, logs = [], []
    for _ in range(2):
        (img, state), log = logged_frame(sharded, lambda: sharded.render_frame_sharded(
            mesh, dscene, cam, state, cfg, cand_tables=tables, gather_len=gl))
        frames.append(img.cpu().numpy())
        logs.append(log)
    launches = trace_cuda.LAUNCHES
    holder = {"state": state}

    def step():
        _, holder["state"] = sharded.render_frame_sharded(mesh, dscene, cam, holder["state"], cfg,
                                                          cand_tables=tables, gather_len=gl)

    frame_ms, _ = timed_frames(step, SHARDED_FRAMES)
    out["off"] = dict(frames=frames, launches=launches, gather_len=gl, frame_ms=frame_ms,
                      logs=logs)

    pstate = sharded.frame_state_sharded(mesh, rt.init_frame_state(SIZE, SIZE))
    prog = rt.init_progressive_state(SIZE, SIZE // world)
    passes, plogs = [], []
    for reset in (True, False):
        (img, pstate, prog), log = logged_frame(sharded, lambda: sharded.render_frame_progressive_sharded(
            mesh, dscene, cam, pstate, prog, cfg, reset, cand_tables=tables, gather_len=gl))
        passes.append(img.cpu().numpy())
        plogs.append(log)
    out["progressive"], out["progressive_logs"] = passes, plogs
    del dscene, tables

    net = rt.net_for_params(rt.load_params(str(WEIGHTS)))
    out["denoised"] = sharded_denoised(mesh, net)
    out["dense"] = sharded_dense(mesh, net)
    torch.cuda.empty_cache()
    out["config5"] = sharded_config5(mesh)
    torch.cuda.empty_cache()

    z = np.load(TRAIN_DIR / "batch.npz")
    half = TRAIN_BATCH // world
    batch = {k: torch.from_numpy(z[k][rank * half : (rank + 1) * half]).cuda() for k in z.files}
    model, sched, opt = denoiser.create_train_state(
        torch.Generator().manual_seed(0), TRAIN_CROP, TRAIN_CROP, TRAIN_LR, arch="unet",
        base=TRAIN_BASE)
    loss = denoiser.train_step(model, opt, sched, batch, group=sharded.group(mesh))
    out["train"] = dict(loss=float(loss), grads={n: p.grad.cpu().numpy()
                                                for n, p in model.named_parameters()})
    return out


def require_band_reads(label, ranks, logs_key, band_rows, halo, get=lambda res, k: res[k]):
    """Every frame of each rank read only band + halo rows (its largest
    region at most band_rows + 2 x halo) and moved no whole-frame
    collective; returns (rows_processed per rank, halo bytes per frame)."""
    rows, halo_bytes = [], set()
    for r, res in enumerate(ranks):
        sums = [exchange_summary(log) for log in get(res, logs_key)]
        require(all(g == 0 for _, _, g in sums), f"{label}: rank {r} gathered a whole frame")
        most = max(n for n, _, _ in sums)
        require(0 < most <= band_rows + 2 * halo,
                f"{label}: rank {r} read {most} rows, band {band_rows} + halo {halo} x 2")
        rows.append(most)
        halo_bytes.update(b for _, b, _ in sums)
    return rows, sorted(halo_bytes)


def band_slice_warp(image, flow_field, r0, rows):
    """The band's slice of warp_separable's row product alone (the route
    parallel/sharded.py does not take): the column product of the whole
    history, then the row product for rows r0 .. r0 + rows only."""
    h, w = image.shape[0], image.shape[1]
    cols = torch.arange(w, dtype=torch.float32, device=image.device) + flow_field[0, :, 0]
    src = torch.arange(h, dtype=torch.float32, device=image.device) + flow_field[:, 0, 1]
    mx = flow._resample_matrix(cols, w)
    my = flow._resample_matrix(src[r0 : r0 + rows], h)
    return torch.einsum("hvc,hu->uvc", torch.einsum("hwc,wv->hvc", image, mx), my)


def sharded_phases(smi, config5_frames):
    """[sharded:*]: two gloo ranks on one card against one process: the
    denoiser-off frame (1024^2 x 128 rpp, per-band tables), a progressive
    pass, the denoised frame's zoom step and the dense frame with the
    shipped UNet, config 5, all bitwise, each rank's post-processing read
    from its band and halo alone; the tails timed in turns; the
    data-parallel train step (2 x 16) against the one-process step on the
    32.  Two ranks share one card here: their times are no scaling figure."""
    from raytracingdiffusioncurves_torch.parallel import sharded

    t0 = time.perf_counter()
    ranks = sharded.spawn_ranks(sharded_rank, SHARDED_RANKS, backend="gloo", timeout=600.0)
    ranks_s = time.perf_counter() - t0
    phase("sharded:gloo_cuda", ranks=SHARDED_RANKS, device="cuda:0", backend="gloo",
          all_gather="cuda tensors", all_reduce="cuda tensors", copies="none",
          seconds=f"{ranks_s:.2f}")
    half = SIZE // SHARDED_RANKS

    # one process, the same frames
    dscene = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, SIZE, SIZE)))
    cfg = main_path_config()
    cam = rt.Camera()
    radius = blur.blur_radius(dscene.max_blur)
    tables = rt.build_cand_tables(dscene, cam, cfg)
    gl = rt.seg_max_count(dscene, tables)
    tables = trace_cuda.narrow_cand_tables(tables, gl)
    state = rt.init_frame_state(SIZE, SIZE)
    for i in range(2):
        img, state = rt.render_frame(dscene, cam, state, cfg, cand_tables=tables, gather_len=gl)
        whole = img.cpu().numpy()
        for r, res in enumerate(ranks):
            require(np.array_equal(res["off"]["frames"][i], whole[r * half : (r + 1) * half]),
                    f"sharded: frame {i}, rank {r}'s band != one process")
    require(all(res["off"]["launches"] == 2 for res in ranks), "sharded: one trace launch per frame")
    rows, hbytes = require_band_reads("sharded:frame", ranks, "logs", half, radius,
                                      lambda res, k: res["off"][k])
    phase("sharded:frame", size=f"{SIZE}x{SIZE}", rpp=RPP, frames=2, bands=SHARDED_RANKS,
          band_rows=half, gather_len=[res["off"]["gather_len"] for res in ranks],
          one_process_gather_len=gl, equal="bitwise",
          trace_launches_per_rank=[res["off"]["launches"] for res in ranks],
          rows_processed=rows, halo_bytes_per_frame=hbytes, whole_frame_collectives=0,
          ms_per_frame_two_ranks_one_card=f"{ranks[0]['off']['frame_ms']:.3f}")

    pstate = rt.init_frame_state(SIZE, SIZE)
    prog = rt.init_progressive_state(SIZE, SIZE)
    for i, reset in enumerate((True, False)):
        img, pstate, prog = rt.render_frame_progressive(dscene, cam, pstate, prog, cfg, reset,
                                                        cand_tables=tables, gather_len=gl)
        whole = img.cpu().numpy()
        for r, res in enumerate(ranks):
            require(np.array_equal(res["progressive"][i], whole[r * half : (r + 1) * half]),
                    f"sharded: progressive pass {i}, rank {r}'s band != one process")
    rows, hbytes = require_band_reads("sharded:progressive", ranks, "progressive_logs", half,
                                      radius)
    phase("sharded:progressive", passes=2, equal="bitwise", rows_processed=rows,
          halo_bytes_per_frame=hbytes)
    del dscene, tables

    net = rt.net_for_params(rt.load_params(str(WEIGHTS)))
    unet_halo = denoiser.band_halo(net)
    dh = DN_H // SHARDED_RANKS
    bands = [slice(r * dh, (r + 1) * dh) for r in range(SHARDED_RANKS)]

    # the denoised frame: two resting frames, the tail, a zoom step
    dscene = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, DN_W, DN_H)))
    dcfg = rt.RenderConfig(rays_per_pixel=DN_RPP)
    dtables = rt.build_cand_tables(dscene, cam, dcfg)
    dgl = rt.seg_max_count(dscene, dtables)
    st = rt.init_frame_state(DN_W, DN_H)
    for _ in range(2):
        img, st = rt.render_frame(dscene, cam, st, dcfg, denoiser=net, cand_tables=dtables,
                                  gather_len=dgl)
    rest = img.cpu().numpy()
    image, bmap = rt.trace_image(dscene, cam, dcfg, st.frame, dtables, dgl)
    def whole_tail():
        return renderer._postprocess(image, bmap, st, dcfg, dscene, None, net)

    tail_ms, _ = cuda_ms(whole_tail, TAIL_REPS, warm_up=True)
    tail_device_ms = device_frame_ms(whole_tail)
    zcam = rt.Camera(zoom_factor=0.9)
    moved = dataclasses.replace(st, flow=rt.add_zoom_flow(st.flow, 1.0, 0.9))
    whole_warp = flow.warp_separable(moved.prev_image, moved.flow)
    slice_bitwise = [torch.equal(band_slice_warp(moved.prev_image, moved.flow, b.start, dh),
                                 whole_warp[b]) for b in bands]
    img, st = rt.render_frame(dscene, zcam, moved, dcfg, denoiser=net,
                              cand_tables=rt.build_cand_tables(dscene, zcam, dcfg))
    zoom, prev = img.cpu().numpy(), st.prev_image.cpu().numpy()
    for r, res in enumerate(ranks):
        d = res["denoised"]
        require(np.array_equal(d["rest"], rest[bands[r]]),
                f"sharded: denoised frame 1, rank {r}'s band != one process")
        require(np.array_equal(d["zoom"], zoom[bands[r]]) and np.array_equal(d["prev"], prev[bands[r]]),
                f"sharded: zoom frame, rank {r}'s band or band state != one process")
        require(d["frame"] == st.frame and d["flow_zero"] and d["launches"] == (1, 9),
                f"sharded: zoom frame state / launches {d['frame']} {d['launches']}")
        require(exchange_summary(d["zoom_log"])[2] == 2 and exchange_summary(d["rest_log"])[2] == 0,
                "sharded: the history is gathered on the moving frame alone")
    zoom_rows, zoom_bytes, _ = exchange_summary(ranks[0]["denoised"]["zoom_log"])
    gather_bytes = sum(b for k, b, _ in ranks[0]["denoised"]["zoom_log"] if k == "gather")
    rest_rows, rest_bytes = require_band_reads("sharded:warp", ranks, "rest_log", dh, unet_halo,
                                               lambda res, k: [res["denoised"][k]])
    phase("sharded:warp", size=f"{DN_W}x{DN_H}", rpp=DN_RPP, denoiser="shipped UNet",
          zoom="1.0->0.9", equal="bitwise", route="whole_frame_warp_band_kept",
          band_slice_of_row_product_bitwise=slice_bitwise, history_gather_bytes=gather_bytes,
          moving_frame_halo_bytes=zoom_bytes, resting_frame_halo_bytes=rest_bytes,
          rows_processed=rest_rows, unet_halo=unet_halo, blur_radius=radius)

    # the dense frame
    dense = rt.build_device_scene(rt.load_scene_from_string(dense_scene_xml(0, DN_W, DN_H, "lady_bug")))
    ncfg = rt.RenderConfig(rays_per_pixel=DENSE_RPP)
    ntables = rt.build_cand_tables(dense, cam, ncfg)
    nst = rt.init_frame_state(DN_W, DN_H)
    img, _ = rt.render_frame(dense, cam, nst, ncfg, denoiser=net, cand_tables=ntables)
    whole = img.cpu().numpy()
    for r, res in enumerate(ranks):
        require(np.array_equal(res["dense"]["image"], whole[bands[r]]),
                f"sharded: dense frame, rank {r}'s band != one process")
        require(res["dense"]["launches"] == 1 and res["dense"]["conv_launches"] == 9,
                f"sharded: dense launches {res['dense']['launches']}, "
                f"{res['dense']['conv_launches']}")
    rows, hbytes = require_band_reads("sharded:dense", ranks, "log", dh, unet_halo,
                                      lambda res, k: [res["dense"][k]])
    phase("sharded:dense", size=f"{DN_W}x{DN_H}", rpp=DENSE_RPP, denoiser="shipped UNet",
          band_rows=dh, equal="bitwise", rows_processed=rows, halo_bytes_per_frame=hbytes,
          whole_frame_collectives=0)
    image, bmap = rt.trace_image(dense, cam, ncfg, 0, ntables)

    def dense_tail():
        return renderer._postprocess(image, bmap, nst, ncfg, dense, None, net)

    dense_tail_ms, _ = cuda_ms(dense_tail, TAIL_REPS, warm_up=True)
    dense_tail_device_ms = device_frame_ms(dense_tail)
    del dense, ntables, image, bmap
    tails = {k: [res[k]["tail"] for res in ranks] for k in ("denoised", "dense")}
    phase("sharded:tail", card=json.dumps(smi), in_turns=True, reps=TAIL_REPS,
          collectives="not timed (replayed)",
          denoised_rank_ms=",".join(f"{t[0]:.3f}" for t in tails["denoised"]),
          denoised_rank_card_alone_ms=",".join(f"{t[1]:.3f}" for t in tails["denoised"]),
          denoised_one_process_whole_frame_ms=f"{tail_ms:.3f}",
          denoised_one_process_card_alone_ms=f"{tail_device_ms:.3f}",
          denoised_rows=[t[2] for t in tails["denoised"]],
          dense_rank_ms=",".join(f"{t[0]:.3f}" for t in tails["dense"]),
          dense_rank_card_alone_ms=",".join(f"{t[1]:.3f}" for t in tails["dense"]),
          dense_one_process_whole_frame_ms=f"{dense_tail_ms:.3f}",
          dense_one_process_card_alone_ms=f"{dense_tail_device_ms:.3f}",
          dense_rows=[t[2] for t in tails["dense"]])

    # config 5 through render_frame_sharded
    c5 = [res["config5"] for res in ranks]
    for i, want in enumerate(config5_frames):
        require(np.array_equal(c5[0]["frames"][i], want.numpy()),
                f"sharded: config-5 frame {i}, gathered != one process")
    require(all(c["launches"] == 2 for c in c5), "sharded: config 5, one trace launch per frame")
    require(all(c["shift"] == 2 for c in c5), f"sharded: config-5 band shifts {[c['shift'] for c in c5]}")
    c5h = C5_H // SHARDED_RANKS
    rows, hbytes = require_band_reads("sharded:config5", ranks, "logs", c5h, radius,
                                      lambda res, k: res["config5"][k])
    phase("sharded:config5", size=f"{C5_W}x{C5_H}", rpp=C5_RPP, frames=2, band_rows=c5h,
          equal="bitwise", wedge_shift_per_band=[c["shift"] for c in c5],
          gather_len=[c["gather_len"] for c in c5], rows_processed=rows,
          halo_bytes_per_frame=hbytes, last_ray_id_rank_1=C5_W * C5_H * C5_RPP - 1,
          ms_per_frame_two_ranks_one_card=",".join(f"{c['frame_ms']:.3f}" for c in c5))

    z = np.load(TRAIN_DIR / "batch.npz")
    batch = {k: torch.from_numpy(z[k]).cuda() for k in z.files}
    model, sched, opt = denoiser.create_train_state(
        torch.Generator().manual_seed(0), TRAIN_CROP, TRAIN_CROP, TRAIN_LR, arch="unet",
        base=TRAIN_BASE)
    loss = float(denoiser.train_step(model, opt, sched, batch))
    loss_err = abs(ranks[0]["train"]["loss"] - loss) / loss
    require(ranks[0]["train"]["loss"] == ranks[1]["train"]["loss"] and loss_err <= 1e-3,
            f"sharded: data-parallel loss {ranks[0]['train']['loss']} vs {loss}")
    worst = 0.0
    for n, p in model.named_parameters():
        g = p.grad.cpu().numpy()
        g0 = ranks[0]["train"]["grads"][n]
        require(np.array_equal(g0, ranks[1]["train"]["grads"][n]), f"sharded: ranks' {n} grads differ")
        worst = max(worst, float(np.linalg.norm(g0 - g) / np.linalg.norm(g)))
    require(worst <= 1e-2, f"sharded: data-parallel gradients rel L2 {worst}")
    phase("sharded:train_step", ranks=SHARDED_RANKS, batch_per_rank=TRAIN_BATCH // SHARDED_RANKS,
          loss_rel_err=f"{loss_err:.3e}", max_grad_rel_l2=f"{worst:.3e}", bar_grad="<=1e-2",
          bar_loss="<=1e-3")
    return dict(sharded_frame_ms_two_ranks_one_card=ranks[0]["off"]["frame_ms"],
                sharded_launches_per_rank=ranks[0]["off"]["launches"],
                sharded_train_grad_rel_l2=worst,
                sharded_denoised_tail_rank_ms=[t[0] for t in tails["denoised"]],
                sharded_denoised_tail_rank_device_ms=[t[1] for t in tails["denoised"]],
                sharded_denoised_tail_one_process_ms=tail_ms,
                sharded_denoised_tail_one_process_device_ms=tail_device_ms,
                sharded_dense_tail_rank_ms=[t[0] for t in tails["dense"]],
                sharded_dense_tail_rank_device_ms=[t[1] for t in tails["dense"]],
                sharded_dense_tail_one_process_ms=dense_tail_ms,
                sharded_dense_tail_one_process_device_ms=dense_tail_device_ms,
                sharded_config5_ms_two_ranks_one_card=[c["frame_ms"] for c in c5])


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # --- build every kernel from the checkout's sources, in parallel ---
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    phase("build", seconds=f"{build_s:.2f}", libs=",".join(p.name for p in paths.values()))
    for name, log in _build.BUILD_LOG.items():
        for line in log["output"].splitlines():
            if "registers" in line or "spill" in line:
                phase(f"ptxas:{name}", info=line.strip())
    trace_info = trace_cuda.trace_kernel_info()
    for i in trace_info:
        phase(f"trace_kernel:{i['name']}", registers=i["registers"], local_bytes=i["local_bytes"],
              static_smem_bytes=i["static_smem_bytes"],
              dynamic_smem_bytes=i["dynamic_smem_bytes"], blocks_per_sm=i["blocks_per_sm"],
              block_threads=i["block_threads"])

    # --- setup: config #2 at 1024^2 x 128 rpp on the seeded scene ---
    t0 = time.perf_counter()
    scene = rt.load_scene_from_string(seeded_scene_xml(0, SIZE, SIZE))
    dscene = rt.build_device_scene(scene)
    cfg = main_path_config()
    cam = rt.Camera()
    require(dscene.s_pad <= 128, f"s_pad {dscene.s_pad} <= 128")
    require(trace_cuda.accel_kind(dscene, cfg) == "seg", "segment candidate lists")
    tables = rt.build_cand_tables(dscene, cam, cfg)
    gl = rt.seg_max_count(dscene, tables)
    tables = trace_cuda.narrow_cand_tables(tables, gl)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    counts = tables.counts
    table_bytes = tables.ids.numel() * 4 + counts.numel() * 4
    phase("setup", seconds=f"{setup_s:.3f}", n_sub=dscene.n_sub, s_pad=dscene.s_pad,
          kind="seg", tables=tuple(tables.ids.shape), table_bytes=table_bytes,
          seg_max_count=gl, mean_count=f"{float(counts.float().mean()):.3f}",
          empty_cells=f"{float((counts == 0).float().mean()):.4f}")

    # --- kernel vs plain on a full-width band (8.4M rays) ---
    px0, n_band = BAND_ROW * SIZE, BAND_ROWS * SIZE
    band_tabs = trace_cuda.build_cand_tables(dscene, cam, cfg, px0, n_band)
    kern = trace_cuda.trace_sums_flat(dscene, cam, cfg, 0, px0, n_band, band_tabs)
    full = trace_cuda.trace_sums_flat(dscene, cam, cfg, 0, px0, n_band, None)
    torch.cuda.synchronize()
    for a, b in zip(kern, full):
        require(torch.equal(a, b), "kernel with lists != kernel full sweep")
    plain = trace_cuda.trace_sums_plain(dscene, cam, cfg, 0, px0, n_band, band_tabs)
    err = parity(normalized(plain, BAND_ROWS, SIZE, cfg), normalized(kern, BAND_ROWS, SIZE, cfg))
    sums_err = max(float((a - b).abs().max()) for a, b in zip(plain, kern))
    band_ms, _ = cuda_ms(lambda: trace_cuda.trace_sums_flat(dscene, cam, cfg, 0, px0, n_band, band_tabs), 5)
    band_plain_ms, _ = cuda_ms(lambda: trace_cuda.trace_sums_plain(dscene, cam, cfg, 0, px0, n_band, band_tabs), 1)
    phase("band", rays=n_band * RPP, max_abs_err=f"{err:.3e}", sums_max_abs_err=f"{sums_err:.3e}",
          lists_eq_full="bitwise", kernel_ms=f"{band_ms:.3f}", plain_ms=f"{band_plain_ms:.1f}")

    # --- kernel vs plain on the portal + weights scene (full sweep, powf) ---
    pscene = rt.build_device_scene(rt.load_scene_from_string(portal_weights_scene_xml(256, 256)))
    pcfg = rt.RenderConfig(rays_per_pixel=32, rays_per_block=2048, use_denoiser=False)
    require(pscene.has_portals and pscene.uniform_wd is None and pscene.uniform_wm is None,
            "portal scene with per-curve weight and weight degree")
    n_p = 256 * 256
    pk = trace_cuda.trace_sums_flat(pscene, cam, pcfg, 1, 0, n_p)
    pp = trace_cuda.trace_sums_plain(pscene, cam, pcfg, 1, 0, n_p)
    perr = parity(normalized(pp, 256, 256, pcfg), normalized(pk, 256, 256, pcfg))
    require(float(pk[1].sum()) > 0.0, "portal scene has weight")
    phase("portal_weights", s_pad=pscene.s_pad, kind=trace_cuda.accel_kind(pscene, pcfg),
          max_abs_err=f"{perr:.3e}")

    # --- main path: chained frames through the public entry points ---
    state = rt.init_frame_state(SIZE, SIZE)
    img, state = rt.render_frame(dscene, cam, state, cfg, cand_tables=tables, gather_len=gl)
    torch.cuda.synchronize()
    # A frame queues on the card without waiting for it: any synchronizing
    # call inside render_frame raises here.
    torch.cuda.set_sync_debug_mode("error")
    img, state = rt.render_frame(dscene, cam, state, cfg, cand_tables=tables, gather_len=gl)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    frame0 = state.frame
    trace_cuda.reset_launch_count()
    t_host = time.perf_counter()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(N_FRAMES):
        img, state = rt.render_frame(dscene, cam, state, cfg, cand_tables=tables, gather_len=gl)
    end.record()
    enqueue_ms = (time.perf_counter() - t_host) * 1e3 / N_FRAMES
    torch.cuda.synchronize()
    launches = trace_cuda.LAUNCHES
    frame_ms = start.elapsed_time(end) / N_FRAMES
    require(launches >= N_FRAMES, f"launches >= N_FRAMES: {launches}")
    require(state.frame == frame0 + N_FRAMES, f"frame counter {state.frame}")
    require(img.shape == (SIZE, SIZE, 4) and not torch.isnan(img).any(), "finite (H, W, 4) image")
    spread = float(img[..., :3].std())
    require(spread > 0.01, f"spread > 0.01: {spread}")
    require(not torch.equal(img, state.prev_image), "blur left the frame unchanged")
    _, blur_map = rt.trace_image(dscene, cam, cfg, state.frame, tables, gl)
    require(float(blur_map.max()) > 0.0, "nonzero blur map")
    phase("main_path", frames=N_FRAMES, ms_per_frame=f"{frame_ms:.3f}",
          host_enqueue_ms_per_frame=f"{enqueue_ms:.3f}", no_host_sync=True,
          rays_per_s=f"{SIZE * SIZE * RPP / (frame_ms * 1e-3):.4e}", trace_launches=launches,
          image_std=f"{spread:.4f}", blur_map_max=f"{float(blur_map.max()):.4f}")

    # --- where the frame's time goes (each stage timed alone) ---
    n_px = SIZE * SIZE
    trace_ms, sums = cuda_ms(lambda: trace_cuda.trace_sums_flat(dscene, cam, cfg, 0, 0, n_px, tables, gl), 5)
    norm_ms, (image, bmap) = cuda_ms(lambda: normalized(sums, SIZE, SIZE, cfg), 5)
    radius = blur.blur_radius(dscene.max_blur)
    blur_ms, blurred = cuda_ms(lambda: blur.variable_gaussian_blur(image, bmap, radius), 5)
    require(torch.equal(blurred, blur.variable_gaussian_blur_plain(image, bmap, radius)),
            "main path: blur kernel vs plain version: not bitwise equal")
    phase("breakdown", trace_ms=f"{trace_ms:.3f}", normalize_ms=f"{norm_ms:.3f}",
          blur_ms=f"{blur_ms:.3f}", blur_radius=radius, blur_eq_plain="bitwise")

    # --- kernel vs plain on the main path's own call: full frame, lists
    # narrowed to seg_max_count ---
    full = trace_cuda.trace_sums_flat(dscene, cam, cfg, 0, 0, n_px, None)
    torch.cuda.synchronize()
    for a, b in zip(sums, full):
        require(torch.equal(a, b), "main path: kernel with narrowed lists != kernel full sweep")
    plain_ms, plain = cuda_ms(lambda: trace_cuda.trace_sums_plain(dscene, cam, cfg, 0, 0, n_px, tables), 1)
    frame_err = parity(normalized(plain, SIZE, SIZE, cfg), normalized(sums, SIZE, SIZE, cfg))
    frame_sums_err = max(float((a - b).abs().max()) for a, b in zip(plain, sums))
    phase("frame_parity", rays=n_px * RPP, lists=tuple(tables.ids.shape), gather_len=gl,
          max_abs_err=f"{frame_err:.3e}", sums_max_abs_err=f"{frame_sums_err:.3e}",
          lists_eq_full="bitwise", plain_ms=f"{plain_ms:.1f}")

    # --- bound: this run's data-dependent work ---
    ops_ms, bytes_ms = list_bound("bound", dscene, cam, cfg, tables, trace_ms)
    bound_ms = max(ops_ms, bytes_ms)

    conv_entry, denoised_trace = denoise_phases(smi)
    dense_trace = dense_phases()
    config5_frames_0_1, config5_trace = config5_phases()
    session_trace = session_phases()
    train_trace, train_conv = train_phases()
    sharded_trace = sharded_phases(smi, config5_frames_0_1)
    conv_entry.update(train_conv)

    print(json.dumps({"kernels": [{
        "name": "trace",
        "route": "cuda",
        "source": "raytracingdiffusioncurves_torch/csrc/trace.cu",
        "replaces": "raytracingdiffusioncurves_tpu/ops/trace_pallas.py:446",
        "launches": launches,
        "max_abs_err": frame_err,
        "ms": trace_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "band_max_abs_err": err,
        "band_ms": band_ms,
        "band_plain_ms": band_plain_ms,
        "portal_max_abs_err": perr,
        "frame_ms": frame_ms,
        "build_s": build_s,
        "instantiations": trace_info,
        "card": smi,
    } | denoised_trace | dense_trace | config5_trace | session_trace | train_trace
      | sharded_trace,
        conv_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
