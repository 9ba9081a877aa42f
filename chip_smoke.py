"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each kernel
against its plain PyTorch version on the card, drives the main path (the
static-camera headline frame: seeded scene at 1024^2, 128 rays per pixel,
AA, blur and exact silhouettes on, denoiser off, hoisted acceleration
tables) for chained frames through the public entry points, and checks
the image.  Each phase prints one line; any failure raises (exit code !=
0).  The line before the last is a JSON object with each kernel's numbers;
the last line is {"ok": true, "device": {...}}.  Exits non-zero without a
result when no CUDA device is visible.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
    sys.exit(2)

import raytracingdiffusioncurves_torch as rt  # noqa: E402
from raytracingdiffusioncurves_torch.models import renderer  # noqa: E402
from raytracingdiffusioncurves_torch.ops import _build, blur, intersect, trace_cuda  # noqa: E402
from raytracingdiffusioncurves_torch.utils.scenes import (  # noqa: E402
    portal_weights_scene_xml,
    seeded_scene_xml,
)

SIZE, RPP = 1024, 128
BAND_ROW, BAND_ROWS = 480, 64
N_FRAMES = 20
# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).  The
# 67e12 FP32 FLOP/s count a fused multiply-add as two operations; the trace
# kernel is built with --fmad=false, so each multiply and add it counts
# below issues as an instruction of its own, at half that rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_FP32_UNFUSED_PER_S = PEAK_FP32_PER_S / 2
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


def cuda_ms(fn, reps: int):
    """(mean milliseconds per call of fn() on the card (CUDA events), the
    last call's result)."""
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


def shaded_rays(scene, cam, cfg, tables):
    """(clean, graze) primary rays of one frame 0 of the main path: clean
    rays have one winner on both chains (shade with the Newton refine),
    grazes a band-only winner (root isolation).  Plain PyTorch on the card,
    for the bound."""
    w, rpp = scene.width, cfg.rays_per_pixel
    n_px = w * scene.height
    _, _, sw, _, tile_h, tiles_x, _, _ = trace_cuda._grid_geom(scene, cfg, w, n_px)
    dev = scene.device
    clean = torch.zeros((), dtype=torch.int64, device=dev)
    graze = torch.zeros((), dtype=torch.int64, device=dev)
    px_chunk = (1 << 18) // rpp
    for p0 in range(0, n_px, px_chunk):
        npx = min(px_chunk, n_px - p0)
        pix = (p0 + torch.arange(npx, device=dev)).repeat_interleave(rpp)
        samples = torch.arange(rpp, device=dev).repeat(npx)
        o, d = intersect.make_rays(pix, samples, w, scene.height, cam, cfg, 0)
        allowed = trace_cuda._allowed_mask(scene, tables, pix, samples, tile_h, tiles_x, sw)
        band = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
        wb, _, _, hb = intersect.closest_hit(scene, o, d, cfg.min_hit_distance, band, allowed)
        ws, _, _, hs = intersect.closest_hit(scene, o, d, cfg.min_hit_distance, allowed=allowed)
        same = hb & hs & (wb == ws)
        clean += same.sum()
        graze += (hb & ~same).sum()
    return int(clean), int(graze)


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

    # --- setup: config #2 at 1024^2 x 128 rpp on the seeded scene ---
    t0 = time.perf_counter()
    scene = rt.load_scene_from_string(seeded_scene_xml(0, SIZE, SIZE))
    dscene = rt.build_device_scene(scene)
    cfg = rt.RenderConfig(rays_per_pixel=RPP, rays_per_block=2048, use_aa=True,
                          use_blur=True, exact_silhouettes=True, use_denoiser=False)
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
    blur_ms, _ = cuda_ms(lambda: blur.variable_gaussian_blur(image, bmap, radius), 5)
    phase("breakdown", trace_ms=f"{trace_ms:.3f}", normalize_ms=f"{norm_ms:.3f}",
          blur_ms=f"{blur_ms:.3f}", blur_radius=radius)

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
    rays_per_cell = (trace_cuda._grid_geom(dscene, cfg, SIZE, n_px)[1]) * (RPP // counts.shape[1])
    pairs = float(counts.double().sum()) * rays_per_cell
    live_rays = float((counts > 0).double().sum()) * rays_per_cell
    clean, grazes = shaded_rays(dscene, cam, cfg, tables)
    ops = OPS_PER_PAIR * pairs + OPS_PER_RAY * live_rays + OPS_PER_HIT * clean + OPS_PER_GRAZE * grazes
    n_bytes = (dscene.seg_consts.numel() + dscene.shade_all_t.numel()) * 4 + table_bytes + 5 * n_px * 4
    ops_ms, bytes_ms = ops / PEAK_FP32_UNFUSED_PER_S * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    phase("bound", pairs=f"{pairs:.4e}", live_rays=f"{live_rays:.4e}", clean_hits=clean,
          grazes=grazes, fp32_ops=f"{ops:.4e}", walk_ops=f"{OPS_PER_PAIR * pairs:.4e}",
          raygen_ops=f"{OPS_PER_RAY * live_rays:.4e}",
          shade_ops=f"{OPS_PER_HIT * clean + OPS_PER_GRAZE * grazes:.4e}",
          bytes=n_bytes, ops_ms=f"{ops_ms:.4f}", bytes_ms=f"{bytes_ms:.4f}",
          share_of_bound=f"{bound_ms / trace_ms:.4f}")

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
        "card": smi,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
