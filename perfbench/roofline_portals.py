"""The least time of a trace with portal continuation on one H100, from the
cell's inputs and shapes alone, as ``roofline.py`` counts a trace without
portals: never from the program's tables, counters or kernels.

Each ray's chain is followed through the frozen reference: trace 0 is the
primary ray, and a ray whose hit the reference's ``trace_and_shade`` puts
on a portal continues from that hit's exit, up to ``max_trace_depth`` more
traces (``n_traces`` in all).  Each trace counts ``roofline.py``'s
operations: the primary's raygen (RAYGEN_FLOP), one pair test (PAIR_FLOP)
for each sub-segment whose bounding circle the trace enters before its
closest hit (``roofline.crossings``, on the direction made unit and the hit
scaled to match, since an exit direction is not renormalized), and the
shading of a hit (SHADE_FLOP).  A trace that continues adds EXIT_FLOP, the
exit's own operations, counted as ``roofline.py`` counts shading: from the
plain code's formulas (``reference/intersect.py::shade`` and
``trace_full``), a compare counting one.  The rows are sampled and scaled as
``roofline.trace_ops`` does, so on a scene without portals the count is
``roofline.trace_ops``'s.

Bytes: ``roofline.py``'s (each sub-segment's record, each pixel's sums),
plus, for each portal sub-segment, its target cubic's 8 control values.
"""

from __future__ import annotations

import math

import torch

from perfbench import roofline

# The exit of a continuing trace: the normal's length (2 multiplies, an
# add, the square root, the clamp: 5) and its unit vector (2 divides) 7;
# ray_cos and ray_sin (2 x (2 multiplies, an add)) 6; the target cubic's
# point and derivative at the hit's parameter 47 (as SHADE_FLOP counts a
# Bezier point and derivative); the target normal's length and unit
# vector 7; the rotated direction (2 x (2 multiplies, an add)) 6; the chain
# (three colour products, the inverse weight's divide and add, the blur
# product) 6.
EXIT_FLOP = 7 + 6 + 47 + 7 + 6 + 6
# A portal sub-segment's target cubic: 8 float32.
PORTAL_EXTRA_BYTES = 8 * 4


def n_traces(scene, cfg) -> int:
    """Traces of a ray's chain: the reference's ``trace_full``'s count."""
    return (cfg.max_trace_depth + 1) if scene.has_portals else 1


def _trace_terms(scene, origins, dirs, cfg, unit: bool) -> tuple[int, int]:
    """(hits, pair tests) of one trace of every ray: the closest hit's
    distance bounds the circles entered."""
    from perfbench.reference import intersect

    _, t, _, hit = intersect.closest_hit(scene, origins, dirs, cfg.min_hit_distance)
    t_hit = torch.where(hit, t, math.inf)
    if unit:
        norm = torch.sqrt(dirs[:, 0] * dirs[:, 0] + dirs[:, 1] * dirs[:, 1])
        norm = torch.clamp(norm, min=1e-30)
        dirs, t_hit = dirs / norm[:, None], t_hit * norm
    return int(hit.sum()), int(roofline.crossings(scene, origins, dirs, t_hit).sum())


def trace_ops(scene, camera, cfg, dev, pairs_per_chunk: int = 1 << 26
              ) -> tuple[float, int, list[int]]:
    """(operations of the whole frame, primary rays counted, rays of each
    trace counted) from every ROW_STRIDE-th row; the operations scaled to
    every row, the rays not."""
    from perfbench.reference import intersect

    w, h, rpp = scene.width, scene.height, cfg.rays_per_pixel
    rows = list(range(roofline.ROW_STRIDE // 2, h, roofline.ROW_STRIDE)) or [h // 2]
    px = torch.tensor([r * w + x for r in rows for x in range(w)], device=dev)
    n_px = px.numel()
    chunk = max(1, pairs_per_chunk // (scene.s_pad * rpp))
    depth = n_traces(scene, cfg)
    traced = [0] * depth
    ops = 0.0
    for p0 in range(0, n_px, chunk):
        pix = px[p0: p0 + chunk].repeat_interleave(rpp)
        sample = torch.arange(rpp, device=dev).repeat(min(chunk, n_px - p0))
        origins, dirs = intersect.make_rays(pix, sample, w, h, camera, cfg, 0)
        hits, pairs = _trace_terms(scene, origins, dirs, cfg, unit=False)
        ops += float(roofline.RAYGEN_FLOP * pix.numel() + roofline.SHADE_FLOP * hits
                     + roofline.PAIR_FLOP * pairs)
        traced[0] += pix.numel()
        for k in range(1, depth):
            # the exits of trace k - 1, as the reference's trace_full takes them
            got = intersect.trace_and_shade(scene, origins, dirs, cfg)
            cont = got.hit & got.is_portal
            origins, dirs = got.exit_origin[cont], got.exit_dir[cont]
            n = int(origins.shape[0])
            if n == 0:
                break
            hits, pairs = _trace_terms(scene, origins, dirs, cfg, unit=True)
            ops += float(EXIT_FLOP * n + roofline.SHADE_FLOP * hits + roofline.PAIR_FLOP * pairs)
            traced[k] += n
    return ops * (h / len(rows)), n_px * rpp, traced


def frame_counts(xml: str, settings: dict, camera: dict, dev) -> dict:
    """Operations, bytes and least seconds of one frame's trace at
    ``camera`` (zoom, offset_x, offset_y), and the rays of each trace."""
    from perfbench.reference import device as dv
    from perfbench.reference import frame as ref
    from perfbench.reference.config import Camera, RenderConfig

    cfg = RenderConfig(**settings)
    cam = Camera(float(camera["zoom"]), float(camera["offset_x"]), float(camera["offset_y"]))
    with torch.no_grad():
        scene = ref.load_scene(xml, cfg, dev)
        ops, rays, traced = trace_ops(scene, cam, cfg, dev)
        portal_subs = int((scene.shade_table[:, dv.COL_PORTAL] > 0.0).sum())
    n_px = scene.width * scene.height
    trace_bytes = roofline.SEGMENT_BYTES * scene.n_sub + PORTAL_EXTRA_BYTES * portal_subs \
        + roofline.PIXEL_SUM_BYTES * n_px
    return {"trace_flop": ops, "trace_bytes": trace_bytes, "rays": rays, "traced": traced,
            "trace_bound_s": max(ops / roofline.FP32_FLOPS, trace_bytes / roofline.HBM_BYTES)}
