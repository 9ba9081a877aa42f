"""The dense-scene trace of the port, on the CPU, vs the JAX package.

Scenes: the inline 90-stroke and 40-strand scenes of
test_torch_candidates_dense.py (64^2, 8 rays per pixel, capped 256-slot
lists that overflow, chunk lists).

* The plain trace with dense tables equals the plain trace without tables
  bit for bit: the plain version takes the exact (key, id) minimum over the
  whole set the tables declare hittable, so this shows the tables
  conservative.
* The CUDA kernel's walk (distance-ordered list with a per-ray exit, then
  the sorted chunk list past the horizon; csrc/trace.cu ``walk_dist``) is
  written out here in plain tensor code and picks, for every ray, the
  winners of the full sweep on both chains, at 8 rays per pixel (whole
  frame) and at 64 (a band; 16 wedges, so the exits bite): with the key
  guard of ops/candidates.py the shortcuts are exact, and the fallback
  really fires.  Every accepted (ray, segment) pair's ordering key is at
  least the bound its cell's table gives the segment.
* On the generated lady_bug-class scene at the dense frame's own launch
  shape (1920x1088, 256 rays per pixel, rest camera, one tile row) cells
  overflow and some of their rays walk chunks past the horizon.
* Without the key guard (the JAX package's tables: bounds of the distance)
  the same walk misses winners of the full sweep on the strokes scene: a
  ray that grazes a far chord nearly parallel gets a key near 0 for it.
  This is the fault the guard repairs; the test pins it.
* ``trace_image`` with dense tables against the JAX oracle
  (``backend="jax"``) under the JAX package's assert_parity bars.  The
  strands take ``frac=5e-4``, the bar of the JAX package's own capped-list
  test: near-vertical rays run almost parallel to the strands, so a couple
  of grazing-tie pixels of 64^2 may flip winners between two
  implementations whose pow and sum order differ.
* ``render_frame`` with the shipped UNet on a dense scene, two chained
  frames, against the JAX package at the bars of chained denoised frames:
  max below 1e-2, fewer than 1% of values above 5e-3, mean below 1e-3 (the
  network's output is a bf16 residual on inputs that differ by the jitted
  bf16 bilateral's 1.6e-3; see test_torch_renderer.py).
"""

import os

import numpy as np
import pytest
import torch

import raytracingdiffusioncurves_torch as rt
import raytracingdiffusioncurves_tpu as rj
from raytracingdiffusioncurves_torch.ops import intersect
from raytracingdiffusioncurves_torch.ops import trace_cuda as tc
from raytracingdiffusioncurves_torch.scene import device as tdev
from raytracingdiffusioncurves_tpu.models import denoiser as jdn

from test_torch_candidates_dense import RPP, SIZE, build_pair
from test_torch_trace import assert_parity

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "weights", "denoiser_r3d.msgpack")
KW = dict(rays_per_pixel=RPP, use_blur=False, use_denoiser=False)
INF = float("inf")


@pytest.fixture(scope="module", params=["strands", "strokes"])
def pair(request):
    return request.param, *build_pair(request.param)


@pytest.mark.parametrize("exact", [True, False])
def test_plain_with_dense_tables_equals_full_sweep_bitwise(pair, exact):
    _, _, dt = pair
    cfg = rt.RenderConfig(**KW, exact_silhouettes=exact)
    cam = rt.Camera(0.9, 1.5, -2.0)
    n_px = 48 * SIZE  # rows 16..63: a band with px_start > 0
    tabs = tc.build_cand_tables(dt, cam, cfg, px_start=16 * SIZE, n_px=n_px)
    assert tabs.dist_ordered and tabs.chunk_ids is not None
    assert int(tabs.counts.max()) > tabs.ids.shape[-1], "premise: a list overflows"
    lists = tc.trace_sums_flat(dt, cam, cfg, 2, 16 * SIZE, n_px, tabs)
    full = tc.trace_sums_flat(dt, cam, cfg, 2, 16 * SIZE, n_px, None)
    for a, b in zip(lists, full):
        assert torch.equal(a, b)
    assert float(lists[1].sum()) > 0.0


def _rays(dt, cam, cfg, frame, n_px=SIZE * SIZE):
    """Origins, directions, tile and wedge of every ray of the first n_px
    pixels."""
    rpp = cfg.rays_per_pixel
    _, _, sw, _, tile_h, tiles_x, _, _ = tc._grid_geom(dt, cfg, SIZE, n_px)
    pix = torch.arange(n_px).repeat_interleave(rpp)
    samples = torch.arange(rpp).repeat(n_px)
    o, d = intersect.make_rays(pix, samples, SIZE, SIZE, cam, cfg, frame)
    tile = ((pix // SIZE) // tile_h) * tiles_x + (pix % SIZE) // tc.TILE_W
    return o, d, tile, samples // sw


def _ranks(dt, o, d, cfg):
    """(band, strict) ordering keys (N, S), inf where a chain rejects."""
    scale = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    _, _, t_est, _, vb = tdev.intersect_consts(dt.seg_consts, o, d, cfg.min_hit_distance, scale)
    _, _, _, _, vs = tdev.intersect_consts(dt.seg_consts, o, d, cfg.min_hit_distance)
    key = torch.clamp(t_est, min=1e-30)
    return torch.where(vb, key, INF), torch.where(vs, key, INF)


def _take(best, key, j, go):
    """consider(): the (key, id) minimum with the explicit tie-break."""
    k0, w0 = best
    better = go & ((key < k0) | ((key == k0) & (j < w0) & (key < INF)))
    return torch.where(better, key, k0), torch.where(better, j, w0)


def walk_dist(dt, tabs, o, d, tile, wedge, rank_b, rank_s, lists=True):
    """csrc/trace.cu ``walk_dist`` for all rays at once: returns (wb, ws,
    slots tested, rays that walked a chunk)."""
    n = o.shape[0]
    ar = torch.arange(n)
    cx, cy, cr, key_slack = tabs.circle.tolist()
    pcx, pcy = cx - o[:, 0], cy - o[:, 1]
    bq = d[:, 0] * pcx + d[:, 1] * pcy
    disc = bq * bq - (pcx * pcx + pcy * pcy - cr * cr)
    texit = torch.clamp(
        torch.where(disc >= 0.0, bq + torch.sqrt(torch.clamp(disc, min=0.0)), 0.0), min=0.0
    ) * np.float32(1.00002) + np.float32(key_slack)
    band = (torch.full((n,), INF), torch.full((n,), 2**30))
    strict = (torch.full((n,), INF), torch.full((n,), 2**30))

    def thr():
        return torch.minimum(strict[0], texit) * np.float32(1.00001)

    slots = torch.zeros(n, dtype=torch.int64)
    into = torch.ones(n, dtype=torch.bool)
    if lists:
        ids, lbs = tabs.ids[tile, wedge].long(), tabs.lbs[tile, wedge]
        count = tabs.counts[tile, wedge].long()
        cand_len = ids.shape[-1]
        alive = torch.ones(n, dtype=torch.bool)
        for k in range(cand_len):
            alive = alive & (k < torch.clamp(count, max=cand_len)) & (lbs[:, k] < thr())
            if not alive.any():
                break
            j = torch.clamp(ids[:, k], max=dt.s_pad - 1)
            band = _take(band, rank_b[ar, j], j, alive)
            strict = _take(strict, rank_s[ar, j], j, alive)
            slots += alive
        into = (count > cand_len) & (tabs.horizon[tile, wedge] < thr())
    cids, clbs = tabs.chunk_ids[tile, wedge].long(), tabs.chunk_lbs[tile, wedge]
    ccount = tabs.chunk_counts[tile, wedge].long()
    walked = torch.zeros(n, dtype=torch.bool)
    alive = into
    for c in range(cids.shape[-1]):
        alive = alive & (c < ccount) & (clbs[:, c] < thr())
        if not alive.any():
            break
        walked |= alive
        for m in range(tdev.SEG_ALIGN):
            j = torch.clamp(cids[:, c] * tdev.SEG_ALIGN + m, max=dt.s_pad - 1)
            band = _take(band, rank_b[ar, j], j, alive)
            strict = _take(strict, rank_s[ar, j], j, alive)
    return band[1], strict[1], slots, walked


def _mismatches(rank_b, rank_s, wb, ws):
    """Rays whose walk winner differs from the full sweep's (the first
    minimum of the keys: the (key, id) order), per chain."""
    out = []
    for rank, got in ((rank_b, wb), (rank_s, ws)):
        best = torch.argmin(rank, dim=1)
        hit = torch.isfinite(rank[torch.arange(rank.shape[0]), best])
        out.append(int((torch.where(hit, best, 2**30) != got).sum()))
    return out


@pytest.mark.parametrize("cam", [(1.0, 0.0, 0.0), (0.7, 5.5, -3.25)])
def test_kernel_walk_finds_the_full_sweeps_winners(pair, cam):
    name, _, dt = pair
    cfg = rt.RenderConfig(**KW)
    camera = rt.Camera(*cam)
    tabs = tc.build_cand_tables(dt, camera, cfg)
    o, d, tile, wedge = _rays(dt, camera, cfg, 1)
    rank_b, rank_s = _ranks(dt, o, d, cfg)
    wb, ws, _, walked = walk_dist(dt, tabs, o, d, tile, wedge, rank_b, rank_s)
    assert _mismatches(rank_b, rank_s, wb, ws) == [0, 0]
    assert int(walked.sum()) > 0, f"{name}: no ray entered the chunk fallback"


@pytest.mark.parametrize("cam", [(1.0, 0.0, 0.0), (0.7, 5.5, -3.25)])
def test_kernel_walk_with_early_exits_finds_the_full_sweeps_winners(pair, cam):
    """64 rays per pixel on a band of 16 rows, in tiles of 16 x 4 pixels: 16
    wedges of 0.39 rad and origin circles of 8 pixels, so most chords are no
    hazard of a wedge, most bounds are above 0 and rays leave their lists
    early."""
    name, _, dt = pair
    cfg = rt.RenderConfig(rays_per_pixel=64, rays_per_block=256, use_blur=False,
                          use_denoiser=False)
    camera = rt.Camera(*cam)
    n_px = 16 * SIZE
    tabs = tc.build_cand_tables(dt, camera, cfg, 0, n_px)
    o, d, tile, wedge = _rays(dt, camera, cfg, 1, n_px)
    rank_b, rank_s = _ranks(dt, o, d, cfg)
    wb, ws, slots, walked = walk_dist(dt, tabs, o, d, tile, wedge, rank_b, rank_s)
    assert _mismatches(rank_b, rank_s, wb, ws) == [0, 0]
    full_len = torch.clamp(tabs.counts[tile, wedge].long(), max=tabs.ids.shape[-1])
    print(name, cam, "slots per ray", float(slots.float().mean()), "of",
          float(full_len.float().mean()), "fallback rays", int(walked.sum()), "of", slots.numel())
    if name == "strands":  # the strokes' bands are a third of their chords:
        # slacks of tens of pixels, next to no exit in a 64-pixel picture
        assert float(slots.float().mean()) < 0.8 * float(full_len.float().mean()), (
            "the exit saves less than a fifth of the slots")


@pytest.mark.parametrize("rpp", [8, 64])
def test_every_accepted_key_is_at_least_its_table_bound(pair, rpp):
    _, _, dt = pair
    from raytracingdiffusioncurves_torch.ops import candidates as tcand
    cfg = rt.RenderConfig(rays_per_pixel=rpp, rays_per_block=256, use_blur=False,
                          use_denoiser=False)
    camera = rt.Camera(0.7, 5.5, -3.25)
    n_px = 16 * SIZE
    _, _, sw, n_wedges, tile_h, tiles_x, tiles_y, n_tiles = tc._grid_geom(dt, cfg, SIZE, n_px)
    ids, _, lbs, _, _ = tcand.segment_ids(
        dt.seg_consts, SIZE, SIZE, 0.7, 5.5, -3.25, rpp, sw, tiles_x, tiles_y, tc.TILE_W,
        tile_h, 0, True, cand_len=dt.s_pad, order="id", key_guard=tcand.KEY_GUARD_SIN)
    bound = torch.full((n_tiles, n_wedges, dt.s_pad + 1), INF)
    bound.scatter_(2, ids.long(), lbs)  # per cell, by segment id; inf: culled
    o, d, tile, wedge = _rays(dt, camera, cfg, 3, n_px)
    rank_b, _ = _ranks(dt, o, d, cfg)  # the band chain accepts what the strict one does
    cell_bound = bound[tile, wedge][:, : dt.s_pad]
    accepted = torch.isfinite(rank_b)
    assert int(accepted.sum()) > 0
    # nothing a ray accepts was culled, and no key undercuts its bound
    assert bool(torch.isfinite(cell_bound[accepted]).all())
    assert bool((rank_b[accepted] * np.float32(1.00001) >= cell_bound[accepted]).all())


def test_rays_pass_the_horizon_at_the_rest_camera():
    """The generated lady_bug-class scene at the dense frame's own launch
    shape (1920x1088, 256 rays per pixel, rest camera), one tile row: every
    tile has a wedge whose cone holds the whole aphid, so that cell's list
    overflows; of its rays those that pass beside the aphid look past the
    list's horizon and walk chunks, and the walk still finds the full
    sweep's winners.  Four pixels of each such cell are traced."""
    from raytracingdiffusioncurves_torch.utils.scenes import dense_scene_xml

    w, h, rpp, tile_row = 1920, 1088, 256, 20
    dt = rt.build_device_scene(
        rt.load_scene_from_string(dense_scene_xml(0, w, h, "lady_bug")), device="cpu")
    cfg = rt.RenderConfig(rays_per_pixel=rpp)
    _, _, sw, _, tile_h, tiles_x, _, _ = tc._grid_geom(dt, cfg, w, w * h)
    px0, n_px = tile_row * tile_h * w, tile_h * w
    tabs = tc.build_cand_tables(dt, rt.Camera(), cfg, px0, n_px)
    cells = torch.nonzero(tabs.counts > tabs.ids.shape[-1])  # (n, 2): tile, wedge
    assert cells.shape[0] >= tiles_x, "premise: every tile has an overflowing cell"
    rows, cols = torch.tensor([4, 12, 20, 28]), torch.tensor([3, 9, 5, 13])
    tile = cells[:, 0].repeat_interleave(4 * sw)
    wedge = cells[:, 1].repeat_interleave(4 * sw)
    k = torch.arange(4 * sw).repeat(cells.shape[0])
    pix = rows[k // sw] * w + (tile % tiles_x) * tc.TILE_W + cols[k // sw]
    samples = wedge * sw + k % sw
    o, d = intersect.make_rays(px0 + pix, samples, w, h, rt.Camera(), cfg, 0)
    rank_b, rank_s = _ranks(dt, o, d, cfg)
    wb, ws, slots, walked = walk_dist(dt, tabs, o, d, tile, wedge, rank_b, rank_s)
    assert _mismatches(rank_b, rank_s, wb, ws) == [0, 0]
    print("overflowing cells", cells.shape[0], "of", tabs.counts.numel(), "rays traced",
          walked.numel(), "past the horizon", int(walked.sum()),
          "slots per ray", float(slots.float().mean()))
    assert int(walked.sum()) > 0, "no ray of an overflowing cell entered the chunk fallback"


def test_distance_bounds_alone_miss_grazing_band_winners():
    """The fault of bounds that bound only the distance (the JAX package's
    tables, ``key_guard=False``): on the strokes scene at this camera two
    rays graze a far chord nearly parallel, the chord's key clamps to 1e-30
    and wins the band chain of the full sweep, and the walk, which stopped
    at the near strict hit, never meets it."""
    _, dt = build_pair("strokes")
    cfg = rt.RenderConfig(**KW)
    camera = rt.Camera(0.7, 5.5, -3.25)
    tabs = tc.build_cand_tables(dt, camera, cfg, key_guard=False)
    o, d, tile, wedge = _rays(dt, camera, cfg, 1)
    rank_b, rank_s = _ranks(dt, o, d, cfg)
    wb, ws, _, _ = walk_dist(dt, tabs, o, d, tile, wedge, rank_b, rank_s)
    band_missed, strict_missed = _mismatches(rank_b, rank_s, wb, ws)
    assert band_missed > 0 and strict_missed == 0


def test_chunk_walk_alone_finds_the_full_sweeps_winners(pair):
    """Chunk lists only (the fine tables of a scene with more than 64
    wedges, wedge shift 0: 512 rays per pixel, two rows of the picture): the
    chunk walk from an empty state."""
    _, _, dt = pair
    cfg = rt.RenderConfig(rays_per_pixel=512, use_blur=False, use_denoiser=False)
    assert tc.accel_kind(dt, cfg, wedge_shift=0) == "chunk"
    n_px = 2 * SIZE
    tabs = tc.build_cand_tables(dt, rt.Camera(), cfg, 0, n_px, wedge_shift=0)
    assert tabs.ids is None and tabs.chunk_ids is not None
    o, d, tile, wedge = _rays(dt, rt.Camera(), cfg, 0, n_px)
    rank_b, rank_s = _ranks(dt, o, d, cfg)
    wb, ws, _, walked = walk_dist(dt, tabs, o, d, tile, wedge, rank_b, rank_s, lists=False)
    assert _mismatches(rank_b, rank_s, wb, ws) == [0, 0]
    assert int(walked.sum()) > 0


def test_chunk_kind_tables_and_plain_trace():
    """A scene with more than 64 wedges gets chunk lists only from
    build_cand_tables at wedge shift 0, and its plain trace equals the full
    sweep."""
    _, dt = build_pair("strands")
    cfg = rt.RenderConfig(rays_per_pixel=512, use_blur=False, use_denoiser=False)
    n_px = 4 * SIZE
    tabs = tc.build_cand_tables(dt, rt.Camera(), cfg, 0, n_px, wedge_shift=0)
    assert tabs.ids is None and tabs.lbs is None and tabs.chunk_ids is not None
    assert tabs.dist_ordered and tc.seg_max_count(dt, tabs) is None
    assert int(tabs.chunk_counts.min()) < dt.s_pad // tdev.SEG_ALIGN  # the cull is active
    a = tc.trace_sums_flat(dt, rt.Camera(), cfg, 0, 0, n_px, tabs)
    b = tc.trace_sums_flat(dt, rt.Camera(), cfg, 0, 0, n_px, None)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_trace_image_matches_jax_oracle(pair):
    name, dj, dt = pair
    cam = (0.9, 1.5, -2.0)
    img_j, bm_j = rj.trace_image(dj, rj.Camera(*cam), rj.RenderConfig(**KW), backend="jax")
    cfg = rt.RenderConfig(**KW)
    tabs = rt.build_cand_tables(dt, rt.Camera(*cam), cfg)
    assert rt.seg_max_count(dt, tabs) is None
    img_t, bm_t = rt.trace_image(dt, rt.Camera(*cam), cfg, cand_tables=tabs)
    assert_parity((np.asarray(img_j), np.asarray(bm_j)), (img_t.numpy(), bm_t.numpy()),
                  frac=5e-4 if name == "strands" else 3e-5)
    assert (img_t.numpy()[..., :3].sum(-1) > 0).mean() > 0.5


def test_denoised_frames_on_a_dense_scene_match_jax():
    dj, dt = build_pair("strands")
    kw = dict(rays_per_pixel=RPP)  # the defaults: denoiser, AA, blur, exact silhouettes
    cfgj, cfgt = rj.RenderConfig(**kw), rt.RenderConfig(**kw)
    assert dt.max_blur > 0.0 and cfgt.use_denoiser and cfgt.use_blur
    pj = jdn.load_params(WEIGHTS)
    net = rt.net_for_params(rt.load_params(WEIGHTS), device="cpu")
    tabs = rt.build_cand_tables(dt, rt.Camera(), cfgt)
    sj = rj.init_frame_state(SIZE, SIZE)
    st = rt.init_frame_state(SIZE, SIZE, device="cpu")
    for i in range(2):
        img_j, sj = rj.render_frame(dj, rj.Camera(), sj, cfgj, backend="jax",
                                    denoiser_params=pj)
        img_t, st = rt.render_frame(dt, rt.Camera(), st, cfgt, denoiser=net,
                                    cand_tables=tabs,
                                    gather_len=rt.seg_max_count(dt, tabs))
        for a, b in ((img_j, img_t), (sj.prev_image, st.prev_image)):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape and np.isfinite(b).all()
            dd = np.abs(a - b)
            assert dd.max() < 1e-2 and (dd > 5e-3).mean() < 0.01 and dd.mean() < 1e-3
        assert st.flow_is_zero and st.frame == i + 1
    assert not torch.equal(img_t, st.prev_image)  # the blur ran after the denoiser
