"""The port's world grid (camera-independent tables for a moving camera) vs
the JAX package and vs the port's own full sweep.

Scenes: the seeded main-path scene at 64^2 x 32 rays per pixel
(``rays_per_block=512``: slot-mode lists, 8 wedges, tiles of 16 x 8) and
the inline dense scenes of test_torch_candidates_dense.py (64^2 x 8 rays
per pixel: capped distance-ordered lists with chunk lists).

* Geometry: the WorldGrid fields equal the JAX package's build_cand_grid;
  grid_covers agrees with the JAX package's on 20 seeded cameras.
* Lists: the grid's cell lists equal the JAX package's ``_segment_ids`` /
  ``chunk_candidates`` on the same cell circles, slot mode bitwise,
  distance order (tables built without the key guard, the JAX package's)
  under the bars of test_torch_candidates_dense.py.
* Supersets: at every camera the grid covers, each cell of the selected
  tables declares hittable (list slots and members of listed chunks) every
  segment the camera's own tables declare.
* Trace: the plain trace with grid tables equals the full sweep and the
  per-camera tables bit for bit; the kernel's early-exit walk, emulated in
  plain tensor code, finds the full sweep's winners on grid tables.
"""

import numpy as np
import pytest
import torch

import raytracingdiffusioncurves_torch as rt
import raytracingdiffusioncurves_tpu as rj
from raytracingdiffusioncurves_tpu.ops import candidates as jcand
from raytracingdiffusioncurves_tpu.ops import trace_pallas as tp
from raytracingdiffusioncurves_torch.ops import trace_cuda as tc
from raytracingdiffusioncurves_torch.scene import device as tdev
from raytracingdiffusioncurves_torch.utils.scenes import seeded_scene_xml

from test_torch_candidates_dense import _ids_equal, _within_one_ulp, build_pair
from test_torch_trace_dense import _mismatches, _ranks, _rays, walk_dist

SIZE = 64
SLOT_KW = dict(rays_per_pixel=32, rays_per_block=512, use_denoiser=False)
DENSE_KW = dict(rays_per_pixel=8, use_blur=False, use_denoiser=False)
# (x0, y0, x1, y1, zoom_max) of the grids under test: a session's grid at
# the rest camera (one zoom-out step, 1.5 screens) and an off-centre one
BOXES = [(-72.0, -72.0, 72.0, 72.0, 1.5), (-30.5, -61.25, 95.0, 40.0, 1.2)]
CAMERAS = [(1.0, 0.0, 0.0), (0.7, 5.5, -3.25), (1.5, -8.0, 6.0)]


_PAIRS = {}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tests run thousands of small tensor ops (the emulated walk
    loops over slots); one intra-op thread each keeps them from spinning
    against the other test workers' threads.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def scene_pair(name):
    """(JAX scene, port scene) of "seeded", "strokes" or "strands", built
    once per module."""
    if name not in _PAIRS:
        if name == "seeded":
            xml = seeded_scene_xml(0, SIZE, SIZE)
            _PAIRS[name] = (rj.build_device_scene(rj.load_scene_from_string(xml)),
                            rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu"))
        else:
            _PAIRS[name] = build_pair(name)
    return _PAIRS[name]


def _kw(name):
    return SLOT_KW if name == "seeded" else DENSE_KW


def _cfgs(kw):
    return rj.RenderConfig(**kw), rt.RenderConfig(**kw)


def _cell_circles(grid, dt, cfg):
    tile_h = tc._grid_geom(dt, cfg, SIZE, SIZE * SIZE)[4]
    x1 = grid.x0 + grid.nx * grid.pitch_x
    y1 = grid.y0 + grid.ny * grid.pitch_y
    return tc._cell_circles(grid.x0, grid.y0, x1, y1, grid.pitch_x, grid.pitch_y, grid.nx,
                            grid.ny, grid.zoom_max, tile_h, dt.device)


@pytest.mark.parametrize("name,box", [("seeded", BOXES[0]), ("seeded", BOXES[1]),
                                      ("strands", BOXES[0])])
def test_world_grid_fields_equal_jax(name, box):
    dj, dt = scene_pair(name)
    cfgj, cfgt = _cfgs(_kw(name))
    x0, y0, x1, y1, zmax = box
    gj = tp.build_cand_grid(dj, cfgj, x0, y0, x1, y1, zoom_max=zmax)
    gt = rt.build_cand_grid(dt, cfgt, x0, y0, x1, y1, zoom_max=zmax)
    assert isinstance(gt, rt.WorldGrid)
    for f in ("x0", "y0", "pitch_x", "pitch_y", "nx", "ny", "zoom_max", "gather_len"):
        assert getattr(gt, f) == getattr(gj, f), f
    assert gt.nx * gt.ny == gt.tables.counts.shape[0] > 1
    if name == "seeded":
        assert gt.gather_len == int(gt.tables.counts.max()) and not gt.tables.dist_ordered
        assert gt.tables.ids.shape[-1] == gt.gather_len
    else:
        assert gt.gather_len is None and gt.tables.dist_ordered
        assert gt.tables.chunk_ids is not None and gt.tables.circle is not None


def test_grid_covers_agrees_with_jax():
    dj, dt = scene_pair("seeded")
    cfgj, cfgt = _cfgs(SLOT_KW)
    rng = np.random.default_rng(6)
    gj = tp.build_cand_grid(dj, cfgj, *BOXES[1][:4], zoom_max=BOXES[1][4])
    gt = rt.build_cand_grid(dt, cfgt, *BOXES[1][:4], zoom_max=BOXES[1][4])
    answers = []
    for z, ox, oy in zip(rng.uniform(0.3, 1.4, 20), rng.uniform(-40, 60, 20),
                         rng.uniform(-45, 25, 20)):
        z, ox, oy = float(z), float(ox), float(oy)
        got = rt.grid_covers(gt, dt, rt.Camera(z, ox, oy), cfgt)
        assert got == tp.grid_covers(gj, dj, rj.Camera(z, ox, oy), cfgj)
        answers.append(got)
    assert 0 < sum(answers) < 20  # both answers occur
    assert not rt.grid_covers(gt, dt, rt.Camera(1.21, 30.0, -10.0), cfgt)  # past zoom_max


@pytest.mark.parametrize("box", BOXES)
def test_slot_mode_cell_lists_equal_jax(box):
    dj, dt = scene_pair("seeded")
    cfgj, cfgt = _cfgs(SLOT_KW)
    gt = rt.build_cand_grid(dt, cfgt, *box[:4], zoom_max=box[4])
    _, _, sw, _, tile_h, _, _, _ = tc._grid_geom(dt, cfgt, SIZE, SIZE * SIZE)
    circles = tuple(np.asarray(c.numpy()) for c in _cell_circles(gt, dt, cfgt))
    ids, cnt, _, _ = jcand._segment_ids(
        dj.seg_consts, SIZE, SIZE, 1.0, 0.0, 0.0, 32, sw, gt.nx, gt.ny, tp.TILE_W, tile_h, 0,
        True, dj.s_pad, order="id", circles=circles,
    )
    ids, cnt = np.swapaxes(np.asarray(ids), 0, 1), np.swapaxes(np.asarray(cnt), 0, 1)
    gl = gt.gather_len
    assert gl == int(cnt.max()) and int(cnt.min()) < dt.s_pad  # the cells cull
    assert np.array_equal(ids[..., :gl], gt.tables.ids.numpy())
    assert np.all(ids[..., gl:] == dt.s_pad)
    assert np.array_equal(cnt, gt.tables.counts.numpy())


@pytest.mark.parametrize("name", ["strokes", "strands"])
def test_dist_order_cell_lists_equal_jax(name):
    dj, dt = scene_pair(name)
    cfgj, cfgt = _cfgs(DENSE_KW)
    x0, y0, x1, y1, zmax = BOXES[0]
    gt = rt.build_cand_grid(dt, cfgt, x0, y0, x1, y1, zoom_max=zmax, key_guard=False)
    _, _, sw, _, tile_h, _, _, _ = tc._grid_geom(dt, cfgt, SIZE, SIZE * SIZE)
    circles = tuple(np.asarray(c.numpy()) for c in _cell_circles(gt, dt, cfgt))
    grid = (SIZE, SIZE, 1.0, 0.0, 0.0, 8, sw, gt.nx, gt.ny, tp.TILE_W, tile_h, 0, True)
    cand_len = tp._cand_len_for(dj.s_pad)
    ids_j, cnt_j, lbs_j, cmax_j = (
        np.swapaxes(np.asarray(a), 0, 1)
        for a in jcand._segment_ids(dj.seg_consts, *grid, cand_len, order="dist",
                                    circles=circles, chunk_cover=True)
    )
    keep_j = cmax_j >= lbs_j[..., -1:]
    cids_j, clbs_j, ccnt_j = (
        np.asarray(a) for a in jcand.chunk_candidates(dj.chunk_bounds, *grid, circles=circles,
                                                     keep=keep_j)
    )
    t = gt.tables
    assert np.array_equal(cnt_j, t.counts.numpy())
    assert _ids_equal(ids_j, t.ids.numpy())
    assert _within_one_ulp(lbs_j[..., :-1], t.lbs.numpy())
    assert _within_one_ulp(lbs_j[..., -1], t.horizon.numpy())
    assert np.array_equal(ccnt_j[..., 0], t.chunk_counts.numpy())
    assert _ids_equal(cids_j, t.chunk_ids.numpy())
    assert _within_one_ulp(clbs_j, t.chunk_lbs.numpy())
    assert int(t.counts.max()) == cand_len + 1  # cells overflow: chunk lists have work


def _declared(dt, tables):
    """(T, W, S) bool: the segments each cell's tables declare hittable, the
    list's first min(count, L) slots and the members of the listed chunks."""
    t = tables.counts.shape[0] if tables.counts is not None else tables.chunk_counts.shape[0]
    w = tables.counts.shape[1] if tables.counts is not None else tables.chunk_counts.shape[1]
    out = torch.zeros((t, w, dt.s_pad + 1), dtype=torch.bool)
    if tables.ids is not None:
        n = tables.ids.shape[-1]
        live = torch.arange(n) < torch.clamp(tables.counts, max=n)[..., None]
        out.scatter_(2, torch.where(live, tables.ids, dt.s_pad).long(), True)
    if tables.chunk_ids is not None:
        c = tables.chunk_ids.shape[-1]
        live = torch.arange(c) < tables.chunk_counts[..., None]
        chunks = torch.zeros((t, w, c + 1), dtype=torch.bool)
        chunks.scatter_(2, torch.where(live, tables.chunk_ids, c).long(), True)
        members = chunks[..., :c].repeat_interleave(tdev.SEG_ALIGN, dim=-1)[..., : dt.s_pad]
        out[..., : dt.s_pad] |= members
    return out[..., : dt.s_pad]


@pytest.mark.parametrize("name", ["seeded", "strokes", "strands"])
def test_selected_tables_are_supersets_of_the_cameras(name):
    _, dt = scene_pair(name)
    cfg = rt.RenderConfig(**_kw(name))
    x0, y0, x1, y1, zmax = BOXES[0]
    grid = rt.build_cand_grid(dt, cfg, x0, y0, x1, y1, zoom_max=zmax)
    served = 0
    for cam in CAMERAS + [(zmax, 0.0, 0.0), (0.5, 20.0, -20.0)]:
        camera = rt.Camera(*cam)
        assert rt.grid_covers(grid, dt, camera, cfg)
        own = _declared(dt, rt.build_cand_tables(dt, camera, cfg))
        picked = _declared(dt, rt.grid_tables(grid, dt, camera, cfg))
        assert bool((picked | ~own).all()), f"camera {cam}: a candidate is missing"
        served += int(own.sum())
        assert int(picked.sum()) >= int(own.sum())
    assert served > 0


@pytest.mark.parametrize("name,cam", [("seeded", (0.7, 5.5, -3.25)), ("seeded", (1.5, -8.0, 6.0)),
                                      ("strokes", (0.7, 5.5, -3.25)),
                                      ("strands", (1.5, -8.0, 6.0))])
def test_plain_trace_on_grid_tables_equals_full_sweep_bitwise(name, cam):
    _, dt = scene_pair(name)
    cfg = rt.RenderConfig(**_kw(name))
    grid = rt.build_cand_grid(dt, cfg, *BOXES[0][:4], zoom_max=BOXES[0][4])
    camera = rt.Camera(*cam)
    n_px = SIZE * SIZE
    own = rt.build_cand_tables(dt, camera, cfg)
    picked = rt.grid_tables(grid, dt, camera, cfg)
    a = tc.trace_sums_flat(dt, camera, cfg, 3, 0, n_px, picked, grid.gather_len)
    b = tc.trace_sums_flat(dt, camera, cfg, 3, 0, n_px, None)
    c = tc.trace_sums_flat(dt, camera, cfg, 3, 0, n_px, own, rt.seg_max_count(dt, own))
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert float(a[1].sum()) > 0.0


def test_grid_tables_on_a_band_are_rows_of_the_frame():
    """A band that starts on a tile row selects the frame's cells for its
    tiles."""
    _, dt = scene_pair("strands")
    cfg = rt.RenderConfig(rays_per_pixel=64, rays_per_block=256, use_denoiser=False)
    grid = rt.build_cand_grid(dt, cfg, *BOXES[0][:4], zoom_max=BOXES[0][4])
    camera = rt.Camera(0.7, 5.5, -3.25)
    tile_h, tiles_x = tc._grid_geom(dt, cfg, SIZE, SIZE * SIZE)[4:6]
    assert SIZE // tile_h >= 3
    whole = tc.grid_cells(grid, dt, camera, cfg)
    band = tc.grid_cells(grid, dt, camera, cfg, tile_h * SIZE, tile_h * SIZE)
    assert torch.equal(band, whole[tiles_x: 2 * tiles_x])


@pytest.mark.parametrize("name,cam", [("strokes", (0.7, 5.5, -3.25)), ("strands", (1.0, 0.0, 0.0))])
def test_kernel_walk_on_grid_tables_finds_the_full_sweeps_winners(name, cam):
    """The emulated early-exit walk (list, horizon, sorted chunk walk) over
    grid tables at 64 rays per pixel on a band of 16 rows (16 wedges, so the
    exits bite): cell circles are about three tile radii wide, and the key
    guard's bounds stay conservative on them."""
    _, dt = scene_pair(name)
    cfg = rt.RenderConfig(rays_per_pixel=64, rays_per_block=256, use_blur=False,
                          use_denoiser=False)
    camera = rt.Camera(*cam)
    n_px = 16 * SIZE
    grid = rt.build_cand_grid(dt, cfg, *BOXES[0][:4], zoom_max=BOXES[0][4])
    assert rt.grid_covers(grid, dt, camera, cfg)
    tabs = rt.grid_tables(grid, dt, camera, cfg, 0, n_px)
    o, d, tile, wedge = _rays(dt, camera, cfg, 1, n_px)
    rank_b, rank_s = _ranks(dt, o, d, cfg)
    wb, ws, slots, _ = walk_dist(dt, tabs, o, d, tile, wedge, rank_b, rank_s)
    assert _mismatches(rank_b, rank_s, wb, ws) == [0, 0]
    own = rt.build_cand_tables(dt, camera, cfg, 0, n_px)
    _, _, own_slots, _ = walk_dist(dt, own, o, d, tile, wedge, rank_b, rank_s)
    # superset lists: the walk tests at least as many slots
    assert float(slots.float().mean()) >= float(own_slots.float().mean())
