"""Wedge-coarsened candidate tables of the port vs the JAX package.

Past 64 wedges (or past the tables' byte cap) 2^k adjacent wedges share one
table entry, built at the wider wedge of sw << k samples
(trace_cuda.table_layout).  Bars:

* the shift rule equals the JAX package's ``_wedge_coarse_shift`` wherever
  neither package's byte cap decides (tolerance 0);
* slot-mode tables equal ``_segment_ids(order="id")`` at sw << k bitwise;
  distance-ordered tables built without the key guard equal the JAX
  package's at sw << k with test_torch_candidates_dense.py's bars (ids and
  counts equal, bounds within one float32 step of a distance below 128);
* the plain trace over coarse tables equals its own full sweep bit for bit
  (the tables are conservative for every ray of the wider wedge), and the
  JAX oracle (``backend="jax"``) under the JAX package's assert_parity;
* a band takes the full frame's shift, and its tables equal the frame's
  rows of tables bitwise.
"""

import numpy as np
import pytest
import torch

import raytracingdiffusioncurves_torch as rt
import raytracingdiffusioncurves_tpu as rj
from raytracingdiffusioncurves_tpu.models import renderer as jr
from raytracingdiffusioncurves_tpu.ops import candidates as jcand
from raytracingdiffusioncurves_tpu.ops import trace_pallas as tp
from raytracingdiffusioncurves_torch.models import renderer as tr
from raytracingdiffusioncurves_torch.ops import trace_cuda as tc
from raytracingdiffusioncurves_torch.scene import device as tdev
from raytracingdiffusioncurves_torch.utils.scenes import portal_weights_scene_xml, seeded_scene_xml

from test_torch_candidates_dense import _ids_equal, _Shape, _within_one_ulp, build_pair
from test_torch_trace import assert_parity

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module, so that under the suite's
    parallel workers its plain traces do not spin against the other
    workers' threads.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)

# A camera zoomed in past the drawing's centre: tiles small against the
# scene, so the cull drops segments from most cells.
CAMERA = (0.5, 3.0, -2.0)


@pytest.mark.parametrize("s_pad,size,rpp", [
    (128, (64, 64), 16),       # 4 wedges: fine
    (1216, (1920, 1088), 256),  # 64 wedges: fine, the cap inclusive
    (128, (64, 64), 512),      # 128 wedges: shift 1
    (128, (64, 64), 1024),     # 256 wedges: shift 2
    (768, (64, 64), 2048),     # 512 wedges: shift 3
    (128, (64, 64), 4096),     # 1024 wedges: shift 4, the most
    (128, (64, 64), 8192),     # 2048 wedges: past 16x, chunk lists
    (1216, (256, 256), 512),   # capped lists, 128 wedges
    (8640, (256, 256), 256),   # dense block geometry, 128 wedges
    (24, (64, 64), 1024),      # shorter than a list: no lists at any shift
])
def test_shift_rule_equals_jax(s_pad, size, rpp):
    scene = _Shape(s_pad, *size)
    cfgj, cfgt = rj.RenderConfig(rays_per_pixel=rpp), rt.RenderConfig(rays_per_pixel=rpp)
    n_px = size[0] * size[1]
    geom = tp._grid_geom(scene, cfgj, size[0], n_px)
    assert tc._grid_geom(scene, cfgt, size[0], n_px) == geom
    jax_shift = tp._wedge_coarse_shift(scene, geom[3], geom[7], tdev.ALLT_ROWS, False)
    kind, shift = tc.table_layout(scene, cfgt)
    assert kind == tp._accel_kind(scene, geom[3], geom[7])
    if jax_shift is None:
        assert kind != "seg" and shift == 0
    else:
        assert kind == "seg" and shift == jax_shift[0]
    # neither package's byte cap decided
    assert tc._seg_table_bytes(s_pad, geom[7], geom[3]) <= tc._CAND_TABLE_BYTES_CAP


@pytest.fixture(scope="module")
def seeded():
    xml = seeded_scene_xml(0, SIZE, SIZE)
    dj = rj.build_device_scene(rj.load_scene_from_string(xml))
    dt = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    return dj, dt


@pytest.mark.parametrize("rpp,shift", [(512, 1), (1024, 2)])
def test_slot_tables_equal_jax_at_the_wider_wedge(seeded, rpp, shift):
    dj, dt = seeded
    cfgt = rt.RenderConfig(rays_per_pixel=rpp, use_denoiser=False)
    _, _, sw, n_wedges, tile_h, tiles_x, tiles_y, n_tiles = tc._grid_geom(dt, cfgt, SIZE, SIZE**2)
    assert tc.table_layout(dt, cfgt) == ("seg", shift)
    ids, cnt, _, _ = jcand._segment_ids(
        dj.seg_consts, SIZE, SIZE, *CAMERA, rpp, sw << shift, tiles_x, tiles_y,
        tp.TILE_W, tile_h, 0, True, dj.s_pad, order="id",
    )
    tabs = tc.build_cand_tables(dt, rt.Camera(*CAMERA), cfgt)
    assert tabs.ids.shape == (n_tiles, n_wedges >> shift, dt.s_pad) and not tabs.dist_ordered
    assert tc.table_wedge_shift(tabs, n_wedges) == shift
    assert np.array_equal(np.swapaxes(np.asarray(ids), 0, 1), tabs.ids.numpy())
    assert np.array_equal(np.swapaxes(np.asarray(cnt), 0, 1), tabs.counts.numpy())
    assert int(tabs.counts.min()) < dt.n_sub  # the cull is active
    # forced fine tables past 64 wedges: chunk lists, as before coarsening
    assert tc.table_layout(dt, cfgt, wedge_shift=0) == ("chunk", 0)
    fine = tc.build_cand_tables(dt, rt.Camera(*CAMERA), cfgt, wedge_shift=0)
    assert fine.ids is None and fine.chunk_ids.shape[1] == n_wedges


@pytest.mark.parametrize("rpp,shift", [(512, 1), (1024, 2)])
@pytest.mark.parametrize("name", ["strokes", "strands"])
def test_dist_tables_equal_jax_at_the_wider_wedge(name, rpp, shift):
    dj, dt = build_pair(name)
    size = 64
    cfgt = rt.RenderConfig(rays_per_pixel=rpp, use_blur=False, use_denoiser=False)
    _, _, sw, n_wedges, tile_h, tiles_x, tiles_y, n_tiles = tc._grid_geom(dt, cfgt, size, size**2)
    assert tc.table_layout(dt, cfgt) == ("seg", shift)
    cand_len = tp._cand_len_for(dj.s_pad)
    cam = (0.7, 5.5, -3.25)
    grid = (size, size, *cam, rpp, sw << shift, tiles_x, tiles_y, tp.TILE_W, tile_h, 0, True)
    ids_j, cnt_j, lbs_j, cmax_j = (
        np.swapaxes(np.asarray(a), 0, 1)
        for a in jcand._segment_ids(dj.seg_consts, *grid, cand_len, order="dist",
                                    chunk_cover=True)
    )
    keep_j = cmax_j >= lbs_j[..., -1:]
    cids_j, clbs_j, ccnt_j = (
        np.asarray(a) for a in jcand.chunk_candidates(dj.chunk_bounds, *grid, keep=keep_j)
    )
    tabs = tc.build_cand_tables(dt, rt.Camera(*cam), cfgt, key_guard=False)
    assert tabs.ids.shape == (n_tiles, n_wedges >> shift, cand_len)
    assert tabs.chunk_ids.shape[:2] == (n_tiles, n_wedges >> shift)
    assert np.array_equal(cnt_j, tabs.counts.numpy())
    assert _ids_equal(ids_j, tabs.ids.numpy())
    assert _within_one_ulp(lbs_j[..., :-1], tabs.lbs.numpy())
    assert _within_one_ulp(lbs_j[..., -1], tabs.horizon.numpy())
    assert np.array_equal(ccnt_j[..., 0], tabs.chunk_counts.numpy())
    assert _ids_equal(cids_j, tabs.chunk_ids.numpy())
    assert _within_one_ulp(clbs_j, tabs.chunk_lbs.numpy())


# (scene, rays per pixel, wedge shift, rows traced from the top): the
# slot-mode seeded scene and the portal scene (192 sub-segments:
# distance-ordered lists, portal bounces), at 32^2, on a band of rows.
TRACE_CASES = {
    "seeded_512": (lambda: seeded_scene_xml(0, SIZE, SIZE), 512, 1, 8),
    "seeded_1024": (lambda: seeded_scene_xml(0, SIZE, SIZE), 1024, 2, 4),
    "portal_512": (lambda: portal_weights_scene_xml(SIZE, SIZE), 512, 1, 4),
}


@pytest.fixture(scope="module")
def traced():
    """Per case: the JAX scene, the port's scene, its config, the band's
    tables and the plain trace's sums over them and over every segment (the
    full sweep), computed once for the tests below."""
    cache = {}

    def get(name):
        if name not in cache:
            make, rpp, shift, rows = TRACE_CASES[name]
            xml = make()
            dj = rj.build_device_scene(rj.load_scene_from_string(xml))
            dt = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
            cfg = rt.RenderConfig(rays_per_pixel=rpp, use_denoiser=False)
            assert tc.table_layout(dt, cfg) == ("seg", shift)
            cam = rt.Camera(*CAMERA)
            n_px = rows * SIZE
            tabs = tc.build_cand_tables(dt, cam, cfg, 0, n_px)
            assert tabs.ids.shape[1] == rpp // tc._grid_geom(dt, cfg, SIZE, n_px)[2] >> shift
            lists = tc.trace_sums_flat(dt, cam, cfg, 3, 0, n_px, tabs)
            full = tc.trace_sums_flat(dt, cam, cfg, 3, 0, n_px, None)
            cache[name] = (dj, dt, cfg, rows, tabs, lists, full)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(TRACE_CASES))
def test_plain_trace_on_coarse_tables_equals_full_sweep(traced, name):
    _, dt, _, _, tabs, lists, full = traced(name)
    for a, b in zip(lists, full):
        assert torch.equal(a, b)
    assert float(lists[1].sum()) > 0.0
    assert int(tabs.counts.min()) < dt.n_sub  # the cull is active
    if name.startswith("portal"):
        assert dt.has_portals and tabs.dist_ordered


@pytest.mark.parametrize("name", sorted(TRACE_CASES))
def test_plain_trace_on_coarse_tables_matches_jax_oracle(traced, name):
    dj, _, cfg, rows, _, lists, _ = traced(name)
    cfgj = rj.RenderConfig(rays_per_pixel=cfg.rays_per_pixel, use_denoiser=False)
    sums_j = jr.trace_sums_flat(dj, rj.Camera(*CAMERA), cfgj, 3, 0, rows * SIZE, "jax")
    shape = (rows, SIZE)
    img_j, bm_j = jr.normalize_sums(np.asarray(sums_j[0]).reshape(*shape, 3),
                                    np.asarray(sums_j[1]).reshape(shape),
                                    np.asarray(sums_j[2]).reshape(shape), cfgj)
    c, w, b = lists
    img_t, bm_t = tr.normalize_sums(c.reshape(*shape, 3), w.reshape(shape), b.reshape(shape), cfg)
    assert_parity((np.asarray(img_j), np.asarray(bm_j)), (img_t.numpy(), bm_t.numpy()))


@pytest.mark.parametrize("rpp,rows", [(260, 8), (1000, 4)])
def test_chunk_lists_where_no_power_of_two_divides_the_wedges(seeded, rpp, rows):
    """65 wedges (260 rpp) and 250 (1000 rpp) on the seeded scene, two
    chunks of sub-segments: fine lists do not exist past 64 wedges and no
    2^k (k >= 1) that divides the count leaves 64 or fewer, so
    ``table_layout`` takes chunk lists at the fine wedge, shift 0.  The
    plain trace over those tables equals its full sweep bit for bit on a
    band of rows.  No JAX comparison: the JAX package asserts at these
    counts (its coarse tables do not divide the wedges)."""
    _, dt = seeded
    cfg = rt.RenderConfig(rays_per_pixel=rpp, use_denoiser=False)
    n_wedges = tc._grid_geom(dt, cfg, SIZE, SIZE**2)[3]
    assert n_wedges == rpp // 4 and n_wedges % 2 ** (1 + (rpp == 1000)) != 0
    assert dt.s_pad // tc.SEG_CHUNK > 1
    assert tc.table_layout(dt, cfg) == ("chunk", 0)
    cam = rt.Camera(*CAMERA)
    n_px = rows * SIZE
    tabs = tc.build_cand_tables(dt, cam, cfg, 0, n_px)
    assert tabs.ids is None and tabs.chunk_ids.shape[1] == n_wedges
    assert tc.table_wedge_shift(tabs, n_wedges) == 0
    lists = tc.trace_sums_flat(dt, cam, cfg, 3, 0, n_px, tabs)
    full = tc.trace_sums_flat(dt, cam, cfg, 3, 0, n_px, None)
    for a, b in zip(lists, full):
        assert torch.equal(a, b)
    assert float(lists[1].sum()) > 0.0


def test_band_takes_the_full_frames_shift(monkeypatch):
    """With a byte cap between one tile row's fine tables and the frame's,
    the frame coarsens and a band takes its shift, although the band's own
    fine tables would fit; its tables are the frame's rows of tables."""
    size = 64
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, size, size)),
                               device="cpu")
    cfg = rt.RenderConfig(rays_per_pixel=256, use_denoiser=False)  # 64 wedges
    _, _, _, n_wedges, tile_h, _, _, n_tiles = tc._grid_geom(dt, cfg, size, size**2)
    assert n_wedges == 64 and tc.table_layout(dt, cfg) == ("seg", 0)
    band_px = tile_h * size  # the last tile row
    band_tiles = tc._grid_geom(dt, cfg, size, band_px)[7]
    assert band_tiles < n_tiles
    monkeypatch.setattr(tc, "_CAND_TABLE_BYTES_CAP",
                        tc._seg_table_bytes(dt.s_pad, band_tiles, n_wedges))
    assert tc._coarse_shift(dt.s_pad, band_tiles, n_wedges) == 0
    assert tc.table_layout(dt, cfg) == ("seg", 1)
    assert tc.table_layout(dt, cfg, n_px=band_px) == ("seg", 1)
    cam = rt.Camera(*CAMERA)
    frame = tc.build_cand_tables(dt, cam, cfg)
    row0 = size * size - band_px
    band = tc.build_cand_tables(dt, cam, cfg, px_start=row0, n_px=band_px)
    assert band.ids.shape == (band_tiles, n_wedges >> 1, dt.s_pad)
    assert torch.equal(band.ids, frame.ids[n_tiles - band_tiles:])
    assert torch.equal(band.counts, frame.counts[n_tiles - band_tiles:])


def test_tables_of_another_shape_are_refused(seeded):
    _, dt = seeded
    cfg = rt.RenderConfig(rays_per_pixel=512, use_denoiser=False)
    tabs = tc.build_cand_tables(dt, rt.Camera(), cfg)
    n_wedges = tc._grid_geom(dt, cfg, SIZE, SIZE**2)[3]
    odd = tc.CandTables(tabs.ids[:, :48].contiguous(), tabs.counts[:, :48].contiguous())
    with pytest.raises(ValueError, match="do not coarsen"):
        tc.table_wedge_shift(odd, n_wedges)
    with pytest.raises(ValueError, match="does not divide"):
        tc.table_layout(dt, rt.RenderConfig(rays_per_pixel=24), wedge_shift=2)  # 6 wedges
