"""Port acceleration tables of dense scenes vs the JAX package.

Scenes are built inline at 64^2, 8 rays per pixel (2 wedges of 4 samples)
and ``flatten_subdivisions=8``: 90 random strokes (768 padded sub-segments)
and 40 parallel strands (320), both past one 128-slot level, so they take
the capped, distance-ordered lists (256 slots) with a horizon and the sorted
chunk lists.

Bars.  Segment ids, counts, chunk ids and chunk counts: equal.  Lower-bound
distances (``lbs``, horizon, chunk lbs): within 1 ulp of the centre distance
they are derived from, ``lb = dist - reach`` — both packages evaluate the
same float32 expressions, but XLA's CPU build may contract
``dcx*dcx + dcy*dcy`` into a fused multiply-add, which moves the square
root by one step.  Distances in these 64^2 scenes are below 128, where a
float32 step is 7.63e-6: that is the bar (measured: bitwise equal on three
of the four cases, 2.7% of values 3.8e-6 off on the fourth; the order of
the ids was the same on all four).  Where two lbs of a cell tie within that
step the two packages may order the two ids differently, so ids are
compared per cell as sets when the ordered comparison fails.
"""

import numpy as np
import pytest
import torch

import raytracingdiffusioncurves_torch as rt
import raytracingdiffusioncurves_tpu as rj
from raytracingdiffusioncurves_tpu.ops import candidates as jcand
from raytracingdiffusioncurves_tpu.ops import trace_pallas as tp
from raytracingdiffusioncurves_torch.ops import candidates as tcand
from raytracingdiffusioncurves_torch.ops import trace_cuda as tc
from raytracingdiffusioncurves_torch.scene import device as tdev

from conftest import make_scene_xml, simple_curve

SIZE, RPP = 64, 8
CAMERAS = [(1.0, 0.0, 0.0), (0.7, 5.5, -3.25)]


def strokes_xml():
    """90 random-walk strokes, junctions everywhere (the chaotic scene of
    the JAX package's capped-list test)."""
    rng = np.random.RandomState(7)
    curves = []
    for _ in range(90):
        x0, y0 = rng.uniform(5, 58, 2)
        pts = [(x0, y0)]
        for _ in range(3):
            x0, y0 = x0 + rng.uniform(-8, 8), y0 + rng.uniform(-8, 8)
            pts.append((round(x0, 2), round(y0, 2)))
        col = f"{rng.randint(256)},{rng.randint(256)},{rng.randint(256)}"
        curves.append(simple_curve(pts, left=[(0, col), (10, col)]))
    return make_scene_xml(curves)


def strands_xml():
    """40 non-crossing parallel strands with two-sided colours and blur."""
    return make_scene_xml([
        simple_curve(
            [(4 + 1.4 * i, 2), (4 + 1.4 * i, 22), (4 + 1.4 * i, 42), (4 + 1.4 * i, 62)],
            left=[(0, f"{(i * 37) % 256},{(i * 91) % 256},200"),
                  (30, f"{(i * 37) % 256},{(i * 91) % 256},200")],
            right=[(0, f"200,{(i * 53) % 256},{(i * 17) % 256}"),
                   (30, f"200,{(i * 53) % 256},{(i * 17) % 256}")],
            blur=[(0, 0.5), (30, 1.5)],
        )
        for i in range(40)
    ])


SCENES = {"strokes": strokes_xml, "strands": strands_xml}


def build_pair(name):
    xml = SCENES[name]()
    dj = rj.build_device_scene(rj.load_scene_from_string(xml), flatten_subdivisions=8)
    dt = rt.build_device_scene(
        rt.load_scene_from_string(xml), flatten_subdivisions=8, device="cpu"
    )
    return dj, dt


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    return build_pair(request.param)


def _within_one_ulp(a, b):
    """Within one float32 step of a distance below 128 (see the module
    docstring)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return bool(np.all(np.abs(a - b) <= np.spacing(np.float32(64.0))))


def _ids_equal(ids_j, ids_t):
    if np.array_equal(ids_j, ids_t):
        return True
    return np.array_equal(np.sort(ids_j, axis=-1), np.sort(ids_t, axis=-1))


@pytest.mark.parametrize("cam", CAMERAS)
def test_dense_tables_equal_jax(pair, cam):
    dj, dt = pair
    kw = dict(rays_per_pixel=RPP, use_blur=False, use_denoiser=False)
    cfgj, cfgt = rj.RenderConfig(**kw), rt.RenderConfig(**kw)
    geom = tp._grid_geom(dj, cfgj, SIZE, SIZE * SIZE)
    assert tc._grid_geom(dt, cfgt, SIZE, SIZE * SIZE) == geom
    _, _, sw, n_wedges, tile_h, tiles_x, tiles_y, n_tiles = geom
    cand_len = tp._cand_len_for(dj.s_pad)
    assert cand_len == 256 < dt.s_pad and tc._cand_len_for(dt.s_pad) == cand_len
    grid = (SIZE, SIZE, *cam, RPP, sw, tiles_x, tiles_y, tp.TILE_W, tile_h, 0, True)

    ids_j, cnt_j, lbs_j, cmax_j = (
        np.swapaxes(np.asarray(a), 0, 1)
        for a in jcand._segment_ids(dj.seg_consts, *grid, cand_len, order="dist",
                                    chunk_cover=True)
    )
    keep_j = cmax_j >= lbs_j[..., -1:]
    cids_j, clbs_j, ccnt_j = (
        np.asarray(a)
        for a in jcand.chunk_candidates(dj.chunk_bounds, *grid, keep=keep_j)
    )

    # without the key guard the port builds the JAX package's tables
    tabs = tc.build_cand_tables(dt, rt.Camera(*cam), cfgt, key_guard=False)
    assert tc.accel_kind(dt, cfgt) == "seg" and tabs.dist_ordered
    assert tabs.ids.shape == (n_tiles, n_wedges, cand_len)
    assert np.array_equal(cnt_j, tabs.counts.numpy())
    assert _ids_equal(ids_j, tabs.ids.numpy())
    assert _within_one_ulp(lbs_j[..., :-1], tabs.lbs.numpy())
    assert _within_one_ulp(lbs_j[..., -1], tabs.horizon.numpy())
    assert np.array_equal(ccnt_j[..., 0], tabs.chunk_counts.numpy())
    assert _ids_equal(cids_j, tabs.chunk_ids.numpy())
    assert _within_one_ulp(clbs_j, tabs.chunk_lbs.numpy())
    # the premise of the dense path: some list overflows, so a horizon is
    # recorded and the chunk lists hold what was dropped
    assert int(tabs.counts.max()) == cand_len + 1
    assert float(tabs.horizon.min()) < tcand.FAR_LB
    assert int(tabs.chunk_counts.max()) > 0
    # lists are sorted by lower bound, slots past the count are parked
    lbs = tabs.lbs.numpy()
    assert np.all(np.diff(lbs, axis=-1) >= 0.0)
    parked = np.arange(cand_len)[None, None, :] >= tabs.counts.numpy()[..., None]
    assert np.all(tabs.ids.numpy()[parked] == dt.s_pad)
    assert np.all(lbs[parked] == np.float32(tcand.FAR_LB))
    # capped lists are walked as built: nothing to narrow
    assert tc.seg_max_count(dt, tabs) is None
    assert tc.narrow_cand_tables(tabs, 16) is tabs


def test_cover_drops_only_chunks_inside_the_list(pair):
    """With ``keep`` a cell's chunk list holds a chunk iff one of the
    chunk's passing segments is missing from the cell's segment list."""
    _, dt = pair
    cfg = rt.RenderConfig(rays_per_pixel=RPP, use_blur=False, use_denoiser=False)
    _, _, sw, _, tile_h, tiles_x, tiles_y, _ = tc._grid_geom(dt, cfg, SIZE, SIZE * SIZE)
    grid = (SIZE, SIZE, 1.0, 0.0, 0.0, RPP, sw, tiles_x, tiles_y, tc.TILE_W, tile_h, 0, True)
    tabs = tc.build_cand_tables(dt, rt.Camera(), cfg)
    every, _, _, _, _ = tcand.segment_ids(dt.seg_consts, *grid, cand_len=dt.s_pad, order="id",
                                          key_guard=tcand.KEY_GUARD_SIN)
    n_chunks = dt.s_pad // tdev.SEG_ALIGN
    for t in range(tabs.ids.shape[0]):
        for w in range(tabs.ids.shape[1]):
            passing = set(every[t, w][every[t, w] < dt.s_pad].tolist())
            listed = set(tabs.ids[t, w][tabs.ids[t, w] < dt.s_pad].tolist())
            assert listed <= passing
            dropped = {j // tdev.SEG_ALIGN for j in passing - listed}
            kept = set(tabs.chunk_ids[t, w, : int(tabs.chunk_counts[t, w])].tolist())
            assert dropped <= kept <= set(range(n_chunks))
            if int(tabs.counts[t, w]) <= tabs.ids.shape[-1]:
                assert not kept  # nothing dropped: no fallback chunks


@pytest.mark.parametrize("s_pad", [8, 64, 128, 192, 256, 320, 768, 1216, 4096, 4160, 8640, 32768])
def test_cand_len_for_equals_jax(s_pad):
    assert tc._cand_len_for(s_pad) == tp._cand_len_for(s_pad)


@pytest.mark.parametrize("rpp,rpb,multi,dense", [
    (8, 4096, True, False), (8, 4096, True, True), (64, 4096, True, True),
    (256, 4096, True, False), (256, 4096, True, True), (512, 4096, True, False),
    (128, 2048, False, False), (6, 1024, True, True), (1, 4096, True, True),
])
def test_choose_block_equals_jax(rpp, rpb, multi, dense):
    assert tc._choose_block(rpp, rpb, multi, dense) == tp._choose_block(rpp, rpb, multi, dense)


class _Shape:
    """The fields accel_kind reads of a scene."""

    def __init__(self, s_pad, width, height):
        self.s_pad, self.width, self.height = s_pad, width, height


@pytest.mark.parametrize("s_pad,size,rpp,want", [
    (24, (64, 64), 16, None),            # shorter than a list: full sweep
    (128, (64, 64), 16, "seg"),          # slot mode
    (128, (64, 64), 1, "chunk"),         # one wedge, two chunks
    (64, (64, 64), 1, None),             # one wedge, one chunk
    (768, (64, 64), 8, "seg"),           # capped lists, 2 wedges
    (1216, (1920, 1088), 256, "seg"),    # 64 wedges: the cap, inclusive
    (1216, (256, 256), 512, "seg"),      # 128 wedges: coarsened to 64
    (8640, (1920, 1088), 64, "seg"),     # dense block geometry
    (8640, (256, 256), 256, "seg"),      # dense, 128 wedges, coarsened
    (32768, (64, 64), 8, "seg"),
    (32832, (64, 64), 8, "chunk"),       # past CAND_MAX_SPAD
])
def test_accel_kind_equals_jax(s_pad, size, rpp, want):
    """The port decides as the JAX package does, wedge coarsening included:
    a scene whose lists exist only over coarser wedges (more than 64 wedges)
    takes segment lists at the same shift (test_torch_coarse.py holds the
    shift rule against the JAX package's)."""
    scene = _Shape(s_pad, *size)
    cfgj, cfgt = rj.RenderConfig(rays_per_pixel=rpp), rt.RenderConfig(rays_per_pixel=rpp)
    n_px = size[0] * size[1]
    geom = tp._grid_geom(scene, cfgj, size[0], n_px)
    assert tc._grid_geom(scene, cfgt, size[0], n_px) == geom
    shift = tp._wedge_coarse_shift(scene, geom[3], geom[7], tdev.ALLT_ROWS, False)
    assert tc.accel_kind(scene, cfgt) == want
    assert tp._accel_kind(scene, geom[3], geom[7]) == want
    if shift is not None and shift[0] > 0:
        assert geom[3] > tcand.CAND_MAX_WEDGES and want == "seg"
        assert tc.table_layout(scene, cfgt) == ("seg", shift[0])


@pytest.mark.parametrize("rpp", [8, 64])
def test_key_guard_tables(pair, rpp):
    """With the key guard (the default of build_cand_tables) every segment
    that passed still passes; a cell's hazards (chords that a ray of the
    wedge can run nearly parallel to) pass on the backward cone too and get
    bound 0; every other bound drops by the segment's slack, and what the
    slack newly admits has bound 0."""
    _, dt = pair
    cfg = rt.RenderConfig(rays_per_pixel=rpp, use_blur=False, use_denoiser=False)
    n_px = 16 * SIZE
    _, _, sw, n_wedges, tile_h, tiles_x, tiles_y, n_tiles = tc._grid_geom(dt, cfg, SIZE, n_px)
    grid = (SIZE, SIZE, 1.0, 0.0, 0.0, rpp, sw, tiles_x, tiles_y, tc.TILE_W, tile_h, 0, True)
    sigma = tcand.KEY_GUARD_SIN

    def by_segment(ids, lbs):  # (T, W, S) bounds by segment id, inf: culled
        out = torch.full((n_tiles, n_wedges, dt.s_pad + 1), float("inf"))
        return out.scatter_(2, ids.long(), lbs)[..., : dt.s_pad]

    plain = tcand.segment_ids(dt.seg_consts, *grid, cand_len=dt.s_pad, order="id")
    guard = tcand.segment_ids(dt.seg_consts, *grid, cand_len=dt.s_pad, order="id",
                              key_guard=sigma)
    lb_plain, lb_guard = by_segment(plain[0], plain[2]), by_segment(guard[0], guard[2])
    passed, passes = torch.isfinite(lb_plain), torch.isfinite(lb_guard)
    assert bool((passes | ~passed).all()) and int(passes.sum()) >= int(passed.sum())
    hazard = tcand.parallel_hazards(dt.seg_consts, rpp, sw, sigma)[None].expand_as(passes)
    slack = tcand.key_slack(dt.seg_consts, sigma)[None, None, :].expand_as(lb_plain)
    both = passed & ~hazard
    assert torch.equal(lb_guard[both], torch.clamp(lb_plain[both] - slack[both], min=0.0))
    assert bool((lb_guard[passes & hazard] == 0.0).all())
    assert bool((lb_guard[passes & ~passed] == 0.0).all())
    if rpp == 8:  # two half-plane wedges: every chord is parallel to some ray
        assert bool(hazard.all())
    else:  # 16 wedges of 0.39 rad: a minority of the chords
        assert 0.0 < float(hazard[..., : dt.n_sub].float().mean()) < 0.5
    slack = tcand.key_slack(dt.seg_consts, sigma)
    assert float(slack[: dt.n_sub].min()) > 0.0 and float(slack[dt.n_sub :].sum()) == 0.0
    tabs = tc.build_cand_tables(dt, rt.Camera(), cfg, 0, n_px)
    assert np.all(np.diff(tabs.lbs.numpy(), axis=-1) >= 0.0)
    # where hazards may have been dropped (horizon 0) the chunks are unbounded
    dropped = (tabs.horizon <= 0.0)[..., None] & (tabs.chunk_lbs < tcand.FAR_LB)
    assert bool((tabs.chunk_lbs[dropped] == 0.0).all())


def test_table_bytes_count_every_table(pair):
    _, dt = pair
    cfg = rt.RenderConfig(rays_per_pixel=RPP, use_blur=False, use_denoiser=False)
    tabs = tc.build_cand_tables(dt, rt.Camera(), cfg)
    n_tiles, n_wedges, _ = tabs.ids.shape
    assert tc._seg_table_bytes(dt.s_pad, n_tiles, n_wedges) == tabs.nbytes - tabs.circle.numel() * 4


def test_scene_circle_encloses_every_segment(pair):
    _, dt = pair
    cx, cy, r, slack = tc.scene_circle(dt, key_guard=False).tolist()
    assert slack == 0.0
    guarded = tc.scene_circle(dt).tolist()
    assert guarded[:3] == [cx, cy, r]
    assert guarded[3] == float(tcand.key_slack(dt.seg_consts, tcand.KEY_GUARD_SIN).max()) > 0.0
    c = dt.seg_consts[: dt.n_sub]
    for px, py in ((c[:, tdev.CONST_P0X], c[:, tdev.CONST_P0Y]),
                   (c[:, tdev.CONST_P0X] + c[:, tdev.CONST_EX],
                    c[:, tdev.CONST_P0Y] + c[:, tdev.CONST_EY])):
        d = torch.sqrt((px - cx) ** 2 + (py - cy) ** 2) + c[:, tdev.CONST_BAND]
        assert float(d.max()) <= r


@pytest.mark.parametrize("kind,lo,hi,cand_len", [
    ("lady_bug", 1024, 1536, 256), ("dolphin", 4096, 9216, 512),
])
def test_dense_scene_classes(kind, lo, hi, cand_len):
    """The generated dense scenes land in their class at the frame size of
    the dense-scene path, and scale with the canvas."""
    from raytracingdiffusioncurves_torch.utils.scenes import dense_scene_xml

    full = rt.build_device_scene(
        rt.load_scene_from_string(dense_scene_xml(0, 1920, 1088, kind)), device="cpu")
    assert lo < full.s_pad <= hi and tc._cand_len_for(full.s_pad) == cand_len
    assert not full.has_portals and full.max_blur > 0.0
    cfg = rt.RenderConfig(rays_per_pixel=256 if kind == "lady_bug" else 64)
    assert tc.accel_kind(full, cfg) == "seg"
    _, pxb, sw, n_wedges, tile_h, _, _, n_tiles = tc._grid_geom(full, cfg, 1920, 1920 * 1088)
    assert (sw, tile_h, n_tiles) == ((4, 32, 4080) if kind == "lady_bug" else (2, 32, 4080))
    assert tc._seg_table_bytes(full.s_pad, n_tiles, n_wedges) < tc._CAND_TABLE_BYTES_CAP
    small = rt.build_device_scene(
        rt.load_scene_from_string(dense_scene_xml(0, 480, 272, kind)), device="cpu")
    assert small.n_sub == full.n_sub
