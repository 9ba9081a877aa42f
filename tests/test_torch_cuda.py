"""The port's CUDA kernels (trace, 3x3 convolution, bilateral, blur) against their plain
PyTorch versions, on the card.  Skips without a CUDA device (the kernels
have no CPU mode).  Imports neither jax nor the JAX package, so it runs on a
machine without them:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Bars: the JAX package's assert_parity (fewer than 3e-5 of image values off
by more than 1e-3, mean below 1e-4) between kernel and plain version — the
two evaluate the same float32 expressions and differ in pow rounding and
the order of the per-pixel sums; kernel with lists == kernel full sweep
bit for bit, with the lists at full length and narrowed to the largest
count (``gather_len``, as the main path passes them).

Dense scenes (capped, distance-ordered lists with a per-ray exit, the
horizon fallback into the sorted chunk lists, chunk lists alone): the same
two bars, kernel vs full sweep bit for bit and kernel vs plain version
under assert_parity, on the inline stroke and strand scenes and on the
generated lady_bug- and dolphin-class scenes, with the fallback seen to
fire in the kernel's own counters.

Convolution: kernel and plain version multiply the same bf16 values and
differ only in the order of the float32 sum: at least 99% of values bitwise
equal, none off by more than one bf16 step of the accumulator plus one of
the result, which is rounded again after the bias
(|diff| <= 2^-7 * (2 |y| + |bias|)).  The denoised frame, kernel route vs
plain route: the network's output is a bf16 residual, so single values move
by one bf16 step (3.9e-3 below 1, 7.8e-3 from 1 to 2): max 1e-2, mean 1e-4.

Row bands: a band's UNet (the conv kernel) and blur and analytic pass, on
the band plus its halo rows cut from the whole frame, bitwise equal to the
whole frame's rows (what parallel/sharded.py relies on).

Bilateral filter: the kernel (csrc/bilateral.cu) bitwise equal to
spatial_bilateral_plain on the same card, in both weight branches, on a
rendered 1080p frame read through its [..., :3] view, random images, the
training batch and frames of 1 to 4 rows or columns; one launch a
denoised frame.

Blur: the kernel (csrc/blur.cu) bitwise equal to variable_gaussian_blur_plain
on the same card: a rendered 1080p frame with its own blur map, random
frames at 1080p and 1024^2 and at radii 0 to 300 (the tile narrowed), sigma
maps past the radius and all zero, views read by their strides, the 4K
frame's bands with their halos against the whole frame's rows; one launch a
frame with the denoiser on, analytic or off.

Training: the batched training forward (cuDNN's bf16 convolution, the
batched bilateral) against the per-image forward on the plain convolution,
and one train step against the same step on the CPU (loss 1e-3 relative,
gradients 3e-2 relative L2: two libraries' bf16 convolutions).
"""

import dataclasses
import os

import pytest
import torch

import raytracingdiffusioncurves_torch as rt
from raytracingdiffusioncurves_torch.models import denoiser as dn
from raytracingdiffusioncurves_torch.models import renderer
from raytracingdiffusioncurves_torch.ops import bilateral_cuda as bc
from raytracingdiffusioncurves_torch.ops import blur as tblur
from raytracingdiffusioncurves_torch.ops import blur_cuda as tbc
from raytracingdiffusioncurves_torch.ops import conv_cuda as cc
from raytracingdiffusioncurves_torch.ops import denoise as tden
from raytracingdiffusioncurves_torch.ops import trace_cuda as tc
from raytracingdiffusioncurves_torch.utils.scenes import (
    _curve_xml,
    _document,
    dense_scene_xml,
    portal_weights_scene_xml,
    seeded_scene_xml,
)

pytestmark = pytest.mark.cuda

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "weights", "denoiser_r3d.msgpack")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trace kernel runs only on the card")
    return torch.device("cuda")


def _images(sums, h, w, cfg):
    c, wt, b = sums
    return renderer.normalize_sums(c.reshape(h, w, 3), wt.reshape(h, w), b.reshape(h, w), cfg)


def _assert_parity(ref, got):
    (ia, ba), (ib, bb) = ref, got
    d = (ia - ib).abs()
    assert not torch.isnan(ib).any()
    assert float((d > 1e-3).float().mean()) < 3e-5 and float(d.mean()) < 1e-4
    assert float(((ba - bb).abs() > 1e-3).float().mean()) < 3e-5


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("exact", [True, False])
def test_kernel_matches_plain_with_lists(cuda, exact, narrow):
    size = 256
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(1, size, size)), device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=32, rays_per_block=2048, use_denoiser=False,
                          exact_silhouettes=exact)
    cam = rt.Camera(0.8, 3.0, -5.0)
    tabs = tc.build_cand_tables(dt, cam, cfg)
    assert tabs is not None
    gl = None
    if narrow:
        gl = tc.seg_max_count(dt, tabs)
        assert gl < tabs.ids.shape[-1]
        tabs = tc.narrow_cand_tables(tabs, gl)
    tc.reset_launch_count()
    kern = tc.trace_sums_flat(dt, cam, cfg, 3, 0, size * size, tabs, gl)
    assert tc.LAUNCHES == 1
    full = tc.trace_sums_flat(dt, cam, cfg, 3, 0, size * size, None)
    torch.cuda.synchronize()
    for a, b in zip(kern, full):
        assert torch.equal(a, b)
    plain = tc.trace_sums_plain(dt, cam, cfg, 3, 0, size * size, tabs)
    _assert_parity(_images(plain, size, size, cfg), _images(kern, size, size, cfg))


def test_kernel_matches_plain_portals_weights(cuda):
    size = 128
    dt = rt.build_device_scene(rt.load_scene_from_string(portal_weights_scene_xml(size, size)),
                               device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=16, rays_per_block=2048, use_denoiser=False)
    kern = tc.trace_sums_flat(dt, rt.Camera(), cfg, 0, 0, size * size)
    plain = tc.trace_sums_plain(dt, rt.Camera(), cfg, 0, 0, size * size)
    _assert_parity(_images(plain, size, size, cfg), _images(kern, size, size, cfg))


@pytest.mark.parametrize("w,h", [(192, 128), (200, 72)], ids=["whole_tiles", "ragged_tiles"])
def test_kernel_matches_plain_at_the_denoised_frames_launch_shape(cuda, w, h):
    """A non-square frame, 8 rays per pixel, the default rays_per_block (2
    wedges, tiles 16 wide and 64 high), a zoomed camera, lists read up to
    seg_max_count: the launch shape of the denoised frame."""
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, w, h)), device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=8)
    cam = rt.Camera(zoom_factor=0.9)
    tabs = tc.build_cand_tables(dt, cam, cfg)
    gl = tc.seg_max_count(dt, tabs)
    kern = tc.trace_sums_flat(dt, cam, cfg, 2, 0, w * h, tabs, gl)
    full = tc.trace_sums_flat(dt, cam, cfg, 2, 0, w * h, None)
    torch.cuda.synchronize()
    for a, b in zip(kern, full):
        assert torch.equal(a, b)
    plain = tc.trace_sums_plain(dt, cam, cfg, 2, 0, w * h, tabs)
    _assert_parity(_images(plain, h, w, cfg), _images(kern, h, w, cfg))


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 65])
def test_id_order_lists_at_piece_boundaries(cuda, n):
    """The kernel stages a walk 32 slots at a time and keeps a cell's first
    two pieces for its samples: lists of n = 0, 1, 31, 32, 33 and 65 ids
    (0..n-1 in every cell) against the full sweep of a scene cut to its
    first n sub-segments, bit for bit, and against the plain version."""
    size = 128
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(2, size, size)),
                               device=cuda)
    assert dt.n_sub >= 65
    cfg = rt.RenderConfig(rays_per_pixel=32, rays_per_block=2048, use_denoiser=False)
    cam = rt.Camera(0.8, 3.0, -5.0)
    _, _, _, n_wedges, _, _, _, n_tiles = tc._grid_geom(dt, cfg, size, size * size)
    slots = torch.arange(max(n, 1), dtype=torch.int32, device=cuda)
    ids = slots.expand(n_tiles, n_wedges, -1).contiguous()
    counts = torch.full((n_tiles, n_wedges), n, dtype=torch.int32, device=cuda)
    tabs = tc.CandTables(ids, counts)
    kern = tc.trace_sums_flat(dt, cam, cfg, 1, 0, size * size, tabs)
    cut = tc.trace_sums_flat(dataclasses.replace(dt, n_sub=n), cam, cfg, 1, 0, size * size, None)
    torch.cuda.synchronize()
    for a, b in zip(kern, cut):
        assert torch.equal(a, b)
    assert (float(kern[1].sum()) > 0.0) == (n > 0)
    plain = tc.trace_sums_plain(dt, cam, cfg, 1, 0, size * size, tabs)
    _assert_parity(_images(plain, size, size, cfg), _images(kern, size, size, cfg))


def test_portal_scene_lists_equal_full_sweep(cuda):
    """Portal bounces walk every segment in the pieces that take turns;
    without tables the primary rays do too, and share the kept pieces."""
    size = 128
    dt = rt.build_device_scene(rt.load_scene_from_string(portal_weights_scene_xml(size, size)),
                               device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=16, rays_per_block=2048, use_denoiser=False)
    cam = rt.Camera(0.9, 2.0, -3.0)
    tabs = tc.build_cand_tables(dt, cam, cfg)
    assert tabs is not None and tabs.dist_ordered and dt.n_sub % 64 != 0
    kern = tc.trace_sums_flat(dt, cam, cfg, 4, 0, size * size, tabs)
    full = tc.trace_sums_flat(dt, cam, cfg, 4, 0, size * size, None)
    torch.cuda.synchronize()
    for a, b in zip(kern, full):
        assert torch.equal(a, b)
    plain = tc.trace_sums_plain(dt, cam, cfg, 4, 0, size * size)
    _assert_parity(_images(plain, size, size, cfg), _images(full, size, size, cfg))


def test_trace_kernel_info(cuda):
    """Each instantiation built within its launch bounds: registers for at
    least seven 128-thread blocks per SM, a few hundred bytes of local memory
    at most (ptxas spills in shading, not in the walks), and as static
    shared memory the warps' piece buffers (4 warps x 2 pieces x 1152
    bytes) and the threads' sums and portal chains (10 floats each)."""
    info = tc.trace_kernel_info()
    assert [i["name"] for i in info] == list(tc.KERNEL_INSTANCES)
    for i in info:
        assert 0 < i["registers"] <= 72 and i["block_threads"] == 128
        assert i["static_smem_bytes"] == 4 * 2 * 1152 + 10 * 128 * 4
        assert i["dynamic_smem_bytes"] == 0
        assert i["blocks_per_sm"] >= 7 and i["local_bytes"] <= 256


def test_wrapper_rejects_bad_tables(cuda):
    size = 64
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, size, size)), device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=16, rays_per_block=2048, use_denoiser=False)
    tabs = tc.build_cand_tables(dt, rt.Camera(), cfg)
    bad = tc.CandTables(tabs.ids.to(torch.int64), tabs.counts)
    with pytest.raises(ValueError):
        tc.trace_sums_flat(dt, rt.Camera(), cfg, 0, 0, size * size, bad)


# ---------------------------------------------------------------------------
# dense scenes: distance-ordered lists, horizon fallback, chunk lists
# ---------------------------------------------------------------------------


def _strokes_xml(size):
    """90 random strokes of one cubic each, junctions everywhere."""
    g = torch.Generator().manual_seed(7)

    def rand(lo, hi, n=1):
        return (lo + (hi - lo) * torch.rand(n, generator=g)).tolist()

    curves = []
    for _ in range(90):
        x, y = rand(0.08 * size, 0.9 * size, 2)
        pts = [(x, y)]
        for _ in range(3):
            dx, dy = rand(-0.125 * size, 0.125 * size, 2)
            x, y = x + dx, y + dy
            pts.append((x, y))
        cols = [tuple(int(c) for c in rand(0, 255, 3)) for _ in range(4)]
        curves.append(_curve_xml(pts, (cols[0], cols[1]), (cols[2], cols[3]),
                                 tuple(rand(0.5, 2.0, 2))))
    return _document(size, size, curves)


def _strands_xml(size):
    """40 parallel strands of one cubic each, none crossing."""
    curves = []
    for i in range(40):
        x = (4 + 1.4 * i) / 64.0 * size
        pts = [(x, f * size) for f in (0.03, 0.34, 0.66, 0.97)]
        curves.append(_curve_xml(
            pts, (((i * 37) % 256, (i * 91) % 256, 200),) * 2,
            ((200, (i * 53) % 256, (i * 17) % 256),) * 2, (0.5, 1.5)))
    return _document(size, size, curves)


def _dense_case(cuda, name, w, h):
    if name == "strokes":
        xml, k = _strokes_xml(w), 8
    elif name == "strands":
        xml, k = _strands_xml(w), 8
    else:
        xml, k = dense_scene_xml(0, w, h, name), 16
    return rt.build_device_scene(rt.load_scene_from_string(xml), flatten_subdivisions=k,
                                 device=cuda)


def _assert_dense(dt, cam, cfg, frame, px_start, n_px, want_kind, fallback=True,
                  wedge_shift=None):
    """Kernel with the scene's tables == kernel full sweep, bitwise; vs the
    plain version under assert_parity; the walk's counters make sense.
    ``wedge_shift``: build_cand_tables'; None takes the frame's rule."""
    w = dt.width
    assert tc.accel_kind(dt, cfg, n_px, wedge_shift) == want_kind
    tabs = tc.build_cand_tables(dt, cam, cfg, px_start, n_px, wedge_shift=wedge_shift)
    assert tabs.dist_ordered and tc.seg_max_count(dt, tabs) is None
    if want_kind == "chunk":
        assert tabs.ids is None
    elif fallback:
        assert int(tabs.counts.max()) > tabs.ids.shape[-1], "premise: a list overflows"
    tc.reset_launch_count()
    kern = tc.trace_sums_flat(dt, cam, cfg, frame, px_start, n_px, tabs)
    assert tc.LAUNCHES == 1
    full = tc.trace_sums_flat(dt, cam, cfg, frame, px_start, n_px, None)
    torch.cuda.synchronize()
    for a, b in zip(kern, full):
        assert torch.equal(a, b)
    assert float(kern[1].sum()) > 0.0
    plain = tc.trace_sums_plain(dt, cam, cfg, frame, px_start, n_px, tabs)
    rows = n_px // w
    _assert_parity(_images(plain, rows, w, cfg), _images(kern, rows, w, cfg))
    stats = tc.trace_walk_stats(dt, cam, cfg, frame, px_start, n_px, tabs)
    assert 0 < stats["live_rays"] <= n_px * cfg.rays_per_pixel
    assert stats["clean_hits"] + stats["grazes"] <= stats["live_rays"]
    if want_kind == "seg":
        assert 0 < stats["list_slots"] <= stats["live_rays"] * tabs.ids.shape[-1]
    if fallback:
        assert stats["fallback_rays"] > 0 and stats["chunks"] >= stats["fallback_rays"]
        assert stats["chunk_pairs"] <= stats["chunks"] * tc.SEG_CHUNK
    # a warp walks its list as long as its longest walk
    assert stats["list_slots"] <= stats["warp_slots"] <= 32 * stats["list_slots"]
    return stats


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name", ["strokes", "strands"])
def test_dense_lists_match_full_sweep_and_plain(cuda, name, exact):
    size = 256
    dt = _dense_case(cuda, name, size, size)
    assert dt.s_pad > tc._cand_len_for(dt.s_pad) == 256
    cfg = rt.RenderConfig(rays_per_pixel=64, use_denoiser=False, exact_silhouettes=exact)
    # the strands' lists hold every passing segment at this size: the list
    # walk and its exit alone; the strokes overflow into the chunk lists
    _assert_dense(dt, rt.Camera(0.9, 3.0, -5.0), cfg, 3, 0, size * size, "seg",
                  fallback=name == "strokes")


@pytest.mark.parametrize("cand_len", [1, 31, 32, 33, 65])
def test_dense_lists_at_piece_boundaries(cuda, monkeypatch, cand_len):
    """Capped distance-ordered lists of 1, 31, 32, 33 and 65 slots (around
    the 32-slot pieces the warp stages): nearly every cell overflows, so
    rays leave their list at every slot, at the end of a piece or past the
    list into the chunk walk, on a scene whose n_sub is no multiple of 64
    (a short last chunk)."""
    size = 256
    dt = _dense_case(cuda, "strokes", size, size)
    assert dt.n_sub % tc.SEG_CHUNK != 0
    monkeypatch.setattr(tc, "_cand_len_for", lambda s_pad: cand_len)
    cfg = rt.RenderConfig(rays_per_pixel=64, use_denoiser=False)
    stats = _assert_dense(dt, rt.Camera(0.9, 3.0, -5.0), cfg, 3, 0, size * size, "seg")
    assert stats["list_slots"] <= stats["live_rays"] * cand_len


@pytest.mark.parametrize("w,h,row0,rows", [
    (256, 256, 64, 128),   # whole tiles, px_start > 0
    (200, 136, 32, 72),    # ragged tiles in both directions, px_start > 0
])
def test_dense_lists_on_a_band(cuda, w, h, row0, rows):
    dt = _dense_case(cuda, "lady_bug", w, h)
    assert 1024 < dt.s_pad <= 1536
    cfg = rt.RenderConfig(rays_per_pixel=64, use_denoiser=False)
    _assert_dense(dt, rt.Camera(zoom_factor=0.9), cfg, 1, row0 * w, rows * w, "seg")


def test_dense_block_geometry_scene(cuda):
    """Past 4096 sub-segments: 2-sample wedges, 1024-ray blocks, 4-level
    lists."""
    w, h = 240, 136
    dt = _dense_case(cuda, "dolphin", w, h)
    assert dt.s_pad > tc.DENSE_SPAD and tc._cand_len_for(dt.s_pad) == 512
    cfg = rt.RenderConfig(rays_per_pixel=16, use_denoiser=False)
    assert tc._grid_geom(dt, cfg, w, w * h)[2] == 2
    _assert_dense(dt, rt.Camera(), cfg, 0, 0, w * h, "seg")


def test_chunk_lists_alone(cuda):
    """More than 64 wedges at wedge shift 0: no segment lists, the chunk
    walk from an empty state."""
    size = 128
    dt = _dense_case(cuda, "lady_bug", size, size)
    cfg = rt.RenderConfig(rays_per_pixel=512, use_denoiser=False)
    stats = _assert_dense(dt, rt.Camera(), cfg, 2, 0, size * size, "chunk", wedge_shift=0)
    assert stats["list_slots"] == 0


# ---------------------------------------------------------------------------
# wedge-coarsened tables: 2^shift adjacent wedges share one table entry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rpp,shift", [(512, 1), (1024, 2)])
def test_coarse_slot_lists_equal_full_sweep_and_plain(cuda, rpp, shift):
    size = 128
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(1, size, size)),
                               device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=rpp, use_denoiser=False)
    cam = rt.Camera(0.8, 3.0, -5.0)
    assert tc.table_layout(dt, cfg) == ("seg", shift)
    tabs = tc.build_cand_tables(dt, cam, cfg)
    gl = tc.seg_max_count(dt, tabs)
    n_wedges = tc._grid_geom(dt, cfg, size, size * size)[3]
    assert tabs.ids.shape[1] == n_wedges >> shift and gl < tabs.ids.shape[-1]
    tc.reset_launch_count()
    kern = tc.trace_sums_flat(dt, cam, cfg, 3, 0, size * size, tabs, gl)
    assert tc.LAUNCHES == 1
    full = tc.trace_sums_flat(dt, cam, cfg, 3, 0, size * size, None)
    torch.cuda.synchronize()
    for a, b in zip(kern, full):
        assert torch.equal(a, b)
    plain = tc.trace_sums_plain(dt, cam, cfg, 3, 0, size * size, tabs)
    _assert_parity(_images(plain, size, size, cfg), _images(kern, size, size, cfg))


@pytest.mark.parametrize("name,rpp", [("lady_bug", 512), ("strokes", 1024)])
def test_coarse_dense_lists_equal_full_sweep_and_plain(cuda, name, rpp):
    """Capped distance-ordered coarse lists with the horizon fallback into
    coarse chunk lists."""
    size = 128
    dt = _dense_case(cuda, name, size, size)
    cfg = rt.RenderConfig(rays_per_pixel=rpp, use_denoiser=False)
    assert tc.table_layout(dt, cfg)[1] > 0
    _assert_dense(dt, rt.Camera(zoom_factor=1.5), cfg, 1, 0, size * size, "seg",
                  fallback=name == "strokes")


def test_coarse_lists_on_a_4k_band(cuda):
    """BASELINE config 5's launch shape on its last tile row: the seeded
    scene at 3840x2160 x 1024 rpp, tables of wedge shift 2 built for the
    band (ray ids past 2^32); kernel == full sweep bitwise, vs plain under
    assert_parity."""
    w, h, rows = 3840, 2160, 16
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, w, h)), device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=1024, use_denoiser=False)
    assert tc.table_layout(dt, cfg) == ("seg", 2)
    px0 = (h - rows) * w
    assert px0 * cfg.rays_per_pixel > 2**32
    cam = rt.Camera()
    tabs = tc.build_cand_tables(dt, cam, cfg, px0, rows * w)
    gl = tc.seg_max_count(dt, tabs)
    kern = tc.trace_sums_flat(dt, cam, cfg, 4, px0, rows * w, tabs, gl)
    full = tc.trace_sums_flat(dt, cam, cfg, 4, px0, rows * w, None)
    torch.cuda.synchronize()
    for a, b in zip(kern, full):
        assert torch.equal(a, b)
    plain = tc.trace_sums_plain(dt, cam, cfg, 4, px0, rows * w, tabs)
    _assert_parity(_images(plain, rows, w, cfg), _images(kern, rows, w, cfg))


def test_wrapper_rejects_tables_of_another_wedge_count(cuda):
    size = 64
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, size, size)), device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=512, use_denoiser=False)
    tabs = tc.build_cand_tables(dt, rt.Camera(), cfg)
    odd = tc.CandTables(tabs.ids[:, :48].contiguous(), tabs.counts[:, :48].contiguous())
    with pytest.raises(ValueError, match="do not coarsen"):
        tc.trace_sums_flat(dt, rt.Camera(), cfg, 0, 0, size * size, odd)


def test_dense_tables_without_the_key_guard_launch(cuda):
    """The JAX package's tables (distance bounds) go through the same
    kernel; its exits are then exact only up to rays that graze a far chord
    nearly parallel, so the bar is assert_parity, not bit equality."""
    size = 256
    dt = _dense_case(cuda, "strands", size, size)
    cfg = rt.RenderConfig(rays_per_pixel=64, use_denoiser=False)
    tabs = tc.build_cand_tables(dt, rt.Camera(), cfg, key_guard=False)
    kern = tc.trace_sums_flat(dt, rt.Camera(), cfg, 0, 0, size * size, tabs)
    full = tc.trace_sums_flat(dt, rt.Camera(), cfg, 0, 0, size * size, None)
    _assert_parity(_images(full, size, size, cfg), _images(kern, size, size, cfg))


def _event_ms(fn, reps=3):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


@pytest.mark.parametrize("kind,rpp", [("lady_bug", 256), ("dolphin", 64), ("lady_bug", 8)])
def test_distance_bounds_alone_differ_from_the_guarded_launch_at_full_size(cuda, kind, rpp):
    """What the key guard buys and costs on the generated dense scenes at
    1920x1088: the same launch over the JAX package's tables (bounds of the
    distance) misses far chords that a ray grazes nearly parallel, so some
    pixels differ from the guarded launch, which equals the full sweep bit
    for bit.  Prints (``-s``) the differing pixels, the slots tested per ray
    and the time of both launches."""
    w, h = 1920, 1088
    n_px = w * h
    dt = _dense_case(cuda, kind, w, h)
    cfg = rt.RenderConfig(rays_per_pixel=rpp)
    cam = rt.Camera()
    row = {}
    for label, guard in (("guarded", True), ("distance_bounds", False)):
        tabs = tc.build_cand_tables(dt, cam, cfg, key_guard=guard)
        ms, sums = _event_ms(lambda: tc.trace_sums_flat(dt, cam, cfg, 0, 0, n_px, tabs))
        st = tc.trace_walk_stats(dt, cam, cfg, 0, 0, n_px, tabs)
        live = max(st["live_rays"], 1)
        row[label] = dict(ms=ms, sums=sums, slots=st["list_slots"] / live,
                          pairs=(st["list_slots"] + st["chunk_pairs"]) / live,
                          fallback=st["fallback_rays"] / live)
        del tabs
    full = tc.trace_sums_flat(dt, cam, cfg, 0, 0, n_px, None)
    a, b = row["guarded"]["sums"], row["distance_bounds"]["sums"]
    for x, y in zip(a, full):
        assert torch.equal(x, y)
    differ = (a[0] != b[0]).any(dim=1) | (a[1] != b[1]) | (a[2] != b[2])
    (img_a, _), (img_b, _) = _images(a, h, w, cfg), _images(b, h, w, cfg)
    d = (img_a - img_b).abs()
    print(f"\n[distance_bounds:{kind}:{rpp}rpp] card={torch.cuda.get_device_name(0)} "
          f"differing_pixels={int(differ.sum())} pixels={n_px} max_abs_diff={float(d.max()):.3e} "
          f"share_above_1e3={float((d > 1e-3).float().mean()):.3e} "
          + " ".join(f"{k}_ms={v['ms']:.3f} {k}_slots_per_ray={v['slots']:.2f} "
                     f"{k}_pairs_per_ray={v['pairs']:.2f} {k}_fallback_share={v['fallback']:.5f}"
                     for k, v in row.items()))
    if rpp > 8:  # measured there; at two wedges only reported
        assert int(differ.sum()) > 0
    assert row["distance_bounds"]["slots"] < row["guarded"]["slots"]


def test_dense_frame_with_the_unet(cuda):
    w, h = 192, 128
    dt = _dense_case(cuda, "lady_bug", w, h)
    cfg = rt.RenderConfig(rays_per_pixel=32)
    net = rt.net_for_params(rt.load_params(WEIGHTS), device=cuda)
    tabs = rt.build_cand_tables(dt, rt.Camera(), cfg)
    st = rt.init_frame_state(w, h, device=cuda)
    tc.reset_launch_count()
    cc.reset_launch_count()
    for _ in range(2):
        img, st = rt.render_frame(dt, rt.Camera(), st, cfg, denoiser=net, cand_tables=tabs,
                                  gather_len=rt.seg_max_count(dt, tabs))
    assert tc.LAUNCHES == 2 and cc.LAUNCHES == 18
    assert img.shape == (h, w, 4) and torch.isfinite(img).all() and st.flow_is_zero


def test_wrapper_rejects_bad_dense_tables(cuda):
    dt = _dense_case(cuda, "strands", 64, 64)
    cfg = rt.RenderConfig(rays_per_pixel=16, use_denoiser=False)
    tabs = tc.build_cand_tables(dt, rt.Camera(), cfg)
    with pytest.raises(ValueError, match="scene circle"):
        tc.trace_sums_flat(dt, rt.Camera(), cfg, 0, 0, 64 * 64, tabs._replace(circle=None))
    with pytest.raises(ValueError, match="cand lbs"):
        tc.trace_sums_flat(dt, rt.Camera(), cfg, 0, 0, 64 * 64,
                           tabs._replace(lbs=tabs.lbs.double()))
    with pytest.raises(ValueError, match="distance-ordered"):
        tc.trace_walk_stats(dt, rt.Camera(), cfg, 0, 0, 64 * 64, tc.CandTables(tabs.ids, tabs.counts))


# ---------------------------------------------------------------------------
# 3x3 convolution kernel
# ---------------------------------------------------------------------------

BF = torch.bfloat16


def _conv_case(device, seed, h, w, cins, cout, ups):
    g = torch.Generator().manual_seed(seed)
    xs = [torch.randn((h >> int(u), w >> int(u), c), generator=g).to(BF).to(device)
          for c, u in zip(cins, ups)]
    ks = [(torch.randn((3, 3, c, cout), generator=g) * 0.1).to(BF).to(device) for c in cins]
    b = torch.randn((cout,), generator=g).to(BF).to(device)
    return xs, ks, b


def _assert_conv_close(ref, got, b):
    ref, got = ref.float(), got.float()
    assert ref.shape == got.shape and torch.isfinite(got).all()
    assert float((ref == got).float().mean()) >= 0.99
    step = 2.0**-7 * (2.0 * torch.maximum(ref.abs(), got.abs()) + b.float().abs())
    assert bool(((ref - got).abs() <= step).all())


@pytest.mark.parametrize("h,w,cins,cout,stride,relu,ups", [
    (37, 50, (11,), 24, 1, True, (False,)),       # unaligned Cin, ragged tiles
    (64, 96, (24,), 48, 2, True, (False,)),       # stride 2, even size: pads (0, 1)
    (33, 41, (48,), 96, 2, True, (False,)),       # stride 2, odd size: pads (1, 1)
    (40, 64, (96, 48), 48, 1, True, (True, False)),  # dec1: [up(e2), e1]
    (40, 64, (48, 24), 24, 1, True, (True, False)),  # dec0: [up(d1), e0]
    (35, 70, (24,), 3, 1, False, (False,)),       # out: 3 channels, no ReLU
    (20, 33, (28,), 28, 1, True, (False,)),       # widths of weights/denoiser.msgpack
    (16, 32, (8, 16, 8), 12, 1, False, (False, False, False)),  # three groups
    (24, 40, (44,), 96, 1, True, (False,)),       # conv3x3_same's 44 -> 96: plain loads
    (3, 5, (24,), 24, 1, True, (False,)),         # image smaller than one tile
    (1, 37, (48,), 48, 1, True, (False,)),        # one row high
    (37, 53, (24,), 48, 2, True, (False,)),       # stride 2, odd size, ragged tiles
    (18, 22, (48, 24), 24, 2, True, (True, False)),  # stride 2 over an upsampled group
    (20, 24, (16,), 136, 1, True, (False,)),      # Cout > 96: 96-channel slices
])
def test_conv_kernel_matches_plain(cuda, h, w, cins, cout, stride, relu, ups):
    xs, ks, b = _conv_case(cuda, h * w, h, w, cins, cout, ups)
    cc.reset_launch_count()
    got = cc.conv3x3(xs, ks, b, stride, relu, ups)
    assert cc.LAUNCHES == 1
    torch.cuda.synchronize()
    ref = cc.conv3x3_plain(xs, ks, b, stride, relu, ups)
    assert cc.LAUNCHES == 1
    assert got.dtype == BF and got.is_contiguous()
    _assert_conv_close(ref, got, b)


@pytest.mark.parametrize("offset", [1, 4])
def test_conv_kernel_at_unaligned_storage(cuda, offset):
    """Contiguous inputs and kernels at a storage offset of ``offset`` bf16
    values (2 or 8 bytes): no 16-byte copies, plain loads."""
    h, w, cins, cout = 21, 35, (48, 24), 48
    xs, ks, b = _conv_case(cuda, 7, h, w, cins, cout, (False, False))

    def shifted(t):
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        s = buf[offset:].view(t.shape)
        s.copy_(t)
        assert s.is_contiguous() and s.data_ptr() % 16 != 0
        return s

    xs_u, ks_u = [shifted(x) for x in xs], [shifted(k) for k in ks]
    got = cc.conv3x3(xs_u, ks_u, b, 1, True, (False, False))
    torch.cuda.synchronize()
    assert torch.equal(got, cc.conv3x3(xs, ks, b, 1, True, (False, False)))
    _assert_conv_close(cc.conv3x3_plain(xs, ks, b, 1, True, (False, False)), got, b)


def test_conv_kernel_instances(cuda):
    """Every instantiation built, with its tile.  The two held to three
    blocks per SM (NP 48 and 96 at stride 1, within 168 registers) may keep
    a register or two in local memory; the others none."""
    inst = cc.kernel_instances()
    assert sorted({(i["np"], i["stride"]) for i in inst}) == [
        (n, s) for n in (8, 24, 32, 48, 96) for s in (1, 2)]
    for i in inst:
        bounded = i["stride"] == 1 and i["np"] in (48, 96)
        assert i["tile_cols"] == 16 and 0 < i["registers"] <= (168 if bounded else 255)
        assert i["local_bytes"] <= (16 if bounded else 0)


def test_conv3x3_same_entry(cuda):
    """The one-group entry (the JAX package's conv3x3_same): float32
    operands are cast to bf16."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((23, 37, 11), generator=g).to(cuda)
    k = (torch.randn((3, 3, 11, 24), generator=g) * 0.1).to(cuda)
    b = torch.randn((24,), generator=g).to(cuda)
    got = cc.conv3x3_same(x, k, b)
    ref = cc.conv3x3_plain([x.to(BF)], [k.to(BF)], b.to(BF))
    _assert_conv_close(ref, got, b.to(BF))


def test_conv_wrapper_rejects_non_contiguous(cuda):
    xs, ks, b = _conv_case(cuda, 1, 16, 16, (16,), 8, (False,))
    with pytest.raises(ValueError, match="contiguous"):
        cc.conv3x3([xs[0][:, :, :8]], [ks[0][:, :, :8]], b)


def test_unet_kernel_route_matches_plain_route(cuda):
    net = rt.net_for_params(rt.load_params(WEIGHTS), device=cuda)
    g = torch.Generator().manual_seed(5)
    h, w = 64, 96
    img = torch.cat([torch.rand((h, w, 3), generator=g), torch.ones(h, w, 1)], -1).to(cuda)
    prev = torch.cat([torch.rand((h, w, 3), generator=g), torch.ones(h, w, 1)], -1).to(cuda)
    bmap = torch.rand((h, w), generator=g).to(cuda)
    cc.reset_launch_count()
    a = rt.apply_denoiser(net, img, prev, bmap, noise=0.35, frame=1)
    assert cc.LAUNCHES == 9
    b = dn._apply_denoiser(net, img, prev, bmap, 1.0, 0.35, 1, cc.conv3x3_plain)
    assert cc.LAUNCHES == 9
    d = (a - b).abs()
    assert float(d.max()) < 1e-2 and float(d.mean()) < 1e-4


def test_denoised_frame_on_the_card(cuda):
    size = 64
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, size, size)),
                               device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=8, rays_per_block=2048)
    net = rt.net_for_params(rt.load_params(WEIGHTS), device=cuda)
    st = rt.init_frame_state(size, size, device=cuda)
    cc.reset_launch_count()
    for _ in range(2):
        img, st = rt.render_frame(dt, rt.Camera(), st, cfg, denoiser=net)
    assert cc.LAUNCHES == 18
    assert img.shape == (size, size, 4) and torch.isfinite(img).all() and st.flow_is_zero


# ---------------------------------------------------------------------------
# the bilateral kernel
# ---------------------------------------------------------------------------


def _assert_bilateral_bitwise(img, bf16_weights=True):
    """One launch of the kernel, bitwise the plain version on the same card."""
    bc.reset_launch_count()
    got = tden.spatial_bilateral(img, bf16_weights)
    assert bc.LAUNCHES == 1
    want = tden.spatial_bilateral_plain(img, bf16_weights)
    torch.cuda.synchronize()
    assert got.shape == img.shape and got.is_contiguous()
    assert torch.equal(got, want), float((got - want).abs().max())


def _bilateral_image(shape, seed, device):
    """Smooth fields, noise of several scales, flat patches (equal weights)
    and values quantized to 1/64 (ties in the bf16 chain)."""
    g = torch.Generator().manual_seed(seed)
    img = 0.5 + 0.1 * torch.randn(shape, generator=g)
    img = img * torch.exp(2.0 * torch.randn(shape[:-1] + (1,), generator=g))
    flat = torch.rand(shape[:-1] + (1,), generator=g) < 0.2
    img = torch.where(flat, torch.full_like(img, 0.75), img)
    quant = torch.rand(shape[:-1] + (1,), generator=g) < 0.3
    img = torch.where(quant, torch.round(img * 64.0) / 64.0, img)
    return img.to(device)


@pytest.mark.parametrize("bf16_weights", [True, False], ids=["bf16", "float32"])
def test_bilateral_kernel_on_a_rendered_frame(cuda, bf16_weights):
    """The arch1080_8rpp_unet frame (the seeded arch class at 1920x1080, 8
    rays per pixel), read through the main path's [..., :3] view of the
    (H, W, 4) image."""
    w, h = 1920, 1080
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, w, h)), device=cuda)
    raw, _ = rt.trace_image(dt, rt.Camera(), rt.RenderConfig(rays_per_pixel=8), 0)
    assert raw.shape == (h, w, 4)
    _assert_bilateral_bitwise(raw[..., :3], bf16_weights)


@pytest.mark.parametrize("bf16_weights", [True, False], ids=["bf16", "float32"])
@pytest.mark.parametrize("kind", ["c3", "c4", "view_of_c4", "transposed", "c8"])
def test_bilateral_kernel_on_random_images(cuda, kind, bf16_weights):
    h, w = 70, 101  # ragged against the kernel's 16 x 32 tiles
    if kind == "c3":
        img = _bilateral_image((h, w, 3), 1, cuda)
    elif kind == "c4":
        img = _bilateral_image((h, w, 4), 2, cuda)
    elif kind == "view_of_c4":
        img = _bilateral_image((h, w, 4), 3, cuda)[..., :3]
    elif kind == "transposed":
        img = _bilateral_image((w, h, 3), 4, cuda).transpose(0, 1)
    else:
        img = _bilateral_image((h, w, 8), 5, cuda)
    _assert_bilateral_bitwise(img, bf16_weights)


@pytest.mark.parametrize("bf16_weights", [True, False], ids=["bf16", "float32"])
def test_bilateral_kernel_on_the_training_batch(cuda, bf16_weights):
    """32 crops of 64 x 64, the training path's batch (leading axis)."""
    _assert_bilateral_bitwise(_bilateral_image((32, 64, 64, 3), 6, cuda), bf16_weights)


@pytest.mark.parametrize("h,w", [(1, 1), (1, 9), (2, 40), (3, 3), (4, 70), (37, 1), (50, 2),
                                 (9, 4)])
def test_bilateral_kernel_on_thin_frames(cuda, h, w):
    """Frames of 1 to 4 rows or columns: the replicate padding covers the
    whole window."""
    _assert_bilateral_bitwise(_bilateral_image((h, w, 3), h * 100 + w, cuda))
    _assert_bilateral_bitwise(_bilateral_image((h, w, 4), h * 100 + w, cuda)[..., :3], False)


def test_bilateral_kernel_keeps_constants_exact(cuda):
    img = torch.full((33, 45, 4), 0.8, device=cuda)
    assert torch.equal(tden.spatial_bilateral(img), img)
    assert torch.equal(tden.spatial_bilateral(img[..., :3]), img[..., :3])


@pytest.mark.parametrize("learned", [True, False], ids=["unet", "analytic"])
def test_one_bilateral_launch_a_denoised_frame(cuda, learned):
    size = 64
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, size, size)),
                               device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=8, rays_per_block=2048)
    net = rt.net_for_params(rt.load_params(WEIGHTS), device=cuda) if learned else None
    st = rt.init_frame_state(size, size, device=cuda)
    img, st = rt.render_frame(dt, rt.Camera(), st, cfg, denoiser=net)
    bc.reset_launch_count()
    img, st = rt.render_frame(dt, rt.Camera(), st, cfg, denoiser=net)
    assert bc.LAUNCHES == 1
    torch.cuda.synchronize()
    assert torch.isfinite(img).all()


# ---------------------------------------------------------------------------
# the blur kernel
# ---------------------------------------------------------------------------


def _assert_blur_bitwise(img, sigma, radius, halo=(0, 0)):
    """One launch of the kernel, bitwise the plain version on the same card."""
    tbc.reset_launch_count()
    got = tblur.variable_gaussian_blur(img, sigma, radius, halo)
    assert tbc.LAUNCHES == 1
    want = tblur.variable_gaussian_blur_plain(img, sigma, radius, halo)
    torch.cuda.synchronize()
    top, bottom = halo
    assert got.shape == (img.shape[0] - top - bottom, *img.shape[1:]) and got.is_contiguous()
    assert torch.equal(got, want), float((got - want).abs().max())
    return got


def _blur_inputs(shape, radius, seed, device, sigma_scale=1.0):
    """An image of noise around 0.5 and a sigma map uniform in [0, radius / 3]
    (times ``sigma_scale``), a fifth of it 0."""
    g = torch.Generator().manual_seed(seed)
    img = 0.5 + 0.2 * torch.randn(shape, generator=g)
    sigma = sigma_scale * radius / 3.0 * torch.rand(shape[:2], generator=g)
    sigma = torch.where(torch.rand(shape[:2], generator=g) < 0.2, 0.0, sigma)
    return img.to(device), sigma.to(device)


def test_blur_kernel_on_a_rendered_frame(cuda):
    """The arch1080_8rpp_unet frame (the seeded arch class at 1920x1080, 8
    rays per pixel) with its own blur map and radius: the main path's
    shape."""
    w, h = 1920, 1080
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, w, h)), device=cuda)
    raw, bmap = rt.trace_image(dt, rt.Camera(), rt.RenderConfig(rays_per_pixel=8), 0)
    radius = tblur.blur_radius(dt.max_blur)
    assert radius == 6 and float(bmap.max()) > 0.0
    _assert_blur_bitwise(raw, bmap, radius)


@pytest.mark.parametrize("h,w,radius", [(1080, 1920, 6), (1024, 1024, 6), (70, 101, 0),
                                        (70, 101, 1), (70, 101, 24), (300, 50, 65),
                                        (1200, 40, 300)],
                         ids=["1080p", "1024sq", "radius0", "radius1", "radius24",
                              "past_the_tallest_tile", "narrowed_tile"])
def test_blur_kernel_on_random_frames(cuda, h, w, radius):
    """Radius 65 is past the tallest tile (64 rows) and its rows pass 48 KB of
    shared memory; radius 300 halves the tile to 1 row and 16 columns."""
    img, sigma = _blur_inputs((h, w, 4), radius, h + w + radius, cuda)
    got = _assert_blur_bitwise(img, sigma, radius)
    if radius == 0:
        assert torch.equal(got, img)


@pytest.mark.parametrize("kind", ["past_the_radius", "all_zero"])
def test_blur_kernel_sigma_maps(cuda, kind):
    """A map whose ceil(3 sigma) exceeds the radius (the taps stop at the
    radius), and an all-zero map (the image back, exactly)."""
    radius = 6
    img, sigma = _blur_inputs((90, 130, 4), radius, 7, cuda, sigma_scale=2.5)
    if kind == "all_zero":
        sigma = torch.zeros_like(sigma)
    got = _assert_blur_bitwise(img, sigma, radius)
    if kind == "all_zero":
        assert torch.equal(got, img)
    else:
        assert float(torch.ceil(3.0 * sigma).max()) > radius


@pytest.mark.parametrize("kind", ["transposed", "channel_view", "unaligned", "c3", "c1"])
def test_blur_kernel_on_views(cuda, kind):
    """Inputs the kernel reads by their strides, one float at a time: views
    that are not contiguous, a base off 16 bytes, fewer than 4 channels."""
    h, w, radius = 70, 101, 6
    if kind == "transposed":
        img, sigma = _blur_inputs((w, h, 4), radius, 1, cuda)
        img, sigma = img.transpose(0, 1), sigma.t()
    elif kind == "channel_view":
        img, sigma = _blur_inputs((h, w, 6), radius, 2, cuda)
        img = img[..., 1:5]
    elif kind == "unaligned":
        img, sigma = _blur_inputs((h, w, 4), radius, 3, cuda)
        img = torch.empty(h * w * 4 + 1, device=cuda)[1:].view(h, w, 4).copy_(img)
    else:
        img, sigma = _blur_inputs((h, w, 3 if kind == "c3" else 1), radius, 4, cuda)
    assert kind in ("c3", "c1") or not img.is_contiguous() or img.data_ptr() % 16
    _assert_blur_bitwise(img, sigma, radius)


def test_blur_kernel_on_4k_bands(cuda):
    """The arch4k_still_4chip cell's bands: 3840x2160 in four bands of 540
    rows, each on its rows plus the 6-row halo the exchange gives (0/6, 6/6,
    6/6, 6/0), bitwise the whole frame's rows, and the whole frame bitwise
    the plain version."""
    h, w, radius = 2160, 3840, 6
    img, sigma = _blur_inputs((h, w, 4), radius, 11, cuda)
    whole = _assert_blur_bitwise(img, sigma, radius)
    rows, halos = h // 4, []
    for r0 in range(0, h, rows):
        (ri, top, bottom), (rs, _, _) = (_band_region(t, r0, rows, radius) for t in (img, sigma))
        halos.append((top, bottom))
        got = _assert_blur_bitwise(ri, rs, radius, (top, bottom))
        assert torch.equal(got, whole[r0 : r0 + rows]), r0
    assert halos == [(0, 6), (6, 6), (6, 6), (6, 0)]


@pytest.mark.parametrize("denoiser", ["unet", "analytic", "off"])
def test_one_blur_launch_a_frame(cuda, denoiser):
    size = 64
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, size, size)),
                               device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=8, rays_per_block=2048,
                          use_denoiser=denoiser != "off")
    net = rt.net_for_params(rt.load_params(WEIGHTS), device=cuda) if denoiser == "unet" else None
    st = rt.init_frame_state(size, size, device=cuda)
    img, st = rt.render_frame(dt, rt.Camera(), st, cfg, denoiser=net)
    tbc.reset_launch_count()
    img, st = rt.render_frame(dt, rt.Camera(), st, cfg, denoiser=net)
    assert tbc.LAUNCHES == 1
    torch.cuda.synchronize()
    assert torch.isfinite(img).all()


def _band_region(t, r0, rows, halo, align=1):
    """Rows [r0 - halo, r0 + rows + halo) of the whole-frame ``t``, widened
    to start and end on a multiple of ``align`` rows and cut at the frame's
    edges: (region, rows above, rows below), as the halo exchange of
    parallel/sharded.py assembles them from the neighbours."""
    start = max(0, (r0 - halo) // align * align)
    end = min(t.shape[0], -(-(r0 + rows + halo) // align) * align)
    return t[start:end], r0 - start, end - r0 - rows


@pytest.mark.parametrize("h,w,n", [(256, 192, 2), (256, 192, 16), (1088, 1920, 4),
                                   (1080, 1920, 4)],
                         ids=["two_bands", "bands_narrower_than_the_halo", "denoised_frame",
                              "bands_off_the_stride_grid"])
def test_band_tail_equals_the_whole_frames_rows(cuda, h, w, n):
    """The row-sharded tail on the card, with each band's halo rows cut from
    the whole frame on one process: the UNet on band + halo, widened to the
    frame's multiples of 4 rows (the conv kernel, 9 launches per band; bands
    of 270 rows start off the stride-2 grid), then the blur on band +
    radius, and the analytic pass on band + 2, each bitwise equal to the
    whole frame's rows."""
    net = rt.net_for_params(rt.load_params(WEIGHTS), device=cuda)
    g = torch.Generator().manual_seed(11)
    img = torch.cat([torch.rand((h, w, 3), generator=g), torch.ones(h, w, 1)], -1).to(cuda)
    prev = torch.cat([torch.rand((h, w, 3), generator=g), torch.ones(h, w, 1)], -1).to(cuda)
    bmap = (2.0 * torch.rand((h, w), generator=g)).to(cuda)
    radius = tblur.blur_radius(2.0)
    den = rt.apply_denoiser(net, img, prev, bmap, noise=0.35, frame=1)
    out = tblur.variable_gaussian_blur(den, bmap, radius)
    ana = rt.temporal_denoise(img, prev, None, 1, 1.0, flow_is_zero=True)
    halo, rows = dn.band_halo(net), h // n
    for r0 in range(0, h, rows):
        band = slice(r0, r0 + rows)
        (ri, top, bottom), (rp, _, _), (rb, _, _) = (
            _band_region(t, r0, rows, halo, dn.BAND_ALIGN) for t in (img, prev, bmap))
        cc.reset_launch_count()
        got = rt.apply_denoiser(net, ri, rp, rb, noise=0.35, frame=1, halo=(top, bottom))
        assert cc.LAUNCHES == 9 and torch.equal(got, den[band]), r0
        (rd, top, bottom), (rb, _, _) = (_band_region(t, r0, rows, radius) for t in (den, bmap))
        got = tblur.variable_gaussian_blur(rd, rb, radius, halo=(top, bottom))
        assert torch.equal(got, out[band]), r0
        ri, top, bottom = _band_region(img, r0, rows, 2)
        got = tden.temporal_blend(ri, prev[band], 1, 1.0, halo=(top, bottom))
        assert torch.equal(got, ana[band]), r0


# ---------------------------------------------------------------------------
# the world grid, the session and the viewer's quantization on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,rpp", [("seeded", 16), ("lady_bug", 64)])
@pytest.mark.parametrize("cam", [(0.75, 0.0, 0.0), (1.0, 37.5, -21.25)], ids=["zoomed", "panned"])
def test_grid_tables_equal_full_sweep(cuda, name, rpp, cam):
    """The kernel on tables selected from a world grid (superset lists:
    slot mode on the seeded scene, distance order with chunk lists on the
    lady_bug class) == its full sweep == the camera's own tables, bitwise."""
    w, h = 256, 192
    if name == "seeded":
        dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, w, h)),
                                   device=cuda)
    else:
        dt = _dense_case(cuda, name, w, h)
    cfg = rt.RenderConfig(rays_per_pixel=rpp, use_denoiser=False)
    grid = rt.build_cand_grid(dt, cfg, -1.5 * 0.75 * w, -1.5 * 0.75 * h, 1.5 * 0.75 * w,
                              1.5 * 0.75 * h, zoom_max=1.5)
    camera = rt.Camera(*cam)
    assert rt.grid_covers(grid, dt, camera, cfg)
    assert grid.tables.dist_ordered == (name != "seeded")
    n_px = w * h
    picked = rt.grid_tables(grid, dt, camera, cfg)
    own = rt.build_cand_tables(dt, camera, cfg)
    tc.reset_launch_count()
    a = tc.trace_sums_flat(dt, camera, cfg, 2, 0, n_px, picked, grid.gather_len)
    b = tc.trace_sums_flat(dt, camera, cfg, 2, 0, n_px, None)
    c = tc.trace_sums_flat(dt, camera, cfg, 2, 0, n_px, own, rt.seg_max_count(dt, own))
    torch.cuda.synchronize()
    assert tc.LAUNCHES == 3
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert float(a[1].sum()) > 0.0


def test_to_uint8_device_equals_to_uint8(cuda):
    from raytracingdiffusioncurves_torch.utils.image import to_uint8, to_uint8_device

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((1088, 1920, 4), generator=gen, device=cuda) * 0.7 + 0.5
    x[0, 0, 0], x[1, 1, 1], x[2, 2, 2] = float("nan"), float("inf"), -float("inf")
    for flip in (True, False):
        q = to_uint8_device(x, flip_vertical=flip)
        assert q.device.type == "cuda" and q.dtype == torch.uint8
        assert (q.cpu().numpy() == to_uint8(x.cpu().numpy(), flip_vertical=flip)).all()


def test_moving_session_frame_enqueues_without_a_host_sync(cuda):
    """A session's moving frame (the event, grid_covers, grid_tables, the
    frame with the UNet) queues on the card without waiting for it."""
    w, h = 256, 192
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, w, h)), device=cuda)
    net = rt.net_for_params(rt.load_params(WEIGHTS), device=cuda)
    s = rt.InteractiveSession(dt, rt.RenderConfig(rays_per_pixel=8), denoiser=net)
    s.render()  # builds the grid (a host sync: the largest count)
    s.render()  # resting: builds the camera's own tables
    grid = s.grid
    tc.reset_launch_count()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s.scroll(1.0)
        s.drag(12.0, -7.0)
        img = s.render(block=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert s.grid is grid and s.grid_builds == 1 and tc.LAUNCHES == 1
    assert img.shape == (h, w, 4) and torch.isfinite(img).all()


def _train_batch(device, n=8, size=64, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    target = torch.rand((n, size, size, 3), generator=gen)
    return {k: v.to(device) for k, v in {
        "noisy": target + 0.2 * torch.randn(target.shape, generator=gen),
        "warped_prev": torch.rand((n, size, size, 3), generator=gen),
        "aux": torch.rand((n, size, size, 2), generator=gen),
        "target": target,
    }.items()}


def test_training_forward_on_the_card(cuda):
    """The batched training forward (conv3x3_train through cuDNN, the
    batched bilateral) against the per-image inference forward on the plain
    convolution, on the card: the outputs of a bf16 residual, at most two
    bf16 steps of ~1 apart; the batched analytic baseline bitwise equal to
    the per-image one."""
    model, _, _ = dn.create_train_state(torch.Generator().manual_seed(0), 64, 64, arch="unet",
                                        device=cuda)
    b = _train_batch(cuda)
    with torch.no_grad():
        base = dn.analytic_baseline(b["noisy"], b["warped_prev"])
        loop = torch.stack([dn.analytic_baseline(n, p) for n, p in zip(b["noisy"], b["warped_prev"])])
        assert torch.equal(base, loop)
        got = model.forward_batch(b["noisy"], b["warped_prev"], b["aux"])
        want = model(b["noisy"], b["warped_prev"], b["aux"], conv=cc.conv3x3_plain)
    assert float((got - want).abs().max()) <= 2 * 2.0**-7


def test_train_step_on_the_card(cuda):
    """One train step on the card against the same step on the CPU from the
    same initial weights: losses within 1e-3 relative, gradients within 3e-2
    relative L2 per tensor (cuDNN's and oneDNN's bf16 convolutions sum in
    other orders), and the loss falls over 10 steps on the fixed batch."""
    b = _train_batch(cuda)
    m_c, s_c, o_c = dn.create_train_state(torch.Generator().manual_seed(0), 64, 64, arch="unet",
                                          device="cpu")
    m_g, s_g, o_g = dn.create_train_state(torch.Generator().manual_seed(0), 64, 64, arch="unet",
                                          device=cuda)
    l_c = dn.train_step(m_c, o_c, s_c, {k: v.cpu() for k, v in b.items()})
    l_g = dn.train_step(m_g, o_g, s_g, b)
    assert abs(float(l_g) - float(l_c)) <= 1e-3 * float(l_c)
    for (name, pc), pg in zip(m_c.named_parameters(), m_g.parameters()):
        g_c, g_g = pc.grad, pg.grad.cpu()
        assert float((g_g - g_c).norm()) <= 3e-2 * float(g_c.norm()), name
    first = float(l_g)
    for _ in range(10):
        loss = dn.train_step(m_g, o_g, s_g, b)
    assert float(loss) < first
