"""Row-band multi-device rendering of the port (``parallel/sharded.py``) on
the CPU: two gloo ranks, spawned once for the module (free port, a join
timeout of their own) to run ``torch_sharded_ranks.rank_work`` (no JAX in
the ranks), and four ranks once for the UNet's halo wider than a band
(``rank_work_wide_halo``), both also for the trace split by work
(``split_frames``), against one process and against the JAX package: its
``trace_image_sharded`` on its 8-device CPU mesh and its ``render_frame`` on
the same chained sequences (``jax_sequences``).

Bars.  The sharded path is bitwise equal to one process: each rank traces
its own band, or its range of the split by work, with the one-device code
(the RNG is keyed on the global ray id; the plain version's chunks lie on
the frame's pixel grid), hands traced rows to their bands, and
post-processes its band plus the halo rows its filters reach, which
the neighbours send as edge strips, with the one-device filters' band
entries.  That holds for the trace, the chained frames (blur, analytic and
learned denoiser, resting and moving: the history is warped whole and the
band kept), the band FrameState they carry, the hoisted per-band tables of a
dense capped-list scene, and the progressive pass; no case needed the
``apply_denoiser`` bar (the plain convolution's float32 products of a band
region round as the whole frame's), also on bands of 34 and 17 rows,
whose UNet regions are widened to the frame's multiples of 4 rows.  Against the JAX package, every
gathered frame and band state of the chained sequences (the UNet's zoom
steps, the 4-rank halo wider than a band, the band FrameState): the
trace alone and the frame with the denoiser off at assert_parity (fewer
than 3e-5 of values off by more than 1e-3, mean below 1e-4; pow rounding
and sum order); denoised frames at test_torch_renderer.py's bars, the
analytic one (max 5e-3, mean 1e-3) until the UNet has run and its learned
one (max 1e-2, fewer than 1% of values above 5e-3, mean 1e-3) from then
on, since the history carries the UNet's bf16 steps into every later
frame (measured on these sequences: max 7.8e-3, 0.57% above 5e-3, mean
9.3e-4).  The data-parallel train step (2 ranks x 2 examples)
against the one-process step on the 4: the loss within 1e-6 relative,
gradients within 2^-7 relative L2, parameters within 1e-6 for all but 1% of
values (the two differ in the order of float32 sums and in where the bf16
gradients are rounded; ``test_data_parallel_train_step`` says why each
bar).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import raytracingdiffusioncurves_torch as rt
import raytracingdiffusioncurves_tpu as rj
from raytracingdiffusioncurves_torch.models import denoiser as tdn
from raytracingdiffusioncurves_torch.ops import trace_cuda as tc
from raytracingdiffusioncurves_torch.parallel import sharded
from raytracingdiffusioncurves_torch.utils.scenes import seeded_scene_xml
from raytracingdiffusioncurves_tpu.models import denoiser as jdn
from raytracingdiffusioncurves_tpu.ops import flow as jflow
from raytracingdiffusioncurves_tpu.parallel import sharded as jsharded

from conftest import make_scene_xml, simple_curve
from test_torch_candidates_dense import strokes_xml
from test_torch_renderer import _assert_denoised_close
from test_torch_trace import assert_parity
from torch_sharded_ranks import (DENSE_CFG, FRAME_CFG, MOVES, PROG_CFG, ROOT, SPLIT_CAMERA,
                                 SPLIT_CFG, TRACE_CFG, WEIGHTS, fail_on_rank_1, move_config,
                                 new_model, rank_work, rank_work_wide_halo, scene, seeded,
                                 split_cost_ms, train_batch)

RANKS_TIMEOUT = 240.0


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this module (and one for each spawned rank),
    so that under the suite's parallel workers its ops do not spin against
    the other workers' threads.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def curve_xml(height=64):
    return make_scene_xml(
        [simple_curve([(10, 14), (30, 25), (40, 40), (50, 52)],
                      left=[(0, "250,40,10"), (10, "20,200,250")],
                      blur=[(0, 0.5), (10, 1.5)])],
        64, height)


@pytest.fixture(scope="module")
def ranks():
    xmls = {"curve": curve_xml(), "odd": curve_xml(63), "band6": curve_xml(68),
            "dense": strokes_xml()}
    return sharded.spawn_ranks(rank_work, 2, (xmls,), backend="gloo", timeout=RANKS_TIMEOUT)


@pytest.fixture(scope="module")
def one_process():
    """The seeded sequence on one process: frames 0-1 (analytic, hoisted
    tables), frame 2 (the UNet, a moved camera, flow zero), then MOVES;
    the images and the state after frame 2 and after the last."""
    dt = seeded()
    cfg = rt.RenderConfig(**FRAME_CFG)
    tabs = rt.build_cand_tables(dt, rt.Camera(), cfg)
    gl = rt.seg_max_count(dt, tabs)
    net = rt.net_for_params(rt.load_params(WEIGHTS), device="cpu")
    st = rt.init_frame_state(64, 64, device="cpu")
    frames = []
    for _ in range(2):
        img, st = rt.render_frame(dt, rt.Camera(), st, cfg, cand_tables=tabs, gather_len=gl)
        frames.append(img.numpy())
    img, st = rt.render_frame(dt, rt.Camera(1.1, 2.0, -1.0), st, cfg, denoiser=net)
    frames.append(img.numpy())
    after_2 = st
    moves = []
    for cam, zoom, kind in MOVES:
        if zoom is not None:
            st = dataclasses.replace(st, flow=rt.add_zoom_flow(st.flow, *zoom))
        img, st = rt.render_frame(dt, cam, st, move_config(kind),
                                  denoiser=net if kind == "unet" else None)
        moves.append(img.numpy())
    return {"frames": frames, "after_2": after_2, "moves": moves, "last": st, "net": net,
            "dt": dt}


# The chained sequences of the ranks, as MOVES: the 2-rank one (frames 0-1
# analytic, frame 2 the UNet at a moved camera, then MOVES) and the 4-rank
# one (frames 0-1 with the UNet, then MOVES).
SEQUENCE_2 = ([(rt.Camera(), None, "analytic")] * 2
              + [(rt.Camera(1.1, 2.0, -1.0), None, "unet")] + MOVES)
SEQUENCE_4 = [(rt.Camera(), None, "unet")] * 2 + MOVES


@pytest.fixture(scope="module")
def jax_sequences():
    """SEQUENCE_2 and SEQUENCE_4 through the JAX package's render_frame on
    the seeded scene (the shipped UNet's checkpoint, its zoom flow): for
    each, every frame's image and the state after it, as numpy."""
    dj = rj.build_device_scene(rj.load_scene_from_string(seeded_scene_xml(0, 64, 64)),
                               flatten_subdivisions=16)
    params = jdn.load_params(WEIGHTS)
    out = {}
    for name, steps in (("2", SEQUENCE_2), ("4", SEQUENCE_4)):
        sj = rj.init_frame_state(64, 64)
        frames = []
        for cam, zoom, kind in steps:
            if zoom is not None:
                sj = sj._replace(flow=jflow.add_zoom_flow(sj.flow, *zoom))
            cfg = rj.RenderConfig(**FRAME_CFG, **({"use_denoiser": False} if kind == "off"
                                                   else {}))
            img, sj = rj.render_frame(dj, rj.Camera(*dataclasses.astuple(cam)), sj, cfg,
                                      backend="jax",
                                      denoiser_params=params if kind == "unet" else None)
            frames.append((np.asarray(img), np.asarray(sj.prev_image), np.asarray(sj.flow),
                           int(sj.frame)))
        out[name] = frames
    return out


def _assert_vs_jax(want, got, steps, i):
    """Frame i of ``steps`` (a gathered image or a band state's history,
    with ``want`` the same rows of JAX's) at the bars of the module
    docstring."""
    kind = steps[i][2]
    if kind == "off":
        d = np.abs(want - got)
        assert (d > 1e-3).mean() < 3e-5 and d.mean() < 1e-4
    else:
        learned = any(k == "unet" for _, _, k in steps[: i + 1])
        _assert_denoised_close(want, torch.from_numpy(got), learned)


@pytest.fixture(scope="module")
def four_ranks():
    return sharded.spawn_ranks(rank_work_wide_halo, 4, backend="gloo", timeout=RANKS_TIMEOUT)


def test_mesh_and_bands(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["size"] == 2 and r["names"] == ("rows",) for r in ranks)
    assert all(r["jax_modules"] == [] for r in ranks)  # the ranks import no JAX
    assert ranks[0]["trace_band"].shape == (32, 64, 4)
    np.testing.assert_array_equal(ranks[0]["trace"][0], ranks[1]["trace"][0])
    np.testing.assert_array_equal(
        np.concatenate([r["trace_band"] for r in ranks]), ranks[0]["trace"][0])


def test_trace_image_sharded_bitwise_and_vs_jax(ranks):
    dt = scene(curve_xml())
    img, bm = rt.trace_image(dt, rt.Camera(), rt.RenderConfig(**TRACE_CFG))
    got_img, got_bm = ranks[0]["trace"]
    np.testing.assert_array_equal(got_img, img.numpy())
    np.testing.assert_array_equal(got_bm, bm.numpy())
    dj = rj.build_device_scene(rj.load_scene_from_string(curve_xml()), flatten_subdivisions=8)
    ij, bj = jsharded.trace_image_sharded(jsharded.make_mesh(2), dj, rj.Camera(),
                                          rj.RenderConfig(**TRACE_CFG), backend="jax")
    assert_parity((np.asarray(ij), np.asarray(bj)), (got_img, got_bm))


def test_render_frame_sharded_bitwise(ranks, one_process, jax_sequences):
    """Two chained frames with hoisted per-band slot-mode lists (blur, the
    analytic denoiser), then a moved camera with the shipped UNet; each
    rank ends with its band of the state.  Bitwise one process's, and the
    JAX package's within the module's bars."""
    dt = seeded()
    tabs = rt.build_cand_tables(dt, rt.Camera(), rt.RenderConfig(**FRAME_CFG))
    gl = rt.seg_max_count(dt, tabs)
    assert gl is not None and ranks[0]["gather_len"] == ranks[1]["gather_len"] >= gl
    for i in range(2):
        np.testing.assert_array_equal(ranks[0]["frames"][i], one_process["frames"][i])
    st = one_process["after_2"]
    jax = jax_sequences["2"]
    for rank, r in enumerate(ranks):
        band = slice(32 * rank, 32 * rank + 32)
        np.testing.assert_array_equal(r["frames"][2], one_process["frames"][2])
        np.testing.assert_array_equal(r["prev"], st.prev_image.numpy()[band])
        assert r["frame"] == st.frame == jax[2][3] == 3
        _assert_vs_jax(jax[2][1][band], r["prev"], SEQUENCE_2, 2)
    for i in range(3):
        _assert_vs_jax(jax[i][0], ranks[0]["frames"][i], SEQUENCE_2, i)


def _assert_moves(got_moves, got_state, one_process, n, jax, steps):
    """MOVES on n ranks: every gathered frame bitwise one process's; each
    rank's final band state the rows of one process's state.  ``jax``: the
    JAX package's frames of ``steps``, which end with MOVES; the frames and
    the band states held to them at the module's bars."""
    first = len(steps) - len(MOVES)
    for i, ((img, _), want) in enumerate(zip(got_moves, one_process["moves"])):
        np.testing.assert_array_equal(img, want)
        _assert_vs_jax(jax[first + i][0], img, steps, first + i)
    last = one_process["last"]
    _, jprev, jflow_, jframe = jax[-1]
    rows = 64 // n
    for rank, (prev, flow, frame, zero) in enumerate(got_state):
        band = slice(rank * rows, rank * rows + rows)
        np.testing.assert_array_equal(prev, last.prev_image.numpy()[band])
        np.testing.assert_array_equal(flow, last.flow.numpy()[band])
        assert frame == last.frame == jframe and zero == last.flow_is_zero
        _assert_vs_jax(jprev[band], prev, steps, len(steps) - 1)
        np.testing.assert_array_equal(flow, jflow_[band])


def test_moving_and_chained_band_frames_bitwise(ranks, one_process, jax_sequences):
    """After the three frames above, a zoom with the UNet (non-zero flow:
    the history gathered and warped), a resting UNet frame, a zoom with the
    analytic pass, a frame with the denoiser off: seven chained frames, the
    band state carried from each to the next."""
    _assert_moves(ranks[0]["moves"], [r["moved_state"] for r in ranks], one_process, 2,
                  jax_sequences["2"], SEQUENCE_2)


def test_a_resting_frame_moves_only_edge_strips(ranks):
    """Counted through the exchange helper (``EXCHANGE_LOG``): a resting
    frame (analytic denoiser and blur, radius 6 on the seeded scene) makes
    two edge-strip exchanges and no whole-frame collective, each moving n x
    2 x halo x W x C x 4 bytes (C = 4 image channels, + 1 blur map for the
    blur) and building a region of the band plus the halo on its inner
    side; where the trace is split by work (the denoiser off), the frame
    first hands the traced rows to their bands (the "rebalance" entry: n
    strips of the most rows a rank traced outside its band, 5 float32 sums
    a pixel, and the rows of the band other ranks traced), then makes the
    blur's exchange alone; a moving frame gathers the history (and the
    flow's row profile) and a resting UNet frame's widest exchange is the
    UNet's halo of 20 rows of nine channels."""
    w, rows, radius = 64, 32, 6
    cuts = ranks[0]["split"]["cuts"]
    own = [min(cuts[j + 1], (j + 1) * rows) - max(cuts[j], j * rows) for j in range(2)]
    k = max(cuts[j + 1] - cuts[j] - own[j] for j in range(2))
    for rank, r in enumerate(ranks):
        assert r["rest_log"] == [("halo", 2 * 2 * 2 * w * 4 * 4, rows + 2),
                                 ("halo", 2 * 2 * radius * w * 5 * 4, rows + radius)]
        assert r["split"]["frames"][1][2] == [("rebalance", 2 * k * w * 5 * 4, rows - own[rank]),
                                              ("halo", 2 * 2 * radius * w * 5 * 4, rows + radius)]
        assert all(bytes_ < 64 * w * 4 * 4 for _, bytes_, _ in r["rest_log"])
        logs = [log for _, log in r["moves"]]
        assert [kind for kind, _, _ in logs[0]] == ["gather", "gather", "halo", "halo"]
        assert logs[0][0] == ("gather", 64 * w * 4 * 4, 64)
        assert logs[1] == [("halo", 2 * 2 * 20 * w * 9 * 4, rows + 20),
                           ("halo", 2 * 2 * radius * w * 5 * 4, rows + radius)]
        assert [kind for kind, _, _ in logs[3]] == ["halo"]  # denoiser off: the blur's alone


def test_unet_halo_wider_than_a_band_on_four_ranks(four_ranks, one_process, jax_sequences):
    """Four ranks, 16-row bands: the UNet's 20-row halo takes rows from two
    ranks above or below; frames 0-1 with the UNet, then MOVES
    (SEQUENCE_4), all bitwise one process's and the JAX package's within
    the module's bars."""
    dt, net = one_process["dt"], one_process["net"]
    cfg = rt.RenderConfig(**FRAME_CFG)
    st = rt.init_frame_state(64, 64, device="cpu")
    jax = jax_sequences["4"]
    for i in range(2):
        img, st = rt.render_frame(dt, rt.Camera(), st, cfg, denoiser=net)
        np.testing.assert_array_equal(four_ranks[0]["frames"][i], img.numpy())
        _assert_vs_jax(jax[i][0], four_ranks[0]["frames"][i], SEQUENCE_4, i)
    # the regions: band + 20 rows on each inner side, cut at the frame's edges
    want_rows = [36, 52, 52, 36]
    for r, rows in zip(four_ranks, want_rows):
        assert r["logs"][1][0] == ("halo", 4 * 2 * 16 * 64 * 9 * 4, rows)
    moves = []
    for cam, zoom, kind in MOVES:
        if zoom is not None:
            st = dataclasses.replace(st, flow=rt.add_zoom_flow(st.flow, *zoom))
        img, st = rt.render_frame(dt, cam, st, move_config(kind),
                                  denoiser=net if kind == "unet" else None)
        moves.append(img.numpy())
    _assert_moves(four_ranks[0]["moves"], [r["moved_state"] for r in four_ranks],
                  {"moves": moves, "last": st}, 4, jax, SEQUENCE_4)


def test_unet_on_bands_of_17_rows_on_four_ranks(four_ranks, one_process):
    """The seeded scene at 64 x 68 on four ranks: bands of 17 rows, whose
    UNet regions start and end on the frame's multiples of 4 rows and take
    rows from up to two ranks ([0, 40), [0, 56), [12, 68), [28, 68)); two
    frames with the UNet, bitwise one process's."""
    dt = scene(seeded_scene_xml(0, 64, 68), flatten=16)
    cfg = rt.RenderConfig(**FRAME_CFG)
    st = rt.init_frame_state(64, 68, device="cpu")
    for i in range(2):
        img, st = rt.render_frame(dt, rt.Camera(), st, cfg, denoiser=one_process["net"])
        np.testing.assert_array_equal(four_ranks[0]["tall_frames"][i], img.numpy())
    assert [r["tall_log"][0] for r in four_ranks] == [
        ("halo", 4 * 2 * 17 * 64 * 9 * 4, rows) for rows in (40, 56, 56, 40)]


def test_band_frame_state(ranks, one_process, jax_sequences):
    """gather_frame_state gives the whole frame's state after frame 2 (what
    --save-session writes), its flow still known to be zero, as one
    process's and, within the module's bars, the JAX package's; a
    whole-frame state is refused by render_frame_sharded."""
    st = one_process["after_2"]
    _, jprev, jflow_, _ = jax_sequences["2"][2]
    for r in ranks:
        prev, flow, zero = r["whole_state"]
        np.testing.assert_array_equal(prev, st.prev_image.numpy())
        np.testing.assert_array_equal(flow, st.flow.numpy())
        assert zero and st.flow_is_zero
        _assert_vs_jax(jprev, prev, SEQUENCE_2, 2)
        np.testing.assert_array_equal(flow, jflow_)
    assert all("not this rank's band of 32 x 64" in r["whole_state_refused"] for r in ranks)


def test_hoisted_band_tables_on_a_dense_scene(ranks):
    """Per-band capped distance-ordered lists (strokes scene, 768 padded
    sub-segments).  Each rank's band sums equal one process's call on that
    band with its own tables and the full sweep, bit for bit, and so does
    the gathered frame the whole-frame call's.  PyTorch's CPU kernels round
    the vector body and the tail of a chunk differently, so a pixel's last
    bit can depend on its chunk of the plain version: its chunks lie on the
    frame's pixel grid, a divisor of a tile row's pixels (here 256 of
    4096), so a band that starts on a tile row, or on that grid as this
    one does, computes every pixel in the whole frame's chunk (chunks cut
    from the call's first pixel left 3 of 16384 values one float32 step
    apart).  The card's kernel computes each ray alone, and
    tests/test_torch_cuda.py holds the bands bitwise to the whole frame."""
    assert all(r["dense_dist_ordered"] for r in ranks)
    assert ranks[0]["dense_gather_len"] is None
    dense = scene(strokes_xml())
    cfg = rt.RenderConfig(**DENSE_CFG)
    for rank, r in enumerate(ranks):
        px0 = rank * 32 * 64
        own = tc.trace_sums_flat(dense, rt.Camera(), cfg, 1, px0, 32 * 64,
                                 tc.build_cand_tables(dense, rt.Camera(), cfg, px0, 32 * 64))
        full = tc.trace_sums_flat(dense, rt.Camera(), cfg, 1, px0, 32 * 64, None)
        for got, a, b in zip(r["dense_band"], own, full):
            np.testing.assert_array_equal(got.reshape(-1), a.numpy().reshape(-1))
            np.testing.assert_array_equal(got.reshape(-1), b.numpy().reshape(-1))
    img, bm = rt.trace_image(dense, rt.Camera(), cfg, 1)
    np.testing.assert_array_equal(ranks[1]["dense"][0], img.numpy())
    np.testing.assert_array_equal(ranks[1]["dense"][1], bm.numpy())
    assert float(img[..., :3].std()) > 0.01


@pytest.fixture(scope="module")
def split_one_process():
    """The ranks' ``split_frames`` on one process, on the whole frame's
    tables: the three frames' images, the final state's history, the two
    progressive passes' images and weight sums."""
    dt = seeded()
    cfg = rt.RenderConfig(**SPLIT_CFG)
    tabs = rt.build_cand_tables(dt, SPLIT_CAMERA, cfg)
    gl = rt.seg_max_count(dt, tabs)
    st = rt.init_frame_state(64, 64, device="cpu")
    frames = []
    for tables in (tabs, tabs, None):
        img, st = rt.render_frame(dt, SPLIT_CAMERA, st, cfg, cand_tables=tables,
                                  gather_len=None if tables is None else gl)
        frames.append(img.numpy())
    out = {"frames": frames, "prev": st.prev_image.numpy(), "frame": st.frame, "progressive": []}
    st = rt.init_frame_state(64, 64, device="cpu")
    prog = rt.init_progressive_state(64, 64, device="cpu")
    for reset in (True, False):
        img, st, prog = rt.render_frame_progressive(dt, SPLIT_CAMERA, st, prog, cfg, reset,
                                                    cand_tables=tabs, gather_len=gl)
        out["progressive"].append((img.numpy(), prog.weight_sum.numpy()))
    return out


def _split(request, n):
    """Every rank's ``split_frames`` record on n ranks."""
    return [r["split"] for r in request.getfixturevalue("ranks" if n == 2 else "four_ranks")]


@pytest.mark.parametrize("n", [2, 4])
def test_split_by_work_cuts_whole_tile_rows(request, n):
    """The trace split by work where the top rows cost three times the
    others (``split_cost_ms`` in the timer's place): every rank holds the
    same cuts, from row 0 to the frame's 64, on tile-row boundaries (2
    rows), each range non-empty, so the ranges cover every row once; they
    are not the equal bands (the split engaged), and the costliest range
    costs at most one tile row more than the best cut into whole tile rows
    does; narrowing the lists keeps them; a rank traces its range on those
    tables and its output band on in-frame tables."""
    got = _split(request, n)
    assert tc.tile_rows(seeded(), rt.RenderConfig(**SPLIT_CFG)) == 2
    cuts = got[0]["cuts"]
    equal = tuple(range(0, 65, 64 // n))
    assert all(g["cuts"] == cuts and g["narrow_cuts"] == (cuts, cuts) and g["narrowed"]
               for g in got)
    assert len(cuts) == n + 1 and cuts[0] == 0 and cuts[-1] == 64 and cuts != equal
    assert all(a < b and a % 2 == 0 for a, b in zip(cuts, cuts[1:]))
    cost = [split_cost_ms(None, None, None, r, r + 2, None) for r in range(0, 64, 2)]
    best = sharded._minmax_partition(cost, n)
    least = max(sum(cost[a:b]) for a, b in zip(best, best[1:]))
    assert max(split_cost_ms(None, None, None, a, b, None)
               for a, b in zip(cuts, cuts[1:])) <= least + max(cost)
    for rank, g in enumerate(got):
        assert [rows for _, rows, _ in g["frames"]] == (
            [(cuts[rank], cuts[rank + 1])] * 2 + [(equal[rank], equal[rank + 1])])


@pytest.mark.parametrize("n", [2, 4])
def test_split_by_work_frames_bitwise(request, n, split_one_process):
    """On the split: two chained frames (the blur on its band after the
    exchange), a frame on in-frame tables (equal ranges), every rank's band
    of the final state, and two progressive passes (the accumulator by
    output band), all bitwise one process's."""
    got = _split(request, n)
    want = split_one_process
    rows = 64 // n
    for rank, g in enumerate(got):
        for (img, _, _), w in zip(g["frames"], want["frames"]):
            np.testing.assert_array_equal(img, w)
        prev, frame = g["state"]
        np.testing.assert_array_equal(prev, want["prev"][rank * rows : rank * rows + rows])
        assert frame == want["frame"] == 3
        for (img, wsum), (w_img, w_wsum) in zip(g["progressive"], want["progressive"]):
            np.testing.assert_array_equal(img, w_img)
            np.testing.assert_array_equal(wsum, w_wsum)
    assert float(want["frames"][0][..., :3].std()) > 0.01


@pytest.mark.parametrize("n", [2, 4])
def test_split_by_work_exchange(request, n):
    """A frame on the split's tables logs one "rebalance" exchange before
    the blur's halo: n strips of k rows x 64 pixels x 5 float32, k the most
    rows any rank traced outside its band, and the rows of this rank's band
    that other ranks traced; a frame on in-frame tables logs none."""
    got = _split(request, n)
    cuts, rows = got[0]["cuts"], 64 // n
    own = [max(0, min(cuts[j + 1], (j + 1) * rows) - max(cuts[j], j * rows)) for j in range(n)]
    k = max(cuts[j + 1] - cuts[j] - own[j] for j in range(n))
    assert k > 0
    for rank, g in enumerate(got):
        for _, _, log in g["frames"][:2]:
            assert log[0] == ("rebalance", n * k * 64 * 5 * 4, rows - own[rank])
            assert [kind for kind, _, _ in log] == ["rebalance", "halo"]
        assert [kind for kind, _, _ in g["frames"][2][2]] == ["halo"]


def test_split_timer_times_a_trace():
    """``sharded._trace_ms``, the split's timer: a positive wall time in ms
    of a trace of the rows on their tables (on the CPU, the plain
    version)."""
    dt = seeded()
    cfg = rt.RenderConfig(**SPLIT_CFG)
    tabs = tc.build_cand_tables(dt, SPLIT_CAMERA, cfg, 0, 2 * 64)
    ms = sharded._trace_ms(dt, SPLIT_CAMERA, cfg, 0, 2, tabs)
    assert isinstance(ms, float) and 0.0 < ms < 60e3


def test_progressive_sharded_bitwise(ranks):
    dt = seeded()
    cfg = rt.RenderConfig(**PROG_CFG)
    st = rt.init_frame_state(64, 64, device="cpu")
    prog = rt.init_progressive_state(64, 64, device="cpu")
    for i, reset in enumerate((True, False, True, False)):
        img, st, prog = rt.render_frame_progressive(dt, rt.Camera(), st, prog, cfg, reset)
        got_img, got_w, passes = ranks[0]["progressive"][i]
        np.testing.assert_array_equal(got_img, img.numpy())
        np.testing.assert_array_equal(got_w, prog.weight_sum.numpy())
        assert passes == prog.passes == (1 if reset else 2)


def test_data_parallel_train_step(ranks):
    """Ranks end the step with the same loss, gradients and parameters; the
    step equals the one-process step on the whole batch: loss within 1e-6
    relative (float32 sums in another order); gradients within 2^-7
    relative L2 per tensor (the bf16 weight and bias gradients are rounded
    per shard, then averaged: measured up to 2.7e-3); parameters within
    1e-6 but for at most 1% of them.  Adam's first update is lr * g / (|g|
    + eps), about +-lr whatever the gradient's size: where a unit's bf16
    pre-activation rounds to 0 in one order of the sum and not in the
    other, its gradient is 0 on one side and tiny on the other, and the
    update lr or 0 (measured: 0.52% of values)."""
    model, sched, opt = new_model()
    loss = tdn.train_step(model, opt, sched, {k: torch.from_numpy(v)
                                              for k, v in train_batch().items()})
    want = tdn.params_to_jax(model)["params"]
    loss_0, params_0, grads_0 = ranks[0]["train"]
    loss_1, params_1, grads_1 = ranks[1]["train"]
    assert loss_0 == loss_1 and abs(loss_0 - float(loss)) <= 1e-6 * float(loss)
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        np.testing.assert_array_equal(grads_0[name], grads_1[name])
        assert np.linalg.norm(grads_0[name] - g) <= 2.0**-7 * np.linalg.norm(g), name
    off = total = 0
    for name, leaves in want.items():
        for leaf, v in leaves.items():
            got = params_0["params"][name][leaf]
            np.testing.assert_array_equal(got, params_1["params"][name][leaf])
            off += int((np.abs(got - v) > 1e-6).sum())
            total += v.size
    assert off <= 0.01 * total, off / total


def test_height_not_divisible_raises(ranks):
    assert all("not divisible by mesh size 2" in r["odd_height"] for r in ranks)


def test_bands_of_34_rows_render_with_either_denoiser(ranks, one_process):
    """A 68-row frame on 2 ranks: the trace, two chained frames with the
    analytic denoiser and the blur, then one with the UNet, bitwise one
    process's.  Bands of 34 rows do not start on the UNet's stride-2 grid:
    its region is widened to the frame's multiples of 4 rows (22 rows on
    the band's inner side, [12, 68) and [0, 56)), the blur's (radius 5 on
    this scene) is not."""
    dt = scene(curve_xml(68))
    cfg = rt.RenderConfig(**FRAME_CFG)
    img, bm = rt.trace_image(dt, rt.Camera(), rt.RenderConfig(**TRACE_CFG))
    np.testing.assert_array_equal(ranks[0]["band6_trace"], img.numpy())
    st = rt.init_frame_state(64, 68, device="cpu")
    for i, denoiser in enumerate((None, None, one_process["net"])):
        img, st = rt.render_frame(dt, rt.Camera(), st, cfg, denoiser=denoiser)
        for r in ranks:
            np.testing.assert_array_equal(r["band6_frames"][i], img.numpy())
    for r in ranks:
        assert [e[2] for e in r["band6_log"]] == [34 + 22, 34 + 5]


def test_make_mesh_refuses_more_devices_than_ranks(ranks):
    assert all(r["mesh_of_3"] == "requested 3 devices, have 2 ranks" for r in ranks)


def test_spawn_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        sharded.spawn_ranks(fail_on_rank_1, 2, backend="gloo", timeout=RANKS_TIMEOUT)


def test_cli_devices_2_on_the_cpu(tmp_path):
    """--devices 2 writes the image and, with --save-session, the whole
    frame's session (gathered from the bands) of one process; a second run
    resumes from it on the bands (--resume) as one process does."""
    xml = tmp_path / "s.xml"
    xml.write_text(curve_xml())
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")  # as few_threads
    outs = {}
    for n in (0, 2):
        for resume in (False, True):
            png, ckpt = tmp_path / f"d{n}{resume}.png", tmp_path / f"d{n}{resume}.npz"
            extra = ["--resume", str(tmp_path / f"d{n}False.npz")] if resume else []
            res = subprocess.run(
                [sys.executable, "-m", "raytracingdiffusioncurves_torch", str(xml), "4",
                 "--device", "cpu", "--devices", str(n), "--frames", "2", "--out", str(png),
                 "--save-session", str(ckpt), *extra],
                capture_output=True, text=True, cwd=tmp_path, env=env, timeout=RANKS_TIMEOUT)
            assert res.returncode == 0, res.stderr
            assert res.stdout.count("Setup took") == res.stdout.count("Average frame time") == 1
            assert res.stdout.count("wrote") == res.stdout.count("saved session") == 1
            with np.load(ckpt) as z:
                outs[n, resume] = (png.read_bytes(), {k: z[k].copy() for k in z.files})
    for resume in (False, True):
        (png0, z0), (png2, z2) = outs[0, resume], outs[2, resume]
        assert png0 == png2 and z0.keys() == z2.keys()
        assert z0["prev_image"].shape == (64, 64, 4) and int(z0["frame"]) == 2 + 2 * resume
        for k in z0:
            np.testing.assert_array_equal(z0[k], z2[k])
    if not torch.cuda.is_available():
        res = subprocess.run(
            [sys.executable, "-m", "raytracingdiffusioncurves_torch", str(xml), "4",
             "--devices", "2"], capture_output=True, text=True, cwd=tmp_path, env=env,
            timeout=RANKS_TIMEOUT)
        assert res.returncode != 0 and "CUDA" in res.stderr
