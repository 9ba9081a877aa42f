"""The port's paths through its public entry points on the card: chained
and progressive frames, the session, its HTTP viewer and the CLI, the
denoiser trainer, and row bands on two gloo ranks that share the card.
Skips without a CUDA device; imports no JAX (run it with test_torch_cuda.py
and ``-m cuda --noconftest``).

Bars: a frame is bitwise what its stages give; a resting frame queues
without a host sync; a frame launches the trace kernel once and, with the
UNet, the convolution nine times; row bands are bitwise one process's rows
and read their band and halo alone.  The denoiser's kernel route against its
plain route (a bf16 residual moves by one bf16 step: 3.9e-3 below 1, 7.8e-3
from 1 to 2): max below 1e-2, fewer than 1e-4 of values above 5e-3, mean
below 1e-4.  The data-parallel train step (2 x 16) against one process's on
32: loss within 1e-3 relative, each gradient within 1e-2 relative L2.
"""

import dataclasses
import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import raytracingdiffusioncurves_torch as rt
from raytracingdiffusioncurves_torch.models import denoiser as dn
from raytracingdiffusioncurves_torch.models import train_denoiser as ttd
from raytracingdiffusioncurves_torch.ops import blur as tblur
from raytracingdiffusioncurves_torch.ops import conv_cuda as cc
from raytracingdiffusioncurves_torch.ops import trace_cuda as tc
from raytracingdiffusioncurves_torch.parallel import sharded
from raytracingdiffusioncurves_torch.utils.scenes import dense_scene_xml, seeded_scene_xml
from raytracingdiffusioncurves_torch.viewer_http import HttpViewer

from torch_sharded_ranks import (ROOT, WEIGHTS, band_sequences, rank_work_on_one_card,
                                 train_batch, unet_train_step)

pytestmark = pytest.mark.cuda

NO_CARD = "needs a CUDA device: the port's kernels run only on the card"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    return torch.device("cuda")


def _scene(name, w, h, device):
    xml = seeded_scene_xml(0, w, h) if name == "seeded" else dense_scene_xml(0, w, h, name)
    return rt.build_device_scene(rt.load_scene_from_string(xml), device=device)


def _unet(device):
    return rt.net_for_params(rt.load_params(WEIGHTS), device=device)


@pytest.mark.parametrize("name,denoiser", [("seeded", "off"), ("seeded", "analytic"),
                                           ("seeded", "unet"), ("lady_bug", "unet")])
def test_chained_frames_on_the_card(cuda, name, denoiser):
    """render_frame chained on hoisted tables: frame 0, a resting frame that
    queues without a host sync, three frames with one trace launch each and
    nine convolution launches with the UNet; the last of them again from
    its stages; with a denoiser, a zoom step whose flow warps the history
    and is zeroed after the frame."""
    w, h = 192, 128
    dt = _scene(name, w, h, cuda)
    cfg = rt.RenderConfig(rays_per_pixel=8 if name == "seeded" else 32,
                          use_denoiser=denoiser != "off")
    net = _unet(cuda) if denoiser == "unet" else None
    cam = rt.Camera()
    tables = rt.build_cand_tables(dt, cam, cfg)
    gl = rt.seg_max_count(dt, tables)
    kw = dict(denoiser=net, cand_tables=tables, gather_len=gl)
    img, st = rt.render_frame(dt, cam, rt.init_frame_state(w, h, device=cuda), cfg, **kw)
    torch.cuda.synchronize()
    assert st.frame == 1 and st.flow_is_zero
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, st = rt.render_frame(dt, cam, st, cfg, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tc.reset_launch_count()
    cc.reset_launch_count()
    for _ in range(3):
        before = st
        img, st = rt.render_frame(dt, cam, st, cfg, **kw)
    assert (tc.LAUNCHES, cc.LAUNCHES) == (3, 27 if net is not None else 0)
    assert st.frame == 5 and img.shape == (h, w, 4) and torch.isfinite(img).all()
    assert float(img[..., :3].std()) > 0.01

    raw, bmap = rt.trace_image(dt, cam, cfg, before.frame, tables, gl)
    if net is not None:
        den = rt.apply_denoiser(net, raw, before.prev_image, bmap, mix=cfg.corrected_image_mix,
                                noise=dn.noise_level(cfg.rays_per_pixel), frame=before.frame)
    elif cfg.use_denoiser:
        den = rt.temporal_denoise(raw, before.prev_image, before.flow, before.frame,
                                  cfg.corrected_image_mix, flow_is_zero=True)
    else:
        den = raw
    assert torch.equal(st.prev_image, den)
    assert torch.equal(img, tblur.variable_gaussian_blur(den, bmap, tblur.blur_radius(dt.max_blur)))
    assert not torch.equal(img, st.prev_image)
    if not cfg.use_denoiser:
        return
    assert float((raw[..., :3] - den[..., :3]).abs().mean()) > 1e-4
    assert st.flow_is_zero and not bool(st.flow.any())
    zcam = rt.Camera(zoom_factor=0.9)
    ztables = rt.build_cand_tables(dt, zcam, cfg)
    moved = dataclasses.replace(st, flow=rt.add_zoom_flow(st.flow, 1.0, 0.9))
    assert not moved.flow_is_zero and bool(moved.flow.any())
    warped = rt.warp_separable(moved.prev_image, moved.flow)
    assert float((warped - moved.prev_image).abs().max()) > 1e-3
    img, st = rt.render_frame(dt, zcam, moved, cfg, denoiser=net, cand_tables=ztables,
                              gather_len=rt.seg_max_count(dt, ztables))
    assert st.frame == 6 and st.flow_is_zero and not bool(st.flow.any())
    assert torch.isfinite(img).all()


def test_progressive_passes_on_the_card(cuda):
    """render_frame_progressive with the UNet: three passes accumulate the
    weights, a reset drops them; nine convolution launches a pass."""
    w, h = 192, 128
    dt = _scene("seeded", w, h, cuda)
    cfg = rt.RenderConfig(rays_per_pixel=8)
    cam = rt.Camera()
    tables = rt.build_cand_tables(dt, cam, cfg)
    gl = rt.seg_max_count(dt, tables)
    net = _unet(cuda)
    st = rt.init_frame_state(w, h, device=cuda)
    prog = rt.init_progressive_state(w, h, device=cuda)
    sums = []
    cc.reset_launch_count()
    for reset in (True, False, False, True):
        img, st, prog = rt.render_frame_progressive(dt, cam, st, prog, cfg, reset, denoiser=net,
                                                    cand_tables=tables, gather_len=gl)
        assert torch.isfinite(img).all()
        sums.append((prog.passes, float(prog.weight_sum.sum())))
    assert [p for p, _ in sums] == [1, 2, 3, 1] and cc.LAUNCHES == 36
    one = sums[0][1]
    assert 2.5 * one < sums[2][1] < 3.5 * one and 0.8 * one < sums[3][1] < 1.2 * one


def _assert_routes_close(net, device):
    """The denoiser on a traced 1920x1088 frame (8 rays per pixel, frame 1
    over frame 0): the kernel route, nine launches, against the plain route
    at the module docstring's bars."""
    w, h = 1920, 1088
    dt = _scene("seeded", w, h, device)
    cfg = rt.RenderConfig(rays_per_pixel=8)
    prev, _ = rt.trace_image(dt, rt.Camera(), cfg, 0)
    raw, bmap = rt.trace_image(dt, rt.Camera(), cfg, 1)
    args = (net, raw, prev, bmap, 1.0, dn.noise_level(cfg.rays_per_pixel), 1)
    cc.reset_launch_count()
    a = dn._apply_denoiser(*args, cc.conv3x3)
    assert cc.LAUNCHES == 9 and torch.isfinite(a).all()
    d = (a - dn._apply_denoiser(*args, cc.conv3x3_plain)).abs()
    assert float(d.max()) < 1e-2 and float(d.mean()) < 1e-4
    assert float((d > 5e-3).float().mean()) < 1e-4


def test_kernel_route_matches_plain_route_on_a_traced_frame(cuda):
    _assert_routes_close(_unet(cuda), cuda)


def test_session_resumes_on_the_card(cuda, tmp_path):
    """A session saved after five frames (a zoom and a drag among them) and
    loaded again: the state bitwise, and the next frame of both equal bit
    for bit."""
    dt = _scene("seeded", 192, 128, cuda)
    cfg = rt.RenderConfig(rays_per_pixel=8)
    net = _unet(cuda)
    s = rt.InteractiveSession(dt, cfg, denoiser=net)
    for ev in [None, None, ("scroll", 1.0), ("drag", 60.0, -40.0), None]:
        if ev is not None:
            getattr(s, ev[0])(*ev[1:])
        s.render()
    path = rt.save_session(str(tmp_path / "session.npz"), s.state, s.camera)
    state, cam, params = rt.load_session(path)
    assert params is None and cam == s.camera and state.frame == s.state.frame == 5
    assert torch.equal(state.prev_image, s.state.prev_image)
    assert torch.equal(state.flow, s.state.flow)
    resumed = rt.InteractiveSession(dt, cfg, camera=cam, denoiser=net)
    resumed.state = state
    assert torch.equal(s.render(), resumed.render())
    assert torch.equal(s.state.prev_image, resumed.state.prev_image)


def test_http_viewer_streams_the_session_from_the_card(cuda):
    """HttpViewer on a free local port over a session with the UNet: the
    stream delivers frames, a posted scroll and drag move the camera and a
    new frame differs; the server's threads stop."""
    s = rt.InteractiveSession(_scene("seeded", 192, 128, cuda), rt.RenderConfig(rays_per_pixel=8),
                              denoiser=_unet(cuda))
    v = HttpViewer(s, port=0).start()
    try:
        base = f"http://127.0.0.1:{v.port}"
        v.wait_frame(timeout=120)
        with urllib.request.urlopen(base + "/stream", timeout=60) as r:
            raw = b""
            while raw.count(b"--frame") < 3:  # two whole parts after the first boundary
                chunk = r.read(1 << 16)
                assert chunk, "the stream ended"
                raw += chunk
        cam0, f0 = s.camera, v.frames
        before, _ = v.wait_frame(after=f0 - 1, timeout=60)
        for ev in ({"type": "scroll", "y": 1.0}, {"type": "drag", "dx": 40.0, "dy": -25.0}):
            req = urllib.request.Request(base + "/event", data=json.dumps(ev).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 204
        after, _ = v.wait_frame(after=f0 + 3, timeout=60)
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        assert after != before and after[:2] == b"\xff\xd8"
        assert s.camera != cam0 and stats["zoom"] < cam0.zoom_factor
    finally:
        v.stop()
    assert not any(t.is_alive() for t in v._threads)


@pytest.mark.parametrize("rpp,args,size", [
    (8, [], (192, 128)),
    (1024, ["--no-denoiser", "--width", "256", "--height", "256"], (256, 256)),
], ids=["shipped_unet", "no_denoiser_coarse_lists_resized"])
def test_cli_on_the_card(cuda, tmp_path, rpp, args, size):
    """``python -m raytracingdiffusioncurves_torch`` in a subprocess on the
    card, as a user runs it: the shipped UNet by default, and at 1024 rays
    per pixel (wedge-coarsened lists) with the size overridden.  Three
    frames: the printed lines, the stats JSON and the PNG."""
    xml, png = tmp_path / "scene.xml", tmp_path / "out.png"
    xml.write_text(seeded_scene_xml(0, 192, 128))
    proc = subprocess.run(
        [sys.executable, "-m", "raytracingdiffusioncurves_torch", str(xml), str(rpp), *args,
         "--frames", "3", "--stats", "--out", str(png)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.replace("\r", "\n").splitlines()
    assert any(ln.startswith("Setup took : ") for ln in lines)
    assert any(ln.startswith("Average frame time : ") for ln in lines)
    phases = json.loads(next(ln for ln in lines if ln.startswith('{"scene_load"')))
    metrics = json.loads(next(ln for ln in lines if ln.startswith('{"counters"')))
    assert phases["frame"]["count"] == 2 and metrics["counters"]["frames"] == 2
    assert lines[-1] == f"wrote {png}"
    with Image.open(png) as img:
        assert img.size == size and img.mode == "RGBA"


def test_trainer_on_the_card(cuda, tmp_path):
    """train_denoiser on the card: generate (three trace launches an
    example, float16 arrays); 30 train steps of the UNet at the shipped
    width on one batch of crops under 0.7x the first loss, launching
    neither the trace nor the convolution kernel (the train step's
    convolution is cuDNN's); train() with validation through the
    convolution kernel (nine launches per example, raw and averaged
    weights, at its first and last step); the checkpoint it writes through
    load_params / net_for_params on the kernel route against the plain
    route."""
    size, cams = 96, 3
    paths = [tmp_path / f"{i}.xml" for i in range(3)]
    for path, xml in zip(paths, (seeded_scene_xml(1, size, size), seeded_scene_xml(3, size, size),
                                 dense_scene_xml(0, size, size, "lady_bug"))):
        path.write_text(xml)
    data, val = str(tmp_path / "data.npz"), str(tmp_path / "val.npz")
    tc.reset_launch_count()
    ttd.generate([str(paths[0]), str(paths[2])], data, size=size, cams_per_scene=cams, seed=0)
    n_ex = 2 * cams
    assert tc.LAUNCHES == 3 * n_ex
    ttd.generate([str(paths[1])], val, size=size, cams_per_scene=2, seed=1)
    with np.load(data) as z:
        arrays = {k: z[k] for k in z.files}
    for k, c in (("noisy", 3), ("warped_prev", 3), ("aux", 2), ("target", 3)):
        assert arrays[k].shape == (n_ex, size, size, c) and arrays[k].dtype == np.float16
        assert np.isfinite(arrays[k]).all()
    assert float(arrays["target"].astype(np.float32).std()) > 0.01

    batch = ttd._crop_batch(arrays, np.random.default_rng(0), 32, 64)
    model, sched, opt = dn.create_train_state(torch.Generator().manual_seed(0), 64, 64, 2e-3,
                                              arch="unet", base=24)
    with torch.no_grad():
        first = float(dn.loss_fn(model, batch))
    tc.reset_launch_count()
    cc.reset_launch_count()
    for _ in range(30):
        loss = dn.train_step(model, opt, sched, batch)
    assert float(loss) < 0.7 * first
    assert tc.LAUNCHES == 0 and cc.LAUNCHES == 0

    ckpt = str(tmp_path / "denoiser.msgpack")
    cc.reset_launch_count()
    res = ttd.train(data, val, ckpt, steps=2, batch=8, crop=32, seed=0, arch="unet", base=24)
    assert cc.LAUNCHES == 9 * 2 * 2 * 2
    assert np.isfinite(res["loss"]) and np.isfinite(res["best_val_psnr"])
    net = rt.net_for_params(rt.load_params(ckpt))
    assert isinstance(net, rt.UNetDenoiser) and net.base == 24
    _assert_routes_close(net, cuda)


# The row-band cases (torch_sharded_ranks.band_sequences): scene XML,
# RenderConfig keywords and camera.  The denoiser-off frame on slot-mode
# lists, the denoised frame with the UNet (a zoom step), the dense frame
# with the UNet (capped lists), 1024 rays per pixel (lists of wedge shift
# 2), and the "off" frame zoomed out into the top rows on tiles of 8 rows,
# whose trace the split by work cuts unequally (32 tile rows, timed by
# torch_sharded_ranks.split_cost_ms: the real timer's cuts follow the
# card's times, and the other cases take it).
BAND_CASES = {
    "off": (seeded_scene_xml(0, 256, 256),
            dict(rays_per_pixel=128, rays_per_block=2048, use_denoiser=False), rt.Camera()),
    "unet": (seeded_scene_xml(0, 192, 128), dict(rays_per_pixel=8), rt.Camera()),
    "dense": (dense_scene_xml(0, 192, 128, "lady_bug"), dict(rays_per_pixel=32), rt.Camera()),
    "coarse": (seeded_scene_xml(0, 256, 256), dict(rays_per_pixel=1024, use_denoiser=False),
               rt.Camera()),
    "split": (seeded_scene_xml(0, 256, 256),
              dict(rays_per_pixel=128, rays_per_block=512, use_denoiser=False),
              rt.Camera(2.0, 0.0, -160.0)),
}
TRAIN_BATCH = 32


@pytest.fixture(scope="module")
def card_ranks():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    return sharded.spawn_ranks(rank_work_on_one_card, 2,
                               ("cuda", BAND_CASES, train_batch(TRAIN_BATCH, 64)),
                               backend="gloo", timeout=600.0)


@pytest.fixture(scope="module")
def one_process():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    return band_sequences(None, "cuda", BAND_CASES, _unet("cuda"))


def test_gloo_collectives_on_cuda_tensors(cuda, card_ranks):
    for res in card_ranks:
        assert res["collectives"] == ("cuda", [0.0] * 4 + [1.0] * 4, 4)


@pytest.mark.parametrize("name", ["off", "progressive", "unet", "dense", "coarse"])
def test_band_frames_on_one_card_equal_one_process(cuda, card_ranks, one_process, name):
    """Each rank's band of every frame, its band of the history, the frame
    counter and the launches equal one process's; each frame's stages read
    the band and at most ``reach`` rows on either side, and only the frame
    after the zoom gathers (the history and its flow)."""
    whole = one_process[name]
    use_unet = name in ("unet", "dense")
    for i, rec in enumerate(whole):
        assert rec["launches"] == (i + 1, 9 * (i + 1) if use_unet else 0)
    if name == "coarse":
        assert one_process["wedge_shift"][name] == 2
    rows = whole[0]["image"].shape[0] // len(card_ranks)
    reach = one_process["reach"][name]
    for r, res in enumerate(card_ranks):
        band = slice(r * rows, (r + 1) * rows)
        got = res["bands"][name]
        assert len(got) == len(whole) and res["bands"]["reach"] == one_process["reach"]
        assert res["bands"]["wedge_shift"] == one_process["wedge_shift"]
        for g, w in zip(got, whole):
            assert np.array_equal(g["image"], w["image"][band])
            assert np.array_equal(g["prev"], w["prev"][band])
            assert (g["frame"], g["flow_zero"], g["moved"], g["launches"]) == (
                w["frame"], w["flow_zero"], w["moved"], w["launches"])
            regions = [n for kind, _, n in g["log"] if kind == "halo"]
            assert 0 < max(regions) <= rows + 2 * reach
            assert sum(kind == "gather" for kind, _, _ in g["log"]) == (2 if g["moved"] else 0)
    assert any(rec["moved"] for rec in whole) == (name == "unet")


def test_trace_split_by_work_on_one_card_equals_one_process(cuda, card_ranks, one_process):
    """The "split" case: the ranks' trace ranges are unequal whole tile rows
    (8) from 0 to 256, the same on both ranks, as ``split_cost_ms`` cuts
    them (the first 20 rows three times the others: rows 0-111 and
    112-255), and the bands of every frame and of the history put
    together are one process's whole frame, bit for bit (an off-by-one at
    a cut would show in any row, not only in those near the bands' edges);
    each frame hands the sums over in one "rebalance" exchange before the
    blur's."""
    whole = one_process["split"]
    cuts = card_ranks[0]["bands"]["cuts"]["split"]
    assert cuts == card_ranks[1]["bands"]["cuts"]["split"]
    assert cuts == (0, 112, 256)
    assert all(a < b and a % 8 == 0 for a, b in zip(cuts, cuts[1:]))
    assert one_process["cuts"]["split"] is None
    for i, w in enumerate(whole):
        got = [res["bands"]["split"][i] for res in card_ranks]
        assert np.array_equal(np.concatenate([g["image"] for g in got]), w["image"])
        assert np.array_equal(np.concatenate([g["prev"] for g in got]), w["prev"])
        assert all([kind for kind, _, _ in g["log"]] == ["rebalance", "halo"] for g in got)


def test_data_parallel_train_step_on_one_card(cuda, card_ranks):
    batch = train_batch(TRAIN_BATCH, 64)
    loss, grads = unet_train_step(batch, "cuda")
    (l0, g0), (l1, g1) = (res["train"] for res in card_ranks)
    assert l0 == l1 and abs(l0 - loss) <= 1e-3 * loss
    for n, g in grads.items():
        assert np.array_equal(g0[n], g1[n]), n
        assert np.linalg.norm(g0[n] - g) <= 1e-2 * np.linalg.norm(g), n
