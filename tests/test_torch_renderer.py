"""Port renderer vs the JAX package, plus the package's import and device
rules.

* Two chained frames with blur on against JAX ``render_frame(backend=
  "jax")`` at 64^2, with the assert_parity bars (fewer than 3e-5 of values
  off by more than 1e-3, mean below 1e-4): trace differences are pow
  rounding and sum order, the blur adds exp rounding (< 2e-5).
* The denoised frame (32^2, 4 rays per pixel, two chained frames) with the
  shipped UNet and with the analytic pass, and three progressive passes
  with a reset, against the JAX package.  Analytic pass: max 5e-3, mean
  1e-3 (the jitted bf16 bilateral chain, see test_torch_denoise.py).
  Learned pass: the UNet's output is a bf16 residual (steps of 3.9e-3 near
  1) on inputs that already differ by the bilateral's 1.6e-3, and the JAX
  route's pre-summed dec0 kernel moves single values by one more step, so
  chained frames differ by up to two steps: max 1e-2, fewer than 1% of
  values above 5e-3, mean 1e-3 (measured over two frames: max 7.9e-3,
  0.4% above 5e-3, mean 8.4e-4).
* ``import raytracingdiffusioncurves_torch`` and its trainer, sharding and
  CLI modules pull in none of jax, flax, optax, msgpack or the JAX package.
* Entry points default to CUDA and raise when it is absent.
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
from raytracingdiffusioncurves_torch.ops import trace_cuda as tc
from raytracingdiffusioncurves_tpu.models import denoiser as jdn
from raytracingdiffusioncurves_tpu.ops import flow as jflow
from raytracingdiffusioncurves_torch.utils.scenes import seeded_scene_xml


def test_chained_frames_match_jax():
    size = 64
    xml = seeded_scene_xml(0, size, size)
    dj = rj.build_device_scene(rj.load_scene_from_string(xml))
    dt = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    kw = dict(rays_per_pixel=8, rays_per_block=2048, use_denoiser=False, use_blur=True)
    cfgj, cfgt = rj.RenderConfig(**kw), rt.RenderConfig(**kw)
    sj = rj.init_frame_state(size, size)
    st = rt.init_frame_state(size, size, device="cpu")
    tabs = rt.build_cand_tables(dt, rt.Camera(), cfgt)
    gl = rt.seg_max_count(dt, tabs)
    for _ in range(2):
        img_j, sj = rj.render_frame(dj, rj.Camera(), sj, cfgj, backend="jax")
        img_t, st = rt.render_frame(dt, rt.Camera(), st, cfgt, cand_tables=tabs,
                                    gather_len=gl)
        a, b = np.asarray(img_j), img_t.numpy()
        d = np.abs(a - b)
        assert not np.isnan(b).any()
        assert (d > 1e-3).mean() < 3e-5 and d.mean() < 1e-4
        np.testing.assert_allclose(np.asarray(sj.prev_image), st.prev_image.numpy(),
                                   atol=1e-3)
    assert st.frame == int(sj.frame) == 2
    # the two frames differ (the RNG folds the frame counter in) and blur ran
    assert dt.max_blur > 0.0


WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "weights", "denoiser_r3d.msgpack")


def _pair(size, **kw):
    xml = seeded_scene_xml(0, size, size)
    dj = rj.build_device_scene(rj.load_scene_from_string(xml))
    dt = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    return dj, dt, rj.RenderConfig(**kw), rt.RenderConfig(**kw)


def _assert_denoised_close(img_j, img_t, learned=False):
    a, b = np.asarray(img_j), img_t.numpy()
    assert a.shape == b.shape and np.isfinite(b).all()
    d = np.abs(a - b)
    assert d.mean() < 1e-3
    if learned:
        assert d.max() < 1e-2 and (d > 5e-3).mean() < 0.01
    else:
        assert d.max() < 5e-3


def test_default_config_renders_with_analytic_denoiser():
    """The default RenderConfig (use_denoiser=True) renders: without a
    ``denoiser`` module through the analytic temporal pass."""
    xml = seeded_scene_xml(0, 16, 16)
    dt = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    st = rt.init_frame_state(16, 16, device="cpu")
    cfg = rt.RenderConfig(rays_per_pixel=4)
    assert cfg.use_denoiser
    img, st = rt.render_frame(dt, rt.Camera(), st, cfg)
    assert img.shape == (16, 16, 4) and torch.isfinite(img).all() and st.frame == 1


def test_denoiser_not_ported_raises():
    """A checkpoint tree that was not turned into the port's module
    (``net_for_params``) is refused: render_frame copies no weights."""
    xml = seeded_scene_xml(0, 16, 16)
    dt = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    st = rt.init_frame_state(16, 16, device="cpu")
    with pytest.raises(TypeError, match="net_for_params"):
        rt.render_frame(dt, rt.Camera(), st, rt.RenderConfig(rays_per_pixel=4),
                        denoiser=rt.load_params(WEIGHTS))


@pytest.mark.parametrize("learned", [True, False])
def test_denoised_frames_match_jax(learned):
    size = 32
    dj, dt, cfgj, cfgt = _pair(size, rays_per_pixel=4, rays_per_block=2048, use_blur=True)
    pj = jdn.load_params(WEIGHTS) if learned else None
    net = rt.net_for_params(rt.load_params(WEIGHTS), device="cpu") if learned else None
    sj = rj.init_frame_state(size, size)
    st = rt.init_frame_state(size, size, device="cpu")
    for i in range(2):
        img_j, sj = rj.render_frame(dj, rj.Camera(), sj, cfgj, backend="jax", denoiser_params=pj)
        img_t, st = rt.render_frame(dt, rt.Camera(), st, cfgt, denoiser=net)
        _assert_denoised_close(img_j, img_t, learned)
        _assert_denoised_close(sj.prev_image, st.prev_image, learned)
        assert st.flow_is_zero and not st.flow.any() and st.frame == i + 1
    # the blur ran after the denoiser: prev_image is the un-blurred frame
    assert not torch.equal(img_t, st.prev_image)


def test_denoised_frame_warps_history_by_the_flow():
    """A zoom step: both packages warp prev_image by the zoom flow before the
    denoiser, and zero the flow after it."""
    size = 32
    dj, dt, cfgj, cfgt = _pair(size, rays_per_pixel=4, rays_per_block=2048, use_blur=False)
    sj = rj.init_frame_state(size, size)
    st = rt.init_frame_state(size, size, device="cpu")
    img_j, sj = rj.render_frame(dj, rj.Camera(), sj, cfgj, backend="jax")
    img_t, st = rt.render_frame(dt, rt.Camera(), st, cfgt)
    sj = sj._replace(flow=jflow.add_zoom_flow(sj.flow, 1.0, 0.9))
    st = dataclasses.replace(st, flow=rt.add_zoom_flow(st.flow, 1.0, 0.9))
    assert not st.flow_is_zero
    rest_t, _ = rt.render_frame(dt, rt.Camera(0.9), dataclasses.replace(st, flow=st.zero_flow), cfgt)
    img_j, sj = rj.render_frame(dj, rj.Camera(0.9), sj, cfgj, backend="jax")
    img_t, st = rt.render_frame(dt, rt.Camera(0.9), st, cfgt)
    _assert_denoised_close(img_j, img_t)
    assert st.flow_is_zero and not st.flow.any()
    assert float((img_t - rest_t).abs().max()) > 1e-3  # the warp moved the history


def test_frame_state_knows_a_zero_flow_on_the_host():
    st = rt.init_frame_state(8, 8, device="cpu")
    assert st.flow_is_zero
    moved = dataclasses.replace(st, flow=rt.add_translation_flow(st.flow, 1.0, 0.0))
    assert not moved.flow_is_zero
    # a state built by hand makes no claim: the warp runs (an exact identity)
    assert not rt.FrameState(st.prev_image, st.flow, 0).flow_is_zero


def test_progressive_matches_jax():
    """Three passes with a reset on the third, against the JAX package
    (denoiser on, analytic): the accumulated sums, the pass counter and the
    displayed image."""
    size = 32
    dj, dt, cfgj, cfgt = _pair(size, rays_per_pixel=4, rays_per_block=2048, use_blur=True)
    sj, pj = rj.init_frame_state(size, size), rj.init_progressive_state(size, size)
    st = rt.init_frame_state(size, size, device="cpu")
    pt = rt.init_progressive_state(size, size, device="cpu")
    for i, reset in enumerate([True, False, True]):
        img_j, sj, pj = rj.render_frame_progressive(dj, rj.Camera(), sj, pj, cfgj, reset,
                                                    backend="jax")
        img_t, st, pt = rt.render_frame_progressive(dt, rt.Camera(), st, pt, cfgt, reset)
        assert pt.passes == int(pj.passes) == (2 if i == 1 else 1)
        np.testing.assert_allclose(np.asarray(pj.weight_sum), pt.weight_sum.numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(pj.color_sum), pt.color_sum.numpy(),
                                   rtol=1e-3, atol=1e-4)
        _assert_denoised_close(img_j, img_t)
    assert st.frame == int(sj.frame) == 3


def test_progressive_accumulates_and_resets():
    size = 16
    _, dt, _, cfg = _pair(size, rays_per_pixel=4, use_denoiser=False, use_blur=False)
    st = rt.init_frame_state(size, size, device="cpu")
    pt = rt.init_progressive_state(size, size, device="cpu")
    _, st, p1 = rt.render_frame_progressive(dt, rt.Camera(), st, pt, cfg, True)
    _, st, p2 = rt.render_frame_progressive(dt, rt.Camera(), st, p1, cfg, False)
    assert (p1.passes, p2.passes) == (1, 2)
    assert float(p2.weight_sum.sum()) > 1.5 * float(p1.weight_sum.sum())
    frame2 = tc.trace_sums_flat(dt, rt.Camera(), cfg, 2, 0, size * size,
                                tc.build_cand_tables(dt, rt.Camera(), cfg))
    _, st, p3 = rt.render_frame_progressive(dt, rt.Camera(), st, p2, cfg, True)
    assert p3.passes == 1
    assert torch.equal(p3.weight_sum.reshape(-1), frame2[1])


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import raytracingdiffusioncurves_torch\n"
        "import raytracingdiffusioncurves_torch.ops._build\n"
        "import raytracingdiffusioncurves_torch.utils.scenes\n"
        "import raytracingdiffusioncurves_torch.models.train_denoiser\n"
        "import raytracingdiffusioncurves_torch.parallel.sharded\n"
        "import raytracingdiffusioncurves_torch.cli\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'msgpack', 'raytracingdiffusioncurves_tpu')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, env=env)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run there")
    scene = rt.load_scene_from_string(seeded_scene_xml(0, 16, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.build_device_scene(scene)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.init_frame_state(16, 16)
    dt = rt.build_device_scene(scene, device="cpu")
    arrays = {f: getattr(dt, f).numpy() for f in ("seg_consts", "shade_table",
                                                   "shade_all_t", "chunk_bounds")}
    meta = {f: getattr(dt, f) for f in ("width", "height", "n_sub", "s_pad",
                                        "has_portals", "max_blur", "uniform_wd",
                                        "uniform_wm")}
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.from_jax_arrays(arrays, meta)
    # a CPU scene traces on the CPU through the plain version, never the kernel
    tc.reset_launch_count()
    cfg = rt.RenderConfig(rays_per_pixel=4, use_denoiser=False)
    img, _ = rt.trace_image(dt, rt.Camera(), cfg)
    assert img.device.type == "cpu" and tc.LAUNCHES == 0
