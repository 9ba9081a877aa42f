"""The port's interactive session, session checkpoints, timing utilities and
device-side quantization, on the CPU, against the JAX package.

* ``InteractiveSession`` (moving frames on world-grid tables, resting
  frames on the camera's own) and the JAX package's
  ``InteractiveSession(backend="jax")`` run one scroll / drag / rest
  sequence on the seeded scene (48^2, 8 rays per pixel, the analytic
  denoiser, blur on).  Every frame agrees under the bars of the analytic
  denoised frames of test_torch_renderer.py: max 5e-3, mean 1e-3 (the
  jitted bf16 bilateral chain).  Cameras and flows equal the JAX session's.
* The zoom and pan factors, the flows and the screenshot, as
  tests/test_viewer.py checks them.
* A session written by either package resumes in the other, bitwise on
  the state and the camera (the JAX package's denoiser entry read by the
  port's MessagePack reader); a port session resumed from its checkpoint
  renders its next frame bit for bit.
* PhaseTimer / Metrics JSON keys equal the JAX package's; trace_to writes
  a Chrome trace; to_uint8_device and to_uint8 equal the JAX package's
  to_uint8 bitwise.
"""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import raytracingdiffusioncurves_torch as rt
import raytracingdiffusioncurves_tpu as rj
from raytracingdiffusioncurves_torch.ops import trace_cuda as tc
from raytracingdiffusioncurves_torch.utils import timing as ttiming
from raytracingdiffusioncurves_torch.utils.image import to_uint8, to_uint8_device
from raytracingdiffusioncurves_torch.utils.scenes import seeded_scene_xml
from raytracingdiffusioncurves_torch.viewer import ZOOM_STEP, InteractiveSession
from raytracingdiffusioncurves_tpu.models import denoiser as jdn
from raytracingdiffusioncurves_tpu.utils import checkpoint as jck
from raytracingdiffusioncurves_tpu.utils import image as jax_image
from raytracingdiffusioncurves_tpu.utils import timing as jtiming
from raytracingdiffusioncurves_tpu.viewer import InteractiveSession as JaxSession

SIZE, RPP = 48, 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNN = os.path.join(ROOT, "weights", "denoiser.msgpack")
# rest, rest, zoom in, drag, rest, zoom out three times (the last past the
# grid's zoom_max: a rebuild), rest
SEQUENCE = [None, None, ("scroll", 1.0), ("drag", 5.0, -3.0), None, ("scroll", -1.0),
            ("scroll", -1.0), ("scroll", -1.0), None]


def _pair(**kw):
    xml = seeded_scene_xml(0, SIZE, SIZE)
    dj = rj.build_device_scene(rj.load_scene_from_string(xml))
    dt = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    return dj, dt, rj.RenderConfig(**kw), rt.RenderConfig(**kw)


def _cam(c):
    """A camera of either package as the port's."""
    return rt.Camera(c.zoom_factor, c.offset_x, c.offset_y)


def _apply(session, ev):
    if ev is not None:
        getattr(session, ev[0])(*ev[1:])


def test_session_matches_jax_session():
    dj, dt, cfgj, cfgt = _pair(rays_per_pixel=RPP)
    assert cfgt.use_denoiser and cfgt.use_blur and dt.max_blur > 0.0
    sj = JaxSession(dj, cfgj, backend="jax")
    st = InteractiveSession(dt, cfgt)
    assert st.device.type == "cpu"
    for ev in SEQUENCE:
        _apply(sj, ev)
        _apply(st, ev)
        assert st.camera == _cam(sj.camera)  # the same float arithmetic
        np.testing.assert_array_equal(np.asarray(sj.state.flow), st.state.flow.numpy())
        a, b = np.asarray(sj.render()), st.render().numpy()
        d = np.abs(a - b)
        assert a.shape == b.shape == (SIZE, SIZE, 4) and np.isfinite(b).all()
        assert d.max() < 5e-3 and d.mean() < 1e-3, (ev, d.max(), d.mean())
    assert st.state.frame == int(sj.state.frame) == len(SEQUENCE)
    # the first frame built the grid, the third zoom-out left it
    assert st.grid_builds == 2 and st.grid.zoom_max == pytest.approx(ZOOM_STEP**3)


def test_moving_frames_take_grid_tables_and_resting_frames_their_own(monkeypatch):
    _, dt, _, cfg = _pair(rays_per_pixel=RPP, use_denoiser=False)
    s = InteractiveSession(dt, cfg)
    seen = []
    real = tc.trace_sums_flat

    def spy(scene, camera, config, frame, px_start, n_px, cand_tables=None, gather_len=None):
        seen.append((cand_tables, gather_len))
        return real(scene, camera, config, frame, px_start, n_px, cand_tables, gather_len)

    monkeypatch.setattr(tc, "trace_sums_flat", spy)
    s.render()  # moving (first) frame: grid tables
    grid = s.grid
    s.render()  # resting: the camera's own tables, narrowed
    s.render()  # resting again: the same tables, not rebuilt
    s.drag(3.0, 2.0)
    s.render()  # moving: the same grid
    assert s.grid is grid and s.grid_builds == 1
    assert seen[0][1] == grid.gather_len
    own = rt.build_cand_tables(dt, rt.Camera(), cfg)
    gl = rt.seg_max_count(dt, own)
    assert seen[1][1] == gl and torch.equal(seen[1][0].ids, own.ids[..., :gl])
    assert seen[2][0] is seen[1][0]
    want = tc.grid_tables(grid, dt, s.camera, cfg)
    assert torch.equal(seen[3][0].ids, want.ids)


def test_grid_serves_one_zoom_in_step_past_its_camera():
    """The grid is built one zoom-out step wide and serves one zoom-in step
    past the camera it was built for; a deeper zoom rebuilds it around the
    new camera, whose frames still equal the full sweep's bitwise."""
    _, dt, _, cfg = _pair(rays_per_pixel=RPP, use_denoiser=False)
    s = InteractiveSession(dt, cfg)
    s.render()
    first = s.grid
    assert first.zoom_max == pytest.approx(ZOOM_STEP)
    s.scroll(1.0)  # one step in: the same grid
    assert s.grid_serves() and rt.grid_covers(first, dt, s.camera, cfg)
    s.render()
    assert s.grid is first and s.grid_builds == 1
    s.scroll(1.0)  # two steps in: covered, but past the grid's zoom range
    assert rt.grid_covers(first, dt, s.camera, cfg) and not s.grid_serves()
    s.render()
    assert s.grid_builds == 2 and s.grid.zoom_max == pytest.approx(ZOOM_STEP**-1)
    picked = tc.grid_tables(s.grid, dt, s.camera, cfg)
    n_px = SIZE * SIZE
    a = tc.trace_sums_flat(dt, s.camera, cfg, 3, 0, n_px, picked, s.grid.gather_len)
    b = tc.trace_sums_flat(dt, s.camera, cfg, 3, 0, n_px, None)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_scroll_zoom_factor_and_flow():
    _, dt, _, cfg = _pair(rays_per_pixel=4, use_blur=False)
    s = InteractiveSession(dt, cfg)
    z0 = s.camera.zoom_factor
    s.scroll(1.0)  # zoom in: *= 1.5^-1 (glfw_events.cpp:110)
    assert s.camera.zoom_factor == pytest.approx(z0 / ZOOM_STEP)
    flow = s.state.flow.numpy()
    assert np.abs(flow).max() > 0 and not s.state.flow_is_zero
    assert np.abs(flow[SIZE // 2, SIZE // 2]).max() < 1.0  # the centre stays
    s.scroll(-1.0)
    assert s.camera.zoom_factor == pytest.approx(z0)


def test_drag_pan_and_screenshot(tmp_path):
    _, dt, _, cfg = _pair(rays_per_pixel=4, use_blur=False)
    s = InteractiveSession(dt, cfg)
    s.scroll(1.0)
    cam0 = s.camera
    s.drag(10.0, -4.0)
    assert s.camera.offset_x == pytest.approx(cam0.offset_x - 10.0 * cam0.zoom_factor)
    assert s.camera.offset_y == pytest.approx(cam0.offset_y + 4.0 * cam0.zoom_factor)
    img = s.render(block=False)
    assert img.shape == (SIZE, SIZE, 4)
    out = s.screenshot(str(tmp_path / "shot.png"))
    saved = np.asarray(Image.open(out))
    assert np.array_equal(saved, to_uint8(img.numpy(), flip_vertical=True))
    assert s.mean_frame_time_ms > 0


def test_progressive_session_resets_on_a_move():
    _, dt, _, cfg = _pair(rays_per_pixel=4, use_blur=False, use_denoiser=False)
    s = InteractiveSession(dt, cfg, progressive=True)
    passes = []
    for ev in [None, None, None, ("drag", 2.0, 0.0), None]:
        _apply(s, ev)
        s.render()
        passes.append(s.prog.passes)
    assert passes == [1, 2, 3, 1, 2]


def test_session_takes_the_module_not_the_checkpoint():
    _, dt, _, cfg = _pair(rays_per_pixel=4)
    with pytest.raises(TypeError, match="module"):
        InteractiveSession(dt, cfg, denoiser=rt.load_params(CNN))
    s = InteractiveSession(dt, cfg, denoiser=rt.net_for_params(rt.load_params(CNN), device="cpu"))
    assert np.isfinite(s.render().numpy()).all()


def _assert_trees_equal(a, b):
    if isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _assert_trees_equal(a[k], b[k])
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _state(rng, frame):
    prev = rng.random((SIZE, SIZE, 4), dtype=np.float32)
    flow = rng.normal(size=(SIZE, SIZE, 2)).astype(np.float32)
    return prev, flow, frame


def test_session_written_by_jax_resumes_in_the_port(tmp_path):
    rng = np.random.default_rng(3)
    prev, flow, frame = _state(rng, 7)
    cam = rj.Camera(0.6666666666666666, -3.25, 12.5)
    params = jdn.load_params(CNN)
    state = rj.init_frame_state(SIZE, SIZE)._replace(
        prev_image=jnp.asarray(prev), flow=jnp.asarray(flow), frame=jnp.int32(frame))
    path = jck.save_session(str(tmp_path / "j.npz"), state, cam, params)
    st, ct, pt = rt.load_session(path, device="cpu")
    assert np.array_equal(st.prev_image.numpy(), prev)
    assert np.array_equal(st.flow.numpy(), flow) and not st.flow_is_zero
    assert st.frame == frame and ct == _cam(cam)
    _assert_trees_equal(pt, rt.load_params(CNN))


def test_session_written_by_the_port_resumes_in_jax(tmp_path):
    rng = np.random.default_rng(4)
    prev, flow, frame = _state(rng, 12)
    st = rt.FrameState(prev_image=torch.from_numpy(prev), flow=torch.from_numpy(flow),
                       frame=frame)
    cam = rt.Camera(1.5, 4.0, -0.125)
    path = rt.save_session(str(tmp_path / "t.npz"), st, cam)
    sj, cj, pj = jck.load_session(path)
    assert np.array_equal(np.asarray(sj.prev_image), prev)
    assert np.array_equal(np.asarray(sj.flow), flow)
    assert int(sj.frame) == frame and _cam(cj) == cam and pj is None
    with np.load(path) as z:
        assert sorted(z.files) == ["camera", "flow", "frame", "prev_image", "version"]
        assert z["frame"].dtype == np.int32 and z["camera"].dtype == np.float64
        assert int(z["version"]) == 1


def test_resumed_session_renders_the_next_frame_bitwise(tmp_path):
    _, dt, _, cfg = _pair(rays_per_pixel=RPP)
    s = InteractiveSession(dt, cfg)
    for ev in SEQUENCE[:5]:
        _apply(s, ev)
        s.render()
    path = rt.save_session(str(tmp_path / "s.npz"), s.state, s.camera)
    state, cam, params = rt.load_session(path, device="cpu")
    assert params is None and cam == s.camera and state.flow_is_zero
    tables, gl = s.accel_tables()
    want, _ = rt.render_frame(dt, s.camera, s.state, cfg, cand_tables=tables, gather_len=gl)
    got, _ = rt.render_frame(dt, cam, state, cfg, cand_tables=tables, gather_len=gl)
    assert torch.equal(want, got)


def test_load_session_rejects_other_versions(tmp_path):
    path = str(tmp_path / "v.npz")
    np.savez(path, version=np.int64(2))
    with pytest.raises(ValueError, match="version 2"):
        rt.load_session(path, device="cpu")


def test_timing_json_keys_equal_jax(tmp_path):
    outs = []
    for mod in (ttiming, jtiming):
        t = mod.PhaseTimer()
        with t.phase("setup"):
            time.sleep(0.002)
        for _ in range(3):
            with t.phase("frame"):
                pass
        m = mod.Metrics()
        m.inc("rays", 100)
        m.inc("rays", 28)
        m.set("fps", 30.5)
        outs.append((json.loads(t.report()), json.loads(m.dump())))
    (rep_t, met_t), (rep_j, met_j) = outs
    assert rep_t.keys() == rep_j.keys() == {"setup", "frame"}
    for name in rep_t:
        assert rep_t[name].keys() == rep_j[name].keys()
    assert rep_t["frame"]["count"] == 3 and rep_t["setup"]["mean_ms"] >= 2
    assert met_t == met_j == {"counters": {"rays": 128.0}, "gauges": {"fps": 30.5}}


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with ttiming.trace_to(str(tmp_path / "prof")):
        torch.ones(8).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_to_uint8_device_equals_to_uint8():
    rng = np.random.default_rng(5)
    x = rng.normal(0.5, 0.7, (9, 7, 4)).astype(np.float32)
    x[0, 0, 0], x[1, 1, 1], x[2, 2, 2] = np.nan, np.inf, -np.inf
    for flip in (True, False):
        q = to_uint8_device(torch.from_numpy(x), flip_vertical=flip)
        assert q.dtype == torch.uint8 and q.is_contiguous()
        with np.errstate(over="ignore"):
            want = jax_image.to_uint8(x, flip_vertical=flip)  # the JAX package's numpy rule
        assert np.array_equal(q.numpy(), want)
        assert np.array_equal(to_uint8(x, flip_vertical=flip), want)
