"""Port renderer vs the JAX package, plus the package's import and device
rules.

* Two chained frames with blur on against JAX ``render_frame(backend=
  "jax")`` at 64^2, with the assert_parity bars (fewer than 3e-5 of values
  off by more than 1e-3, mean below 1e-4): trace differences are pow
  rounding and sum order, the blur adds exp rounding (< 2e-5).
* ``import raytracingdiffusioncurves_torch`` pulls in neither jax nor the
  JAX package.
* Entry points default to CUDA and raise when it is absent.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import raytracingdiffusioncurves_torch as rt
import raytracingdiffusioncurves_tpu as rj
from raytracingdiffusioncurves_torch.ops import trace_cuda as tc
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


def test_denoiser_not_ported_raises():
    xml = seeded_scene_xml(0, 16, 16)
    dt = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    st = rt.init_frame_state(16, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        rt.render_frame(dt, rt.Camera(), st, rt.RenderConfig(rays_per_pixel=4))


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import raytracingdiffusioncurves_torch\n"
        "import raytracingdiffusioncurves_torch.ops._build\n"
        "import raytracingdiffusioncurves_torch.utils.scenes\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('raytracingdiffusioncurves_tpu')]\n"
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
