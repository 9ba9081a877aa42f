"""The port's CLI end to end, in process, on the CPU (``--device cpu``),
after tests/test_cli.py: the PNG, frames with a session round trip, size and
camera overrides; also the reference's printed lines, the stats JSON, the
shipped UNet by default, the CUDA default and the native scene loader."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from raytracingdiffusioncurves_torch.cli import main, shipped_weights

from conftest import make_scene_xml, simple_curve


@pytest.fixture()
def scene_file(tmp_path):
    xml = make_scene_xml([simple_curve([(10, 14), (30, 25), (40, 40), (50, 52)])], 48, 48)
    p = tmp_path / "scene.xml"
    p.write_text(f"<!DOCTYPE CurveSetXML>\n{xml}")
    return str(p)


def test_cli_renders_png(tmp_path, scene_file):
    out = str(tmp_path / "out.png")
    rc = main([scene_file, "4", "--no-denoiser", "--device", "cpu", "--out", out])
    assert rc == 0 and os.path.exists(out)
    img = np.asarray(Image.open(out))
    assert img.shape == (48, 48, 4)
    assert img.max() > 0


def test_cli_frames_and_session_roundtrip(tmp_path, scene_file, capsys):
    out = str(tmp_path / "o.png")
    ckpt = str(tmp_path / "sess.npz")
    rc = main([scene_file, "2", "--no-denoiser", "--device", "cpu",
               "--frames", "3", "--out", out, "--save-session", ckpt, "--stats"])
    assert rc == 0 and os.path.exists(ckpt)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("Setup took : ") and lines[0].endswith("ms")
    assert any(ln.startswith("Average frame time : ") for ln in lines)
    phases = json.loads(next(ln for ln in lines if ln.startswith('{"scene_load"')))
    assert phases["frame"]["count"] == 2
    assert set(phases) == {"scene_load", "device_build", "accel_build", "first_frame", "frame"}
    metrics = json.loads(next(ln for ln in lines if ln.startswith('{"counters"')))
    assert metrics["counters"] == {"frames": 2.0, "rays": 2.0 * 48 * 48 * 2}
    assert metrics["gauges"]["mean_frame_ms"] > 0 and metrics["gauges"]["width"] == 48
    assert lines[-1] == f"wrote {out}"
    rc = main([scene_file, "2", "--no-denoiser", "--device", "cpu",
               "--resume", ckpt, "--out", out])
    assert rc == 0
    assert "resumed at frame 3 from" in capsys.readouterr().out


def test_cli_size_override_and_camera(tmp_path, scene_file):
    out = str(tmp_path / "z.png")
    rc = main([scene_file, "2", "--no-denoiser", "--device", "cpu",
               "--width", "32", "--height", "32", "--zoom", "0.5",
               "--offset-x", "4", "--out", out])
    assert rc == 0
    assert np.asarray(Image.open(out)).shape[:2] == (32, 32)


def test_cli_runs_the_shipped_weights_by_default(tmp_path, scene_file, monkeypatch):
    import raytracingdiffusioncurves_torch as rt

    built = []
    real = rt.net_for_params

    def spy(params, device=None):
        built.append(real(params, device=device))
        return built[-1]

    monkeypatch.setattr(rt, "net_for_params", spy)
    out = str(tmp_path / "d.png")
    assert main([scene_file, "2", "--device", "cpu", "--width", "24", "--height", "24",
                 "--frames", "2", "--out", out]) == 0
    assert len(built) == 1  # built once, for every frame
    assert os.path.basename(shipped_weights()) == "denoiser_r3d.msgpack"
    assert isinstance(built[0], rt.UNetDenoiser)  # the UNet, whatever the files' mtimes


def test_cli_defaults_to_cuda(scene_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        main([scene_file, "2", "--no-denoiser"])


def test_front_ends_import_no_jax():
    """The CLI, the viewers, the timing utilities and the native loader pull
    in neither jax nor the JAX package."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import raytracingdiffusioncurves_torch.cli, raytracingdiffusioncurves_torch.viewer\n"
        "import raytracingdiffusioncurves_torch.viewer_http\n"
        "import raytracingdiffusioncurves_torch.utils.timing\n"
        "import raytracingdiffusioncurves_torch.scene.native_loader\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('raytracingdiffusioncurves_tpu')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, env=env, timeout=120)
