"""The bilateral filter's dispatch and the kernel wrapper's checks, on the CPU
(the kernel itself, ``csrc/bilateral.cu``, runs only on the card: its
bitwise agreement with the plain version is in tests/test_torch_cuda.py).

* ``ops/bilateral_cuda.py`` imports without nvcc and builds nothing until a
  launch.
* A CPU tensor takes the plain version, bitwise, and launches nothing.
* The wrapper raises on what the kernel does not take, before any build.
* The kernel's name falls in the benchmark's plain-torch layer, not in the
  trace or conv kernels' (``perfbench/layers.py::layer_of``).
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from perfbench import layers
from raytracingdiffusioncurves_torch.ops import bilateral_cuda as bc
from raytracingdiffusioncurves_torch.ops import denoise as td

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _image(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return 0.5 + 0.2 * torch.randn(shape, generator=g)


def test_wrapper_imports_without_nvcc():
    code = ("import sys; import raytracingdiffusioncurves_torch.ops.bilateral_cuda as bc; "
            "assert bc.LAUNCHES == 0; "
            "assert 'raytracingdiffusioncurves_torch.ops._build' not in sys.modules")
    env = {**os.environ, "PATH": "/nonexistent", "PYTHONPATH": str(ROOT)}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT, timeout=120)


@pytest.mark.parametrize("bf16_weights", [True, False])
@pytest.mark.parametrize("shape", [(9, 11, 3), (9, 11, 4), (2, 3, 8, 6, 3), (1, 5, 3)],
                         ids=["c3", "c4", "batch", "one_row"])
def test_cpu_tensor_takes_the_plain_version(shape, bf16_weights):
    img = _image(shape, seed=len(shape))
    bc.reset_launch_count()
    got = td.spatial_bilateral(img, bf16_weights)
    assert torch.equal(got, td.spatial_bilateral_plain(img, bf16_weights))
    assert bc.LAUNCHES == 0


def test_cpu_tensor_view_takes_the_plain_version():
    """The main path's ``image[..., :3]`` view of the (H, W, 4) frame."""
    frame = _image((12, 10, 4), seed=3)
    bc.reset_launch_count()
    got = td.spatial_bilateral(frame[..., :3])
    assert torch.equal(got, td.spatial_bilateral_plain(frame[..., :3].contiguous()))
    assert bc.LAUNCHES == 0


@pytest.mark.parametrize("image,match", [
    (torch.zeros(8, 8, 3, dtype=torch.float64), "float32"),
    (torch.zeros(8, 8, 3, dtype=torch.bfloat16), "float32"),
    (torch.zeros(8, 3), "float32"),
    (torch.zeros(8, 8, 2), "channels"),
    (torch.zeros(8, 8, 9), "channels"),
    (torch.zeros(0, 8, 3), "empty"),
], ids=["float64", "bf16", "no_channel_axis", "two_channels", "nine_channels", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(image, match):
    """The argument check comes first, before the device's and any build."""
    bc.reset_launch_count()
    with pytest.raises(ValueError, match=match):
        bc.bilateral5x5(image, *td._weight_constants(True), True)
    assert bc.LAUNCHES == 0


def test_wrapper_rejects_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        bc.bilateral5x5(torch.zeros(8, 8, 3), *td._weight_constants(True), True)


def test_float4_staging_only_where_each_pixel_has_16_bytes():
    h, w = 6, 5
    frame = torch.zeros(h, w, 4)
    assert bc._float4_pixels(frame[..., :3].reshape(-1, h, w, 3))
    assert bc._float4_pixels(frame.reshape(-1, h, w, 4))
    assert not bc._float4_pixels(torch.zeros(1, h, w, 3))  # 12-byte pixels
    assert not bc._float4_pixels(frame[..., 1:].reshape(-1, h, w, 3))  # 4-byte offset
    # a view whose last pixel's fourth float lies past the storage
    short = torch.zeros(h * w * 4 - 1).as_strided((1, h, w, 3), (0, w * 4, 4, 1))
    assert not bc._float4_pixels(short)


def test_weight_constants_are_the_plain_chains():
    """The bf16 branch's constants are bf16 values; the float32 branch's are
    the Python expressions the plain loop had, tap by tap, dy-major."""
    spatial, inv_sc = td._weight_constants(False)
    r = td.BILATERAL_RADIUS
    want = [-(dx * dx + dy * dy) * (1.0 / (2.0 * 1.5**2))
            for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    assert list(spatial) == want and inv_sc == 1.0 / (2.0 * 0.1**2)
    spatial_b, inv_sc_b = td._weight_constants(True)
    for v in (*spatial_b, inv_sc_b):
        assert float(torch.tensor(v).to(torch.bfloat16)) == v
    assert spatial_b[12] == 0.0 and spatial_b == spatial_b[::-1]


def test_kernel_name_is_in_the_plain_torch_layer():
    """The kernel's name as the profiler shows it (demangled) must contain
    neither the trace nor the conv kernel's name fragment."""
    src = (ROOT / "raytracingdiffusioncurves_torch" / "csrc" / "bilateral.cu").read_text()
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))? (\w+)\(", src)
    assert names == ["bilateral5x5_kernel"]
    for branch in ("true", "false"):
        demangled = (f"void (anonymous namespace)::{names[0]}<{branch}>"
                     f"((anonymous namespace)::Params)")
        assert layers.layer_of(demangled) == "torch"
