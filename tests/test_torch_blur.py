"""Port variable-sigma blur vs the JAX package's: within 2e-5 (the JAX
package's own bar against the reference loop; the two differ only in how
exp rounds), at tap bounds 0, 3 and 9.

The dispatch and the kernel wrapper's checks, on the CPU (the kernel itself,
``csrc/blur.cu``, runs only on the card: its bitwise agreement with the
plain version is in tests/test_torch_cuda.py):

* ``ops/blur_cuda.py`` imports without nvcc and builds nothing until a
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

import numpy as np
import pytest
import torch

from perfbench import layers
from raytracingdiffusioncurves_tpu.ops import blur as jblur
from raytracingdiffusioncurves_torch.ops import blur as tblur
from raytracingdiffusioncurves_torch.ops import blur_cuda as tbc

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("radius", [0, 3, 9])
def test_blur_matches_jax(radius):
    rng = np.random.default_rng(radius)
    img = rng.uniform(0, 1, (17, 23, 4)).astype(np.float32)
    sigma = rng.uniform(0, radius / 3.0, (17, 23)).astype(np.float32)
    sigma[rng.uniform(size=sigma.shape) < 0.2] = 0.0
    want = np.asarray(jblur.variable_gaussian_blur(img, sigma, radius=radius))
    got = tblur.variable_gaussian_blur(torch.from_numpy(img), torch.from_numpy(sigma), radius)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_zero_sigma_is_exact_identity():
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.uniform(0, 1, (9, 11, 4)).astype(np.float32))
    out = tblur.variable_gaussian_blur(img, torch.zeros(9, 11), 6)
    assert torch.equal(out, img)


def test_wrapper_imports_without_nvcc():
    code = ("import sys; import raytracingdiffusioncurves_torch.ops.blur as b; "
            "assert b.blur_cuda.LAUNCHES == 0; "
            "assert 'raytracingdiffusioncurves_torch.ops._build' not in sys.modules")
    env = {**os.environ, "PATH": "/nonexistent", "PYTHONPATH": str(ROOT)}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT, timeout=120)


@pytest.mark.parametrize("shape,radius,halo", [((17, 23, 4), 6, (0, 0)), ((17, 23, 4), 6, (6, 3)),
                                               ((9, 11, 3), 2, (0, 2)), ((5, 8, 1), 9, (1, 0))],
                         ids=["frame", "band", "c3", "c1_past_the_frame"])
def test_cpu_tensor_takes_the_plain_version(shape, radius, halo):
    rng = np.random.default_rng(len(shape) + radius)
    img = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
    sigma = torch.from_numpy(rng.uniform(0, radius / 3.0, shape[:2]).astype(np.float32))
    tbc.reset_launch_count()
    got = tblur.variable_gaussian_blur(img, sigma, radius, halo)
    assert torch.equal(got, tblur.variable_gaussian_blur_plain(img, sigma, radius, halo))
    assert got.shape == (shape[0] - sum(halo), *shape[1:])
    assert tbc.LAUNCHES == 0


_ZEROS = torch.zeros(8, 8)


@pytest.mark.parametrize("image,sigma,radius,halo,match", [
    (torch.zeros(8, 8, 4, dtype=torch.float64), _ZEROS, 6, (0, 0), "float32"),
    (torch.zeros(8, 8, 4, dtype=torch.bfloat16), _ZEROS, 6, (0, 0), "float32"),
    (torch.zeros(8, 8), _ZEROS, 6, (0, 0), "float32"),
    (torch.zeros(8, 8, 5), _ZEROS, 6, (0, 0), "channels"),
    (torch.zeros(0, 8, 4), torch.zeros(0, 8), 6, (0, 0), "empty"),
    (torch.zeros(8, 8, 4), torch.zeros(8, 9), 6, (0, 0), "sigma map"),
    (torch.zeros(8, 8, 4), torch.zeros(8, 8, dtype=torch.float64), 6, (0, 0), "sigma map"),
    (torch.zeros(8, 8, 4), _ZEROS, -1, (0, 0), "radius"),
    (torch.zeros(8, 8, 4), _ZEROS, 6, (4, 4), "halo"),
    (torch.zeros(8, 8, 4), _ZEROS, 6, (-1, 0), "halo"),
], ids=["float64", "bf16", "no_channel_axis", "five_channels", "empty", "sigma_shape",
        "sigma_float64", "negative_radius", "halo_covers_the_rows", "negative_halo"])
def test_wrapper_rejects_what_the_kernel_does_not_take(image, sigma, radius, halo, match):
    """The argument check comes first, before the device's and any build."""
    tbc.reset_launch_count()
    with pytest.raises(ValueError, match=match):
        tbc.variable_blur(image, sigma, radius, halo)
    assert tbc.LAUNCHES == 0


def test_wrapper_rejects_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        tbc.variable_blur(torch.zeros(8, 8, 4), torch.zeros(8, 8), 6)


def test_kernel_name_is_in_the_plain_torch_layer():
    """The kernel's name as the profiler shows it (demangled) must contain
    neither the trace nor the conv kernel's name fragment."""
    src = (ROOT / "raytracingdiffusioncurves_torch" / "csrc" / "blur.cu").read_text()
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))? (\w+)\(", src)
    assert names == ["variable_blur_kernel"]
    demangled = f"(anonymous namespace)::{names[0]}((anonymous namespace)::Params)"
    assert layers.layer_of(demangled) == "torch"
