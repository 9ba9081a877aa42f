"""The port's analytic denoiser (``ops/denoise.py``) vs the JAX package, on
seeded numpy images.

* ``spatial_bilateral``, float32 branch: within 2e-6 of JAX's (measured
  1.2e-7: the same float32 expressions, exp differs in the last ulp).
* bf16 weight chain: PyTorch rounds every step of the chain to bf16, and so
  does JAX run eagerly: bitwise equal outputs.  Under ``jax.jit`` (how the
  JAX renderer runs it) XLA keeps parts of the fused chain in float32, which
  moves single weights by up to ~1e-2 relative, by design of the bf16 chain;
  the filtered image then differs by up to 1.6e-3 (measured; mean 3e-5).
  Bar there: max 5e-3, mean 1e-4.
* ``temporal_denoise`` at frame 0 and frame 1 with a zoom + pan flow, vs
  JAX's jitted function: the same bars as the jitted bilateral inside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingdiffusioncurves_torch.ops import denoise as td
from raytracingdiffusioncurves_torch.ops import flow as tf
from raytracingdiffusioncurves_tpu.ops import denoise as jd
from raytracingdiffusioncurves_tpu.ops import flow as jf

H, W = 40, 52


def _image(seed, c):
    rng = np.random.default_rng(seed)
    # smooth field + noise: both flat and busy neighbourhoods
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(xx / 9.0)[..., None] * np.cos(yy / 7.0)[..., None]
    return (base + 0.05 * rng.standard_normal((H, W, c))).astype(np.float32)


@pytest.fixture
def jax_bilateral_flag():
    saved = jd.BILATERAL_BF16
    yield
    jd.BILATERAL_BF16 = saved


@pytest.mark.parametrize("channels", [3, 4])
def test_bilateral_float32_branch(channels, jax_bilateral_flag):
    img = _image(channels, channels)
    jd.BILATERAL_BF16 = False
    a = np.asarray(jd.spatial_bilateral(jnp.asarray(img)))
    b = td.spatial_bilateral(torch.tensor(img), bf16_weights=False).numpy()
    np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)


@pytest.mark.parametrize("channels", [3, 4])
def test_bilateral_bf16_branch_eager_bitwise(channels, jax_bilateral_flag):
    img = _image(10 + channels, channels)
    jd.BILATERAL_BF16 = True
    a = np.asarray(jd.spatial_bilateral(jnp.asarray(img)))
    b = td.spatial_bilateral(torch.tensor(img)).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("channels", [3, 4])
def test_bilateral_bf16_branch_vs_jit(channels, jax_bilateral_flag):
    img = _image(20 + channels, channels)
    jd.BILATERAL_BF16 = True
    a = np.asarray(jax.jit(jd.spatial_bilateral)(jnp.asarray(img)))
    b = td.spatial_bilateral(torch.tensor(img)).numpy()
    d = np.abs(a - b)
    assert d.max() < 5e-3 and d.mean() < 1e-4


def test_bilateral_keeps_constants_exact():
    img = torch.full((12, 12, 4), 0.8)
    assert torch.equal(td.spatial_bilateral(img), img)


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("moving", [False, True])
def test_temporal_denoise_matches_jax(frame, moving):
    img, prev = _image(31, 4), _image(32, 4)
    fj, ft = jf.zero_flow(H, W), tf.zero_flow(H, W, device="cpu")
    if moving:
        fj = jf.add_translation_flow(jf.add_zoom_flow(fj, 1.0, 1.1), 1.5, -0.75)
        ft = tf.add_translation_flow(tf.add_zoom_flow(ft, 1.0, 1.1), 1.5, -0.75)
    a = np.asarray(jd.temporal_denoise(jnp.asarray(img), jnp.asarray(prev), fj,
                                       jnp.int32(frame), 1.0))
    b = td.temporal_denoise(torch.tensor(img), torch.tensor(prev), ft, frame, 1.0,
                            flow_is_zero=not moving).numpy()
    d = np.abs(a - b)
    assert d.max() < 5e-3 and d.mean() < 1e-4
    if frame == 0:  # no history: the spatial pass alone, up to the lerp's rounding
        np.testing.assert_allclose(b, td.spatial_bilateral(torch.tensor(img)).numpy(),
                                   atol=1e-6, rtol=0)


def test_temporal_denoise_zero_flow_skip_is_exact():
    img, prev = torch.tensor(_image(41, 4)), torch.tensor(_image(42, 4))
    zero = tf.zero_flow(H, W, device="cpu")
    a = td.temporal_denoise(img, prev, zero, 3, 1.0, flow_is_zero=True)
    b = td.temporal_denoise(img, prev, zero, 3, 1.0, flow_is_zero=False)
    assert torch.equal(a, b)


def test_temporal_denoise_mix_semantics():
    """blendFactor = 1 - mix (optixHello.cpp:1131): mix=0 returns the input;
    a shifted history is warped back by the flow before blending."""
    img = torch.full((8, 8, 4), 0.8)
    zero = tf.zero_flow(8, 8, device="cpu")
    out = td.temporal_denoise(img, torch.zeros_like(img), zero, 1, mix=0.0)
    np.testing.assert_allclose(out.numpy(), img.numpy(), atol=1e-6)
    cur = torch.zeros(16, 16, 4)
    prev = torch.zeros(16, 16, 4)
    prev[:, 8:, :] = 1.0
    fl = tf.add_translation_flow(tf.zero_flow(16, 16, device="cpu"), 4.0, 0.0)
    out = td.temporal_denoise(cur, prev, fl, 3, mix=1.0)
    assert out[8, 13, 0] > out[8, 3, 0]
