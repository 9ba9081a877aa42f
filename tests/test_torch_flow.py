"""The port's optical-flow ops (``ops/flow.py``) vs the JAX package.

Inputs come from numpy with a seed.  The flow writers and the resampling
matrices are bitwise equal to JAX's (the same float32 expressions); the two
warps agree within 2e-6 (the bar the JAX package's own test holds its
separable warp to against the gather warp: same bilinear weights, another
order of the sums); a zero flow reproduces the image bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingdiffusioncurves_torch.ops import flow as tf
from raytracingdiffusioncurves_tpu.ops import flow as jf

H, W = 33, 47


def _flows():
    fj = jf.zero_flow(H, W)
    ft = tf.zero_flow(H, W, device="cpu")
    fj = jf.add_zoom_flow(fj, 1.0, 1.37)
    ft = tf.add_zoom_flow(ft, 1.0, 1.37)
    fj = jf.add_translation_flow(fj, 2.25, -1.5)
    ft = tf.add_translation_flow(ft, 2.25, -1.5)
    fj = jf.add_zoom_flow(fj, 1.37, 0.8)
    ft = tf.add_zoom_flow(ft, 1.37, 0.8)
    return fj, ft


def _image(seed, c=4):
    return np.random.default_rng(seed).uniform(size=(H, W, c)).astype(np.float32)


def test_zero_flow():
    f = tf.zero_flow(5, 7, device="cpu")
    assert f.shape == (5, 7, 2) and f.dtype == torch.float32 and not f.any()


def test_flow_writers_bitwise():
    fj, ft = _flows()
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())


@pytest.mark.parametrize("n", [H, W])
def test_resample_matrix_bitwise(n):
    pos = np.random.default_rng(n).uniform(-3.0, n + 3.0, size=n).astype(np.float32)
    a = np.asarray(jf._resample_matrix(jnp.asarray(pos), n))
    b = tf._resample_matrix(torch.tensor(pos), n).numpy()
    np.testing.assert_array_equal(a, b)


def test_warp_separable_matches_jax():
    fj, ft = _flows()
    img = _image(3)
    a = np.asarray(jf.warp_separable(jnp.asarray(img), fj))
    b = tf.warp_separable(torch.tensor(img), ft).numpy()
    np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)


def test_warp_by_flow_matches_jax():
    fj, ft = _flows()
    img = _image(4)
    a = np.asarray(jf.warp_by_flow(jnp.asarray(img), fj))
    b = tf.warp_by_flow(torch.tensor(img), ft).numpy()
    np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)


def test_warp_separable_matches_generic():
    _, ft = _flows()
    img = torch.tensor(_image(5))
    np.testing.assert_allclose(tf.warp_by_flow(img, ft).numpy(),
                               tf.warp_separable(img, ft).numpy(), atol=2e-6, rtol=0)


def test_zero_flow_is_identity_bitwise():
    """Identity resampling matrices reproduce the image bit for bit, so the
    renderer's host-side skip of the warp changes no value."""
    img = torch.tensor(_image(7))
    zero = tf.zero_flow(H, W, device="cpu")
    assert torch.equal(tf.warp_separable(img, zero), img)
    assert torch.equal(tf.warp_by_flow(img, zero), img)
    moved = tf.warp_separable(img, tf.add_translation_flow(zero, 0.5, 0.0))
    assert float((moved - img).abs().max()) > 0.0


@pytest.mark.parametrize("row0,rows", [(0, 11), (11, 11), (22, 11), (16, 17)])
def test_band_zoom_flow_bitwise_vs_jax(row0, rows):
    """``add_zoom_flow`` on a row band (``row0=``, ``height=``, as the row-
    sharded FrameState calls it) gives the rows of JAX's whole-frame field,
    also on a band of an earlier flow."""
    fj, ft = _flows()
    band = slice(row0, row0 + rows)
    want = np.asarray(jf.add_zoom_flow(fj, 0.8, 1.1))[band]
    got = tf.add_zoom_flow(ft[band], 0.8, 1.1, row0=row0, height=H).numpy()
    np.testing.assert_array_equal(want, got)
