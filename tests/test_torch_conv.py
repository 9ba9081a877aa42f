"""The port's plain 3x3 convolution (``ops/conv_cuda.conv3x3_plain``, the
version the CUDA kernel is held against on the card) vs the JAX package.

Inputs are made with numpy from a seed and handed to both sides.  The JAX
side is the Pallas kernels in interpret mode (``conv_pallas.conv3x3_same``
and ``conv3x3_flat``) or XLA's bf16 ``conv_general_dilated`` + bias.  Both
sides multiply the same bf16 values (every product exact in float32), round
the float32 accumulator to bf16 and then add the bf16 bias; only the order
of the float32 sum is free.  Bar: at least 99% of values bitwise equal and
none off by more than one bf16 step of the accumulator (the value that is
rounded before the bias is added) plus one of the result, which is rounded
again: |diff| <= 2^-7 * (2 |y| + |bias|).  (A step of the accumulator is
several steps of y where the bias cancels most of it.)  Measured here: all
equal but one value of the two-group case, which is one accumulator step
off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingdiffusioncurves_torch.ops import conv_cuda as cc
from raytracingdiffusioncurves_tpu.ops import conv_pallas

BF = torch.bfloat16
DN = ("NHWC", "HWIO", "NHWC")
# the shapes of tests/test_denoiser.py::test_pallas_conv_matches_xla_conv
SHAPES = [(23, 37, 11, 24, True), (16, 20, 44, 96, True), (9, 50, 24, 12, False)]


def _t(a, dtype=None):
    x = torch.tensor(np.asarray(a, np.float32))
    return x if dtype is None else x.to(dtype)


def _assert_bf16_close(ref, got, bias):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert ref.shape == got.shape
    assert (ref == got).mean() >= 0.99
    bias = np.asarray(torch.tensor(np.asarray(bias, np.float32)).to(BF).float())
    step = 2.0**-7 * (2.0 * np.maximum(np.abs(ref), np.abs(got)) + np.abs(bias))
    assert (np.abs(ref - got) <= step).all()


def _inputs(seed, h, w, ci, co):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((h, w, ci)).astype(np.float32)
    k = (rng.standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize("h,w,ci,co,relu", SHAPES)
def test_plain_matches_pallas_conv3x3_same(h, w, ci, co, relu):
    x, k, b = _inputs(h, h, w, ci, co)
    ref = conv_pallas.conv3x3_same(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), relu=relu)
    got = cc.conv3x3_same(_t(x), _t(k), _t(b), relu)
    assert got.dtype == BF
    _assert_bf16_close(ref, got.float().numpy(), b)


@pytest.mark.parametrize("h,w,ci,co,relu", SHAPES)
def test_plain_matches_pallas_conv3x3_flat(h, w, ci, co, relu):
    x, k, b = _inputs(w, h, w, ci, co)
    flat = conv_pallas.conv3x3_flat(
        [conv_pallas.to_flat(jnp.asarray(x))], [jnp.asarray(k)], jnp.asarray(b), h, w, relu=relu)
    ref = conv_pallas.from_flat(flat, h, w, co)
    got = cc.conv3x3([_t(x, BF)], [_t(k, BF)], _t(b, BF), 1, relu)
    _assert_bf16_close(ref, got.float().numpy(), b)


def test_plain_two_groups_match_pallas_conv3x3_flat():
    """A channel concat as two contraction groups (dec1's layout)."""
    h, w = 12, 20
    rng = np.random.default_rng(5)
    xa = rng.standard_normal((h, w, 16)).astype(np.float32)
    xb = rng.standard_normal((h, w, 8)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 24, 16)) * 0.1).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    flat = conv_pallas.conv3x3_flat(
        [conv_pallas.to_flat(jnp.asarray(xa)), conv_pallas.to_flat(jnp.asarray(xb))],
        [jnp.asarray(k[:, :, :16]), jnp.asarray(k[:, :, 16:])], jnp.asarray(b), h, w)
    ref = conv_pallas.from_flat(flat, h, w, 16)
    kt = _t(k, BF)
    got = cc.conv3x3([_t(xa, BF), _t(xb, BF)],
                     [kt[:, :, :16].contiguous(), kt[:, :, 16:].contiguous()], _t(b, BF))
    _assert_bf16_close(ref, got.float().numpy(), b)


@pytest.mark.parametrize("stride", [1, 2])
def test_plain_upsampled_group_and_stride_match_xla(stride):
    """Group 0 read through a nearest 2x upsample, concatenated with a
    full-size group, at both strides, vs XLA's conv on the materialized
    concat (stride 2 on an even size pads (0, 1))."""
    rng = np.random.default_rng(7)
    x1 = rng.standard_normal((12, 16, 10)).astype(np.float32)
    x2 = rng.standard_normal((24, 32, 6)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 16, 20)) * 0.1).astype(np.float32)
    b = rng.standard_normal(20).astype(np.float32)
    jb = jnp.bfloat16
    up = jnp.repeat(jnp.repeat(jnp.asarray(x1), 2, 0), 2, 1)
    cat = jnp.concatenate([up, jnp.asarray(x2)], -1).astype(jb)
    ref = jax.lax.conv_general_dilated(
        cat[None], jnp.asarray(k).astype(jb), (stride, stride), "SAME", dimension_numbers=DN,
    )[0] + jnp.asarray(b).astype(jb)
    ref = jnp.maximum(ref, jb(0))
    kt = _t(k, BF)
    got = cc.conv3x3([_t(x1, BF), _t(x2, BF)],
                     [kt[:, :, :10].contiguous(), kt[:, :, 10:].contiguous()],
                     _t(b, BF), stride, True, (True, False))
    assert got.shape == (24 // stride, 32 // stride, 20)
    _assert_bf16_close(ref, got.float().numpy(), b)


def test_plain_stride2_odd_size_matches_xla():
    """Odd sizes at stride 2 pad (1, 1), as JAX's SAME does."""
    x, k, b = _inputs(11, 13, 17, 8, 5)
    jb = jnp.bfloat16
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x).astype(jb)[None], jnp.asarray(k).astype(jb), (2, 2), "SAME",
        dimension_numbers=DN,
    )[0] + jnp.asarray(b).astype(jb)
    got = cc.conv3x3([_t(x, BF)], [_t(k, BF)], _t(b, BF), 2, False)
    assert got.shape == (7, 9, 5)
    _assert_bf16_close(ref, got.float().numpy(), b)


def test_bias_is_added_after_rounding():
    """Round-then-add.  At the centre pixel the accumulator is exactly
    1 + 2^-8, which rounds to 1.0 in bf16 (tie to even); adding the bias
    2^-8 gives 1 + 2^-8 again, so y = 1.0.  Adding the bias to the float32
    accumulator first would give 1 + 2^-7 = 1.0078125, a bf16 value."""
    x = torch.zeros(4, 4, 1)
    k = torch.zeros(3, 3, 1, 1)
    x[1, 1, 0], k[1, 1, 0, 0] = 1.0, 1.0
    x[1, 2, 0], k[1, 2, 0, 0] = 2.0**-8, 1.0
    b = torch.tensor([2.0**-8])
    y = cc.conv3x3([x.to(BF)], [k.to(BF)], b.to(BF), 1, False)
    assert float(y[1, 1, 0]) == 1.0


@pytest.mark.parametrize("n,stride,expect", [
    (8, 1, (8, 1, 1)), (7, 1, (7, 1, 1)), (8, 2, (4, 0, 1)), (7, 2, (4, 1, 1)), (1, 2, (1, 1, 1)),
])
def test_same_padding(n, stride, expect):
    assert cc.same_padding(n, stride) == expect


def test_conv3x3_rejects_bad_arguments():
    x = torch.zeros(8, 8, 4, dtype=BF)
    k = torch.zeros(3, 3, 4, 6, dtype=BF)
    b = torch.zeros(6, dtype=BF)
    with pytest.raises(ValueError, match="bf16"):
        cc.conv3x3([x.float()], [k], b)
    with pytest.raises(ValueError, match="kernel 0"):
        cc.conv3x3([x], [k[:, :, :3]], b)
    with pytest.raises(ValueError, match="stride"):
        cc.conv3x3([x], [k], b, stride=3)
    with pytest.raises(ValueError, match="image size"):
        cc.conv3x3([x, x], [k, k], b, upsample=(True, False))
    with pytest.raises(ValueError, match="bias"):
        cc.conv3x3([x], [k], b[:5])
    with pytest.raises(ValueError, match="groups"):
        cc.conv3x3([x] * 4, [k] * 4, b)


def test_cpu_tensors_never_launch_the_kernel():
    cc.reset_launch_count()
    x = torch.zeros(8, 8, 4, dtype=BF)
    y = cc.conv3x3([x], [torch.zeros(3, 3, 4, 6, dtype=BF)], torch.ones(6, dtype=BF))
    assert y.device.type == "cpu" and cc.LAUNCHES == 0
    assert torch.equal(y.float(), torch.ones(8, 8, 6))
