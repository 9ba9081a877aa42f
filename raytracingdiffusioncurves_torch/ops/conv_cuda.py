"""The denoisers' 3x3 convolution: the dispatch between the CUDA kernel and
its plain PyTorch version.

``conv3x3`` computes, for one NHWC bf16 image,

    y = relu?( bf16( sum_groups sum_taps x_g (*) k_g ) + bias_bf16 )

over 1 to 3 input groups (a channel concat is extra groups, never a copy),
HWIO kernels, stride 1 or 2 with JAX's SAME padding, float32 accumulation,
the accumulator rounded to bf16 *before* the bf16 bias is added (what
``conv_general_dilated(x, k) + b`` computes on bf16 operands), optional
ReLU.  A group may be read through a nearest 2x upsample.  On CUDA tensors
it launches the hand-written kernel ``csrc/conv3x3.cu``, which replaces the
JAX package's Pallas kernels ``ops/conv_pallas.py::_flat_kernel``
(``conv3x3_flat``) and ``::_conv_kernel`` (``conv3x3_same``): an implicit
GEMM on the tensor cores (``mma.sync`` m16n8k16, bf16 in, float32
accumulate) over halo tiles staged in shared memory with ``cp.async``, all
of Cout in one block.  On CPU tensors it runs ``conv3x3_plain``.  There is
no fallback between the two: a CUDA tensor either goes through the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

MAX_GROUPS = 3

# Launches of the CUDA convolution kernel since the last reset (one per
# conv3x3 call on CUDA tensors).  The tests read it to show that the
# denoised frame went through the kernel.
LAUNCHES = 0


def reset_launch_count() -> None:
    global LAUNCHES
    LAUNCHES = 0


def same_padding(n: int, stride: int) -> tuple[int, int, int]:
    """(output size, pad before, pad after) of JAX's SAME padding for a
    window of 3 along an axis of ``n``: stride 1 pads (1, 1); stride 2 pads
    (0, 1) on an even axis, so y[i] = sum_k w[k] x[2i + k]."""
    out = -(-n // stride)
    total = max((out - 1) * stride + 3 - n, 0)
    return out, total // 2, total - total // 2


def _check_args(xs, ks, b, stride, upsample):
    """Validate one call; returns (h_in, w_in, cout, upsample tuple)."""
    if not 1 <= len(xs) <= MAX_GROUPS or len(ks) != len(xs):
        raise ValueError(f"1 to {MAX_GROUPS} input groups with one kernel each, got "
                         f"{len(xs)} inputs and {len(ks)} kernels")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    upsample = tuple(upsample) if upsample is not None else (False,) * len(xs)
    if len(upsample) != len(xs):
        raise ValueError("one upsample flag per input group")
    cout = ks[0].shape[-1]
    sizes = set()
    for i, (x, k, up) in enumerate(zip(xs, ks, upsample)):
        if x.dim() != 3 or x.dtype != torch.bfloat16:
            raise ValueError(f"input {i} must be a bf16 (H, W, C) tensor, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if tuple(k.shape) != (3, 3, x.shape[2], cout) or k.dtype != torch.bfloat16:
            raise ValueError(f"kernel {i} must be bf16 (3, 3, {x.shape[2]}, {cout}), got "
                             f"{tuple(k.shape)} {k.dtype}")
        if x.device != xs[0].device or k.device != xs[0].device:
            raise ValueError("all inputs and kernels must lie on one device")
        sizes.add((x.shape[0] << int(up), x.shape[1] << int(up)))
    if len(sizes) != 1:
        raise ValueError(f"input groups disagree on the image size: {sorted(sizes)}")
    if tuple(b.shape) != (cout,) or b.dtype != torch.bfloat16 or b.device != xs[0].device:
        raise ValueError(f"bias must be bf16 ({cout},) on the inputs' device")
    (h_in, w_in), = sizes
    return h_in, w_in, cout, upsample


def conv3x3(
    xs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    b: torch.Tensor,
    stride: int = 1,
    relu: bool = True,
    upsample: Sequence[bool] | None = None,
) -> torch.Tensor:
    """SAME 3x3 convolution of the bf16 groups ``xs`` (H, W, C_i) with the
    bf16 kernels ``ks`` (3, 3, C_i, Cout) and bf16 bias ``b``; returns
    (H_out, W_out, Cout) bf16.  ``upsample[i]``: group i is given at half
    size and read through a nearest 2x upsample.  CUDA tensors go through the
    kernel, CPU tensors through ``conv3x3_plain``."""
    device = xs[0].device
    if device.type == "cuda":
        return _conv3x3_cuda(xs, ks, b, stride, relu, upsample)
    if device.type != "cpu":
        raise RuntimeError(f"no convolution path for device {device}")
    return conv3x3_plain(xs, ks, b, stride, relu, upsample)


def conv3x3_same(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, relu: bool = True):
    """The one-group entry (the JAX package's ``conv_pallas.conv3x3_same``):
    SAME 3x3 conv of ``x`` (H, W, Cin) with ``k`` (3, 3, Cin, Cout) and bias
    ``b`` (Cout,), operands cast to bf16, fused ReLU.  Returns (H, W, Cout)
    bf16."""
    bf = torch.bfloat16
    return conv3x3([x.to(bf)], [k.to(bf)], b.to(bf), 1, relu)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def conv3x3_plain(xs, ks, b, stride=1, relu=True, upsample=None) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device: each tap is a
    float32 matrix product of the shifted image with that tap's (Cin, Cout)
    kernel slice, summed in float32.  The operands hold bf16 values, so
    every product is exact in float32 and only the order of the sum is free.
    A float32 ``torch.matmul`` runs in full float32 unless the caller turned
    TF32 on (``torch.backends.cuda.matmul.allow_tf32``, off by default);
    ``F.conv2d`` is not used because cuDNN takes TF32 and transformed
    algorithms for a float32 convolution."""
    h_in, w_in, cout, upsample = _check_args(xs, ks, b, stride, upsample)
    h_out, pad_top, pad_bottom = same_padding(h_in, stride)
    w_out, pad_left, pad_right = same_padding(w_in, stride)
    acc = None
    for x, k, up in zip(xs, ks, upsample):
        xf = x.to(torch.float32)
        if up:
            xf = xf.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        xp = F.pad(xf, (0, 0, pad_left, pad_right, pad_top, pad_bottom))
        kf = k.to(torch.float32)
        for dy in range(3):
            for dx in range(3):
                win = xp[dy : dy + (h_out - 1) * stride + 1 : stride,
                         dx : dx + (w_out - 1) * stride + 1 : stride]
                term = win.reshape(h_out * w_out, -1) @ kf[dy, dx]
                acc = term if acc is None else acc + term
    y = acc.reshape(h_out, w_out, cout).to(torch.bfloat16) + b
    return torch.relu(y) if relu else y


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _conv3x3_cuda(xs, ks, b, stride, relu, upsample) -> torch.Tensor:
    """Launch csrc/conv3x3.cu on the inputs' card; one launch per call."""
    global LAUNCHES
    from . import _build  # builds csrc/conv3x3.cu on first use

    h_in, w_in, cout, upsample = _check_args(xs, ks, b, stride, upsample)
    for i, t in enumerate((*xs, *ks, b)):
        if not t.is_contiguous():
            raise ValueError(f"conv3x3 argument {i} must be contiguous")
    h_out, pad_top, _ = same_padding(h_in, stride)
    w_out, pad_left, _ = same_padding(w_in, stride)
    out = torch.empty((h_out, w_out, cout), dtype=torch.bfloat16, device=xs[0].device)
    n = len(xs)
    fill = [None] * (MAX_GROUPS - n)
    lib = _build.load("conv3x3")
    stream = torch.cuda.current_stream(xs[0].device).cuda_stream
    err = lib.rtdc_conv3x3(
        *[x.data_ptr() for x in xs], *fill,
        *[k.data_ptr() for k in ks], *fill,
        *[x.shape[2] for x in xs], *[0] * (MAX_GROUPS - n),
        *[int(u) for u in upsample], *[0] * (MAX_GROUPS - n), n,
        b.data_ptr(), out.data_ptr(),
        h_in, w_in, h_out, w_out, cout,
        stride, pad_top, pad_left, int(relu), ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: {_build.error_string(lib, err)}")
    LAUNCHES += 1
    return out


def kernel_instances() -> list[dict]:
    """What the build made of each instantiation of the kernel (padded
    output channels, stride): its tile, registers per thread, shared memory
    and spilled bytes, from ``cudaFuncGetAttributes`` on the card."""
    from . import _build

    lib = _build.load("conv3x3")
    keys = ("np", "stride", "tile_rows", "tile_cols", "registers", "dynamic_smem_bytes",
            "static_smem_bytes", "local_bytes")
    out = []
    for i in range(lib.rtdc_conv3x3_info(-1, None)):
        vals = (ctypes.c_int * len(keys))()
        err = lib.rtdc_conv3x3_info(i, vals)
        if err != 0:
            raise RuntimeError(f"conv3x3 kernel attributes: {_build.error_string(lib, err)}")
        out.append(dict(zip(keys, vals)))
    return out
