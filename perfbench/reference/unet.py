"""The learned denoiser in plain PyTorch: the UNet of the shipped checkpoint
(11 -> 24 -> 48 -> 96 channels, two stride-2 levels, nearest 2x upsamples)
on bf16 operands with float32 sums, and its inference wrapper.

It computes the network as the flax module that defines it does: the input
and every layer's kernel and bias cast to bf16, each 3x3 tap a float32
product (exact for bf16 operands), the sum rounded to bf16 and only then the
bf16 bias added.  Weights are a flat dict ``{"enc0a/kernel": (3, 3, Cin,
Cout), "enc0a/bias": (Cout,), ...}`` of float32 arrays, read from the
benchmark's own copy of the checkpoint.

``round_operands`` lets the control put another operand precision in place
of bf16 (see ``frame.Precision``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import denoise

BF16 = torch.bfloat16
LAYERS = ("enc0a", "enc0b", "enc1a", "enc1b", "enc2a", "enc2b", "dec1", "dec0", "out")
# Receptive field of the UNet's residual in rows (above, below), worked out
# from its layers: 15 up, 18 down; plus the bilateral's radius feeding its
# analytic input; rounded up to a multiple of BAND_ALIGN.
BAND_HALO = 20
BAND_ALIGN = 4


def same_padding(n: int, stride: int) -> tuple[int, int, int]:
    """(output size, pad before, pad after) of SAME padding for a window of
    3: stride 1 pads (1, 1); stride 2 pads (0, 1) on an even axis."""
    out = -(-n // stride)
    total = max((out - 1) * stride + 3 - n, 0)
    return out, total // 2, total - total // 2


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16)


def conv3x3(xs, ks, b, stride=1, relu=True, upsample=None, round_operands=_bf16):
    """SAME 3x3 convolution of the channel groups ``xs`` (H, W, C_i) with the
    kernels ``ks`` (3, 3, C_i, Cout), nearest 2x upsampled where flagged, plus
    the bias ``b``; each tap a float32 matrix product."""
    upsample = tuple(upsample) if upsample is not None else (False,) * len(xs)
    h_in = xs[0].shape[0] * (2 if upsample[0] else 1)
    w_in = xs[0].shape[1] * (2 if upsample[0] else 1)
    h_out, pad_top, pad_bottom = same_padding(h_in, stride)
    w_out, pad_left, pad_right = same_padding(w_in, stride)
    cout = ks[0].shape[-1]
    acc = None
    for x, k, up in zip(xs, ks, upsample):
        xf = round_operands(x).to(torch.float32)
        if up:
            xf = xf.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        xp = F.pad(xf, (0, 0, pad_left, pad_right, pad_top, pad_bottom))
        kf = round_operands(k).to(torch.float32)
        for dy in range(3):
            for dx in range(3):
                win = xp[dy: dy + (h_out - 1) * stride + 1: stride,
                         dx: dx + (w_out - 1) * stride + 1: stride]
                term = win.reshape(h_out * w_out, -1) @ kf[dy, dx]
                acc = term if acc is None else acc + term
    y = round_operands(acc.reshape(h_out, w_out, cout)).to(BF16) + round_operands(b).to(BF16)
    return torch.relu(y) if relu else y


def residual(weights: dict, x: torch.Tensor, round_operands=_bf16) -> torch.Tensor:
    """The UNet's residual of ``x`` (H, W, 11), H and W multiples of 4."""
    def conv(name, xs, stride=1, relu=True, upsample=None):
        k = weights[f"{name}/kernel"]
        sizes = [v.shape[-1] for v in xs]
        ks = list(torch.split(k, sizes, dim=2))
        return conv3x3(xs, ks, weights[f"{name}/bias"], stride, relu, upsample,
                       round_operands)

    e0 = conv("enc0b", [conv("enc0a", [x])])
    e1 = conv("enc1b", [conv("enc1a", [e0], stride=2)])
    e2 = conv("enc2b", [conv("enc2a", [e1], stride=2)])
    d1 = conv("dec1", [e2, e1], upsample=(True, False))
    d0 = conv("dec0", [d1, e0], upsample=(True, False))
    return conv("out", [d0], relu=False)


def noise_level(rays_per_pixel: int) -> float:
    """The constant noise channel: 1 / sqrt(rays per pixel)."""
    return float(rays_per_pixel) ** -0.5


def apply_denoiser(weights, image, warped_prev, blur_map, mix, noise, frame,
                   halo=(0, 0), round_operands=_bf16):
    """The denoised image (rows of ``image`` less the halo) from the traced
    ``image`` (R, W, 4), the warped history (R, W, 4) and the blur map (R,
    W): the analytic temporal pass plus the UNet's residual, blended by
    ``mix``.  ``halo`` (rows above, rows below): the region carries that
    many rows beyond the band on each side; the region starts on a multiple
    of BAND_ALIGN rows of the frame (and ends on one, or at the frame's
    bottom), so the stride-2 grids are the whole frame's."""
    aux = torch.stack([blur_map, torch.full_like(blur_map, float(noise))], dim=-1)
    noisy = image[..., :3]
    prev = warped_prev[..., :3]
    spatial = denoise.spatial_bilateral(noisy)
    if frame <= 0:
        prev = spatial
    analytic = prev + (spatial - prev) * denoise.TEMPORAL_ALPHA
    h, w = noisy.shape[:2]
    ph, pw = (-h) % 4, (-w) % 4
    args = [noisy, prev, aux, analytic]
    if ph or pw:
        args = [F.pad(v.permute(2, 0, 1)[None], (0, pw, 0, ph), mode="reflect")[0]
                .permute(1, 2, 0) for v in args]
    noisy, prev, aux, analytic = args
    x = torch.cat([noisy, prev, analytic, aux], dim=-1).to(BF16)
    pred = analytic + residual(weights, x, round_operands).to(torch.float32)
    top, bottom = halo
    rows = h - top - bottom
    pred = pred[top: top + rows, :w]
    image = image[top: top + rows]
    alpha = torch.ones(image.shape[:2] + (1,), dtype=torch.float32, device=image.device)
    denoised = torch.cat([pred, alpha], dim=-1)
    return denoised + (image - denoised) * (1.0 - mix)
