"""Learned denoiser: the residual CNN and the UNet of the JAX package as
``nn.Module``s, their inference on the hand-written 3x3 convolution kernel,
and their training.

The reference leans on OptiX's *trained* temporal denoiser model
(OPTIX_DENOISER_MODEL_KIND_TEMPORAL, optixHello.cpp:1057).  The analytic
temporal/bilateral pass (ops/denoise.py) covers the blend semantics; the
networks here predict a residual correction on top of it.  Weights come from
the shipped checkpoints (``utils/checkpoint.load_params`` +
``net_for_params``) or from ``models/train_denoiser.py``.

The modules compute the networks as the JAX package's flax modules define
them (``UNetDenoiser.__call__``), on NHWC bf16 tensors with float32
parameters cast to bf16 per call.  The JAX package's inference route
(``apply_unet_flat``: space-to-depth packing, a ring-padded flat layout,
pre-summed phase kernels) is a TPU layout of the same network and is not
carried over.  Every inference convolution goes through
``ops/conv_cuda.conv3x3``: the CUDA kernel on the card, its plain version on
the CPU.  The decoder's channel concats are input groups of that kernel, and
its nearest 2x upsamples are read inside the kernel: neither is ever written
to memory.

Training (the JAX package's ``create_train_state`` / ``loss_fn`` /
``train_step``) runs the batch whole through ``conv3x3_train``: the same
function on (N, H, W, C) tensors through ``F.conv2d``, with autograd.  The
JAX train step uses no Pallas kernel either (flax ``nn.Conv`` lowers to
``lax.conv_general_dilated``).  Adam and the cosine schedule follow optax's
defaults; with a process group the gradients are averaged over it before the
update (the data-parallel step).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops import conv_cuda
from ..ops import denoise as denoise_ops
from ..utils.devices import resolve_device
from ..utils.timing import span

BF16 = torch.bfloat16


def analytic_baseline(noisy: torch.Tensor, warped_prev: torch.Tensor) -> torch.Tensor:
    """The analytic temporal pass on already-warped history
    (ops/denoise.py temporal_denoise with the warp factored out): bilateral +
    temporal blend, for (..., H, W, 3) images (leading axes are a batch)."""
    spatial = denoise_ops.spatial_bilateral(noisy)
    return warped_prev + (spatial - warped_prev) * denoise_ops.TEMPORAL_ALPHA


class Conv3x3(nn.Module):
    """One SAME 3x3 convolution layer: float32 ``kernel`` (3, 3, Cin, Cout)
    in the JAX package's HWIO layout and ``bias`` (Cout,), applied in bf16.
    ``groups``: channel counts of the input groups the kernel is split into
    along Cin (a concat [a, b] is the groups (Ca, Cb))."""

    def __init__(self, cin: int, cout: int, stride: int = 1, relu: bool = True,
                 groups: tuple[int, ...] | None = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.relu = stride, relu
        self.groups = tuple(groups) if groups is not None else (cin,)
        if sum(self.groups) != cin:
            raise ValueError(f"groups {self.groups} do not add up to {cin} input channels")

    def forward(self, xs, conv: Callable = conv_cuda.conv3x3, upsample=None):
        k = self.kernel.to(BF16)
        ks = [part.contiguous() for part in torch.split(k, self.groups, dim=2)]
        return conv(xs, ks, self.bias.to(BF16), self.stride, self.relu, upsample)


def conv3x3_train(xs, ks, b, stride: int = 1, relu: bool = True, upsample=None) -> torch.Tensor:
    """The training convolution: ``conv3x3``'s function on a batch, (N, H,
    W, C_i) bf16 groups, through ``F.conv2d`` (differentiable).  The groups
    are concatenated along channels (after a nearest 2x upsample where
    flagged), padded as JAX's SAME (stride 2 pads (0, 1)), convolved on the
    bf16 operands with no bias, the result rounded to bf16 and only then the
    bf16 bias added, as flax's ``nn.Conv`` computes it (``F.conv2d(bias=)``
    would add the bias before rounding).  Returns (N, H_out, W_out, Cout)
    bf16."""
    upsample = tuple(upsample) if upsample is not None else (False,) * len(xs)
    parts = [x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) if up else x
             for x, up in zip(xs, upsample)]
    x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    _, top, bottom = conv_cuda.same_padding(x.shape[1], stride)
    _, left, right = conv_cuda.same_padding(x.shape[2], stride)
    x = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    k = torch.cat(list(ks), dim=2).permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(x, k, stride=stride).permute(0, 2, 3, 1) + b
    return torch.relu(y) if relu else y


class _ResidualDenoiser(nn.Module):
    """Shared batch handling: ``forward(noisy, warped_prev, aux, analytic)``
    on (N, H, W, C) float32 tensors, as the flax modules' ``__call__``;
    returns ``analytic + residual`` (N, H, W, 3) float32.  ``conv`` is the
    convolution function (default: the dispatching ``conv3x3``, one image at
    a time); ``forward_batch`` is the training forward."""

    def forward(self, noisy, warped_prev, aux, analytic=None,
                conv: Callable = conv_cuda.conv3x3):
        outs = []
        for i in range(noisy.shape[0]):
            base = analytic[i] if analytic is not None else analytic_baseline(
                noisy[i], warped_prev[i])
            x = torch.cat([noisy[i], warped_prev[i], base, aux[i]], dim=-1).to(BF16)
            outs.append(base + self.residual(x, conv).to(torch.float32))
        return torch.stack(outs)

    def forward_batch(self, noisy, warped_prev, aux, analytic=None):
        """The training forward: the batch whole, the analytic baseline
        batched, every layer one ``conv3x3_train`` call."""
        if analytic is None:
            with torch.no_grad():
                analytic = analytic_baseline(noisy, warped_prev)
        x = torch.cat([noisy, warped_prev, analytic, aux], dim=-1).to(BF16)
        return analytic + self.residual(x, conv3x3_train).to(torch.float32)


class DenoiserNet(_ResidualDenoiser):
    """Residual CNN on top of the analytic temporal pass: ``depth`` hidden
    3x3 layers of ``features`` channels with ReLU, then a 3-channel layer.
    ``aux`` carries the blur map plus a constant noise-level channel
    (1/sqrt(rpp)), so one set of weights serves every rays-per-pixel
    setting.  Layer names follow the flax module's (``Conv_0`` ...)."""

    def __init__(self, features: int = 32, depth: int = 5, in_channels: int = 11):
        super().__init__()
        self.features, self.depth = features, depth
        cin = in_channels
        for i in range(depth):
            setattr(self, f"Conv_{i}", Conv3x3(cin, features))
            cin = features
        setattr(self, f"Conv_{depth}", Conv3x3(cin, 3, relu=False))

    def residual(self, x, conv):
        for i in range(self.depth + 1):
            x = getattr(self, f"Conv_{i}")([x], conv)
        return x


class UNetDenoiser(_ResidualDenoiser):
    """Multi-scale residual denoiser: an encoder/decoder with skips, two
    stride-2 downsamples (receptive field ~40 px), nearest 2x upsamples.
    Same interface and residual-on-analytic design as DenoiserNet.  Input H
    and W must be multiples of 4 (apply_denoiser pads and crops)."""

    def __init__(self, base: int = 24, in_channels: int = 11):
        super().__init__()
        c = self.base = base
        self.enc0a = Conv3x3(in_channels, c)
        self.enc0b = Conv3x3(c, c)
        self.enc1a = Conv3x3(c, 2 * c, stride=2)
        self.enc1b = Conv3x3(2 * c, 2 * c)
        self.enc2a = Conv3x3(2 * c, 4 * c, stride=2)
        self.enc2b = Conv3x3(4 * c, 4 * c)
        # concat order of the flax module: [up(x), skip]
        self.dec1 = Conv3x3(6 * c, 2 * c, groups=(4 * c, 2 * c))
        self.dec0 = Conv3x3(3 * c, c, groups=(2 * c, c))
        self.out = Conv3x3(c, 3, relu=False)

    def residual(self, x, conv):
        if x.shape[-3] % 4 or x.shape[-2] % 4:
            raise ValueError(f"UNet input size {tuple(x.shape[-3:-1])} must be a multiple of 4")
        e0 = self.enc0b([self.enc0a([x], conv)], conv)
        e1 = self.enc1b([self.enc1a([e0], conv)], conv)
        e2 = self.enc2b([self.enc2a([e1], conv)], conv)
        d1 = self.dec1([e2, e1], conv, upsample=(True, False))
        d0 = self.dec0([d1, e0], conv, upsample=(True, False))
        return self.out([d0], conv)


def noise_level(rays_per_pixel) -> float:
    """Monte-Carlo noise scale of a render: ~1/sqrt(rpp)."""
    return float(1.0 / math.sqrt(float(rays_per_pixel)))


def make_batch_from_renders(noisy_img, target_img, prev_img, blur_map, noise=0.0):
    """Assemble one training example from renderer outputs (leading batch dim
    added); ``noise`` is the noisy render's noise_level(rpp)."""
    aux = torch.stack([blur_map, torch.full_like(blur_map, float(noise))], dim=-1)
    return {
        "noisy": noisy_img[None, ..., :3],
        "warped_prev": prev_img[None, ..., :3],
        "aux": aux[None],
        "target": target_img[None, ..., :3],
    }


# flax's default kernel init, lecun_normal: a normal truncated at +-2 sigma,
# its sigma divided by the truncated unit normal's own std so the draws have
# variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax's ``cosine_decay_schedule``: count -> learning rate, from
    ``init_value`` down to ``alpha * init_value`` over ``decay_steps``
    counts, constant after."""
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)
    return schedule


def _conv_layers(model: nn.Module):
    return [(name, m) for name, m in model.named_children() if isinstance(m, Conv3x3)]


def create_train_state(generator: torch.Generator, height: int, width: int, lr=1e-3,
                       aux_channels: int = 2, arch: str = "cnn", base: int | None = None,
                       device=None):
    """A freshly initialised model with its optimizer, as the JAX package's
    ``create_train_state``.  Returns (model, sched, opt):

    * ``model``: the DenoiserNet ("cnn") or UNetDenoiser ("unet"), ``base``
      overriding its width (UNet ``base`` / CNN ``features``), float32
      parameters on ``device`` (None = CUDA).  Kernels are drawn on the CPU
      from ``generator`` layer by layer as flax's ``lecun_normal``, so every
      device gets the same weights: a normal truncated at +-2 sigma, sigma
      = sqrt(1 / (9 Cin)) / 0.8796; biases are zero.
    * ``sched``: the ``LambdaLR`` that holds the step count and the learning
      rate (the JAX TrainState's ``step``); ``lr`` is a float or a schedule
      count -> lr (``cosine_decay_schedule``), the first update taking count 0.
    * ``opt``: Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8): the
      update lr * m_hat / (sqrt(v_hat) + eps).

    ``height``/``width`` are the JAX signature's; no parameter depends on
    them."""
    del height, width
    in_channels = 9 + aux_channels
    if arch == "unet":
        model = UNetDenoiser(in_channels=in_channels, **({"base": base} if base else {}))
    elif arch == "cnn":
        model = DenoiserNet(in_channels=in_channels, **({"features": base} if base else {}))
    else:
        raise ValueError(f"arch must be 'cnn' or 'unet', got {arch!r}")
    with torch.no_grad():
        for _, layer in _conv_layers(model):
            std = math.sqrt(1.0 / (9 * layer.kernel.shape[2])) / _TRUNC_STD
            nn.init.trunc_normal_(layer.kernel, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            layer.bias.zero_()
    model.to(resolve_device(device))
    schedule = lr if callable(lr) else (lambda _count, lr=float(lr): lr)
    opt = torch.optim.Adam(model.parameters(), lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, schedule)
    return model, sched, opt


def loss_fn(model: nn.Module, batch: dict) -> torch.Tensor:
    """L1 + MSE of the training forward against the high-rpp reference
    render: mean |err| + mean err^2."""
    pred = model.forward_batch(batch["noisy"], batch["warped_prev"], batch["aux"])
    err = pred - batch["target"]
    return err.abs().mean() + (err * err).mean()


def train_step(model: nn.Module, opt, sched, batch: dict, group=None) -> torch.Tensor:
    """One training step on ``batch`` (dict of (N, H, W, C) float32 tensors
    on the model's device); returns the loss (a tensor: reading it waits for
    the card).  With a process group ``group`` every rank passes its own
    shard of the batch: the gradients and the loss are averaged over the
    group (one all_reduce) before the update, the data-parallel step (the
    JAX package's gradient mean as a psum)."""
    params = list(model.parameters())
    opt.zero_grad(set_to_none=False)
    loss = loss_fn(model, batch)
    loss.backward()
    loss = loss.detach()
    if group is not None:
        flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.reshape(1)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat /= dist.get_world_size(group)
        offset = 0
        for p in params:
            p.grad.copy_(flat[offset : offset + p.numel()].view_as(p.grad))
            offset += p.numel()
        loss = flat[-1]
    opt.step()
    sched.step()
    return loss


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX package's parameter tree (``{"params": {layer: {"kernel":
    (3, 3, Cin, Cout), "bias": (Cout,)}}}``, numpy float32) as the state
    dict of the matching module: ``<layer>.kernel`` and ``<layer>.bias``,
    HWIO kept."""
    state = {}
    for layer, leaves in params["params"].items():
        for leaf in ("kernel", "bias"):
            state[f"{layer}.{leaf}"] = torch.tensor(np.asarray(leaves[leaf], np.float32))
    return state


def params_to_jax(model: nn.Module) -> dict:
    """The inverse of ``params_from_jax``: the module's parameters as the
    JAX package's tree, ``{"params": {layer: {"kernel": (3, 3, Cin, Cout),
    "bias": (Cout,)}}}`` of float32 numpy arrays, layers in the module's
    order."""
    return {"params": {
        name: {"kernel": layer.kernel.detach().cpu().numpy().copy(),
               "bias": layer.bias.detach().cpu().numpy().copy()}
        for name, layer in _conv_layers(model)
    }}


def net_for_params(params, device=None) -> nn.Module:
    """The module whose architecture matches a loaded checkpoint, with the
    checkpoint's weights, on ``device`` (None = CUDA): UNet checkpoints carry
    explicitly named layers ("enc0a", ...); plain stacks carry auto-numbered
    "Conv_i" (depth = hidden layers, features = their channel count)."""
    layers = params["params"]
    if "enc0a" in layers:
        kernel = layers["enc0a"]["kernel"]
        net = UNetDenoiser(base=int(kernel.shape[-1]), in_channels=int(kernel.shape[2]))
    else:
        kernel = layers["Conv_0"]["kernel"]
        depth = sum(1 for k in layers if k.startswith("Conv_")) - 1
        net = DenoiserNet(features=int(kernel.shape[-1]), depth=depth,
                          in_channels=int(kernel.shape[2]))
    net.load_state_dict(params_from_jax(params))
    return net.to(resolve_device(device)).requires_grad_(False)


def _extent_conv(xs, ks, b, stride=1, relu=True, upsample=None) -> torch.Tensor:
    """``conv3x3``'s wiring on row extents: each input pixel holds (first,
    last) of the input rows its value depends on; each output pixel gets
    the min and max over the taps it reads (SAME padding, stride, nearest 2x
    upsample as the kernel), the padding reading nothing.  Kernels and bias
    are ignored."""
    del ks, b, relu
    upsample = tuple(upsample) if upsample is not None else (False,) * len(xs)
    lo = hi = None
    for x, up in zip(xs, upsample):
        if up:
            x = x.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        h_out, top, bottom = conv_cuda.same_padding(x.shape[0], stride)
        w_out, left, right = conv_cuda.same_padding(x.shape[1], stride)
        pads = (left, right, top, bottom)
        xlo = F.pad(x[..., 0], pads, value=math.inf)
        xhi = F.pad(x[..., 1], pads, value=-math.inf)
        for dy in range(3):
            for dx in range(3):
                win = (slice(dy, dy + (h_out - 1) * stride + 1, stride),
                       slice(dx, dx + (w_out - 1) * stride + 1, stride))
                lo = xlo[win] if lo is None else torch.minimum(lo, xlo[win])
                hi = xhi[win] if hi is None else torch.maximum(hi, xhi[win])
    return torch.stack([lo, hi], dim=-1)


def receptive_field(model: nn.Module) -> tuple[int, int]:
    """(rows above, rows below) of the network's input that one output row
    of ``model.residual`` reads, worked out from its layers: the residual
    runs on row extents through ``_extent_conv`` on a 64 x 4 input, and the
    widest reach over every output row (every phase of the stride-2 grids)
    is taken.  The UNet: (15, 18); the plain CNN of depth d: (d + 1, d + 1)."""
    n = 64
    rows = torch.arange(n, dtype=torch.float32)
    x = torch.stack([rows, rows], dim=-1)[:, None, :].expand(n, 4, 2)
    with torch.no_grad():
        ext = model.residual(x, _extent_conv)[:, 0]
    return int((rows - ext[:, 0]).max()), int((ext[:, 1] - rows).max())


# A row band's region for ``apply_denoiser`` starts and ends on a multiple
# of BAND_ALIGN rows of the frame (or at its top or bottom), so that the
# UNet's two stride-2 levels keep the whole frame's grids.
BAND_ALIGN = 4


def band_halo(model: nn.Module) -> int:
    """Rows of the frame a row band needs on each side for ``apply_denoiser``
    to give its rows bitwise as on the whole frame: the receptive field's
    wider side plus the bilateral's radius (the analytic input is the
    bilateral's output), rounded up to a multiple of BAND_ALIGN.  Cached
    per architecture; 20 for the UNet."""
    depth = getattr(model, "depth", None)
    key = (type(model).__name__, depth)
    if key not in _BAND_HALOS:
        reach = max(receptive_field(model)) + denoise_ops.BILATERAL_RADIUS
        _BAND_HALOS[key] = -(-reach // 4) * 4
    return _BAND_HALOS[key]


_BAND_HALOS: dict[tuple, int] = {}


def _reflect_pad(v: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(H, W, C) reflect-padded by ph rows below and pw columns right."""
    return F.pad(v.permute(2, 0, 1)[None], (0, pw, 0, ph), mode="reflect")[0].permute(1, 2, 0)


def _apply_denoiser(model, image, warped_prev, blur_map, mix, noise, frame, conv,
                    halo=(0, 0)):
    """apply_denoiser with the convolution function named: ``conv3x3`` (the
    dispatch) on every normal call, ``conv3x3_plain`` where a check holds the
    kernel route against the plain one on the same device."""
    noisy = image[..., :3]
    prev = warped_prev[..., :3]
    with span("post.bilateral", frame=frame):
        spatial = denoise_ops.spatial_bilateral(noisy)
    with span("post.unet", frame=frame):
        aux = torch.stack([blur_map, torch.full_like(blur_map, float(noise))], dim=-1)
        if frame is not None and frame <= 0:
            prev = spatial
        analytic = prev + (spatial - prev) * denoise_ops.TEMPORAL_ALPHA
        # UNet strides need H, W divisible by 4: reflect-pad, predict, crop.
        h, w = noisy.shape[:2]
        ph, pw = (-h) % 4, (-w) % 4
        args = [noisy, prev, aux, analytic]
        if (ph or pw) and isinstance(model, UNetDenoiser):
            args = [_reflect_pad(v, ph, pw) for v in args]
        top, bottom = halo
        rows = h - top - bottom
        pred = model(*[v[None] for v in args], conv=conv)[0, top : top + rows, :w]
    with span("post.blend", frame=frame):
        image = image[top : top + rows]
        alpha = torch.ones(image.shape[:2] + (1,), dtype=torch.float32, device=image.device)
        denoised = torch.cat([pred, alpha], dim=-1)
        return denoised + (image - denoised) * (1.0 - mix)


def apply_denoiser(
    model: nn.Module,
    image: torch.Tensor,
    warped_prev: torch.Tensor,
    blur_map: torch.Tensor,
    mix: float = 1.0,
    noise: float = 0.0,
    frame: int | None = None,
    halo: tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """Inference wrapper matching the blendFactor semantics
    (optixHello.cpp:1131): mix=1 -> fully denoised.  ``model`` holds its
    weights (net_for_params).  ``frame`` is a host int: on frame 0 there is
    no history, so the warped-previous input falls back to the bilateral of
    the current frame (the analytic pass does the same, ops/denoise.py).

    ``halo`` (rows above, rows below): the inputs are a row band of a frame
    with that many of the frame's rows on each side, and the result is the
    band's rows alone, bitwise those of the whole frame's call.  A side
    holds at least ``band_halo(model)`` rows or all the rows up to the
    frame's edge, and for the UNet the region starts on a multiple of
    BAND_ALIGN rows of the frame and is a multiple of BAND_ALIGN rows high
    unless it ends at the frame's bottom (where the reflect pad then
    applies, as on the whole frame)."""
    return _apply_denoiser(model, image, warped_prev, blur_map, mix, noise, frame,
                           conv_cuda.conv3x3, halo)
