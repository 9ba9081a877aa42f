"""Temporal denoiser: flow-directed reprojection + edge-preserving spatial pass.

Replaces the OptiX temporal AI denoiser (optixHello.cpp:1033-1134,1186-1235),
which runs with no albedo/normal inputs, an optical-flow input, and
``blendFactor = 1 - corrected_image_mix`` (:1131; blendFactor 0 = fully
denoised output, 1 = passthrough).  Two components, as in the JAX package:

* **temporal**: the previous denoised frame, warped by the flow field, is
  blended with the current frame (new = lerp(history, current, alpha));
* **spatial**: a 5x5 joint-bilateral filter on the current frame, weighted by its own colours.

The output feeds both the displayed image and the next frame's prev_image
(:1216-1231).  Plain PyTorch, but for the spatial pass on the card: one
launch of the hand-written kernel ``csrc/bilateral.cu``
(``ops/bilateral_cuda.py``), bitwise equal to the plain version kept here.
The JAX package runs this stage outside Pallas.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..utils.timing import span
from . import bilateral_cuda
from . import flow as flow_ops

# Temporal accumulation factor: new = lerp(history, current, TEMPORAL_ALPHA)
TEMPORAL_ALPHA = 0.2
BILATERAL_RADIUS = 2
_BILATERAL_SIGMA_SPACE = 1.5
_BILATERAL_SIGMA_COLOR = 0.1


@functools.lru_cache(maxsize=None)
def _bf16_scalar(v: float) -> float:
    """``v`` rounded to bf16, as a Python float (made on the host: a Python
    scalar enters a kernel as an argument, with no copy to the card)."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


@functools.lru_cache(maxsize=None)
def _weight_constants(bf16_weights: bool) -> tuple[tuple[float, ...], float]:
    """Each tap's spatial term, dy-major, and the colour scale, as the weight
    chain uses them: bf16 values (as Python floats) in the bf16 branch."""
    r = BILATERAL_RADIUS
    inv_ss = 1.0 / (2.0 * _BILATERAL_SIGMA_SPACE**2)
    inv_sc = 1.0 / (2.0 * _BILATERAL_SIGMA_COLOR**2)
    spatial = tuple(-(dx * dx + dy * dy) * inv_ss
                    for dy in range(-r, r + 1) for dx in range(-r, r + 1))
    if bf16_weights:
        return tuple(_bf16_scalar(v) for v in spatial), _bf16_scalar(inv_sc)
    return spatial, inv_sc


def spatial_bilateral(image: torch.Tensor, bf16_weights: bool = True) -> torch.Tensor:
    """5x5 joint bilateral filter weighted by the image's own colours, all
    channels, of an (..., H, W, C) image: leading axes are a batch (the JAX
    package maps the single-image filter over them with ``jax.vmap``).  A
    CUDA tensor takes one launch of the kernel (``bilateral_cuda``), bitwise
    equal to ``spatial_bilateral_plain``; a CPU tensor takes the plain
    version."""
    device = image.device
    if device.type == "cuda":
        spatial, inv_sc = _weight_constants(bf16_weights)
        return bilateral_cuda.bilateral5x5(image, spatial, inv_sc, bf16_weights)
    if device.type != "cpu":
        raise RuntimeError(f"no bilateral path for device {device}")
    return spatial_bilateral_plain(image, bf16_weights)


def spatial_bilateral_plain(image: torch.Tensor, bf16_weights: bool = True) -> torch.Tensor:
    """The plain PyTorch version of ``spatial_bilateral``, on any device.

    ``bf16_weights`` (the JAX package's default, ``BILATERAL_BF16``): only
    the WEIGHT chain (colour differences, squared distance, exp) runs in
    bf16, each step rounded to bf16; the accumulated values and both
    accumulators stay float32, so on flat regions every tap carries the
    identical (quantized) weight and accum / wsum is exact.  False runs the
    whole filter in float32."""
    r = BILATERAL_RADIUS
    spatial, inv_sc = _weight_constants(bf16_weights)
    h, w, c = image.shape[-3:]
    # edge padding of the two image axes, over the batch as one (N, C, H, W)
    flat = image.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    padded = F.pad(flat, (r, r, r, r), mode="replicate").permute(0, 2, 3, 1)
    padded = padded.reshape(image.shape[:-3] + padded.shape[1:])
    accum = torch.zeros_like(image)
    wsum = torch.zeros(image.shape[:-1], dtype=image.dtype, device=image.device)
    if bf16_weights:
        centre = image[..., :3].to(torch.bfloat16)
        padded_g = padded[..., :3].to(torch.bfloat16)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            s = spatial[(dy + r) * (2 * r + 1) + dx + r]
            nb = padded[..., dy + r : dy + r + h, dx + r : dx + r + w, :]
            if bf16_weights:
                nbg = padded_g[..., dy + r : dy + r + h, dx + r : dx + r + w, :]
                diff = nbg - centre
                dist2 = torch.sum(diff * diff, dim=-1)
                wgt = torch.exp(s - dist2 * inv_sc).to(image.dtype)
            else:
                diff = nb[..., :3] - image[..., :3]
                dist2 = torch.sum(diff * diff, dim=-1)
                wgt = torch.exp(s - dist2 * inv_sc)
            accum = accum + nb * wgt[..., None]
            wsum = wsum + wgt
    return accum / wsum[..., None]


def temporal_denoise(
    image: torch.Tensor,
    prev_image: torch.Tensor,
    flow: torch.Tensor,
    frame: int,
    mix: float = 1.0,
    flow_is_zero: bool = False,
) -> torch.Tensor:
    """Denoise ``image`` using the previous output and its flow field.

    ``mix`` is corrected_image_mix: the blend between the denoised result
    (mix = 1) and the raw input (mix = 0), inverted exactly like the
    reference's blendFactor (optixHello.cpp:98,1131).  ``frame`` is a host
    int: on frame 0 there is no history and the spatial result stands alone.
    ``flow_is_zero``: the caller knows the flow is all zero, so the warp (an
    exact identity then) is skipped."""
    warped = prev_image if flow_is_zero else flow_ops.warp_separable(prev_image, flow)
    return temporal_blend(image, warped, frame, mix)


def temporal_blend(image: torch.Tensor, warped: torch.Tensor, frame: int, mix: float = 1.0,
                   halo: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """``temporal_denoise`` on already-warped history ``warped``.

    ``halo`` (rows above, rows below): ``image`` is a row band of a frame
    with that many of the frame's rows on each side (``BILATERAL_RADIUS``
    rows, or up to the frame's edge), ``warped`` the band alone; the result
    is the band's rows, bitwise those of the whole frame's pass."""
    top, bottom = halo
    rows = image.shape[0] - top - bottom
    with span("post.bilateral", frame=frame):
        spatial = spatial_bilateral(image)[top : top + rows]
    with span("post.blend", frame=frame):
        image = image[top : top + rows]
        alpha = TEMPORAL_ALPHA if frame > 0 else 1.0
        denoised = warped + (spatial - warped) * alpha
        blend_factor = 1.0 - mix  # 0 => fully denoised (reference default)
        return denoised + (image - denoised) * blend_factor
