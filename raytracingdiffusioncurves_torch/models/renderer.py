"""The main path: scene -> traced image -> blur.

Equivalent of the reference render loop (optixHello.cpp:1163-1259) with the
denoiser off:

    optixLaunch (raygen fan per pixel)  ->  trace_image (ops/trace_cuda.py)
    gaussianBlur (variable sigma)       ->  ops.blur.variable_gaussian_blur

Frame state (previous output + optical flow + frame counter) is threaded
explicitly, as in the JAX package.  The denoiser (``use_denoiser=True``)
is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import Camera, RenderConfig
from ..ops import blur as blur_ops
from ..ops import trace_cuda
from ..scene.device import DeviceScene
from ..utils.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class FrameState:
    """Temporal state carried between frames (params.h:39-42: prev_image +
    image_flow).  ``frame`` is a host int: it keys the RNG stream."""

    prev_image: torch.Tensor  # (H, W, 4) previous output
    flow: torch.Tensor  # (H, W, 2) pixel displacement to the previous frame
    frame: int


def init_frame_state(width: int, height: int, device=None) -> FrameState:
    dev = resolve_device(device)
    return FrameState(
        prev_image=torch.zeros((height, width, 4), dtype=torch.float32, device=dev),
        flow=torch.zeros((height, width, 2), dtype=torch.float32, device=dev),
        frame=0,
    )


def trace_image(
    scene: DeviceScene,
    camera: Camera,
    config: RenderConfig,
    frame: int = 0,
    cand_tables=None,
    gather_len: int | None = None,
):
    """Render the raw (pre-postprocessing) image and blur map on the
    scene's device.  Returns (image (H, W, 4) float32, blur_map (H, W)).

    The per-pixel result is the weight-normalized average over the ray fan
    (DeviceCode.cu:153-181).  Pixels whose rays all return zero weight are
    NaN in the reference (0/0); here they get config.background (alpha is
    always 1 — the reference never writes it).  ``cand_tables``: hoisted
    tables of this camera (trace_cuda.build_cand_tables); None builds them
    in-frame for scenes that use lists."""
    h, w = scene.height, scene.width
    if cand_tables is None:
        cand_tables = trace_cuda.build_cand_tables(scene, camera, config)
    csum, wsum, bsum = trace_cuda.trace_sums_flat(
        scene, camera, config, frame, 0, h * w, cand_tables, gather_len
    )
    return normalize_sums(
        csum.reshape(h, w, 3), wsum.reshape(h, w), bsum.reshape(h, w), config
    )


def normalize_sums(color_sum, weight_sum, blur_sum, config: RenderConfig):
    """Weighted-mean normalization (DeviceCode.cu:176-181), with the
    background-instead-of-NaN rule for all-miss pixels.  The background
    enters as Python scalars, one channel at a time: a background tensor
    would be a host-to-device copy, which waits for the card every frame."""
    has_w = weight_sum > 0.0
    safe_w = torch.where(has_w, weight_sum, 1.0)
    channels = [
        torch.where(has_w, color_sum[..., k] / safe_w, float(v))
        for k, v in enumerate(config.background)
    ]
    image = torch.stack(channels + [torch.ones_like(weight_sum)], dim=-1)
    blur_map = torch.where(has_w, blur_sum / safe_w, 0.0)
    return image, blur_map


def _postprocess(
    image,
    blur_map,
    config: RenderConfig,
    scene: DeviceScene,
    max_blur_radius: int | None,
):
    """Blur tail of a frame (the denoiser is not ported).  Returns (display
    image, next prev_image).  The blur always runs: for an all-zero blur
    map it returns the image exactly, so skipping it (one host sync per
    frame) would change no value."""
    next_prev = image
    if config.use_blur:
        radius = max_blur_radius
        if radius is None:
            radius = config.max_blur_radius
        if radius is None:
            radius = blur_ops.blur_radius(scene.max_blur)
        if radius > 0:
            image = blur_ops.variable_gaussian_blur(image, blur_map, radius)
    return image, next_prev


def render_frame(
    scene: DeviceScene,
    camera: Camera,
    state: FrameState,
    config: RenderConfig,
    max_blur_radius: int | None = None,
    cand_tables=None,
    gather_len: int | None = None,
) -> tuple[torch.Tensor, FrameState]:
    """One full frame: trace -> variable blur.

    Returns (image (H, W, 4), next FrameState).  With the denoiser off the
    flow passes through untouched and prev_image is the un-blurred frame,
    as in the JAX package.  ``cand_tables``/``gather_len``: hoisted
    acceleration tables of this camera (trace_cuda.build_cand_tables and
    seg_max_count); None builds them in-frame."""
    if config.use_denoiser:
        raise NotImplementedError(
            "use_denoiser=True: the denoiser is not ported yet (ROADMAP A7); "
            "pass RenderConfig(use_denoiser=False)"
        )
    image, blur_map = trace_image(
        scene, camera, config, state.frame, cand_tables, gather_len
    )
    image, next_prev = _postprocess(image, blur_map, config, scene, max_blur_radius)
    next_state = FrameState(prev_image=next_prev, flow=state.flow, frame=state.frame + 1)
    return image, next_state
