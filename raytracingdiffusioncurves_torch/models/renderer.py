"""The main path: scene -> traced image -> denoised image -> blur.

Equivalent of the reference render loop (optixHello.cpp:1163-1259):

    optixLaunch (raygen fan per pixel)  ->  trace_image (ops/trace_cuda.py)
    optixDenoiserInvoke (temporal)      ->  models.denoiser.apply_denoiser
                                            or ops.denoise.temporal_denoise
    gaussianBlur (variable sigma)       ->  ops.blur.variable_gaussian_blur

Frame state (previous output + optical flow + frame counter) is threaded
explicitly, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import Camera, RenderConfig
from ..models import denoiser as dn
from ..ops import blur as blur_ops
from ..ops import denoise as denoise_ops
from ..ops import flow as flow_ops
from ..ops import trace_cuda
from ..scene.device import DeviceScene
from ..utils.devices import resolve_device
from ..utils.timing import span


@dataclasses.dataclass(frozen=True)
class FrameState:
    """Temporal state carried between frames (params.h:39-42: prev_image +
    image_flow).  ``frame`` is a host int: it keys the RNG stream and
    decides "no history yet" without asking the card.

    ``zero_flow`` is a tensor known on the host to hold all zeros
    (init_frame_state and every denoised frame set it, together with
    ``flow``); the flow is known to be zero exactly while ``flow`` is that
    very tensor, so replacing ``flow`` (``dataclasses.replace(state,
    flow=add_zoom_flow(state.flow, ...))``) needs no second field kept in
    step.  Never write into a flow tensor in place."""

    prev_image: torch.Tensor  # (H, W, 4) previous output
    flow: torch.Tensor  # (H, W, 2) pixel displacement to the previous frame
    frame: int
    zero_flow: torch.Tensor | None = None

    @property
    def flow_is_zero(self) -> bool:
        return self.flow is self.zero_flow


def init_frame_state(width: int, height: int, device=None) -> FrameState:
    dev = resolve_device(device)
    flow = torch.zeros((height, width, 2), dtype=torch.float32, device=dev)
    return FrameState(
        prev_image=torch.zeros((height, width, 4), dtype=torch.float32, device=dev),
        flow=flow,
        frame=0,
        zero_flow=flow,
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
    tables of this camera (trace_cuda.build_cand_tables: slot-mode lists,
    capped distance-ordered lists with chunk lists, or chunk lists alone, by
    the scene's size); None builds them in-frame for scenes that use any.
    ``gather_len``: seg_max_count's value (None for all but slot-mode
    lists)."""
    h, w = scene.height, scene.width
    with span("trace", frame=frame):
        if cand_tables is None:
            with span("trace.tables", frame=frame):
                cand_tables = trace_cuda.build_cand_tables(scene, camera, config)
        with span("trace.launch", frame=frame):
            csum, wsum, bsum = trace_cuda.trace_sums_flat(
                scene, camera, config, frame, 0, h * w, cand_tables, gather_len
            )
        with span("trace.normalize", frame=frame):
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


def _whole_frame(tensors, halo, align=1):
    """The tail's ``exchange`` on one device: the whole frame has no rows
    beyond its edges, so every tensor is its own region."""
    del halo, align
    return tensors, 0, 0


def _warp_whole(state: FrameState) -> torch.Tensor:
    """The tail's ``warp`` on one device: the history warped by the flow."""
    return flow_ops.warp_separable(state.prev_image, state.flow)


def _postprocess(
    image,
    blur_map,
    state: FrameState,
    config: RenderConfig,
    scene: DeviceScene,
    denoiser: torch.nn.Module | None,
    exchange=_whole_frame,
    warp=_warp_whole,
):
    """Denoise + blur tail shared by render_frame and the progressive path.
    Returns (display image, next prev_image).  The blur always runs: for an
    all-zero blur map it returns the image exactly, so skipping it (one host
    sync per frame) would change no value.

    The hooks let a row band of a frame run the same tail
    (parallel/sharded.py): ``exchange(tensors, halo, align=1)`` returns
    (regions, rows above, rows below), each tensor with at least ``halo``
    rows of the frame on each side (fewer only where the frame's top or
    bottom comes first), the region starting and ending on a multiple of
    ``align`` rows of the frame or at its edge; ``warp(state)`` returns the
    band's rows of the warped history.  Each stage then computes the band's
    rows alone, bitwise those of the whole frame."""
    with span("post", frame=state.frame):
        if config.use_denoiser:
            warped = state.prev_image
            if not state.flow_is_zero:
                with span("post.warp", frame=state.frame):
                    warped = warp(state)
            if denoiser is not None:
                if not isinstance(denoiser, torch.nn.Module):
                    raise TypeError(
                        "denoiser: pass the module, net_for_params(load_params(path)), "
                        "not the checkpoint tree"
                    )
                # Learned denoiser (models/denoiser.py) with the reference's
                # temporal input layout: current frame + flow-warped previous
                # output (optixHello.cpp:1115-1127).
                (image, warped, blur_in), top, bottom = exchange(
                    [image, warped, blur_map], dn.band_halo(denoiser), dn.BAND_ALIGN)
                image = dn.apply_denoiser(
                    denoiser, image, warped, blur_in,
                    mix=config.corrected_image_mix,
                    noise=dn.noise_level(config.rays_per_pixel),
                    frame=state.frame, halo=(top, bottom),
                )
            else:
                (image,), top, bottom = exchange([image], denoise_ops.BILATERAL_RADIUS)
                image = denoise_ops.temporal_blend(
                    image, warped, state.frame, config.corrected_image_mix, halo=(top, bottom))
        next_prev = image
        if config.use_blur:
            radius = config.max_blur_radius
            if radius is None:
                radius = blur_ops.blur_radius(scene.max_blur)
            if radius > 0:
                (image, blur_in), top, bottom = exchange([image, blur_map], radius)
                with span("post.blur", frame=state.frame):
                    image = blur_ops.variable_gaussian_blur(image, blur_in, radius,
                                                            halo=(top, bottom))
        return image, next_prev


def _next_state(state: FrameState, next_prev, config: RenderConfig) -> FrameState:
    """Flow is zeroed after each DENOISE, exactly like the reference
    (optixHello.cpp:1234); with the denoiser off it passes through
    untouched.  The zeros are one tensor reused from frame to frame."""
    flow, zero = state.flow, state.zero_flow
    if config.use_denoiser:
        if zero is None:
            zero = torch.zeros_like(state.flow)
        flow = zero
    return FrameState(prev_image=next_prev, flow=flow, frame=state.frame + 1, zero_flow=zero)


def render_frame(
    scene: DeviceScene,
    camera: Camera,
    state: FrameState,
    config: RenderConfig,
    denoiser: torch.nn.Module | None = None,
    cand_tables=None,
    gather_len: int | None = None,
) -> tuple[torch.Tensor, FrameState]:
    """One full frame: trace -> temporal denoise -> variable blur.

    Returns (image (H, W, 4), next FrameState).  Mirrors the per-frame hot
    path optixHello.cpp:1163-1259 including the order of operations: the
    denoiser runs on the raw traced image and its output feeds both the
    display path and prev_image; the blur runs after (:1186-1240); the flow
    is zeroed after each denoise (:1234).  ``denoiser``: the module that
    holds a checkpoint's weights on the scene's device, built once by the
    caller (``net_for_params(load_params(path))``), selects the learned
    denoiser; None the analytic temporal pass.  ``cand_tables``/``gather_len``: hoisted
    acceleration tables of this camera (trace_cuda.build_cand_tables and
    seg_max_count, for scenes of any density); None builds them in-frame."""
    with span("frame", frame=state.frame):
        image, blur_map = trace_image(
            scene, camera, config, state.frame, cand_tables, gather_len
        )
        image, next_prev = _postprocess(
            image, blur_map, state, config, scene, denoiser
        )
        return image, _next_state(state, next_prev, config)


@dataclasses.dataclass(frozen=True)
class ProgressiveState:
    """Monte-Carlo accumulator for progressive refinement: raw trace sums
    (pre-normalization, the same quantities __raygen__rg accumulates over its
    in-pixel fan, DeviceCode.cu:153-160) summed across *frames*.  While the
    camera rests each extra frame adds rays_per_pixel fresh stratified rays
    to every pixel, so displayed quality converges at interactive rates; any
    camera motion resets the sums."""

    color_sum: torch.Tensor  # (H, W, 3)
    weight_sum: torch.Tensor  # (H, W)
    blur_sum: torch.Tensor  # (H, W)
    passes: int  # frames accumulated so far


def init_progressive_state(width: int, height: int, device=None) -> ProgressiveState:
    dev = resolve_device(device)
    return ProgressiveState(
        color_sum=torch.zeros((height, width, 3), dtype=torch.float32, device=dev),
        weight_sum=torch.zeros((height, width), dtype=torch.float32, device=dev),
        blur_sum=torch.zeros((height, width), dtype=torch.float32, device=dev),
        passes=0,
    )


def _accumulate(sums, prog: ProgressiveState, reset: bool) -> ProgressiveState:
    """This pass's raw sums added to the accumulator, or alone on ``reset``."""
    csum, wsum, bsum = sums
    if reset:
        return ProgressiveState(csum, wsum, bsum, 1)
    return ProgressiveState(csum + prog.color_sum, wsum + prog.weight_sum,
                            bsum + prog.blur_sum, prog.passes + 1)


def render_frame_progressive(
    scene: DeviceScene,
    camera: Camera,
    state: FrameState,
    prog: ProgressiveState,
    config: RenderConfig,
    reset: bool,
    denoiser: torch.nn.Module | None = None,
    cand_tables=None,
    gather_len: int | None = None,
) -> tuple[torch.Tensor, FrameState, ProgressiveState]:
    """One progressive pass: trace config.rays_per_pixel fresh rays per pixel
    (the RNG folds the frame counter in, ops/rng.py, so each pass draws a new
    stratified jitter within the same 2*pi/N sectors), accumulate the raw
    sums, and display the normalized accumulated estimate through the usual
    denoise + blur tail.

    ``reset`` (a host bool: the camera moved) drops the history, so the
    displayed image is exactly this frame's rays.  Requires config.use_aa —
    without jitter every pass repeats the same rays.  Returns (image, next
    FrameState, next ProgressiveState)."""
    h, w = scene.height, scene.width
    f = state.frame
    with span("frame", frame=f):
        with span("trace", frame=f):
            if cand_tables is None:
                with span("trace.tables", frame=f):
                    cand_tables = trace_cuda.build_cand_tables(scene, camera, config)
            with span("trace.launch", frame=f):
                csum, wsum, bsum = trace_cuda.trace_sums_flat(
                    scene, camera, config, f, 0, h * w, cand_tables, gather_len
                )
            with span("trace.normalize", frame=f):
                next_prog = _accumulate(
                    (csum.reshape(h, w, 3), wsum.reshape(h, w), bsum.reshape(h, w)), prog,
                    reset)
                image, blur_map = normalize_sums(
                    next_prog.color_sum, next_prog.weight_sum, next_prog.blur_sum, config)
        image, next_prev = _postprocess(
            image, blur_map, state, config, scene, denoiser
        )
        return image, _next_state(state, next_prev, config), next_prog
