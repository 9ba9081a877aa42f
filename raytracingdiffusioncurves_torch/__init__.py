"""raytracingdiffusioncurves_torch — the PyTorch / CUDA port of the
diffusion-curve renderer, for NVIDIA Hopper (H100).

The same renderer as the JAX package ``raytracingdiffusioncurves_tpu``
(which stays the reference the port is held against): Orzan-XML scene
loading, per-pixel stratified ray fans against cubic Bezier diffusion
curves, endcaps, portal curves, per-curve weight/weight-degree and
per-pixel variable Gaussian blur, the temporal denoiser (analytic, or the
shipped learned networks) and progressive refinement, on scenes from a few
sub-segments to tens of thousands (per-cell candidate lists, capped and
distance-ordered for dense scenes, with chunk lists behind them; a
world grid of them serves a moving camera).  The trace and the
denoiser networks' 3x3 convolutions run in hand-written CUDA kernels
(``csrc/trace.cu``, ``csrc/conv3x3.cu``, built with nvcc at first use);
every entry point runs on the card unless the caller passes
``device="cpu"``, which selects the plain PyTorch version of each kernel.

Quick start::

    import raytracingdiffusioncurves_torch as rtdc
    scene = rtdc.load_scene("arch.xml")
    dev = rtdc.build_device_scene(scene)            # on the card
    cfg = rtdc.RenderConfig(rays_per_pixel=8)       # denoiser on by default
    net = rtdc.net_for_params(rtdc.load_params("weights/denoiser_r3d.msgpack"))
    state = rtdc.init_frame_state(dev.width, dev.height)
    image, state = rtdc.render_frame(dev, rtdc.Camera(), state, cfg,
                                     denoiser=net)
    rtdc.save_image(image, "out.png")

Interactive use: ``InteractiveSession`` (zoom, pan, screenshot; moving
frames take their tables from a world grid), ``viewer_http.HttpViewer``
(an MJPEG page), and the CLI ``python -m raytracingdiffusioncurves_torch
scene.xml 128`` (``--devices N``: row bands on N devices,
``parallel/sharded.py`` over ``torch.distributed``).  The denoiser trains
on the renderer's own output: ``python -m
raytracingdiffusioncurves_torch.models.train_denoiser gen|train``.
"""

from .config import Camera, RenderConfig
from .models.denoiser import (
    DenoiserNet,
    UNetDenoiser,
    apply_denoiser,
    net_for_params,
    params_from_jax,
    params_to_jax,
)
from .models.renderer import (
    FrameState,
    ProgressiveState,
    init_frame_state,
    init_progressive_state,
    render_frame,
    render_frame_progressive,
    trace_image,
)
from .ops.denoise import spatial_bilateral, temporal_denoise
from .ops.flow import add_translation_flow, add_zoom_flow, warp_by_flow, warp_separable, zero_flow
from .ops.trace_cuda import (
    WorldGrid,
    build_cand_grid,
    build_cand_tables,
    grid_covers,
    grid_tables,
    narrow_cand_tables,
    seg_max_count,
)
from .scene.device import DeviceScene, build_device_scene, from_jax_arrays
from .scene.xml_loader import SceneTables, load_scene, load_scene_from_string
from .utils.checkpoint import load_params, load_session, save_params, save_session
from .utils.image import psnr, save_image, to_uint8, to_uint8_device
from .viewer import InteractiveSession, run_viewer

__all__ = [
    "Camera",
    "RenderConfig",
    "SceneTables",
    "DeviceScene",
    "FrameState",
    "ProgressiveState",
    "DenoiserNet",
    "UNetDenoiser",
    "load_scene",
    "load_scene_from_string",
    "build_device_scene",
    "from_jax_arrays",
    "build_cand_tables",
    "seg_max_count",
    "narrow_cand_tables",
    "WorldGrid",
    "build_cand_grid",
    "grid_tables",
    "grid_covers",
    "InteractiveSession",
    "run_viewer",
    "load_session",
    "save_session",
    "to_uint8_device",
    "trace_image",
    "render_frame",
    "render_frame_progressive",
    "init_frame_state",
    "init_progressive_state",
    "load_params",
    "net_for_params",
    "params_from_jax",
    "params_to_jax",
    "save_params",
    "apply_denoiser",
    "spatial_bilateral",
    "temporal_denoise",
    "zero_flow",
    "add_zoom_flow",
    "add_translation_flow",
    "warp_separable",
    "warp_by_flow",
    "save_image",
    "to_uint8",
    "psnr",
]

__version__ = "0.4.0"
