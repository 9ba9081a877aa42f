"""raytracingdiffusioncurves_torch — the PyTorch / CUDA port of the
diffusion-curve renderer, for NVIDIA Hopper (H100).

The same renderer as the JAX package ``raytracingdiffusioncurves_tpu``
(which stays the reference the port is held against): Orzan-XML scene
loading, per-pixel stratified ray fans against cubic Bezier diffusion
curves, endcaps, portal curves, per-curve weight/weight-degree and
per-pixel variable Gaussian blur.  The trace runs in a hand-written CUDA
kernel (``csrc/trace.cu``, built with nvcc at first use); every entry point
runs on the card unless the caller passes ``device="cpu"``, which selects
the plain PyTorch version of each kernel.  The denoiser is not ported yet.

Quick start::

    import raytracingdiffusioncurves_torch as rtdc
    scene = rtdc.load_scene("arch.xml")
    dev = rtdc.build_device_scene(scene)            # on the card
    cfg = rtdc.RenderConfig(rays_per_pixel=128, use_denoiser=False)
    image, blur_map = rtdc.trace_image(dev, rtdc.Camera(), cfg)
    rtdc.save_image(image, "out.png")
"""

from .config import Camera, RenderConfig
from .models.renderer import FrameState, init_frame_state, render_frame, trace_image
from .ops.trace_cuda import build_cand_tables, seg_max_count
from .scene.device import DeviceScene, build_device_scene, from_jax_arrays
from .scene.xml_loader import SceneTables, load_scene, load_scene_from_string
from .utils.image import psnr, save_image, to_uint8

__all__ = [
    "Camera",
    "RenderConfig",
    "SceneTables",
    "DeviceScene",
    "FrameState",
    "load_scene",
    "load_scene_from_string",
    "build_device_scene",
    "from_jax_arrays",
    "build_cand_tables",
    "seg_max_count",
    "trace_image",
    "render_frame",
    "init_frame_state",
    "save_image",
    "to_uint8",
    "psnr",
]

__version__ = "0.1.0"
