"""One frame of the renderer on a band of rows, in plain PyTorch: the
comparison's reference.

``reference_band`` works out rows [r0, r1) of a frame's display image and
of its next temporal state from the cell's inputs alone: the scene (parsed
and flattened here from the benchmark's XML), the camera, the render
settings, the frame counter, the flow of the events before the frame, the
checkpoint's weights, and the history (the state the frame starts from).
It traces every ray of the rows it needs against every sub-segment (the
full sweep: no candidate tables, no world grid), then normalizes, warps the
history, runs the bilateral and the UNet, and blurs, each stage over the
band plus the rows its windows reach.

``Precision`` names the arithmetic: ``REFERENCE`` is the configuration's
(float32 throughout, the UNet on bf16 operands with float32 sums);
``CONTROL`` is the step below it (each float32 stage's inputs and outputs
rounded to bf16, the UNet's operands to fp8 e4m3), the control that the
comparison has to fail.

Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np
import torch

from . import blur, device, flow, intersect, unet, xml_loader
from .config import Camera, RenderConfig

BF16 = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str

    @property
    def lower(self) -> bool:
        return self.name == "control"

    def stage(self, x: torch.Tensor) -> torch.Tensor:
        """A float32 stage's value as this precision holds it."""
        return x.to(BF16).to(torch.float32) if self.lower else x

    def operands(self, x: torch.Tensor) -> torch.Tensor:
        """A UNet operand as this precision holds it (bf16, or fp8 e4m3)."""
        if self.lower:
            return x.to(torch.float32).to(torch.float8_e4m3fn).to(BF16)
        return x.to(BF16)


REFERENCE = Precision("reference")
CONTROL = Precision("control")


def load_scene(xml_text: str, cfg: RenderConfig, dev) -> device.DeviceScene:
    """Parse and flatten the scene as the renderer's defaults do."""
    tables = xml_loader.build_scene(
        ET.fromstring(xml_text), diffusion_curve_save=cfg.diffusion_curve_save,
        endcap_size=cfg.endcap_size, default_weight_degree=cfg.default_weight_degree)
    return device.build_device_scene(tables, flatten_subdivisions=cfg.flatten_subdivisions,
                                     device=dev)


def load_weights(path: str, dev) -> dict[str, torch.Tensor]:
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]).to(dev) for k in z.files}


def _lowered(scene: device.DeviceScene, prec: Precision) -> device.DeviceScene:
    if not prec.lower:
        return scene
    return dataclasses.replace(scene, seg_consts=prec.stage(scene.seg_consts),
                               shade_all_t=prec.stage(scene.shade_all_t))


def trace_rows(scene, camera: Camera, cfg: RenderConfig, frame: int, row0: int, n_rows: int,
               prec: Precision = REFERENCE, pairs_per_chunk: int = 1 << 26):
    """Raw per-pixel sums (color (n, W, 3), weight (n, W), blur (n, W)) of
    rows [row0, row0 + n_rows): every ray against every sub-segment."""
    w, rpp = scene.width, cfg.rays_per_pixel
    scene = _lowered(scene, prec)
    dev = scene.device
    n_px = n_rows * w
    px_chunk = max(1, min(n_px, pairs_per_chunk // (scene.s_pad * rpp)))
    csum = torch.empty((n_px, 3), dtype=torch.float32, device=dev)
    wsum = torch.empty((n_px,), dtype=torch.float32, device=dev)
    bsum = torch.empty((n_px,), dtype=torch.float32, device=dev)
    for p0 in range(0, n_px, px_chunk):
        npx = min(px_chunk, n_px - p0)
        pixel = (row0 * w + p0 + torch.arange(npx, device=dev)).repeat_interleave(rpp)
        sample = torch.arange(rpp, device=dev).repeat(npx)
        origins, dirs = intersect.make_rays(pixel, sample, w, scene.height, camera, cfg, frame)
        color, weight, blur_v = intersect.trace_full(
            scene, prec.stage(origins), prec.stage(dirs), cfg)
        color = color.reshape(npx, rpp, 3)
        weight = weight.reshape(npx, rpp)
        blur_v = blur_v.reshape(npx, rpp)
        csum[p0: p0 + npx] = torch.sum(color * weight[..., None], dim=1)
        wsum[p0: p0 + npx] = torch.sum(weight, dim=1)
        bsum[p0: p0 + npx] = torch.sum(blur_v * weight, dim=1)
    return (prec.stage(csum).reshape(n_rows, w, 3), prec.stage(wsum).reshape(n_rows, w),
            prec.stage(bsum).reshape(n_rows, w))


def normalize(csum, wsum, bsum, cfg: RenderConfig):
    """Weighted means; pixels whose rays all carry zero weight take the
    background colour (alpha 1, blur 0)."""
    has_w = wsum > 0.0
    safe = torch.where(has_w, wsum, 1.0)
    chans = [torch.where(has_w, csum[..., k] / safe, float(v))
             for k, v in enumerate(cfg.background)]
    image = torch.stack(chans + [torch.ones_like(wsum)], dim=-1)
    return image, torch.where(has_w, bsum / safe, 0.0)


def frame_flow(height: int, width: int, events, zoom_before: float, dev) -> torch.Tensor:
    """The flow a frame starts with: zero after every denoised frame, plus
    the events applied just before it, in order (each ("scroll", ticks) or
    ("drag", dx, dy) in pixels), from the zoom ``zoom_before``."""
    f = flow.zero_flow(height, width, dev)
    zoom = zoom_before
    for ev in events:
        if ev[0] == "scroll":
            new = zoom * 1.5 ** (-float(ev[1]))
            f = flow.add_zoom_flow(f, zoom, new)
            zoom = new
        else:
            f = flow.add_translation_flow(f, -float(ev[1]), -float(ev[2]))
    return f


def reference_band(scene, camera: Camera, cfg: RenderConfig, weights, frame: int, history,
                   flow_field, r0: int, r1: int, prec: Precision = REFERENCE):
    """Rows [r0, r1) of (display image, next state) of one frame.

    ``history``: the frame's starting state (H, W, 4); ``flow_field``: its
    flow (H, W, 2), or None for an all-zero flow (no warp).  Requires the
    denoiser and the blur on, as both cells' configurations state."""
    h = scene.height
    radius = cfg.max_blur_radius
    if radius is None:
        radius = blur.blur_radius(scene.max_blur)
    # rows of the next state the blur reads, and the UNet's region for them
    a, b = max(0, r0 - radius), min(h, r1 + radius)
    ua = max(0, (a - unet.BAND_HALO) // unet.BAND_ALIGN * unet.BAND_ALIGN)
    ub = min(h, -(-(b + unet.BAND_HALO) // unet.BAND_ALIGN) * unet.BAND_ALIGN)
    sums = trace_rows(scene, camera, cfg, frame, ua, ub - ua, prec)
    image, blur_map = normalize(*sums, cfg)
    image, blur_map = prec.stage(image), prec.stage(blur_map)
    if flow_field is None:
        warped = history
    else:
        warped = prec.stage(flow.warp_separable(prec.stage(history), flow_field))
    denoised = unet.apply_denoiser(
        weights, image, warped[ua:ub], blur_map, cfg.corrected_image_mix,
        unet.noise_level(cfg.rays_per_pixel), frame, halo=(a - ua, ub - b),
        round_operands=prec.operands)
    denoised = prec.stage(denoised)
    shown = blur.variable_gaussian_blur(denoised, blur_map[a - ua: b - ua], radius,
                                        halo=(r0 - a, b - r1))
    return prec.stage(shown), denoised[r0 - a: r1 - a]
