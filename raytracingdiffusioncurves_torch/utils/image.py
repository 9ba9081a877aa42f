"""Image quantization and file output (screenshot parity).

Reference: the F11 screenshot path (glfw_events.cpp:53-100) copies the float4
image to the host, converts with ``min(c * 255, 255)`` truncated to uint8
(:76-79 — C's float->unsigned char conversion truncates), flips vertically
when rendering diffusion-curve saves (:92), and writes a timestamped JPG.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

FILE_PREFIX = "screenshot-"


def to_uint8(image, flip_vertical: bool = True) -> np.ndarray:
    """Quantize an (H, W, C) float image exactly like the reference
    screenshot (``to_uint8_device``'s rule), returned on the host."""
    if not hasattr(image, "detach"):
        image = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    return to_uint8_device(image, flip_vertical).cpu().numpy()


def to_uint8_device(image: torch.Tensor, flip_vertical: bool = True) -> torch.Tensor:
    """Quantize on the tensor's own device: min(c*255, 255) truncated toward
    zero (glfw_events.cpp:76-79), NaNs mapped to 0 (the reference leaves
    them undefined), optionally flipped vertically.  A display then copies
    one byte per channel to the host instead of four.  Returns a contiguous
    uint8 tensor on that device."""
    img = torch.nan_to_num(image.detach().to(torch.float32), nan=0.0)
    q = torch.clamp(img * 255.0, 0.0, 255.0).to(torch.uint8)  # truncation, like the C cast
    if flip_vertical:
        q = torch.flip(q, dims=(0,))
    return q.contiguous()


def save_image(image: np.ndarray, path: str | None = None, flip_vertical: bool = True) -> str:
    """Write the rendered image to ``path`` (format from the extension) or to
    a timestamped screenshot-*.jpg like the reference (glfw_events.cpp:85-94)."""
    from PIL import Image

    if path is None:
        stamp = datetime.datetime.now().strftime("%d-%m-%Y-%H-%M-%S")
        path = f"{FILE_PREFIX}{stamp}.jpg"
    q = to_uint8(image, flip_vertical)
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[q.shape[2]] if q.ndim == 3 else "L"
    if path.lower().endswith((".jpg", ".jpeg")) and mode == "RGBA":
        q = q[..., :3]
        mode = "RGB"
    Image.fromarray(q.squeeze() if mode == "L" else q, mode).save(path)
    return path


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))
