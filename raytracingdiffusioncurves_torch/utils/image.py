"""Image quantization and file output (screenshot parity).

Reference: the F11 screenshot path (glfw_events.cpp:53-100) copies the float4
image to the host, converts with ``min(c * 255, 255)`` truncated to uint8
(:76-79 — C's float->unsigned char conversion truncates), flips vertically
when rendering diffusion-curve saves (:92), and writes a timestamped JPG.
"""

from __future__ import annotations

import datetime

import numpy as np

FILE_PREFIX = "screenshot-"


def to_uint8(image, flip_vertical: bool = True) -> np.ndarray:
    """Quantize an (H, W, C) float image exactly like the reference
    screenshot: min(c*255, 255) truncated toward zero (glfw_events.cpp:76-79),
    with NaNs mapped to 0 (the reference leaves them undefined)."""
    if hasattr(image, "detach"):  # a torch tensor, on any device
        image = image.detach().cpu().numpy()
    img = np.asarray(image, np.float32)
    img = np.nan_to_num(img, nan=0.0)
    q = np.minimum(img * 255.0, 255.0)
    q = np.clip(q, 0.0, 255.0).astype(np.uint8)  # truncation, like the C cast
    if flip_vertical:
        q = q[::-1]
    return q


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
