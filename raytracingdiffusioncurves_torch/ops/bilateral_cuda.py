"""The denoiser's 5x5 joint bilateral filter as one launch of the CUDA kernel
``csrc/bilateral.cu``.

``ops/denoise.py::spatial_bilateral`` sends CUDA tensors here and hands over
the filter's constants; its plain version ``spatial_bilateral_plain`` is the
CPU path and the reference that the card tests hold the kernel to, bitwise.
The image is any (..., H, W, C) float32 tensor with 3 <= C <= 8, read in
place through its strides (the main path's ``image[..., :3]`` view of the
(H, W, 4) frame takes no copy); leading axes are a batch.  There is no
fallback: a tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

MAX_CHANNELS = 8
MAX_BATCH = 65535  # the grid's z axis

# Launches of the CUDA bilateral kernel since the last reset (one per
# spatial_bilateral call on a CUDA tensor).
LAUNCHES = 0


def reset_launch_count() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _check_image(image: torch.Tensor) -> tuple[int, int, int]:
    """Validate an image for the kernel; returns (H, W, C)."""
    if image.dtype != torch.float32 or image.dim() < 3:
        raise ValueError(f"the bilateral kernel takes a float32 (..., H, W, C) image, got "
                         f"{tuple(image.shape)} {image.dtype}")
    h, w, c = image.shape[-3:]
    if not 3 <= c <= MAX_CHANNELS:
        raise ValueError(f"the bilateral kernel takes 3 to {MAX_CHANNELS} channels, got {c}")
    if image.numel() == 0:
        raise ValueError(f"the bilateral kernel takes no empty image, got {tuple(image.shape)}")
    return h, w, c


def _float4_pixels(flat: torch.Tensor) -> bool:
    """Whether the kernel may stage each pixel of the (N, H, W, C) view as one
    16-byte load: 4-float pixels of unit channel stride, 16-byte aligned, and
    the last pixel's 16 bytes inside the storage (C = 3 reads the fourth)."""
    n, h, w, c = flat.shape
    s_n, s_y, s_x, s_c = flat.stride()
    if c > 4 or s_c != 1 or s_x != 4 or s_y % 4 or (n > 1 and s_n % 4) or flat.data_ptr() % 16:
        return False
    last = flat.storage_offset() + (n - 1) * s_n + (h - 1) * s_y + (w - 1) * s_x
    return (last + 4) * flat.element_size() <= flat.untyped_storage().nbytes()


def bilateral5x5(image: torch.Tensor, spatial: Sequence[float], inv_sc: float,
                 bf16_weights: bool) -> torch.Tensor:
    """Launch csrc/bilateral.cu on the image's card: ``spatial`` holds the 25
    taps' spatial terms (dy-major) and ``inv_sc`` the colour scale, as the
    weight chain uses them (bf16 values in the bf16 branch).  Returns the
    filtered image, contiguous, of the input's shape; one launch per call,
    on the current stream, without a synchronize."""
    global LAUNCHES
    h, w, c = _check_image(image)
    if image.device.type != "cuda":
        raise ValueError(f"the bilateral kernel runs on a CUDA device, got {image.device}")
    if len(spatial) != 25:
        raise ValueError(f"25 spatial terms, one per tap, got {len(spatial)}")
    from . import _build  # builds csrc/bilateral.cu on first use

    flat = image.reshape(-1, h, w, c)
    n = flat.shape[0]
    if n > MAX_BATCH:
        raise ValueError(f"the bilateral kernel takes at most {MAX_BATCH} images, got {n}")
    out = torch.empty(image.shape, dtype=torch.float32, device=image.device)
    lib = _build.load("bilateral")
    stream = torch.cuda.current_stream(image.device).cuda_stream
    err = lib.rtdc_bilateral5x5(
        flat.data_ptr(), out.data_ptr(), n, h, w, c, *flat.stride(),
        int(_float4_pixels(flat)), (ctypes.c_float * 25)(*spatial), inv_sc,
        int(bf16_weights), ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"bilateral kernel launch failed: {_build.error_string(lib, err)}")
    LAUNCHES += 1
    return out
