"""The variable-sigma Gaussian blur as one launch of the CUDA kernel
``csrc/blur.cu``.

``ops/blur.py::variable_gaussian_blur`` sends CUDA tensors here; its plain
version ``variable_gaussian_blur_plain`` is the CPU path and the reference
that the card tests hold the kernel to, bitwise.  The image is an (H, W, C)
float32 tensor with 1 <= C <= 4 and the sigma map an (H, W) float32 tensor,
both read in place through their strides; ``halo`` gives the rows above and
below the band whose blur is returned, as in the plain version.  There is no
fallback: a tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

MAX_CHANNELS = 4

# Launches of the CUDA blur kernel since the last reset (one per
# variable_gaussian_blur call on a CUDA tensor).
LAUNCHES = 0


def reset_launch_count() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _check(image: torch.Tensor, sigma_map: torch.Tensor, radius: int,
           halo: tuple[int, int]) -> tuple[int, int, int]:
    """Validate the arguments for the kernel; returns (H, W, C)."""
    if image.dtype != torch.float32 or image.dim() != 3:
        raise ValueError(f"the blur kernel takes a float32 (H, W, C) image, got "
                         f"{tuple(image.shape)} {image.dtype}")
    h, w, c = image.shape
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"the blur kernel takes 1 to {MAX_CHANNELS} channels, got {c}")
    if image.numel() == 0:
        raise ValueError(f"the blur kernel takes no empty image, got {tuple(image.shape)}")
    if sigma_map.dtype != torch.float32 or tuple(sigma_map.shape) != (h, w):
        raise ValueError(f"the blur kernel takes a float32 sigma map of the image's {(h, w)}, "
                         f"got {tuple(sigma_map.shape)} {sigma_map.dtype}")
    if sigma_map.device != image.device:
        raise ValueError(f"sigma map on {sigma_map.device}, image on {image.device}")
    if not 0 <= radius <= 1 << 30:
        raise ValueError(f"the blur kernel takes a radius of 0 to 2^30, got {radius}")
    top, bottom = halo
    if top < 0 or bottom < 0 or top + bottom >= h:
        raise ValueError(f"halo {halo} leaves no row of the {h}")
    return h, w, c


def variable_blur(image: torch.Tensor, sigma_map: torch.Tensor, radius: int,
                  halo: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Launch csrc/blur.cu on the image's card.  Returns the blurred rows
    [top, H - bottom), contiguous (H - top - bottom, W, C); one launch per
    call, on the current stream, without a synchronize."""
    global LAUNCHES
    radius, halo = int(radius), (int(halo[0]), int(halo[1]))
    h, w, c = _check(image, sigma_map, radius, halo)
    if image.device.type != "cuda":
        raise ValueError(f"the blur kernel runs on a CUDA device, got {image.device}")
    from . import _build  # builds csrc/blur.cu on first use

    top, bottom = halo
    h_out = h - top - bottom
    out = torch.empty((h_out, w, c), dtype=torch.float32, device=image.device)
    lib = _build.load("blur")
    stream = torch.cuda.current_stream(image.device).cuda_stream
    err = lib.rtdc_variable_blur(
        image.data_ptr(), sigma_map.data_ptr(), out.data_ptr(), h, w, c, radius, top, h_out,
        *image.stride(), *sigma_map.stride(), ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"blur kernel launch failed: {_build.error_string(lib, err)}")
    LAUNCHES += 1
    return out
