"""Per-pixel variable-sigma separable Gaussian blur.

Reference semantics (helperKernels.cu:48-148), as in the JAX package's
``ops/blur.py``:

* separable horizontal-then-vertical passes;
* per-pixel kernel half-width ceil(3 * sigma) (the "99 percentile": :65);
* tap weight exp(-k^2 / (sigma + 1e-6)^2) — no factor 2, and the 1e-6
  floor is added to sigma *before* squaring (:68,79);
* clamp-to-edge borders (:76,117);
* per-pixel weight renormalization (:91-94);
* all four channels blurred.

The radius is a fixed tap bound (sized from the scene's maximum blur) and
taps beyond the per-pixel ceil(3*sigma) get weight 0 — the same result as
the reference's per-pixel loop.  An all-zero sigma map gives the input back
exactly (every tap past k = 0 has weight 0), so no skip test is needed.

This was no Pallas kernel in the JAX package.  On the card it is one
launch of the hand-written kernel ``csrc/blur.cu`` (``ops/blur_cuda.py``),
bitwise equal to the plain version kept here, which is the CPU path.
"""

from __future__ import annotations

import math

import torch

from . import blur_cuda

MINUM_SIGMA = 1e-6


def _variable_gauss_1d(image: torch.Tensor, sigma: torch.Tensor, radius: int, axis: int,
                       first: int = 0, count: int | None = None):
    """One blur pass along ``axis`` (0 = vertical, 1 = horizontal), for the
    ``count`` positions from ``first`` along it (None: all); the taps read
    the whole axis, clamped to its ends.

    Incremental Gaussian weights: gauss_k = e1^(k^2) with e1 =
    exp(-1/sig^2), advanced by g_{k+1} = g_k * e1^(2k+1) — one exp per
    pixel per pass, and the +-k tap pair shares its weight."""
    n = image.shape[axis]
    count = n - first if count is None else count
    centre = image.narrow(axis, first, count)
    sigma = sigma.narrow(axis, first, count)
    sig = sigma + MINUM_SIGMA
    inv_sig_sq = 1.0 / (sig * sig)
    k_half = torch.ceil(3.0 * sigma)  # per-pixel half-width, from raw sigma

    idx = torch.arange(first, first + count, device=image.device)

    def shift(k):  # clamp-to-edge neighbour at offset k along axis
        return torch.index_select(image, axis, torch.clamp(idx + k, 0, n - 1))

    e1 = torch.exp(-inv_sig_sq)
    e2 = e1 * e1
    accum = centre.to(torch.float32)  # k = 0 tap, weight 1
    wsum = torch.ones(centre.shape[:2], dtype=torch.float32, device=image.device)
    g = e1  # gauss_1
    m = e1 * e2  # e1^(2k+1) at k = 1
    for k in range(1, radius + 1):
        gk = torch.where(k <= k_half, g, 0.0)
        accum = accum + (shift(k) + shift(-k)) * gk[..., None]
        wsum = wsum + 2.0 * gk
        g = g * m
        m = m * e2
    return accum / wsum[..., None]


def variable_gaussian_blur(image: torch.Tensor, sigma_map: torch.Tensor, radius: int,
                           halo: tuple[int, int] = (0, 0)):
    """image (H, W, C), sigma_map (H, W) -> blurred (H, W, C).

    ``radius`` is the tap bound; it must be >= ceil(3 * max(sigma)) for
    exact reference parity (gaussianBlur, helperKernels.cu:137-148).

    ``halo`` (rows above, rows below): the inputs are a row band of a frame
    with that many of the frame's rows on each side, and the result is the
    band's rows alone, bitwise those of the whole frame's blur.  A side
    holds ``radius`` rows, or all the rows up to the frame's edge (where
    the clamp then applies, as on the whole frame).

    A CUDA tensor takes one launch of the kernel (``blur_cuda``), bitwise
    equal to ``variable_gaussian_blur_plain``; a CPU tensor takes the plain
    version."""
    device = image.device
    if device.type == "cuda":
        return blur_cuda.variable_blur(image, sigma_map, radius, halo)
    if device.type != "cpu":
        raise RuntimeError(f"no blur path for device {device}")
    return variable_gaussian_blur_plain(image, sigma_map, radius, halo)


def variable_gaussian_blur_plain(image: torch.Tensor, sigma_map: torch.Tensor, radius: int,
                                 halo: tuple[int, int] = (0, 0)):
    """The plain PyTorch version of ``variable_gaussian_blur``, on any device:
    two passes of ``_variable_gauss_1d``."""
    top, bottom = halo
    out = _variable_gauss_1d(image, sigma_map, radius, axis=1)  # horizontal first
    return _variable_gauss_1d(out, sigma_map, radius, axis=0, first=top,
                              count=image.shape[0] - top - bottom)  # then vertical


def blur_radius(max_blur: float) -> int:
    """The tap bound ceil(3 * max_blur) the renderer uses."""
    return int(math.ceil(3.0 * max_blur))
