"""Optical-flow fields for the temporal denoiser.

The reference accumulates approximate flow on zoom/pan events
(helperKernels.cu:163-199, driven from glfw_events.cpp:105-130) and hands it
to the OptiX temporal denoiser as its motion input.  As in the JAX package,
flow is the standard backward-warp field: ``flow[p]`` is the displacement
from pixel p in the *current* frame to the position of the same world point
in the *previous* frame (the reference's wrapping index arithmetic and its
always-zero pan delta are not copied).

Plain PyTorch: the JAX package runs all of this outside Pallas.  The two
resampling products of ``warp_separable`` are float32 ``torch.matmul``s in
full precision (the JAX package asks for ``Precision.HIGHEST``); nothing
here turns TF32 on.
"""

from __future__ import annotations

import torch



def zero_flow(height: int, width: int, device=None) -> torch.Tensor:
    """helperKernels.cu:163-172."""
    return torch.zeros((height, width, 2), dtype=torch.float32, device=device)


def add_zoom_flow(flow: torch.Tensor, old_zoom: float, new_zoom: float, row0: int = 0,
                  height: int | None = None) -> torch.Tensor:
    """Radial flow for a zoom change (helperKernels.cu:175-185, corrected).

    World x of pixel col is (col - w/2) * zoom + off; the same world point was
    at (x - off) / old_zoom + w/2 in the previous frame, so the displacement
    is (col - w/2) * (new_zoom / old_zoom - 1).  ``flow`` may be a row band:
    rows [row0, row0 + its rows) of a frame ``height`` rows high (None: the
    whole frame), each row the same values as the whole frame's."""
    h, w = flow.shape[0], flow.shape[1]
    height = h if height is None else height
    scale = new_zoom / old_zoom - 1.0
    cols = (torch.arange(w, dtype=torch.float32, device=flow.device) - w // 2) * scale
    rows = (torch.arange(row0, row0 + h, dtype=torch.float32, device=flow.device)
            - height // 2) * scale
    return flow + torch.stack([cols[None, :].expand(h, w), rows[:, None].expand(h, w)], dim=-1)


def add_translation_flow(flow: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    """Constant flow for a pan of (dx, dy) pixels (helperKernels.cu:188-199;
    the reference's call site passes zero — fixed, as in the JAX package).
    The components enter as Python scalars: no host-to-device copy."""
    return torch.stack([flow[..., 0] + float(dx), flow[..., 1] + float(dy)], dim=-1)


def _resample_matrix(pos: torch.Tensor, n: int) -> torch.Tensor:
    """(n_in, n_out) bilinear sampling matrix: column j holds the two
    clamp-to-edge bilinear weights for input positions pos[j]."""
    p = torch.clamp(pos, 0.0, n - 1.0)
    i0 = torch.floor(p).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    f = p - i0
    rows = torch.arange(n, device=pos.device)[:, None]  # (n_in, 1)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    return torch.where(rows == i0[None, :], 1.0 - f[None, :], zero) + torch.where(
        rows == i1[None, :], f[None, :], zero
    )


def warp_separable(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp for SEPARABLE flows — axis-aligned fields where flow_x
    depends only on the column and flow_y only on the row.  Every flow this
    renderer produces is one (zoom is radial-separable, pan is constant), and
    separability turns the bilinear warp into two small resampling matrix
    products.  For a general flow field use ``warp_by_flow``.

    An all-zero flow makes both matrices exact identities, and the products
    then reproduce the image bit for bit.  The JAX package skips them behind
    a test of the flow on the device; here that test would make the host wait
    for the card every frame, so this function always runs the products and
    the renderer, which knows on the host when the flow is zero
    (``FrameState.flow_is_zero``), skips the call instead."""
    return warp_separable_profiles(image, flow[0, :, 0], flow[:, 0, 1])


def warp_separable_profiles(image: torch.Tensor, flow_x: torch.Tensor,
                            flow_y: torch.Tensor) -> torch.Tensor:
    """``warp_separable`` from the flow's two profiles: ``flow_x`` (W,) the
    column displacement (any row of the field), ``flow_y`` (H,) the row
    displacement of every row of the frame."""
    h, w = image.shape[0], image.shape[1]
    cols = torch.arange(w, dtype=torch.float32, device=image.device) + flow_x
    rows = torch.arange(h, dtype=torch.float32, device=image.device) + flow_y
    mx = _resample_matrix(cols, w)  # (W, W)
    my = _resample_matrix(rows, h)  # (H, H)
    hp = torch.einsum("hwc,wv->hvc", image, mx)
    return torch.einsum("hvc,hu->uvc", hp, my)


def warp_by_flow(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``image`` (H, W, C) by ``flow`` (H, W, 2) with bilinear
    sampling and clamp-to-edge: the general (gather) form of the warp."""
    h, w = image.shape[0], image.shape[1]
    dev = image.device
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + flow[..., 0]
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + flow[..., 1]
    cols = torch.clamp(cols, 0.0, w - 1.0)
    rows = torch.clamp(rows, 0.0, h - 1.0)
    c0 = torch.floor(cols).to(torch.int64)
    r0 = torch.floor(rows).to(torch.int64)
    c1 = torch.clamp(c0 + 1, max=w - 1)
    r1 = torch.clamp(r0 + 1, max=h - 1)
    fc = (cols - c0)[..., None]
    fr = (rows - r0)[..., None]
    top = image[r0, c0] * (1 - fc) + image[r0, c1] * fc
    bot = image[r1, c0] * (1 - fc) + image[r1, c1] * fc
    return top * (1 - fr) + bot * fr
