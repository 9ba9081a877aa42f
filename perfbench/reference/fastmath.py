"""Fast sincos shared by the plain trace and the CUDA trace kernel.

Bit-exact twin of the JAX package's ``ops/fastmath.py``: one quadrant
reduction by pi/2 (two-term exact subtraction), the Cephes sinf/cosf
minimax polynomials on [-pi/4, pi/4], and branch-free quadrant selection.
The CUDA kernel (csrc/trace.cu ``fast_sincos``) evaluates the same
operations in the same order, built with ``--fmad=false`` so no multiply-add
is contracted; raygen directions are then identical in every path.

Replaces the reference's device libm usage in raygen
(optixHello/DeviceCode.cu:128-133).
"""

from __future__ import annotations

import numpy as np
import torch

_TWO_OVER_PI = float(np.float32(0.6366197723675814))
# pi/2 split into float32 head + tail.
_PIO2_HI = float(np.float32(1.5707963705062866))
_PIO2_LO = float(np.float32(-4.371139000186241e-08))

_S1 = float(np.float32(-1.6666654611e-1))
_S2 = float(np.float32(8.3321608736e-3))
_S3 = float(np.float32(-1.9515295891e-4))
_C1 = float(np.float32(4.166664568298827e-2))
_C2 = float(np.float32(-1.388731625493765e-3))
_C3 = float(np.float32(2.443315711809948e-5))


def sincos(theta: torch.Tensor):
    """(sin(theta), cos(theta)) float32 for theta in [0, ~4*pi).

    Requires theta >= 0: the truncating int cast is floor only for
    non-negative arguments (kept deliberately — it is what the JAX package
    and the kernel do)."""
    x = theta.to(torch.float32)
    q = (x * _TWO_OVER_PI + 0.5).to(torch.int32)  # trunc == floor, x >= 0
    qf = q.to(torch.float32)
    d = (x - qf * _PIO2_HI) - qf * _PIO2_LO
    z = d * d
    s = ((_S3 * z + _S2) * z + _S1) * z * d + d
    c = ((_C3 * z + _C2) * z + _C1) * (z * z) - 0.5 * z + 1.0
    swap = (q & 1) == 1
    sin_v = torch.where(swap, c, s)
    cos_v = torch.where(swap, s, c)
    # cos(d + q*pi/2) flips sign for q mod 4 in {1, 2}; sin for {2, 3}
    cos_v = torch.where(((q + 1) & 2) != 0, -cos_v, cos_v)
    sin_v = torch.where((q & 2) != 0, -sin_v, sin_v)
    return sin_v, cos_v
