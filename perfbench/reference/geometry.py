"""Curve math for the scene layer (host side, NumPy).

The reference stores each cubic Bezier segment as 4 *B-spline* control points
(converted through a fixed 4x4 matrix, optixHello.cpp:76-79,1335-1343) because
OptiX's built-in primitive is a round cubic B-spline.  Our intersector is our
own, so the canonical representation here is the original cubic **Bezier**
control points; ``bspline_from_bezier`` and the B-spline basis evaluators exist
to prove (in tests) that both representations trace the same curve.
"""

from __future__ import annotations

import numpy as np

# Maps Bezier control points -> B-spline control points such that the uniform
# cubic B-spline through the converted points reproduces the Bezier
# (reference: optixHello.cpp:76-79; applied without the 1/6 factor, which lives
# in the device basis functions, DeviceCode.cu:71-75).
BSPLINE_CORRECTION_MATRIX = np.array(
    [
        [6.0, -7.0, 2.0, 0.0],
        [0.0, 2.0, -1.0, 0.0],
        [0.0, -1.0, 2.0, 0.0],
        [0.0, 2.0, -7.0, 6.0],
    ],
    dtype=np.float32,
)


def bspline_from_bezier(points: np.ndarray) -> np.ndarray:
    """Convert Bezier control points (..., 4, 2) to B-spline control points.

    Equivalent of ``correctControlPoints`` (optixHello.cpp:1335-1343).
    """
    return np.einsum("ij,...jk->...ik", BSPLINE_CORRECTION_MATRIX, points)


def bezier_basis(t: np.ndarray) -> np.ndarray:
    """Cubic Bernstein basis, shape t.shape + (4,)."""
    t = np.asarray(t, dtype=np.float64)
    mt = 1.0 - t
    return np.stack([mt**3, 3.0 * mt**2 * t, 3.0 * mt * t**2, t**3], axis=-1)


def bezier_point(points: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Evaluate a cubic Bezier: points (..., 4, 2), t (...) -> (..., 2)."""
    basis = bezier_basis(t)
    return np.einsum("...i,...ik->...k", basis, np.asarray(points, np.float64))


def bezier_derivative(points: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Derivative of a cubic Bezier wrt t, shape (..., 2).

    Matches ``getBezierTangent`` (optixHello.cpp:1354-1357):
      3t^2*P3 + P0*(-3t^2+6t-3) + P1*(9t^2-12t+3) + P2*(-9t^2+6t)
    """
    p = np.asarray(points, np.float64)
    t = np.asarray(t, np.float64)[..., None]
    return (
        3.0 * t**2 * p[..., 3, :]
        + p[..., 0, :] * (-3.0 * t**2 + 6.0 * t - 3.0)
        + p[..., 1, :] * (9.0 * t**2 - 12.0 * t + 3.0)
        + p[..., 2, :] * (-9.0 * t**2 + 6.0 * t)
    )


def bspline_point(points: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Uniform cubic B-spline position as the reference device evaluates it
    (DeviceCode.cu:71-75). points (..., 4, 2), t (...) -> (..., 2)."""
    p = np.asarray(points, np.float64)
    t = np.asarray(t, np.float64)[..., None]
    return (1.0 / 6.0) * (
        t**3 * p[..., 3, :]
        + p[..., 0, :] * (-(t**3) + 3.0 * t**2 - 3.0 * t + 1.0)
        + p[..., 1, :] * (3.0 * t**3 - 6.0 * t**2 + 4.0)
        + p[..., 2, :] * (-3.0 * t**3 + 3.0 * t**2 + 3.0 * t + 1.0)
    )


def bspline_derivative(points: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Uniform cubic B-spline derivative (DeviceCode.cu:64-68, the x-component
    of the normal there is +dy and the y-component is -dx)."""
    p = np.asarray(points, np.float64)
    t = np.asarray(t, np.float64)[..., None]
    return (1.0 / 6.0) * (
        3.0 * t**2 * p[..., 3, :]
        + p[..., 0, :] * (-3.0 * t**2 + 6.0 * t - 3.0)
        + p[..., 1, :] * (9.0 * t**2 - 12.0 * t)
        + p[..., 2, :] * (-9.0 * t**2 + 6.0 * t + 3.0)
    )


def right_normal(derivative: np.ndarray) -> np.ndarray:
    """Normal to the right of the travel direction: (dy, -dx)
    (reference: calculateSplineNormal, DeviceCode.cu:64-68)."""
    d = np.asarray(derivative)
    return np.stack([d[..., 1], -d[..., 0]], axis=-1)


def endcap_points(
    endpoint: np.ndarray, tangent: np.ndarray, endcap_size: float
) -> tuple[np.ndarray, np.ndarray]:
    """Middle two control points of an endcap loop.

    Matches ``getEndcapPoints`` (optixHello.cpp:1360-1369): rotate the points
    (-1, 1) and (1, 1) by the angle that takes +y onto the (normalized)
    tangent, scale by endcap_size, translate to the endpoint.  The reference
    normalizes with the Quake fast inverse sqrt (optixHello.cpp:1372-1386,
    ~0.2% error); we use the exact value, an invisible deviation.
    """
    tx, ty = float(tangent[0]), float(tangent[1])
    inv = 1.0 / np.sqrt(tx * tx + ty * ty)
    cos = ty * inv
    sin = -tx * inv
    ex, ey = float(endpoint[0]), float(endpoint[1])
    p1 = np.array([(-cos - sin) * endcap_size + ex, (-sin + cos) * endcap_size + ey], np.float32)
    p2 = np.array([(cos - sin) * endcap_size + ex, (sin + cos) * endcap_size + ey], np.float32)
    return p1, p2


def make_endcap_segment(
    curve_points: np.ndarray, at_start: bool, endcap_size: float
) -> np.ndarray:
    """Synthesize the 4 Bezier control points of an endcap loop.

    Reference: optixHello.cpp:229-274 (start cap, tangent at t=1e-3 reversed)
    and :290-329 (end cap, tangent at t=1-1e-3).  ``curve_points`` is the
    (4, 2) Bezier control polygon of the adjacent segment; for the end cap the
    caller passes the *last* segment and ``at_start=False``.
    """
    curve_points = np.asarray(curve_points, np.float32)
    if at_start:
        endpoint = curve_points[0]
        tan = -bezier_derivative(curve_points, np.float32(1e-3))
    else:
        endpoint = curve_points[3]
        tan = bezier_derivative(curve_points, np.float32(1.0 - 1e-3))
    p1, p2 = endcap_points(endpoint, tan, endcap_size)
    return np.stack([endpoint, p1, p2, endpoint]).astype(np.float32)
