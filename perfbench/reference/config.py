"""Runtime configuration for the PyTorch / CUDA diffusion-curve renderer.

The reference builds these as compile-time ``#define``s and hardcoded constants
(reference: optixHello/params.h:24-32, optixHello/optixHello.cpp:89-98,
glfw_events.cpp:39, helperKernels.cu:27-31).  Here they are one runtime
dataclass, field for field the same as the JAX package's, so a config means
the same render in both packages.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All knobs of the render pipeline.

    Fields are hashable/static so a ``RenderConfig`` can be a static argument
    of a jitted render function.
    """

    # Number of stratified rays in the per-pixel fan
    # (reference: optixHello.cpp:101, DeviceCode.cu:117).
    rays_per_pixel: int = 128

    # Orzan "diffusion curve save" convention: swap x<->y on control points,
    # mirror the y axis and swap the R and B color channels
    # (reference: params.h:24, optixHello.cpp:1305-1307,1318-1325, DeviceCode.cu:104).
    diffusion_curve_save: bool = True

    # Post-processing toggles (reference: params.h:27-29).
    use_blur: bool = True
    use_aa: bool = True
    use_denoiser: bool = True

    # Maximum number of portal traversals per ray (reference: params.h:32).
    max_trace_depth: int = 2

    # Weight exponent used when a curve carries no <weight_degree_set>
    # (reference: optixHello.cpp:94).
    default_weight_degree: float = 0.5

    # Radius of the swept curve primitive. The reference renders curves as
    # radius-1e-3 tubes (optixHello.cpp:95,531-535); we intersect the curve
    # centerline directly and use this only as the minimum-hit-distance scale.
    curve_width: float = 1e-3

    # Size of the synthesized endcap loops (reference: optixHello.cpp:96).
    endcap_size: float = 8.0

    # Fraction of the denoised image blended into the output; 1 = fully
    # denoised (reference: optixHello.cpp:98,1131: blendFactor = 1 - mix).
    corrected_image_mix: float = 1.0

    # --- Port knobs (no reference counterpart) ---

    # Uniform subdivisions per cubic segment when flattening curves into line
    # sub-segments.  Attribute knots are always added as extra breakpoints, so
    # attribute interpolation is exact regardless of this value; it only
    # controls geometric fidelity of the flattened curve (error ~ O(1/K^2)).
    flatten_subdivisions: int = 16

    # Exact silhouettes: widen the chord sweep's acceptance by each
    # sub-segment's conservative capsule band (scene/device.py CONST_BAND)
    # and let the Newton residual on the exact cubic decide hit/miss —
    # hit/miss then no longer follows the flattening chords, matching the
    # reference's implicit curve intersector (optixHello.cpp:871-879) at any
    # flatten_subdivisions (and killing the viewer's deep-zoom re-flatten).
    exact_silhouettes: bool = True

    # Hits closer than this (in scene units ~ pixels) are rejected.  Replaces
    # OptiX's implicit tube-radius behaviour and guards portal continuation
    # rays, which originate exactly on the target curve, from re-hitting it
    # (reference relies on OptiX tube intersection, DeviceCode.cu:267-280).
    min_hit_distance: float = 1e-2

    # Weighted-average denominator guard: a pixel whose rays all miss is NaN
    # in the reference (DeviceCode.cu:176-181, 0/0).  We emit this background
    # color instead and keep the semantics documented.
    background: tuple[float, float, float] = (0.0, 0.0, 0.0)

    # Rays per pixel block: sizes the (tile, wedge) acceleration grid exactly
    # as in the JAX package (ops/trace_cuda.py _choose_block), so candidate
    # tables compare 1:1 between the two packages.
    rays_per_block: int = 4096

    # Maximum Gaussian blur radius in pixels for the variable-sigma blur.
    # The reference computes a per-pixel radius ceil(3*sigma)
    # (helperKernels.cu:65); the blur takes a fixed tap bound, sized from the
    # scene's maximum blur value at load time unless overridden here.
    max_blur_radius: int | None = None

    # PRNG seed for the stratified sampling jitter. The reference seeds
    # curand with the pixel index (helperKernels.cu:151-160); we use a
    # counter-based hash of (seed, pixel, sample, frame) instead.
    seed: int = 0

    def __post_init__(self):
        if self.rays_per_pixel < 1:
            raise ValueError("rays_per_pixel must be >= 1")
        if self.max_trace_depth < 0:
            raise ValueError("max_trace_depth must be >= 0")
        if self.flatten_subdivisions < 1:
            raise ValueError("flatten_subdivisions must be >= 1")


@dataclasses.dataclass(frozen=True)
class Camera:
    """Zoom/pan camera (reference mutates Params fields: params.h:94-97,
    glfw_events.cpp:105-130).  Plain floats: the kernels take them as
    launch arguments, so moving the camera never rebuilds anything."""

    zoom_factor: float = 1.0
    offset_x: float = 0.0
    offset_y: float = 0.0
