"""One frame of the renderer with the denoiser off, on a band of rows, in
plain PyTorch: the reference of the cells whose configuration turns the
denoiser off.

``blurred_band`` is a frozen copy of the denoiser-off branch of the
renderer's tail (``_postprocess`` with ``use_denoiser=False``): every ray
of the band's rows and the blur's halo against every sub-segment
(``frame.trace_rows``), the weighted means (``frame.normalize``), then the
variable blur over the band plus the rows its window reaches.  The next
state is the normalized image, unblurred; the history does not enter the
frame.  ``prec`` is ``frame.REFERENCE`` or ``frame.CONTROL``, as for
``frame.reference_band``.

Nothing here imports the program under test.
"""

from __future__ import annotations

from . import blur
from .config import Camera, RenderConfig
from .frame import REFERENCE, Precision, normalize, trace_rows


def blurred_band(scene, camera: Camera, cfg: RenderConfig, frame: int, r0: int, r1: int,
                 prec: Precision = REFERENCE):
    """Rows [r0, r1) of (display image, next state) of one frame with the
    denoiser off and the blur on."""
    h = scene.height
    radius = cfg.max_blur_radius
    if radius is None:
        radius = blur.blur_radius(scene.max_blur)
    a, b = max(0, r0 - radius), min(h, r1 + radius)
    image, blur_map = normalize(*trace_rows(scene, camera, cfg, frame, a, b - a, prec), cfg)
    image, blur_map = prec.stage(image), prec.stage(blur_map)
    shown = image[r0 - a: r1 - a]
    if radius > 0:
        shown = blur.variable_gaussian_blur(image, blur_map, radius, halo=(r0 - a, b - r1))
    return prec.stage(shown), image[r0 - a: r1 - a]
