"""Batched, jittable image ops for the raster front-end (device path).

All ops are pure JAX functions over static-shape arrays, batched over a
leading layer/batch axis: ordered area-resize taps, separable fixed-point
convolutions, stencil passes expressed as shifted-array boolean algebra
(fused by XLA), convergence loops via ``lax.while_loop``.

Bit-exactness contracts (validated against OpenCV in tests):

- ``area_resize``      — bit-exact for integer AND fractional scale ratios
  (exact ``resizeArea`` tab + float32 accumulation-order replica).
- ``gaussian_blur_u8`` — bit-exact for ksize ≤ 7 with sigma=0 (the Q8
  fixed-point small-kernel path).
- ``morphology``       — bit-exact (binary min/max algebra).
- ``canny``            — bit-exact (integer Sobel + fixed-point sector NMS +
  hysteresis-to-fixpoint).
- ``thinning``         — bit-exact vs the reference Zhang–Suen variant.
"""

from .resize import area_resize, resize_if_needed
from .filters import gaussian_blur_u8
from .morphology import structuring_element, erode, dilate, morph_open, morph_close
from .canny import canny
from .thinning import zhang_suen

__all__ = [
    "area_resize",
    "resize_if_needed",
    "gaussian_blur_u8",
    "structuring_element",
    "erode",
    "dilate",
    "morph_open",
    "morph_close",
    "canny",
    "zhang_suen",
]
