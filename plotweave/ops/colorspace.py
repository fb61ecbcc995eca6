"""Color-space conversions (BGR ↔ Lab) in OpenCV's 8-bit conventions.

Float sRGB→XYZ(D65)→L*a*b* with the 8-bit packing L·255/100, a+128, b+128
(reference use: 02_color_extract.py:35 clusters in this space).  Values agree
with OpenCV within ±2 code units (OpenCV uses fixed-point tables); k-means
clustering behavior is insensitive to that (tolerance-tested).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# sRGB → XYZ (D65), rows scaled so white maps to (0.950456, 1.0, 1.088754).
# Kept as NUMPY constants: a module-level jnp.array is an eager dispatch that
# would initialize the default backend at import time; as numpy they embed
# into the jitted program at trace time instead.
_M = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_WHITE = np.array([0.950456, 1.0, 1.088754], dtype=np.float32)


def _srgb_gamma_inv(u: jax.Array) -> jax.Array:
    return jnp.where(u <= 0.04045, u / 12.92, ((u + 0.055) / 1.055) ** 2.4)




def _f(t: jax.Array) -> jax.Array:
    d = 6.0 / 29.0
    return jnp.where(t > d**3, jnp.cbrt(t), t / (3 * d * d) + 4.0 / 29.0)




@jax.jit
def bgr_to_lab_u8(img: jax.Array) -> jax.Array:
    """(..., 3) uint8 BGR → (..., 3) float32 Lab in 8-bit scaling (0..255)."""
    bgr = img.astype(jnp.float32) / 255.0
    rgb = bgr[..., ::-1]
    lin = _srgb_gamma_inv(rgb)
    xyz = jnp.einsum("ij,...j->...i", _M, lin, precision=jax.lax.Precision.HIGHEST) / _WHITE
    fx, fy, fz = _f(xyz[..., 0]), _f(xyz[..., 1]), _f(xyz[..., 2])
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return jnp.stack([L * 255.0 / 100.0, a + 128.0, b + 128.0], axis=-1)
