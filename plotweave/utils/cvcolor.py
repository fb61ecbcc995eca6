"""OpenCV's 8-bit colour conversions, bit-exact, in numpy.

The reference clusters in cv2's fixed-point uint8 Lab (``COLOR_BGR2LAB``)
and names each palette entry by ``COLOR_LAB2BGR`` of the truncated centre,
so both conversions are part of the byte contract.  These are ports of
OpenCV's integer paths (imgproc/color_lab.cpp: ``RGB2Lab_b`` and
``Lab2RGBinteger``), their lookup tables rebuilt from the same float32
formulas; tests/test_cvcolor.py checks both against cv2 over all 2^24 inputs.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_F = np.float32

# sRGB primaries and D65 white, as OpenCV states them
_SRGB2XYZ = np.array(
    [[0.412453, 0.357580, 0.180423],
     [0.212671, 0.715160, 0.072169],
     [0.019334, 0.119193, 0.950227]]
)
_XYZ2SRGB = np.array(
    [[3.240479, -1.53715, -0.498535],
     [-0.969256, 1.875991, 0.041556],
     [0.055648, -0.204043, 1.057311]]
)
_D65 = np.array([0.950456, 1.0, 1.088754])

_LAB_SHIFT = 12            # XYZ coefficient scale (2^12)
_LAB_SHIFT2 = 15           # cube-root table scale (lab_shift + gamma_shift)
_GAMMA_SCALE = 255 * 8     # sRGB gamma table range (gamma_shift = 3)
_BASE = 1 << 14            # Lab→RGB fixed-point base
_INV_GAMMA_SIZE = 4096


def _round(x) -> np.ndarray:
    """cvRound: round half to even."""
    return np.rint(x).astype(np.int32)


def _descale(v, n: int):
    return (v + (1 << (n - 1))) >> n


def _gamma(x32: np.ndarray) -> np.ndarray:
    xd = x32.astype(np.float64)
    return np.where(xd <= 0.04045, xd / 12.92, ((xd + 0.055) / 1.055) ** 2.4).astype(_F)


def _inv_gamma(x32: np.ndarray) -> np.ndarray:
    xd = x32.astype(np.float64)
    return np.where(xd <= 0.0031308, xd * 12.92, 1.055 * xd ** (1 / 2.4) - 0.055).astype(_F)


@lru_cache(maxsize=1)
def _lab_tables():
    i = np.arange(256)
    gamma = _round(_F(_GAMMA_SCALE) * _gamma(i.astype(_F) / _F(255)))
    j = np.arange(256 * 3 // 2 * 8)
    x = _F(1) / _F(_GAMMA_SCALE) * j.astype(_F)
    lin = (x.astype(np.float64) * np.float64(_F(7.787)) + np.float64(_F(16.0 / 116.0))).astype(_F)
    cbrt = np.where(x < _F(0.008856), lin, np.cbrt(x.astype(np.float64)).astype(_F))
    cbrt = _round(_F(1 << _LAB_SHIFT2) * cbrt)
    # OpenCV's own cube root lands one float32 ulp low at 324/2040, where the
    # correctly rounded value is exactly a half-integer after scaling
    cbrt[324] -= 1
    # rows X, Y, Z; columns in BGR source order
    coeffs = np.array(
        [[round((1 << _LAB_SHIFT) * _SRGB2XYZ[r, c] / _D65[r]) for c in (2, 1, 0)] for r in range(3)],
        np.int32,
    )
    return gamma, cbrt, coeffs


def bgr2lab_u8(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2LAB) for uint8 (..., 3) BGR."""
    gamma, cbrt, c = _lab_tables()
    t = gamma[np.asarray(img, np.uint8)]
    f = [cbrt[_descale(t @ c[r], _LAB_SHIFT)] for r in range(3)]
    half = 128 << _LAB_SHIFT2
    lightness = _descale(296 * f[1] - 1336934, _LAB_SHIFT2)
    a = _descale(500 * (f[0] - f[1]) + half, _LAB_SHIFT2)
    b = _descale(200 * (f[1] - f[2]) + half, _LAB_SHIFT2)
    return np.clip(np.stack([lightness, a, b], axis=-1), 0, 255).astype(np.uint8)


@lru_cache(maxsize=1)
def _inv_tables():
    inv_gamma = _round(_F(255) * _inv_gamma((_F(1) / _F(_INV_GAMMA_SIZE)) * np.arange(_INV_GAMMA_SIZE).astype(_F)))
    y = np.zeros(256, np.int64)
    ify = np.zeros(256, np.int64)
    for i in range(256):
        if i <= 20:
            y[i] = np.rint(_F(i * _BASE * 20 * 9) / _F(17 * 29 * 29 * 29))
            ify[i] = np.rint(_F(_BASE) * (_F(16) / _F(116) + _F(i * 5) / _F(3 * 17 * 29)))
        else:
            fy = _F(i * 100 * _BASE) / _F(255 * 116) + _F(16 * _BASE) / _F(116)
            ify[i] = np.rint(fy)
            y[i] = np.rint(fy * fy * fy / _F(_BASE * _BASE))
    # rows B, G, R (output order); columns X, Y, Z
    coeffs = np.array(
        [[round((1 << _LAB_SHIFT) * _XYZ2SRGB[o, c] * _D65[c]) for c in range(3)] for o in (2, 1, 0)],
        np.int64,
    )
    return inv_gamma, y, ify, coeffs


def _tdiv(a, b: int):
    """C integer division (truncates toward zero)."""
    return np.where(a >= 0, a // b, -((-a) // b))


def _ab_to_xz(v):
    lin = _tdiv(v * 108, 841) - _BASE * 16 // 116 * 108 // 841
    cube = _tdiv(_tdiv(v * v, _BASE) * v, _BASE)
    return np.where(v <= 3390, lin, cube)


def lab2bgr_u8(lab: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(lab, COLOR_LAB2BGR) for uint8 (..., 3) Lab."""
    inv_gamma, y_tab, ify_tab, c = _inv_tables()
    lab = np.asarray(lab, np.uint8).astype(np.int64)
    y = y_tab[lab[..., 0]]
    ify = ify_tab[lab[..., 0]]
    # OpenCV's fixed-point stand-ins for a*BASE/500 and b*BASE/200
    adiv = ((5 * lab[..., 1] * 53687 + (1 << 7)) >> 13) - 128 * _BASE // 500
    bdiv = ((lab[..., 2] * 41943 + (1 << 4)) >> 9) - 128 * _BASE // 200 + 1
    x = _ab_to_xz(ify + adiv)
    z = _ab_to_xz(ify - bdiv)
    out = [
        inv_gamma[np.clip(_descale(c[o, 0] * x + c[o, 1] * y + c[o, 2] * z, 14), 0, _INV_GAMMA_SIZE - 1)]
        for o in range(3)
    ]
    return np.clip(np.stack(out, axis=-1), 0, 255).astype(np.uint8)
