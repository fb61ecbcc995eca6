"""OpenCV-exact drawing primitives and ``minEnclosingCircle``.

The reference draws its previews, dedup canvases and forbid masks with cv2;
their pixels are part of the artifact contract.  These wrappers run the
native ports in ``native/raster.cpp`` (pinned pixel-for-pixel against cv2 in
tests/test_raster_native.py) with cv2's call signatures, so the pipeline
needs no OpenCV.  The ``PLOTWEAVE_NO_NATIVE=1`` executable spec draws with
cv2 itself, imported only then.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

from ..native.loader import bind_raster, get_lib

LINE_8 = 8
LINE_AA = 16


def _native():
    lib = get_lib()
    if lib is not None:
        bind_raster(lib)
    return lib


def _cv2():
    import cv2  # noqa: PLC0415 — executable-spec oracle only

    return cv2


def _image_args(img: np.ndarray):
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise TypeError(f"drawing needs a 2-D or 3-D uint8 image, got {img.dtype} {img.shape}")
    cn = 1 if img.ndim == 2 else img.shape[2]
    if img.strides[-1] != 1 or (img.ndim == 3 and img.strides[1] != cn):
        raise ValueError("image rows must be contiguous pixels")
    if not img.flags.writeable:
        raise ValueError("image is read-only")
    return img.ctypes.data, img.shape[0], img.shape[1], cn, img.strides[0]


def _color(color) -> bytes:
    """cv2's scalarToRawData for uint8: four channels, each rounded (half to
    even, like cvRound) and saturated; the rasterizer reads the first cn."""
    vals = list(color) if isinstance(color, (tuple, list, np.ndarray)) else [color]
    vals = (vals + [0, 0, 0, 0])[:4]
    return bytes(min(255, max(0, round(float(v)))) for v in vals)


def polylines(img: np.ndarray, polys: Iterable, closed: bool, color, thickness: int = 1,
              line_type: int = LINE_8) -> np.ndarray:
    """cv2.polylines(img, polys, closed, color, thickness, line_type)."""
    arrs = [np.asarray(p, dtype=np.int32).reshape(-1, 2) for p in polys]
    lib = _native()
    if lib is None:
        _cv2().polylines(img, [a.reshape(-1, 1, 2) for a in arrs], bool(closed), color,
                         int(thickness), int(line_type))
        return img
    if not arrs:
        return img
    ptr, h, w, cn, step = _image_args(img)
    pts = np.ascontiguousarray(np.concatenate(arrs) if len(arrs) > 1 else arrs[0])
    offs = np.zeros(len(arrs) + 1, np.int64)
    np.cumsum([len(a) for a in arrs], out=offs[1:])
    lib.pw_draw_polylines(ptr, h, w, cn, step, pts.ctypes.data, offs.ctypes.data, len(arrs),
                          int(bool(closed)), _color(color), int(thickness), int(line_type), 0)
    return img


def line(img: np.ndarray, p0: Sequence[int], p1: Sequence[int], color, thickness: int = 1,
         line_type: int = LINE_8) -> np.ndarray:
    """cv2.line: one open two-point polyline (both ends capped)."""
    return polylines(img, [[p0, p1]], False, color, thickness, line_type)


def rectangle(img: np.ndarray, p0: Sequence[int], p1: Sequence[int], color,
              thickness: int = 1, line_type: int = LINE_8) -> np.ndarray:
    """cv2.rectangle outline: the closed 4-corner polyline."""
    (x0, y0), (x1, y1) = p0, p1
    return polylines(img, [[(x0, y0), (x1, y0), (x1, y1), (x0, y1)]], True, color,
                     thickness, line_type)


def circle(img: np.ndarray, center: Sequence[int], radius: int, color, thickness: int = 1,
           line_type: int = LINE_8) -> np.ndarray:
    """cv2.circle, filled (thickness < 0) or a 1-px outline."""
    if thickness > 1:
        # thick outlines clip their polygon segments differently in cv2
        # near the border; no caller needs them, so none are drawn unpinned
        raise ValueError("circle outlines thicker than 1 px are not supported")
    lib = _native()
    if lib is None:
        _cv2().circle(img, (int(center[0]), int(center[1])), int(radius), color,
                      int(thickness), int(line_type))
        return img
    ptr, h, w, cn, step = _image_args(img)
    lib.pw_draw_circle(ptr, h, w, cn, step, int(center[0]), int(center[1]), int(radius),
                       _color(color), int(thickness), int(line_type), 0)
    return img


def min_enclosing_circle(points) -> Tuple[Tuple[float, float], float]:
    """cv2.minEnclosingCircle → ((cx, cy), radius) as float32 values."""
    pts = np.ascontiguousarray(np.asarray(points).reshape(-1, 2), dtype=np.float32)
    lib = _native()
    if lib is None:
        (cx, cy), r = _cv2().minEnclosingCircle(pts.reshape(-1, 1, 2))
        return (cx, cy), r
    out = np.zeros(3, np.float32)
    lib.pw_min_enclosing_circle(pts.ctypes.data, len(pts), out.ctypes.data)
    return (float(out[0]), float(out[1])), float(out[2])


def copy_nonwhite(dst: np.ndarray, src: np.ndarray) -> None:
    """dst[p] = src[p] wherever src[p] != (255, 255, 255) — cv2's
    ``copyTo(src, bitwise_not(inRange(src, white, white)), dst)`` for two
    equal-shape contiguous BGR images."""
    if dst.shape != src.shape or src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"need two equal (H, W, 3) images, got {dst.shape} and {src.shape}")
    lib = _native()
    if lib is None or not (dst.flags.c_contiguous and src.flags.c_contiguous):
        keep = (src != 255).any(axis=2)
        dst[keep] = src[keep]
        return
    lib.pw_copy_nonwhite(dst.ctypes.data, src.ctypes.data, src.shape[0] * src.shape[1])
