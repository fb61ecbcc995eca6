#!/usr/bin/env python3
"""Measure the single-core CPU rate of the reference's raster front-end.

Runs the reference's own implementations (cv2 morphology/blur/canny with one
thread + the reference stage-04 vectorized-numpy Zhang–Suen, imported from
/root/reference) on a 2000×1500 synthetic portrait-like image with 4 layers —
the same work plotweave's fused `raster_frontend` does on the device.  Prints the
megapixels/sec figure embedded in bench.py as the baseline.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import sys
import time

import cv2
import numpy as np

cv2.setNumThreads(1)


def _load_ref04():
    sys.path.insert(0, "/root/reference/image_processor")
    spec = importlib.util.spec_from_file_location(
        "ref04", "/root/reference/image_processor/04_find_contours.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def synth_image(h=1500, w=2000, seed=0):
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    for _ in range(120):
        c = tuple(int(v) for v in rng.integers(0, 256, 3))
        x, y = int(rng.integers(0, w)), int(rng.integers(0, h))
        r = int(rng.integers(10, 150))
        if rng.random() < 0.5:
            cv2.circle(img, (x, y), r, c, -1)
        else:
            cv2.rectangle(img, (x, y), (x + r, y + r), c, -1)
    return img


def main() -> None:
    ref04 = _load_ref04()
    img = synth_image()
    h, w = img.shape[:2]
    mpx = h * w / 1e6
    k = 4
    centers = np.array(
        [[40, 128, 128], [110, 140, 120], [180, 150, 140], [240, 128, 126]], np.float32
    )

    t0 = time.perf_counter()
    # stage-02 work: Lab + all-pixel nearest-center assignment (02:35,52-55)
    lab = cv2.cvtColor(img, cv2.COLOR_BGR2LAB).reshape(-1, 3).astype(np.float32)
    d2 = np.sum((lab[:, None, :] - centers[None, :, :]) ** 2, axis=2)
    labels = np.argmin(d2, axis=1).reshape(h, w)
    rect = cv2.getStructuringElement(cv2.MORPH_RECT, (3, 3))
    ell = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3))
    for idx in range(k):
        mask = (labels == idx).astype(np.uint8) * 255
        mask = cv2.morphologyEx(mask, cv2.MORPH_OPEN, rect)
        mask = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, rect)
        # stage-03 work
        mask = cv2.morphologyEx(mask, cv2.MORPH_OPEN, ell)
        mask = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, ell)
        edges = cv2.Canny(cv2.GaussianBlur(mask, (7, 7), 0), 22, 70)
        # stage-04 thinning (the reference's numpy implementation)
        with contextlib.redirect_stdout(io.StringIO()):
            ref04.thinning_zhangsuen(edges, layer=f"l{idx}")
    dt = time.perf_counter() - t0

    print(f"image: {w}x{h} ({mpx:.2f} Mpx), {k} layers")
    print(f"reference front-end single-core: {dt:.2f}s → {mpx / dt:.4f} Mpx/s")


if __name__ == "__main__":
    main()
