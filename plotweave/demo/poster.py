"""Seeded synthetic posters (numpy only): flat-colour discs, rectangles and
thin strokes over a light background — the shape of input the pipeline's
k-means layering is built for.  Used by bench.py, chip_smoke.py and tests."""

from __future__ import annotations

import numpy as np

# eight well-separated BGR inks; index 0 doubles as the background
PALETTE = np.array(
    [
        [235, 230, 225], [20, 20, 20], [60, 40, 100], [40, 60, 200],
        [60, 170, 60], [190, 120, 50], [140, 180, 220], [90, 210, 230],
    ],
    np.uint8,
)


def synth_poster(h: int, w: int, n_colors: int = 8, seed: int = 0,
                 n_shapes: int = 160, n_strokes: int = 60) -> np.ndarray:
    """(h, w, 3) uint8 BGR poster using the first ``n_colors`` inks."""
    if not 2 <= n_colors <= len(PALETTE):
        raise ValueError(f"n_colors must be in 2..{len(PALETTE)}")
    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 3), np.uint8)
    img[:] = PALETTE[0]
    scale = min(h, w)
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    for _ in range(n_shapes):
        ink = PALETTE[int(rng.integers(1, n_colors))]
        cx, cy = int(rng.integers(0, w)), int(rng.integers(0, h))
        r = int(rng.integers(scale // 80 + 2, scale // 8 + 3))
        y0, y1 = max(0, cy - r), min(h, cy + r + 1)
        x0, x1 = max(0, cx - r), min(w, cx + r + 1)
        if rng.random() < 0.5:
            disc = (yy[y0:y1] - cy) ** 2 + (xx[:, x0:x1] - cx) ** 2 <= r * r
            img[y0:y1, x0:x1][disc] = ink
        else:
            img[y0:y1, x0:x1] = ink
    for _ in range(n_strokes):
        ink = PALETTE[int(rng.integers(1, n_colors))]
        p0 = rng.integers(0, [w, h])
        p1 = rng.integers(0, [w, h])
        half = int(rng.integers(1, max(2, scale // 400) + 2))
        n = int(np.abs(p1 - p0).max()) * 2 + 2
        t = np.linspace(0.0, 1.0, n)
        px = np.rint(p0[0] + (p1[0] - p0[0]) * t).astype(np.int64)
        py = np.rint(p0[1] + (p1[1] - p0[1]) * t).astype(np.int64)
        for dy in range(-half, half + 1):
            for dx in range(-half, half + 1):
                img[np.clip(py + dy, 0, h - 1), np.clip(px + dx, 0, w - 1)] = ink
    return img
