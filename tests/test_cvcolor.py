"""Host ports of the reference's OpenCV colour, morphology and labelling
calls, pinned to cv2: Lab both ways over all 2^24 inputs, stage 02's 3×3
mask refine, and the labeller's component numbering."""

from __future__ import annotations

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from plotweave.stages.s02_color_extract import _host_clean_masks  # noqa: E402
from plotweave.utils.cvcolor import bgr2lab_u8, lab2bgr_u8  # noqa: E402
from plotweave.vector.trace import connected_components  # noqa: E402


def _all_colours() -> np.ndarray:
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)


@pytest.mark.parametrize("code", ["BGR2LAB", "LAB2BGR"])
def test_lab_exhaustive(code):
    img = _all_colours()
    fn = bgr2lab_u8 if code == "BGR2LAB" else lab2bgr_u8
    want = cv2.cvtColor(img, getattr(cv2, f"COLOR_{code}"))
    for r in range(0, 4096, 1024):  # chunks bound the int64 temporaries
        got = fn(img[r:r + 1024])
        bad = (got != want[r:r + 1024]).any(-1)
        assert not bad.any(), (code, img[r:r + 1024][bad][:4], got[bad][:4], want[r:r + 1024][bad][:4])


@pytest.mark.parametrize("seed", range(6))
def test_mask_refine_matches_cv2_morphology(seed):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(1, 60)), int(rng.integers(1, 60))
    k = int(rng.integers(2, 5))
    labels = rng.integers(0, k, (h, w))
    oi, ci = int(rng.integers(0, 3)), int(rng.integers(0, 3))
    kernel = cv2.getStructuringElement(cv2.MORPH_RECT, (3, 3))
    got = _host_clean_masks(labels, k, oi, ci)
    for kk in range(k):
        m = (labels == kk).astype(np.uint8) * 255
        if oi:
            m = cv2.morphologyEx(m, cv2.MORPH_OPEN, kernel, iterations=oi)
        if ci:
            m = cv2.morphologyEx(m, cv2.MORPH_CLOSE, kernel, iterations=ci)
        assert np.array_equal(got[kk], m), (kk, oi, ci)


@pytest.mark.parametrize(
    "shape,density",
    [((1, 1), 0.5), ((7, 1), 0.5), ((1, 9), 0.5), ((33, 47), 0.1), ((33, 47), 0.45),
     ((64, 64), 0.6), ((1125, 2000), 0.3), ((1001, 777), 0.05)],
)
def test_labeller_numbers_like_cv2(shape, density):
    """cv2 numbers components by their first 2×2 block, not by first pixel;
    odd sizes and the large (multi-threaded in cv2) planes included."""
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    m = (rng.random(shape) < density).astype(np.uint8)
    n_cv, lab_cv = cv2.connectedComponents(m, connectivity=8)
    n, lab = connected_components(m)
    assert n == n_cv
    assert lab.dtype == np.int32
    assert np.array_equal(lab, lab_cv)


def test_labeller_block_order_differs_from_raster_order():
    # pixel (0,1) starts a component before (1,0) in raster order, but both
    # sit in block (0,0); the component touching (1,0) first by block scan
    # is the one cv2 numbers 1 — a plain raster labeller gets this wrong
    m = np.zeros((2, 4), np.uint8)
    m[0, 3] = 1  # block (0,1)
    m[1, 0] = 1  # block (0,0): numbered first by cv2
    assert np.array_equal(connected_components(m)[1], cv2.connectedComponents(m, connectivity=8)[1])
    assert connected_components(m)[1][1, 0] == 1
