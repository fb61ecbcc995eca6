"""OpenCV-exact drawing and minEnclosingCircle (native/raster.cpp via
utils/draw.py) against cv2: thin, thick and anti-aliased polylines, filled
and outline circles, rectangles, the stage-08 stamp tables, and drawing
into row-slice views."""

from __future__ import annotations

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from plotweave.native.loader import get_lib  # noqa: E402
from plotweave.utils import draw  # noqa: E402


def _need_native():
    assert get_lib() is not None, "native library must build for these tests"


def _canvas(rng, cn):
    h, w = int(rng.integers(5, 90)), int(rng.integers(5, 90))
    shape = (h, w) if cn == 1 else (h, w, cn)
    if rng.random() < 0.5:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return np.full(shape, 255, np.uint8)


def _colour(rng, cn):
    c = tuple(int(v) for v in rng.integers(0, 256, 3))
    return c[:1] if cn == 1 and rng.random() < 0.5 else c


@pytest.mark.parametrize(
    "line_type,thick",
    [(8, False), (8, True), (16, False), (16, True)],
    ids=["line8-thin", "line8-thick", "aa-thin", "aa-thick"],
)
def test_polylines(line_type, thick):
    """Open and closed polylines whose vertices reach well outside the image
    (clipping paths included), gray and BGR canvases."""
    _need_native()
    rng = np.random.default_rng(line_type * 2 + thick)
    for _ in range(500):
        cn = int(rng.choice([1, 3]))
        img = _canvas(rng, cn)
        h, w = img.shape[:2]
        th = int(rng.choice([2, 3, 4, 5, 7, 10, 16])) if thick else 1
        pts = [rng.integers(-40, max(h, w) + 40, (int(rng.integers(1, 6)), 2)).astype(np.int32)
               for _ in range(int(rng.integers(1, 3)))]
        closed = bool(rng.random() < 0.3)
        col = _colour(rng, cn)
        a, b = img.copy(), img.copy()
        cv2.polylines(a, [p.reshape(-1, 1, 2) for p in pts], closed, col, th, line_type)
        draw.polylines(b, pts, closed, col, th, line_type)
        assert np.array_equal(a, b), (pts, closed, th, col)


@pytest.mark.parametrize("line_type", [8, 16], ids=["line8", "aa"])
@pytest.mark.parametrize("thickness", [-1, 1], ids=["filled", "outline"])
def test_circles(line_type, thickness):
    _need_native()
    rng = np.random.default_rng(line_type + thickness)
    for _ in range(500):
        cn = int(rng.choice([1, 3]))
        img = _canvas(rng, cn)
        h, w = img.shape[:2]
        c = rng.integers(-12, max(h, w) + 12, 2)
        r = int(rng.integers(0, 45))
        col = _colour(rng, cn)
        a, b = img.copy(), img.copy()
        cv2.circle(a, (int(c[0]), int(c[1])), r, col, thickness, line_type)
        draw.circle(b, c, r, col, thickness, line_type)
        assert np.array_equal(a, b), (c, r, col)


def test_thick_circle_outlines_are_refused():
    with pytest.raises(ValueError, match="thicker than 1"):
        draw.circle(np.zeros((9, 9), np.uint8), (4, 4), 3, 255, 2)


def test_line_and_rectangle():
    _need_native()
    rng = np.random.default_rng(11)
    for _ in range(400):
        img = _canvas(rng, 3)
        p0, p1 = rng.integers(-20, 100, 2), rng.integers(-20, 100, 2)
        th = int(rng.choice([1, 2, 3, 6]))
        lt = int(rng.choice([8, 16]))
        a, b = img.copy(), img.copy()
        cv2.line(a, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])), (10, 20, 30), th, lt)
        draw.line(b, p0, p1, (10, 20, 30), th, lt)
        assert np.array_equal(a, b)
        a, b = img.copy(), img.copy()
        cv2.rectangle(a, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])), (30, 30, 30), 1)
        draw.rectangle(b, p0, p1, (30, 30, 30), 1)
        assert np.array_equal(a, b)


def test_draws_into_row_slice_views():
    """Stage 08 draws into ROI views of its canvas (cv2 honours the row
    stride; so must the native path)."""
    _need_native()
    a = np.zeros((60, 70), np.uint8)
    b = a.copy()
    pts = np.array([[1, 2], [30, 25], [5, 40]], np.int32)
    cv2.polylines(a[10:50, 5:60], [pts.reshape(-1, 1, 2)], False, 255, 6, 8)
    draw.polylines(b[10:50, 5:60], [pts], False, 255, 6)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("thickness,R", [(6, 4), (16, 6)])
def test_stamp_table_matches_cv2_lines(thickness, R):
    """The stage-08 stamp spans (native/api.py LineStampTable) reproduce
    cv2.line for every delta they cover."""
    _need_native()
    from plotweave.native.api import LineStampTable

    t = LineStampTable(thickness, R)
    side = 2 * R + 1
    m = R + thickness + 4
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            ref = np.zeros((2 * m + 1, 2 * m + 1), np.uint8)
            cv2.line(ref, (m, m), (m + dx, m + dy), 255, thickness, cv2.LINE_8)
            got = np.zeros_like(ref)
            key = (dy + R) * side + (dx + R)
            s, n = int(t.span_start[key]), int(t.span_count[key])
            for row, x0, x1 in zip(t.span_row[s:s + n], t.span_x0[s:s + n], t.span_x1[s:s + n]):
                got[m + row, m + x0:m + x1 + 1] = 255
            assert np.array_equal(got, ref), (dx, dy)


def _tap_contour(rng, n):
    """A closed integer outline of n vertices around a small blob, as the
    stage-08/10 tap candidates are: a few pixels across, anywhere on the
    8400 x 11880 canvas, with repeated and collinear vertices."""
    t = np.sort(rng.random(n)) * 2 * np.pi
    r = rng.uniform(1.0, 12.0) * (1.0 + 0.3 * rng.standard_normal(n))
    xy = np.stack([np.cos(t), np.sin(t)], 1) * r[:, None] + rng.integers(0, [8400, 11880])
    return np.rint(xy).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 10, 11, 12, 17, 25, 50, 1100])
def test_min_enclosing_circle_exact(n):
    """Bit-identical centre and radius: float inputs, integer-valued point
    clouds and tap-like outlines.  Above ten points cv2 shuffles its copy
    first, so these sizes pin the shuffle too; 1100 points take cv2's heap
    buffer."""
    _need_native()
    rng = np.random.default_rng(n)
    for it in range(2000 if n < 1000 else 100):
        kind = it % 3
        if kind == 0:
            pts = (rng.random((n, 2)) * 1000).astype(np.float32)
        elif kind == 1:
            pts = (rng.integers(0, 25, (n, 2)) + rng.integers(0, 8000, 2)).astype(np.float32)
        else:
            pts = _tap_contour(rng, n)
        (cx, cy), r = cv2.minEnclosingCircle(pts.reshape(-1, 1, 2))
        assert draw.min_enclosing_circle(pts) == ((cx, cy), r), pts


def test_tap_stages_match_cv2_on_many_vertex_taps(tmp_path, monkeypatch):
    """Stages 08 and 10 end to end on layers whose tap candidates have 11 to
    50 vertices (up to the default tap_max_vertices): every pickle they
    write is byte-identical to the one written with cv2.minEnclosingCircle
    in place of the port."""
    _need_native()
    from plotweave.config import PipelineConfig
    from plotweave.stages import s08_dedup_intra, s10_dedup_cross
    from plotweave.stages.common import layer_dir
    from plotweave.utils import save_pickle

    names = ["layer_a", "layer_b"]
    W, H = 1600, 2000

    def blob(rng, r_lo, r_hi):
        n = int(rng.integers(11, 51))
        t = np.sort(rng.random(n)) * 2 * np.pi
        r = rng.uniform(r_lo, r_hi) * (1.0 + 0.15 * rng.standard_normal(n))
        xy = np.stack([np.cos(t), np.sin(t)], 1) * r[:, None] + rng.integers(40, [W - 40, H - 40])
        return np.rint(xy).astype(np.int32).reshape(-1, 1, 2)

    def run(tag):
        cfg = PipelineConfig(output_dir=str(tmp_path / tag), color_names=names,
                             target_width_px=W, target_height_px=H)
        rng = np.random.default_rng(5)
        for name in names:
            polys = [blob(rng, 2, 9) for _ in range(700)]      # stage-08 taps (bbox <= 25)
            polys += [blob(rng, 14, 22) for _ in range(300)]   # kept by 08, taps in stage 10
            order = rng.permutation(len(polys))
            save_pickle([polys[i] for i in order], layer_dir(cfg, name) + "/contours_sorted.pkl")
        s08_dedup_intra.run(cfg)
        s10_dedup_cross.run(cfg)
        return {(name, f): (tmp_path / tag / name / f).read_bytes() for name in names
                for f in ("lines_intra.pkl", "taps_intra.pkl", "lines_cross.pkl", "taps_cross.pkl")}

    calls = []
    port = draw.min_enclosing_circle

    def counted(points):
        calls.append(len(np.asarray(points).reshape(-1, 2)))
        return port(points)

    monkeypatch.setattr(draw, "min_enclosing_circle", counted)
    ours = run("port")
    assert sum(n >= 11 for n in calls) >= 1500, "the stages must reach 11+ vertex taps"

    def opencv(points):
        (cx, cy), r = cv2.minEnclosingCircle(np.asarray(points, np.float32).reshape(-1, 1, 2))
        return (cx, cy), r

    monkeypatch.setattr(draw, "min_enclosing_circle", opencv)
    theirs = run("cv2")
    for key in ours:
        assert ours[key] == theirs[key], key
