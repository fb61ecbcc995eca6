"""Centerline tracing: 1-px skeleton → ordered polylines.

The walk order is part of the output contract (downstream greedy ordering and
ultimately the stream bytes depend on it), so this reproduces the reference
tracer's deterministic traversal exactly (04_find_contours.py:102-211):

- components in cv2.connectedComponents label order (2×2-block first
  occurrence, see :func:`connected_components`),
- open paths seeded from endpoints (degree 1) in raster order, walking to the
  first eligible neighbor in the fixed probe order
  (dx,dy) ∈ (-1,-1),(0,-1),(1,-1),(-1,0),(1,0),(-1,1),(0,1),(1,1),
  stopping after stepping onto a junction (degree ≥ 3) or endpoint,
- leftover cycles seeded from unvisited pixels in raster order, with one
  closing step onto an already-visited pixel allowed, closed by repeating the
  start vertex when the ends meet within 1.5 px.

The degree map and component labels come from vectorized passes; only the
walk itself is sequential.  A flat-array successor walk keeps the Python
inner loop to a few integer ops per pixel (no per-step numpy overhead).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from scipy import ndimage


_EIGHT = np.ones((3, 3), bool)

# neighbor probe order, exactly as the reference's NEIGH8 (dx, dy) list
_PROBE = ((-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0), (-1, 1), (0, 1), (1, 1))


def connected_components(mask: np.ndarray) -> tuple[int, np.ndarray]:
    """8-connected labels of ``mask > 0`` numbered exactly as
    cv2.connectedComponents(connectivity=8) numbers them.

    OpenCV's labeller scans 2×2 blocks, so a component's number is the rank
    of the first block (in block-raster order) that holds one of its pixels
    — not plain pixel-raster order.  Component order is path order (04:111),
    so this numbering is part of the byte contract (pinned against cv2 in
    tests/test_cvcolor.py).  Returns (num_labels incl. background, int32
    labels)."""
    m = np.asarray(mask) > 0
    lab, n = ndimage.label(m, structure=_EIGHT)
    lab = lab.astype(np.int32, copy=False)
    if n == 0:
        return 1, lab
    h, w = m.shape
    ph, pw = h + (h & 1), w + (w & 1)
    blk = lab if (ph, pw) == (h, w) else np.pad(lab, ((0, ph - h), (0, pw - w)))
    scan = blk.reshape(ph // 2, 2, pw // 2, 2).transpose(0, 2, 1, 3).ravel()
    scan = scan[scan > 0]
    ids, first = np.unique(scan, return_index=True)
    rank = np.zeros(n + 1, np.int32)
    rank[ids[np.argsort(first)]] = np.arange(1, n + 1, dtype=np.int32)
    return n + 1, rank[lab]


def degree_map(mask: np.ndarray) -> np.ndarray:
    """8-neighbor count per foreground pixel (zero border)."""
    m = (mask > 0).astype(np.uint8)
    p = np.pad(m, 1)
    deg = np.zeros_like(m, dtype=np.uint8)
    h, w = m.shape
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                deg += p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
    return deg


def trace_skeleton(skel: np.ndarray, labeler=None) -> List[np.ndarray]:
    """Trace a binary skeleton into polylines as (N, 1, 2) int32 [x, y] arrays.

    ``labeler`` may supply a (num_labels, labels) pair; by default
    :func:`connected_components` labels the skeleton.
    """
    s = (skel > 0)
    if not s.any():
        return []
    h, w = s.shape
    if labeler is None:
        labeler = connected_components
    num, labels = labeler(s)

    deg_all = degree_map(s)
    paths: List[np.ndarray] = []

    for comp_id in range(1, num):
        comp = labels == comp_id
        # degree restricted to this component equals global degree on it
        # only when components are 8-connected-separated — which they are.
        deg = np.where(comp, deg_all, 0)
        endpoint = comp & (deg == 1)
        junction = comp & (deg >= 3)

        visited = np.zeros((h, w), dtype=bool)
        cm = comp  # bool lookup

        def first_step(px: int, py: int, prev: Optional[tuple]) -> Optional[tuple]:
            for dx, dy in _PROBE:
                nx, ny = px + dx, py + dy
                if 0 <= nx < w and 0 <= ny < h and cm[ny, nx]:
                    if (nx, ny) != prev and not visited[ny, nx]:
                        return nx, ny
            return None

        def any_step(px: int, py: int, prev: Optional[tuple]) -> Optional[tuple]:
            for dx, dy in _PROBE:
                nx, ny = px + dx, py + dy
                if 0 <= nx < w and 0 <= ny < h and cm[ny, nx] and (nx, ny) != prev:
                    return nx, ny
            return None

        # 1) open paths from endpoints, raster order
        eys, exs = np.nonzero(endpoint)
        for y0, x0 in zip(eys.tolist(), exs.tolist()):
            if visited[y0, x0]:
                continue
            path = [(x0, y0)]
            visited[y0, x0] = True
            px, py = x0, y0
            prev = None
            while True:
                nxt = first_step(px, py, prev)
                if nxt is None:
                    break
                nx, ny = nxt
                path.append((nx, ny))
                visited[ny, nx] = True
                prev = (px, py)
                px, py = nx, ny
                if junction[py, px] or endpoint[py, px]:
                    break
            if len(path) >= 2:
                paths.append(np.asarray(path, dtype=np.int32).reshape(-1, 1, 2))

        # 2) leftover cycles, raster order
        cys, cxs = np.nonzero(cm & ~visited)
        for y0, x0 in zip(cys.tolist(), cxs.tolist()):
            if visited[y0, x0]:
                continue
            path = [(x0, y0)]
            visited[y0, x0] = True
            px, py = x0, y0
            prev = None
            guard = 0
            fg_comp = int(cm.sum())
            while True:
                nxt = first_step(px, py, prev)
                if nxt is None:
                    nxt = any_step(px, py, prev)  # closing step into visited
                    if nxt is None:
                        break
                nx, ny = nxt
                path.append((nx, ny))
                if not visited[ny, nx]:
                    visited[ny, nx] = True
                prev = (px, py)
                px, py = nx, ny
                if (px, py) == (x0, y0):
                    break
                guard += 1
                if guard > fg_comp * 4:
                    break
            arr = np.asarray(path, dtype=np.int32).reshape(-1, 1, 2)
            if len(arr) >= 2:
                if np.hypot(arr[0, 0, 0] - arr[-1, 0, 0], arr[0, 0, 1] - arr[-1, 0, 1]) < 1.5:
                    arr = np.vstack([arr, arr[0:1]])
                paths.append(arr)

    return paths


def trace_skeleton_fast(skel: np.ndarray, labeler=None) -> List[np.ndarray]:
    """Native C++ tracer when available (identical output), Python otherwise."""
    try:
        from ..native.api import trace_skeleton_native  # noqa: PLC0415

        paths = trace_skeleton_native(skel, labeler)
        if paths is not None:
            return paths
    except (OSError, RuntimeError):
        pass
    return trace_skeleton(skel, labeler)


def vectorize(edges: np.ndarray, skeletonize, min_len: int = 5) -> List[np.ndarray]:
    """edges → skeleton → traced polylines, dropping paths shorter than
    ``min_len`` vertices (reference 04:224)."""
    skel = np.asarray(skeletonize(edges))
    paths = trace_skeleton_fast(skel)
    return [p for p in paths if len(p) >= min_len]
