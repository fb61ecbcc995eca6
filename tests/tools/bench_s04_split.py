#!/usr/bin/env python3
"""Split stage 04's cfg3 wall time into its host parts.

Stage 04 on the 4K poster = per layer: cv2.connectedComponents labeling +
native centerline walk (pw_trace) + min-length filter + pickle save, after
the (device-side, fused-chain) thinning.  This tool reproduces that host leg
on the poster's real skeletons and times each part separately, so future
rounds know whether the next win is in labeling, walking, or I/O.

Usage: python tests/tools/bench_s04_split.py [--runs 3]
(CPU-only; builds the poster, runs stages 01-03 on the CPU backend first.)
"""

from __future__ import annotations

import argparse
import pickle
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests" / "tools"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()

    import json

    import cv2

    import plotweave  # noqa: F401
    from bench_cfg3 import NAMES8, build_poster_4k, make_cfg
    from plotweave.config import load_config
    from plotweave.ops.thinning import zhang_suen
    from plotweave.pipeline import run_pipeline
    from plotweave.vector.trace import trace_skeleton_fast

    tmp = Path(tempfile.mkdtemp(prefix="pw_s04_"))
    img = tmp / "poster.png"
    build_poster_4k(img)
    out = tmp / "out"
    out.mkdir()
    raw = make_cfg(img, out)
    (out / "config.json").write_text(json.dumps(raw))
    cfg = load_config(str(out / "config.json"))
    run_pipeline(cfg, start_step=1, end_step=3)

    # thin on the CPU backend once (the pipeline's device leg), keep skeletons
    import jax.numpy as jnp

    edges = np.stack(
        [cv2.imread(str(out / n / "edges.png"), 0) for n in NAMES8], axis=0
    )
    t0 = time.perf_counter()
    skels = np.asarray(zhang_suen(jnp.asarray(edges), max_iter=120, rotated=True))
    print(f"thinning (CPU backend, batched): {time.perf_counter() - t0:.2f}s")

    for run in range(args.runs):
        t_label = t_trace = t_pickle = 0.0
        n_paths = 0
        for li, name in enumerate(NAMES8):
            skel = skels[li].astype(np.uint8)
            t0 = time.perf_counter()
            num, labels = cv2.connectedComponents(skel, connectivity=8)
            t_label += time.perf_counter() - t0

            t0 = time.perf_counter()
            paths = trace_skeleton_fast(skel, labeler=lambda _m: (num, labels))
            t_trace += time.perf_counter() - t0

            paths = [p for p in paths if len(p) >= 5]
            n_paths += len(paths)
            t0 = time.perf_counter()
            blob = pickle.dumps(paths, protocol=5)
            t_pickle += time.perf_counter() - t0
        print(
            f"run {run}: label {t_label * 1e3:7.1f} ms   trace {t_trace * 1e3:7.1f} ms   "
            f"pickle {t_pickle * 1e3:6.1f} ms   ({n_paths} paths, {len(blob)} B last layer)"
        )


if __name__ == "__main__":
    main()
