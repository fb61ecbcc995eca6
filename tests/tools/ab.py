#!/usr/bin/env python3
"""Interleaved A/B capture harness — the BASELINE.md measurement convention.

Best-of numbers captured at different times are not comparable (host load,
card clocks and power limits drift), so every comparative claim runs k
ALTERNATING A/B pairs in one process and quotes the per-side MEDIAN +
spread.

Usage (from any bench tool):

    from ab import ab_capture
    res = ab_capture(run_batch, run_seq, k=3, label_a="batch", label_b="seq")
    # res = {"a": {...median/min/max/times...}, "b": {...},
    #        "winner": "a"|"b"|"tie"}

Each run_* callable executes one full measurement and returns a float whose
LARGER-IS-BETTER interpretation is up to the caller (pass throughput, or
negate wall seconds via ``lower_is_better=True``).
"""

from __future__ import annotations

import json
import statistics
from typing import Callable


def _side(times: list) -> dict:
    return {
        "times": [round(t, 4) for t in times],
        "median": round(statistics.median(times), 4),
        "min": round(min(times), 4),
        "max": round(max(times), 4),
        "spread_pct": round(
            100.0 * (max(times) - min(times)) / max(1e-12, statistics.median(times)), 1
        ),
    }


def ab_capture(
    run_a: Callable[[], float],
    run_b: Callable[[], float],
    k: int = 3,
    label_a: str = "A",
    label_b: str = "B",
    lower_is_better: bool = False,
    verbose: bool = True,
) -> dict:
    """Run A and B alternately (A,B,A,B,…) k times per side in the SAME
    phase; return medians, spreads and the winner by median."""
    ta: list = []
    tb: list = []
    for i in range(k):
        for label, fn, acc in ((label_a, run_a, ta), (label_b, run_b, tb)):
            v = float(fn())
            acc.append(v)
            if verbose:
                print(f"[ab] pair {i + 1}/{k} {label}: {v:.4f}", flush=True)
    a, b = _side(ta), _side(tb)
    ma, mb = a["median"], b["median"]
    if lower_is_better:
        winner = label_a if ma < mb else (label_b if mb < ma else "tie")
    else:
        winner = label_a if ma > mb else (label_b if mb > ma else "tie")
    res = {
        "protocol": f"interleaved A/B, k={k}, median-of-{k} per side, same phase",
        label_a: a,
        label_b: b,
        "winner": winner,
    }
    if verbose:
        print("[ab] " + json.dumps(res), flush=True)
    return res
