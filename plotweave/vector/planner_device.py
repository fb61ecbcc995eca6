"""Device greedy planner: stage 07's nearest-endpoint tour on the device.

The host C++ selection loop (native pw_greedy_order) is O(n²) sequential;
on the device the per-step candidate scan vectorizes over all n, which pays
for large plans (the gate, config.planner_device_min_n, picks the size).

Selection semantics replicate 07_sort_contours.py:50-87 bit-for-bit:
float32 squared distances, jnp.argmin's first-minimum == the ascending
strict-< scan, closed contours always join at their start, open contours
prefer start when d²(start) ≤ d²(end).

Exactness: the host computes ``dx*dx + dy*dy`` in float32 with each product
rounded before the add.  A GPU compiler fuses that into one FMA (one
rounding), which flips near-ties once squares pass float32's 2²⁴ integer
range.  Endpoints are integer pixel coordinates, so the device squares them
in int32 — exact — and converts each square to float32 (the same rounding as
a float32 product) before the float32 add: nothing is left to contract, and
the distances equal the host's on every backend.  Plans whose endpoints are
not small integers stay on the host.

Shapes are padded to a bucket (one compile per bucket + closed_aware) with
a DYNAMIC trip count, so padded iterations never run.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Optional, Tuple

import numpy as np

# The 4096 bucket is unreachable under the DEFAULT gate (config.py
# planner_device_min_n=4500 → the smallest eligible plan pads to 8192); it
# exists only for user-lowered gates (planner_device_min_n ≤ 4096).
BUCKETS = (4096, 8192, 16384, 32768, 65536)
# |coordinate| bound that keeps int32 dx² + dy² from overflowing
COORD_LIMIT = 16384


@lru_cache(maxsize=1)
def _jitted():
    import jax

    return partial(jax.jit, static_argnames=("closed_aware",))(_greedy_device_impl)


def _greedy_device_impl(s, e, closed, seed, n_valid, closed_aware: bool):
    import jax
    import jax.numpy as jnp

    n = s.shape[0]
    closed_f = closed if closed_aware else jnp.zeros_like(closed)

    def d2(p, q):
        # exact int32 squares, each rounded to float32, then one float32 add
        # (module note: the host's product-then-add rounding, no FMA)
        sq = ((p - q) * (p - q)).astype(jnp.float32)
        return sq[:, 0] + sq[:, 1]

    def body(i, st):
        used, cur_end, order, flips = st
        d2s = d2(s, cur_end)
        d2e = d2(e, cur_end)
        prefer_start = closed_f | (d2s <= d2e)
        cand = jnp.where(prefer_start, d2s, d2e)
        cand = jnp.where(used, jnp.inf, cand)
        best = jnp.argmin(cand)  # first min wins == ascending strict-<
        flip = ~prefer_start[best]
        new_end = jnp.where(closed_f[best], s[best], jnp.where(flip, s[best], e[best]))
        return (
            used.at[best].set(True),
            new_end,
            order.at[i].set(best.astype(jnp.int32)),
            flips.at[i].set(flip),
        )

    # padding rows (index ≥ n_valid) start used=True and are never selected;
    # the dynamic trip count stops at the real plan size
    used0 = (jnp.arange(n) >= n_valid).at[seed].set(True)
    cur0 = jnp.where(closed_f[seed], s[seed], e[seed])
    order0 = jnp.zeros(n, jnp.int32).at[0].set(seed.astype(jnp.int32))
    flips0 = jnp.zeros(n, bool)
    _, _, order, flips = jax.lax.fori_loop(1, n_valid, body, (used0, cur0, order0, flips0))
    return order, flips


def greedy_order_device(
    starts: np.ndarray,
    ends: np.ndarray,
    closed,
    closed_aware: bool,
    seed: int,
) -> Optional[Tuple[List[int], List[bool]]]:
    """(order, flips) via the device planner; None when the plan exceeds the
    largest bucket or its endpoints are not integers within ±COORD_LIMIT
    (callers keep the host path).  Device errors propagate."""
    import jax.numpy as jnp

    n = len(starts)
    bucket = next((b for b in BUCKETS if b >= n), None)
    if bucket is None or n < 2:
        return None
    pts = np.concatenate([np.asarray(starts, np.float32).reshape(-1, 2),
                          np.asarray(ends, np.float32).reshape(-1, 2)])
    if not (np.all(pts == np.rint(pts)) and np.all(np.abs(pts) < COORD_LIMIT)):
        return None
    s = np.zeros((bucket, 2), np.int32)
    e = np.zeros((bucket, 2), np.int32)
    cl = np.zeros(bucket, bool)
    s[:n] = pts[:n]
    e[:n] = pts[n:]
    cl[:n] = np.asarray(closed, bool)
    order, flips = _jitted()(
        jnp.asarray(s), jnp.asarray(e), jnp.asarray(cl),
        jnp.asarray(seed), jnp.asarray(n), closed_aware,
    )
    order = np.asarray(order)[:n]
    flips = np.asarray(flips)[:n]
    return [int(i) for i in order], [bool(f) for f in flips]


def device_planner_eligible() -> bool:
    """Auto-engage only on an accelerator: on the CPU backend the host C++
    loop is the faster path (the result is identical either way)."""
    import jax

    return jax.default_backend() != "cpu"
