"""Device tour refinement: stage 12's optional 2-opt ⊕ relocation on the device.

The host refiner (vector/planner.py:140-238) scans O(n²) candidate moves in
Python per pass — fine for the post-dedup op counts of typical runs (tens),
unusable at poster/SVG scale (n in the thousands).  On-device, one iteration
evaluates EVERY candidate move at once as masked n×n distance matrices
(elementwise math), applies the single best move with index
arithmetic, and loops under ``lax.while_loop`` until no move improves:

- **2-opt(i, j)**: reverse ops [i..j] (each op flips orientation).  Only the
  two boundary travel edges change, so
  ``delta = d(P[i], X[j]) + d(E[i], N[j]) - d(P[i], E[i]) - d(X[j], N[j])``
  with P[i] = previous exit (pen start for i=0) and N[j] = next entry
  (absent for the last op).
- **relocate(i → k, rev)**: move op i (optionally reversed) to sit before
  op k.  ``delta = insertion(k, rev) - removal_gain(i)``, three edges change.

Both move families preserve the pen-down geometry exactly — only order and
orientation change, the same contract as the host refiner.  Unlike
stage 07's device planner there is NO bit-parity requirement (refinement is
a plotweave extension, off by default; reference byte-equality holds only
with ``plotopt_two_opt: false``) — the wrapper re-checks the tour length in
float64 on host and keeps the original ops if the device pass somehow did
not improve.

Shapes are padded to a bucket (one compile per bucket);
padded rows are masked out of every move, so results depend only on the real
ops.  Reference context: the reference has no refinement pass at all — its
stage 12 emits the greedy order directly (12_optimize_plot_order.py:85-187).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

BUCKETS = (256, 512, 1024, 2048, 4096, 8192)

# a move must shorten pen-up travel by at least this many pixels to be
# applied — also the float32 noise floor for the matrix evaluation
MIN_GAIN = 1e-2


@lru_cache(maxsize=1)
def _jitted():
    import jax

    # max_moves is traced (not static): one compile per bucket serves any
    # move budget, and the budget only feeds the while_loop condition
    return jax.jit(_refine_impl)


def _refine_impl(E, X, n_valid, start, max_moves):
    """(perm, flip, n_moves): refined visit order of the padded node arrays.

    E/X: (n, 2) float32 entry/exit points in CURRENT tour order.  The loop
    keeps E/X permuted in-place (so each iteration's matrices read the
    current tour) and drags ``perm``/``flip`` along to report the final
    order over the caller's original indices.
    """
    import jax
    import jax.numpy as jnp

    n = E.shape[0]
    idx = jnp.arange(n)
    real = idx < n_valid  # padded rows never move and carry no edges
    BIG = jnp.float32(1e30)

    def dist(a, b):
        d = a - b
        return jnp.sqrt(jnp.sum(d * d, axis=-1))

    def body(st):
        E, X, perm, flip, moves, _go = st

        P = jnp.concatenate([start[None], X[:-1]])     # P[i]: exit before op i
        N = jnp.concatenate([E[1:], E[-1:]])           # N[j]: entry after op j
        has_next = idx < n_valid - 1                   # last real op has no next edge
        a_edge = dist(P, E)                            # current edge into op i
        b_edge = jnp.where(has_next, dist(X, N), 0.0)  # current edge out of op j

        # ---- 2-opt: reverse [i..j], i <= j (i == j = flip one op in place)
        d_px = dist(P[:, None, :], X[None, :, :])      # d(P[i], X[j])
        d_en = dist(E[:, None, :], N[None, :, :])      # d(E[i], N[j])
        delta2 = (d_px + jnp.where(has_next[None, :], d_en, 0.0)
                  - a_edge[:, None] - b_edge[None, :])
        ok2 = (idx[:, None] <= idx[None, :]) & real[:, None] & real[None, :]
        delta2 = jnp.where(ok2, delta2, BIG)

        # ---- relocate: move op i before op k (k in 0..n_valid, k != i, i+1)
        # removal closes (P[i] → N[i]); last-op removal just drops its edge
        gain_rm = a_edge + b_edge - jnp.where(has_next, dist(P, N), 0.0)
        # insertion before k opens (X[k-1] → E[k]): B[k] = exit feeding slot k
        B = jnp.concatenate([start[None], X])          # (n+1, 2)
        A = jnp.concatenate([E, E[-1:]])               # (n+1, 2); A[n] unused
        slot = jnp.arange(n + 1)
        slot_real = slot <= n_valid - 1                # slots 0..n_valid-1 sit before a real op
        end_slot = slot == n_valid                     # append after the last op
        base = jnp.where(slot_real, dist(B, A), 0.0)   # edge the insertion splits
        # (n, n+1) matrices: rows = op i, cols = slot k
        d_bh = dist(E[:, None, :], B[None, :, :])      # d(E[i], B[k])  (forward head)
        d_xh = dist(X[:, None, :], B[None, :, :])      # d(X[i], B[k])  (reversed head)
        d_ta = dist(X[:, None, :], A[None, :, :])      # d(X[i], A[k])  (forward tail)
        d_ea = dist(E[:, None, :], A[None, :, :])      # d(E[i], A[k])  (reversed tail)
        tail_ok = slot_real[None, :]
        ins_f = d_bh + jnp.where(tail_ok, d_ta, 0.0) - base[None, :]
        ins_r = d_xh + jnp.where(tail_ok, d_ea, 0.0) - base[None, :]
        okr = (real[:, None] & (slot_real | end_slot)[None, :]
               & (slot[None, :] != idx[:, None]) & (slot[None, :] != idx[:, None] + 1))
        deltaR_f = jnp.where(okr, ins_f - gain_rm[:, None], BIG)
        deltaR_r = jnp.where(okr, ins_r - gain_rm[:, None], BIG)

        # ---- pick the single best move across the three families
        c2 = jnp.argmin(delta2)
        cf = jnp.argmin(deltaR_f)
        cr = jnp.argmin(deltaR_r)
        v2 = delta2.reshape(-1)[c2]
        vf = deltaR_f.reshape(-1)[cf]
        vr = deltaR_r.reshape(-1)[cr]
        fam = jnp.argmin(jnp.stack([v2, vf, vr]))
        best = jnp.minimum(v2, jnp.minimum(vf, vr))

        def apply_2opt(args):
            E, X, perm, flip = args
            i, j = c2 // n, c2 % n
            # positions i..j reverse and each op flips: new[t] = old[i+j-t]
            src = jnp.where((idx >= i) & (idx <= j), i + j - idx, idx)
            inseg = (idx >= i) & (idx <= j)
            nE = jnp.where(inseg[:, None], X[src], E[src])
            nX = jnp.where(inseg[:, None], E[src], X[src])
            return nE, nX, perm[src], flip[src] ^ inseg

        def apply_reloc(args):
            E, X, perm, flip = args
            c, rev = jax.lax.cond(fam == 1, lambda: (cf, False), lambda: (cr, True))
            i, k = c // (n + 1), c % (n + 1)
            # remove position i, insert before original slot k (k != i, i+1)
            # final position of the moved op: k if k < i else k-1
            dest = jnp.where(k < i, k, k - 1)
            # src for each position t != dest: walk the remaining ops in order
            shifted_up = (idx > dest) & (idx <= i)        # k < i: block shifts right
            shifted_dn = (idx >= i) & (idx < dest)        # k > i+1: block shifts left
            src = jnp.where(shifted_up, idx - 1, jnp.where(shifted_dn, idx + 1, idx))
            src = jnp.where(idx == dest, i, src)
            nE = jnp.take(E, src, axis=0)
            nX = jnp.take(X, src, axis=0)
            swap = (idx == dest) & rev
            return (jnp.where(swap[:, None], nX, nE),
                    jnp.where(swap[:, None], nE, nX),
                    perm[src], flip[src] ^ swap)

        E2, X2, p2, f2 = jax.lax.cond(
            fam == 0, apply_2opt, apply_reloc, (E, X, perm, flip)
        )
        improved = best < -MIN_GAIN
        keep = lambda new, old: jnp.where(improved, new, old)  # noqa: E731
        return (keep(E2, E), keep(X2, X), keep(p2, perm), keep(f2, flip),
                moves + improved.astype(jnp.int32), improved)

    def cond(st):
        return st[5] & (st[4] < max_moves)

    perm0 = idx.astype(jnp.int32)
    flip0 = jnp.zeros(n, bool)
    st = (E, X, perm0, flip0, jnp.int32(0), jnp.bool_(True))
    _, _, perm, flip, moves, _ = jax.lax.while_loop(cond, body, st)
    return perm, flip, moves


def refine_order_device(
    entries: np.ndarray,
    exits: np.ndarray,
    start: Tuple[float, float] = (0.0, 0.0),
    max_moves: int = 4096,
) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """(perm, flip, n_moves) refining the tour over nodes with the given
    entry/exit points; None when the plan exceeds the largest bucket (callers
    keep the host path).  Device errors propagate."""
    import jax.numpy as jnp

    n = len(entries)
    bucket = next((b for b in BUCKETS if b >= n), None)
    if bucket is None or n < 3:
        return None
    E = np.zeros((bucket, 2), np.float32)
    X = np.zeros((bucket, 2), np.float32)
    E[:n] = np.asarray(entries, np.float32)
    X[:n] = np.asarray(exits, np.float32)
    perm, flip, moves = _jitted()(
        jnp.asarray(E), jnp.asarray(X), jnp.asarray(n),
        jnp.asarray(np.asarray(start, np.float32)), jnp.asarray(int(max_moves)),
    )
    return np.asarray(perm)[:n], np.asarray(flip)[:n], int(moves)


def refine_ops_device(ops: List[dict], max_moves: int = 4096) -> Optional[List[dict]]:
    """Device-refined reordering of a stage-12 op list (see planner.refine_tour).

    Returns None when ineligible (callers fall back to the host refiner).
    Geometry is preserved exactly: the result is a permutation of the input
    ops with some line ops reversed.  The tour length is re-verified on host
    in float64 — if the float32 device pass did not strictly improve it, the
    original list is returned unchanged (never worse)."""
    from .planner import _op_entry, _op_exit, _op_flip, tour_length  # noqa: PLC0415

    if len(ops) < 3:
        return None
    entries = np.array([_op_entry(o) for o in ops], np.float32)
    exits = np.array([_op_exit(o) for o in ops], np.float32)
    r = refine_order_device(entries, exits, max_moves=max_moves)
    if r is None:
        return None
    perm, flip, _moves = r
    out = [_op_flip(ops[int(p)]) if f else ops[int(p)] for p, f in zip(perm, flip)]
    if tour_length(out) >= tour_length(ops):
        return list(ops)
    return out
