"""Zhang–Suen skeletonization as an iterated two-subpass stencil.

Each iteration runs the two classical subpasses (neighbor count B ∈ [2,6],
transition count A == 1, plus the subpass-specific direction products) as
whole-array boolean algebra inside a ``lax.while_loop`` that exits when an
iteration removes nothing or the cap is reached — identical convergence
semantics to the reference (04_find_contours.py:35-99, which also stops as
soon as a full iteration removes no pixel; its max_iter=120 cap is honored
via ``max_iter``).

Bit-exact vs the reference on any input (validated by golden tests).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _neighbors(x: jax.Array, rotated: bool):
    """P2..P9 ring, zero border.

    ``rotated=False``: textbook order (N, NE, E, SE, S, SW, W, NW) — used by
    the reference's stage-08 fallback thinner (08_dedup_layer_basic.py:342).
    ``rotated=True``: the 180°-rotated ring the reference's stage-04 thinner
    actually computes (its ``_shift(roi, -1, 0)`` reads the *south* neighbor,
    04_find_contours.py:14-22,53-55) — S, SW, W, NW, N, NE, E, SE.  Zhang–Suen
    is not rotation-symmetric, so the two variants differ on rare patterns and
    both must be available for bit-exact parity.
    """
    h, w = x.shape[-2], x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)]
    p = jnp.pad(x, pad)

    def at(dy, dx):
        return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    ring = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]
    if rotated:
        ring = [(-dy, -dx) for dy, dx in ring]
    return tuple(at(dy, dx) for dy, dx in ring)


def _subpass(x: jax.Array, first: bool, rotated: bool) -> jax.Array:
    p2, p3, p4, p5, p6, p7, p8, p9 = _neighbors(x, rotated)
    ring = (p2, p3, p4, p5, p6, p7, p8, p9, p2)
    b = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9
    a = jnp.zeros_like(b)
    for i in range(8):
        a = a + ((ring[i] == 0) & (ring[i + 1] == 1)).astype(jnp.int32)
    if first:
        dir_ok = ((p2 * p4 * p6) == 0) & ((p4 * p6 * p8) == 0)
    else:
        dir_ok = ((p2 * p4 * p8) == 0) & ((p2 * p6 * p8) == 0)
    kill = (x == 1) & (a == 1) & (b >= 2) & (b <= 6) & dir_ok
    return jnp.where(kill, 0, x)


@partial(jax.jit, static_argnames=("max_iter", "rotated"))
def zhang_suen_dense(binary: jax.Array, max_iter: int = 120, rotated: bool = True) -> jax.Array:
    """Reference dense-pixel implementation of :func:`zhang_suen` (one int32
    lane per pixel).  Kept as the readable oracle and for the halo variant
    that reuses ``_subpass``; production calls go through the bit-packed twin
    below (bit-exact)."""
    x0 = (binary > 0).astype(jnp.int32)

    def body(state):
        x, it, _ = state
        x1 = _subpass(x, first=True, rotated=rotated)
        x2 = _subpass(x1, first=False, rotated=rotated)
        changed = jnp.any(x2 != x)
        return x2, it + 1, changed

    def cond(state):
        _, it, changed = state
        return changed & (it < max_iter)

    x, _, _ = jax.lax.while_loop(cond, body, (x0, jnp.int32(0), jnp.array(True)))
    return x


# --------------------------------------------------------------------------
# Bit-packed variant: 32 pixels per uint32 lane (ROADMAP #6).
#
# The subpass is pure boolean algebra, so packing 32 columns into each lane
# cuts VPU work ~16x: the neighbor count B is computed bit-sliced with
# carry-save adders (full adders over bitboards), the transition count A==1
# with an exactly-one accumulator, and the direction products as plain AND
# trees.  Zero borders fall out of the shift fills; padding bits beyond W
# stay zero because thinning only clears bits.  Bit-exact vs zhang_suen on
# both ring orientations (fuzz-pinned in test_ops_raster).


def _shift_words(p: jax.Array, d: int) -> jax.Array:
    """Word-axis shift on the last axis: out[..., k] = p[..., k+d], zero fill."""
    nw = p.shape[-1]
    z = jnp.zeros_like(p[..., :abs(d)])
    if d > 0:
        return jnp.concatenate([p[..., d:], z], axis=-1)
    return jnp.concatenate([z, p[..., :nw + d]], axis=-1)


def _shift_rows(p: jax.Array, d: int) -> jax.Array:
    """Row-axis shift: out[..., r, :] = p[..., r+d, :], zero fill."""
    if d == 0:
        return p
    z = jnp.zeros_like(p[..., :abs(d), :])
    if d > 0:
        return jnp.concatenate([p[..., d:, :], z], axis=-2)
    return jnp.concatenate([z, p[..., :p.shape[-2] + d, :]], axis=-2)


def _nbr_bits(p: jax.Array, dx: int) -> jax.Array:
    """Column-neighbor bitboard: bit j of the result = bit j+dx of the packed
    row (LSB-first within each word, carries across word boundaries)."""
    if dx == 0:
        return p
    if dx > 0:  # east neighbor
        return (p >> 1) | (_shift_words(p, 1) << 31)
    return (p << 1) | (_shift_words(p, -1) >> 31)  # west


def _fa(a, b, c):
    """Bitboard full adder: (sum, carry)."""
    ab = a ^ b
    return ab ^ c, (a & b) | (c & ab)


def _subpass_bits(x: jax.Array, first: bool, rotated: bool) -> jax.Array:
    ring = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]
    if rotated:
        ring = [(-dy, -dx) for dy, dx in ring]
    rows = {dy: _shift_rows(x, dy) for dy in (-1, 0, 1)}
    n = [_nbr_bits(rows[dy], dx) for dy, dx in ring]  # P2..P9 bitboards

    # B = sum of the 8 neighbor bits, bit-sliced via carry-save adders
    s1, c1 = _fa(n[0], n[1], n[2])
    s2, c2 = _fa(n[3], n[4], n[5])
    s3, c3 = n[6] ^ n[7], n[6] & n[7]
    b0, c4 = _fa(s1, s2, s3)
    s5, c5 = _fa(c1, c2, c3)
    b1, c6 = s5 ^ c4, s5 & c4
    b2, b3 = c5 ^ c6, c5 & c6
    b_ok = (b1 | b2 | b3) & ~(b3 | (b2 & b1 & b0))  # 2 <= B <= 6

    # A == 1: exactly one 0->1 transition around the ring
    t0 = ~n[0] & n[1]
    any_, two = t0, jnp.zeros_like(x)
    for i in range(1, 8):
        t = ~n[i] & n[(i + 1) % 8]
        two = two | (any_ & t)
        any_ = any_ | t
    a1 = any_ & ~two

    p2, p4, p6, p8 = n[0], n[2], n[4], n[6]
    if first:
        dir_ok = ~(p2 & p4 & p6) & ~(p4 & p6 & p8)
    else:
        dir_ok = ~(p2 & p4 & p8) & ~(p2 & p6 & p8)

    return x & ~(x & a1 & b_ok & dir_ok)


def pack_bitboards(binary: jax.Array) -> jax.Array:
    """(..., H, W) 0/1-ish → (..., H, ceil(W/32)) uint32, LSB-first."""
    w = binary.shape[-1]
    x = (binary > 0).astype(jnp.uint32)
    pad = (-w) % 32
    if pad:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    xr = x.reshape(*x.shape[:-1], -1, 32)
    weights = jnp.left_shift(jnp.uint32(1), jnp.arange(32, dtype=jnp.uint32))
    return (xr * weights).sum(axis=-1, dtype=jnp.uint32)


def unpack_bitboards(packed: jax.Array, width: int) -> jax.Array:
    """Inverse of :func:`pack_bitboards` → (..., H, width) int32 0/1."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[..., :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(*packed.shape[:-1], -1)[..., :width].astype(jnp.int32)


@partial(jax.jit, static_argnames=("max_iter", "rotated"))
def zhang_suen(binary: jax.Array, max_iter: int = 120, rotated: bool = True) -> jax.Array:
    """Thin a (..., H, W) 0/1 (or 0/255) image to 1-px skeletons; 0/1 int32.

    Leading dims are batched with one joint convergence loop (iterations past
    an element's fixpoint are no-ops).  ``rotated=True`` reproduces stage 04's
    thinner; ``rotated=False`` with ``max_iter=48`` reproduces stage 08's
    fallback thinner.

    Runs bit-packed (32 px per uint32 lane); bit-exact vs
    :func:`zhang_suen_dense` on both ring orientations (fuzz-pinned).
    """
    x = zhang_suen_packed(pack_bitboards(binary), max_iter=max_iter, rotated=rotated)
    return unpack_bitboards(x, binary.shape[-1])


def zhang_suen_packed(packed: jax.Array, max_iter: int = 120, rotated: bool = True) -> jax.Array:
    """:func:`zhang_suen`'s fixpoint on an ALREADY bit-packed board (the
    representation :func:`pack_bitboards` produces — also what canny's
    bit-packed hysteresis converges in), returning the packed skeleton.
    Skips the dense-u8 round trip + re-pack between the two fixpoints when
    chained after ``canny_packed`` (ops/frontend.py)."""

    def body(state):
        x, it, _ = state
        x2, changed = thinning_step(x, rotated)
        return x2, it + 1, changed

    def cond(state):
        _, it, changed = state
        return changed & (it < max_iter)

    x, _, _ = jax.lax.while_loop(cond, body, (packed, jnp.int32(0), jnp.array(True)))
    return x


def thinning_step(x: jax.Array, rotated: bool = True):
    """One Zhang–Suen iteration (both subpasses) on a packed board →
    (new board, changed?)."""
    x1 = _subpass_bits(x, first=True, rotated=rotated)
    x2 = _subpass_bits(x1, first=False, rotated=rotated)
    return x2, jnp.any(x2 != x)
