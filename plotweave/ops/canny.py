"""Canny edge detection, bit-compatible with OpenCV's L1 path.

Pipeline: 3×3 Sobel (replicate border) → L1 magnitude → fixed-point sector
non-maximum suppression (the Q15 tan(22.5°)=13573 trick, with OpenCV's exact
strict/non-strict comparison pattern per sector) → double threshold →
hysteresis as a dilate-AND fixpoint loop (equivalent to BFS reachability
from strong pixels through weak ones, but expressible as a device stencil).

Reference use: 03_edge_detect.py:34 (cv2.Canny on the blurred mask).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_TG22 = 13573  # tan(22.5°) in Q15
_SHIFT = 15


def _nbr(x: jax.Array, dy: int, dx: int, fill=0) -> jax.Array:
    """Neighbor lookup on the last two dims: out[..., i, j] = x[..., i+dy, j+dx],
    out-of-bounds reads ``fill``.  Leading dims ride along (no vmap needed)."""
    h, w = x.shape[-2], x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)]
    p = jnp.pad(x, pad, constant_values=fill)
    return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def _sobel_pair(img: jax.Array):
    """3×3 Sobel dx, dy with replicate border, int16 (|g| ≤ 4·255 = 1020, so
    16 bits hold every value exactly — halves the HBM bytes of the gradient
    and magnitude planes); batched over leading dims."""
    x = img.astype(jnp.int16)
    h, w = img.shape[-2], img.shape[-1]
    pad = [(0, 0)] * (img.ndim - 2) + [(1, 1), (1, 1)]
    p = jnp.pad(x, pad, mode="edge")

    def at(dy, dx):
        return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    # smooth along one axis [1,2,1], derivative along the other [-1,0,1]
    gx = (at(-1, 1) + 2 * at(0, 1) + at(1, 1)) - (at(-1, -1) + 2 * at(0, -1) + at(1, -1))
    gy = (at(1, -1) + 2 * at(1, 0) + at(1, 1)) - (at(-1, -1) + 2 * at(-1, 0) + at(-1, 1))
    return gx, gy


@partial(jax.jit, static_argnames=("low", "high"))
def canny(img: jax.Array, low: int, high: int) -> jax.Array:
    """Binary edge map (uint8 0/255) of a (..., H, W) uint8 image.

    Leading dims are batched; hysteresis runs as one joint fixpoint over the
    whole batch (extra sweeps past a layer's convergence are no-ops)."""
    return canny_packed(img, low, high)[0]


def canny_packed(img: jax.Array, low: int, high: int):
    """:func:`canny` + the hysteresis fixpoint's own bit-packed result:
    (dense uint8 0/255 edges, pack_bitboards-encoded edges).  The packed
    board feeds thinning.zhang_suen_packed directly — the two fixpoints
    share the encoding, so the dense round trip between them is pure waste
    (ops/frontend.py)."""
    candb, edgesb = canny_boards(img, low, high)
    edgesb, _ = jax.lax.while_loop(
        lambda st: st[1], lambda st: hysteresis_step(candb, st[0]), (edgesb, jnp.array(True))
    )
    from .thinning import unpack_bitboards  # noqa: PLC0415

    edges = unpack_bitboards(edgesb, img.shape[-1])
    return jnp.where(edges != 0, jnp.uint8(255), jnp.uint8(0)), edgesb


def canny_boards(img: jax.Array, low: int, high: int):
    """Sobel + sector NMS + double threshold → bit-packed (candidate, strong)
    boards, the hysteresis fixpoint's inputs."""
    from .thinning import pack_bitboards  # noqa: PLC0415

    if low > high:
        low, high = high, low
    # L1 magnitude ≤ 2040, so thresholds clamp into int16 range losslessly
    low, high = min(low, 2041), min(high, 2041)
    gx, gy = _sobel_pair(img)
    mag = jnp.abs(gx) + jnp.abs(gy)

    # ---- sector NMS (magnitude neighbors beyond the border read as 0) ----
    m_l = _nbr(mag, 0, -1)
    m_r = _nbr(mag, 0, 1)
    m_u = _nbr(mag, -1, 0)
    m_d = _nbr(mag, 1, 0)
    m_ul = _nbr(mag, -1, -1)
    m_ur = _nbr(mag, -1, 1)
    m_dl = _nbr(mag, 1, -1)
    m_dr = _nbr(mag, 1, 1)

    # the Q15 sector products need 32 bits; everything else stays int16
    ax = jnp.abs(gx).astype(jnp.int32)
    ay = jnp.abs(gy).astype(jnp.int32) << _SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << (_SHIFT + 1))

    horiz = ay < tg22x
    vert = ay > tg67x
    sign_neg = (gx ^ gy) < 0  # gradient along the anti-diagonal

    keep_h = (mag > m_l) & (mag >= m_r)
    keep_v = (mag > m_u) & (mag >= m_d)
    # s=-1: compare (up, j+1) and (down, j-1); s=+1: (up, j-1) and (down, j+1)
    keep_d = jnp.where(
        sign_neg,
        (mag > m_ur) & (mag > m_dl),
        (mag > m_ul) & (mag > m_dr),
    )
    keep = jnp.where(horiz, keep_h, jnp.where(vert, keep_v, keep_d))

    cand = (mag > low) & keep
    strong = cand & (mag > high)

    return pack_bitboards(cand), pack_bitboards(strong)


def hysteresis_step(candb: jax.Array, edgesb: jax.Array):
    """One step of the hysteresis fixpoint: grow the strong edges through the
    candidates → (new board, changed?).

    Reachability grows one pixel per sweep along weak-edge chains, so the
    loop trip count is the longest chain (often hundreds).  It runs
    bit-packed (32 px per uint32 lane, the thinning fixpoint's encoding) so
    each sweep touches ~1/32 of the dense bool bytes — the fixpoint is
    identical, only the encoding changes.  Two sweeps per step halve the
    loop's predicate reductions; sweeps past the fixpoint are no-ops (growth
    is monotone)."""
    from .thinning import _nbr_bits, _shift_rows  # noqa: PLC0415

    def _dilate8(e):
        row = e | _nbr_bits(e, 1) | _nbr_bits(e, -1)
        return row | _shift_rows(row, 1) | _shift_rows(row, -1)

    new = candb & _dilate8(edgesb)
    new = candb & _dilate8(new)
    return new, jnp.any(new != edgesb)
