"""Area-average (INTER_AREA-style) resize as two matmuls.

Step 01's downscale: the separable area-overlap weights applied as ordered
per-tap gathers and float32 accumulations on the device.

Rounding contracts (reference behavior: 01_resize.py:7-23 via cv2.resize):

- integer scale ratio: box sum with round-half-up — bit-exact vs OpenCV's
  fast path.
- fractional ratio: exact replica of OpenCV's ``resizeArea`` —
  ``computeResizeAreaTab``'s span table (double intermediates, float32
  alphas, the 1e-3 sliver thresholds, ``cellWidth`` edge handling),
  horizontal-then-vertical float32 accumulation in tap order, round
  half-to-even — bit-exact vs OpenCV (fuzz-pinned in test_ops_raster).
  Per-destination tap counts are tiny (ceil(scale)+1), so the gather
  formulation is a handful of vectorized passes, not a dense matmul.
"""

from __future__ import annotations

import math
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=64)
def _resize_area_tab(ssize: int, dsize: int):
    """OpenCV ``computeResizeAreaTab`` replica (resize.cpp): per destination
    index, the ordered (source index, float32 alpha) taps.  Returned padded
    to the max tap count with alpha=0 (adding ``0.0`` is exact, so padding
    preserves the float32 accumulation order of the real taps)."""
    scale = ssize / dsize
    ent = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cw = min(scale, ssize - fsx1)
        sx1 = math.ceil(fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(sx1, sx2)
        e = []
        if sx1 - fsx1 > 1e-3:
            e.append((sx1 - 1, np.float32((sx1 - fsx1) / cw)))
        inv = np.float32(1.0 / cw)
        for sx in range(sx1, sx2):
            e.append((sx, inv))
        if fsx2 - sx2 > 1e-3:
            e.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cw) / cw)))
        ent.append(e)
    taps = max(len(e) for e in ent)
    si = np.zeros((dsize, taps), np.int32)
    al = np.zeros((dsize, taps), np.float32)
    for d, e in enumerate(ent):
        for t, (s, a) in enumerate(e):
            si[d, t] = s
            al[d, t] = a
    return si, al


@partial(jax.jit, static_argnames=("new_w", "new_h"))
def _frac_hprod(img: jax.Array, new_w: int, new_h: int) -> jax.Array:
    xsi, xal = _resize_area_tab(img.shape[1], new_w)
    x = img.astype(jnp.float32)
    return jnp.stack(
        [x[:, xsi[:, t], :] * xal[None, :, t, None] for t in range(xsi.shape[1])]
    )


@partial(jax.jit, static_argnames=("new_w", "new_h"))
def _frac_hsum_vprod(p: jax.Array, new_w: int, new_h: int) -> jax.Array:
    ysi, yal = _resize_area_tab(p.shape[1], new_h)
    hb = p[0]
    for t in range(1, p.shape[0]):
        hb = hb + p[t]
    return jnp.stack(
        [hb[ysi[:, t], :, :] * yal[:, t, None, None] for t in range(ysi.shape[1])]
    )


@jax.jit
def _frac_vsum(p: jax.Array) -> jax.Array:
    out = p[0]
    for t in range(1, p.shape[0]):
        out = out + p[t]
    return jnp.clip(jnp.rint(out), 0, 255).astype(jnp.uint8)


# extreme-ratio chunking: the product stack is (taps, H, W', C) float32, so
# taps ≈ ceil(scale)+1 makes memory scale with the downscale ratio (ADVICE r2
# #4: 8000→100 ≈ 81 taps ≈ hundreds of MB).  Above this many taps the passes
# accumulate per fixed-size tap groups instead — same products, same
# sequential add order, just cut at extra kernel boundaries (which is the
# fma-safe cut, see _area_resize_frac), capping the stack at
# _TAP_CHUNK·H·W'·C·4 bytes.  Ratios ≤ ~15 keep the 3-dispatch fast path.
_TAP_CHUNK = 16


@partial(jax.jit, static_argnames=("new_w", "t0", "t1"))
def _frac_hprod_chunk(img: jax.Array, new_w: int, t0: int, t1: int) -> jax.Array:
    xsi, xal = _resize_area_tab(img.shape[1], new_w)
    x = img.astype(jnp.float32)
    return jnp.stack(
        [x[:, xsi[:, t], :] * xal[None, :, t, None] for t in range(t0, t1)]
    )


@partial(jax.jit, static_argnames=("new_h", "t0", "t1"))
def _frac_vprod_chunk(hb: jax.Array, new_h: int, t0: int, t1: int) -> jax.Array:
    ysi, yal = _resize_area_tab(hb.shape[0], new_h)
    return jnp.stack(
        [hb[ysi[:, t], :, :] * yal[:, t, None, None] for t in range(t0, t1)]
    )


@jax.jit
def _frac_add_first(p: jax.Array) -> jax.Array:
    acc = p[0]
    for t in range(1, p.shape[0]):
        acc = acc + p[t]
    return acc


@jax.jit
def _frac_add_into(acc: jax.Array, p: jax.Array) -> jax.Array:
    for t in range(p.shape[0]):
        acc = acc + p[t]
    return acc


@jax.jit
def _frac_round_u8(acc: jax.Array) -> jax.Array:
    return jnp.clip(jnp.rint(acc), 0, 255).astype(jnp.uint8)


def _frac_pass_chunked(prod, taps: int) -> jax.Array:
    """Ordered tap accumulation in _TAP_CHUNK groups: products come from one
    kernel, the adds consuming them from the next (materialized boundary =
    no fma contraction), and group order preserves the global add order."""
    acc = None
    for t0 in range(0, taps, _TAP_CHUNK):
        p = prod(t0, min(t0 + _TAP_CHUNK, taps))
        acc = _frac_add_first(p) if acc is None else _frac_add_into(acc, p)
    return acc


def _area_resize_frac(img: jax.Array, new_w: int, new_h: int) -> jax.Array:
    """OpenCV ``ResizeArea`` replica: horizontal pass then vertical pass,
    accumulating taps in table order, so every float32 rounding step matches.

    Deliberately THREE dispatches, not one fused kernel: products and the
    additions that consume them must live in separate XLA executables,
    because XLA:CPU's LLVM backend contracts a fused mul+add into fma even
    across ``optimization_barrier`` — and OpenCV rounds each product before
    adding (no fma), so contraction flips half-even ties.  Materializing the
    product stacks at kernel boundaries is the only contraction-proof cut.
    (One implementation must be bit-exact on every backend — the e2e
    goldens run on the CPU and the GPU.)

    Extreme downscale ratios (> ~15, taps > _TAP_CHUNK) switch to the
    chunked accumulation above — bit-identical, bounded memory.
    """
    x = img if img.ndim == 3 else img[:, :, None]
    th = _resize_area_tab(x.shape[1], new_w)[0].shape[1]
    tv = _resize_area_tab(x.shape[0], new_h)[0].shape[1]
    if th <= _TAP_CHUNK and tv <= _TAP_CHUNK:
        o = _frac_vsum(_frac_hsum_vprod(_frac_hprod(x, new_w, new_h), new_w, new_h))
    else:
        hb = _frac_pass_chunked(lambda a, b: _frac_hprod_chunk(x, new_w, a, b), th)
        o = _frac_round_u8(
            _frac_pass_chunked(lambda a, b: _frac_vprod_chunk(hb, new_h, a, b), tv)
        )
    return o if img.ndim == 3 else o[:, :, 0]


@partial(jax.jit, static_argnames=("sy", "sx"))
def _area_resize_int(img: jax.Array, sy: int, sx: int) -> jax.Array:
    """Integer-ratio box downscale (OpenCV fast-path rounding).

    OpenCV's 2×2 case is a specialized integer average with half-up rounding;
    every other integer ratio multiplies the block sum by a float reciprocal
    and rounds half-to-even.  Both are reproduced exactly.
    """
    h, w = img.shape[:2]
    x = img.astype(jnp.int32)
    if x.ndim == 2:
        x = x[:, :, None]
    c = x.shape[2]
    x = x.reshape(h // sy, sy, w // sx, sx, c).sum(axis=(1, 3))
    area = sy * sx
    if (sy, sx) == (2, 2):
        o = ((x + 2) >> 2).astype(jnp.uint8)
    else:
        o = jnp.clip(jnp.rint(x.astype(jnp.float64) / area), 0, 255).astype(jnp.uint8)
    return o if img.ndim == 3 else o[:, :, 0]


def area_resize(img, new_w: int, new_h: int):
    """Downscale with area averaging; picks the bit-exact path when possible."""
    h, w = img.shape[:2]
    if (new_w, new_h) == (w, h):
        return jnp.asarray(img)
    if h % new_h == 0 and w % new_w == 0:
        return _area_resize_int(jnp.asarray(img), h // new_h, w // new_w)
    return _area_resize_frac(jnp.asarray(img), new_w, new_h)


def resize_if_needed(img, max_dimension: int):
    """Cap the longest side at ``max_dimension`` (reference 01_resize.py:7-23)."""
    h, w = img.shape[:2]
    m = max(h, w)
    if m <= max_dimension:
        return img, False  # keep host-resident: no device round trip for a no-op
    scale = max_dimension / m
    return area_resize(img, int(w * scale), int(h * scale)), True
