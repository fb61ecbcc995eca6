"""Bit-packing for binary images crossing the host↔device link.

Masks, edges and skeletons are all 0/255 uint8, so packing 8 pixels/byte on
the device cuts those host↔device transfers 8×.  Packing is MSB-first along the last axis to match
``np.unpackbits(..., axis=-1)`` on the host side.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def bitpack_rows(masks):
    """(..., W) uint8 (any nonzero = set) → (..., ceil(W/8)) uint8, on device."""
    w = masks.shape[-1]
    bits = (masks > 0).astype(jnp.uint8)
    pad = (-w) % 8
    if pad:
        bits = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    bits = bits.reshape(*bits.shape[:-1], -1, 8)
    weights = jnp.array([128, 64, 32, 16, 8, 4, 2, 1], jnp.int32)
    return (bits.astype(jnp.int32) * weights).sum(axis=-1).astype(jnp.uint8)


def bitunpack_rows(packed, width: int):
    """(..., ⌈W/8⌉) uint8 → (..., width) 0/1 uint8, on device (inverse of
    :func:`bitpack_rows`; MSB-first like ``np.unpackbits``)."""
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (packed[..., :, None] >> shifts) & jnp.uint8(1)
    return bits.reshape(*packed.shape[:-1], -1)[..., :width]


def unpack_rows(packed: np.ndarray, width: int) -> np.ndarray:
    """Host inverse of :func:`bitpack_rows`; returns 0/1 uint8 of last-axis
    length ``width``."""
    return np.unpackbits(np.asarray(packed), axis=-1)[..., :width]
