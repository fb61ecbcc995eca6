"""Fused raster front-end: image → per-layer edges + skeletons, one program.

This is the flagship compute graph (stages 01–04's dense work): Lab
conversion → nearest-center layer assignment → per-layer mask morphology →
Gaussian blur → Canny → Zhang–Suen thinning, batched over layers, jitted
end-to-end so XLA fuses the stencil chains and keeps everything on the
device.  Batched/sharded wrappers live in plotweave.parallel.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from .canny import canny_packed
from .colorspace import bgr_to_lab_u8
from .filters import gaussian_blur_u8
from .thinning import unpack_bitboards, zhang_suen_packed


def assign_nearest(image: jax.Array, centers: jax.Array, k: int) -> jax.Array:
    """Nearest-Lab-center label per pixel: (..., H, W, 3) u8 + (k, 3) f32 →
    (..., H, W) int32 with first-minimum tie-breaking (== argmin).

    The distances unroll elementwise over the k static centers with a running
    (best, argbest) pair, so XLA fuses Lab conversion + k distances + the
    argmin into ONE pass over the image — neither the (N, 3) f32 Lab plane
    nor an (N, k) f32 distance matrix is ever materialized in HBM (the
    matmul-expansion form wrote both; the chain is bandwidth-bound, r4
    roofline).  The per-pixel math matches the reference's own assignment
    form `sum((lab - c)**2)` (02_color_extract.py:52-55)."""
    lab = bgr_to_lab_u8(image)  # fused into the distance pass below
    best_d = jnp.sum((lab - centers[0]) ** 2, axis=-1)
    best = jnp.zeros(image.shape[:-1], jnp.int32)
    for i in range(1, k):
        d = jnp.sum((lab - centers[i]) ** 2, axis=-1)
        take = d < best_d  # strict <: first minimum wins, like argmin
        best = jnp.where(take, jnp.int32(i), best)
        best_d = jnp.minimum(best_d, d)
    return best


@partial(
    jax.jit,
    static_argnames=(
        "k",
        "extract_iters",
        "edge_kernel",
        "edge_iters",
        "blur_kernel",
        "low",
        "high",
        "thin_iters",
    ),
)
def raster_frontend(
    image: jax.Array,  # (..., H, W, 3) uint8 BGR — leading batch dims allowed
    centers: jax.Array,  # (k, 3) float32 Lab centers (from plotweave.ops.kmeans)
    *,
    k: int = 4,
    extract_iters: int = 1,
    edge_kernel: int = 3,
    edge_iters: int = 1,
    blur_kernel: int = 7,
    low: int = 22,
    high: int = 70,
    thin_iters: int = 120,
) -> Tuple[jax.Array, jax.Array]:
    """Returns (edges (..., k, H, W) uint8, skeletons (..., k, H, W) uint8)."""
    labels = assign_nearest(image, centers, k)  # (...,H,W) int32

    # all ops are natively batched on (..., k, H, W): static-slice stencils
    # and joint fixpoint loops compile far faster than vmap-of-while.
    # The binary morphology runs bit-packed (32 px/uint32 lane, one pack →
    # four programs → one unpack) — 2.9× the dense min/max chain.
    from .morphology import _valid_bits, morph_bits  # noqa: PLC0415
    from .thinning import pack_bitboards, unpack_bitboards  # noqa: PLC0415

    w = image.shape[-2]  # (..., H, W, 3) → W
    masks_b = pack_bitboards(
        labels[..., None, :, :] == jnp.arange(k)[:, None, None]
    )
    valid = jnp.asarray(_valid_bits(w))
    masks_b = morph_bits(masks_b, valid, "rect", 3, extract_iters, "ed")
    masks_b = morph_bits(masks_b, valid, "rect", 3, extract_iters, "de")
    masks_b = morph_bits(masks_b, valid, "ellipse", edge_kernel, edge_iters, "ed")
    masks_b = morph_bits(masks_b, valid, "ellipse", edge_kernel, edge_iters, "de")
    masks = unpack_bitboards(masks_b, w).astype(jnp.uint8) * 255
    # canny's hysteresis already runs bit-packed: hand its packed fixpoint
    # result straight to the (also bit-packed) thinner instead of paying a
    # dense-u8 round trip + re-pack between the two fixpoints
    edges, edges_b = canny_packed(gaussian_blur_u8(masks, blur_kernel), low, high)
    skel_b = zhang_suen_packed(edges_b, max_iter=thin_iters, rotated=True)
    skel = unpack_bitboards(skel_b, w).astype(jnp.uint8)
    return edges, skel
