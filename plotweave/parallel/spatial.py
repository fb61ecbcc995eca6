"""Spatial sharding: one large image row-sharded across the mesh.

Stencil stages exchange 1-to-3-row halos with mesh neighbors via
``jax.lax.ppermute`` (device-to-device traffic only); iterative fixpoints
(Canny hysteresis, Zhang–Suen thinning) exchange a 1-row halo per sweep and
reach global convergence via an all-reduced changed flag.  This is the
multi-device answer to the reference's resolution cap — instead of downscaling a 4K+ input
(01_resize.py:15-20), shard it (SURVEY §5 long-context mapping).

Outputs are bit-identical to the single-device ops (halo regions are compute
margins, discarded after each exchange; global borders reproduce each op's
border mode on the edge shards).
"""

from __future__ import annotations

from functools import lru_cache as _lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.canny import _nbr, _sobel_pair, _TG22, _SHIFT
from ..ops.filters import gaussian_kernel_q8
from ..ops.morphology import structuring_element
from ..ops.thinning import _subpass

AXIS = "space"


def make_local_frontend(k: int, edge_kernel: int, blur_kernel: int, low: int, high: int, reduce_axes=(AXIS,)):
    """Per-shard front-end body (expects to run inside shard_map over AXIS)."""
    se = structuring_element("ellipse", edge_kernel)

    def local(img_rows, ctrs):
        # SHARED with the unsharded frontend (assignment is pointwise — no
        # halo needed), so the twins cannot diverge on the assign math
        from ..ops.frontend import assign_nearest  # noqa: PLC0415

        labels = assign_nearest(img_rows, ctrs, k)

        def per_layer(idx):
            m = (labels == idx).astype(jnp.uint8) * 255
            rect = structuring_element("rect", 3)
            m = _morph_halo_b(m, rect, False)
            m = _morph_halo_b(m, rect, True)  # open
            m = _morph_halo_b(m, rect, True)
            m = _morph_halo_b(m, rect, False)  # close
            m = _morph_halo_b(m, se, False)
            m = _morph_halo_b(m, se, True)  # edge open
            m = _morph_halo_b(m, se, True)
            m = _morph_halo_b(m, se, False)  # edge close
            e = _canny_halo_b(_blur_halo_b(m, blur_kernel), low, high, reduce_axes)
            s = _thin_halo_b(e, reduce_axes=reduce_axes).astype(jnp.uint8)
            return e, s

        return jax.vmap(per_layer)(jnp.arange(k))

    return local


def spatial_frontend(
    mesh: Mesh,
    image,
    centers,
    *,
    k: int = 4,
    edge_kernel: int = 3,
    blur_kernel: int = 7,
    low: int = 22,
    high: int = 70,
):
    """Row-sharded front-end over one image: (H, W, 3) uint8 + (k, 3) centers
    → (k, H, W) edges, (k, H, W) skeletons, H sharded over the ``space`` axis.
    """
    local = make_local_frontend(k, edge_kernel, blur_kernel, low, high)
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(AXIS), P()),
        out_specs=(P(None, AXIS), P(None, AXIS)),
        check_vma=False,
    )
    return jax.jit(fn)(image, centers)


# --------------------------------------------------------------------------
# Batched halo ops: (k, rows, W) layers sharded on the rows axis.  Twins of
# the single-layer helpers above, but batched over the layer dim so the
# iterative fixpoints run jointly (vmap-of-while compiles pathologically on
# this backend — same design rule as the single-device ops).


def _with_halo_b(x: jax.Array, h: int, border: str) -> jax.Array:
    """Halo exchange on axis -2 of (..., rows, W): prepend/append ``h`` rows
    from mesh neighbors; edge shards synthesize the global border (zero /
    reflect-101 / edge-replicate).  Works on 2-D single layers and (k, rows,
    W) batches alike (leading dims ride along)."""
    n = jax.lax.axis_size(AXIS)
    i = jax.lax.axis_index(AXIS)
    down = [(j, j + 1) for j in range(n - 1)]
    up = [(j, j - 1) for j in range(1, n)]
    from_above = jax.lax.ppermute(x[..., -h:, :], AXIS, down)
    from_below = jax.lax.ppermute(x[..., :h, :], AXIS, up)

    if border == "zero":
        top_fill = jnp.zeros_like(x[..., :h, :])
        bot_fill = top_fill
    elif border == "reflect":  # reflect-101
        top_fill = x[..., 1 : h + 1, :][..., ::-1, :]
        bot_fill = x[..., -h - 1 : -1, :][..., ::-1, :]
    elif border == "edge":
        top_fill = jnp.repeat(x[..., :1, :], h, axis=-2)
        bot_fill = jnp.repeat(x[..., -1:, :], h, axis=-2)
    else:
        raise ValueError(border)

    top = jnp.where(i == 0, top_fill, from_above)
    bot = jnp.where(i == n - 1, bot_fill, from_below)
    return jnp.concatenate([top, x, bot], axis=-2)


def _morph_halo_b(x: jax.Array, se: np.ndarray, is_max: bool) -> jax.Array:
    r = se.shape[0] // 2
    xp = _with_halo_b(x, r, "edge")
    rows, w = x.shape[-2], x.shape[-1]
    pad_val = jnp.iinfo(x.dtype).min if is_max else jnp.iinfo(x.dtype).max
    pad = [(0, 0)] * (x.ndim - 2) + [(0, 0), (r, r)]
    p = jnp.pad(xp, pad, constant_values=pad_val)
    ys, xs = np.nonzero(se)
    acc = None
    for dy, dx in zip(ys.tolist(), xs.tolist()):
        win = p[..., dy : dy + rows, dx : dx + w]
        acc = win if acc is None else (
            jnp.maximum(acc, win) if is_max else jnp.minimum(acc, win)
        )
    return acc


def _morph_prog_halo(x, shape: str, ksize: int, iterations: int, program: str):
    """Halo twin of ops.morphology._morph (same op sequencing)."""
    se = structuring_element(shape, ksize)
    for op in program:
        for _ in range(iterations):
            x = _morph_halo_b(x, se, is_max=(op == "d"))
    return x


def _blur_halo_b(x: jax.Array, ksize: int) -> jax.Array:
    kq = jnp.asarray(gaussian_kernel_q8(ksize))
    r = ksize // 2
    xi = x.astype(jnp.int32)
    rows, w = x.shape[-2], x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 2) + [(0, 0), (r, r)]
    p = jnp.pad(xi, pad, mode="reflect")
    tmp = sum(p[..., :, i : i + w] * kq[i] for i in range(ksize))
    tp = _with_halo_b(tmp, r, "reflect")
    acc = sum(tp[..., i : i + rows, :] * kq[i] for i in range(ksize))
    return jnp.clip((acc + (1 << 15)) >> 16, 0, 255).astype(jnp.uint8)


def _canny_halo_b(img: jax.Array, low: int, high: int, reduce_axes=(AXIS,)) -> jax.Array:
    """Batched :func:`_canny_halo`: joint hysteresis fixpoint over all layers
    (and, via ``reduce_axes``, over the whole mesh)."""
    if low > high:
        low, high = high, low
    # _sobel_pair returns int16 (|g| ≤ 1020); mirror ops.canny exactly —
    # magnitude/NMS stay 16-bit, the Q15 sector products widen to int32
    low, high = min(low, 2041), min(high, 2041)
    x2 = _with_halo_b(img, 2, "edge")
    gx, gy = _sobel_pair(x2)
    mag = jnp.abs(gx) + jnp.abs(gy)
    n = jax.lax.axis_size(AXIS)
    i = jax.lax.axis_index(AXIS)
    rows = jnp.arange(mag.shape[-2])[:, None]
    outside = ((i == 0) & (rows < 2)) | ((i == n - 1) & (rows >= mag.shape[-2] - 2))
    mag = jnp.where(outside, 0, mag)
    ax = jnp.abs(gx).astype(jnp.int32)
    ay = jnp.abs(gy).astype(jnp.int32) << _SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << (_SHIFT + 1))
    horiz = ay < tg22x
    vert = ay > tg67x
    sign_neg = (gx ^ gy) < 0
    keep_h = (mag > _nbr(mag, 0, -1)) & (mag >= _nbr(mag, 0, 1))
    keep_v = (mag > _nbr(mag, -1, 0)) & (mag >= _nbr(mag, 1, 0))
    keep_d = jnp.where(
        sign_neg,
        (mag > _nbr(mag, -1, 1)) & (mag > _nbr(mag, 1, -1)),
        (mag > _nbr(mag, -1, -1)) & (mag > _nbr(mag, 1, 1)),
    )
    keep = jnp.where(horiz, keep_h, jnp.where(vert, keep_v, keep_d))

    cand = ((mag > low) & keep)[..., 2:-2, :]
    strong = cand & (mag[..., 2:-2, :] > high)

    def sweep(state):
        edges, _ = state
        ep = _with_halo_b(edges, 1, "zero")
        nbr = ep
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    nbr = nbr | _nbr(ep, dy, dx, fill=False)
        new = cand & nbr[..., 1:-1, :]
        changed = jax.lax.psum(jnp.any(new != edges).astype(jnp.int32), reduce_axes) > 0
        return new, changed

    edges, _ = jax.lax.while_loop(lambda s: s[1], sweep, (strong, jnp.array(True)))
    return jnp.where(edges, jnp.uint8(255), jnp.uint8(0))


def _thin_halo_b(edges: jax.Array, max_iter: int = 120, reduce_axes=(AXIS,)) -> jax.Array:
    x0 = (edges > 0).astype(jnp.int32)

    def sub(x, first):
        xp = _with_halo_b(x, 1, "zero")
        return _subpass(xp, first=first, rotated=True)[..., 1:-1, :]

    def body(state):
        x, it, _ = state
        x1 = sub(x, True)
        x2 = sub(x1, False)
        changed = jax.lax.psum(jnp.any(x2 != x).astype(jnp.int32), reduce_axes) > 0
        return x2, it + 1, changed

    x, _, _ = jax.lax.while_loop(
        lambda s: s[2] & (s[1] < max_iter), body, (x0, jnp.int32(0), jnp.array(True))
    )
    return x


# The halo helpers exchange/synthesize at most 3 rows (blur k=7) and the
# reflect fill reads rows [1 : h+1], so each shard must hold a safe margin of
# rows — below this, halos would clip and results would silently diverge.
MIN_ROWS_PER_SHARD = 8


def fit_shard_rows(h: int, requested: int, n_devices: int, max_radius: int = 0) -> int:
    """Largest shard count ≤ min(requested, n_devices) that divides ``h``
    evenly AND leaves enough rows per shard for the halo stencils (shard_map
    needs equal row slabs; remainder handling is a documented non-goal — see
    ROADMAP).

    ``max_radius`` is the largest stencil radius the sharded program will
    run (edge-morph kernel // 2, blur kernel // 2, Canny's 2): a shard must
    hold ≥ radius+1 rows or ``_with_halo_b``'s neighbor slices / reflect
    fills come up short and fail with an opaque broadcast error at trace
    time.  MIN_ROWS_PER_SHARD covers the default kernels; outsized
    configured kernels raise the floor here instead of crashing later."""
    min_rows = max(MIN_ROWS_PER_SHARD, int(max_radius) + 1)
    cap = max(1, min(int(requested), int(n_devices), int(h) // min_rows or 1))
    for n in range(cap, 0, -1):
        if h % n == 0:
            return n
    return 1


def sharded_chain(
    mesh: Mesh,
    packed_clean,
    w: int,
    mk: int,
    oi: int,
    ci: int,
    bk: int,
    lo: int,
    hi: int,
):
    """Row-sharded twin of stage 02's fused ``_chain_from_clean`` device
    program (s02_color_extract.py): unpack the uploaded CLEANED masks,
    stage 03's morphology+blur+Canny, stage 04's thinning — with rows split
    over the ``space`` mesh axis and halos exchanged between devices.

    Bit-identical to the unsharded program: returns the same flat u8 blob
    ``[packed edges][packed skels]``.  This is the multi-device answer to
    the reference's resolution cap (01_resize.py:15-20): an image too large
    for one card's memory streams through N cards instead of being
    downscaled.  (The stage-02 mask refine runs on the host, so the rect
    clean-up stage and the masks leg of the blob are not part of it.)
    """
    run = _build_sharded_chain(mesh, w, mk, oi, ci, bk, lo, hi)
    return run(packed_clean)


@_lru_cache(maxsize=32)
def _build_sharded_chain(mesh, w, mk, oi, ci, bk, lo, hi):
    """Cached program builder: without this every call would create a fresh
    shard_map closure + jit identity and re-trace the whole fused chain
    (minutes on the remote compiler) — batch mode calls once per image."""
    from ..ops.bitpack import bitpack_rows, bitunpack_rows  # noqa: PLC0415

    def local(packed):
        m = bitunpack_rows(packed, w) * jnp.uint8(255)
        if oi > 0:
            m = _morph_prog_halo(m, "ellipse", mk, oi, "ed")
        if ci > 0:
            m = _morph_prog_halo(m, "ellipse", mk, ci, "de")
        edges = _canny_halo_b(_blur_halo_b(m, bk), lo, hi)
        skels = _thin_halo_b(edges)
        return bitpack_rows(edges), bitpack_rows(skels)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, AXIS, None),),
        out_specs=(
            P(None, AXIS, None),
            P(None, AXIS, None),
        ),
        check_vma=False,
    )

    @jax.jit
    def run(packed):
        pe, ps = fn(packed)
        return jnp.concatenate([pe.reshape(-1), ps.reshape(-1)])

    return run


def grid_frontend(
    mesh: Mesh,
    images,
    centers,
    *,
    k: int = 4,
    edge_kernel: int = 3,
    blur_kernel: int = 7,
    low: int = 22,
    high: int = 70,
    data_axis: str = "data",
):
    """2-D mesh: batch over ``data`` × rows over ``space`` simultaneously.

    (B, H, W, 3) images + (k, 3) shared centers → (B, k, H, W) outputs with
    B sharded over ``data`` and H over ``space`` — the dp×sp layout for
    many large images at once.
    """
    # convergence must be all-reduced over the FULL mesh: the data groups'
    # fixpoints otherwise iterate different counts and the per-iteration
    # ppermutes deadlock across groups (extra sweeps are no-ops).
    local1 = make_local_frontend(k, edge_kernel, blur_kernel, low, high,
                                 reduce_axes=(data_axis, AXIS))

    def local(imgs, ctrs):
        return jax.vmap(lambda im: local1(im, ctrs))(imgs)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(data_axis, AXIS), P()),
        out_specs=(P(data_axis, None, AXIS), P(data_axis, None, AXIS)),
        check_vma=False,
    )
    return jax.jit(fn)(images, centers)
