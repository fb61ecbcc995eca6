"""[02] Color-layer extraction → <layer>/mask.png + palette_by_name.json.

Default mode clusters pixels in Lab with k-means and maps clusters to layer
names by darkness; legacy swatch mode thresholds around configured BGR
swatches (reference 02_color_extract.py).

The default ``kmeans_init: "host-exact"`` path is bit-identical to the
reference on ARBITRARY inputs (photos included): cv2's fixed-point uint8
Lab conversion (utils/cvcolor.py), the exact ``cv2.kmeans`` replication
(ops/cvkmeans.py — OpenCV MWC RNG from its fresh-process state, kmeans++,
float32 Lloyd), the reference's numpy assignment semantics in native C++,
and the reference's 3×3 mask refine with cv2's border rule, on the host.
When the runner chains stages 03/04, the CLEANED masks cross to the device
bit-packed (8 px/byte) for the fused edges+skeletons program — ONE
dispatch whose fetch runs on a side thread so the mask PNG writes overlap
it.

``kmeans_init: "device"`` (opt-in) instead fuses the entire fit on device
with jax-PRNG sampling — deterministic per seed, not cv2-compatible.
"""

from __future__ import annotations

import os
from functools import lru_cache, partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig
from ..ops import morph_close, morph_open
from ..ops.bitpack import bitpack_rows, bitunpack_rows
from ..ops.colorspace import bgr_to_lab_u8
from ..ops.cvkmeans import assign_labels, cv_kmeans
from ..utils.cvcolor import bgr2lab_u8, lab2bgr_u8
from ..utils import (
    fetch_device_artifact,
    read_image,
    register_derived_artifact,
    register_device_artifact,
    save_json,
    thread_map,
    write_image,
)
from .common import chain_key, darkness_rank, edge_params, layer_dir


def _assign_tail(lab, best_centers, k: int, open_iters: int, close_iters: int):
    """All-pixel nearest-center assignment → counts → morphology-cleaned
    masks → (stats, packed masks, masks); shared by every fit variant."""
    flat = lab.reshape(-1, 3)
    d2 = (
        jnp.sum(flat * flat, axis=1, keepdims=True)
        - 2.0 * jnp.matmul(flat, best_centers.T, precision=jax.lax.Precision.HIGHEST)
        + jnp.sum(best_centers * best_centers, axis=1)
    )
    labels = jnp.argmin(d2, axis=1).reshape(lab.shape[:2])
    sel = labels[None, :, :] == jnp.arange(k)[:, None, None]
    counts = sel.sum(axis=(1, 2))
    masks = _binary_morph_u8(sel, lab.shape[1], open_iters, close_iters)
    counts_bits = jax.lax.bitcast_convert_type(counts[:, None].astype(jnp.int32), jnp.float32)
    stats = jnp.concatenate([best_centers, counts_bits], axis=1)
    return stats, bitpack_rows(masks), masks


def _binary_morph_u8(masks, w: int, open_iters: int, close_iters: int,
                     shape: str = "rect", ksize: int = 3):
    """Open/close on binary masks via the bit-packed morphology (one pack →
    programs → one unpack); returns 0/255 uint8."""
    from ..ops.morphology import _valid_bits, morph_bits  # noqa: PLC0415
    from ..ops.thinning import pack_bitboards, unpack_bitboards  # noqa: PLC0415

    if open_iters <= 0 and close_iters <= 0:
        return (masks > 0).astype(jnp.uint8) * 255
    b = pack_bitboards(masks)
    valid = jnp.asarray(_valid_bits(w))
    if open_iters > 0:
        b = morph_bits(b, valid, shape, ksize, open_iters, "ed")
    if close_iters > 0:
        b = morph_bits(b, valid, shape, ksize, close_iters, "de")
    return unpack_bitboards(b, w).astype(jnp.uint8) * 255


def _chain_tail(masks, mk: int, oi: int, ci: int, bk: int, lo: int, hi: int):
    """Stage 03's morphology+blur+Canny and stage 04's thinning over the
    cleaned masks; returns the bit-packed (2k, H, ⌈W/8⌉) edges+skeletons."""
    from ..ops.canny import canny_packed  # noqa: PLC0415
    from ..ops.filters import gaussian_blur_u8  # noqa: PLC0415
    from ..ops.thinning import unpack_bitboards, zhang_suen_packed  # noqa: PLC0415

    m = _binary_morph_u8(masks, masks.shape[-1], oi, ci, "ellipse", mk)
    # the hysteresis fixpoint's packed board feeds the (same-encoding) packed
    # thinner directly — no dense round trip + re-pack between the fixpoints
    edges, edges_b = canny_packed(gaussian_blur_u8(m, bk), lo, hi)
    skels = unpack_bitboards(
        zhang_suen_packed(edges_b, max_iter=120, rotated=True), masks.shape[-1]
    )
    # axis=-3 == axis 0 for the solo (k, H, w8) case; keeps leading batch dims
    return jnp.concatenate([bitpack_rows(edges), bitpack_rows(skels)], axis=-3)


@partial(
    jax.jit,
    static_argnames=(
        "k", "iters", "attempts", "limit", "seed", "fuse",
        "mk", "oi", "ci", "bk", "lo", "hi", "open_iters", "close_iters",
    ),
)
def _device_init_stage(
    img,
    k: int, iters: int, attempts: int, limit: int, seed: int, fuse: bool,
    mk: int = 0, oi: int = 0, ci: int = 0, bk: int = 3, lo: int = 0, hi: int = 0,
    open_iters: int = 1, close_iters: int = 1,
):
    """kmeans_init="device": the ENTIRE stage (and, when fused, stages 03/04's
    device work) in one dispatch — jax-PRNG subsample + ++ seeding, Lloyd,
    assignment, masks, optional edges+skeletons — returning one u8 blob.
    Deterministic per seed; not numpy-RNG-compatible (see CONFIG.md)."""
    from ..ops.kmeans import kmeans_fit_device  # noqa: PLC0415

    lab = bgr_to_lab_u8(img)
    flat = lab.reshape(-1, 3)
    n = flat.shape[0]
    if n > limit:
        idx = jax.random.choice(jax.random.PRNGKey(seed), n, (limit,), replace=False)
        sample = jnp.take(flat, idx, axis=0)
    else:
        sample = flat
    centers = kmeans_fit_device(sample, k, attempts, iters, seed)
    stats, packed_masks, masks = _assign_tail(lab, centers, k, open_iters, close_iters)
    parts = [
        jax.lax.bitcast_convert_type(stats, jnp.uint8).reshape(-1),
        packed_masks.reshape(-1),
    ]
    if fuse:
        parts.append(_chain_tail(masks, mk, oi, ci, bk, lo, hi).reshape(-1))
    return jnp.concatenate(parts), masks


def _rect3(m: np.ndarray, erode: bool, iters: int) -> np.ndarray:
    """``iters`` separable 3×3-rect erosions (or dilations) of a bool mask
    with cv2's constant border: outside pixels never erode or dilate."""
    f = np.logical_and if erode else np.logical_or
    for _ in range(iters):
        p = np.pad(m, ((0, 0), (1, 1)), constant_values=erode)
        r = f(f(p[:, :-2], p[:, 1:-1]), p[:, 2:])
        p = np.pad(r, ((1, 1), (0, 0)), constant_values=erode)
        m = f(f(p[:-2], p[1:-1]), p[2:])
    return m


def _host_clean_masks(labels: np.ndarray, k: int, open_iters: int, close_iters: int):
    """The reference's per-cluster mask refine (02:150-154): one-hot masks →
    3×3-rect ``morphologyEx`` open then close, ``iterations`` times each
    (pinned against cv2 in tests/test_cvcolor.py).  The device
    ``_binary_morph_u8`` replication serves the kmeans_init='device' path."""
    out = []
    for kk in range(k):
        m = labels == kk
        if open_iters > 0:
            m = _rect3(_rect3(m, True, open_iters), False, open_iters)
        if close_iters > 0:
            m = _rect3(_rect3(m, False, close_iters), True, close_iters)
        out.append(m.astype(np.uint8) * 255)
    return out


@partial(jax.jit, static_argnames=("w", "mk", "oi", "ci", "bk", "lo", "hi"))
def _chain_from_clean(
    packed_clean, w: int, mk: int, oi: int, ci: int, bk: int, lo: int, hi: int
):
    """Fused 03→04 device program over stage 02's already-cleaned masks:
    stage 03's morphology+blur+Canny plus stage 04's thinning — one dispatch
    round trip for the stages' device work.  Layer order is the original
    cluster order (per-layer ops are order-independent; the host permutes
    rows when it knows the dark→light relabel).  One flat u8 blob rides
    home: [packed edges (k·H·W8)] [packed skels]."""
    masks = bitunpack_rows(packed_clean, w) * jnp.uint8(255)
    return _chain_tail(masks, mk, oi, ci, bk, lo, hi).reshape(-1)


def _chain_blob_batch(
    packed_clean,
    *,
    w: int, mk: int, oi: int, ci: int, bk: int, lo: int, hi: int,
):
    """Batched twin of :func:`_chain_from_clean`: (B, k, H, ⌈W/8⌉) packed
    CLEANED masks → (B, L) per-image blobs [packed edges][packed skels].
    Every op is leading-dim batched and integer, so each row is byte-equal
    to the solo program's blob (the mesh-DP batch runner relies on this —
    parallel/batchrun.py)."""
    masks = bitunpack_rows(packed_clean, w) * jnp.uint8(255)
    b = packed_clean.shape[0]
    return _chain_tail(masks, mk, oi, ci, bk, lo, hi).reshape(b, -1)


@lru_cache(maxsize=8)
def _space_mesh(n: int):
    """One Mesh per shard count: a fresh Mesh object per image would miss
    the cached shard_map program (hash keyed on the mesh)."""
    from ..parallel import make_mesh  # noqa: PLC0415

    return make_mesh((n,), ("space",))


def _resolve_shard_n(cfg: PipelineConfig, h: int, w: int) -> int:
    """Row-shard count for the fused raster chain: 0 = unsharded.

    ``shard_rows`` N>0 explicitly requests the sharded program (fitted to
    the largest row-divisor ≤ min(N, device count); N=1 exercises the
    degenerate 1-device mesh).  ``shard_auto_mpx`` auto-engages over all
    devices when the resized image exceeds that many megapixels — the
    multi-device replacement for the reference's resolution cap."""
    from ..parallel.spatial import fit_shard_rows  # noqa: PLC0415

    req = int(getattr(cfg, "shard_rows", 0) or 0)
    auto = float(getattr(cfg, "shard_auto_mpx", 0) or 0)
    if req <= 0 and auto <= 0:
        return 0
    # largest stencil radius the sharded chain will run: edge-morph kernel,
    # Gaussian blur, Canny's 2-row sobel/NMS margin — outsized configured
    # kernels must shrink the shard count, not crash at trace time (the
    # halo slices clip below radius+1 rows per shard)
    mk, _oi, _ci, bk, _lo, _hi = edge_params(cfg)
    max_radius = max(2, mk // 2, bk // 2)
    ndev = len(jax.devices())
    if req > 0:
        n = fit_shard_rows(h, req, ndev, max_radius)
        if n < min(req, ndev) and max_radius * 2 + 1 > 17:
            print(
                f"[shard] note: stencil radius {max_radius} (configured edge "
                f"kernels) caps shards at {n} for H={h} (needs ≥{max_radius + 1} "
                "rows/shard)"
            )
        return n
    if h * w / 1e6 > auto:
        n = fit_shard_rows(h, ndev, ndev, max_radius)
        if n > 1:
            return n
    return 0


def _maybe_batcher(cfg: PipelineConfig, fuse: bool, shard_n: int):
    """The active mesh-DP batcher (parallel/batchrun.py), when this image's
    chain dispatch is eligible to join it: fused host-exact path and no
    spatial sharding requested (``shard_n`` precomputed by the caller —
    resolving it twice would duplicate the '[shard] note' print)."""
    if not fuse or shard_n >= 1:
        return None
    from ..parallel.batchrun import active_batcher  # noqa: PLC0415

    return active_batcher()


def _swatch_mode(cfg: PipelineConfig, img: np.ndarray) -> None:
    """Threshold ±tolerance around each swatch, trying both channel orders and
    keeping the better-covered mask (02:82-109)."""
    tol = int(cfg.color_tolerance)
    names: List[str] = list(cfg.color_names)
    colors = list(cfg.colors)
    if not colors or len(colors) < len(names):
        raise RuntimeError("swatch mode: 'colors' must have ≥ len(color_names) entries.")
    for i, name in enumerate(names):
        d = layer_dir(cfg, name)
        raw = tuple(int(v) for v in colors[i])
        for candidate in ((raw[2], raw[1], raw[0]), raw):  # RGB→BGR first, then as-is
            lo = np.maximum(np.array(candidate) - tol, 0).astype(np.uint8)
            hi = np.minimum(np.array(candidate) + tol, 255).astype(np.uint8)
            m = (np.all(img >= lo, axis=2) & np.all(img <= hi, axis=2)).astype(np.uint8) * 255
            if candidate == (raw[2], raw[1], raw[0]):
                best = m
            elif int(np.count_nonzero(m)) > int(np.count_nonzero(best)):
                best = m
        mask = np.asarray(morph_close(morph_open(best, "rect", 3, 1), "rect", 3, 1))
        write_image(os.path.join(d, "mask.png"), mask)
        print(f"Extracted (swatch): {name} | nz={int(np.count_nonzero(mask))}")
    print("Color extraction: done.")


def run(cfg: PipelineConfig) -> None:
    os.makedirs(cfg.output_dir, exist_ok=True)
    resized_path = os.path.join(cfg.output_dir, "resized.png")

    if cfg.extraction_mode.lower() == "swatch":
        _swatch_mode(cfg, read_image(resized_path))
        return

    if cfg.kmeans_init.lower() == "device":
        # device-resident handoff from stage 01 when available; disk otherwise
        img = fetch_device_artifact(resized_path)
        if img is None:
            img = read_image(resized_path)
    else:
        # host-exact mode works from the host pixels
        img = read_image(resized_path)

    names = list(cfg.color_names)
    k = cfg.resolve_cluster_k()

    h, w = img.shape[:2]
    n = h * w
    seed = int(cfg.kmeans_seed)
    limit = int(cfg.kmeans_sample_limit)
    attempts = int(cfg.kmeans_attempts)

    # when the runner chains straight into stages 03+04, fuse their device
    # work into this dispatch (edges + skeletons ride back bit-packed); the
    # per-stage programs remain the fallback for resume/partial runs
    from ..pipeline import chain_hint  # noqa: PLC0415

    fuse = {3, 4} <= chain_hint() and k == len(names)

    shard_requested = (
        int(getattr(cfg, "shard_rows", 0) or 0) > 0
        or float(getattr(cfg, "shard_auto_mpx", 0) or 0) > 0
    )
    if shard_requested and (cfg.kmeans_init.lower() == "device" or not fuse):
        print(
            "[shard] note: row sharding applies to the fused host-exact 02-04 "
            f"chain; this run (kmeans_init={cfg.kmeans_init!r}, fused={fuse}) "
            "uses the unsharded device programs"
        )

    w8 = (w + 7) // 8

    chain_packed = None
    if cfg.kmeans_init.lower() == "device":
        # fully-fused single dispatch; jax-PRNG sampling/seeding (CONFIG.md)
        blob_dev, masks_dev = _device_init_stage(
            img,
            k, int(cfg.kmeans_iters), attempts, limit, seed, fuse,
            *(edge_params(cfg) if fuse else (1, 0, 0, 3, 0, 0)),
            open_iters=int(cfg.extract_open_iters),
            close_iters=int(cfg.extract_close_iters),
        )
        blob = np.asarray(blob_dev)
        n_stats = k * 16
        stats = np.ascontiguousarray(blob[:n_stats]).view(np.float32).reshape(k, 4)
        centers = np.ascontiguousarray(stats[:, :3])
        counts0 = np.ascontiguousarray(stats[:, 3]).view(np.int32)
        packed = blob[n_stats : n_stats + k * h * w8].reshape(k, h, w8)
        if fuse:
            chain_packed = blob[n_stats + k * h * w8 :].reshape(2 * k, h, w8)

        def mask_of(cluster_idx: int) -> np.ndarray:
            m = np.unpackbits(packed[cluster_idx], axis=-1)[..., :w]
            m *= np.uint8(255)
            return m

        return _finish_kmeans(
            cfg, names, k, w, centers, counts0, mask_of,
            (lambda: chain_packed) if chain_packed is not None else None,
            masks_dev,
        )
    else:
        # host-exact: cv2's fixed-point uint8 Lab, the identical subsample
        # index stream (rng(42).choice, 02:41), the bit-exact cv2.kmeans
        # replication, and the reference's numpy assignment — byte-identical
        # to the reference on any input (photos included)
        lab = bgr2lab_u8(img)
        flat = lab.reshape(-1, 3)
        if n > limit:
            idx = np.random.default_rng(seed).choice(n, size=limit, replace=False)
            sample = flat[idx].astype(np.float32)
        else:
            sample = flat.astype(np.float32)
        _, _, centers = cv_kmeans(
            sample, k, max_count=int(cfg.kmeans_iters), epsilon=0.5, attempts=attempts
        )
        labels = assign_labels(flat, centers).reshape(h, w)
        counts0 = np.bincount(labels.ravel(), minlength=k).astype(np.int64)
        # the reference's 3×3 rect mask refine runs on the host
        # (_host_clean_masks); only the cleaned masks go to the device,
        # bit-packed (8 px/byte), and only when stages 03/04 are fused in
        masks8 = _host_clean_masks(
            labels, k, int(cfg.extract_open_iters), int(cfg.extract_close_iters)
        )

        if not fuse:
            # stage 02 standalone (resume/partial runs): pure host, no
            # device dispatch at all
            return _finish_kmeans(
                cfg, names, k, w, centers, counts0, lambda ci: masks8[ci], None, None
            )

        packed_np = np.stack([np.packbits(m > 0, axis=-1) for m in masks8])
        shard_n = _resolve_shard_n(cfg, h, w)
        batcher = _maybe_batcher(cfg, fuse, shard_n)
        if batcher is not None:
            # mesh-DP batch run: this image's chain dispatch joins its
            # siblings in one shard_map over the data axis (byte-identical
            # per image — parallel/batchrun.py).  The blocking rendezvous
            # runs on a side thread so this image's mask PNG writes overlap
            # its group's device round trip.
            def chain_submit():
                return batcher.run_chain(
                    packed_np, w, edge_params(cfg)
                ).reshape(2 * k, h, w8)

            return _finish_kmeans(
                cfg, names, k, w, centers, counts0, lambda ci: masks8[ci],
                _bg_fetch(chain_submit), None,
            )
        packed_clean = jnp.asarray(packed_np)
        if shard_n >= 1:
            from ..parallel.spatial import sharded_chain  # noqa: PLC0415

            print(f"[shard] raster chain row-sharded over {shard_n} device(s)")
            blob_dev = sharded_chain(_space_mesh(shard_n), packed_clean, w, *edge_params(cfg))
        else:
            blob_dev = _chain_from_clean(packed_clean, w, *edge_params(cfg))
        # dispatch is in flight; fetch on a side thread so the PNG writes +
        # palette below overlap the device compute and the download
        return _finish_kmeans(
            cfg, names, k, w, centers, counts0, lambda ci: masks8[ci],
            _bg_fetch(lambda: np.asarray(blob_dev).reshape(2 * k, h, w8)), None,
        )


def _bg_fetch(fn):
    """Run ``fn`` on a daemon thread now; return a join-and-reraise callable.
    The body waits on the device, so the overlapped host work proceeds."""
    import threading  # noqa: PLC0415

    box: dict = {}

    def work():
        try:
            box["v"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised at join
            box["e"] = e

    t = threading.Thread(target=work, name="pw-chain-fetch", daemon=True)
    t.start()

    def join():
        t.join()
        if "e" in box:
            raise box["e"]
        return box["v"]

    return join


def _finish_kmeans(cfg, names, k, w, centers, counts0, mask_of, chain_fetch, masks_dev):
    """Shared tail of every k-means variant: dark→light relabel, mask PNG
    writes, chain/device artifact registration, palette JSON.

    ``mask_of(cluster_idx)`` returns the CLEANED dense 0/255 mask for an
    original cluster id; ``chain_fetch`` (when fused) joins the in-flight
    edges+skels fetch → (2k, H, ⌈W/8⌉) packed — called AFTER the PNG writes
    so the host work overlaps the device round trip.  ``masks_dev`` may be
    None (host-exact paths keep no device copy — stages 03/04 consume the
    registered chain blob instead)."""
    # relabel dark→light by the L channel (reference 02:120-127)
    order = np.argsort(centers[:, 0])
    counts = [int(c) for c in counts0[order]]
    centers = centers[order]

    names_sorted = sorted(names, key=darkness_rank)

    # each layer's PNG write is threaded — the encode is the stage's host
    # cost at 4K and zlib releases the GIL
    def write_mask(cluster_idx: int, name: str):
        d = layer_dir(cfg, name)
        mask = mask_of(int(order[cluster_idx]))
        mask_path = os.path.join(d, "mask.png")
        write_image(mask_path, mask)
        return mask_path, int(np.count_nonzero(mask))

    written = thread_map(lambda t: write_mask(*t), list(enumerate(names_sorted[:k])))

    if chain_fetch is not None:
        # hand stage 03/04 their precomputed outputs, permuted from cluster
        # order to cfg.color_names order, keyed to the mask files just written
        ch = chain_fetch()  # (2k, H, ceil(W/8)): edges rows, then skeleton rows
        name_to_cluster = {nm: int(order[j]) for j, nm in enumerate(names_sorted[:k])}
        perm = [name_to_cluster[nm] for nm in names]
        mask_paths = [os.path.join(layer_dir(cfg, nm), "mask.png") for nm in names]
        register_derived_artifact(
            chain_key(cfg, "edges+skels"),
            mask_paths,
            (np.ascontiguousarray(ch[:k][perm]), np.ascontiguousarray(ch[k:][perm]), w),
        )

    palette = {}
    for cluster_idx, name in enumerate(names_sorted[:k]):
        mask_path, nz = written[cluster_idx]
        # device-resident copy for stage 03 (identical values to the PNG)
        if masks_dev is not None:
            register_device_artifact(mask_path, masks_dev[int(order[cluster_idx])])

        # reference truncates: centers_lab[k].astype(np.uint8) → cv2 Lab2BGR
        # on the 1×1 uint8 image (02:58-61,159); int() below truncates too
        center_lab = centers[cluster_idx].astype(np.uint8)
        bgr_px = lab2bgr_u8(center_lab)
        bgr = (int(bgr_px[0]), int(bgr_px[1]), int(bgr_px[2]))
        palette[name] = {
            "mode": "kmeans",
            "cluster_index": int(cluster_idx),
            "cluster_lab": [int(v) for v in center_lab],
            "approx_bgr": list(bgr),
            "pixels": counts[cluster_idx],
            "mask_nonzero": nz,
        }
        print(
            f"Extracted (kmeans): {name} | cluster={cluster_idx} | "
            f"L*={centers[cluster_idx, 0]:.1f} | pixels={counts[cluster_idx]} | nz={nz}"
        )

    pal_path = os.path.join(cfg.output_dir, "palette_by_name.json")
    save_json(palette, pal_path)
    print(f"Palette saved: {pal_path}")
    print("Color extraction: done.")
