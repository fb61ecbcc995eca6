"""[03] Edge detection → <layer>/edges.png + edges_composite.png.

Per layer: ellipse-kernel open/close, Gaussian blur, Canny (reference
03_edge_detect.py:13-40).  Where the reference forks a process pool across
layers, the whole chain here is one jitted, layer-batched (vmap) device
program — the device replacement for its only multiprocessing.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import numpy as np

from ..config import PipelineConfig
from ..ops.bitpack import bitpack_rows, unpack_rows
from ..ops.canny import canny
from ..ops.filters import gaussian_blur_u8
from ..utils import (
    fetch_derived_artifact,
    fetch_device_artifact,
    read_image,
    register_derived_artifact,
    register_device_artifact,
    thread_map,
    write_image,
)
from .common import chain_key, edge_params, layer_dir, palette_bgr


@partial(jax.jit, static_argnames=("mk", "oi", "ci", "bk", "lo", "hi"))
def _edges_batched(masks, mk: int, oi: int, ci: int, bk: int, lo: int, hi: int):
    """(L, H, W) masks → (L, H, W) edges; the ops are natively layer-batched.
    Edges come back both packed (8 px/byte for the host transfer) and
    unpacked (device-resident, handed to stage 04)."""
    from .s02_color_extract import _binary_morph_u8  # noqa: PLC0415

    m = _binary_morph_u8(masks, masks.shape[-1], oi, ci, "ellipse", mk)
    e = canny(gaussian_blur_u8(m, bk), lo, hi)
    return bitpack_rows(e), e


def run(cfg: PipelineConfig) -> None:
    import jax.numpy as jnp  # noqa: PLC0415

    names = list(cfg.color_names)

    # fused-chain fast path: stage 02 already computed edges (and skeletons)
    # in its own dispatch; validate against the mask files and skip the
    # device entirely
    mask_paths = [os.path.join(cfg.output_dir, n, "mask.png") for n in names]
    fused = fetch_derived_artifact(chain_key(cfg, "edges+skels"), pop=True)
    edges_dev = None
    if fused is not None:
        packed_edges, packed_skels, w = fused
        edges = unpack_rows(packed_edges, w) * np.uint8(255)
    else:
        masks = []
        all_dev = True
        for name, p in zip(names, mask_paths):
            m = fetch_device_artifact(p)
            if m is None:
                all_dev = False
                if not os.path.exists(p):
                    raise FileNotFoundError(f"Mask not found: {p}")
                m = read_image(p, gray=True)
            masks.append(m)
        batch = jnp.stack(masks, axis=0) if all_dev else np.stack([np.asarray(m) for m in masks], axis=0)
        packed_dev, edges_dev = _edges_batched(batch, *edge_params(cfg))
        edges = unpack_rows(packed_dev, batch.shape[-1]) * np.uint8(255)
        packed_skels = None

    # PNG encode dominates the host cost at large sizes; zlib releases the GIL
    def write_one(i_name):
        i, name = i_name
        out = os.path.join(layer_dir(cfg, name), "edges.png")
        write_image(out, edges[i])
        return out, int(np.count_nonzero(edges[i]))

    results = thread_map(write_one, list(enumerate(names)))

    edges_by_name = {}
    for i, (name, (out, nz)) in enumerate(zip(names, results)):
        if edges_dev is not None:
            register_device_artifact(out, edges_dev[i])
        edges_by_name[name] = edges[i]
        print(f"Edges extracted: {name} | nz={nz}")

    if packed_skels is not None:
        # republish the precomputed skeletons keyed to the edge files just
        # written — stage 04 consumes them with zero device work
        register_derived_artifact(
            chain_key(cfg, "skels"),
            [r[0] for r in results],
            (packed_skels, edges.shape[-1]),
        )

    _composite(cfg, names, edges_by_name)


def _composite(cfg: PipelineConfig, names, edges_by_name=None) -> None:
    """Overlay per-layer edges in layer colors on white (03:60-111).

    Keeps the reference's palette quirk: it looks up key "bgr", which the
    stage-02 palette never writes, so colors always fall back to cfg.colors.
    """
    edges_by_name = edges_by_name or {}
    try:
        base = read_image(os.path.join(cfg.output_dir, "resized.png"))
        h, w = base.shape[:2]
    except FileNotFoundError:
        h = w = None
        for name in names:
            p = os.path.join(cfg.output_dir, name, "edges.png")
            if os.path.exists(p):
                e = read_image(p, gray=True)
                h, w = e.shape[:2]
                break
        if h is None:
            raise FileNotFoundError("No edges found to build edges_composite.png")
    canvas = np.full((h, w, 3), 255, np.uint8)
    colors = palette_bgr(cfg, key="bgr")
    for name in names:
        e = edges_by_name.get(name)
        if e is None:
            p = os.path.join(cfg.output_dir, name, "edges.png")
            if not os.path.exists(p):
                continue
            e = read_image(p, gray=True)
        m = e > 0
        if m.any():
            canvas[m] = colors[name]
    out = os.path.join(cfg.output_dir, "edges_composite.png")
    write_image(out, canvas)
    print(f"Edges composite saved: {out}")
