"""[04] Vectorization: edges → skeleton → centerline polylines →
<layer>/contours.pkl (reference 04_find_contours.py).

Thinning runs layer-batched on device (each layer converges independently
inside its own while_loop under vmap); tracing — sequential by nature — runs
on host per component.
"""

from __future__ import annotations

import os
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig
from ..ops.bitpack import bitpack_rows, unpack_rows
from ..ops.thinning import zhang_suen
from ..utils import (fetch_derived_artifact, fetch_device_artifact,
                     read_image, save_pickle, thread_map)
from ..vector.trace import trace_skeleton_fast
from .common import chain_key, layer_dir


@partial(jax.jit, static_argnames=())
def _thin_batched(edges):
    # natively layer-batched; bit-packed output (8 px/byte d2h transfer)
    return bitpack_rows(zhang_suen(edges, max_iter=120, rotated=True))


def run(cfg: PipelineConfig) -> None:
    names = list(cfg.color_names)

    t0 = time.perf_counter()
    fused = fetch_derived_artifact(chain_key(cfg, "skels"), pop=True)
    if fused is not None:
        # skeletons precomputed by the fused 02→04 chain, validated against
        # the edges.png files on disk — zero device work here
        packed_skels, w = fused
        skeletons = unpack_rows(packed_skels, w)
        print(f"[vectorize] thinning (fused-chain handoff, {len(names)} layers)")
    else:
        edge_imgs = []
        all_dev = True
        for name in names:
            p = os.path.join(cfg.output_dir, name, "edges.png")
            e = fetch_device_artifact(p)
            if e is None:
                all_dev = False
                if not os.path.exists(p):
                    raise FileNotFoundError(f"Edges not found: {p}")
                e = read_image(p, gray=True)
            edge_imgs.append(e)

        if all_dev:
            batch = jnp.stack(edge_imgs, axis=0)
        else:
            batch = np.stack([np.asarray(e) for e in edge_imgs], axis=0)
        skeletons = unpack_rows(_thin_batched(batch), batch.shape[-1])
        print(f"[vectorize] thinning (batched, {len(names)} layers): {time.perf_counter() - t0:.2f}s")

    min_len = int(cfg.thinning_min_segment_len)

    # inside a pipeline chain the ~60 MB contours.pkl dumps go write-behind
    # (the dominant cost of this stage — bench_s04_split); run_pipeline's
    # finally flushes them before any resume boundary.  Standalone stage
    # invocations (tests, --start-step debugging) keep synchronous writes.
    from ..pipeline import chain_hint  # noqa: PLC0415
    from ..utils.io import save_pickle_async  # noqa: PLC0415

    save = save_pickle_async if chain_hint() else save_pickle

    # layers are independent — trace them concurrently (the native walker,
    # scipy labelling and pickle writes all release the GIL); output identical
    def trace_one(args):
        name, skel = args
        t1 = time.perf_counter()
        paths = trace_skeleton_fast(skel)  # 0/1 uint8: tracers accept any nonzero
        paths = [p for p in paths if len(p) >= min_len]
        out = os.path.join(layer_dir(cfg, name), "contours.pkl")
        save(paths, out)
        return f"[{name}] traced {len(paths)} polylines in {time.perf_counter() - t1:.2f}s → {out}"

    for line in thread_map(trace_one, list(zip(names, skeletons))):
        print(line)
