#!/usr/bin/env python3
"""Split the frontend's 50-dispatch window into device compute vs
dispatch-gap time, and estimate the memory-bandwidth roofline of the fused
stage-01–04 chain (`ops/frontend.py::raster_frontend`).

Three measurements on the default backend (run on the GPU):

1. sustained  — bench.py --frontend's loop shape: N async dispatches ended
   by ``block_until_ready``.  Per-dispatch time includes host dispatch gaps.
2. device-only — ONE dispatch running K chained iterations inside
   `lax.fori_loop`; the input is perturbed with the loop index each
   iteration so XLA cannot hoist the (loop-invariant) chain out of the
   loop.  Per-iteration time is device compute: no per-iteration dispatch.
3. cost analysis — XLA's own `compiled.cost_analysis()` bytes-accessed and
   flop counts for the single-shot program → bytes/Mpx and the
   bandwidth-bound floor at the card's published peak bandwidth.

Prints a short table + a JSON line.

Usage: python tests/tools/profile_frontend.py [--iters 50] [--loop-k 10]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

# published peak memory bandwidth (GB/s) by jax device_kind.  Source: NVIDIA
# H100 data sheet, SXM part (3.35 TB/s HBM3).  A device not listed is an
# error, not a default.
PEAK_HBM_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}


def synth_image(h: int = 2000, w: int = 1500) -> np.ndarray:
    rng = np.random.default_rng(7)
    img = np.empty((h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img[..., 0] = (yy * 255 // h).astype(np.uint8)
    img[..., 1] = (xx * 255 // w).astype(np.uint8)
    img[..., 2] = ((yy + xx) % 256).astype(np.uint8)
    noise = rng.integers(0, 40, (h, w, 3), np.uint8)
    return img ^ noise


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--loop-k", type=int, default=10)
    args = ap.parse_args()

    import plotweave  # noqa: F401 — persistent compile cache
    import jax
    import jax.numpy as jnp

    from plotweave.ops.frontend import raster_frontend

    print(f"backend: {jax.default_backend()}")
    img = synth_image()
    h, w = img.shape[:2]
    mpx = h * w / 1e6
    centers = np.array(
        [[40, 128, 128], [110, 140, 120], [180, 150, 140], [240, 128, 126]],
        np.float32,
    )

    kind = jax.devices()[0].device_kind
    if kind not in PEAK_HBM_GBPS:
        raise SystemExit(f"no published peak bandwidth for device kind {kind!r}")
    peak = PEAK_HBM_GBPS[kind]

    def fetch(out):
        return jax.block_until_ready(out)

    dev_img = jax.device_put(img)
    dev_ctr = jax.device_put(centers)

    # ---- 3. XLA cost analysis of the single-shot program -----------------
    shot = jax.jit(partial(raster_frontend, k=4))
    compiled = shot.lower(dev_img, dev_ctr).compile()
    ca = compiled.cost_analysis() or {}
    if isinstance(ca, (list, tuple)):  # older jax returns [dict]
        ca = ca[0] if ca else {}
    bytes_acc = float(ca.get("bytes accessed", 0.0))
    flops = float(ca.get("flops", 0.0))

    # ---- 1. sustained: async dispatch queue + one trailing fetch ---------
    fetch(shot(dev_img, dev_ctr))  # warm
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = shot(dev_img, dev_ctr)
    fetch(out)
    t_sustained = (time.perf_counter() - t0) / args.iters

    # ---- 2. device-only: K chained iterations in ONE dispatch ------------
    @jax.jit
    def k_loop(image, ctr, k_iters):
        def body(i, acc):
            # perturb one byte-plane with the loop index: the chain's input
            # now depends on i, so LICM cannot hoist the whole body
            im = image.at[0, 0, 0].set((image[0, 0, 0] + i).astype(jnp.uint8))
            edges, skel = raster_frontend(im, ctr, k=4)
            return acc + jnp.sum(edges, dtype=jnp.int32) + jnp.sum(skel)

        return jax.lax.fori_loop(0, k_iters, body, jnp.int32(0))

    fetch(k_loop(dev_img, dev_ctr, 1))  # warm/compile
    # baseline the loop overhead with k=1, then the marginal cost of k more
    t0 = time.perf_counter()
    fetch(k_loop(dev_img, dev_ctr, 1))
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    fetch(k_loop(dev_img, dev_ctr, 1 + args.loop_k))
    t_many = time.perf_counter() - t0
    t_device = (t_many - t_one) / args.loop_k

    gap = t_sustained - t_device
    bw = bytes_acc / t_device / 1e9 if t_device > 0 else 0.0
    sol = bytes_acc / (peak * 1e9)  # bandwidth-bound floor

    print(f"image: {w}x{h} = {mpx:.2f} Mpx, fused 01-04 chain k=4")
    print(f"sustained   : {t_sustained * 1e3:8.2f} ms/dispatch  ({mpx / t_sustained:8.1f} Mpx/s)")
    print(f"device-only : {t_device * 1e3:8.2f} ms/iter      ({mpx / t_device:8.1f} Mpx/s)")
    print(f"dispatch gap: {gap * 1e3:8.2f} ms  ({100 * gap / t_sustained:.0f}% of sustained)")
    print(f"XLA bytes accessed: {bytes_acc / 1e6:.1f} MB  ({bytes_acc / mpx / 1e6:.1f} MB/Mpx)")
    print(f"XLA flops: {flops / 1e9:.2f} GFLOP")
    print(f"achieved HBM BW (device-only): {bw:.0f} GB/s  (peak {peak:.0f}, {kind})")
    print(f"bandwidth speed-of-light: {sol * 1e3:.2f} ms/iter ({mpx / sol:.0f} Mpx/s)")
    print(
        json.dumps(
            {
                "sustained_ms": round(t_sustained * 1e3, 2),
                "device_only_ms": round(t_device * 1e3, 2),
                "gap_ms": round(gap * 1e3, 2),
                "bytes_accessed_mb": round(bytes_acc / 1e6, 1),
                "gflop": round(flops / 1e9, 2),
                "achieved_gbps": round(bw, 0),
                "sol_ms": round(sol * 1e3, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
