#!/usr/bin/env python3
"""Benchmark: end-to-end image→stream Mpx/s on the GPU.

Default: the full 13-stage pipeline on a seeded 1024×768, 4-colour image
(one warm-up run, then two timed runs, each with per-stage wall times).
``--frontend`` instead times the fused stage-01–04 device program
(``ops.frontend.raster_frontend``) on a 2000×1500 image, 50 back-to-back
dispatches ended by ``block_until_ready``.

Every result line names the device it ran on.  Without a GPU the script
prints an error line and exits 1: a measurement never falls back to the CPU.
The last line of standard output is one JSON object.

    python bench.py [--frontend] [--device-init]
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np


def _emit(obj: dict, rc: int) -> None:
    print(json.dumps(obj), flush=True)
    sys.exit(rc)


def _device() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def _card() -> str:
    """nvidia-smi's name and power limit of the card (recorded beside every
    number: a card below its full power limit runs slower under load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({type(e).__name__})"
    return out.splitlines()[0] if out else "unknown"


def bench_e2e(device_init: bool, dev: dict) -> dict:
    from plotweave.config import load_config
    from plotweave.demo.poster import PALETTE, synth_poster
    from plotweave.pipeline import run_pipeline, stage_clock
    from plotweave.utils import write_image

    metric = "e2e_image_to_stream_megapixels_per_sec"
    h, w = 768, 1024
    base = tempfile.mkdtemp(prefix="pw_bench_")
    try:
        write_image(os.path.join(base, "img.png"), synth_poster(h, w, n_colors=4, seed=7))

        def run(tag: str):
            out = os.path.join(base, tag)
            os.makedirs(out)
            cfg_d = {
                "input_image": os.path.join(base, "img.png"), "output_dir": out,
                "colors": PALETTE[:4].tolist(),
                "color_names": ["layer_dark", "layer_mid", "layer_skin", "layer_light"],
                "edge_low_threshold": 22, "edge_high_threshold": 70, "edge_kernel_size": 7,
                "pixels_per_mm": 4, "pen_width_px": 12, "pen_radius_px": 6,
            }
            if device_init:
                cfg_d["kmeans_init"] = "device"
            with open(os.path.join(out, "config.json"), "w", encoding="utf-8") as f:
                json.dump(cfg_d, f)
            with stage_clock() as clock:
                t0 = time.perf_counter()
                run_pipeline(load_config(os.path.join(out, "config.json")), 1, 13)
                dt = time.perf_counter() - t0
            print(f"[bench] {tag}: {dt:.4f} s  stages "
                  + " ".join(f"{k[:3]}={v:.4f}" for k, v in sorted(clock.items())), flush=True)
            return dt

        warm = run("warmup")
        timed = [run("timed1"), run("timed2")]
    finally:
        shutil.rmtree(base, ignore_errors=True)
    mpx = h * w / 1e6
    return {"metric": metric, "value": mpx / min(timed), "unit": "Mpx/s",
            "runs_s": timed, "warmup_s": warm, "device": dev}


def bench_frontend(dev: dict) -> dict:
    import jax

    from plotweave.demo.poster import synth_poster
    from plotweave.ops.frontend import raster_frontend

    img = synth_poster(1500, 2000, n_colors=4, seed=0)
    centers = np.array([[40, 128, 128], [110, 140, 120], [180, 150, 140], [240, 128, 126]], np.float32)
    dev_img, dev_ctr = jax.device_put(img), jax.device_put(centers)
    t0 = time.perf_counter()
    jax.block_until_ready(raster_frontend(dev_img, dev_ctr, k=4))
    compile_s = time.perf_counter() - t0
    iters = 50
    t0 = time.perf_counter()
    for _ in range(iters):
        out = raster_frontend(dev_img, dev_ctr, k=4)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    return {"metric": "raster_frontend_megapixels_per_sec", "value": img.shape[0] * img.shape[1] / 1e6 / dt,
            "unit": "Mpx/s", "ms_per_dispatch": dt * 1e3, "compile_s": compile_s, "device": dev}


def main() -> None:
    dev = _device()
    if dev["platform"] != "gpu":
        _emit({"error": f"no GPU: JAX's default device is {dev['platform']}", "device": dev}, 1)
    print(f"[bench] card: {_card()}", flush=True)
    if "--frontend" in sys.argv:
        _emit(bench_frontend(dev), 0)
    _emit(bench_e2e("--device-init" in sys.argv, dev), 0)


if __name__ == "__main__":
    main()
