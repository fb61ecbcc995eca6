#!/usr/bin/env python3
"""End-to-end smoke test of plotweave on NVIDIA GPUs.

    python chip_smoke.py                # one card: phases a-f
    python chip_smoke.py --four-cards   # four cards: the multi-device path only

Phases (one process; each prints its result, a failed phase fails the run):

a. preflight: card name and power limit, JAX version and devices, the native
   library built from the committed sources, and an import blocker for
   cv2 / PIL / pygame / matplotlib that every later phase runs under.
b. goldens: the four committed e2e configurations through run_pipeline on
   the card, every artifact equal to the reference tarballs (streams and
   pickles exactly, PNGs by decoded pixels).
c. real-size job: a seeded 3840×2160 8-colour poster through the CLI entry
   (steps 01-14, defaults): compile and warm times per stage, device memory,
   the fused raster chain checked exactly against the same program on the
   CPU backend, the stream replayed cleanly and identical across warm runs.
d. device planner: a 20,000-contour plan with exact and near ties, ordered
   on the card and by the native host planner; orders and flips identical.
e. device refiner: a dense line-art job under --preset quality; travel no
   longer than the greedy tour, printed beside the host refiner's.
f. kmeans_init "device": the fused k-means program on the card against the
   CPU backend (centres within 1e-2 Lab, labels within 0.01 %).
g. --four-cards: batch mode over 4 cards (9 mixed-shape images) and the
   row-sharded chain on a 2160×3840 8-layer plane, byte-equal to one card.

Without a GPU, or outside a plotweave checkout, it exits non-zero and prints
no result.  The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.abc
import json
import os
import pickle
import shutil
import subprocess
import sys
import tarfile
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BLOCKED = ("cv2", "PIL", "pygame", "matplotlib")
GOLDEN = HERE / "tests" / "golden" / "e2e"
GOLDEN_CONFIGS = [
    ("base_cfg.json", "ref_artifacts.tar.gz"),
    ("base_cfg2.json", "ref_artifacts2.tar.gz"),
    ("cfg3_8layers.json", "ref_artifacts3.tar.gz"),
    ("cfg4_gray1layer.json", "ref_artifacts4.tar.gz"),
]


class Failed(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise Failed(msg)


class _ImportBlocker(importlib.abc.MetaPathFinder):
    """Refuses the optional GUI/imaging packages: the main path must run on
    numpy, scipy, JAX and the native library alone."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked: the main path must not import it")
        return None


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- helpers


def _same_pickle(a: Path, b: Path) -> bool:
    A = pickle.loads(a.read_bytes())
    B = pickle.loads(b.read_bytes())
    if len(A) != len(B):
        return False
    for x, y in zip(A, B):
        if isinstance(x, dict):
            if x["type"] != y["type"]:
                return False
            if x["type"] == "line" and not np.array_equal(x["points"], y["points"]):
                return False
            if x["type"] != "line" and (x["x"], x["y"]) != (y["x"], y["y"]):
                return False
        elif not np.array_equal(np.asarray(x), np.asarray(y)):
            return False
    return True


def _png_pixels(p: Path) -> np.ndarray:
    from plotweave.utils.png import decode_png

    data = p.read_bytes()
    # colour type byte of IHDR: 0 = gray
    return decode_png(data, gray=data[25] == 0)


def compare_trees(ref: Path, mine: Path) -> list:
    """Every reference artifact against ours; returns the mismatches."""
    bad = []
    n = 0
    for r in sorted(ref.rglob("*")):
        if r.is_dir() or r.name == "config.json":
            continue
        m = mine / r.relative_to(ref)
        n += 1
        if not m.exists():
            bad.append(f"missing {m.relative_to(mine)}")
        elif r.suffix == ".png":
            a, b = _png_pixels(r), _png_pixels(m)
            if a.shape != b.shape or not np.array_equal(a, b):
                bad.append(f"pixels differ: {m.relative_to(mine)}")
        elif r.suffix == ".pkl":
            if not _same_pickle(r, m):
                bad.append(f"pickle differs: {m.relative_to(mine)}")
        elif r.suffix == ".json":
            if json.loads(r.read_text()) != json.loads(m.read_text()):
                bad.append(f"json differs: {m.relative_to(mine)}")
        elif r.read_bytes() != m.read_bytes():
            bad.append(f"bytes differ: {m.relative_to(mine)}")
    check(n > 0, f"empty reference tree {ref}")
    return bad


def stream_clean(out: Path) -> tuple:
    from plotweave.stream.decoder import StreamDecoder, replay

    data = (out / "plot_stream.bin").read_bytes()
    dec = StreamDecoder(data)
    man = json.loads((out / "vector_manifest.json").read_text())
    w, h = man["image_size"]
    replay(dec, w, h)
    return data, dec.stats.eof_seen, dec.stats.off_canvas_steps


# ---------------------------------------------------------------- phases


def phase_goldens(work: Path) -> str:
    from plotweave.config import load_config
    from plotweave.pipeline import run_pipeline

    for cfg_name, tar_name in GOLDEN_CONFIGS:
        base = work / cfg_name.replace(".json", "")
        ref, mine = base / "ref", base / "mine"
        ref.mkdir(parents=True)
        mine.mkdir()
        with tarfile.open(GOLDEN / tar_name) as tf:
            tf.extractall(ref, filter="data")
        cfg = json.loads((GOLDEN / cfg_name).read_text())
        cfg["input_image"] = str(GOLDEN / Path(cfg["input_image"]).name)
        cfg["output_dir"] = str(mine)
        (mine / "config.json").write_text(json.dumps(cfg))
        t0 = time.perf_counter()
        run_pipeline(load_config(str(mine / "config.json")), 1, 13)
        dt = time.perf_counter() - t0
        bad = compare_trees(ref, mine)
        check(not bad, f"{cfg_name}: {len(bad)} mismatches, first: {bad[:5]}")
        log(f"[b] {cfg_name}: all artifacts identical to the reference ({dt:.1f} s incl. compile)")
    return f"{len(GOLDEN_CONFIGS)}/{len(GOLDEN_CONFIGS)} goldens identical"


def phase_real_size(work: Path, card: str, seed: int, size=(2160, 3840)) -> str:
    import jax

    from plotweave.config import PipelineConfig
    from plotweave.demo.poster import synth_poster
    from plotweave.ops.resize import area_resize
    from plotweave.pipeline import main, stage_clock
    from plotweave.stages.common import edge_params
    from plotweave.stages.s02_color_extract import _chain_from_clean
    from plotweave.utils import read_image, write_image

    img_path = work / "poster.png"
    poster = synth_poster(*size, n_colors=8, seed=seed)
    scale = 2000 / max(size)
    rh, rw = int(size[0] * scale), int(size[1] * scale)
    write_image(str(img_path), poster)
    os.environ.pop("DISPLAY", None)  # step 14 renders headless
    runs = []
    for tag in ("compile", "warm1", "warm2"):
        out = work / f"real_{tag}"
        with stage_clock() as clock:
            t0 = time.perf_counter()
            main([str(img_path), "--output", str(out)])
            dt = time.perf_counter() - t0
        data, eof, off = stream_clean(out)
        check(eof and off == 0, f"{tag}: stream replay eof={eof} off_canvas={off}")
        runs.append(data)
        stages = " ".join(f"{k[:3]}={v:.3f}" for k, v in sorted(clock.items()))
        log(f"[c] {tag}: {dt:.3f} s wall [{card}]; stages(s): {stages}")
    check(runs[1] == runs[2], "warm runs produced different streams")
    log(f"[c] stream {len(runs[1])} bytes, replay clean (EOF, 0 off-canvas), warm runs identical")

    cfg = PipelineConfig()
    out = work / "real_warm1"
    resized = read_image(str(out / "resized.png"))
    check(resized.shape == (rh, rw, 3), f"resized shape {resized.shape}")
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        r_cpu = np.asarray(area_resize(poster, rw, rh))
    check(np.array_equal(r_cpu, resized), "step-01 resize differs between the card and the CPU backend")

    params = edge_params(cfg)
    masks = [read_image(str(out / n / "mask.png"), gray=True) for n in cfg.color_names]
    packed = np.ascontiguousarray(np.stack([np.packbits(m > 0, axis=-1) for m in masks]))
    t0 = time.perf_counter()
    gpu_blob = np.asarray(jax.block_until_ready(_chain_from_clean(packed, rw, *params)))
    t_gpu = time.perf_counter() - t0
    cpu_blob = np.asarray(_chain_from_clean(jax.device_put(packed, cpu), rw, *params))
    check(np.array_equal(gpu_blob, cpu_blob), "fused raster chain differs between the card and the CPU backend")
    log(f"[c] fused chain blob ({len(gpu_blob)} B) identical on the card and the CPU backend "
        f"(card call {t_gpu * 1e3:.1f} ms incl. transfer)")

    log("[c] " + fixpoint_profile(packed, rw, params, gpu_blob))

    k8 = jax.ShapeDtypeStruct((8, rh, (rw + 7) // 8), np.uint8)
    mem = _chain_from_clean.lower(k8, rw, *params).compile().memory_analysis()
    log(f"[c] _chain_from_clean (8,{rh},{rw}) memory_analysis: {mem}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[c] peak_bytes_in_use={stats.get('peak_bytes_in_use')} [{card}]")
    return "real-size job ok"


def fixpoint_profile(packed: np.ndarray, w: int, params, blob: np.ndarray) -> str:
    """What XLA makes of the fused chain at this width: its warm time per
    call, and the two data-dependent fixpoints (Canny hysteresis, Zhang–Suen
    thinning) stepped one iteration per dispatch — their trip counts and
    per-step times.  The stepped result must equal the chain's skeletons."""
    import jax
    import jax.numpy as jnp

    from plotweave.ops.bitpack import bitpack_rows, bitunpack_rows
    from plotweave.ops.canny import canny_boards, hysteresis_step
    from plotweave.ops.filters import gaussian_blur_u8
    from plotweave.ops.thinning import thinning_step, unpack_bitboards
    from plotweave.stages.s02_color_extract import _binary_morph_u8, _chain_from_clean

    mk, oi, ci, bk, lo, hi = params
    dev = jax.device_put(packed)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        jax.block_until_ready(_chain_from_clean(dev, w, *params))
        times.append(time.perf_counter() - t0)
    chain_ms = 1e3 * float(np.median(times))

    @jax.jit
    def boards(p):
        masks = bitunpack_rows(p, w) * jnp.uint8(255)
        m = _binary_morph_u8(masks, w, oi, ci, "ellipse", mk)
        return canny_boards(gaussian_blur_u8(m, bk), lo, hi)

    def run_steps(step, x, limit):
        n, changed = 0, True
        t0 = time.perf_counter()
        while changed and n < limit:
            x, ch = step(x)
            changed = bool(ch)
            n += 1
        return x, n, time.perf_counter() - t0

    candb, strongb = jax.block_until_ready(boards(dev))
    h_step = jax.jit(hysteresis_step)
    t_step = jax.jit(lambda x: thinning_step(x, True))
    run_steps(lambda e: h_step(candb, e), strongb, 2)  # compile both step programs
    run_steps(t_step, strongb, 1)
    edges, n_h, t_h = run_steps(lambda e: h_step(candb, e), strongb, 1 << 20)
    skel, n_t, t_t = run_steps(t_step, edges, 120)
    skel_rows = np.asarray(bitpack_rows(unpack_bitboards(skel, w).astype(jnp.uint8)))
    half = blob.size // 2
    check(np.array_equal(skel_rows.reshape(-1), blob[half:]), "stepped fixpoints differ from the chain")
    return (f"chain {chain_ms:.2f} ms/call warm (median of 10); hysteresis {n_h} steps "
            f"({2 * n_h} sweeps) at {1e3 * t_h / n_h:.3f} ms/step when stepped from the host; "
            f"thinning {n_t} iterations at {1e3 * t_t / n_t:.3f} ms/iteration when stepped")


def phase_planner(seed: int) -> str:
    import jax

    from plotweave.vector.planner_device import device_planner_eligible, greedy_order_device
    from plotweave.vector.sort import _greedy_order_native, sort_contours

    rng = np.random.default_rng(seed)
    n = 20000
    starts = rng.integers(0, 11881, (n, 2))
    ends = starts + rng.integers(-40, 41, (n, 2))
    # exact ties: repeated endpoints; near ties: neighbours one step apart
    dup = rng.choice(n, n // 10, replace=False)
    starts[dup] = starts[rng.choice(n, n // 10)]
    near = rng.choice(n, n // 10, replace=False)
    starts[near] = starts[rng.choice(n, n // 10)] + rng.integers(-1, 2, (n // 10, 2))
    starts = np.clip(starts, 0, 11880).astype(np.float32)
    ends = np.clip(ends, 0, 11880).astype(np.float32)
    closed = rng.random(n) < 0.2
    check(device_planner_eligible(), "device planner gate does not engage on this backend")
    for closed_aware in (True, False):
        s0 = int(rng.integers(0, n))
        t0 = time.perf_counter()
        dev = greedy_order_device(starts, ends, closed, closed_aware, s0)
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = _greedy_order_native(starts, ends, closed, closed_aware, s0)
        t_host = time.perf_counter() - t0
        check(dev is not None and host is not None, "planner returned no order")
        check(dev[0] == host[0] and dev[1] == host[1],
              f"device planner differs from host (closed_aware={closed_aware}): first diff at "
              f"{next((i for i, (a, b) in enumerate(zip(dev[0], host[0])) if a != b), None)}")
        log(f"[d] n={n} closed_aware={closed_aware}: orders+flips identical "
            f"(card {t_dev:.3f} s incl. compile, host {t_host:.3f} s)")
    polys = [np.stack([s, e]).astype(np.int32).reshape(-1, 1, 2) for s, e in zip(starts, ends)]
    a = sort_contours(polys)
    b = sort_contours(polys, device_min_n=4500)
    check(len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)),
          "sort_contours differs with the device gate engaged")
    log(f"[d] vector.sort with the gate engaged ({jax.default_backend()}) == host order")
    return "device planner identical to host"


def line_art(h: int, w: int, seed: int, n: int = 1400) -> np.ndarray:
    """Dense short strokes in two inks on a light ground (≥600 ops/layer)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 235, np.uint8)
    inks = np.array([[20, 20, 20], [40, 60, 200]], np.uint8)
    for i in range(n):
        x0, y0 = rng.integers(8, w - 48), rng.integers(8, h - 48)
        ang = rng.random() * np.pi
        length = int(rng.integers(12, 36))
        t = np.linspace(0, 1, length * 2)
        xs = np.rint(x0 + np.cos(ang) * length * t).astype(int)
        ys = np.rint(y0 + np.sin(ang) * length * t).astype(int)
        for d in range(6):
            img[np.clip(ys + d, 0, h - 1), np.clip(xs + d // 3, 0, w - 1)] = inks[i % 2]
    return img


def phase_refiner(work: Path, card: str, seed: int) -> str:
    from plotweave.pipeline import main
    from plotweave.utils import write_image
    from plotweave.vector.planner import refine_tour, tour_length

    img = work / "lineart.png"
    write_image(str(img), line_art(1200, 1200, seed))
    cfg = work / "lineart_cfg.json"
    names = ["layer_dark", "layer_mid", "layer_light"]
    cfg.write_text(json.dumps({"color_names": names,
                               "colors": [[20, 20, 20], [40, 60, 200], [235, 235, 235]]}))
    times = {}
    for tag, extra in (("greedy", []), ("quality", ["--preset", "quality"])):
        t0 = time.perf_counter()
        main([str(img), "--output", str(work / tag), "--config", str(cfg), "--end-step", "13"] + extra)
        times[tag] = time.perf_counter() - t0
        _data, eof, off = stream_clean(work / tag)
        check(eof and off == 0, f"{tag}: stream replay eof={eof} off_canvas={off}")
    engaged = 0
    for name in names:
        g = pickle.loads((work / "greedy" / name / "ops.pkl").read_bytes())
        q = pickle.loads((work / "quality" / name / "ops.pkl").read_bytes())
        lg, lq = tour_length(g), tour_length(q)
        check(lq <= lg, f"{name}: refined travel {lq} > greedy {lg}")
        line = f"[e] {name}: {len(g)} ops, greedy travel {lg:.1f}, card refiner {lq:.1f}"
        if len(g) >= 600:
            engaged += 1
            if engaged == 1:
                t0 = time.perf_counter()
                lh = tour_length(refine_tour(list(g)))
                line += f", host refiner {lh:.1f} ({time.perf_counter() - t0:.1f} s)"
        log(line)
    check(engaged >= 1, "no layer reached the 600-op refiner gate")
    log(f"[e] greedy run {times['greedy']:.1f} s, quality run {times['quality']:.1f} s [{card}]")
    return f"refiner ok on {engaged} layer(s)"


def attempt_readout(img, dev, k, iters, attempts, limit, seed):
    """Every k-means attempt of the device fit on one backend: its
    compactness and final centres (same sample and ++ keys as the stage,
    traced as a program of its own)."""
    import jax
    import jax.numpy as jnp

    from plotweave.ops.colorspace import bgr_to_lab_u8
    from plotweave.ops.kmeans import _kpp_init_device, _lloyd

    @jax.jit
    def fit(x):
        flat = bgr_to_lab_u8(x).reshape(-1, 3)
        idx = jax.random.choice(jax.random.PRNGKey(seed), flat.shape[0], (limit,), replace=False)
        sample = jnp.take(flat, idx, axis=0)
        out = [_lloyd(sample, _kpp_init_device(sample, k, jax.random.PRNGKey(seed + 1000 * a)), iters)
               for a in range(attempts)]
        return jnp.stack([c for c, _ in out]), jnp.stack([v for _, v in out])

    cents, comps = fit(jax.device_put(img, dev))
    return np.asarray(comps), np.asarray(cents)


def phase_kmeans_device(seed: int) -> str:
    import jax

    from plotweave.config import PipelineConfig
    from plotweave.demo.poster import synth_poster
    from plotweave.ops.resize import area_resize
    from plotweave.stages.s02_color_extract import _device_init_stage

    cfg = PipelineConfig()
    img = np.asarray(area_resize(synth_poster(2160, 3840, n_colors=8, seed=seed), 2000, 1125))
    h, w = img.shape[:2]
    k = cfg.resolve_cluster_k()
    args = (k, int(cfg.kmeans_iters), int(cfg.kmeans_attempts), int(cfg.kmeans_sample_limit),
            int(cfg.kmeans_seed), False)

    def run(dev):
        blob, _masks = _device_init_stage(jax.device_put(img, dev), *args)
        blob = np.asarray(blob)
        stats = np.ascontiguousarray(blob[: k * 16]).view(np.float32).reshape(k, 4)
        packed = blob[k * 16:].reshape(k, h, (w + 7) // 8)
        return stats[:, :3], np.unpackbits(packed, axis=-1)[..., :w]

    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        comps, cents = attempt_readout(img, dev, *args[:5])
        log(f"[f] {dev.platform} attempts: compactness {comps.tolist()}, "
            f"centre L by attempt {[np.round(np.sort(c[:, 0]), 3).tolist() for c in cents]}")

    # layers are the clusters ordered dark → light (stage 02's relabel), so
    # compare in that order
    c_gpu, m_gpu = run(jax.devices()[0])
    c_cpu, m_cpu = run(jax.devices("cpu")[0])
    og, oc = np.argsort(c_gpu[:, 0]), np.argsort(c_cpu[:, 0])
    c_gpu, m_gpu, c_cpu, m_cpu = c_gpu[og], m_gpu[og], c_cpu[oc], m_cpu[oc]
    dc = float(np.abs(c_gpu - c_cpu).max())
    diff = float((m_gpu != m_cpu).any(axis=0).mean())
    log(f"[f] centres max |Δ| {dc:.3g} Lab, labels differing {100 * diff:.5f} %")
    log(f"[f] card centres {np.round(c_gpu, 3).tolist()}; CPU {np.round(c_cpu, 3).tolist()}")
    check(dc <= 1e-2, f"k-means centres differ by {dc} Lab")
    check(diff <= 1e-4, f"{100 * diff:.4f} % of labels differ")

    return "kmeans_init=device within tolerance"


BATCH_SHAPES = [(480, 640), (640, 480), (600, 800), (480, 640), (720, 960),
                (640, 480), (500, 700), (480, 640), (600, 800)]


def check_batch_mode(work: Path, devs, shapes=BATCH_SHAPES, seed: int = 0) -> str:
    """run_pipeline_batch over a ``data`` mesh of ``devs`` against one-device
    sequential runs: every plot_stream.bin byte-equal."""
    import jax

    from plotweave.config import load_config
    from plotweave.demo.poster import synth_poster
    from plotweave.pipeline import run_pipeline, run_pipeline_batch
    from plotweave.utils import write_image

    imgs = []
    for i, (h, w) in enumerate(shapes):
        p = work / f"batch_{i}.png"
        write_image(str(p), synth_poster(h, w, n_colors=4, seed=seed + i))
        imgs.append(p)

    def cfgs(tag):
        out = []
        for i, p in enumerate(imgs):
            d = work / tag / f"img{i}"
            d.mkdir(parents=True)
            (d / "config.json").write_text(json.dumps({
                "input_image": str(p), "output_dir": str(d), "pixels_per_mm": 10,
                "colors": [[20, 20, 20], [60, 40, 100], [40, 60, 200], [235, 230, 225]],
            }))
            out.append(load_config(str(d / "config.json")))
        return out

    t0 = time.perf_counter()
    times = run_pipeline_batch(cfgs("batch"), 1, 13, devices=devs)
    t_batch = time.perf_counter() - t0
    check(all(t > 0 for t in times), f"batch run failed: {times}")
    with jax.default_device(devs[0]):
        t0 = time.perf_counter()
        for c in cfgs("seq"):
            run_pipeline(c, 1, 13)
        t_seq = time.perf_counter() - t0
    for i in range(len(imgs)):
        a = (work / "batch" / f"img{i}" / "plot_stream.bin").read_bytes()
        b = (work / "seq" / f"img{i}" / "plot_stream.bin").read_bytes()
        check(a == b, f"image {i}: batch stream over {len(devs)} devices differs from one device")
    return (f"batch over {len(devs)} devices: {len(imgs)} images byte-equal to one device "
            f"(batch {t_batch:.1f} s, sequential {t_seq:.1f} s, compile included)")


def check_sharded_chain(devs, k: int = 8, h: int = 2160, w: int = 3840, seed: int = 0) -> str:
    """The row-sharded fused chain over ``devs`` against the unsharded
    program on one device, byte for byte."""
    import jax

    from plotweave.parallel.mesh import make_mesh
    from plotweave.parallel.spatial import fit_shard_rows, sharded_chain
    from plotweave.stages.s02_color_extract import _chain_from_clean

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    labels = ((yy // 24 + xx // 24) + rng.integers(0, 3, (h, w))) % k
    packed = np.ascontiguousarray(np.stack([np.packbits(labels == i, axis=-1) for i in range(k)]))
    params = (3, 1, 1, 7, 22, 70)
    n = len(devs)
    ns = fit_shard_rows(h, n, n, max_radius=3)
    check(ns == n, f"{h} rows should split over {n} devices, got {ns}")
    mesh = make_mesh((n,), ("space",), devices=devs)
    blob_n = np.asarray(jax.block_until_ready(sharded_chain(mesh, packed, w, *params)))
    blob_1 = np.asarray(jax.block_until_ready(_chain_from_clean(jax.device_put(packed, devs[0]), w, *params)))
    check(np.array_equal(blob_n, blob_1), f"row-sharded chain over {n} devices differs from one device")
    return f"row-sharded chain ({k},{h},{w}) over {n} devices byte-equal to one device"


def check_grid_frontend(devs, seed: int = 0) -> str:
    """data × space grid front-end (2 × n/2) against the one-device program."""
    import jax

    from plotweave.ops.frontend import raster_frontend
    from plotweave.parallel.mesh import make_mesh
    from plotweave.parallel.spatial import grid_frontend

    rng = np.random.default_rng(seed)
    space = len(devs) // 2
    mesh = make_mesh((2, space), ("data", "space"), devices=devs)
    centers = np.array([[40, 128, 128], [110, 140, 120], [180, 150, 140], [240, 128, 126]], np.float32)
    images = rng.integers(0, 256, (4, 64 * space, 320, 3)).astype(np.uint8)
    e_n, s_n = grid_frontend(mesh, images, centers, k=4)
    with jax.default_device(devs[0]):
        e_1, s_1 = raster_frontend(images, centers, k=4)
    check(np.array_equal(np.asarray(e_n), np.asarray(e_1)) and np.array_equal(np.asarray(s_n), np.asarray(s_1)),
          "data×space grid front-end differs from one device")
    return f"data×space (2×{space}) grid front-end byte-equal to one device"


def phase_four_cards(work: Path, seed: int) -> str:
    import jax

    devs = jax.devices()
    check(len(devs) == 4, f"--four-cards needs 4 devices, found {len(devs)}")
    log("[g] " + check_batch_mode(work, devs, seed=seed))
    log("[g] " + check_sharded_chain(devs, seed=seed))
    log("[g] " + check_grid_frontend(devs, seed=seed))
    return "four-card paths byte-equal to one card"


# ---------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path (needs 4 GPUs)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    sys.path.insert(0, str(HERE))
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's default device is {devs[0].platform})", file=sys.stderr)
        return 1
    try:
        import plotweave
    except ImportError:
        print("chip_smoke: plotweave is not beside this script", file=sys.stderr)
        return 1
    if Path(plotweave.__file__).resolve().parent.parent != HERE:
        print(f"chip_smoke: plotweave found at {plotweave.__file__}, not beside this script",
              file=sys.stderr)
        return 1

    # ---- a. preflight
    card = card_line()
    log(f"[a] card: {card}")
    log(f"[a] jax {jax.__version__}; devices {devs}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    sys.meta_path.insert(0, _ImportBlocker())
    from plotweave.native.loader import get_lib

    if os.environ.get("PLOTWEAVE_NO_NATIVE") or get_lib() is None:
        print("chip_smoke: the native library could not be built or loaded", file=sys.stderr)
        return 1
    log(f"[a] native library: {get_lib()._name}")

    if args.four_cards:
        phases = [("g", lambda w: phase_four_cards(w, args.seed))]
    else:
        phases = [
            ("b", phase_goldens),
            ("c", lambda w: phase_real_size(w, card, args.seed)),
            ("d", lambda w: phase_planner(args.seed)),
            ("e", lambda w: phase_refiner(w, card, args.seed)),
            ("f", lambda w: phase_kmeans_device(args.seed)),
        ]
    work = Path(tempfile.mkdtemp(prefix="pw_chip_smoke_"))
    failed = []
    try:
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                res = fn(work)
                log(f"[{name}] PASS: {res} ({time.perf_counter() - t0:.1f} s)")
            except Exception as e:  # noqa: BLE001 — report every phase, then fail
                traceback.print_exc()
                log(f"[{name}] FAIL: {type(e).__name__}: {e}")
                failed.append(name)
            except SystemExit as e:  # the CLI entry exits on a stage error
                log(f"[{name}] FAIL: pipeline exited with {e.code}")
                failed.append(name)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    log(f"card: {card}")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                             "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
