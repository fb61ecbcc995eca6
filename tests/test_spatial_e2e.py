"""Row-sharded pipeline e2e: `shard_rows` routes stage 02-04's fused device
program through parallel.spatial.sharded_chain over the 8-device CPU
mesh and must stay byte-identical to the unsharded run through step 13
(VERDICT r1 item 4 — the wiring test, not just the frontend unit test)."""

from __future__ import annotations

import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from plotweave.config import load_config
from plotweave.parallel.spatial import fit_shard_rows
from plotweave.pipeline import run_pipeline

PALETTE = [(20, 20, 20), (40, 60, 200), (140, 180, 220), (235, 230, 225)]
NAMES = ["layer_dark", "layer_mid", "layer_skin", "layer_light"]


def _image(rng, h, w):
    img = np.zeros((h, w, 3), np.uint8)
    img[:, :] = PALETTE[-1]
    for c in PALETTE:
        for _ in range(5):
            x, y = int(rng.integers(0, w)), int(rng.integers(0, h))
            r = int(rng.integers(10, 50))
            if rng.random() < 0.5:
                cv2.circle(img, (x, y), r, c, -1)
            else:
                cv2.rectangle(img, (x, y), (x + r, y + int(r * 0.8)), c, -1)
    return img


def _run(tmp_path: Path, img_path: Path, tag: str, shard_rows: int) -> Path:
    out = tmp_path / tag
    out.mkdir()
    cfg = {
        "input_image": str(img_path),
        "output_dir": str(out),
        "color_names": NAMES,
        "colors": [list(c) for c in PALETTE],
        "shard_rows": shard_rows,
    }
    (out / "config.json").write_text(json.dumps(cfg))
    run_pipeline(load_config(str(out / "config.json")), 1, 13)
    return out


def test_fit_shard_rows():
    assert fit_shard_rows(256, 8, 8) == 8
    assert fit_shard_rows(1125, 8, 8) == 5
    assert fit_shard_rows(1126, 8, 8) == 2
    assert fit_shard_rows(997, 8, 8) == 1  # prime rows → degenerate mesh
    assert fit_shard_rows(256, 8, 1) == 1  # one real chip
    assert fit_shard_rows(256, 0, 8) == 1
    # halo stencils need working margin: never shard below 8 rows/shard
    assert fit_shard_rows(24, 8, 8) == 3
    assert fit_shard_rows(12, 8, 8) == 1
    assert fit_shard_rows(4, 8, 8) == 1
    # an outsized stencil radius raises the per-shard floor (ADVICE r2 #1:
    # edge_morph_kernel > 17 used to hit an opaque broadcast error instead)
    assert fit_shard_rows(64, 8, 8, max_radius=10) == 4  # needs ≥11 rows/shard
    assert fit_shard_rows(256, 8, 8, max_radius=10) == 8  # 32 rows/shard is fine
    assert fit_shard_rows(64, 8, 8, max_radius=3) == 8  # default kernels unchanged
    assert fit_shard_rows(64, 8, 8, max_radius=63) == 1  # radius ≥ H → unsharded


@pytest.mark.slow
def test_sharded_pipeline_byte_identical(tmp_path):
    """Full pipeline with shard_rows=8 vs unsharded: every stage artifact and
    the stream byte-equal (the wiring test — registry handoffs, permutes,
    palette, manifest all flow through the sharded chain)."""
    rng = np.random.default_rng(0)
    img_path = tmp_path / "img.png"
    cv2.imwrite(str(img_path), _image(rng, 256, 320))

    a = _run(tmp_path, img_path, "unsharded", 0)
    b = _run(tmp_path, img_path, "sharded", 8)

    assert (a / "plot_stream.bin").read_bytes() == (b / "plot_stream.bin").read_bytes()
    for name in NAMES:
        for f in ("mask.png", "edges.png"):
            fa, fb = a / name / f, b / name / f
            if fa.exists() or fb.exists():
                assert fa.read_bytes() == fb.read_bytes(), f"{name}/{f}"
    for f in ("palette_by_name.json", "vector_manifest.json"):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.slow
def test_sharded_pipeline_degenerate_divisor(tmp_path, capsys):
    """251 rows is prime: --shard-rows 8 must fit down to the 1-shard
    degenerate mesh and stay byte-identical (round-2 verdict #7)."""
    rng = np.random.default_rng(3)
    img_path = tmp_path / "img.png"
    cv2.imwrite(str(img_path), _image(rng, 251, 180))

    a = _run(tmp_path, img_path, "unsharded", 0)
    b = _run(tmp_path, img_path, "sharded", 8)
    out = capsys.readouterr().out
    assert "row-sharded over 1 device(s)" in out
    assert (a / "plot_stream.bin").read_bytes() == (b / "plot_stream.bin").read_bytes()


@pytest.mark.slow
def test_outsized_kernel_caps_shards(capsys):
    """edge_morph_kernel=21 (stencil radius 10) must CAP the shard count to
    keep ≥ radius+1 rows per shard instead of crashing at trace time with a
    broadcast error (ADVICE r2 #1) — policy via _resolve_shard_n, behavior
    via the sharded chain bit-compared against the unsharded program."""
    from plotweave.config import PipelineConfig
    from plotweave.parallel import make_mesh
    from plotweave.parallel.spatial import sharded_chain
    from plotweave.stages.s02_color_extract import _chain_from_clean, _resolve_shard_n

    cfg = PipelineConfig(
        shard_rows=8, edge_morph_kernel=21,
        edge_morph_open_iters=1, edge_morph_close_iters=1,
    )
    # 64 rows / (radius 10 + 1) → at most 5 shards → largest divisor is 4
    n = _resolve_shard_n(cfg, 64, 96)
    assert n == 4
    assert "stencil radius 10" in capsys.readouterr().out

    rng = np.random.default_rng(4)
    k, h, w = 4, 64, 96
    labels = rng.integers(0, k, (h, w))
    packed = np.ascontiguousarray(
        np.stack([np.packbits(labels == i, axis=-1) for i in range(k)])
    )
    args = (w, 21, 1, 1, 7, 22, 70)  # mk=21: the outsized stencil
    mesh = make_mesh((n,), ("space",))
    blob_s = sharded_chain(mesh, packed, *args)
    blob_1 = _chain_from_clean(packed, *args)
    assert np.array_equal(np.asarray(blob_s), np.asarray(blob_1))


@pytest.mark.parametrize("n_shards", [1, 4, 5])
def test_sharded_chain_bit_identical(n_shards):
    """sharded_chain vs the unsharded fused program, bit-compared on
    the raw blob: 1-device degenerate mesh (the one-card case), a fitted
    4-way split, and an odd 5-way split."""
    import jax.numpy as jnp

    from plotweave.parallel import make_mesh
    from plotweave.parallel.spatial import sharded_chain
    from plotweave.stages.s02_color_extract import _chain_from_clean

    rng = np.random.default_rng(n_shards)
    k, h, w = 4, 120, 90  # 120 divides by 1, 4 and 5
    labels = rng.integers(0, k, (h, w))
    packed = jnp.asarray(
        np.stack([np.packbits(labels == i, axis=-1) for i in range(k)])
    )
    args = (w, 3, 1, 1, 7, 22, 70)
    blob0 = _chain_from_clean(packed, *args)
    mesh = make_mesh((n_shards,), ("space",))
    blob1 = sharded_chain(mesh, packed, *args)
    assert np.array_equal(np.asarray(blob0), np.asarray(blob1))


def test_resolve_shard_n_policies():
    from plotweave.config import PipelineConfig
    from plotweave.stages.s02_color_extract import _resolve_shard_n

    cfg = PipelineConfig()
    assert _resolve_shard_n(cfg, 256, 320) == 0  # off by default
    cfg.shard_rows = 8
    assert _resolve_shard_n(cfg, 256, 320) == 8  # explicit, fits
    cfg.shard_rows = 0
    cfg.shard_auto_mpx = 1.0
    assert _resolve_shard_n(cfg, 256, 320) == 0  # 0.08 Mpx below budget
    assert _resolve_shard_n(cfg, 2000, 2000) == 8  # 4 Mpx above budget
    # a poor row divisor fits down to the largest divisor ≤ device count
    assert _resolve_shard_n(cfg, 2002, 2000) == 7
