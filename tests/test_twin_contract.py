"""Structural guard on the ops ↔ parallel.spatial halo-twin contract.

Round-4 proved the trap is real: the i16 Sobel byte cut in ops/canny.py
broke the sharded NMS (commit 699c77f) because parallel/spatial.py
re-stitches the ops primitives with its own border/halo logic.  This module
sweeps EVERY dtype-sensitive public op through its halo twin on the 8-device
row-sharded mesh and asserts byte equality on adversarial inputs — so an
ops/ dtype or semantics change cannot pass the default tier while the twin
diverges, without anyone hand-writing a per-case fixture.

The twin registry below is the contract's single source of truth: when a new
halo twin is added to parallel/spatial.py, add one PAIRS row here.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from plotweave.ops.canny import canny
from plotweave.ops.filters import gaussian_blur_u8
from plotweave.ops.morphology import _morph
from plotweave.ops.thinning import zhang_suen
from plotweave.parallel.mesh import make_mesh
from plotweave.parallel.spatial import (
    AXIS,
    _blur_halo_b,
    _canny_halo_b,
    _morph_prog_halo,
    _thin_halo_b,
)

K, H, W = 4, 64, 40  # 8 rows/shard over 8 devices = the halo-feasibility floor


def _panels() -> np.ndarray:
    """(K, H, W) u8 adversarial stack: every layer stresses a different
    dtype/overflow corner — saturated checkerboard extremes (Sobel at its
    ±1020 ceiling, every NMS sector), full-range speckle, thin stripes
    (fixpoint propagation across shard boundaries), near-threshold plateaus."""
    rng = np.random.default_rng(23)
    yy, xx = np.mgrid[0:H, 0:W]
    board = (((yy // 4) + (xx // 4)) % 2).astype(np.uint8) * 255
    speckle = rng.integers(0, 256, (H, W)).astype(np.uint8)
    stripes = np.where((xx + yy) % 7 < 2, 255, 0).astype(np.uint8)
    plateau = np.where(yy % 16 < 8, 128, 131).astype(np.uint8)  # tiny gradients
    return np.stack([board, speckle, stripes, plateau])


def _binary_panels() -> np.ndarray:
    """(K, H, W) u8 0/255 stacks for the binary fixpoints (thinning): blobs,
    dense speckle, one-pixel lines, and rings that straddle shard borders."""
    rng = np.random.default_rng(29)
    yy, xx = np.mgrid[0:H, 0:W]
    blobs = (((yy - 20) ** 2 + (xx - 20) ** 2 < 150) | ((yy - 48) ** 2 + (xx - 28) ** 2 < 90))
    speckle = rng.random((H, W)) < 0.45
    lines = (yy % 8 == 0) | (xx % 8 == 0)
    ring = (np.abs(np.hypot(yy - 32, xx - 20) - 14) < 1.6)
    return (np.stack([blobs, speckle, lines, ring]).astype(np.uint8)) * 255


@pytest.fixture(scope="module")
def space_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh((8,), (AXIS,), devices=jax.devices()[:8])


def _run_halo(mesh, fn, x: np.ndarray) -> np.ndarray:
    """Apply a halo-twin body to (K, rows, W) with rows sharded over AXIS."""
    f = jax.shard_map(
        fn, mesh=mesh, in_specs=(P(None, AXIS, None),),
        out_specs=P(None, AXIS, None), check_vma=False,
    )
    return np.asarray(jax.jit(f)(x))


# (name, solo_fn, halo_fn, input builder) — one row per halo twin in
# parallel/spatial.py.  Parameter grids mirror every configuration the
# production chains can reach (stage-02 mask cleanup, stage-03 edge
# morphology + blur + Canny, stage-04 thinning).
PAIRS = (
    [
        (
            f"morph-{shape}{ksize}-{prog}x{iters}",
            partial(_morph, shape=shape, ksize=ksize, iterations=iters, program=prog),
            partial(_morph_prog_halo, shape=shape, ksize=ksize, iterations=iters, program=prog),
            _panels,
        )
        for shape in ("rect", "ellipse")
        for ksize in (3, 7)
        for prog in ("ed", "de")
        for iters in (1, 2)
    ]
    + [
        (
            f"blur-k{ksize}",
            partial(gaussian_blur_u8, ksize=ksize),
            partial(_blur_halo_b, ksize=ksize),
            _panels,
        )
        for ksize in (3, 5, 7)
    ]
    + [
        (
            f"canny-{lo}-{hi}",
            partial(canny, low=lo, high=hi),
            partial(_canny_halo_b, low=lo, high=hi),
            _panels,
        )
        for lo, hi in ((22, 70), (0, 1), (200, 900), (70, 22))
    ]
    + [
        (
            "thinning",
            lambda x: zhang_suen(x).astype(np.uint8),
            lambda x: _thin_halo_b(x).astype(np.uint8),
            _binary_panels,
        )
    ]
)


@pytest.mark.parametrize("name,solo,halo,inputs", PAIRS, ids=[p[0] for p in PAIRS])
def test_halo_twin_byte_identical(space_mesh, name, solo, halo, inputs):
    x = inputs()
    want = np.asarray(jax.jit(solo)(x))
    got = _run_halo(space_mesh, halo, x)
    assert want.dtype == got.dtype, f"{name}: dtype diverged {want.dtype} vs {got.dtype}"
    mism = int((want != got).sum())
    assert mism == 0, f"{name}: {mism} bytes diverged between solo op and halo twin"


def test_twin_registry_covers_all_halo_twins():
    """If a new halo twin lands in parallel/spatial.py without a PAIRS row,
    fail loudly — the registry must stay the contract's source of truth."""
    import plotweave.parallel.spatial as sp

    twins = {n for n in dir(sp) if n.endswith("_halo_b") or n.endswith("_halo")}
    covered = {"_morph_halo_b", "_morph_prog_halo", "_blur_halo_b",
               "_canny_halo_b", "_thin_halo_b", "_with_halo_b"}
    # _with_halo_b is the exchange primitive (no solo counterpart);
    # _morph_halo_b is exercised through _morph_prog_halo's program strings
    assert twins <= covered, (
        f"new halo twin(s) {twins - covered} lack a PAIRS row in "
        "tests/test_twin_contract.py"
    )
