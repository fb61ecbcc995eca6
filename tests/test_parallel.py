"""Multi-device sharding tests on the virtual 8-device CPU mesh: spatial
row-sharding (halo exchange) and batch data-parallelism must be bit-identical
to the single-device fused front-end, and the driver entry points must run."""

from __future__ import annotations

import numpy as np
import pytest

import jax

from plotweave.ops.frontend import raster_frontend
from plotweave.parallel import frontend_batch, make_mesh, spatial_frontend

CENTERS = np.array(
    [[40, 128, 128], [110, 140, 120], [180, 150, 140], [240, 128, 126]], np.float32
)


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


def test_spatial_sharding_bit_identical(eight_devices):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (128, 96, 3)).astype(np.uint8)
    mesh = make_mesh((8,), ("space",), devices=eight_devices)
    e_sp, s_sp = spatial_frontend(mesh, img, CENTERS, k=4)
    e_1, s_1 = raster_frontend(img, CENTERS, k=4)
    assert (np.asarray(e_sp) == np.asarray(e_1)).all()
    assert (np.asarray(s_sp) == np.asarray(s_1)).all()


def test_spatial_sharding_extreme_gradients_bit_identical(eight_devices):
    """Checkerboard/stripe extremes drive the Sobel responses to their ±1020
    ceiling and light up every NMS sector — pins the sharded twins'
    dtype/overflow contract (the ops run int16 planes with int32 Q15
    products; a missed widening in the halo twin corrupts ONLY the sharded
    bytes, as happened with the round-4 int16 migration)."""
    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[0:128, 0:96]
    board = (((yy // 8) + (xx // 8)) % 2).astype(np.uint8) * 255  # 8-px blocks
    img = np.repeat(board[..., None], 3, axis=2)
    img[40:72] = rng.integers(0, 256, (32, 96, 3))
    img[96:112] = np.where((np.arange(96) % 12 < 6)[None, :, None], 255, 0)
    mesh = make_mesh((8,), ("space",), devices=eight_devices)
    e_sp, s_sp = spatial_frontend(mesh, img, CENTERS, k=4)
    e_1, s_1 = raster_frontend(img, CENTERS, k=4)
    assert int((np.asarray(e_1) > 0).sum()) > 100  # non-degenerate content
    assert (np.asarray(e_sp) == np.asarray(e_1)).all()
    assert (np.asarray(s_sp) == np.asarray(s_1)).all()


def test_batch_sharding_bit_identical(eight_devices):
    rng = np.random.default_rng(12)
    imgs = rng.integers(0, 256, (8, 64, 48, 3)).astype(np.uint8)
    mesh = make_mesh((8,), ("data",), devices=eight_devices)
    e_b, s_b = frontend_batch(mesh, imgs, CENTERS, k=4)
    e_1, s_1 = raster_frontend(imgs, CENTERS, k=4)
    assert (np.asarray(e_b) == np.asarray(e_1)).all()
    assert (np.asarray(s_b) == np.asarray(s_1)).all()


def test_grid_2d_sharding_bit_identical(eight_devices):
    """The data×space 2-D grid (dp × sp composed) must be bit-identical to
    the unsharded fused front-end — not just shape-compatible (round-3
    verdict #3).  4 images × 2-way batch split × 4-way row split, with the
    joint fixpoint all-reduce over BOTH mesh axes."""
    from plotweave.parallel.spatial import grid_frontend

    rng = np.random.default_rng(13)
    imgs = rng.integers(0, 256, (4, 64, 48, 3)).astype(np.uint8)
    mesh = make_mesh((2, 4), ("data", "space"), devices=eight_devices)
    e_g, s_g = grid_frontend(mesh, imgs, CENTERS, k=4)
    e_1, s_1 = raster_frontend(imgs, CENTERS, k=4)
    assert (np.asarray(e_g) == np.asarray(e_1)).all()
    assert (np.asarray(s_g) == np.asarray(s_1)).all()


def test_graft_entry_and_dryrun(eight_devices, tmp_path):
    """The multi-card checks of ``chip_smoke.py --four-cards`` rehearsed on
    the virtual CPU mesh: batch mode over a ``data`` mesh (more images than
    devices, a ragged last group, mixed shapes), the row-sharded chain and
    the data×space grid front-end, each byte-equal to one device."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent.parent))
    import chip_smoke

    devs = eight_devices[:4]
    shapes = [(60, 80), (80, 60), (72, 96), (60, 80), (90, 120)]
    assert chip_smoke.check_batch_mode(tmp_path, devs, shapes=shapes).startswith("batch over 4")
    assert "byte-equal" in chip_smoke.check_sharded_chain(devs, k=4, h=96, w=80)
    assert "byte-equal" in chip_smoke.check_grid_frontend(devs)
