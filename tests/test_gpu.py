"""On-card checks (marker ``gpu``): the chip_smoke.py phases c–f as tests.

They skip without a card.  On a machine with one GPU:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


def test_real_size_job(gpu, tmp_path):
    assert chip_smoke.phase_real_size(tmp_path, gpu.device_kind, 0) == "real-size job ok"


def test_device_planner_identical_to_host(gpu):
    assert chip_smoke.phase_planner(0) == "device planner identical to host"


def test_device_refiner_never_longer_than_greedy(gpu, tmp_path):
    assert chip_smoke.phase_refiner(tmp_path, gpu.device_kind, 0).startswith("refiner ok")


def test_kmeans_device_matches_cpu_backend(gpu):
    assert chip_smoke.phase_kmeans_device(0) == "kmeans_init=device within tolerance"
