"""bench.py measures on a GPU or not at all: without one it prints a JSON
error line naming the device it found and exits non-zero."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_bench_refuses_to_measure_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "bench.py"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 1
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert "no GPU" in last["error"] and last["device"]["platform"] == "cpu"
