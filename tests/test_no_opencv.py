"""The main path needs no OpenCV, PIL, pygame or matplotlib: a golden
configuration runs end to end (steps 01–14) in a fresh process where
importing any of them fails, and its stream still matches the reference."""

from __future__ import annotations

import json
import subprocess
import sys
import tarfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "e2e"

SCRIPT = r"""
import sys
for name in ("cv2", "PIL", "pygame", "matplotlib"):
    sys.modules[name] = None
from plotweave.config import load_config
from plotweave.pipeline import run_pipeline
run_pipeline(load_config(sys.argv[1]), 1, 14)
leaked = [m for m in ("cv2", "PIL", "pygame", "matplotlib") if sys.modules.get(m) is not None]
assert not leaked, leaked
"""


def test_golden_config_without_opencv(tmp_path):
    cfg = json.loads((GOLDEN / "base_cfg2.json").read_text())
    cfg["input_image"] = str(GOLDEN / cfg["input_image"])
    out = tmp_path / "mine"
    out.mkdir()
    cfg["output_dir"] = str(out)
    (out / "config.json").write_text(json.dumps(cfg))
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path),
           "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(out / "config.json")], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with tarfile.open(GOLDEN / "ref_artifacts2.tar.gz") as tf:
        tf.extractall(tmp_path / "ref", filter="data")
    ref = next((tmp_path / "ref").rglob("plot_stream.bin"))
    assert (out / "plot_stream.bin").read_bytes() == ref.read_bytes()
    assert (out / "stream_preview.png").exists()  # step 14, headless
