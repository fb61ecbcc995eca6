"""[01] Input resize: cap the longest side at max_dimension → resized.png
(reference 01_resize.py)."""

from __future__ import annotations

import os

from ..config import PipelineConfig
from ..utils import read_image, register_device_artifact, write_image


def run(cfg: PipelineConfig) -> None:
    import jax  # noqa: PLC0415
    import numpy as np  # noqa: PLC0415

    from ..ops.resize import area_resize  # noqa: PLC0415

    cfg.ensure_output_dirs()
    img = read_image(cfg.input_image)
    h, w = img.shape[:2]
    m = max(h, w)
    # the reference's cv2.resize(INTER_AREA) is the byte contract
    # (01_resize.py:20); ops.area_resize replicates it bit-exactly on the
    # device (fuzz-pinned against cv2 in tests/test_ops_raster.py)
    out_dev = None
    if m > cfg.max_dimension:
        scale = cfg.max_dimension / m
        out_dev = area_resize(img, int(w * scale), int(h * scale))
        out = np.asarray(out_dev)
        print(f"Resizing: {w}x{h} -> {out.shape[1]}x{out.shape[0]}")
    else:
        out = img
        print(f"No resize required: {w}x{h}")
    dst = os.path.join(cfg.output_dir, "resized.png")
    # only the kmeans_init="device" mode consumes the image device-resident
    # (s02 fetches it); the default host-exact mode reads host pixels
    if str(getattr(cfg, "kmeans_init", "host-exact")).lower() == "device":
        if out_dev is None:
            out_dev = jax.device_put(out)  # async; overlaps the PNG encode below
        write_image(dst, out)
        register_device_artifact(dst, out_dev)
    else:
        write_image(dst, out)
    print(f"Saved: {dst}")
