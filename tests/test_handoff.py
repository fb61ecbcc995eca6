"""Device-artifact handoff + bitpack: the in-process fast path must be
invisible — identical bytes to disk reads, and stale entries must fall back."""

from __future__ import annotations

import os
import time

import numpy as np

from plotweave.ops.bitpack import bitpack_rows, unpack_rows
from plotweave.utils import fetch_device_artifact, register_device_artifact, write_image


def test_bitpack_roundtrip_arbitrary_widths():
    rng = np.random.default_rng(0)
    for w in (1, 7, 8, 9, 64, 100, 1023, 1024):
        img = (rng.random((3, 5, w)) < 0.5).astype(np.uint8) * 255
        packed = np.asarray(bitpack_rows(img))
        assert packed.shape == (3, 5, (w + 7) // 8)
        np.testing.assert_array_equal(unpack_rows(packed, w), (img > 0).astype(np.uint8))


def test_handoff_roundtrip_and_stale_invalidation(tmp_path):
    import jax

    p = str(tmp_path / "art.png")
    img = np.arange(100, dtype=np.uint8).reshape(10, 10)
    write_image(p, img)
    arr = jax.device_put(img)
    register_device_artifact(p, arr)
    got = fetch_device_artifact(p)
    assert got is not None
    np.testing.assert_array_equal(np.asarray(got), img)

    # rewriting the file must invalidate the cached device array
    time.sleep(0.01)
    write_image(p, img[::-1].copy())
    assert fetch_device_artifact(p) is None
    # and stays invalid on repeat lookups
    assert fetch_device_artifact(p) is None


def test_handoff_missing_file(tmp_path):
    import jax

    p = str(tmp_path / "gone.png")
    write_image(p, np.zeros((4, 4), np.uint8))
    register_device_artifact(p, jax.device_put(np.zeros((4, 4), np.uint8)))
    os.remove(p)
    assert fetch_device_artifact(p) is None


def test_handoff_lru_bound(tmp_path):
    import jax

    from plotweave.utils.io import _DEVICE_HANDOFF, _DEVICE_HANDOFF_CAP

    for i in range(_DEVICE_HANDOFF_CAP + 10):
        p = str(tmp_path / f"a{i}.png")
        write_image(p, np.full((2, 2), i % 256, np.uint8))
        register_device_artifact(p, jax.device_put(np.zeros((2, 2), np.uint8)))
    assert len(_DEVICE_HANDOFF) <= _DEVICE_HANDOFF_CAP


def test_config_doc_covers_every_field():
    """CONFIG.md must mention every PipelineConfig field (doc-coverage guard)."""
    from dataclasses import fields
    from pathlib import Path

    from plotweave.config import PipelineConfig

    doc = (Path(__file__).parent.parent / "CONFIG.md").read_text()
    missing = [f.name for f in fields(PipelineConfig) if f"`{f.name}`" not in doc]
    assert not missing, f"CONFIG.md missing: {missing}"


def _tiny_pipeline_cfg(tmp_path, tag):
    import json

    import cv2

    rng = np.random.default_rng(5)
    img = np.zeros((96, 128, 3), np.uint8)
    img[:, :] = (235, 230, 225)
    for _ in range(8):
        c = [(20, 20, 20), (40, 60, 200), (140, 180, 220)][int(rng.integers(0, 3))]
        cv2.circle(img, (int(rng.integers(0, 128)), int(rng.integers(0, 96))), int(rng.integers(5, 25)), c, -1)
    p = tmp_path / f"{tag}.png"
    cv2.imwrite(str(p), img)
    out = tmp_path / tag
    out.mkdir()
    cfg_d = {
        "input_image": str(p),
        "output_dir": str(out),
        "colors": [[20, 20, 20], [40, 60, 200], [140, 180, 220], [235, 230, 225]],
        "color_names": ["layer_dark", "layer_mid", "layer_skin", "layer_light"],
        "target_width_mm": 64, "target_height_mm": 48, "pixels_per_mm": 2,
        "pen_width_px": 8, "pen_radius_px": 4,
    }
    (out / "config.json").write_text(json.dumps(cfg_d))
    from plotweave.config import load_config

    return load_config(str(out / "config.json")), out


def test_fused_chain_equals_stepwise(tmp_path):
    """run_pipeline(1..4) (fused 02→04 dispatch) must produce artifacts
    byte-identical to four separate single-step runs (per-stage programs)."""
    import pickle

    import cv2

    from plotweave.pipeline import run_pipeline

    cfg_a, out_a = _tiny_pipeline_cfg(tmp_path, "chained")
    run_pipeline(cfg_a, 1, 4)
    cfg_b, out_b = _tiny_pipeline_cfg(tmp_path, "stepwise")
    for s in (1, 2, 3, 4):
        run_pipeline(cfg_b, s, s)

    for layer in cfg_a.color_names:
        for f in ("mask.png", "edges.png"):
            a = cv2.imread(str(out_a / layer / f), 0)
            b = cv2.imread(str(out_b / layer / f), 0)
            assert a is not None and (a == b).all(), f"{layer}/{f}"
        pa = pickle.loads((out_a / layer / "contours.pkl").read_bytes())
        pb = pickle.loads((out_b / layer / "contours.pkl").read_bytes())
        assert len(pa) == len(pb)
        for x, y in zip(pa, pb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_fused_chain_invalidated_by_edited_edges(tmp_path):
    """If edges.png changes after the chained run, stage 04 must NOT reuse
    the fused skeletons — it recomputes from the file on disk."""
    import pickle

    import cv2

    from plotweave.pipeline import run_pipeline

    cfg, out = _tiny_pipeline_cfg(tmp_path, "inval")
    run_pipeline(cfg, 1, 4)
    orig = pickle.loads((out / "layer_dark" / "contours.pkl").read_bytes())

    # blank one layer's edges and rerun step 4 alone
    e_path = out / "layer_dark" / "edges.png"
    e = cv2.imread(str(e_path), 0)
    cv2.imwrite(str(e_path), np.zeros_like(e))
    run_pipeline(cfg, 4, 4)
    new = pickle.loads((out / "layer_dark" / "contours.pkl").read_bytes())
    assert len(new) == 0 and len(orig) > 0  # recomputed from the blank file


def test_fused_chain_miss_on_renamed_layers(tmp_path):
    """Rerunning stage 03 with reordered layer names (same mask files) must
    NOT consume the fused-chain entry registered under the old names order."""
    import json

    import cv2

    from plotweave.config import load_config
    from plotweave.pipeline import run_pipeline

    cfg, out = _tiny_pipeline_cfg(tmp_path, "renamed")
    run_pipeline(cfg, 1, 4)
    before = {
        n: cv2.imread(str(out / n / "edges.png"), 0)
        for n in cfg.color_names
    }

    # reorder the names (masks on disk untouched) and rerun stage 3 alone
    cfg_d = json.loads((out / "config.json").read_text())
    cfg_d["color_names"] = list(reversed(cfg_d["color_names"]))
    cfg_d["colors"] = list(reversed(cfg_d["colors"]))
    (out / "config.json").write_text(json.dumps(cfg_d))
    cfg2 = load_config(str(out / "config.json"))
    run_pipeline(cfg2, 3, 3)

    # each layer's edges must still be the edges OF ITS OWN mask — i.e. the
    # recompute from disk, not mis-assigned fused rows
    for n in cfg.color_names:
        after = cv2.imread(str(out / n / "edges.png"), 0)
        assert (before[n] == after).all(), n


def test_kmeans_device_init_mode(tmp_path):
    """kmeans_init="device" (opt-in, single fused dispatch) must produce
    masks equivalent to host-exact on a separable image, and a valid stream."""
    import json

    import cv2

    from plotweave.config import load_config
    from plotweave.pipeline import run_pipeline

    cfg_a, out_a = _tiny_pipeline_cfg(tmp_path, "exact")
    run_pipeline(cfg_a, 1, 13)

    cfg_d = json.loads((out_a / "config.json").read_text())
    out_b = tmp_path / "device"
    out_b.mkdir()
    cfg_d["output_dir"] = str(out_b)
    cfg_d["kmeans_init"] = "device"
    (out_b / "config.json").write_text(json.dumps(cfg_d))
    run_pipeline(load_config(str(out_b / "config.json")), 1, 13)

    # separable colors ⇒ identical converged Voronoi assignment ⇒ same masks
    for layer in cfg_a.color_names:
        a = cv2.imread(str(out_a / layer / "mask.png"), 0)
        b = cv2.imread(str(out_b / layer / "mask.png"), 0)
        assert a is not None and b is not None and (a == b).all(), layer
    sa = (out_a / "plot_stream.bin").read_bytes()
    sb = (out_b / "plot_stream.bin").read_bytes()
    assert sa == sb  # converged identically on this input


def test_save_pickle_interrupted_overwrite_is_loudly_invalid(tmp_path):
    """save_pickle overwrites in place (tmpfs page reuse); a save that dies
    mid-dump must leave a file pickle.load REJECTS — never new-prefix+
    old-suffix bytes that unpickle silently to wrong data.  The first byte
    stays an invalid opcode until the dump + truncate complete."""
    import pickle

    import pytest

    from plotweave.utils.io import _FirstByteGuard, save_pickle

    p = tmp_path / "artifact.pkl"
    old = {"v": np.arange(1000)}
    save_pickle(old, str(p))
    assert pickle.loads(p.read_bytes())["v"].sum() == old["v"].sum()

    # simulate a crash: run the dump through the guard but never finish()
    new = {"v": np.arange(5)}  # shorter: old suffix would survive
    with open(p, "r+b") as f:
        guard = _FirstByteGuard(f)
        pickle.dump(new, guard, protocol=5)
        # no truncate, no finish -> the on-disk file must be invalid
    with pytest.raises(Exception):
        pickle.loads(p.read_bytes())

    # a completed save over the corrupt file recovers it byte-validly
    save_pickle(new, str(p))
    assert pickle.loads(p.read_bytes())["v"].tolist() == [0, 1, 2, 3, 4]


def test_approx_nbytes_recurses_nested_artifacts():
    """Byte-budget accounting must see arrays nested in list-of-dicts
    (contour artifacts) — the exact shapes the budget exists to evict."""
    from plotweave.utils.io import _approx_nbytes

    a = np.zeros(1000, np.uint8)
    assert _approx_nbytes(a) == 1000
    assert _approx_nbytes([a, a]) == 2000
    assert _approx_nbytes([{"points": a}, {"points": a}]) == 2000
    assert _approx_nbytes({"layers": [{"points": a}]}) == 1000
    # depth cap: don't scan unboundedly deep structures
    assert _approx_nbytes([[[[a]]]]) == 0


def test_save_pickle_async_write_behind(tmp_path):
    """Write-behind contract: the live object is fetchable immediately
    (pending entry), flush_pending_saves() puts durable bytes on disk, and
    the registry entry survives with a real stat signature afterwards."""
    import pickle

    from plotweave.utils.io import (
        _PENDING_SIG, _PICKLE_HANDOFF, flush_pending_saves, load_pickle,
        save_pickle_async,
    )

    p = tmp_path / "wb.pkl"
    obj = {"v": np.arange(4096)}
    save_pickle_async(obj, str(p))
    # the live object is served even before the bytes land
    assert load_pickle(str(p)) is obj
    flush_pending_saves()
    assert pickle.loads(p.read_bytes())["v"].sum() == obj["v"].sum()
    # the pending entry was re-registered with the file's real signature
    ent = _PICKLE_HANDOFF.get(str(p))
    assert ent is not None and ent[0] is not _PENDING_SIG
    # a fresh-process-style read (registry cleared) sees the same bytes
    _PICKLE_HANDOFF.clear()
    assert load_pickle(str(p))["v"].tolist() == obj["v"].tolist()


def test_save_pickle_async_latest_writer_wins(tmp_path):
    """Two write-behind saves to one path: the SECOND object owns the
    registration; after flush the disk holds the second dump."""
    import pickle

    from plotweave.utils.io import flush_pending_saves, load_pickle, save_pickle_async

    p = tmp_path / "wb2.pkl"
    first = {"v": np.arange(10)}
    second = {"v": np.arange(20)}
    save_pickle_async(first, str(p))
    save_pickle_async(second, str(p))
    assert load_pickle(str(p)) is second
    flush_pending_saves()
    assert len(pickle.loads(p.read_bytes())["v"]) == 20
    assert load_pickle(str(p)) is second  # registration not clobbered


def test_save_pickle_async_flush_raises_on_write_error(tmp_path):
    """A failed background dump must surface at the flush barrier — a
    silently lost artifact would corrupt --start-step resume."""
    import pytest

    from plotweave.utils.io import flush_pending_saves, save_pickle_async

    target = tmp_path / "x.pkl"
    # an unpicklable payload makes the background dump itself fail (a
    # filesystem error would too, but root ignores permission bits)
    save_pickle_async({"v": open(os.devnull)}, str(target))
    with pytest.raises(RuntimeError, match="write-behind save"):
        flush_pending_saves()
    flush_pending_saves()  # error queue drained; next flush is clean


def test_pending_entries_never_evicted(tmp_path, monkeypatch):
    """Byte-budget eviction must skip pending entries: their file bytes are
    not on disk yet, so eviction would strand consumers on a missing file."""
    from plotweave.utils import io as pio

    pio.flush_pending_saves()
    pio._PICKLE_HANDOFF.clear()
    pio._PICKLE_HANDOFF_BYTES[0] = 0
    # hold the background writer for the whole test: once the dump completes,
    # the entry is legitimately re-registered as non-pending and EVICTABLE —
    # without the hold, this assertion races the writer thread (a fast dump
    # lets the budget slam below evict it, and load_pickle then returns a
    # fresh unpickle instead of the identical live object)
    monkeypatch.setattr(pio._ASYNC_WRITER, "submit", lambda obj, path: None)
    pending = {"v": np.zeros(1 << 20, np.uint8)}  # 1 MB
    p_pending = tmp_path / "pending.pkl"
    pio.save_pickle_async(pending, str(p_pending))
    # now slam the budget with synchronous saves; the pending entry survives
    old_cap = pio._PICKLE_HANDOFF_BYTE_CAP
    pio._PICKLE_HANDOFF_BYTE_CAP = 2 << 20
    try:
        for i in range(4):
            pio.save_pickle({"v": np.zeros(1 << 20, np.uint8)}, str(tmp_path / f"s{i}.pkl"))
        assert pio.load_pickle(str(p_pending)) is pending
    finally:
        pio._PICKLE_HANDOFF_BYTE_CAP = old_cap
        monkeypatch.undo()
        # complete the held-back dump so the registry entry leaves the
        # pending state with a valid file behind it (tmp dir or not, no
        # global state should outlive the test in a half-written shape)
        pio.save_pickle(pending, str(p_pending))
        pio.flush_pending_saves()


def test_bg_fetch_returns_value_and_reraises():
    """_bg_fetch (stage 02's fetch-overlap helper): the join returns the
    body's value, and a body that raises surfaces its exception AT THE JOIN
    (after the overlapped PNG writes) instead of hanging or vanishing on the
    daemon thread."""
    import pytest

    from plotweave.stages.s02_color_extract import _bg_fetch

    join = _bg_fetch(lambda: np.arange(4))
    np.testing.assert_array_equal(join(), np.arange(4))

    class Boom(RuntimeError):
        pass

    def failing():
        time.sleep(0.05)  # join must WAIT for the body, not race it
        raise Boom("device fetch failed")

    join = _bg_fetch(failing)
    with pytest.raises(Boom, match="device fetch failed"):
        join()


def test_flush_pending_saves_scoped_error_attribution(tmp_path):
    """Batch pipelines share one write-behind writer: image A's dump failure
    must surface in A's scoped flush, not in whichever image flushes next."""
    import pytest

    from plotweave.utils.io import flush_pending_saves, load_pickle, save_pickle_async

    a = tmp_path / "imgA"
    b = tmp_path / "imgB"
    a.mkdir()
    b.mkdir()

    class Unpicklable:
        def __reduce__(self):
            raise RuntimeError("disk exploded")

    save_pickle_async(Unpicklable(), str(a / "contours.pkl"))
    save_pickle_async([1, 2, 3], str(b / "contours.pkl"))

    # B's scoped flush: its own dump is durable, A's error is NOT raised here
    flush_pending_saves(str(b))
    assert load_pickle(str(b / "contours.pkl")) == [1, 2, 3]

    # A's scoped flush gets A's error
    with pytest.raises(RuntimeError, match="write-behind save .*imgA"):
        flush_pending_saves(str(a))

    # and the error was consumed — a later global flush is clean
    flush_pending_saves()
