"""PNG codec (utils/png.py) against cv2 as the oracle: round trips, files
cv2 reads back, files cv2 (and PIL) wrote, every filter type, and the
refusals that keep a missing decoder from changing behaviour silently."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from plotweave.utils import io as pio  # noqa: E402
from plotweave.utils.png import _unfilter_py, decode_png, encode_png  # noqa: E402

SHAPES = [(17, 23), (17, 23, 3), (40, 31, 4), (1, 9), (9, 1, 3), (64, 64, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_round_trip_and_cv2_reads_it(tmp_path, shape):
    img = np.random.default_rng(len(shape) * 100 + shape[0]).integers(0, 256, shape, dtype=np.uint8)
    p = tmp_path / "a.png"
    p.write_bytes(encode_png(img))
    want = img[..., 0] if img.ndim == 3 and img.shape[2] == 1 else img
    assert np.array_equal(cv2.imread(str(p), cv2.IMREAD_UNCHANGED), want)
    gray = want.ndim == 2
    got = decode_png(p.read_bytes(), gray=gray)
    assert np.array_equal(got, want if gray else want[..., :3])


@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra", "gray16", "bgr16"])
def test_decodes_what_cv2_writes(tmp_path, kind):
    rng = np.random.default_rng(5)
    if kind.endswith("16"):
        img = rng.integers(0, 65536, (13, 11) if kind == "gray16" else (13, 11, 3), dtype=np.uint16)
    else:
        img = rng.integers(0, 256, {"gray": (13, 11), "bgr": (13, 11, 3), "bgra": (13, 11, 4)}[kind],
                           dtype=np.uint8)
    p = str(tmp_path / "c.png")
    cv2.imwrite(p, img)
    for gray in ((True, False) if img.ndim == 2 else (False,)):
        want = cv2.imread(p, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        assert np.array_equal(pio.read_image(p, gray=gray), want), gray


@pytest.mark.parametrize("mode", ["1", "P", "L", "LA", "RGBA"])
def test_decodes_pil_palette_and_low_bit_depth(tmp_path, mode):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(7)
    base = Image.fromarray(rng.integers(0, 256, (21, 19, 3), dtype=np.uint8), "RGB")
    im = base.convert(mode) if mode != "P" else base.quantize(colors=13)
    p = str(tmp_path / f"{mode}.png")
    im.save(p, optimize=True)
    assert np.array_equal(pio.read_image(p), cv2.imread(p, cv2.IMREAD_COLOR))


def _filtered_png(img: np.ndarray, ft: int) -> bytes:
    """Encode 8-bit RGB with PNG filter ``ft`` on every row (test oracle)."""
    h, w, c = img.shape
    raw = img[:, :, ::-1].reshape(h, w * c).astype(np.int32)
    rows = []
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        cur = raw[y]
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if ft == 0:
            f = cur
        elif ft == 1:
            f = cur - left
        elif ft == 2:
            f = cur - prev
        elif ft == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            f = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([ft]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_every_filter_type(tmp_path, ft):
    img = np.random.default_rng(ft).integers(0, 256, (12, 10, 3), dtype=np.uint8)
    data = _filtered_png(img, ft)
    p = tmp_path / "f.png"
    p.write_bytes(data)
    assert np.array_equal(cv2.imread(str(p)), img)  # the oracle agrees the file is valid
    assert np.array_equal(decode_png(data), img)
    # the Python executable spec of the native unfilter
    (n,) = struct.unpack(">I", data[33:37])
    rows = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8)
    assert np.array_equal(_unfilter_py(rows, 12, 30, 3).reshape(12, 10, 3)[:, :, ::-1], img)


def test_refusals(tmp_path, monkeypatch):
    img = np.zeros((4, 4, 3), np.uint8)
    p = tmp_path / "c.png"
    p.write_bytes(encode_png(img))
    with pytest.raises(ValueError, match="colour PNG requested as gray"):
        pio.read_image(str(p), gray=True)
    jpg = tmp_path / "x.jpg"
    cv2.imwrite(str(jpg), img)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ValueError, match="only PNG input is decoded without OpenCV"):
        pio.read_image(str(jpg))
    with pytest.raises(ValueError, match="only PNG artifacts"):
        pio.write_image(str(tmp_path / "y.jpg"), img)


def test_interlaced_is_refused():
    good = encode_png(np.zeros((8, 8, 3), np.uint8))
    ihdr = bytearray(good[16:29])
    ihdr[12] = 1  # interlace method: Adam7
    bad = good[:8] + good[8:16] + bytes(ihdr) + struct.pack(">I", zlib.crc32(b"IHDR" + bytes(ihdr))) + good[33:]
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(bad)
