"""PNG codec on ``zlib`` + numpy (8-bit gray, BGR and BGRA out; any
non-interlaced PNG in).

Writing mirrors cv2.imwrite's defaults (Sub filter on every row, zlib level 1
with the run-length strategy), so artifact encode cost stays what it was;
files are compared by decoded pixels, not bytes.  Reading follows
cv2.imread's conversions: palette expansion, 16→8-bit by the high byte,
1/2/4-bit gray scaled to 8 bits, alpha dropped, RGB stored as BGR.  A
colour file read as gray is refused (cv2 converts it through libpng's
gamma-aware weights, which nothing in the pipeline needs).
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(data, zlib.crc32(kind)) & 0xFFFFFFFF
    )


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA → PNG bytes."""
    a = np.asarray(img)
    if a.dtype == np.bool_:
        a = a.astype(np.uint8)
    if a.dtype != np.uint8:
        raise TypeError(f"PNG writer takes uint8 images, got {a.dtype}")
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[2] not in (1, 3, 4):
        raise ValueError(f"PNG writer takes (H, W[, 1|3|4]) images, got {a.shape}")
    h, w, c = a.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    order = {1: (0,), 3: (2, 1, 0), 4: (2, 1, 0, 3)}[c]  # BGR(A) → RGB(A)
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = 1  # Sub filter: each byte minus the same channel one pixel left
    px = rows[:, 1:].reshape(h, w, c)
    for j, src in enumerate(order):
        px[:, 0, j] = a[:, 0, src]
        np.subtract(a[:, 1:, src], a[:, :-1, src], out=px[:, 1:, j])
    comp = zlib.compressobj(1, zlib.DEFLATED, 15, 8, zlib.Z_RLE)
    idat = comp.compress(rows.data) + comp.flush()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return _SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat) + _chunk(b"IEND", b"")


def _unfilter_py(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Executable spec of PNG row unfiltering (the native loop's reference)."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft = int(rows[y, 0])
        src = rows[y, 1:].astype(np.int32)
        if ft == 0:
            cur = src
        elif ft == 1:
            cur = src.copy()
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif ft == 2:
            cur = (src + prev) & 0xFF
        elif ft in (3, 4):
            cur = src.copy()
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prev[i - bpp]) if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"corrupt PNG: filter type {ft}")
        out[y] = cur
        prev = cur
    return out


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    from ..native.loader import bind_raster, get_lib  # noqa: PLC0415

    buf = np.frombuffer(raw, np.uint8)
    if buf.size < h * (stride + 1):
        raise ValueError("corrupt PNG: image data too short")
    buf = buf[: h * (stride + 1)]
    lib = get_lib()
    if lib is None:
        return _unfilter_py(buf, h, stride, bpp)
    bind_raster(lib)
    src = np.ascontiguousarray(buf)
    out = np.empty((h, stride), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if lib.pw_png_unfilter(src.ctypes.data_as(u8p), h, stride, bpp, out.ctypes.data_as(u8p)):
        raise ValueError("corrupt PNG: unknown filter type")
    return out


def _expand_bits(rows: np.ndarray, w: int, c: int, depth: int) -> np.ndarray:
    """Unfiltered rows → (H, W, C) samples of 8 bits (16-bit keeps the
    high byte; sub-byte samples stay as raw indices/levels)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, : w * c].reshape(h, w, c)
    if depth == 16:
        return rows[:, : 2 * w * c].reshape(h, w, c, 2)[..., 0]
    bits = np.unpackbits(rows, axis=1)[:, : w * c * depth].reshape(h, w * c, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8).reshape(h, w, c)


def decode_png(data: bytes, gray: bool = False) -> np.ndarray:
    """PNG bytes → uint8 (H, W) when ``gray`` else (H, W, 3) BGR."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos, ihdr, plte, idat = 8, None, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("corrupt PNG: missing IHDR or IDAT")
    w, h, depth, ctype, _cm, _fm, interlace = ihdr
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"unsupported PNG colour type {ctype} / bit depth {depth}")
    if interlace:
        raise ValueError("interlaced PNG: re-save it non-interlaced (the built-in decoder reads only those)")
    c = _CHANNELS[ctype]
    stride = (w * c * depth + 7) // 8
    bpp = max(1, c * depth // 8)
    samples = _expand_bits(_unfilter(zlib.decompress(b"".join(idat)), h, stride, bpp), w, c, depth)
    if ctype == 3:
        if plte is None:
            raise ValueError("corrupt PNG: palette image without PLTE")
        rgb = plte[np.minimum(samples[..., 0], len(plte) - 1)]
    elif ctype in (0, 4):
        g = samples[..., 0]
        if depth < 8:
            g = (g.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(np.uint8)
        if gray:
            return np.ascontiguousarray(g)
        return np.repeat(g[:, :, None], 3, axis=2)
    else:
        rgb = samples[..., :3]
    if gray:
        # cv2 converts through libpng's gamma-aware rgb_to_gray here; no
        # pipeline artifact needs it, so refuse rather than approximate
        raise ValueError("colour PNG requested as gray: read it as colour instead")
    return np.ascontiguousarray(rgb[:, :, ::-1])
