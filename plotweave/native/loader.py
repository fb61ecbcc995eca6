"""Build + load the native library via ctypes."""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = tuple(os.path.join(_HERE, f) for f in ("encoder.cpp", "raster.cpp"))
# build products live beside the sources in a git-ignored directory, one file
# per build key: a library is only ever loaded by a host whose compiler,
# flags and ISA produced it (a checkout copied to another machine rebuilds)
_BUILD_DIR = os.path.join(_HERE, "_build")
# -ffp-contract=off: the encoder/greedy float math must match numpy
# bit-for-bit, and the drawing/min-circle ports must match OpenCV's SSE2
# builds; FMA contraction would change last-ulp results and flip near-tie
# selections.  -march=native widens the auto-vectorized elementwise loops; it
# cannot change float results (contraction stays off, and GCC never
# vectorizes FP reductions without -fassociative-math).
_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")
_NATIVE_ISA = ("-march=native",)
_BUILD_TIMEOUT_S = 300

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _host_isa() -> str:
    """Machine name plus the CPU feature flags -march=native resolves from."""
    flags = ""
    try:
        with open("/proc/cpuinfo", "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{platform.machine()} {flags}"


def _compiler_version() -> str:
    out = subprocess.run(["g++", "--version"], check=True, capture_output=True,
                         text=True, timeout=60).stdout
    return out.splitlines()[0] if out else ""


def build_key(sources, flags, compiler: str, isa: str) -> str:
    """Hash of everything that determines the library's machine code."""
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
        h.update(b"\0")
    h.update(" ".join(flags).encode())
    h.update(b"\0" + compiler.encode() + b"\0" + isa.encode())
    return h.hexdigest()[:24]


def _compile(flags, key: str) -> str:
    lib = os.path.join(_BUILD_DIR, f"libplotweave-{key}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    subprocess.run(["g++", *flags, "-o", tmp, *_SOURCES], check=True,
                   capture_output=True, timeout=_BUILD_TIMEOUT_S)
    os.replace(tmp, lib)
    return lib


def _build() -> Optional[str]:
    """Path of a library built from the committed sources for this host,
    compiling it when no build with the same key exists; None on failure."""
    try:
        compiler = _compiler_version()
        isa = _host_isa()
        flags = _NATIVE_ISA + _FLAGS
        try:
            return _compile(flags, build_key(_SOURCES, flags, compiler, isa))
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
            # the compiler rejected (or choked on) -march=native: baseline ISA
            return _compile(_FLAGS, build_key(_SOURCES, _FLAGS, compiler, ""))
    except (OSError, subprocess.SubprocessError) as e:
        print(f"[plotweave.native] build failed, using Python fallback: {e}", file=sys.stderr)
        return None


class PwProfile(ctypes.Structure):
    _fields_ = [
        ("div_start", ctypes.c_int32),
        ("div_fast", ctypes.c_int32),
        ("profile_scurve", ctypes.c_int32),
        ("corner_deg", ctypes.c_double),
        ("corner_div", ctypes.c_int32),
        ("corner_window_steps", ctypes.c_int32),
        ("short_len_steps", ctypes.c_int32),
        ("short_div", ctypes.c_int32),
        ("travel_div_fast", ctypes.c_int32),
        ("travel_start_div", ctypes.c_int32),
        ("travel_window_steps", ctypes.c_int32),
        ("travel_quant_step", ctypes.c_int32),
    ]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.pw_writer_new.restype = ctypes.c_void_p
    lib.pw_writer_free.argtypes = [ctypes.c_void_p]
    for f in ("pw_pen_up", "pw_pen_down", "pw_tap"):
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.pw_color.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pw_set_speed.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pw_size.argtypes = [ctypes.c_void_p]
    lib.pw_size.restype = ctypes.c_int64
    lib.pw_finalize.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.pw_finalize.restype = ctypes.c_int64
    lib.pw_polyline.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(PwProfile),
    ]
    lib.pw_travel.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(PwProfile),
    ]
    lib.pw_trace.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    lib.pw_trace.restype = ctypes.c_int64
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        if os.environ.get("PLOTWEAVE_NO_NATIVE"):
            return None
        path = _build()
        if path is not None:
            try:
                _lib = _bind(ctypes.CDLL(path))
            except OSError as e:
                print(f"[plotweave.native] load failed: {e}", file=sys.stderr)
    return _lib


def available() -> bool:
    return get_lib() is not None


def bind_virtual_draw(lib: ctypes.CDLL) -> None:
    if hasattr(lib, "_pw_vd_bound"):
        return
    lib.pw_virtual_draw.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    lib.pw_virtual_draw.restype = ctypes.c_int64
    lib.pw_resample_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pw_resample_batch.restype = ctypes.c_int64
    lib.pw_virtual_draw_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pw_virtual_draw_batch.restype = ctypes.c_int64
    lib._pw_vd_bound = True


def bind_cv_kmeans(lib: ctypes.CDLL) -> None:
    if hasattr(lib, "_pw_km_bound"):
        return
    lib.pw_cv_kmeans.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.pw_cv_kmeans.restype = ctypes.c_double
    lib.pw_km_assign.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib._pw_km_bound = True


def bind_skeleton_ops(lib: ctypes.CDLL) -> None:
    if hasattr(lib, "_pw_skel_bound"):
        return
    lib.pw_thin.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.pw_thin.restype = ctypes.c_int
    lib.pw_comp_path.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    lib.pw_comp_path.restype = ctypes.c_int64
    lib.pw_comp_paths_all.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pw_comp_paths_all.restype = ctypes.c_int64
    lib.pw_degree.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.pw_arc_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.pw_arc_batch_ptrs.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.pw_scale_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.pw_greedy_order.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.pw_gcode_tokens.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.pw_gcode_tokens.restype = ctypes.c_int64
    lib.pw_gcode_text.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int64,
    ]
    lib.pw_gcode_text.restype = ctypes.c_int64
    lib.pw_order_l1.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib._pw_skel_bound = True


def bind_find_period(lib: ctypes.CDLL) -> None:
    if hasattr(lib, "_pw_period_bound"):
        return
    lib.pw_find_period.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pw_find_period.restype = ctypes.c_int
    lib._pw_period_bound = True


def bind_raster(lib: ctypes.CDLL) -> None:
    if hasattr(lib, "_pw_raster_bound"):
        return
    u8p = ctypes.POINTER(ctypes.c_uint8)
    vp = ctypes.c_void_p
    lib.pw_draw_polylines.argtypes = [
        vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        vp, vp, ctypes.c_int64, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.pw_draw_polylines.restype = None
    lib.pw_draw_circle.argtypes = [
        vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.pw_draw_circle.restype = None
    lib.pw_min_enclosing_circle.argtypes = [vp, ctypes.c_int64, vp]
    lib.pw_min_enclosing_circle.restype = None
    lib.pw_png_unfilter.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, u8p]
    lib.pw_png_unfilter.restype = ctypes.c_int
    lib.pw_copy_nonwhite.argtypes = [vp, vp, ctypes.c_int64]
    lib.pw_copy_nonwhite.restype = None
    lib._pw_raster_bound = True
