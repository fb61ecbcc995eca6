"""plotweave — JAX image→plotter-stream framework.

A rebuild of the OmniRevolve image processor (reference:
omnirevolve/omnirevolve-image-processor): raster images (and SVG / G-code
inputs) become binary motion streams for an 8-pen XY plotter.  The dense
raster chain runs as fused XLA programs on the accelerator (an NVIDIA GPU);
the serial host stages run in a small C++ library.

Layering (see SURVEY.md for the reference layer map this mirrors):

- ``plotweave.stream``   — byte protocol: encoder (motion planning + byte
  serialization), decoder/simulator (the executable spec / test oracle).
- ``plotweave.ops``      — batched, jittable image ops (resize, Lab k-means,
  morphology, Gaussian, Canny, Zhang–Suen thinning).
- ``plotweave.vector``   — geometry stages: centerline tracing, scaling,
  travel-order sorting, intra-/cross-layer dedup, plot-order planning.
- ``plotweave.stages``   — the 14 numbered pipeline stages with the
  reference-compatible on-disk artifact contract.
- ``plotweave.frontends``— SVG / G-code input paths.
- ``plotweave.parallel`` — device-mesh sharding utilities (batch of images
  over cards via jax.sharding + shard_map).
"""

__version__ = "0.1.0"

import os as _os  # noqa: E402

# <checkout>/.jax_cache: a fixed path (the path is part of the cache key)
# inside the checkout, git-ignored
_DEFAULT_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def compilation_cache_dir(environ=None) -> str:
    """Persistent XLA compilation cache: ``JAX_COMPILATION_CACHE_DIR`` when
    set, else the checkout's ``.jax_cache``."""
    env = _os.environ if environ is None else environ
    return env.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_CACHE


def _enable_compilation_cache() -> None:
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return  # JAX reads the variable itself; set nothing else
    _os.environ["JAX_COMPILATION_CACHE_DIR"] = _DEFAULT_CACHE
    import sys as _sys

    if "jax" in _sys.modules:  # jax already imported: its config read the env
        _sys.modules["jax"].config.update("jax_compilation_cache_dir", _DEFAULT_CACHE)


_enable_compilation_cache()


def _retain_heap() -> None:
    """Keep freed large buffers in the process heap (glibc mallopt).

    By default glibc serves multi-MB numpy temporaries via mmap and munmaps
    them on free, so every stage's big temporary re-pays fresh page faults.
    On the earlier one-core development host that cost was pathological and
    episodic: 55 ms/MB during bad phases (a 240 MB first-touch took 13 s)
    vs ~0.3 ms/MB warm, both measured there; on GPU hosts it is not measured
    yet.  Raising the mmap/trim thresholds makes the heap grow to the
    pipeline's peak working set once and stay there.
    Opt out with PLOTWEAVE_NO_MALLOC_TUNE=1.
    """
    if _os.environ.get("PLOTWEAVE_NO_MALLOC_TUNE"):
        return
    try:
        import ctypes as _ctypes

        libc = _ctypes.CDLL(None)
        GB = 1 << 30
        libc.mallopt(-3, GB)  # M_MMAP_THRESHOLD: heap-serve allocations < 1 GB
        libc.mallopt(-1, GB)  # M_TRIM_THRESHOLD: never return freed heap < 1 GB
    except (OSError, AttributeError):  # pragma: no cover — non-glibc hosts
        pass


_retain_heap()
