"""Where compiled artifacts live: the native library's build key and the
persistent XLA compilation cache directory."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

from plotweave.native import loader

ROOT = Path(__file__).resolve().parents[1]


def _key(**kw):
    args = dict(sources=loader._SOURCES, flags=loader._NATIVE_ISA + loader._FLAGS,
                compiler="g++ (X) 12.2.0", isa="x86_64 sse2 avx2")
    args.update(kw)
    return loader.build_key(args["sources"], args["flags"], args["compiler"], args["isa"])


@pytest.mark.parametrize(
    "change",
    [{"flags": loader._FLAGS}, {"compiler": "g++ (X) 13.1.0"}, {"isa": "x86_64 sse2"},
     {"isa": "aarch64 neon"}],
    ids=["flags", "compiler", "isa", "machine"],
)
def test_build_key_tracks_what_shapes_the_binary(change):
    assert _key() != _key(**change)
    assert _key() == _key()


def test_build_key_tracks_source_contents(tmp_path):
    a, b = tmp_path / "a.cpp", tmp_path / "b.cpp"
    a.write_text("int f() { return 1; }\n")
    b.write_text("int g() { return 2; }\n")
    k1 = _key(sources=(str(a), str(b)))
    a.write_text("int f() { return 3; }\n")
    assert _key(sources=(str(a), str(b))) != k1


def test_library_is_built_from_the_committed_sources_under_its_key():
    lib = loader.get_lib()
    assert lib is not None
    path = Path(lib._name)
    assert path.parent == Path(loader._BUILD_DIR)
    assert path.name.startswith("libplotweave-") and path.suffix == ".so"
    assert {Path(s).name for s in loader._SOURCES} == {"encoder.cpp", "raster.cpp"}
    # the build directory is ignored by git: a checkout copied to another
    # machine carries no library built here
    r = subprocess.run(["git", "check-ignore", "-q", str(path)], cwd=ROOT)
    assert r.returncode == 0


def test_compilation_cache_dir_rule():
    import plotweave

    assert plotweave.compilation_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) == "/x/y"
    assert plotweave.compilation_cache_dir({}) == str(ROOT / ".jax_cache")


@pytest.mark.parametrize("preset", [None, "/tmp/pw-cache-test"], ids=["default", "env"])
def test_compilation_cache_dir_in_a_fresh_process(preset):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    if preset:
        env["JAX_COMPILATION_CACHE_DIR"] = preset
    code = "import jax, plotweave; print(jax.config.jax_compilation_cache_dir)"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout.split()[-1]
    assert out == (preset or str(ROOT / ".jax_cache"))
