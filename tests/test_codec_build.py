"""The native blosc codec is always built from the tracked csrc/ sources on
the host that loads it: a library older than its sources is rebuilt, and
the sources also build where the zstd development header is absent (only
the runtime libzstd.so.1 installed)."""

import os
import shutil

import numpy as np
import pytest

from aind_smartspim_destripe_tpu.io import blosc

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")


def _copy_sources(dst):
    for f in ("Makefile", "destripe_runtime.cpp"):
        shutil.copy(os.path.join(CSRC, f), dst / f)
    return str(dst)


def _bump(path, seconds):
    t = os.path.getmtime(path) + seconds
    os.utime(path, (t, t))


def test_native_stale_rules(tmp_path):
    src = _copy_sources(tmp_path)
    so = os.path.join(src, "libdestripe_runtime.so")
    assert blosc._native_stale(so, src)  # missing
    open(so, "wb").close()
    _bump(so, 10)
    assert not blosc._native_stale(so, src)  # newer than every source
    _bump(os.path.join(src, "destripe_runtime.cpp"), 20)
    assert blosc._native_stale(so, src)  # source edited after the build
    _bump(so, 30)
    _bump(os.path.join(src, "Makefile"), 60)
    assert blosc._native_stale(so, src)  # build rules changed


def _roundtrip(lib, monkeypatch):
    monkeypatch.setattr(blosc, "_native", lib)
    x = (np.arange(1 << 16) % 1021).astype(np.uint16).tobytes()
    frame = blosc.compress(x, 2, clevel=3, shuffle=blosc.SHUFFLE,
                           cname="zstd")
    assert blosc.decompress(frame) == x
    assert blosc.decompress_py(frame) == x  # a standard blosc1 frame


def test_stale_library_is_rebuilt(tmp_path, monkeypatch):
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("needs make and g++")
    src = _copy_sources(tmp_path)
    so = os.path.join(src, "libdestripe_runtime.so")
    lib = blosc._load_from(src)
    assert lib and os.path.exists(so)
    _bump(so, -60)  # the library now predates its sources
    built = os.path.getmtime(so)
    assert blosc._native_stale(so, src)
    lib = blosc._load_from(src)
    assert lib and os.path.getmtime(so) > built
    assert not blosc._native_stale(so, src)
    _roundtrip(lib, monkeypatch)


def test_builds_without_zstd_header(tmp_path, monkeypatch):
    """DESTRIPE_DECLARE_ZSTD takes the declaration block that hosts without
    zstd.h compile; the library must still write standard frames."""
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("needs make and g++")
    src = _copy_sources(tmp_path)
    monkeypatch.setenv(
        "CXXFLAGS", "-O3 -fPIC -std=c++17 -Wall -DDESTRIPE_DECLARE_ZSTD"
    )
    lib = blosc._load_from(src)
    assert lib
    _roundtrip(lib, monkeypatch)


def test_failed_rebuild_never_loads_the_stale_library(tmp_path):
    """A library older than its sources is not loaded when the rebuild
    fails: the caller gets the pure-Python codec instead."""
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("needs make and g++")
    src = _copy_sources(tmp_path)
    so = os.path.join(src, "libdestripe_runtime.so")
    assert blosc._load_from(src)
    cpp = os.path.join(src, "destripe_runtime.cpp")
    with open(cpp, "a") as f:
        f.write("\n#error deliberately broken\n")
    _bump(cpp, 60)
    assert blosc._native_stale(so, src)
    assert blosc._load_from(src) is False


def test_cxxflags_from_environment_reach_the_build(tmp_path, monkeypatch):
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("needs make and g++")
    src = _copy_sources(tmp_path)
    monkeypatch.setenv("CXXFLAGS", "-fPIC -no-such-compiler-flag")
    assert blosc._load_from(src) is False
    assert not os.path.exists(os.path.join(src, "libdestripe_runtime.so"))


def test_missing_source_dir_gives_no_library(tmp_path):
    assert blosc._load_from(str(tmp_path / "absent")) is False
