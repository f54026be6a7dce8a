"""
What the program promises about the device it runs on: every operator
matmul of the device step runs at the one precision constant; no module
reaches for a Pallas backend other than the GPU ones; the compile cache goes to
$JAX_COMPILATION_CACHE_DIR or a fixed directory in the checkout; and the
measurement entry points refuse a backend that is not a GPU.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aind_smartspim_destripe_tpu import runtime
from aind_smartspim_destripe_tpu.ops import wavelets
from aind_smartspim_destripe_tpu.ops.dual_band import dual_band_destripe_batch
from aind_smartspim_destripe_tpu.ops.filter import (
    FilterConfig,
    build_plan,
    destripe_batch,
)

ROOT = Path(__file__).resolve().parent.parent
# Pallas entry points a GPU build may import; any other
# jax.experimental.pallas submodule targets another accelerator
GPU_PALLAS = {
    "jax.experimental.pallas",
    "jax.experimental.pallas.triton",
    "jax.experimental.pallas.mosaic_gpu",
}
# Pallas' own Mosaic lowering (Mosaic GPU is the separate ``mosaic_gpu``)
NON_GPU_LOWERING = "jax._src.pallas.mosaic"


def _dot_precisions(closed):
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(closed.jaxpr)
    return found


def _expected(p):
    return (p, p) if isinstance(p, jax.lax.Precision) else p


def _step_jaxpr(kind):
    plan = build_plan(
        96, 128,
        FilterConfig(wavelet="db3", level=None, sigma=64, max_threshold=3),
        FilterConfig(wavelet="db3", level=None, sigma=128, max_threshold=12),
    )
    x = jnp.zeros((2, 96, 128), jnp.uint16)
    consts = plan.constants()
    if kind == "single":
        flat = jnp.ones((96, 128))
        return jax.make_jaxpr(
            lambda a, f, d: destripe_batch(plan, a, 2500.0, consts, flat=f,
                                           dark=d)
        )(x, flat, flat * 0)
    if kind == "dual":
        return jax.make_jaxpr(
            lambda a: dual_band_destripe_batch(plan, a, consts=consts)
        )(x)
    # the plane-sharded production step: shard_map over a 4-device mesh
    from aind_smartspim_destripe_tpu.runtime.pipeline import make_device_step

    step = make_device_step(plan, 2500.0, False, devices=jax.devices()[:4])
    one = jnp.ones((1, 1))
    return jax.make_jaxpr(step)(jnp.zeros((4, 96, 128), jnp.uint16), one,
                                one * 0)


@pytest.mark.parametrize("kind", ["single", "dual", "sharded"])
def test_precision_constant_reaches_every_dot(kind):
    precs = _dot_precisions(_step_jaxpr(kind))
    assert len(precs) >= 10
    want = _expected(wavelets.MATMUL_PRECISION)
    assert all(p == want for p in precs), set(map(str, precs))


def test_precision_constant_is_read_at_trace_time(monkeypatch):
    """Reassigning the constant (the precision sweep does) moves every
    matmul of a freshly traced step."""
    p = jax.lax.Precision.HIGHEST
    if wavelets.MATMUL_PRECISION == p:
        p = jax.lax.Precision.HIGH
    monkeypatch.setattr(wavelets, "MATMUL_PRECISION", p)
    precs = _dot_precisions(_step_jaxpr("single"))
    assert precs and all(q == _expected(p) for q in precs)


def _foreign_pallas(module: str) -> bool:
    parts = module.split(".")
    return (parts[:3] == ["jax", "experimental", "pallas"] and len(parts) > 3
            and ".".join(parts[:4]) not in GPU_PALLAS)


def test_foreign_pallas_predicate():
    assert _foreign_pallas("jax.experimental.pallas.some_backend")
    assert not _foreign_pallas("jax.experimental.pallas")
    assert not _foreign_pallas("jax.experimental.pallas.triton")
    assert not _foreign_pallas("jax.experimental.pallas.mosaic_gpu")
    assert not _foreign_pallas("jax.numpy")


def test_no_non_gpu_pallas_anywhere():
    """No file of the repo imports a Pallas backend other than Triton or
    Mosaic GPU, and importing the whole package loads no non-GPU Pallas
    lowering."""
    bad = []
    for path in ROOT.rglob("*.py"):
        if any(part.startswith(".") for part in path.relative_to(ROOT).parts):
            continue
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] + [
                    f"{node.module}.{a.name}" for a in node.names
                ]
            bad += [(str(path), n) for n in names if _foreign_pallas(n)]
    assert not bad, bad
    code = (
        "import pkgutil, importlib, sys, aind_smartspim_destripe_tpu as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(sorted(sys.modules))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    loaded = eval(r.stdout.strip().splitlines()[-1])
    assert not [
        m for m in loaded
        if m == NON_GPU_LOWERING or m.startswith(NON_GPU_LOWERING + ".")
    ]


@pytest.fixture
def cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_follows_env_variable(tmp_path, monkeypatch, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache(2.5) == str(tmp_path)
    # JAX reads the variable itself: nothing else is configured
    assert jax.config.jax_compilation_cache_dir == before
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 2.5


def test_cache_default_is_fixed_in_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = runtime.enable_compile_cache()
    assert got == str(ROOT / ".jax_cache") == runtime.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == got
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 1.0
    assert runtime.enable_compile_cache() == got  # same path every call
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_bench_refuses_cpu():
    r = subprocess.run(
        [sys.executable, str(ROOT / "bench.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert "MPix" not in r.stdout


def test_require_gpu_refuses_cpu():
    from aind_smartspim_destripe_tpu.runtime.device import require_gpu

    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu()


# an environment read: os.environ.get("X") / os.environ["X"] / getenv("X")
_ENV_READ = re.compile(
    r'(?:environ(?:\.get)?\s*[\(\[]|getenv\()\s*"(DESTRIPE_[A-Z_]+)"'
)


def _knobs_read():
    names = set()
    files = list((ROOT / "aind_smartspim_destripe_tpu").rglob("*.py"))
    files += list((ROOT / "csrc").glob("*.cpp")) + [ROOT / "bench.py"]
    for path in files:
        names |= set(_ENV_READ.findall(path.read_text()))
    return names


def _knobs_documented():
    table = (ROOT / "README.md").read_text().split("## Environment knobs")[1]
    return set(re.findall(r"`(DESTRIPE_[A-Z_]+)`", table))


@pytest.mark.parametrize("knob", sorted(_knobs_documented()))
def test_documented_knob_is_read(knob):
    """Every knob of the README's table is read by the program."""
    assert knob in _knobs_read()


def test_every_knob_read_is_documented():
    assert _knobs_read() <= _knobs_documented(), (
        _knobs_read() - _knobs_documented()
    )
