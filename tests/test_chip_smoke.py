"""
chip_smoke.py on the CPU: it must refuse to run without a GPU (and outside a
checkout) and print no result, its result line has the exact contract
format, and its phases pass at a tiny geometry here — the rehearsal of the
full-size run on the card (the 4-card phase on 4 virtual CPU devices).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _has_result(stdout: str) -> bool:
    return any('"ok"' in line for line in stdout.splitlines())


def test_refuses_cpu():
    r = _run(ROOT, ROOT / "chip_smoke.py")
    assert r.returncode != 0
    assert not _has_result(r.stdout)
    assert "no GPU" in r.stderr


def test_refuses_outside_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert not _has_result(r.stdout)


def test_result_line_format():
    devs = [SimpleNamespace(platform="gpu",
                            device_kind="NVIDIA H100 80GB HBM3")]
    line = chip_smoke.result_line(devs)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    assert json.loads(line)["device"]["count"] == 1


def test_sample_planes_dim_and_bright():
    for z in (4, 64, 256):
        zs = chip_smoke._sample_planes(z)
        assert len(zs) == 4 and max(zs) < z
        assert sum(v % 2 for v in zs) == 2  # two bright (odd), two dim


def test_phase_codec(monkeypatch):
    """The phase rebuilds the library through the loader: afterwards it is
    newer than every tracked source."""
    from aind_smartspim_destripe_tpu.io import blosc

    monkeypatch.setattr(blosc, "_native", None)  # load anew in this process
    backend = chip_smoke.phase_codec()
    assert backend in ("native", "zstandard")
    if backend == "native":
        csrc = ROOT / "csrc"
        assert not blosc._native_stale(
            str(csrc / "libdestripe_runtime.so"), str(csrc)
        )


def test_phase_capsule_single_small(tmp_path):
    rep = chip_smoke.phase_capsule_single(tmp_path, 0, planes=4, h=96, w=128)
    assert len(rep["psnr_db"]) == 8
    assert min(rep["psnr_db"].values()) >= chip_smoke.PSNR_GATE_DB


def test_phase_capsule_dual_small(tmp_path):
    rep = chip_smoke.phase_capsule_dual(tmp_path, 0, planes=4, h=96, w=128)
    assert len(rep["psnr_db"]) == 4
    assert min(rep["psnr_db"].values()) >= chip_smoke.PSNR_GATE_DB


def test_phase_four_cards_small():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    rep = chip_smoke.phase_four_cards(0, jax.devices()[:4], planes=8,
                                      h=160, w=256)
    assert rep["plane_sharded"]["max_lsb"] <= 1
    assert rep["plane_sharded"]["frac_differ"] < 1e-3
    assert set(rep) == {"planes", "one_card_s", "plane_sharded_s",
                        "plane_sharded"}


def test_four_card_inputs_alternate_dim_and_bright():
    vol, flat, dark, plan = chip_smoke.four_card_inputs(0, planes=4, h=64,
                                                        w=80)
    assert vol.shape == (4, 64, 80) and vol.dtype.name == "uint16"
    means = vol.reshape(4, -1).mean(axis=1)
    assert means[0] < 1000 < means[1] and means[2] < 1000 < means[3]
    assert flat.shape == dark.shape == (64, 80)
    assert (plan.height, plan.width) == (64, 80)


@pytest.mark.gpu
def test_phases_small_on_gpu(gpu, tmp_path):
    """The same phases at the tiny geometry on the card (chip_smoke.py runs
    them at full size)."""
    chip_smoke.phase_capsule_single(tmp_path / "s", 0, planes=4, h=96, w=128)
    chip_smoke.phase_capsule_dual(tmp_path / "d", 0, planes=4, h=96, w=128)
