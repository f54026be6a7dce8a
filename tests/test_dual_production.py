"""
Dual-band mode through the PRODUCTION surfaces (round-3): the device step,
the streaming Zarr orchestrator, the filter_stripes facade, and the legacy
file-batch path all route to ops/dual_band.py when asked, with the same
epilogue semantics as the classifier path (wrap cast / flat-field).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aind_smartspim_destripe_tpu import filtering
from aind_smartspim_destripe_tpu.ops import dual_band as db
from aind_smartspim_destripe_tpu.ops.filter import FilterConfig, build_plan
from aind_smartspim_destripe_tpu.ops.flatfield import flatfield_correction
from aind_smartspim_destripe_tpu.runtime.pipeline import make_device_step

H, W, Z = 120, 160, 16

CELLS = {"wavelet": "db3", "level": None, "sigma": 64, "max_threshold": 3}
NO_CELLS = {"wavelet": "db3", "level": None, "sigma": 128, "max_threshold": 12}


def _plan():
    return build_plan(
        H, W, FilterConfig.from_dict(CELLS), FilterConfig.from_dict(NO_CELLS)
    )


def _vol(z=Z):
    rng = np.random.default_rng(3)
    return np.clip(
        300
        + (rng.normal(size=(z, H, 1)) * 60) * np.ones((1, 1, W))
        + rng.normal(size=(z, H, W)) * 10,
        0,
        65535,
    ).astype(np.uint16)


def _expected(vol, flat=None, dark=None):
    plan = _plan()
    blended = db.dual_band_destripe_batch(
        plan,
        jnp.asarray(vol.astype(np.float32)),
        100.0,
        -1.0,
        consts=plan.constants(),
    )
    if flat is not None:
        return np.asarray(flatfield_correction(blended, flat, dark))
    from aind_smartspim_destripe_tpu.ops.filter import wrap_cast

    return np.asarray(wrap_cast(blended))


def _assert_lsb(a, b, tol=1):
    # batch-extent / sharding changes XLA's reduction vectorization ->
    # 1 f32 ulp -> at most 1 uint16 LSB after the cast; never gate bitwise
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= tol, f"max LSB diff {d.max()}"


def test_device_step_dual_wrap():
    vol = _vol()
    step = make_device_step(_plan(), 2500.0, with_flatfield=False, dual=True)
    out = np.asarray(
        step(
            step.put(vol),
            step.put_const(np.ones((1, 1), np.float32)),
            step.put_const(np.zeros((1, 1), np.float32)),
        )
    )
    assert out.dtype == np.uint16
    _assert_lsb(out, _expected(vol))


def test_device_step_dual_flatfield():
    vol = _vol()
    flat = np.full((H, W), 1.25, np.float32)
    dark = np.full((H, W), 4.0, np.float32)
    step = make_device_step(_plan(), 2500.0, with_flatfield=True, dual=True)
    out = np.asarray(
        step(step.put(vol), step.put_const(flat), step.put_const(dark))
    )
    assert out.dtype == np.uint16
    _assert_lsb(out, _expected(vol, flat, dark))


def test_device_step_dual_multichip_identity():
    devices = jax.local_devices()
    if len(devices) < 2:
        pytest.skip("needs the multi-device CPU mesh")
    vol = _vol(Z)  # Z=16 divides the 8-way z mesh
    step = make_device_step(
        _plan(), 2500.0, with_flatfield=False, devices=devices, dual=True
    )
    assert step.n_devices == len(devices)
    out = np.asarray(
        step(
            step.put(vol),
            step.put_const(np.ones((1, 1), np.float32)),
            step.put_const(np.zeros((1, 1), np.float32)),
        )
    )
    _assert_lsb(out, _expected(vol))


def test_dual_crossover_must_be_positive():
    img = _vol(1)[0]
    for bad in (0.0, -5.0):
        with pytest.raises(ValueError, match="crossover"):
            db.dual_band_destripe_configs(img, CELLS, NO_CELLS, crossover=bad)


def test_dual_configs_must_share_wavelet_level():
    img = _vol(1)[0]
    with pytest.raises(NotImplementedError):
        db.dual_band_destripe_configs(
            img, {"wavelet": "db2", "sigma": 64}, {"wavelet": "db3", "sigma": 128}
        )


def test_filter_stripes_dual_facade():
    img = _vol(1)[0]
    out = filtering.filter_stripes(
        image=img,
        no_cells_config=NO_CELLS,
        cells_config=CELLS,
        dual_band={"crossover": 100.0, "threshold": -1.0},
    )
    direct = db.dual_band_destripe_configs(img, CELLS, NO_CELLS)
    np.testing.assert_allclose(out, direct, rtol=0, atol=1e-3)
    # and the classifier path is genuinely different from the blend
    single = filtering.filter_stripes(
        image=img, no_cells_config=NO_CELLS, cells_config=CELLS
    )
    assert np.abs(out - single).max() > 0.5


def test_destripe_zarr_dual_e2e(tmp_path):
    from aind_smartspim_destripe_tpu import zarr_destriper as zd
    from aind_smartspim_destripe_tpu.io.zarr import group, open_zarr

    vol = _vol()
    tile = group(str(tmp_path / "data" / "100000_200000.zarr"))
    lvl0 = tile.create_dataset(
        0, shape=(1, 1, Z, H, W), chunks=(1, 1, 8, 64, 64), dtype=np.uint16
    )
    lvl0[:] = vol[None, None]
    results = tmp_path / "results"
    results.mkdir()

    zd.destripe_zarr(
        dataset_path=tmp_path / "data" / "100000_200000.zarr",
        multiscale="0",
        output_destriped_zarr=results / "Ex_488_Em_525" / "100000_200000.zarr",
        prediction_chunksize=(8, H, W),
        target_size_mb=64,
        n_workers=0,
        batch_size=1,
        super_chunksize=(16, H, W),
        results_folder=results,
        derivatives_path=None,
        xyz_resolution=(1.8, 1.8, 2.0),
        parameters={
            "no_cells_config": NO_CELLS,
            "cells_config": CELLS,
            "dual_band": True,
        },
        devices=jax.local_devices()[:1],
    )
    out = np.asarray(
        open_zarr(str(results / "Ex_488_Em_525" / "100000_200000.zarr"))["0"][:]
    )[0, 0]
    _assert_lsb(out, _expected(vol))

    # the journal records the mode, so a single-band resume can't reuse it
    import json

    journal = json.loads(
        (
            results / "Ex_488_Em_525" / "100000_200000.zarr" / "0"
            / ".destripe_journal.json"
        ).read_text()
    )
    assert journal["meta"]["dual"] is True


def test_destripe_zarr_dual_sharded_e2e(tmp_path):
    """destripe_zarr in dual mode over every local device (planes sharded
    over the mesh): store contents match the single-device dual run to
    <= 1 LSB and the journal still pins dual."""
    if len(jax.local_devices()) < 2:
        pytest.skip("needs the multi-device CPU mesh")
    from aind_smartspim_destripe_tpu import zarr_destriper as zd
    from aind_smartspim_destripe_tpu.io.zarr import group, open_zarr

    vol = _vol()
    tile = group(str(tmp_path / "data" / "100000_200000.zarr"))
    lvl0 = tile.create_dataset(
        0, shape=(1, 1, Z, H, W), chunks=(1, 1, 8, 64, 64), dtype=np.uint16
    )
    lvl0[:] = vol[None, None]

    outs = {}
    for tag in ("one", "all"):
        results = tmp_path / f"results_{tag}"
        results.mkdir()
        zd.destripe_zarr(
            dataset_path=tmp_path / "data" / "100000_200000.zarr",
            multiscale="0",
            output_destriped_zarr=(
                results / "Ex_488_Em_525" / "100000_200000.zarr"
            ),
            prediction_chunksize=(8, H, W),
            target_size_mb=64,
            n_workers=0,
            batch_size=1,
            super_chunksize=(16, H, W),
            results_folder=results,
            derivatives_path=None,
            xyz_resolution=(1.8, 1.8, 2.0),
            parameters={
                "no_cells_config": NO_CELLS,
                "cells_config": CELLS,
                "dual_band": True,
            },
            devices=jax.local_devices()[:1] if tag == "one" else None,
        )
        outs[tag] = np.asarray(
            open_zarr(
                str(results / "Ex_488_Em_525" / "100000_200000.zarr")
            )["0"][:]
        )[0, 0]

    _assert_lsb(outs["all"], outs["one"])
    assert outs["all"].any()

    import json

    journal = json.loads(
        (
            tmp_path / "results_all" / "Ex_488_Em_525"
            / "100000_200000.zarr" / "0" / ".destripe_journal.json"
        ).read_text()
    )
    assert journal["meta"]["dual"] is True


def test_batch_filter_dual(tmp_path):
    from aind_smartspim_destripe_tpu.destriper import batch_filter
    from aind_smartspim_destripe_tpu.io.readers import imread
    from aind_smartspim_destripe_tpu.io.writers import imsave

    inp = tmp_path / "in"
    outp = tmp_path / "out"
    inp.mkdir()
    outp.mkdir()
    vol = _vol(2)
    for i, plane in enumerate(vol):
        imsave(str(inp / f"plane_{i}.tiff"), plane)

    batch_filter(
        input_path=inp,
        output_path=outp,
        workers=1,
        chunks=2,
        high_int_filt_params=CELLS,
        low_int_filt_params=NO_CELLS,
        shadow_correction=None,
        dual_band={},
    )
    expected = db.dual_band_destripe_configs(
        vol.astype(np.float32), CELLS, NO_CELLS
    )
    for i in range(2):
        got = np.asarray(imread(str(outp / f"plane_{i}.tiff")))
        _assert_lsb(got, expected[i].astype(np.uint16))
