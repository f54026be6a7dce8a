"""
Multi-chip execution of the PRODUCTION pipeline (not just the mesh helpers):
StreamingDestriper / destripe_zarr shard each device batch over every local
device via a 1-D z mesh (runtime/pipeline.make_device_step). On the 8-virtual-
device CPU backend (conftest.py) the sharded run must match a single-device
run to <= 1 uint16 LSB — per-plane compute has no cross-plane math, but XLA
may vectorize reductions differently at different batch extents, giving rare
1-ulp float jitter (the same tolerance the e2e kernel gate uses). This is the
device equivalent of the reference's producer + co_cpus consumer pool
(zarr_destriper.py:1136-1172).
"""

import os

import jax
import numpy as np
import pytest

from aind_smartspim_destripe_tpu import zarr_destriper as zd
from aind_smartspim_destripe_tpu.io.writers import imsave
from aind_smartspim_destripe_tpu.io.zarr import group, open_zarr
from aind_smartspim_destripe_tpu.ops.filter import FilterConfig, build_plan
from aind_smartspim_destripe_tpu.runtime.pipeline import (
    StreamingDestriper,
    make_device_step,
)

H, W, Z = 64, 80, 12

PARAMETERS = {
    "no_cells_config": {"wavelet": "db3", "level": None, "sigma": 128, "max_threshold": 12},
    "cells_config": {"wavelet": "db3", "level": None, "sigma": 64, "max_threshold": 3},
}


def _plan():
    return build_plan(
        H, W,
        FilterConfig.from_dict(PARAMETERS["cells_config"]),
        FilterConfig.from_dict(PARAMETERS["no_cells_config"]),
    )


def _vol(seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(
        300
        + (rng.normal(size=(Z, H, 1)) * 60) * np.ones((1, 1, W))
        + rng.normal(size=(Z, H, W)) * 10,
        0, 65535,
    ).astype(np.uint16)


def test_device_step_sharded_matches_single():
    """make_device_step over all 8 virtual devices == single device, bitwise
    (both epilogues)."""
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    plan = _plan()
    vol = _vol()
    flat = np.full((H, W), 1.25, np.float32)
    dark = np.full((H, W), 5.0, np.float32)

    for with_flat in (True, False):
        single = make_device_step(
            plan, 2500.0, with_flat, devices=jax.devices()[:1]
        )
        multi = make_device_step(plan, 2500.0, with_flat, devices=jax.devices())
        assert multi.n_devices == len(jax.devices())
        # batch must split evenly over the mesh: 12 planes pad to 16 upstream
        # (StreamingDestriper rounds device_batch); here use an even 8
        batch = vol[:8]
        want = np.asarray(single(single.put(batch), flat, dark))
        got = np.asarray(multi(multi.put(batch), flat, dark))
        d = got.astype(int) - want.astype(int)
        assert np.abs(d).max() <= 1 and (d != 0).mean() < 1e-3
        assert got.dtype == np.uint16


def test_streaming_pipeline_sharded_identity():
    """Full StreamingDestriper over numpy arrays: 8-device mesh output ==
    pinned single-device output, including the ragged last slab (Z=12 with
    slab 8 -> a 4-plane tail that pads to the rounded device batch)."""
    plan = _plan()
    vol = _vol(1)
    flat = np.full((H, W), 1.25, np.float32)
    dark = np.full((H, W), 5.0, np.float32)

    outs = []
    for devices in (jax.devices()[:1], None):  # None -> all local devices
        out = np.zeros_like(vol)
        pipe = StreamingDestriper(
            vol, out, plan, flatfield=flat, darkfield=dark,
            slab=8, device_batch=6, journal=False, devices=devices,
        )
        stats = pipe.run()
        assert stats.planes == Z
        outs.append(out.copy())
    d = outs[0].astype(int) - outs[1].astype(int)
    assert np.abs(d).max() <= 1 and (d != 0).mean() < 1e-3
    assert outs[0].any()


@pytest.mark.parametrize("with_flat", [True, False], ids=["flat", "wrap"])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_streaming_pipeline_device_subsets(n_dev, with_flat):
    """StreamingDestriper pinned to a subset of the devices shards planes
    over exactly that subset and matches the unsharded kernel to <= 1 LSB,
    both epilogues, including the ragged last slab (Z=12, slab 8)."""
    import jax.numpy as jnp

    from aind_smartspim_destripe_tpu.ops.filter import destripe_batch

    plan = _plan()
    vol = _vol(5)
    flat = np.full((H, W), 1.25, np.float32)
    dark = np.full((H, W), 5.0, np.float32)
    kw = dict(flatfield=flat, darkfield=dark) if with_flat else {}
    out = np.zeros_like(vol)
    pipe = StreamingDestriper(
        vol, out, plan, slab=8, device_batch=3, journal=False,
        devices=jax.devices()[:n_dev], **kw,
    )
    assert pipe._step.n_devices == n_dev
    assert pipe.device_batch % n_dev == 0
    assert pipe.run().planes == Z
    ref = dict(flat=jnp.asarray(flat), dark=jnp.asarray(dark)) if with_flat \
        else dict(wrap=True)
    want = np.asarray(destripe_batch(
        plan, jnp.asarray(vol), 2500.0, plan.constants(), **ref
    ))
    d = out.astype(int) - want.astype(int)
    assert np.abs(d).max() <= 1 and (d != 0).mean() < 1e-3
    assert out.any()


@pytest.mark.parametrize("n_dev", [2, 4])
def test_streaming_pipeline_dual_device_subsets(n_dev):
    """Dual-band through StreamingDestriper on a subset of the devices
    matches the unsharded dual-band kernel to <= 1 LSB."""
    import jax.numpy as jnp

    from aind_smartspim_destripe_tpu.ops.dual_band import (
        dual_band_destripe_batch,
    )
    from aind_smartspim_destripe_tpu.ops.filter import wrap_cast

    plan = _plan()
    vol = _vol(6)
    out = np.zeros_like(vol)
    pipe = StreamingDestriper(
        vol, out, plan, slab=8, device_batch=4, journal=False,
        devices=jax.devices()[:n_dev], dual=True,
    )
    assert pipe._step.n_devices == n_dev
    assert pipe.run().planes == Z
    want = np.asarray(wrap_cast(dual_band_destripe_batch(
        plan, jnp.asarray(vol), 100.0, -1.0, consts=plan.constants()
    )))
    d = out.astype(int) - want.astype(int)
    assert np.abs(d).max() <= 1 and (d != 0).mean() < 1e-3
    assert out.any()


@pytest.mark.parametrize(
    "device_batch,n_dev,want",
    [(6, 8, 8), (8, 8, 8), (9, 8, 16), (1, 2, 2), (5, 4, 8), (64, 1, 64)],
)
def test_device_batch_rounds_up_to_the_mesh(device_batch, n_dev, want):
    """The compiled batch is the requested one rounded up to a multiple of
    the mesh size, so every device gets the same plane count."""
    vol = _vol()
    pipe = StreamingDestriper(
        vol, np.zeros_like(vol), _plan(), device_batch=device_batch,
        journal=False, devices=jax.devices()[:n_dev],
    )
    assert pipe.device_batch == want


def test_destripe_zarr_e2e_sharded_identity(tmp_path):
    """destripe_zarr end-to-end on the 8-virtual-device mesh produces output
    identical to the single-device run."""
    data_dir = tmp_path / "data"
    deriv = data_dir / "derivatives"
    os.makedirs(deriv)
    vol = _vol(2)
    tile = group(str(data_dir / "471320_461360.zarr"))
    lvl0 = tile.create_dataset(
        0, shape=(1, 1, Z, H, W), chunks=(1, 1, 8, 64, 64), dtype=np.uint16
    )
    lvl0[:] = vol[None, None]
    dark = np.full((H, W), 5.0, dtype=np.float32)
    imsave(str(deriv / "DarkMaster_cropped.tiff"), dark.astype(np.uint16))
    os.replace(
        str(deriv / "DarkMaster_cropped.tiff"),
        str(deriv / "DarkMaster_cropped.tif"),
    )
    flat = np.full((H, W), 1.25, dtype=np.float32)

    levels = {}
    for tag, devices in (("one", jax.devices()[:1]), ("all", None)):
        results = tmp_path / f"results_{tag}"
        os.makedirs(results)
        zd.destripe_zarr(
            dataset_path=data_dir / "471320_461360.zarr",
            multiscale="0",
            output_destriped_zarr=results / "Ex_488_Em_525" / "471320_461360.zarr",
            prediction_chunksize=(8, H, W),
            target_size_mb=64,
            n_workers=0,
            batch_size=1,
            super_chunksize=(16, H, W),
            results_folder=results,
            derivatives_path=deriv,
            xyz_resolution=(1.8, 1.8, 2.0),
            parameters=PARAMETERS,
            flatfield=flat,
            devices=devices,
        )
        t = open_zarr(
            str(results / "Ex_488_Em_525" / "471320_461360.zarr")
        )
        levels[tag] = [np.asarray(t[str(i)][:]) for i in range(3)]

    for lvl, (a, b) in enumerate(zip(levels["one"], levels["all"])):
        d = a.astype(int) - b.astype(int)
        assert np.abs(d).max() <= 1 and (d != 0).mean() < 1e-3, f"level {lvl}"
    assert levels["all"][0].any()
