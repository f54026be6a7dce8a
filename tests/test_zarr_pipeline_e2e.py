"""
End-to-end test of the production Zarr path: synthesize an OME-Zarr input
tile, run destripe_zarr, and check level 0 numerics (vs the ops kernel),
pyramid levels, OME-NGFF metadata, and journal-based resume. This is the
integration tier the reference lacks entirely (SURVEY.md section 4).
"""

import json
import os

import jax
import numpy as np
import pytest

from aind_smartspim_destripe_tpu import zarr_destriper as zd
from aind_smartspim_destripe_tpu.io.writers import imsave
from aind_smartspim_destripe_tpu.io.zarr import ZarrArray, group, open_zarr
from aind_smartspim_destripe_tpu.ops.filter import (
    FilterConfig,
    build_plan,
    destripe_batch,
)
from aind_smartspim_destripe_tpu.ops.flatfield import flatfield_correction
from aind_smartspim_destripe_tpu.ops.multiscale import windowed_mean_np

H, W, Z = 120, 160, 20

PARAMETERS = {
    "no_cells_config": {"wavelet": "db3", "level": None, "sigma": 128, "max_threshold": 12},
    "cells_config": {"wavelet": "db3", "level": None, "sigma": 64, "max_threshold": 3},
}


def make_input_tile(root, name="471320_461360.zarr"):
    rng = np.random.default_rng(0)
    vol = np.clip(
        300
        + (rng.normal(size=(Z, H, 1)) * 60) * np.ones((1, 1, W))
        + rng.normal(size=(Z, H, W)) * 10,
        0,
        65535,
    ).astype(np.uint16)
    tile = group(str(root / name))
    lvl0 = tile.create_dataset(
        0, shape=(1, 1, Z, H, W), chunks=(1, 1, 8, 64, 64), dtype=np.uint16
    )
    lvl0[:] = vol[None, None]
    return vol


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e")
    data_dir = tmp / "data"
    results = tmp / "results"
    deriv = data_dir / "derivatives"
    os.makedirs(deriv)
    os.makedirs(results)

    vol = make_input_tile(data_dir)

    dark = np.full((H + 10, W + 10), 5.0, dtype=np.float32)  # cropped by pipeline
    imsave(str(deriv / "DarkMaster_cropped.tiff"), dark.astype(np.uint16))
    os.rename(str(deriv / "DarkMaster_cropped.tiff"), str(deriv / "DarkMaster_cropped.tif"))

    flat = np.full((H, W), 1.25, dtype=np.float32)

    stats = zd.destripe_zarr(
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
    )
    return tmp, vol, flat, stats


def test_pipeline_outputs_match_ops_kernel(pipeline_run):
    tmp, vol, flat, stats = pipeline_run
    out_tile = open_zarr(str(tmp / "results" / "Ex_488_Em_525" / "471320_461360.zarr"))
    lvl0 = out_tile["0"]
    assert tuple(lvl0.shape) == (1, 1, Z, H, W)
    got = np.asarray(lvl0[0, 0])

    # expected: destripe + flatfield via the ops kernels directly
    plan = build_plan(
        H, W,
        FilterConfig.from_dict(PARAMETERS["cells_config"]),
        FilterConfig.from_dict(PARAMETERS["no_cells_config"]),
    )
    filtered = np.asarray(destripe_batch(plan, vol.astype(np.float32), 2500.0))
    dark = np.full((H, W), 5.0, dtype=np.float32)
    want = np.asarray(flatfield_correction(filtered, flat, dark))
    mismatch = np.abs(got.astype(int) - want.astype(int))
    assert (mismatch <= 1).all()  # batch-split fp jitter at most 1 LSB
    assert (mismatch > 0).mean() < 1e-3
    assert stats.planes == Z and stats.slabs == -(-Z // 8)


def test_pipeline_multiscale_levels(pipeline_run):
    tmp, vol, _, _ = pipeline_run
    tile = open_zarr(str(tmp / "results" / "Ex_488_Em_525" / "471320_461360.zarr"))
    lvl0, lvl1, lvl2 = np.asarray(tile["0"][:]), tile["1"], tile["2"]
    assert tuple(lvl1.shape) == (1, 1, Z // 2, H // 2, W // 2)
    assert tuple(lvl2.shape) == (1, 1, Z // 4, H // 4, W // 4)
    want1 = windowed_mean_np(lvl0, (2, 2, 2))
    got1 = np.asarray(lvl1[:])
    assert (np.abs(got1.astype(int) - want1.astype(int)) <= 1).all()
    want2 = windowed_mean_np(want1, (2, 2, 2))
    got2 = np.asarray(lvl2[:])
    assert (np.abs(got2.astype(int) - want2.astype(int)) <= 1).all()


def test_pipeline_metadata(pipeline_run):
    tmp, *_ = pipeline_run
    tile_path = tmp / "results" / "Ex_488_Em_525" / "471320_461360.zarr"
    attrs = json.load(open(tile_path / ".zattrs"))
    ms = attrs["multiscales"][0]
    assert [d["path"] for d in ms["datasets"]] == ["0", "1", "2"]
    # voxel size ZYX = (2.0, 1.8, 1.8); level1 doubles
    assert ms["datasets"][0]["coordinateTransformations"][0]["scale"] == [
        1.0, 1.0, 2.0, 1.8, 1.8,
    ]
    assert attrs["omero"]["channels"][0]["window"]["end"] == 350.0
    assert attrs["omero"]["rdefs"]["defaultZ"] == Z // 2


def test_pipeline_resume_skips_committed_slabs(pipeline_run):
    tmp, vol, flat, _ = pipeline_run
    results = tmp / "results"
    stats2 = zd.destripe_zarr(
        dataset_path=tmp / "data" / "471320_461360.zarr",
        multiscale="0",
        output_destriped_zarr=results / "Ex_488_Em_525" / "471320_461360.zarr",
        prediction_chunksize=(8, H, W),
        target_size_mb=64,
        n_workers=0,
        batch_size=1,
        super_chunksize=(16, H, W),
        results_folder=results,
        derivatives_path=tmp / "data" / "derivatives",
        xyz_resolution=(1.8, 1.8, 2.0),
        parameters=PARAMETERS,
        flatfield=flat,
    )
    assert stats2.slabs == 0
    assert stats2.slabs_skipped == -(-Z // 8)


def test_resume_refuses_foreign_codec_store(tmp_path):
    """A pre-existing level-0 with a non-zstd compressor (decodable but not
    re-encodable here) must start clean instead of failing on the first
    chunk write in resume mode."""
    vol = make_input_tile(tmp_path, "t.zarr")
    results = tmp_path / "results"
    results.mkdir()
    out_tile = results / "Ex_488_Em_525" / "t.zarr"
    tile_group = group(str(out_tile))
    from aind_smartspim_destripe_tpu.io.zarr import BloscCodec

    tile_group.create_dataset(
        0, shape=(1, 1, Z, H, W), chunks=(1, 1, 64, 128, 128),
        dtype=np.uint16,
        compressor=BloscCodec(cname="lz4", clevel=5),
        dimension_separator="/",
    )
    stats = zd.destripe_zarr(
        dataset_path=tmp_path / "t.zarr",
        multiscale="0",
        output_destriped_zarr=out_tile,
        prediction_chunksize=(8, H, W),
        target_size_mb=64,
        n_workers=0,
        batch_size=1,
        super_chunksize=(16, H, W),
        results_folder=results,
        derivatives_path=None,
        xyz_resolution=(1.8, 1.8, 2.0),
        parameters=PARAMETERS,
    )
    assert stats.slabs == -(-Z // 8) and stats.slabs_skipped == 0
    reopened = open_zarr(str(out_tile))["0"]
    assert (reopened.meta.get("compressor") or {}).get("cname") == "zstd"
    assert np.asarray(reopened[:]).any()


def test_destripe_foreign_lz4_input_tile(tmp_path):
    """An input tile compressed with blosc-lz4 (zarr-python's default, what
    generic conversion tooling writes) streams through destripe_zarr
    end-to-end — the decode matrix is a production input path, not just a
    codec unit feature."""
    from aind_smartspim_destripe_tpu.io import blosc as blosc_mod

    if blosc_mod.load_system_blosc() is None:
        pytest.skip("system c-blosc not available as the lz4 encoder")
    rng = np.random.default_rng(7)
    vol = np.clip(
        300
        + (rng.normal(size=(Z, H, 1)) * 60) * np.ones((1, 1, W))
        + rng.normal(size=(Z, H, W)) * 10,
        0, 65535,
    ).astype(np.uint16)

    # forge the store the way zarr-python's defaults would write it
    import json as _json

    root = tmp_path / "foreign.zarr"
    lvl = root / "0"
    os.makedirs(lvl)
    chunks = (8, 64, 64)
    (root / ".zgroup").write_text(_json.dumps({"zarr_format": 2}))
    (lvl / ".zarray").write_text(_json.dumps({
        "zarr_format": 2, "shape": [Z, H, W], "chunks": list(chunks),
        "dtype": "<u2", "order": "C", "fill_value": 0, "filters": None,
        "dimension_separator": ".",
        "compressor": {"id": "blosc", "cname": "lz4", "clevel": 5,
                       "shuffle": 1, "blocksize": 0},
    }))
    for ci in range(-(-Z // chunks[0])):
        for cj in range(-(-H // chunks[1])):
            for ck in range(-(-W // chunks[2])):
                buf = np.zeros(chunks, np.uint16)
                sl = vol[
                    ci * chunks[0] : (ci + 1) * chunks[0],
                    cj * chunks[1] : (cj + 1) * chunks[1],
                    ck * chunks[2] : (ck + 1) * chunks[2],
                ]
                buf[: sl.shape[0], : sl.shape[1], : sl.shape[2]] = sl
                frame = blosc_mod.system_compress(
                    buf.tobytes(), typesize=2, clevel=5, shuffle=1, cname="lz4"
                )
                (lvl / f"{ci}.{cj}.{ck}").write_bytes(frame)

    # reference store: the SAME volume in our own zstd layout — both runs
    # share one jitted pipeline, so foreign-decode correctness shows up as
    # BIT-IDENTICAL outputs (an absolute numeric oracle would instead be
    # comparing two differently-compiled executables: ulp Otsu jitter can
    # flip a mask bin and produce legitimate visible diffs)
    same = group(str(tmp_path / "same.zarr"))
    lvl0 = same.create_dataset(0, shape=(Z, H, W), chunks=chunks,
                               dtype=np.uint16)
    lvl0[:] = vol

    outs = {}
    for name in ("foreign.zarr", "same.zarr"):
        results = tmp_path / f"results_{name}"
        results.mkdir()
        zd.destripe_zarr(
            dataset_path=tmp_path / name,
            multiscale="0",
            output_destriped_zarr=results / "Ex_488_Em_525" / name,
            prediction_chunksize=(8, H, W),
            target_size_mb=64,
            n_workers=0,
            batch_size=1,
            super_chunksize=(16, H, W),
            results_folder=results,
            derivatives_path=None,
            xyz_resolution=(1.8, 1.8, 2.0),
            parameters=PARAMETERS,
            devices=jax.local_devices()[:1],
        )
        outs[name] = np.asarray(
            open_zarr(str(results / "Ex_488_Em_525" / name))["0"][:]
        )
    assert outs["foreign.zarr"].any()
    np.testing.assert_array_equal(outs["foreign.zarr"], outs["same.zarr"])


def test_validate_capsule_inputs(tmp_path):
    (tmp_path / "present.json").write_text("{}")
    missing = zd.validate_capsule_inputs(
        [str(tmp_path / "present.json"), str(tmp_path / "absent.json")]
    )
    assert missing == [str(tmp_path / "absent.json")]


def test_pad_array_n_d_and_extract():
    out = zd.pad_array_n_d(np.ones((3, 3)), 5)
    assert out.shape == (1, 1, 1, 3, 3)
    with pytest.raises(ValueError):
        zd.pad_array_n_d(np.ones((2, 2)), 6)

    ids = np.array([[5, 5, 5, 1], [50, 5, 5, 2]])
    sl = (slice(0, 10), slice(0, 10), slice(0, 10))
    picked = zd.extract_global_to_local(ids.copy(), sl)
    assert (picked[:, :3] >= 0).all()
    assert picked.shape[0] == 1 and picked[0, 3] == 1


def test_execute_worker_block_api(tmp_path):
    """execute_worker parity surface: destripe an in-memory block and write
    it into output slices (reference zarr_destriper.py:253-339)."""
    from aind_smartspim_destripe_tpu.io.zarr import ZarrArray

    rng = np.random.default_rng(0)
    block = np.clip(
        300 + (rng.normal(size=(4, 64, 80, 1)) * 50).transpose(0, 1, 3, 2)
        * np.ones((1, 1, 1, 80)),
        0, 65535,
    )[..., 0, :].astype(np.float32)
    out = ZarrArray.create(
        str(tmp_path / "o.zarr"), (1, 1, 8, 64, 80), (1, 1, 4, 64, 80), np.uint16
    )
    flat = np.full((64, 80), 1.5, np.float32)
    dark = np.zeros((64, 80), np.float32)
    res = zd.execute_worker(
        data=block[None, None],
        output_slices=(slice(0, 1), slice(0, 1), slice(4, 8), slice(0, 64), slice(0, 80)),
        output_destriped_zarr=out,
        cells_config=PARAMETERS["cells_config"],
        no_cells_config=PARAMETERS["no_cells_config"],
        shadow_correction={
            "retrospective": True, "flatfield": flat, "darkfield": dark,
            "tile_config": None,
        },
        dataset_name="471320_461360.zarr",
    )
    assert res.dtype == np.uint16
    np.testing.assert_array_equal(out[0, 0, 4:8], np.squeeze(res))
    assert (out[0, 0, 0:4] == 0).all()


def test_get_microscope_flats(tmp_path):
    from aind_smartspim_destripe_tpu.io.writers import imsave

    deriv = tmp_path / "derivatives"
    deriv.mkdir()
    meta = {
        "tile_config": {
            "t0": {"Laser": "488", "X": "471320", "Y": "461360", "Side": "0"},
            "t1": {"Laser": "488", "X": "489620", "Y": "461360", "Side": "1"},
            "t2": {"Laser": "561", "X": "471320", "Y": "461360", "Side": "0"},
        }
    }
    (deriv / "metadata.json").write_text(json.dumps(meta))
    for i in range(2):
        imsave(str(deriv / f"f{i}.tiff"), np.full((4, 4), i + 1, np.uint16))
        os.replace(str(deriv / f"f{i}.tiff"), str(deriv / f"FlatReal488_{i}.tif"))

    flats, config = zd.get_microscope_flats("Ex_488_Em_525", deriv)
    assert len(flats) == 2
    assert config == {"471320": {"461360": 0}, "489620": {"461360": 1}}

    # channel without digits -> no flats
    flats2, config2 = zd.get_microscope_flats("nochannel", deriv)
    assert flats2 is None and config2 is None

    # wrong flat count raises
    os.remove(str(deriv / "FlatReal488_1.tif"))
    with pytest.raises(ValueError):
        zd.get_microscope_flats("Ex_488_Em_525", deriv)


def test_compute_pyramid_levels():
    data = np.arange(4 * 8 * 8, dtype=np.uint16).reshape(4, 8, 8)
    levels = zd.compute_pyramid(data, n_lvls=3, scale_axis=(2, 2, 2))
    assert [lvl.shape for lvl in levels] == [(4, 8, 8), (2, 4, 4), (1, 2, 2)]
    from aind_smartspim_destripe_tpu.ops.multiscale import windowed_mean_np

    np.testing.assert_array_equal(levels[1], windowed_mean_np(data, (2, 2, 2)))


def test_compute_multiscale_3d_output(tmp_path):
    """3-D (ZYX) outputs: chunks must align to trailing axes (not (1,1,64))
    and omero metadata must describe ONE channel, not shape[1]=Y entries
    (regressions of earlier bugs)."""
    z, h, w = 16, 32, 48
    tile = group(str(tmp_path / "t.zarr"))
    lvl0 = tile.create_dataset(0, shape=(z, h, w), chunks=(8, 16, 16), dtype=np.uint16)
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 1000, size=(z, h, w), dtype=np.uint16)
    lvl0[:] = vol

    zd.compute_multiscale(
        output_zarr=lvl0,
        zarr_group=tile,
        scale_factor=(2, 2, 2),
        n_workers=1,
        voxel_size=(2.0, 1.8, 1.8),
        image_name="Ex_488_Em_525",
        n_levels=3,
    )
    reopened = open_zarr(str(tmp_path / "t.zarr"))
    lvl1, lvl2 = reopened["1"], reopened["2"]
    assert tuple(lvl1.shape) == (z // 2, h // 2, w // 2)
    assert tuple(lvl2.shape) == (z // 4, h // 4, w // 4)
    # trailing-axis chunk template: (64,128,128) capped by shape
    assert tuple(lvl1.chunks) == (z // 2, h // 2, w // 2)
    want1 = windowed_mean_np(vol, (2, 2, 2))
    assert (np.abs(np.asarray(lvl1[:]).astype(int) - want1.astype(int)) <= 1).all()

    attrs = json.load(open(tmp_path / "t.zarr" / ".zattrs"))
    assert len(attrs["omero"]["channels"]) == 1
    assert attrs["omero"]["rdefs"]["defaultZ"] == z // 2
    ms = attrs["multiscales"][0]
    assert [d["path"] for d in ms["datasets"]] == ["0", "1", "2"]
    assert ms["datasets"][2]["coordinateTransformations"][0]["scale"] == [
        1.0, 1.0, 8.0, 7.2, 7.2,
    ]
