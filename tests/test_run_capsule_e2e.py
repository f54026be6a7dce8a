"""
Full capsule end-to-end: synthesize the Code Ocean input conventions
(acquisition.json, laser_tiles.json, estimated flats, derivatives dark,
channel folder with OME-Zarr tiles), run run_capsule.run(), and verify the
destriped tiles, pyramids, metadata, and provenance JSON.
"""

import json
import os

import numpy as np
import pytest

from aind_smartspim_destripe_tpu import run_capsule
from aind_smartspim_destripe_tpu.io.writers import imsave
from aind_smartspim_destripe_tpu.io.zarr import group, open_zarr

H, W, Z = 96, 128, 16
# tile name -> laser side is LASER_TILES; the dark is a constant field
TILES = ("471320_461360", "489620_461360")
LASER_TILES = {"0": ["471320_461360"], "1": ["489620_461360"]}
CAPSULE_DARK = 3


def build_capsule(tmp, h=H, w=W, z=Z, seed=1, chunks=(1, 1, 8, 64, 64),
                  bright_odd=False):
    """Write a synthetic capsule input tree under ``tmp``: two tiles (one per
    laser side) of ``z`` striped uint16 planes of ``h`` x ``w`` in a
    blosc-zstd zarr with ``chunks``, the per-side estimated flats and the
    derivatives dark. Planes are dim (~280, the no-cells classifier
    branch); with ``bright_odd`` every odd plane is bright (~3200, the
    cells branch). Volumes are written one z-chunk at a time, so memory
    stays at one slab whatever ``z``. Returns (data, results) folders."""
    data = tmp / "data"
    results = tmp / "results"
    (data / "derivatives").mkdir(parents=True)
    results.mkdir()

    acq = {
        "tiles": [
            {
                "coordinate_transformations": [
                    {"type": "scale", "scale": ["1.8", "1.8", "2.0"]}
                ]
            }
        ]
    }
    (data / "acquisition.json").write_text(json.dumps(acq))
    (data / "laser_tiles.json").write_text(json.dumps(LASER_TILES))

    # estimated flats: one per laser side (imsave writes .tiff; the capsule
    # convention expects .tif, so rename)
    for side in (0, 1):
        # estimated flats are ~[1, 2] float tiffs (normalize_image output)
        imsave(str(data / f"flat_{side}.tiff"), capsule_flat(h, w, side))
        os.replace(
            str(data / f"flat_{side}.tiff"),
            str(data / f"estimated_flat_laser_Ex_488_Em_525_{side}.tif"),
        )

    imsave(str(data / "derivatives" / "DarkMaster_cropped.tiff"),
           np.full((h, w), CAPSULE_DARK, np.uint16))
    os.replace(
        str(data / "derivatives" / "DarkMaster_cropped.tiff"),
        str(data / "derivatives" / "DarkMaster_cropped.tif"),
    )

    rng = np.random.default_rng(seed)
    ch = data / "Ex_488_Em_525"
    zc = chunks[2]
    for tile in TILES:
        tg = group(str(ch / f"{tile}.zarr"))
        lvl0 = tg.create_dataset(
            0, shape=(1, 1, z, h, w), chunks=chunks, dtype=np.uint16
        )
        for z0 in range(0, z, zc):
            n = min(zc, z - z0)
            level = np.full((n, 1, 1), 280.0, np.float32)
            if bright_odd:
                level[(np.arange(z0, z0 + n) % 2 == 1)] = 3200.0
            slab = (
                level
                + rng.standard_normal((n, h, 1), dtype=np.float32) * 50
                + rng.standard_normal((n, h, w), dtype=np.float32) * 8
            )
            lvl0[0:1, 0:1, z0:z0 + n] = np.clip(
                slab, 0, 65535
            ).astype(np.uint16)[None, None]
    return data, results


def capsule_flat(h, w, side):
    """The estimated flat of laser ``side`` written by :func:`build_capsule`."""
    return np.full((h, w), 1.0 + 0.25 * side, np.float32)


@pytest.mark.slow
def test_run_capsule_end_to_end(tmp_path):
    data, results = build_capsule(tmp_path)
    run_capsule.run(
        data_folder=str(data),
        results_folder=str(results),
        scratch_folder=str(tmp_path / "scratch"),
    )

    for tile in TILES:
        tile_group = open_zarr(
            str(results / "destriped_data" / "Ex_488_Em_525" / f"{tile}.zarr")
        )
        assert set(tile_group.keys()) == {"0", "1", "2"}
        lvl0 = tile_group["0"]
        assert tuple(lvl0.shape) == (1, 1, Z, H, W)
        out = np.asarray(lvl0[0, 0])
        assert out.dtype == np.uint16 and out.max() > 0
        ms = tile_group.attrs["multiscales"][0]
        assert ms["datasets"][0]["coordinateTransformations"][0]["scale"] == [
            1.0, 1.0, 2.0, 1.8, 1.8,
        ]

    prov = results / "image_destriping_Ex_488_Em_525_processing.json"
    assert prov.exists()
    doc = json.load(open(prov))
    names = [p["name"] for p in doc["processing_pipeline"]["data_processes"]]
    assert names == ["Image destriping", "Image flat-field correction"]


def test_run_capsule_dual_band_env(tmp_path, monkeypatch):
    """DESTRIPE_DUAL_BAND=1 routes the capsule's parameters into the
    dual-band mode (with the optional crossover/threshold overrides)."""
    data, results = build_capsule(tmp_path)
    captured = {}

    def fake_destripe_channel(parameters, **kw):
        captured.update(parameters)
        return {}

    monkeypatch.setattr(
        run_capsule.zarr_destriper, "destripe_channel",
        lambda **kw: fake_destripe_channel(**kw),
    )
    monkeypatch.setenv("DESTRIPE_DUAL_BAND", "1")
    monkeypatch.setenv("DESTRIPE_DUAL_CROSSOVER", "85.5")
    run_capsule.run(
        data_folder=str(data),
        results_folder=str(results),
        scratch_folder=str(tmp_path / "scratch"),
    )
    assert captured["dual_band"] is True
    assert captured["crossover"] == 85.5
    assert "dual_threshold" not in captured  # unset env leaves the default
