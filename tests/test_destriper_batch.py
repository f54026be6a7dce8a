"""
Legacy file-batch path tests (reference destriper.py surface): directory
mirroring, sidecar copies, device-batched filtering, retry/skip logging,
plus run_capsule discovery conventions and provenance JSON.
"""

import json
import os

import numpy as np
import pytest

from aind_smartspim_destripe_tpu import destriper, run_capsule
from aind_smartspim_destripe_tpu.destriper_params import DestripingParams
from aind_smartspim_destripe_tpu.io.readers import imread
from aind_smartspim_destripe_tpu.io.writers import imsave
from aind_smartspim_destripe_tpu.utils.provenance import generate_data_processing


def make_tree(tmp_path, n=3, h=64, w=80):
    rng = np.random.default_rng(0)
    inp = tmp_path / "in"
    out = tmp_path / "out"
    (inp / "col0" / "col0_row0").mkdir(parents=True)
    out.mkdir()
    (inp / "notes.txt").write_text("sidecar")
    imgs = {}
    for i in range(n):
        img = np.clip(
            300 + (rng.normal(size=(h, 1)) * 50) * np.ones((1, w)),
            0, 65535,
        ).astype(np.uint16)
        p = inp / "col0" / "col0_row0" / f"{i}.tiff"
        imsave(str(p), img)
        imgs[f"{i}.tiff"] = img
    return inp, out, imgs


def test_batch_filter_mirrors_tree_and_filters(tmp_path):
    inp, out, imgs = make_tree(tmp_path)
    destriper.batch_filter(
        input_path=inp,
        output_path=out,
        workers=4,
        chunks=2,
        high_int_filt_params={"wavelet": "db3", "level": None, "sigma": 64, "max_threshold": 3},
        low_int_filt_params={"wavelet": "db3", "level": None, "sigma": 128, "max_threshold": 12},
        shadow_correction=None,
    )
    assert (out / "notes.txt").read_text() == "sidecar"
    for name, orig in imgs.items():
        o = out / "col0" / "col0_row0" / name
        assert o.exists()
        got = np.asarray(imread(str(o)))
        assert got.shape == orig.shape and got.dtype == np.uint16
        # stripes reduced
        assert np.var(got.astype(float).mean(axis=1)) < np.var(
            orig.astype(float).mean(axis=1)
        )
    assert not (out / "destripe_log.txt").exists()


def test_batch_filter_streams_with_bounded_readahead(tmp_path, monkeypatch):
    """Reads must interleave with writes (bounded read-ahead), not drain the
    whole tree into RAM first (round-1 weak #6)."""
    import threading

    inp, out, imgs = make_tree(tmp_path, n=24, h=32, w=40)
    events = []
    lock = threading.Lock()
    real_imread, real_imsave = destriper.imread, destriper.imsave

    def spy_imread(p, *a, **k):
        with lock:
            events.append("r")
        return real_imread(p, *a, **k)

    def spy_imsave(p, *a, **k):
        with lock:
            events.append("w")
        return real_imsave(p, *a, **k)

    monkeypatch.setattr(destriper, "imread", spy_imread)
    monkeypatch.setattr(destriper, "imsave", spy_imsave)
    destriper.batch_filter(
        input_path=inp,
        output_path=out,
        workers=2,
        chunks=2,
        high_int_filt_params={"wavelet": "db3", "level": None, "sigma": 64, "max_threshold": 3},
        low_int_filt_params={"wavelet": "db3", "level": None, "sigma": 128, "max_threshold": 12},
        shadow_correction=None,
    )
    assert events.count("r") == 24 and events.count("w") == 24
    # some write must start before the final read: streaming, not read-all
    first_w = events.index("w")
    assert first_w < len(events) - 1 and "r" in events[first_w:]
    # outstanding (read - written) images stay bounded well below the tree size
    outstanding = peak = 0
    for e in events:
        outstanding += 1 if e == "r" else -1
        peak = max(peak, outstanding)
    assert peak <= 16  # read_ahead(4) + bucket(2) + max_writes(8) + slack
    for name, orig in imgs.items():
        got = np.asarray(imread(str(out / "col0" / "col0_row0" / name)))
        assert got.shape == orig.shape


def test_read_filter_save_logs_failed_reads(tmp_path):
    out = tmp_path / "o"
    out.mkdir()
    bad = tmp_path / "missing.tiff"
    destriper.read_filter_save(
        output_dir=str(out),
        input_path=str(bad),
        output_path=str(out / "missing.tiff"),
        high_int_filter_params={},
        low_int_filter_params={},
        shadow_correction=None,
    )
    log = out / "destripe_log.txt"
    assert log.exists()
    assert str(bad) in log.read_text()


def test_destriper_params_cli():
    with pytest.raises(SystemExit):
        DestripingParams.from_args([])  # missing required args
    p = DestripingParams.from_args(
        ["--input_path", "/tmp", "--output_path", "/tmp/out", "--workers", "4"]
    )
    assert p.workers == 4 and p.chunks == 1 and p.output_format is None
    assert p.dual_band is False and p.crossover == 100.0
    p2 = DestripingParams.from_args(
        ["--input_path", "/tmp", "--output_path", "/tmp/out",
         "--dual_band", "--crossover", "80", "--dual_threshold", "350"]
    )
    assert p2.dual_band and p2.crossover == 80.0 and p2.dual_threshold == 350.0
    with pytest.raises(ValueError):
        DestripingParams("/nonexistent-dir", "/tmp").validate()


# ---------------------------------------------------------------------------
# run_capsule conventions + provenance
# ---------------------------------------------------------------------------


def test_get_resolution():
    acq = {
        "tiles": [
            {
                "coordinate_transformations": [
                    {"type": "translation", "translation": [0, 0, 0]},
                    {"type": "scale", "scale": ["1.8", "1.8", "2.0"]},
                ]
            }
        ]
    }
    assert run_capsule.get_resolution(acq) == (1.8, 1.8, 2.0)


def test_run_capsule_validations(tmp_path):
    with pytest.raises(ValueError):
        run_capsule.run(data_folder=str(tmp_path), results_folder=str(tmp_path))
    (tmp_path / "acquisition.json").write_text("{}")
    with pytest.raises(ValueError):
        run_capsule.run(data_folder=str(tmp_path), results_folder=str(tmp_path))


def test_generate_data_processing(tmp_path):
    path = generate_data_processing(
        channel_name="Ex_488_Em_525",
        destripe_version="0.1.0",
        destripe_config={
            "input_path": "/data/Ex_488_Em_525",
            "output_path": "/results",
            "no_cells_config": {"wavelet": "db3"},
            "retrospective": True,
        },
        start_time=0.0,
        end_time=1.0,
        output_directory=str(tmp_path),
    )
    doc = json.load(open(path))
    procs = doc["processing_pipeline"]["data_processes"]
    assert [p["name"] for p in procs] == [
        "Image destriping",
        "Image flat-field correction",
    ]
    assert "basicpy" in procs[1]["notes"]
    assert "input_path" not in procs[0]["parameters"]
    assert os.path.basename(path) == "image_destriping_Ex_488_Em_525_processing.json"
    with pytest.raises(FileNotFoundError):
        generate_data_processing(
            "c", "0.1.0", {}, 0.0, 1.0, str(tmp_path / "nope")
        )


def test_processing_json_validates_against_vendored_schema(tmp_path):
    """Pin the provenance contract: the emitted
    document must satisfy the vendored transcription of the aind-data-schema
    v1.x Processing model surface (reference run_capsule.py:134-175)."""
    import jsonschema

    path = generate_data_processing(
        channel_name="Ex_561_Em_593",
        destripe_version="0.2.0",
        destripe_config={
            "input_path": "/data/Ex_561_Em_593",
            "output_path": "/results",
            "no_cells_config": {"wavelet": "db3", "level": None},
            "cells_config": {"sigma": 64},
            "retrospective": False,
        },
        start_time=1700000000.0,
        end_time=1700000500.0,
        output_directory=str(tmp_path),
    )
    doc = json.load(open(path))
    schema = json.load(
        open(os.path.join(os.path.dirname(__file__), "fixtures",
                          "aind_processing_schema.json"))
    )
    jsonschema.validate(doc, schema)  # raises on contract violation

    # datetimes must round-trip through fromisoformat (pydantic emits ISO)
    from datetime import datetime

    for p in doc["processing_pipeline"]["data_processes"]:
        datetime.fromisoformat(p["start_date_time"])
        datetime.fromisoformat(p["end_date_time"])

    # a mutated document must FAIL (the gate has teeth)
    bad = json.loads(json.dumps(doc))
    bad["processing_pipeline"]["data_processes"][0]["name"] = "Renamed"
    with pytest.raises(jsonschema.ValidationError):
        jsonschema.validate(bad, schema)


def test_hemisphere_lookup_infers_path_shape(tmp_path):
    """Review-derived: the facade's non-retrospective hemisphere lookup must
    parse a filesystem plane path by its PARENT tile directory (the
    reference calls the zarr=True default there, a latent bug its zarr
    pipeline never hits; our batch path always passes real file paths)."""
    from aind_smartspim_destripe_tpu.filtering import filter_stripes

    img = np.full((32, 40), 300, np.float32)
    flats = [np.full((32, 40), 1.0, np.float32),
             np.full((32, 40), 2.0, np.float32)]
    sc = {
        "retrospective": False,
        "flatfield": flats,
        "darkfield": np.zeros((32, 40), np.float32),
        "tile_config": {"471320": {"461360": 1}},
    }
    cfg = {"wavelet": "db3", "level": 1, "sigma": 128, "max_threshold": 12}
    out = filter_stripes(
        image=img,
        input_tile_path="/data/Ex_488_Em_525/471320/471320_461360/0001.tiff",
        no_cells_config=cfg, cells_config=cfg, shadow_correction=sc,
    )
    assert out.shape == img.shape  # flats[1] (==2.0) selected, no KeyError
    # bare tile name still takes the zarr-name parse
    out2 = filter_stripes(
        image=img, input_tile_path="471320_461360",
        no_cells_config=cfg, cells_config=cfg, shadow_correction=sc,
    )
    assert out2.shape == img.shape


def test_batch_shadow_correction_without_flat_warns_not_crashes(tmp_path):
    from aind_smartspim_destripe_tpu.destriper import batch_filter
    from aind_smartspim_destripe_tpu.io.writers import imsave
    from aind_smartspim_destripe_tpu.io.readers import imread

    inp, outp = tmp_path / "in", tmp_path / "out"
    inp.mkdir(); outp.mkdir()
    img = np.full((32, 40), 400, np.uint16)
    imsave(str(inp / "plane_0.tiff"), img)
    batch_filter(
        input_path=inp, output_path=outp, workers=1, chunks=1,
        high_int_filt_params={"wavelet": "db3", "level": 1, "sigma": 64,
                              "max_threshold": 3},
        low_int_filt_params={"wavelet": "db3", "level": 1, "sigma": 128,
                             "max_threshold": 12},
        shadow_correction={"retrospective": True,
                           "darkfield": np.zeros((32, 40), np.float32)},
    )
    out = imread(str(outp / "plane_0.tiff"))
    assert out is not None and out.shape == img.shape  # uncorrected, no crash
