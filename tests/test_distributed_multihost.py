"""
Multi-host (cross-process tier) end-to-end test: two real jax.distributed processes
destripe one channel of four tiles.

Asserts: disjoint round-robin tile ownership, all four tile outputs written
with multiscale levels, and a correct cross-process global_stats reduction.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Z, H, W = 8, 32, 48
STEMS = ["471300_461360", "471320_461360", "471340_461360", "471360_461360"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _build_channel(root):
    from aind_smartspim_destripe_tpu.io.writers import imsave
    from aind_smartspim_destripe_tpu.io.zarr import group

    ch = root / "Ex_488_Em_525"
    rng = np.random.default_rng(0)
    for i, stem in enumerate(STEMS):
        tile = group(str(ch / f"{stem}.zarr"))
        lvl0 = tile.create_dataset(
            0, shape=(1, 1, Z, H, W), chunks=(1, 1, 8, 16, 16), dtype=np.uint16
        )
        vol = np.clip(
            300 + (rng.normal(size=(Z, H, 1)) * 50) * np.ones((1, 1, W)), 0, 65535
        ).astype(np.uint16)
        lvl0[:] = vol[None, None]
    # output_format keeps the .tif name (bare imsave re-extensions to .tiff,
    # the reference quirk)
    imsave(
        str(root / "flat.tif"),
        np.full((H, W), 1.2, np.float32).astype(np.uint16),
        output_format=".tif",
    )
    (root / "laser_tiles.json").write_text(json.dumps({"0": STEMS}))
    (root / "results").mkdir()


def test_two_process_destripe_channel(tmp_path):
    _build_channel(tmp_path)
    port = _free_port()
    nprocs = 2
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # one device per process
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    for pid in range(nprocs):
        out_json = tmp_path / f"report_{pid}.json"
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    os.path.join(REPO, "tests", "distributed_worker.py"),
                    str(tmp_path),
                    str(port),
                    str(pid),
                    str(nprocs),
                    str(out_json),
                ],
                env=env,
                cwd=REPO,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
            )
        )
    outputs = [p.communicate(timeout=540)[0].decode() for p in procs]
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"

    reports = [json.load(open(tmp_path / f"report_{i}.json")) for i in range(nprocs)]
    assert all(r["process_count"] == nprocs for r in reports)

    # disjoint round-robin ownership covering all four tiles
    owned = [set(r["tiles"]) for r in reports]
    assert owned[0] & owned[1] == set()
    assert owned[0] | owned[1] == {f"{s}.zarr" for s in STEMS}
    assert all(len(o) == 2 for o in owned)
    assert all(p == Z for r in reports for p in r["planes"].values())

    # cross-process reduction: sum of [pid+1, 1] over 2 procs = [3, 2]
    for r in reports:
        assert r["global_stats"] == [3.0, 2.0]

    # every tile written with multiscale levels + metadata
    for stem in STEMS:
        tile_out = tmp_path / "results" / "destriped_data" / "Ex_488_Em_525" / f"{stem}.zarr"
        assert (tile_out / "0" / ".zarray").exists()
        assert (tile_out / "1" / ".zarray").exists()
        attrs = json.load(open(tile_out / ".zattrs"))
        assert len(attrs["omero"]["channels"]) == 1

    # resume interplay: the worker invalidated the journals
    # of two tiles (one per owner) and both processes re-ran the channel —
    # ownership must be unchanged, journal-skips must happen PER OWNER
    # (intact-journal tiles skip all slabs / recompute 0 planes) and only
    # the invalidated tiles recompute.
    invalidated = set(reports[0]["invalidated"])
    for r in reports:
        assert sorted(r["resume_tiles"]) == sorted(r["tiles"])
        for t in r["resume_tiles"]:
            if t in invalidated:
                assert r["resume_planes"][t] == Z, (t, r["resume_planes"])
                assert r["resume_skipped"][t] == 0
            else:
                assert r["resume_planes"][t] == 0, (t, r["resume_planes"])
                assert r["resume_skipped"][t] >= 1
    # each owner recomputed exactly one invalidated tile
    recomputed = [
        {t for t in r["resume_tiles"] if r["resume_planes"][t] == Z}
        for r in reports
    ]
    assert recomputed[0] | recomputed[1] == invalidated
    assert all(len(s) == 1 for s in recomputed)


def test_two_process_local_mesh_interplay(tmp_path):
    """Cross-process x in-process interplay: two jax.distributed processes
    each run their owned tiles with planes sharded over the process's 4
    LOCAL virtual devices, while tile ownership round-robins across
    processes. Outputs must match a single-process, single-device run of
    the same channel to <= 1 LSB."""
    _build_channel(tmp_path)

    # reference run: single process, plane route (separate results tree)
    ref_root = tmp_path / "ref"
    ref_root.mkdir()
    for item in ("Ex_488_Em_525", "flat.tif", "laser_tiles.json"):
        os.symlink(tmp_path / item, ref_root / item)
    (ref_root / "results").mkdir()
    env_ref = dict(os.environ)
    env_ref["JAX_PLATFORMS"] = "cpu"
    env_ref.pop("XLA_FLAGS", None)
    ref = subprocess.run(
        [
            sys.executable,
            "-c",
            (
                "import sys, json; sys.path.insert(0, %r);"
                "import jax; jax.config.update('jax_platforms', 'cpu');"
                "from aind_smartspim_destripe_tpu import zarr_destriper as zd;"
                "laser = json.load(open(%r));"
                "zd.destripe_channel(zarr_dataset_path=%r,"
                " derivatives_path=None, channel_name='Ex_488_Em_525',"
                " results_folder=%r, xyz_resolution=(1.8, 1.8, 2.0),"
                " estimated_channel_flats=[%r], laser_tiles=laser,"
                " parameters={'no_cells_config': {'wavelet': 'db3',"
                " 'level': None, 'sigma': 128, 'max_threshold': 12},"
                " 'cells_config': {'wavelet': 'db3', 'level': None,"
                " 'sigma': 64, 'max_threshold': 3}})"
            )
            % (
                REPO,
                str(tmp_path / "laser_tiles.json"),
                str(ref_root),
                str(ref_root / "results"),
                str(tmp_path / "flat.tif"),
            ),
        ],
        env=env_ref,
        cwd=REPO,
        capture_output=True,
        timeout=540,
    )
    assert ref.returncode == 0, ref.stdout.decode()[-4000:] + ref.stderr.decode()[-4000:]

    port = _free_port()
    nprocs = 2
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = []
    for pid in range(nprocs):
        out_json = tmp_path / f"mesh_report_{pid}.json"
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    os.path.join(REPO, "tests", "distributed_worker.py"),
                    str(tmp_path),
                    str(port),
                    str(pid),
                    str(nprocs),
                    str(out_json),
                    "mesh",
                ],
                env=env,
                cwd=REPO,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
            )
        )
    outputs = [p.communicate(timeout=540)[0].decode() for p in procs]
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, f"mesh worker failed:\n{out[-4000:]}"

    reports = [
        json.load(open(tmp_path / f"mesh_report_{i}.json"))
        for i in range(nprocs)
    ]
    assert all(r["process_count"] == nprocs for r in reports)
    assert all(r["local_devices"] == 4 for r in reports)
    assert all(p == Z for r in reports for p in r["planes"].values())
    owned = [set(r["tiles"]) for r in reports]
    assert owned[0] & owned[1] == set()
    assert owned[0] | owned[1] == {f"{s}.zarr" for s in STEMS}

    from aind_smartspim_destripe_tpu.io.zarr import open_zarr

    for stem in STEMS:
        got = np.asarray(
            open_zarr(
                str(
                    tmp_path / "results" / "destriped_data"
                    / "Ex_488_Em_525" / f"{stem}.zarr"
                )
            )["0"][:]
        )
        want = np.asarray(
            open_zarr(
                str(
                    ref_root / "results" / "destriped_data"
                    / "Ex_488_Em_525" / f"{stem}.zarr"
                )
            )["0"][:]
        )
        d = got.astype(np.int32) - want.astype(np.int32)
        assert np.abs(d).max() <= 1 and (d != 0).mean() < 1e-3, stem
        assert got.any()
