"""Worker process for the 2-process jax.distributed test (multi-host
tier, SURVEY.md §5 "Distributed communication backend"). Launched by
tests/test_distributed_multihost.py with a shared coordinator port; runs
destripe_channel over a shared 4-tile channel and reports which tiles this
process owned plus a cross-host global_stats reduction."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    root, port, pid, nprocs, out_json = (
        sys.argv[1],
        sys.argv[2],
        int(sys.argv[3]),
        int(sys.argv[4]),
        sys.argv[5],
    )
    # "mesh" mode (multi-host x local-mesh interplay test): each process
    # runs its owned tiles with planes sharded over its LOCAL device mesh
    # while tile ownership partitions across processes; the resume-interplay
    # phase is skipped (covered by the default mode).
    mode = sys.argv[6] if len(sys.argv) > 6 else "full"
    import jax

    jax.config.update("jax_platforms", "cpu")  # before first backend use

    import numpy as np

    from aind_smartspim_destripe_tpu import zarr_destriper as zd
    from aind_smartspim_destripe_tpu.parallel.distributed import (
        global_stats,
        initialize_distributed,
    )

    initialize_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs,
        process_id=pid,
    )
    assert jax.process_count() == nprocs

    laser_tiles = json.load(open(f"{root}/laser_tiles.json"))
    params = {
        "no_cells_config": {"wavelet": "db3", "level": None, "sigma": 128, "max_threshold": 12},
        "cells_config": {"wavelet": "db3", "level": None, "sigma": 64, "max_threshold": 3},
    }
    run_channel = lambda: zd.destripe_channel(
        zarr_dataset_path=root,
        derivatives_path=None,
        channel_name="Ex_488_Em_525",
        results_folder=f"{root}/results",
        xyz_resolution=(1.8, 1.8, 2.0),
        estimated_channel_flats=[f"{root}/flat.tif"],
        laser_tiles=laser_tiles,
        parameters=params,
    )
    stats = run_channel()
    gs = global_stats(np.array([pid + 1.0, 1.0]))

    if mode == "mesh":
        json.dump(
            {
                "process_id": pid,
                "process_count": jax.process_count(),
                "local_devices": jax.local_device_count(),
                "tiles": sorted(stats),
                "planes": {k: v.planes for k, v in stats.items()},
                "global_stats": np.asarray(gs).tolist(),
            },
            open(out_json, "w"),
        )
        return

    # Resume interplay: leave the channel HALF-completed —
    # process 0 invalidates the journals of the first tile each process
    # owns — then both processes resume the whole channel. Owners must skip
    # exactly the still-committed slabs and recompute the invalidated ones.
    ch_out = f"{root}/results/destriped_data/Ex_488_Em_525"
    tile_names = sorted(json.load(open(f"{root}/laser_tiles.json"))["0"])
    invalidated = [f"{tile_names[0]}.zarr", f"{tile_names[1]}.zarr"]
    global_stats(np.array([1.0]))  # barrier: all first-run journals on disk
    if pid == 0:
        for t in invalidated:
            # the journal lives next to the level-0 chunks (pipeline.py
            # joins output_array.path, which is <tile>.zarr/0)
            os.remove(f"{ch_out}/{t}/0/.destripe_journal.json")
    global_stats(np.array([1.0]))  # barrier: tampering visible everywhere
    stats2 = run_channel()

    json.dump(
        {
            "process_id": pid,
            "process_count": jax.process_count(),
            "tiles": sorted(stats),
            "planes": {k: v.planes for k, v in stats.items()},
            "global_stats": np.asarray(gs).tolist(),
            "resume_tiles": sorted(stats2),
            "resume_planes": {k: v.planes for k, v in stats2.items()},
            "resume_skipped": {k: v.slabs_skipped for k, v in stats2.items()},
            "invalidated": invalidated,
        },
        open(out_json, "w"),
    )


if __name__ == "__main__":
    main()
