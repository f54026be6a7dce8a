"""
Capsule entry point (reference surface: code/run_capsule.py).

Same input-file conventions: ``acquisition.json`` (voxel resolution from the
first tile's scale transform), channel folders ``Ex_*_Em_*``,
``laser_tiles.json`` (side -> tile list), per-channel estimated flats
``estimated_flat_laser_{channel}*.tif``, ``derivatives/DarkMaster_cropped.tif``.
Hardcoded production filter parameters match run_capsule.py:374-390.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from time import time
from typing import List, Tuple

from . import __version__, zarr_destriper
from .utils import utils
from .utils.provenance import generate_data_processing


def get_data_config(
    data_folder: str,
    processing_manifest_path: str = "processing_manifest.json",
    data_description_path: str = "data_description.json",
) -> Tuple[dict, str]:
    """Read the processing manifest and dataset name (reference
    run_capsule.py:21-64)."""
    derivatives_dict = utils.read_json_as_dict(
        f"{data_folder}/{processing_manifest_path}"
    )
    data_description_dict = utils.read_json_as_dict(
        f"{data_folder}/{data_description_path}"
    )
    smartspim_dataset = data_description_dict["name"]
    return derivatives_dict, smartspim_dataset


def get_resolution(acquisition_config: dict):
    """(x, y, z) micron resolution from the first tile's scale transform
    (reference run_capsule.py:265-278)."""
    tile_transforms = acquisition_config["tiles"][0]["coordinate_transformations"]
    scale_transform = [
        x["scale"] for x in tile_transforms if x["type"] == "scale"
    ][0]
    return (
        float(scale_transform[0]),
        float(scale_transform[1]),
        float(scale_transform[2]),
    )


def validate_capsule_inputs(input_elements: List[str]) -> List[str]:
    """List the missing required inputs (reference run_capsule.py:281-305)."""
    return [str(e) for e in input_elements if not Path(e).exists()]


def _natsorted(paths):
    def key(p):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", str(p))]

    return sorted(paths, key=key)


PRODUCTION_PARAMETERS = {
    "no_cells_config": {
        "wavelet": "db3",
        "level": None,
        "sigma": 128,
        "max_threshold": 12,
    },
    "cells_config": {
        "wavelet": "db3",
        "level": None,
        "sigma": 64,
        "max_threshold": 3,
    },
    "retrospective": True,
}


def run(
    data_folder: str = "../data",
    results_folder: str = "../results",
    scratch_folder: str = "../scratch",
):
    """Validate inputs and destripe every channel (reference
    run_capsule.py:308-421). Multi-host aware: when the DESTRIPE_COORDINATOR
    env vars are set, jax.distributed comes up and each process destripes a
    disjoint tile subset (provenance JSON written by process 0 only).
    Returns ``{channel: {tile: PipelineStats}}`` for this process's tiles."""
    from .parallel.distributed import initialize_distributed

    process_index, process_count = initialize_distributed()
    if process_count > 1:
        print(f"Multi-host run: process {process_index}/{process_count}")

    data_folder = Path(os.path.abspath(data_folder))
    results_folder = Path(os.path.abspath(results_folder))
    # accepted-for-parity and unused, like the reference (run_capsule.py:313
    # computes the same path and never reads it; the device pipeline
    # streams through memory instead of a scratch tree)
    Path(os.path.abspath(scratch_folder))

    missing_files = validate_capsule_inputs([f"{data_folder}/acquisition.json"])
    print(f"Data in folder: {list(data_folder.glob('*'))}")
    if len(missing_files):
        raise ValueError(
            f"We miss the following files in the capsule input: {missing_files}"
        )

    acquisition_path = data_folder.joinpath("acquisition.json")
    acquisition_dict = utils.read_json_as_dict(str(acquisition_path))
    if not len(acquisition_dict):
        raise ValueError(
            f"Not able to read acquisition metadata from {acquisition_path}"
        )

    voxel_resolution = get_resolution(acquisition_dict)
    derivatives_path = data_folder.joinpath("derivatives")
    print(f"Derivatives path data: {list(derivatives_path.glob('*'))}")

    channels = [
        folder.name
        for folder in data_folder.glob("Ex_*_Em_*")
        if os.path.isdir(folder)
    ]

    laser_tiles_path = data_folder.joinpath("laser_tiles.json")
    if not laser_tiles_path.exists():
        raise FileNotFoundError(f"Path {laser_tiles_path} does not exist!")
    laser_tiles = utils.read_json_as_dict(str(laser_tiles_path))
    print(f"Laser tiles: {laser_tiles}")

    if not len(channels):
        print(f"No channels to process in {data_folder}")
        return {}

    all_stats = {}

    for channel_name in channels:
        estimated_channel_flats = _natsorted(
            data_folder.glob(f"estimated_flat_laser_{channel_name}*.tif")
        )
        if not len(estimated_channel_flats):
            raise FileNotFoundError(
                "Error while retrieving flats from the data folder "
                f"for channel {channel_name}"
            )

        parameters = {
            "input_path": data_folder.joinpath(channel_name),
            "output_path": str(results_folder),
            **PRODUCTION_PARAMETERS,
        }
        # Opt-in dual-band capsule runs without editing code: the reference
        # hardcodes its production parameters (run_capsule.py:377-388); env
        # vars are this framework's knob convention (README env table).
        if os.environ.get("DESTRIPE_DUAL_BAND", "") == "1":
            parameters["dual_band"] = True
            if os.environ.get("DESTRIPE_DUAL_CROSSOVER"):
                parameters["crossover"] = float(
                    os.environ["DESTRIPE_DUAL_CROSSOVER"]
                )
            if os.environ.get("DESTRIPE_DUAL_THRESHOLD"):
                parameters["dual_threshold"] = float(
                    os.environ["DESTRIPE_DUAL_THRESHOLD"]
                )

        destriping_start_time = time()
        all_stats[channel_name] = zarr_destriper.destripe_channel(
            zarr_dataset_path=data_folder,
            channel_name=channel_name,
            results_folder=results_folder,
            derivatives_path=derivatives_path,
            xyz_resolution=voxel_resolution,
            estimated_channel_flats=estimated_channel_flats,
            laser_tiles=laser_tiles,
            parameters=parameters,
        )
        destriping_end_time = time()

        if process_index == 0:
            generate_data_processing(
                channel_name=channel_name,
                destripe_version=__version__,
                destripe_config=parameters,
                start_time=destriping_start_time,
                end_time=destriping_end_time,
                output_directory=str(results_folder),
            )
    return all_stats


if __name__ == "__main__":
    run()
