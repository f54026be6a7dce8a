"""
Production Zarr destriping orchestrator (reference surface:
code/aind_smartspim_destripe/zarr_destriper.py; see SURVEY.md C7/C9/C10).

Same public API — ``destripe_channel`` / ``destripe_zarr`` / multiscale and
metadata helpers — but the execution model is device-first: the reference's
producer queue + consumer process pool + Dask LocalCluster collapse into one
process running the streaming device pipeline (runtime/pipeline.py) and a
device windowed-mean pyramid (ops/multiscale.py).
"""

from __future__ import annotations

import logging
import os
import re
from glob import glob
from pathlib import Path
from time import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from .io import ngff
from .io.readers import imread
from .io.zarr import BloscCodec, ZarrArray, ZarrGroup, group, open_zarr
from .ops import flatfield as ffops
from .ops.filter import FilterConfig, build_plan
from .ops.multiscale import windowed_mean
from .runtime.pipeline import StreamingDestriper
from .utils import utils
from .utils.utils import ResourceProfiler, read_json_as_dict  # re-export parity

__all__ = [
    "read_json_as_dict",
    "get_microscope_flats",
    "pad_array_n_d",
    "extract_global_to_local",
    "compute_pyramid",
    "write_ome_ngff_metadata",
    "compute_multiscale",
    "destripe_zarr",
    "destripe_channel",
    "validate_capsule_inputs",
]


def _natsort_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def get_microscope_flats(
    channel_name: str, derivatives_folder
) -> Tuple[Optional[List[np.ndarray]], Optional[dict]]:
    """Load the per-hemisphere microscope flats ``FlatReal{wave}_*.tif`` and
    the tile-side config from ``metadata.json`` (reference
    zarr_destriper.py:70-154)."""
    derivatives_folder = Path(derivatives_folder)
    flatfield = None
    metadata_json = None

    waves = [p for p in str(channel_name).split("_") if p.isdigit()]
    metadata_json_path = derivatives_folder.joinpath("metadata.json")

    if metadata_json_path.exists() and len(waves):
        orig = utils.read_json_as_dict(str(metadata_json_path))
        curr_wave = int(waves[0])
        tile_config = orig.get("tile_config")
        if tile_config is None:
            raise ValueError("Please, verify metadata.json")

        metadata_json = {}
        for _step, value in tile_config.items():
            laser = value.get("Laser")
            if laser is None:
                # same clean contract as the X/Y/Side fields below — a
                # missing key in this untrusted file must not surface as a
                # bare TypeError from int(None)
                raise KeyError("Please, check the data in metadata.json")
            if int(laser) != curr_wave:
                continue
            x_folder = value.get("X")
            y_folder = value.get("Y")
            brain_side = value.get("Side")
            if x_folder is None or y_folder is None or brain_side is None:
                raise KeyError("Please, check the data in metadata.json")
            metadata_json.setdefault(x_folder, {})[y_folder] = int(brain_side)

        paths = sorted(
            glob(f"{derivatives_folder}/FlatReal{curr_wave}_*.tif"),
            key=_natsort_key,
        )
        flatfield = [imread(g) for g in paths if os.path.exists(g)]
        if len(flatfield) != 2:
            raise ValueError(
                f"Error while reading the microscope flatfields: {flatfield}"
            )

    return flatfield, metadata_json


def pad_array_n_d(arr, dim: int = 5):
    """Left-pad with singleton axes up to ``dim`` (reference
    zarr_destriper.py:157-179)."""
    if dim > 5:
        raise ValueError("Padding more than 5 dimensions is not supported.")
    while arr.ndim < dim:
        arr = arr[np.newaxis, ...]
    return arr


def extract_global_to_local(global_ids_with_cells, global_slices, pad: int = 0):
    """Map global ZYX ids into a chunk's local frame (reference
    zarr_destriper.py:182-250; retained for API parity with the cell-seg
    toolchain even though the destripe flow does not use it)."""
    starts = np.array([s.start - pad for s in global_slices])
    stops = np.array([s.stop + pad for s in global_slices])

    g = global_ids_with_cells
    keep = np.ones(len(g), dtype=bool)
    for d in range(3):
        keep &= (g[:, d] >= starts[d]) & (g[:, d] < stops[d])
    picked = g[keep].copy()
    picked[..., :3] = picked[..., :3] - starts - pad

    keep2 = np.ones(len(picked), dtype=bool)
    for d in range(3):
        keep2 &= (picked[:, d] >= 0) & (picked[:, d] <= (stops[d] - starts[d]) + pad)
    return picked[keep2]


def execute_worker(
    data: np.ndarray,
    output_slices: Tuple[slice, ...],
    output_destriped_zarr,
    cells_config: dict,
    no_cells_config: dict,
    shadow_correction: Optional[dict] = None,
    dataset_name: str = "",
    logger: Optional[logging.Logger] = None,
    microscope_high_int: float = 2500.0,
):
    """Destripe one in-memory Z-block and write it to the output store
    (reference zarr_destriper.py:253-339 surface, for custom orchestration;
    the streaming pipeline in runtime/pipeline.py is the production path).

    ``data``: (Z, H, W) (or squeezable 4-D/5-D) block; ``output_slices``:
    where it lands in the (possibly 5-D) output array. The whole block runs
    as one batched device call instead of a per-plane Python loop.
    """
    block = np.asarray(data)
    while block.ndim > 3:
        block = np.squeeze(block, axis=0)

    h, w = block.shape[-2:]
    plan = build_plan(
        h,
        w,
        FilterConfig.from_dict(cells_config),
        FilterConfig.from_dict(no_cells_config),
    )
    from .ops.filter import destripe_batch, device_constants

    filtered = np.asarray(
        destripe_batch(
            plan,
            block.astype(np.float32),
            microscope_high_int,  # zarr-path default 2500 (reference :326)
            device_constants(plan),
        )
    )

    if shadow_correction is not None:
        flat = shadow_correction.get("flatfield")
        dark = shadow_correction.get("darkfield")
        if not shadow_correction.get("retrospective"):
            flat = ffops.get_hemisphere_flatfield(
                input_tile_path=dataset_name.replace(".zarr", ""),
                tile_config=shadow_correction.get("tile_config"),
                flatfields=flat,
            )
        filtered = np.asarray(ffops.flatfield_correction(filtered, flat, dark))

    out = filtered
    while out.ndim < len(output_destriped_zarr.shape):
        out = out[np.newaxis]
    output_destriped_zarr[output_slices] = out
    if logger:
        logger.info(f"block {output_slices} destriped")
    return out


# ---------------------------------------------------------------------------
# Pyramid
# ---------------------------------------------------------------------------


def compute_pyramid(data, n_lvls: int, scale_axis, chunks="auto"):
    """Successive windowed-mean reductions of an in-memory array (reference
    zarr_destriper.py:365-407 semantics, device-executed). Returns the list
    of levels, level 0 first.

    ``chunks`` is accepted for reference-signature parity and unused: the
    reference rechunks a dask graph here; this implementation returns plain
    arrays and chunking is decided by the store writer."""
    levels = [np.asarray(data)]
    factors = tuple(int(s) for s in scale_axis)
    for _ in range(max(0, n_lvls - 1)):
        nxt = np.asarray(windowed_mean(np.asarray(levels[-1]), factors=factors))
        levels.append(nxt)
    return levels


def write_ome_ngff_metadata(
    group: ZarrGroup,
    arr,
    image_name: str,
    n_lvls: int,
    scale_factors: tuple,
    voxel_size: tuple,
    channel_names: List[str] = None,
    channel_colors: List[int] = None,
    channel_minmax: List[Tuple[float, float]] = None,
    channel_startend: List[Tuple[float, float]] = None,
    metadata: dict = None,
):
    """OME-NGFF metadata on a tile group (reference zarr_destriper.py:600-674)."""
    ngff.write_ome_ngff_metadata(
        group=group,
        shape=tuple(arr.shape),
        chunksize=tuple(arr.chunks),
        image_name=image_name,
        n_lvls=n_lvls,
        scale_factors=tuple(scale_factors),
        voxel_size=tuple(voxel_size),
        channel_names=channel_names,
        channel_colors=channel_colors,
        channel_minmax=channel_minmax,
        channel_startend=channel_startend,
        metadata=metadata,
    )


def compute_multiscale(
    output_zarr: ZarrArray,
    zarr_group: ZarrGroup,
    scale_factor,
    n_workers: int,
    voxel_size,
    image_name: str,
    n_levels: int = 3,
    threads_per_worker: int = 1,
    logger: Optional[logging.Logger] = None,
):
    """Write levels 1..n_levels-1 plus OME-NGFF metadata (reference
    zarr_destriper.py:677-794). Downsampling runs on device slab-by-slab; no
    Dask cluster is spun up.

    ``n_workers`` and ``threads_per_worker`` are accepted for
    reference-signature parity and unused: they sized the reference's Dask
    LocalCluster, which this implementation replaces with device slabs."""
    logger = logger or logging.getLogger(__name__)
    start_time = time()

    # Channel metadata follows TCZYX semantics: pad the logical shape to 5-D
    # first (pad_array_n_d), so a 3-D ZYX output yields one channel rather
    # than shape[1]=Y bogus omero entries (round-1 bug).
    shape5 = (1,) * (5 - len(output_zarr.shape)) + tuple(output_zarr.shape)
    channel_minmax = [
        (float(np.iinfo(np.uint16).min), float(np.iinfo(np.uint16).max))
        for _ in range(shape5[1])
    ]
    channel_startend = [(0.0, 350.0) for _ in range(shape5[1])]

    write_ome_ngff_metadata(
        group=zarr_group,
        arr=output_zarr,
        image_name=image_name,
        n_lvls=n_levels,
        scale_factors=scale_factor,
        voxel_size=voxel_size,
        channel_names=[image_name],
        channel_colors=[0x690AFE],
        channel_minmax=channel_minmax,
        channel_startend=channel_startend,
        metadata=None,
    )

    factors = tuple(int(f) for f in scale_factor)
    prev = output_zarr
    for lvl in range(1, n_levels):
        zc = prev.chunks[2] if prev.ndim == 5 else prev.chunks[0]
        z_prev = prev.shape[-3]
        new_shape = prev.shape[:-3] + tuple(
            s // f for s, f in zip(prev.shape[-3:], factors)
        )
        # Align the chunk template to the TRAILING axes (ZYX last); zipping
        # the 5-D template against a 3-D shape head-first produced (1,1,64)
        # chunks for ZYX arrays (round-1 bug).
        template = (1, 1, 64, 128, 128)[-len(new_shape):]
        chunks = tuple(min(c, s) for c, s in zip(template, new_shape))
        dst = zarr_group.create_dataset(
            name=lvl,
            shape=new_shape,
            chunks=chunks,
            dtype=np.uint16,
            compressor=BloscCodec(cname="zstd", clevel=3),
            dimension_separator="/",
            overwrite=True,
        )
        slab = max(factors[0], (zc * 2 // factors[0]) * factors[0])
        for z0 in range(0, (z_prev // factors[0]) * factors[0], slab):
            z1 = min(z0 + slab, (z_prev // factors[0]) * factors[0])
            block = np.asarray(prev[..., z0:z1, :, :])
            down = np.asarray(windowed_mean(block, factors=factors))
            dst[..., z0 // factors[0] : z1 // factors[0], :, :] = down
        logger.info(f"multiscale level {lvl}: {new_shape}")
        prev = dst

    logger.info(f"Time to write the multiscales: {time() - start_time:.2f}s")


# ---------------------------------------------------------------------------
# Main tile pipeline
# ---------------------------------------------------------------------------


def destripe_zarr(
    dataset_path,
    multiscale: str,
    output_destriped_zarr,
    prediction_chunksize: Tuple[int, ...],
    target_size_mb: int,
    n_workers: int,
    batch_size: int,
    super_chunksize: Tuple[int, ...],
    results_folder,
    derivatives_path,
    xyz_resolution,
    parameters: dict,
    flatfield=None,
    lazy_callback_fn: Optional[Callable] = None,
    devices=None,
):
    """Destripe one OME-Zarr tile end-to-end: stream -> device filter +
    shadow correction -> level-0 Zarr -> multiscale + metadata (reference
    zarr_destriper.py:909-1211 surface).

    ``prediction_chunksize[0]`` sets the streamed Z-slab; ``n_workers`` caps
    IO threads (0 -> auto); ``target_size_mb``/``super_chunksize``/
    ``batch_size`` are accepted for parameter parity (the device pipeline's
    prefetch depth replaces the producer super-chunk staging).

    ``devices``: accelerators the pipeline shards each batch over (None ->
    every local device; the multi-device analog of the reference's ``co_cpus``
    consumer pool, zarr_destriper.py:1136-1172).

    ``parameters`` extras beyond the reference's cells/no_cells configs:
    ``dual_band`` (bool, default False) switches from the per-plane
    classifier to the dual-band per-pixel blend (BASELINE config 2;
    ops/dual_band.py) with optional ``crossover`` (sigmoid width, 100.0)
    and ``dual_threshold`` (center; < 0 = per-plane Otsu).
    """
    no_cells_config = parameters["no_cells_config"]
    cells_config = parameters["cells_config"]
    # Dual-band mode (BASELINE config 2): blend both configs per pixel
    # instead of the per-plane classifier dispatch. cells_config = the
    # foreground band (gentle sigma), no_cells_config = background.
    dual_band = bool(parameters.get("dual_band", False))
    dual_crossover = float(parameters.get("crossover", 100.0))
    dual_threshold = float(parameters.get("dual_threshold", -1.0))

    co_cpus = int(utils.get_code_ocean_cpu_limit())
    if n_workers > co_cpus:
        raise ValueError(f"Provided workers {n_workers} > current workers {co_cpus}")

    logger = utils.create_logger(output_log_path=str(results_folder))
    logger.info(f"{20 * '='} Large-Scale Zarr Destriping {20 * '='}")
    logger.info(f"Processing dataset {dataset_path}")

    from .runtime import enable_compile_cache

    enable_compile_cache()

    profiler = ResourceProfiler(interval=20).start()

    try:
        dataset = open_zarr(str(dataset_path))
        if isinstance(dataset, ZarrGroup):
            lazy_data = dataset[str(multiscale)]
        else:
            lazy_data = dataset
        if lazy_callback_fn is not None:
            lazy_data = lazy_callback_fn(lazy_data)
        original_dataset_shape = tuple(lazy_data.shape)
        logger.info(f"Lazy data shape: {original_dataset_shape}")

        # Output store layout: {parent}/{tile}.zarr/0 (reference
        # zarr_destriper.py:1060-1074)
        output_destriped_zarr = Path(output_destriped_zarr)
        root_group = group(str(output_destriped_zarr.parent))
        dataset_name = output_destriped_zarr.name
        new_channel_group = root_group.create_group(dataset_name, overwrite=False)
        out_chunks = (1, 1, 64, 128, 128)[-len(original_dataset_shape) :]
        # Reuse a compatible existing level-0 store so the per-slab resume
        # journal can skip completed work; otherwise start clean (the
        # reference always starts clean, zarr_destriper.py:1065-1074).
        output_zarr = None
        if "0" in new_channel_group:
            existing = new_channel_group["0"]
            # resume writes re-encode chunks: a decodable-but-not-
            # encodable store (e.g. foreign blosc-lz4) must start clean
            # instead of failing on the first chunk write. The codec is
            # the single source of truth for its encode capability.
            reencodable = getattr(existing.codec, "can_encode", True)
            if (
                tuple(existing.shape) == tuple(original_dataset_shape)
                and tuple(existing.chunks) == tuple(out_chunks)
                and existing.dtype == np.dtype(np.uint16)
                and reencodable
            ):
                output_zarr = existing
                logger.info("Reusing existing output zarr (resume mode)")
        if output_zarr is None:
            output_zarr = new_channel_group.create_dataset(
                name=0,
                shape=original_dataset_shape,
                chunks=out_chunks,
                dtype=np.uint16,
                compressor=BloscCodec(cname="zstd", clevel=3),
                dimension_separator="/",
                overwrite=True,
            )
        logger.info(f"Created zarr: {output_zarr}")

        # Shadow-correction inputs (reference zarr_destriper.py:1095-1130)
        darkfield = None
        tile_config = None
        derivatives_path = Path(derivatives_path) if derivatives_path else None
        if derivatives_path is not None and os.path.exists(derivatives_path):
            darkfield_path = str(derivatives_path.joinpath("DarkMaster_cropped.tif"))
            logger.info(f"Loading darkfield from path: {darkfield_path}")
            try:
                darkfield = imread(darkfield_path)
            except FileNotFoundError:
                raise FileNotFoundError(
                    "Please, provide the current dark from the microscope! "
                    f"Provided path: {darkfield_path}"
                )
            if flatfield is None:
                channel_name = output_destriped_zarr.parent.name
                flats, tile_config = get_microscope_flats(
                    channel_name=str(channel_name),
                    derivatives_folder=derivatives_path,
                )
                if flats is not None:
                    flatfield = np.asarray(ffops.normalize_image(flats))
            else:
                logger.info("Ignoring microscope flats...")

        h, w = original_dataset_shape[-2:]
        plan = build_plan(
            h,
            w,
            FilterConfig.from_dict(cells_config),
            FilterConfig.from_dict(no_cells_config),
        )

        per_tile_flat = None
        if flatfield is not None:
            flat_arr = np.asarray(flatfield, dtype=np.float32)
            if flat_arr.ndim == 3:
                # microscope flats: one per hemisphere; pick by tile name
                if tile_config is None:
                    raise ValueError(
                        "hemisphere flats provided without tile_config"
                    )
                per_tile_flat = np.asarray(
                    ffops.get_hemisphere_flatfield(
                        input_tile_path=dataset_name.replace(".zarr", ""),
                        tile_config=tile_config,
                        flatfields=list(flat_arr),
                    ),
                    dtype=np.float32,
                )
            else:
                per_tile_flat = flat_arr

        from .runtime.tracing import device_trace

        start_time = time()
        pipe = StreamingDestriper(
            input_array=lazy_data,
            output_array=output_zarr,
            plan=plan,
            flatfield=per_tile_flat,
            darkfield=np.asarray(darkfield, np.float32) if darkfield is not None else None,
            microscope_high_int=2500.0,
            slab=int(prediction_chunksize[0]) if prediction_chunksize else 64,
            io_threads=n_workers or 0,
            logger=logger,
            devices=devices,
            dual=dual_band,
            crossover=dual_crossover,
            dual_threshold=dual_threshold,
        )
        with device_trace(os.environ.get("DESTRIPE_TRACE_DIR")):
            stats = pipe.run()
        end_time = time()

        multiscale_start = time()
        compute_multiscale(
            output_zarr=output_zarr,
            zarr_group=new_channel_group,
            scale_factor=[2, 2, 2],
            n_workers=co_cpus,
            voxel_size=[
                xyz_resolution[-1],
                xyz_resolution[-2],
                xyz_resolution[-3],
            ],
            image_name=dataset_name,
            n_levels=3,
            logger=logger,
        )
        multiscale_end = time()

        logger.info(
            f"Processing destripe flatfield time: {end_time - start_time} seconds"
        )
        logger.info(
            f"Processing multiscale time: {multiscale_end - multiscale_start} seconds"
        )
        return stats
    finally:
        profiler.stop()
        if len(profiler.time_points):
            profiler.save_graphs(str(results_folder), "zarr_destriper")


def destripe_channel(
    zarr_dataset_path,
    derivatives_path,
    channel_name,
    results_folder,
    xyz_resolution,
    estimated_channel_flats,
    laser_tiles,
    parameters,
):
    """Destripe every tile of a channel (reference zarr_destriper.py:1214-1267):
    pick the estimated flat by laser side, then run destripe_zarr per tile.
    Returns {tile_name: PipelineStats} for the tiles THIS process owns (all
    of them in single-process runs; a disjoint round-robin subset under
    jax.distributed — see parallel/distributed.assign_tiles)."""
    zarr_dataset_path = Path(zarr_dataset_path)
    results_folder = Path(results_folder)
    channel_dataset = zarr_dataset_path.joinpath(channel_name)

    destriped_data_folder = results_folder.joinpath("destriped_data")
    utils.create_folder(str(destriped_data_folder))

    tiles = sorted(channel_dataset.glob("*.zarr"))
    try:
        import jax

        if jax.process_count() > 1:
            # Multi-host: each process owns a disjoint tile subset; bulk
            # image bytes never cross hosts (parallel/distributed.py).
            from .parallel.distributed import assign_tiles

            tiles = assign_tiles(tiles)
    except Exception:  # pragma: no cover - jax optional at this layer
        pass

    stats = {}
    for tile_path in tiles:
        output_folder = destriped_data_folder.joinpath(
            f"{channel_name}/{tile_path.name}"
        )
        print(
            f"Processing {tile_path} - writing to: {output_folder} - "
            f"derivatives: {derivatives_path}"
        )

        flatfield_path = None
        for side, side_tiles in laser_tiles.items():
            tile_path_stem = tile_path.stem.rsplit(".", 1)[0]
            if tile_path_stem in side_tiles:
                flatfield_path = estimated_channel_flats[int(side)]
                break
        if flatfield_path is None:
            raise ValueError(f"Tile {tile_path} not found in {laser_tiles}")

        flatfield = imread(str(flatfield_path))
        print(f"Reading flatfield from {flatfield_path} - shape: {flatfield.shape}")

        stats[tile_path.name] = destripe_zarr(
            dataset_path=tile_path,
            multiscale="0",
            output_destriped_zarr=output_folder,
            prediction_chunksize=(64, 1600, 2000),
            target_size_mb=3072,
            n_workers=0,
            batch_size=1,
            super_chunksize=(384, 1600, 2000),
            results_folder=results_folder,
            derivatives_path=derivatives_path,
            xyz_resolution=xyz_resolution,
            parameters=parameters,
            flatfield=flatfield,
            lazy_callback_fn=None,
        )
    return stats


def validate_capsule_inputs(input_elements: List[str]) -> List[str]:
    """Missing-input check (reference zarr_destriper.py:1270-1294)."""
    missing = []
    for element in input_elements:
        if not Path(element).exists():
            missing.append(str(element))
    return missing
