"""
File-batch destriping (legacy TIFF/PNG/RAW path; reference surface:
code/aind_smartspim_destripe/destriper.py).

Device-first redesign of the execution model: instead of a multiprocessing.Pool
where each process filters one image on CPU, files are read by IO threads,
grouped by geometry, destriped on device in batches, and written by IO
threads. ``workers`` bounds the IO thread pool; ``chunks`` maps to the device
batch size. Retry behavior matches the reference: failed reads are logged to
``destripe_log.txt`` and skipped (destriper.py:167-191), writes retry 10x on
OSError (destriper.py:202-215).
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from .filtering import filter_stripes
from .io.readers import SUPPORTED_READING_EXTENSIONS, imread
from .io.writers import imsave
from .ops.filter import (
    FilterConfig,
    build_plan,
    destripe_batch,
    device_constants,
)
from .ops.flatfield import flatfield_correction, get_hemisphere_flatfield

LOG_FMT = "%(asctime)s %(message)s"
LOG_DATE_FMT = "%Y-%m-%d %H:%M"

logging.basicConfig(format=LOG_FMT, datefmt=LOG_DATE_FMT)
logger = logging.getLogger(__name__)
logger.setLevel(logging.INFO)


def read_filter_save(
    output_dir,
    input_path,
    output_path,
    high_int_filter_params: dict,
    low_int_filter_params: dict,
    shadow_correction: dict,
    compression: Optional[int] = 1,
    output_format: Optional[str] = None,
    output_dtype: Optional[type] = None,
    dual_band: Optional[dict] = None,
):
    """Read one image, destripe, save (reference destriper.py:113-215):
    3 read attempts then log-and-skip; 10 write retries on OSError.

    ``dual_band``: optional dict (``crossover`` / ``threshold`` keys) —
    blend both filter configs per pixel instead of classifier dispatch."""
    raw_image = None
    for attempt in range(3):
        try:
            raw_image = imread(input_path)
            if raw_image is None:
                raise ValueError(f"unsupported input {input_path}")
            break
        except Exception:
            if attempt == 2:
                _log_failed_read(output_dir, input_path)
                return
            time.sleep(0.05)

    dtype = raw_image.dtype
    if output_dtype is not None and isinstance(output_dtype, type):
        dtype = output_dtype

    filtered_image = filter_stripes(
        image=np.asarray(raw_image),
        input_tile_path=input_path,
        no_cells_config=low_int_filter_params,
        cells_config=high_int_filter_params,
        shadow_correction=shadow_correction,
        dual_band=dual_band,
    )

    for attempt in range(10):
        try:
            imsave(
                output_path,
                filtered_image.astype(dtype),
                compression=compression,
                output_format=output_format,
            )
        except OSError:
            if attempt == 9:
                # exhausting the retries silently would report a clean run
                # with a missing output file — record it where the caller
                # is told to look (destripe_log.txt)
                logger.error(f"FAILED writing image in {output_path}")
                _log_failed_read(output_dir, f"WRITE-FAILED {output_path}")
                return
            logger.error(f"Retrying writing image in {output_path}...")
            time.sleep(0.05)
            continue
        break


_log_lock = threading.Lock()


def _log_failed_read(output_dir, input_path):
    file_name = os.path.join(output_dir, "destripe_log.txt")
    with _log_lock:
        # concurrent io-pool failures must not race the header check into a
        # truncating re-open that erases an already-logged path
        if not os.path.exists(file_name):
            with open(file_name, "w") as f:
                f.write(
                    "Error reading the following images.  "
                    "We will interpolate their content."
                )
        with open(file_name, "a+") as f:
            f.write(f"\n{input_path}")


def _read_filter_save(input_dict: dict):
    """Dict-argument wrapper (reference destriper.py:218-227)."""
    return read_filter_save(**input_dict)


def _find_all_images(search_path, input_path, output_path):
    """Recursively collect supported images, mirroring the directory tree
    into the output (reference destriper.py:230-264)."""
    input_path = Path(input_path)
    output_path = Path(output_path)
    search_path = Path(search_path)
    assert search_path.is_dir()

    img_paths = []
    for p in search_path.iterdir():
        if p.is_file():
            if p.suffix in SUPPORTED_READING_EXTENSIONS:
                img_paths.append(p)
        elif p.is_dir():
            o = output_path.joinpath(p.relative_to(input_path))
            if not o.exists():
                o.mkdir(parents=True)
            img_paths.extend(_find_all_images(p, input_path, output_path))
    return img_paths


def batch_filter(
    input_path,
    output_path,
    workers: int,
    chunks: int,
    high_int_filt_params: dict,
    low_int_filt_params: dict,
    shadow_correction: dict,
    compression: Optional[int] = 1,
    output_format: Optional[str] = None,
    output_dtype: Optional[type] = None,
    dual_band: Optional[dict] = None,
):
    """Destripe a directory tree of images (reference destriper.py:267-378).

    Device-batched: images are grouped by (shape, dtype); each group runs
    through one compiled destripe kernel in batches, overlapped with
    threaded file IO.

    ``dual_band``: optional dict (``crossover`` / ``threshold`` keys) —
    blend both filter configs per pixel (high_int = foreground band,
    low_int = background) instead of the per-plane classifier dispatch.
    """
    input_path = Path(input_path)
    output_path = Path(output_path)

    error_path = os.path.join(output_path, "destripe_log.txt")
    if os.path.exists(error_path):
        os.remove(error_path)

    logger.info(f"Looking for images in {input_path}")
    img_paths = _find_all_images(input_path, input_path, output_path)
    logger.info(f"Found {len(img_paths)} compatible images")

    for file in input_path.iterdir():
        if Path(file).suffix in [".txt", ".ini"]:
            shutil.copyfile(file, os.path.join(output_path, os.path.split(file)[1]))

    n_io = max(1, int(workers) or 1)
    batch = max(1, int(chunks) or 1)
    logger.info(f"Setting up {n_io} io threads, device batch {batch}...")

    cells_cfg = FilterConfig.from_dict(high_int_filt_params or {})
    no_cells_cfg = FilterConfig.from_dict(low_int_filt_params or {})

    io_pool = ThreadPoolExecutor(max_workers=n_io)

    # Streaming with bounded memory (round-1 weak #6 fix): at most
    # ``read_ahead`` decoded images wait for the device, one partial bucket
    # per geometry, and at most ``max_writes`` encoded images wait for disk —
    # the reference's Pool.imap(chunksize) had the same property
    # (destriper.py:366-373); the round-1 rebuild drained all reads first.
    read_ahead = max(2 * batch, 2 * n_io)
    max_writes = 4 * n_io

    def read_one(p):
        # 3 attempts each, reference retry semantics
        for attempt in range(3):
            try:
                img = imread(p)
                if img is None:
                    raise ValueError(f"unsupported input {p}")
                return p, np.asarray(img)
            except Exception:
                if attempt == 2:
                    _log_failed_read(output_path, p)
                    return p, None
                time.sleep(0.05)

    from collections import deque

    plans = {}

    consts_cache = {}
    write_futures = deque()

    def process_batch(shape, items):
        imgs = np.stack([im for _, im in items]).astype(np.float32)
        if dual_band is not None:
            # the dual wrapper caches its own plan per geometry (and
            # validates the configs share wavelet/level)
            from .ops.dual_band import dual_band_destripe_configs

            filtered = dual_band_destripe_configs(
                imgs,
                high_int_filt_params or {},
                low_int_filt_params or {},
                crossover=float(dual_band.get("crossover", 100.0)),
                threshold=float(dual_band.get("threshold", -1.0)),
            )
        else:
            plan = plans.get(shape)
            if plan is None:
                plan = plans[shape] = build_plan(
                    shape[0], shape[1], cells_cfg, no_cells_cfg
                )
            # operator matrices as device ARGUMENTS (filter.py guidance):
            # baking multi-MB literals into the graph stalls XLA, and
            # rebuilding them per batch re-stages host->device every group
            consts = consts_cache.get(shape)
            if consts is None:
                consts = consts_cache[shape] = device_constants(plan)
            filtered = np.asarray(destripe_batch(plan, imgs, 2700.0, consts))

        for (p, img), plane in zip(items, filtered):
            out_img = plane
            if shadow_correction is not None:
                flat = shadow_correction.get("flatfield")
                dark = shadow_correction.get("darkfield")
                if flat is not None and not shadow_correction.get(
                    "retrospective"
                ):
                    flat = get_hemisphere_flatfield(
                        input_tile_path=p,
                        tile_config=shadow_correction.get("tile_config"),
                        flatfields=flat,
                        zarr=False,
                    )
                if flat is not None:
                    out_img = np.asarray(
                        flatfield_correction(out_img, flat, dark)
                    )
                else:
                    # same semantics as runtime/pipeline.py: the dark only
                    # applies inside the flat-field correction — warn
                    # instead of crashing mid-run on jnp.asarray(None)
                    logger.warning(
                        "shadow_correction without a flatfield — skipping "
                        "the correction (dark alone cannot apply)"
                    )
            dtype_out = output_dtype if isinstance(output_dtype, type) else img.dtype
            o = output_path.joinpath(Path(p).relative_to(input_path))

            def write(o=o, out_img=out_img, dtype_out=dtype_out):
                for attempt in range(10):
                    try:
                        imsave(
                            o, out_img.astype(dtype_out),
                            compression=compression,
                            output_format=output_format,
                        )
                    except OSError:
                        if attempt == 9:
                            logger.error(f"FAILED writing image in {o}")
                            _log_failed_read(
                                output_path, f"WRITE-FAILED {o}"
                            )
                            return
                        logger.error(f"Retrying writing image in {o}...")
                        time.sleep(0.05)
                        continue
                    break

            write_futures.append(io_pool.submit(write))
        while len(write_futures) > max_writes:
            write_futures.popleft().result()

    groups = defaultdict(list)  # (shape, dtype) -> partial bucket, < batch items
    pending_reads = deque()
    path_iter = iter(img_paths)

    def schedule_reads():
        while len(pending_reads) < read_ahead:
            p = next(path_iter, None)
            if p is None:
                return
            pending_reads.append(io_pool.submit(read_one, p))

    schedule_reads()
    while pending_reads:
        p, img = pending_reads.popleft().result()
        schedule_reads()
        if img is None:
            continue
        if img.ndim != 2:
            # odd inputs (e.g. RGB pngs) fall back to the per-image host path
            o = output_path.joinpath(Path(p).relative_to(input_path))
            read_filter_save(
                output_path, p, o, high_int_filt_params, low_int_filt_params,
                shadow_correction, compression, output_format, output_dtype,
                dual_band=dual_band,
            )
            continue
        key = (img.shape, img.dtype)
        groups[key].append((p, img))
        if len(groups[key]) == batch:
            process_batch(key[0], groups.pop(key))

    for (shape, _), items in groups.items():  # tail buckets
        process_batch(shape, items)

    for f in write_futures:
        f.result()
    io_pool.shutdown()

    logger.info("Done with batch filtering!")
    if os.path.exists(error_path):
        logger.error("An error happened, see destripe log for more details")
