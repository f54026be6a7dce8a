"""
Flat-field / dark-field / baseline estimation from sample slides (reference
surface: code/aind_smartspim_destripe/flatfield_estimation.py).

Same three-function API — ``shading_correction`` (fit the shading model over
destriped tiles), ``unify_fields`` (median/mean/mip combination, float16
cast), ``slide_flat_estimation`` (walk the SmartSPIM col/row tree, destripe
each tile, fit per slide) — with the BaSiCPy dependency replaced by the
in-repo JAX BaSiC model in models/basic.py.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from .io.readers import imread
from .models.basic import BaSiC

__all__ = ["shading_correction", "unify_fields", "slide_flat_estimation"]


def shading_correction(
    slides: List[np.ndarray],
    shading_parameters: dict,
    mask: Optional[np.ndarray] = None,
) -> dict:
    """Fit the shading model over a stack of (destriped) tiles (reference
    flatfield_estimation.py:15-52)."""
    shading_obj = BaSiC(**shading_parameters)
    shading_obj.fit(images=np.array(slides), fitting_weight=mask)
    return {
        "flatfield": shading_obj.flatfield,
        "darkfield": shading_obj.darkfield,
        "baseline": shading_obj.baseline,
    }


def unify_fields(
    flatfields: List[np.ndarray],
    darkfields: List[np.ndarray],
    baselines: List[np.ndarray],
    mode: Optional[str] = "median",
):
    """Combine per-slide fits into single float16 fields (reference
    flatfield_estimation.py:55-122)."""
    flatfields = np.array(flatfields)
    darkfields = np.array(darkfields)
    baselines = np.array(baselines)

    if mode == "median":
        flatfield = np.median(flatfields, axis=0)
        darkfield = np.median(darkfields, axis=0)
        baseline = np.median(baselines, axis=0)
    elif mode == "mean":
        flatfield = np.mean(flatfields, axis=0)
        darkfield = np.mean(darkfields, axis=0)
        baseline = np.mean(baselines, axis=0)
    elif mode == "mip":
        flatfield = np.max(flatfields, axis=0)
        darkfield = np.min(darkfields, axis=0)
        baseline = np.max(baselines, axis=0)
    else:
        raise NotImplementedError("Accepted values are: ['mean', 'median', 'mip']")

    return (
        flatfield.astype(np.float16),
        darkfield.astype(np.float16),
        baseline.astype(np.float16),
    )


def slide_flat_estimation(
    dict_struct: dict,
    channel_name: str,
    slide_idxs: List[int],
    shading_parameters: dict,
    no_cells_config: dict,
    cells_config: dict,
) -> dict:
    """Per-slide shading fits over destriped tiles of a SmartSPIM channel
    tree (reference flatfield_estimation.py:125-196 surface). ``dict_struct``
    is the utils.read_image_directory_structure output.

    Device execution: the reference destriped each tile with its own
    per-plane call; here every tile of a slide is read by IO threads and
    destriped as ONE device batch through the compiled kernel (the tiles of
    a SmartSPIM slide share geometry), then fit."""
    from .ops.filter import (
        FilterConfig,
        build_plan,
        destripe_batch,
        device_constants,
    )

    dict_struct = dict_struct[channel_name]
    cols = list(dict_struct.keys())
    rows = [row.split("_")[-1] for row in list(dict_struct[cols[0]].keys())]
    row_name = f"{cols[0]}_{rows[0]}"
    grid = [(col, row) for col in cols for row in rows]

    cells_cfg = FilterConfig.from_dict(cells_config or {})
    no_cells_cfg = FilterConfig.from_dict(no_cells_config or {})

    shading_correction_per_slide = {}
    with ThreadPoolExecutor(max_workers=8) as pool:
        for slide_idx in slide_idxs:
            slide_name = dict_struct[cols[0]][row_name][slide_idx]
            paths = [
                f"{channel_name}/{col}/{col}_{row}/{slide_name}"
                for col, row in grid
            ]
            imgs = np.stack(
                [np.asarray(d) for d in pool.map(imread, paths)]
            ).astype(np.float32)

            plan = build_plan(imgs.shape[-2], imgs.shape[-1], cells_cfg, no_cells_cfg)
            # 2700 = filter_stripes' default microscope_high_int
            # (reference filtering.py:423; the zarr path's 2500 only applies
            # to the production destripe, not flat estimation)
            destriped = np.asarray(
                destripe_batch(plan, imgs, 2700.0, device_constants(plan))
            )
            slide_tiles = list(destriped)

            shading_correction_per_slide[slide_idx] = shading_correction(
                slides=slide_tiles, shading_parameters=shading_parameters
            )
            shading_correction_per_slide[slide_idx]["data"] = slide_tiles

    return shading_correction_per_slide
