"""
Generate the BaSiCPy golden fixture for models/basic.py.

Run this ON A MACHINE WHERE BaSiCPy INSTALLS (it does not in the dev image
— no network, and BaSiCPy is not baked in):

    pip install basicpy==1.1.0
    python tests/golden/make_basicpy_fixture.py

and commit the resulting ``tests/fixtures/basicpy_golden.npz`` (< 1 MB).
``tests/test_basic_model.py::test_matches_basicpy_golden_fixture`` gates the
in-repo LADMAP fit against it at a stated field-level tolerance and SKIPS
while the file is absent, so the gate arms itself the moment the fixture
lands.

The synthetic stack (16 × 128×128, smooth vignette flat + offset dark +
sparse blobs) is SAVED INTO the npz — the comparison never depends on RNG
reproducibility across numpy versions. Knobs are the production ones the
reference uses (zarr_destriper_orig.py:1092-1099 via
flatfield_estimation.py:43-45): smoothness_flatfield=1.0,
smoothness_darkfield=20, sort_intensity=True, max_reweight_iterations=35,
get_darkfield both False and True.
"""

import os
import sys

import numpy as np

FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "fixtures",
    "basicpy_golden.npz",
)

N, H, W = 16, 128, 128


def build_stack():
    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64) / (H - 1)
    # smooth vignette flat (peak center, ~35% falloff) + tilted darkfield
    true_flat = 1.0 - 0.35 * ((yy - 0.5) ** 2 + (xx - 0.5) ** 2) / 0.5
    true_dark = 60.0 + 25.0 * xx + 10.0 * yy
    images = np.zeros((N, H, W), np.float64)
    for i in range(N):
        base = 400.0 + 150.0 * rng.random()
        content = np.full((H, W), base)
        for _ in range(6):  # sparse smooth blobs (cells)
            cy, cx = rng.integers(10, H - 10), rng.integers(10, W - 10)
            amp = 800.0 + 1200.0 * rng.random()
            sig = 4.0 + 6.0 * rng.random()
            content += amp * np.exp(
                -(((yy * (H - 1) - cy) ** 2 + (xx * (W - 1) - cx) ** 2)
                  / (2 * sig**2))
            )
        images[i] = content * true_flat + true_dark + rng.normal(
            scale=3.0, size=(H, W)
        )
    return images.astype(np.float32), true_flat, true_dark


def main():
    images, true_flat, true_dark = build_stack()
    try:
        import basicpy
    except ImportError:
        print(
            "BaSiCPy is not installed here. Run this script on a machine "
            "with `pip install basicpy==1.1.0` and commit the npz.",
            file=sys.stderr,
        )
        sys.exit(2)

    out = {"images": images, "true_flat": true_flat, "true_dark": true_dark,
           "basicpy_version": np.array(basicpy.__version__)}
    for get_dark in (False, True):
        model = basicpy.BaSiC(
            get_darkfield=get_dark,
            smoothness_flatfield=1.0,
            smoothness_darkfield=20,
            sort_intensity=True,
            max_reweight_iterations=35,
        )
        model.fit(images)
        tag = "dark" if get_dark else "nodark"
        out[f"flatfield_{tag}"] = np.asarray(model.flatfield, np.float32)
        out[f"darkfield_{tag}"] = np.asarray(model.darkfield, np.float32)
        out[f"baseline_{tag}"] = np.asarray(model.baseline, np.float32)

    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")


if __name__ == "__main__":
    main()
