"""
aind_smartspim_destripe_tpu — a JAX/XLA rebuild of the SmartSPIM destriping
framework, run on NVIDIA GPUs (the package name records the accelerator it
was first built for).

Re-implements, device-first, every capability of the reference
AllenNeuralDynamics/aind-smartspim-destripe pipeline (see SURVEY.md):

- ``ops``      — the numeric kernels (wavelets, FFT-notch, Otsu, stripe filter,
                 flat-field application, multiscale pyramid), all jittable JAX.
- ``models``   — the BaSiC shading-estimation model and filter configurations.
- ``parallel`` — device-mesh sharding (shard_map) of the destripe step.
- ``io``       — Zarr v2 store + blosc codec (C++ native backend), OME-NGFF
                 metadata, TIFF/PNG/RAW readers and writers.
- ``runtime``  — streaming host<->device pipeline (double-buffered), blocked
                 zarr writer, resource profiling.
- ``utils``    — logging, provenance, config.

Top-level orchestration modules mirror the reference public API surface:
``destriper`` (file-batch path), ``zarr_destriper`` (production Zarr path),
``flatfield_estimation``, ``run_capsule``.
"""

__version__ = "0.1.0"
