"""
Device + host tracing (the reference's observability surface, extended).

The reference samples host CPU/memory into a matplotlib PNG
(utils.py:21-121) and prints wall-clock phase timings
(zarr_destriper.py:1088-1199). Here that is kept (utils.ResourceProfiler)
and extended with what an accelerator deployment needs:

- ``device_trace``: a context manager around ``jax.profiler`` emitting an
  XPlane trace viewable in TensorBoard/XProf,
- ``StageTimer``: per-stage wall-clock + throughput accounting used by the
  streaming pipeline (read/compute/write seconds and MPix/s per stage),
- ``annotate``: named trace regions (jax.profiler.TraceAnnotation).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Profile the enclosed block with jax.profiler when ``logdir`` is set;
    no-op otherwise."""
    if not logdir:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region in the device trace (safe no-op without jax)."""
    try:
        import jax

        return jax.profiler.TraceAnnotation(name)
    except Exception:  # pragma: no cover
        return contextlib.nullcontext()


@dataclass
class StageTimer:
    """Accumulate per-stage seconds and pixel counts."""

    seconds: Dict[str, float] = field(default_factory=dict)
    pixels: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, pixels: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.pixels[name] = self.pixels.get(name, 0) + pixels

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, sec in self.seconds.items():
            px = self.pixels.get(name, 0)
            out[name] = {
                "seconds": round(sec, 3),
                "mpix_per_s": round(px / sec / 1e6, 1) if sec and px else None,
            }
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
