"""
CLI config schema for the legacy file-batch path (reference surface:
code/aind_smartspim_destripe/destriper_params.py, an argschema model).

Rebuilt on argparse + dataclass (argschema is not in this runtime): same
fields, defaults, and semantics — input_path, output_path, workers (16),
chunks (1), output_format.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from pathlib import Path
from typing import Optional


@dataclass
class DestripingParams:
    """Parameters for ``destriper.batch_filter``."""

    input_path: str
    output_path: str
    workers: int = 16
    chunks: int = 1
    output_format: Optional[str] = None
    # extras beyond the reference schema: dual-band blend mode
    dual_band: bool = False
    crossover: float = 100.0
    dual_threshold: float = -1.0

    def validate(self) -> "DestripingParams":
        if not Path(self.input_path).is_dir():
            raise ValueError(f"input_path is not a directory: {self.input_path}")
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        if self.chunks < 1:
            raise ValueError("chunks must be >= 1")
        return self

    @staticmethod
    def parser() -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(
            description="SmartSPIM destriper (file-batch mode)"
        )
        p.add_argument("--input_path", required=True,
                       help="Path to the input directory of images")
        p.add_argument("--output_path", required=True,
                       help="Path where filtered images are written")
        p.add_argument("--workers", type=int, default=16,
                       help="IO worker threads")
        p.add_argument("--chunks", type=int, default=1,
                       help="Images per device batch")
        p.add_argument("--output_format", default=None,
                       help="Output extension (.tiff/.tif/.png)")
        p.add_argument("--dual_band", action="store_true",
                       help="Blend both filter configs per pixel instead of "
                            "the per-plane classifier (dual-band mode)")
        p.add_argument("--crossover", type=float, default=100.0,
                       help="Dual-band sigmoid width")
        p.add_argument("--dual_threshold", type=float, default=-1.0,
                       help="Dual-band sigmoid center; < 0 = per-plane Otsu")
        return p

    @classmethod
    def from_args(cls, argv=None) -> "DestripingParams":
        ns = cls.parser().parse_args(argv)
        return cls(**vars(ns)).validate()
