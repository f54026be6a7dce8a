"""
Device identity for measurement and smoke runs: refuse anything but an
NVIDIA GPU, name the device the way results must be labelled, and read the
card's name and power limit.
"""

from __future__ import annotations

import subprocess

__all__ = ["require_gpu", "device_record", "card_info", "CompileClock"]


def require_gpu():
    """``jax.devices()`` when they are GPUs; SystemExit(1) otherwise. There
    is no CPU fallback: a number from another backend must never be
    reported under a device metric."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX found {len(devices)} {devices[0].platform!r} "
            "device(s); this run needs an NVIDIA GPU"
        )
    return devices


def device_record(devices) -> dict:
    """The device as JAX reports it: platform, device_kind and count."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def card_info() -> str:
    """``name, power.limit`` of every card, one per line, as nvidia-smi
    reports them (a card may be capped below its maximum power, which
    lowers its clocks under load: every number is kept beside this)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


class CompileClock:
    """Counts XLA compilations and their seconds while registered, from
    JAX's own compile-duration events (``/jax/core/compile/...``)."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.compiles = 0

        def listener(event, duration, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.compiles += 1
            if event.startswith("/jax/core/compile/"):
                self.seconds += duration

        jax.monitoring.register_event_duration_secs_listener(listener)
