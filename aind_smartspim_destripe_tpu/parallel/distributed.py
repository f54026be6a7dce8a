"""
Multi-host runtime helpers (the host-network tier).

The reference is strictly single-node (SURVEY.md section 2.4). Across hosts
the natural decomposition is: tiles/channels across hosts (each host owns the
Zarr IO for its tiles — the host network only carries control), planes across
the devices of each host. These helpers wire that up:

- ``initialize_distributed``: jax.distributed.initialize wrapper (no-op on a
  single process),
- ``assign_tiles``: deterministic per-process tile ownership,
- ``host_local_mesh``: the mesh over this process's addressable devices,
- ``global_stats``: SUM a small stats vector across all hosts via a tiny replicated
  psum (the only cross-host collective the workload needs).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import jax
import numpy as np


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Bring up the multi-host runtime when configured; returns
    (process_index, process_count). Safe to call in single-process runs.

    Configuration sources, in order: explicit args, then the
    ``DESTRIPE_COORDINATOR_ADDRESS`` / ``DESTRIPE_NUM_PROCESSES`` /
    ``DESTRIPE_PROCESS_ID`` environment variables (set by the launcher on
    each host). Called by run_capsule.run() and the CLI, so a multi-host
    launch needs no code changes — just the env vars."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("DESTRIPE_COORDINATOR_ADDRESS")
        if coordinator_address:
            num_processes = int(os.environ.get("DESTRIPE_NUM_PROCESSES", "1"))
            process_id = int(os.environ.get("DESTRIPE_PROCESS_ID", "0"))
    if coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def assign_tiles(tiles: Sequence, process_index: Optional[int] = None,
                 process_count: Optional[int] = None) -> List:
    """Deterministic round-robin tile ownership: host i processes tiles
    i, i+P, i+2P, ... — each host streams only its own Zarr tiles, so bulk
    image data never crosses hosts."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    ordered = sorted(tiles, key=str)
    return [t for j, t in enumerate(ordered) if j % pc == pi]


def host_local_mesh(axis: str = "z") -> jax.sharding.Mesh:
    """1-D mesh over this process's local devices (plane axis)."""
    return jax.sharding.Mesh(np.array(jax.local_devices()), (axis,))


def global_stats(values: np.ndarray) -> np.ndarray:
    """Sum a small per-host stats vector across all hosts: each process
    contributes its local vector as one row of a process-sharded array and a
    replicated jitted sum reduces it (XLA inserts the cross-host collective).
    Identity in single-process runs."""
    values = np.asarray(values)
    if jax.process_count() == 1:
        return values
    # one representative device per process
    by_proc = {}
    for d in jax.devices():
        by_proc.setdefault(d.process_index, d)
    devs = np.array([by_proc[i] for i in sorted(by_proc)])
    mesh = jax.sharding.Mesh(devs, ("p",))
    P = jax.sharding.PartitionSpec
    arr = jax.make_array_from_process_local_data(
        jax.sharding.NamedSharding(mesh, P("p")),
        values[None],
        (len(devs),) + values.shape,
    )
    out = jax.jit(
        lambda x: x.sum(axis=0),
        out_shardings=jax.sharding.NamedSharding(mesh, P()),
    )(arr)
    return np.asarray(out)
