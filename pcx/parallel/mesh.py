"""Device-mesh helpers for the two parallel axes of the workload.

The reference is single-GPU (SURVEY.md section 2.4); pcx scales along:

* "k"    — the Brillouin-zone sweep: k-points are independent solves
           (the reference's serial loop, numerical_experiments.py:418),
* "grid" — the FFT grid for N beyond one chip's HBM: pencil-decomposed
           3-D FFT + local symbol multiplies; Gram reductions psum.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, PartitionSpec as P

K_AXIS = "k"
GRID_AXIS = "grid"


def make_mesh(n_k: Optional[int] = None, n_grid: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over ("k", "grid").  Defaults: all grid if n_grid given, else
    split devices evenly preferring the k axis (independent solves scale
    perfectly; grid sharding pays all_to_all)."""
    devices = list(devices if devices is not None else jax.devices())
    n_dev = len(devices)
    if n_k is None and n_grid is None:
        n_k, n_grid = n_dev, 1
    elif n_k is None:
        n_k = n_dev // n_grid
    elif n_grid is None:
        n_grid = n_dev // n_k
    if n_k * n_grid != n_dev:
        raise ValueError(f"mesh {n_k}x{n_grid} != {n_dev} devices")
    arr = np.asarray(devices).reshape(n_k, n_grid)
    return Mesh(arr, (K_AXIS, GRID_AXIS))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Multi-host bring-up: initialize the JAX distributed runtime so
    ``jax.devices()`` returns the GLOBAL device list (SURVEY.md section 5.8).

    Arguments default to the standard cluster env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).  A no-op returning 0 when neither
    arguments nor env vars request distribution.  On CPU test rigs the
    cross-process collectives run over gloo
    (jax_cpu_collectives_implementation, default on).

    Returns the process index.
    """
    import os
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return 0  # single-host
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_index()


def make_multihost_mesh(n_grid: int = 1) -> Mesh:
    """Global ("k", "grid") mesh after :func:`init_distributed`:
    process-major device order, so the k axis (independent solves that
    never communicate) spans hosts while grid sharding (an all_to_all in
    every operator apply) stays among one host's cards, which NVLink joins
    all to all — within a host the mesh shape follows the algorithm
    alone."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_local = len([d for d in devs
                   if d.process_index == jax.process_index()])
    if n_grid > max(n_local, 1):
        raise ValueError(
            f"n_grid={n_grid} exceeds {n_local} cards per host — grid "
            f"all_to_alls would cross the host network")
    return make_mesh(n_grid=n_grid, devices=devs)


def host_slice(n_items: int) -> list:
    """Strided slice of work items owned by this process — the multi-host
    split of the band sweep (each host computes its own k-points and writes
    its own checkpoint shard)."""
    return list(range(jax.process_index(), n_items, jax.process_count()))


def field_spec(batched: bool = False) -> P:
    """PartitionSpec of a field block (m, 3, N, N, N): shard the LAST grid
    axis over "grid" (pencil layout); optionally a leading k-batch axis."""
    if batched:
        return P(K_AXIS, None, None, None, None, GRID_AXIS)
    return P(None, None, None, None, GRID_AXIS)


def symbol_spec(batched: bool = False) -> P:
    """PartitionSpec of a symbol (3, N, N, N) (same grid sharding)."""
    if batched:
        return P(K_AXIS, None, None, None, GRID_AXIS)
    return P(None, None, None, GRID_AXIS)
