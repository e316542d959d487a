"""Multi-host initialization helpers.

The reference is strictly single-node (SURVEY.md section 2.4); scaling this
framework across hosts uses the standard JAX distributed runtime: every host
calls :func:`initialize_distributed`, after which ``jax.devices()`` spans
every host's devices and the (time, channels) meshes built by
``parallel.make_mesh`` shard across hosts transparently — the device interconnect carries the
halo/collective traffic, the host network only coordinates.

Ingest in a multi-host deployment is per-host: each host feeds the
time-shards owned by its local devices (`host_local_block` below gives the
slice of a global block a host should supply), which is the
"per-host shard of the IQ stream" design of SURVEY.md section 7.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialize the JAX distributed runtime (idempotent).

    With no arguments, relies on the cluster environment
    (JAX_COORDINATOR_ADDRESS etc.)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise


def host_time_span(mesh, axis: str = "time") -> Tuple[int, int, int]:
    """(start, stop, T): the contiguous span of `axis` shards owned by
    this host's local devices, out of T total.  Raises when the mesh
    layout gives this host a non-contiguous span (lay the mesh out with
    the default device order so each host owns one contiguous time
    span)."""
    t_axis = list(mesh.axis_names).index(axis)
    T = mesh.shape[axis]
    local_ids = {d.id for d in jax.local_devices()}
    # time-shard index of each device row in the mesh
    owned = sorted({idx[t_axis]
                    for idx, d in np.ndenumerate(mesh.devices)
                    if d.id in local_ids})
    if not owned:
        return 0, 0, T
    start, stop = owned[0], owned[-1] + 1
    if owned != list(range(start, stop)):
        raise ValueError(
            f"this host's '{axis}' shards {owned} are not contiguous in "
            f"mesh order; lay the mesh out so each host owns a "
            f"contiguous time span (e.g. make_mesh with the default "
            f"device order)")
    return start, stop, T


def host_local_block(x_global: np.ndarray, mesh,
                     axis: str = "time") -> Tuple[np.ndarray, int]:
    """The contiguous slice of a global IQ block this host must provide.

    Returns (local_samples, global_offset).  With T time shards over P
    hosts, each host owns the segments of its local devices; segments are
    contiguous in mesh order."""
    start, stop, T = host_time_span(mesh, axis)
    seg = len(x_global) // T
    if start == stop:
        return np.zeros(0, dtype=x_global.dtype), 0
    return x_global[start * seg: stop * seg], start * seg
