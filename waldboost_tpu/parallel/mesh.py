"""Device-mesh helpers for multi-chip scaling.

Detection is embarrassingly parallel over images, so the canonical mesh here
is 1-D data parallelism over the device interconnect; training shards the sample pool the same
way (the only cross-chip reductions a WaldBoost step needs are the global
histogram / weight-sum / threshold statistics — see SURVEY.md §2's
parallelism inventory).  Shardings are expressed with jax.sharding + jit so
XLA inserts the collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["make_mesh", "data_sharding", "replicated", "shard_array",
           "is_multiprocess", "DATA_AXIS"]

DATA_AXIS = "data"


def is_multiprocess(mesh: Optional[Mesh]) -> bool:
    """True when ``mesh`` spans devices of more than one jax process (a
    multi-host / multi-slice DCN mesh): some shards are then NOT host-
    addressable from this process, so host<->device staging must go through
    global-array construction instead of plain device_put/asarray."""
    if mesh is None:
        return False
    procs = {d.process_index for d in mesh.devices.flat}
    return len(procs) > 1


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
              axis_name: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` local devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"Requested {n_devices} devices but only {len(devices)} available")
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def data_sharding(mesh: Mesh, ndim: int, axis_name: str = DATA_AXIS) -> NamedSharding:
    """Shard the leading dimension over the data axis, replicate the rest."""
    spec = PartitionSpec(axis_name, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_array(x, mesh: Mesh, axis_name: str = DATA_AXIS):
    """Place an array with its leading dim sharded across the mesh.

    Works on single-process meshes (plain device_put) AND multi-process
    (DCN) meshes: there, every process passes the same full host value (the
    multi-controller SPMD contract) and this builds the global array from
    each process's addressable shards via ``jax.make_array_from_callback``.
    """
    s = data_sharding(mesh, np.ndim(x), axis_name)
    if is_multiprocess(mesh):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, s,
                                            lambda idx: x[idx])
    import jax.numpy as jnp
    return jax.device_put(jnp.asarray(x), s)
