"""Device mesh construction and sharding helpers.

The in-program replacement for the reference's process-per-worker solve farm
(``pmpc/remote.py``): instead of queueing problems to ZMQ workers, the scenario
batch is a sharded array axis on a ``jax.sharding.Mesh`` and the particle axis
can be sharded too — the consensus coupling then reduces across devices with
XLA collectives (the ``psum`` the reference performs serially in
``main.jl:338-344``/``lqp_utils.jl:17-61``). The mesh assumes no topology:
devices are laid out in the order ``jax.devices()`` gives them, which suits
cards joined all to all (NVLink within a host).

Axes convention:
- ``batch``: independent scenario/problem instances (pure data parallel),
- ``particle``: the M consensus particles of each problem (the "tensor
  parallel" analog — contractions over it become psum/reduce-scatter).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_batch: Optional[int] = None,
    n_particle: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Create a ("batch", "particle") mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_batch is None:
        n_batch = n // n_particle
    assert n_batch * n_particle == n, (
        f"mesh {n_batch}x{n_particle} does not cover {n} devices"
    )
    dev_array = np.array(devices).reshape(n_batch, n_particle)
    return Mesh(dev_array, axis_names=("batch", "particle"))


def data_sharding(mesh: Mesh, shard_particles: bool = True) -> NamedSharding:
    """Sharding for (B, M, ...) problem arrays: B over 'batch', M over 'particle'."""
    if shard_particles:
        return NamedSharding(mesh, P("batch", "particle"))
    return NamedSharding(mesh, P("batch"))


def shard_batched_data(data, mesh: Mesh, shard_particles: bool = True):
    """Place a pytree of (B, M, ...) arrays onto the mesh.

    Arrays with fewer than 2 leading batch dims are replicated."""
    def place(x):
        if not hasattr(x, "ndim"):
            return x
        if x.ndim >= 2 and shard_particles:
            spec = P("batch", "particle")
        elif x.ndim >= 2:
            spec = P("batch")
        else:
            # fewer than 2 dims cannot be a (B, M, ...) batch array:
            # replicate (sharding a 1-D non-batch leaf along 'batch' would
            # hand each shard a different slice of a shared constant)
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(place, data)
