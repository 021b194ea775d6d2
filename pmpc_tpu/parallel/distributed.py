"""Multi-host runtime helpers (jax.distributed).

The reference scales across machines with a ZMQ/Redis worker farm
(``pmpc/remote.py``); the in-program equivalent is the JAX multi-host
runtime: one process per host, a global mesh whose 'batch' axis spans hosts
over the network while 'particle' stays within a host on NVLink, and
per-host shards fed with ``jax.make_array_from_process_local_data``.

This is the thin wiring layer for multi-host deployments; the sharding
itself is checked by ``__graft_entry__.dryrun_multichip`` on a virtual
device mesh, and `tests/test_distributed.py` runs two local processes.
"""

from __future__ import annotations

from typing import Optional

import jax


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-host runtime (idempotent). Without a cluster
    manager that JAX detects, pass all three arguments
    (``coordinator_address`` as ``host:port`` of process 0)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def global_mesh(n_particle: int = 1):
    """A ("batch", "particle") mesh over ALL processes' devices; 'batch' spans
    hosts, 'particle' should divide the per-host device count so consensus
    reductions stay within a host."""
    from .mesh import make_mesh

    return make_mesh(n_particle=n_particle, devices=jax.devices())


def host_local_batch_to_global(mesh, data):
    """Assemble a global sharded batch from per-process local shards."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(x):
        if not hasattr(x, "ndim"):
            return x
        spec = P("batch", "particle") if x.ndim >= 2 else (P("batch") if x.ndim else P())
        return jax.make_array_from_process_local_data(NamedSharding(mesh, spec), x)

    return jax.tree.map(put, data)
