"""Sharded batched SCP solving: GSPMD partitioning of the vmapped solver.

Design: the single-problem solver from `pmpc_tpu.jax_scp.build_scp_solver` is
vmapped over a scenario batch B and jitted with ``NamedSharding`` constraints
placing B on the 'batch' mesh axis and the particle axis M on 'particle'. XLA
then auto-partitions the whole SCP program: per-particle condensation,
Cholesky factorizations and IPM iterations stay local to each particle shard,
while the consensus-block contractions (sums over M inside the arrow Schur
complement, IPM duality reductions) lower to ``all-reduce`` over the
'particle' axis (NVLink between the cards of one host).
"""

from __future__ import annotations

from typing import Callable

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..jax_scp import SCPData


def make_sharded_solver(
    solver: Callable,
    mesh: Mesh,
    shard_particles: bool = True,
    donate: bool = False,
) -> Callable:
    """Wrap a single-problem SCP solver into a batched mesh-sharded solver.

    Args:
        solver: fn(SCPData (M, ...)) -> (X, U, info) built by build_scp_solver
            (pass ``jit=False`` there; this wrapper jits).
        mesh: a ("batch", "particle") mesh from `make_mesh`.
        shard_particles: also shard the particle axis M over 'particle'
            (requires M % mesh.shape['particle'] == 0).

    Returns:
        fn(SCPData with leading (B, M, ...) axes) -> (X, U, info), sharded.
    """
    batched = jax.vmap(solver)

    def spec_for(x):
        if not hasattr(x, "ndim"):
            return P()
        if x.ndim >= 2 and shard_particles:
            return P("batch", "particle")
        if x.ndim >= 1:
            return P("batch")
        return P()

    def shardings_like(tree):
        return jax.tree.map(lambda x: NamedSharding(mesh, spec_for(x)), tree)

    def call(data: SCPData):
        # pin the intended layout even if inputs arrived unsharded
        data = jax.lax.with_sharding_constraint(data, shardings_like(data))
        return batched(data)

    jit_kwargs = {}
    if donate:
        jit_kwargs["donate_argnums"] = (0,)
    return jax.jit(call, **jit_kwargs)
