"""Continuous batching for heterogeneous solve streams (lane refill).

The fused vmapped solver runs every lane of a batch to the BATCH max
iteration count: with heterogeneous difficulty, converged lanes idle while
stragglers finish (the lane-idle tax). This module keeps
a fixed B-lane device batch busy from a STREAM of problems with the refill
INSIDE the device loop: one jitted ``lax.while_loop`` advances every lane by
``chunk_it`` SCP iterations, retires finished lanes into device-resident
result buffers (predicated scatter via a dump row), gathers fresh problems
from the device-resident stream pool, and re-initializes only those lanes'
carries — the host sees ONE dispatch and ONE final pull for the whole
stream. The on-device analog of the reference farm's greedy dispatch +
requeue (``pmpc/remote.py:391-452``).

(A host-driven refill pays ~17 eager dispatches and a host sync per refill
round; the device loop removes every per-round host touch.)
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np


def solve_stream(
    solver,
    stream: Sequence[Any],
    B: int,
    chunk_it: int = 4,
    max_it: int = 10_000,
    max_rounds: int = 100_000,
) -> List[Tuple[np.ndarray, np.ndarray, dict]]:
    """Solve a stream of same-shape problems with in-device-loop lane refill.

    Args:
        solver: a `build_scp_solver(...)` result (carries ``init_carry`` /
            ``run_chunk`` / ``extract``).
        stream: sequence of single-problem `SCPData` pytrees (unbatched).
        B: device batch width (lanes).
        chunk_it: SCP iterations per refill opportunity.
        max_it: iteration budget per problem — a lane that reaches it
            without converging is retired (``info["converged"]=False``).

    Returns:
        list of (X_traj, U, info) in input order; ``info["iters"]`` is the
        lane's own iteration count (not a batch max).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    S = len(stream)
    if S == 0:
        return []
    B = min(B, S)

    pool = jax.tree.map(lambda *xs: jnp.stack(xs), *stream)  # (S, ...)

    @jax.jit
    def drive(pool):
        data0 = jax.tree.map(lambda a: a[:B], pool)
        carry0 = jax.vmap(solver.init_carry)(data0)
        lane_prob0 = jnp.arange(B, dtype=jnp.int32)
        # result buffers with a dump row at index S (predicated scatter)
        eX, eU, einfo = jax.vmap(solver.extract)(data0, carry0)
        rX = jnp.zeros((S + 1,) + eX.shape[1:], eX.dtype)
        rU = jnp.zeros((S + 1,) + eU.shape[1:], eU.dtype)
        rMeta = jnp.zeros((S + 1, 3), jnp.float32)  # iters, resid, converged

        def cond(st):
            n_done, rounds = st[0], st[1]
            return (n_done < S) & (rounds < max_rounds)

        def body(st):
            n_done, rounds, next_p, lane_prob, data, carry, rX, rU, rMeta = st
            carry = jax.vmap(lambda d, c: solver.run_chunk(d, c, chunk_it))(
                data, carry)
            done = carry[3]
            iters = carry[2]
            active = lane_prob >= 0
            fin = (done | (iters >= max_it)) & active

            # retire: write finished lanes' results (inactive -> dump row S).
            # Scatter and gather are expressed as one-hot MATMULS (the
            # codebase's broadcast-mask idiom) — exact row copies (each
            # output row is 1.0 * one source row).
            eX, eU, einfo = jax.vmap(solver.extract)(data, carry)
            idx = jnp.where(fin, lane_prob, S)
            oh_r = (idx[:, None] == jnp.arange(S + 1)[None, :])  # (B, S+1)

            def retire(buf, rows):
                ohf = oh_r.astype(rows.dtype)
                delta = jnp.einsum(
                    "bs,bd->sd", ohf, rows.reshape(B, -1)).reshape(buf.shape)
                keep = ~jnp.any(oh_r, axis=0)
                return jnp.where(
                    keep.reshape((S + 1,) + (1,) * (buf.ndim - 1)),
                    buf, delta)

            rX = retire(rX, eX)
            rU = retire(rU, eU)
            meta = jnp.stack([iters.astype(jnp.float32),
                              einfo["resid"].astype(jnp.float32),
                              done.astype(jnp.float32)], axis=-1)
            rMeta = retire(rMeta, meta)
            n_done = n_done + jnp.sum(fin).astype(jnp.int32)

            # refill: k-th finishing lane takes problem next_p + k
            ranks = jnp.cumsum(fin.astype(jnp.int32)) - 1
            new_idx = next_p + ranks
            refill = fin & (new_idx < S)
            gather = jnp.clip(new_idx, 0, S - 1)
            oh_g = (gather[:, None] == jnp.arange(S)[None, :]) \
                & refill[:, None]  # (B, S)

            def pull(full, cur):
                rows = jnp.einsum(
                    "bs,sd->bd", oh_g.astype(cur.dtype),
                    full.reshape(S, -1)).reshape((B,) + full.shape[1:])
                return jnp.where(
                    refill.reshape((B,) + (1,) * (cur.ndim - 1)), rows, cur)

            data = jax.tree.map(pull, pool, data)
            fresh = jax.vmap(solver.init_carry)(data)
            sel = lambda n, c: jax.tree.map(
                lambda a, b: jnp.where(
                    refill.reshape((B,) + (1,) * (b.ndim - 1)), a, b), n, c)
            carry = sel(fresh, carry)
            lane_prob = jnp.where(refill, new_idx.astype(jnp.int32),
                                  jnp.where(fin, -1, lane_prob))
            next_p = next_p + jnp.sum(fin).astype(jnp.int32)
            return (n_done, rounds + 1, next_p, lane_prob, data, carry,
                    rX, rU, rMeta)

        st0 = (jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
               jnp.asarray(B, jnp.int32), lane_prob0, data0, carry0,
               rX, rU, rMeta)
        st = lax.while_loop(cond, body, st0)
        return st[6], st[7], st[8], st[0]

    rX, rU, rMeta, n_done = drive(pool)
    rX, rU, rMeta = np.asarray(rX), np.asarray(rU), np.asarray(rMeta)
    if int(n_done) < S:
        raise RuntimeError(
            f"solve_stream: only {int(n_done)}/{S} problems finished "
            f"(max_rounds={max_rounds})")
    return [(rX[i], rU[i], dict(iters=int(rMeta[i, 0]),
                                resid=float(rMeta[i, 1]),
                                converged=bool(rMeta[i, 2] > 0)))
            for i in range(S)]
