"""Linearized-dynamics utilities: rollouts, condensation, and JAX-native linearization.

All functions here operate on a SINGLE problem with arrays shaped ``(N, ...)``;
particle (M) and scenario-batch axes are added by ``jax.vmap`` at call sites.

Semantics parity (reference):
- the affine rollout matches ``PMPC.jl/src/types.jl:161-179`` (``rollout!``):
  ``x_j = f_j + fx_j (x_{j-1} - xlin_{j-1}) + fu_j (u_j - U_prev_j)`` with
  ``xlin = [x0, X_prev[:-1]]`` and the ``fx_0`` term vanishing at ``j=0``,
- the condensed dense dynamics map ``X = Ft @ vec(U - U_prev) + ft`` matches the
  structure of ``pmpc/experimental/jax/dynamics.py:81-114``
  (``dynamics_linear_matrix``) built as an O(N) scan,
- feedback rollout matches ``types.jl:181-201``.

Layout notes: the condensation scan carries a full ``(xdim, N*udim)`` row
block so each step is a small matmul; the result feeds big batched matmuls
downstream, never sparse scatter/gather.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax import lax


def rollout(x0, f, fx, fu, X_prev, U_prev, U):
    """Roll out the affine (linearized) dynamics for controls ``U``.

    Args:
        x0: (xdim,) initial state.
        f: (N, xdim) dynamics value at the linearization point.
        fx: (N, xdim, xdim) state Jacobians.
        fu: (N, xdim, udim) control Jacobians.
        X_prev: (N, xdim) linearization state trajectory (states AFTER each step).
        U_prev: (N, udim) linearization controls.
        U: (N, udim) controls to roll out.

    Returns:
        X: (N, xdim) states after each step (not including x0).
    """
    xlin = jnp.concatenate([x0[None, :], X_prev[:-1]], axis=0)
    du = U - U_prev

    def step(x, inp):
        f_j, fx_j, fu_j, xlin_j, du_j = inp
        x_next = f_j + fx_j @ (x - xlin_j) + fu_j @ du_j
        return x_next, x_next

    _, X = lax.scan(step, x0, (f, fx, fu, xlin, du))
    return X


def rollout_feedback(x0, f, fx, fu, X_prev, U_prev, L, l):
    """Roll out affine state-feedback ``u_j = l_j + L_j x_{j-1}`` (x_{-1} = x0).

    Matches ``PMPC.jl/src/types.jl:181-201``. Returns (X, U)."""
    xlin = jnp.concatenate([x0[None, :], X_prev[:-1]], axis=0)

    def step(x, inp):
        f_j, fx_j, fu_j, xlin_j, up_j, L_j, l_j = inp
        u_j = l_j + L_j @ x
        x_next = f_j + fx_j @ (x - xlin_j) + fu_j @ (u_j - up_j)
        return x_next, (x_next, u_j)

    _, (X, U) = lax.scan(step, x0, (f, fx, fu, xlin, U_prev, L, l))
    return X, U


def condense(x0, f, fx, fu, X_prev, U_prev, unroll: int = 1) -> Tuple[jax.Array, jax.Array]:
    """Build the dense condensed dynamics map ``vec(X) = Ft @ vec(U - U_prev) + ft``.

    ``Ft`` is block lower-triangular with blocks
    ``Ft[j, l] = fx_j fx_{j-1} ... fx_{l+1} fu_l`` for ``l <= j``; ``ft`` is the
    rollout at ``U = U_prev``. Built with an O(N) scan whose carry is the full
    ``(xdim, N*udim)`` sensitivity row (each step: one small matmul + one
    dynamic-slice insert), so XLA sees only dense matmul-shaped work.

    Accepts arbitrary leading batch dims (f: (..., N, xdim) etc.) — the scan
    carries the whole batch, so callers with explicit batch axes get direct
    batched HLO instead of paying the vmap batching transform.

    Returns:
        Ft: (..., N*xdim, N*udim)
        ft: (..., N*xdim)
    """
    N, xdim = f.shape[-2:]
    udim = fu.shape[-1]
    batch = f.shape[:-2]
    xlin = jnp.concatenate([x0[..., None, :], X_prev[..., :-1, :]], axis=-2)

    # one-hot block placement e_j (x) fu_j, built OUTSIDE the scan: an in-body
    # dynamic_update_slice copies the whole (xdim, N*udim) carry every step;
    # as a precomputed scan input the body is a single fused matmul+add.
    # Built by broadcast-masking, not scatter, so it is one elementwise
    # product.
    onehot = jnp.eye(N, dtype=f.dtype)  # (N, N)
    E = onehot[:, None, :, None] * fu[..., :, :, None, :]  # (..., N, xdim, N, udim)
    E = E.reshape(batch + (N, xdim, N * udim))

    Ft, ft = _condense_scan(x0, f, fx, E, xlin)
    return (Ft.reshape(batch + (N * xdim, N * udim)),
            ft.reshape(batch + (N * xdim,)))


@jax.custom_batching.custom_vmap
def _condense_scan(x0, f, fx, E, xlin):
    """The condense rows scan over ONE flat leading batch axis.

    custom_vmap folds every outer vmap axis into the flat batch instead of
    letting the batching transform split the carry into (B, M, xdim, NU):
    one (B*M)-flat carry per scan step. The math is per-lane, so the fold is
    exact.

    Returns (rows (..., N, xdim, NU), xs (..., N, xdim))."""
    N, xdim = f.shape[-2:]
    batch = f.shape[:-2]
    nb = len(batch)
    mv = lambda a: jnp.moveaxis(a, nb, 0) if nb else a  # N axis to front

    def step(carry, inp):
        row_prev, x_prev = carry
        f_j, fx_j, E_j, xlin_j = inp
        # sensitivity row: d x_j / d vec(U) = fx_j @ row_{j-1} + e_j (x) fu_j.
        # A contraction over xdim (4) is too small for a matmul unit; the
        # broadcast-multiply-reduce form lowers to one elementwise fusion in
        # full f32, whatever the matmul precision setting.
        row = jnp.sum(fx_j[..., :, :, None] * row_prev[..., None, :, :],
                      axis=-2) + E_j
        x_next = f_j + jnp.einsum("...ij,...j->...i", fx_j, x_prev - xlin_j)
        return (row, x_next), (row, x_next)

    NU = E.shape[-1]
    init = (jnp.zeros(batch + (xdim, NU), dtype=f.dtype), x0)
    _, (rows, xs) = lax.scan(step, init, (mv(f), mv(fx), mv(E), mv(xlin)))
    return jnp.moveaxis(rows, 0, nb), jnp.moveaxis(xs, 0, nb)


@_condense_scan.def_vmap
def _condense_scan_vmap(axis_size, in_batched, x0, f, fx, E, xlin):  # noqa: ANN001
    bcast = lambda a, b: a if b else jnp.broadcast_to(a[None],
                                                      (axis_size,) + a.shape)
    x0, f, fx, E, xlin = (
        bcast(a, b) for a, b in
        zip((x0, f, fx, E, xlin), in_batched))
    if f.ndim - 1 - 2 == 0:
        # the unbatched call had no leading dims: the vmap axis IS the flat
        # batch — no fold needed
        rows, xs = _condense_scan(x0, f, fx, E, xlin)
        return (rows, xs), (True, True)
    lead = f.shape[:2]
    flat = lambda a: a.reshape((lead[0] * lead[1],) + a.shape[2:])
    rows, xs = _condense_scan(flat(x0), flat(f), flat(fx), flat(E), flat(xlin))
    unflat = lambda a: a.reshape(lead + a.shape[1:])
    return (unflat(rows), unflat(xs)), (True, True)


def linearize(dynamics: Callable, X: jax.Array, U: jax.Array):
    """Compute ``(f, fx, fu)`` for a JAX-traceable single-step dynamics ``f(x, u)``.

    This is the JAX-native dynamics protocol replacing the reference's arbitrary
    Python ``f_fx_fu_fn`` callback (e.g. torch autodiff in
    ``tests/dubins_car.py:7-45``): per-step Jacobians via ``jacfwd`` under vmap.

    Args:
        dynamics: function (x: (xdim,), u: (udim,)) -> (xdim,) next state.
        X: (..., N, xdim) states entering each step.
        U: (..., N, udim) controls.

    Returns:
        f: (..., N, xdim), fx: (..., N, xdim, xdim), fu: (..., N, xdim, udim)
    """

    xdim = X.shape[-1]

    def single(x, u):
        # ONE combined jacfwd over z = [x; u] with the primal as aux: a single
        # trace of the dynamics instead of three (value + two jacfwds) — the
        # tangent count (xdim + udim) is the same either way
        def g(z):
            y = dynamics(z[:xdim], z[xdim:])
            return y, y

        J, y = jax.jacfwd(g, has_aux=True)(jnp.concatenate([x, u]))
        return y, J[:, :xdim], J[:, xdim:]

    fn = single
    for _ in range(X.ndim - 1):
        fn = jax.vmap(fn)
    return fn(X, U)


def make_f_fx_fu_fn(dynamics: Callable) -> Callable:
    """Wrap a JAX single-step dynamics into the reference-style ``f_fx_fu_fn(X, U)``."""

    @jax.jit
    def _lin(X, U):
        return linearize(dynamics, X, U)

    def f_fx_fu_fn(X, U):
        # one device->host transfer for (f, fx, fu): the host SCP loop pulls
        # each output separately otherwise — three blocking round trips per
        # iteration
        return jax.device_get(_lin(jnp.asarray(X), jnp.asarray(U)))

    f_fx_fu_fn.__wrapped_dynamics__ = dynamics
    return f_fx_fu_fn


def shorten_horizon(N_new: int, *arrays, N: int = None):
    """Slice problem arrays to a shorter horizon (parity with
    ``PMPC.jl/src/types.jl:203-237``): each array keeps its first ``N_new``
    entries along the horizon axis — axis -2 for (..., N, d) arrays, axis -3
    for (..., N, d, d) matrix stacks.

    Pass the current horizon ``N`` to disambiguate when a square trailing
    block could be mistaken for a matrix stack (e.g. a (M, N, xdim) vector
    array with N == xdim would otherwise be sliced along the wrong axis)."""
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        if N is None:
            matrix = a.ndim >= 3 and a.shape[-1] == a.shape[-2]
        else:
            matrix = (a.ndim >= 3 and a.shape[-1] == a.shape[-2]
                      and a.shape[-3] == N)
            if not matrix and a.shape[-2] != N:
                raise ValueError(
                    f"array of shape {a.shape} has horizon {N} on neither "
                    f"axis -2 nor -3")
        out.append(a[..., :N_new, :, :] if matrix else a[..., :N_new, :])
    return out


def dynamics_violation(x0, f, fx, fu, X_prev, U_prev, X, U):
    """Per-step linearized dynamics violation norms; parity with
    ``PMPC.jl/src/types.jl:348-364``. Returns (total, per-step)."""
    pred = rollout_residual(x0, f, fx, fu, X_prev, U_prev, X, U)
    viols = jnp.linalg.norm(pred, axis=-1)
    return jnp.sum(viols), viols


def rollout_residual(x0, f, fx, fu, X_prev, U_prev, X, U):
    """``x_j - (f_j + fx_j (x_{j-1} - xlin_{j-1}) + fu_j (u_j - U_prev_j))`` for all j."""
    xlin = jnp.concatenate([x0[None, :], X_prev[:-1]], axis=0)
    xm1 = jnp.concatenate([x0[None, :], X[:-1]], axis=0)
    pred = f + jnp.einsum("nij,nj->ni", fx, xm1 - xlin) + jnp.einsum("nij,nj->ni", fu, U - U_prev)
    return X - pred
