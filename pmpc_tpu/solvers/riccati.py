"""Riccati-sweep LQR solver: O(N) stage-structured alternative to condensation.

The condensed path (`reduced.py`) materializes the O(N^2) dense sensitivity
``Ft`` — ideal for short horizons and huge batches. For long horizons the
classic backward/forward Riccati recursion solves the same equality-
constrained problem in O(N) with tiny per-stage matmuls under ``lax.scan``
(the "sparse, stage-structured" design the reference gets from its sparse
CPU solvers, re-expressed as scans; SURVEY §5 long-context note).

Cost semantics match the condensed assembly (`lqp_repr_Pq` without slew):
    sum_j 0.5 x_j'Qt_j x_j - xt_j'x_j + 0.5 u_j'Rt_j u_j - ut_j'u_j
    s.t.  x_j = c_j + A_j x_{j-1} + B_j u_j,   x_0 given,
with Qt = Q + reg_x I, xt = Q X_ref + reg_x X_prev (etc.).

Single-particle; vmap over particles/batches. Consensus (shared controls) is
handled by the theta-parameterized sweep below; slew coupling by
`augment_slew_stages` state augmentation (carry (u_j, u_{j-1}) in the stage
state — the reference's tridiagonal slew coupling, ``lqp_utils.jl:26-103``,
at O(N) for any horizon).
Also returns the affine feedback gains (K_j, k_j), the control law the
reference exposes through rollouts (``types.jl:181-201``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.linalg import psd_solve
from ..utils import with_matmul_precision


class LQRSolution(NamedTuple):
    X: jax.Array  # (N, xdim)
    U: jax.Array  # (N, udim)
    K: jax.Array  # (N, udim, xdim) feedback gains (u_j = K_j x_{j-1} + k_j)
    k: jax.Array  # (N, udim)


@partial(jax.jit, static_argnames=())
@with_matmul_precision("highest")
def riccati_solve(x0, c, A, B, Qt, xt, Rt, ut) -> LQRSolution:
    """Solve the affine-dynamics tracking LQR via backward/forward scans.

    Args:
        x0: (xdim,) initial state.
        c: (N, xdim) affine dynamics offsets.
        A: (N, xdim, xdim), B: (N, xdim, udim).
        Qt: (N, xdim, xdim) state Hessians; xt: (N, xdim) state linear targets
            (cost 0.5 x'Qt x - xt'x).
        Rt: (N, udim, udim); ut: (N, udim) (cost 0.5 u'Rt u - ut'u).
    """
    N, xdim = c.shape
    udim = B.shape[-1]
    dtype = c.dtype

    def backward(carry, inp):
        P, p = carry  # value of stages j+1.. as 0.5 x'Px + p'x
        c_j, A_j, B_j, Qt_j, xt_j, Rt_j, ut_j = inp
        M = Qt_j + P
        m = p - xt_j
        Mc_m = M @ c_j + m
        Hu = Rt_j + B_j.T @ M @ B_j
        BtMA = B_j.T @ M @ A_j
        rhs = jnp.concatenate([BtMA, (B_j.T @ Mc_m - ut_j)[:, None]], axis=1)
        sol = psd_solve(Hu, rhs)  # (udim, xdim+1)
        K_j = -sol[:, :xdim]
        k_j = -sol[:, xdim]
        AtM = A_j.T @ M
        P_new = AtM @ A_j + BtMA.T @ K_j
        P_new = 0.5 * (P_new + P_new.T)
        p_new = A_j.T @ Mc_m + BtMA.T @ k_j
        return (P_new, p_new), (K_j, k_j)

    init = (jnp.zeros((xdim, xdim), dtype), jnp.zeros((xdim,), dtype))
    _, (K, k) = lax.scan(backward, init, (c, A, B, Qt, xt, Rt, ut), reverse=True)

    def forward(x, inp):
        c_j, A_j, B_j, K_j, k_j = inp
        u = K_j @ x + k_j
        x_next = c_j + A_j @ x + B_j @ u
        return x_next, (x_next, u)

    _, (X, U) = lax.scan(forward, x0, (c, A, B, K, k))
    return LQRSolution(X=X, U=U, K=K, k=k)


def riccati_solve_scp(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                      reg_x, reg_u) -> LQRSolution:
    """Riccati solve of one SCP subproblem (single particle, reference cost
    semantics; affine dynamics from the linearization convention
    x_j = f_j + fx_j (x_{j-1} - xlin_{j-1}) + fu_j (u_j - U_prev_j))."""
    c, Qt, xt, Rt, ut = _scp_stage_terms(x0, f, fx, fu, X_prev, U_prev,
                                         Q, R, X_ref, U_ref, reg_x, reg_u)
    return riccati_solve(x0, c, fx, fu, Qt, xt, Rt, ut)


def _scp_stage_terms(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                     reg_x, reg_u):
    """Affine dynamics offsets + per-stage cost terms of one SCP subproblem."""
    xlin = jnp.concatenate([x0[None, :], X_prev[:-1]], axis=0)
    c = f - jnp.einsum("nij,nj->ni", fx, xlin) - jnp.einsum("nij,nj->ni", fu, U_prev)
    xdim = x0.shape[0]
    udim = U_prev.shape[-1]
    eye_x = jnp.eye(xdim, dtype=f.dtype)
    eye_u = jnp.eye(udim, dtype=f.dtype)
    Qt = Q + reg_x * eye_x
    Rt = R + reg_u * eye_u
    xt = jnp.einsum("nij,nj->ni", Q, X_ref) + reg_x * X_prev
    ut = jnp.einsum("nij,nj->ni", R, U_ref) + reg_u * U_prev
    return c, Qt, xt, Rt, ut


def augment_slew_stages(x0, c, A, B, Qt, xt, slew_reg, slew_reg0, slew_um1):
    """Carry (u_j, u_{j-1}) in the stage state so slew coupling becomes a
    pure per-stage STATE cost — the O(N) route to the reference's
    tridiagonal slew coupling (``lqp_utils.jl:26-103``), which the condensed
    path encodes densely and the plain stage sweep cannot express.

    Augmented state x~_j = [x_j; u_j; u_{j-1}] with dynamics

        x~_j = A~_j x~_{j-1} + B~_j u_j + c~_j,
        A~ = [[A,0,0],[0,0,0],[0,I,0]],  B~ = [B; I; 0],  c~ = [c; 0; 0],

    and per-stage state cost 0.5 w_j ||u_j - u_{j-1}||^2 with w_0 = slew_reg0
    (anchor ``slew_um1`` enters through x~_{-1} = [x0; slew_um1; 0]) and
    w_j = slew_reg for j >= 1 — exactly the reference cost semantics
    (`reduced.py` docstring). Single particle; vmap over M.

    Returns (x0_a, c_a, A_a, B_a, Qt_a, xt_a) with xdim_a = xdim + 2 udim."""
    N, xdim = c.shape
    udim = B.shape[-1]
    dtype = c.dtype
    na = xdim + 2 * udim
    eye_u = jnp.eye(udim, dtype=dtype)
    A_a = jnp.zeros((N, na, na), dtype)
    A_a = A_a.at[:, :xdim, :xdim].set(A)
    A_a = A_a.at[:, xdim + udim:, xdim:xdim + udim].set(eye_u)
    B_a = jnp.zeros((N, na, udim), dtype)
    B_a = B_a.at[:, :xdim, :].set(B)
    B_a = B_a.at[:, xdim:xdim + udim, :].set(eye_u)
    c_a = jnp.zeros((N, na), dtype).at[:, :xdim].set(c)
    w = jnp.where(jnp.arange(N) == 0, slew_reg0, slew_reg)  # (N,)
    Qt_a = jnp.zeros((N, na, na), dtype)
    Qt_a = Qt_a.at[:, :xdim, :xdim].set(Qt)
    wI = w[:, None, None] * eye_u
    Qt_a = Qt_a.at[:, xdim:xdim + udim, xdim:xdim + udim].set(wI)
    Qt_a = Qt_a.at[:, xdim + udim:, xdim + udim:].set(wI)
    Qt_a = Qt_a.at[:, xdim:xdim + udim, xdim + udim:].set(-wI)
    Qt_a = Qt_a.at[:, xdim + udim:, xdim:xdim + udim].set(-wI)
    xt_a = jnp.zeros((N, na), dtype).at[:, :xdim].set(xt)
    x0_a = jnp.concatenate([x0, slew_um1, jnp.zeros((udim,), dtype)])
    return x0_a, c_a, A_a, B_a, Qt_a, xt_a


def _theta_backward(x0, c, A, B, Qt, xt, Rt, ut, Nc: int):
    """Backward sweep of ONE particle with the first ``Nc`` stage controls
    treated as a shared PARAMETER vector theta (nc = Nc*udim entries).

    The value function of stages j.. is carried as a quadratic in the
    augmented variable (x, theta):

        V_j(x, th) = 0.5 [x; th]' P [x; th] + p' [x; th] + const,

    free stages (j >= Nc) eliminate u_j as usual; consensus stages substitute
    u_j = E_j th. Returns the theta-quadratic at the root (0.5 th'S th + s'th,
    both including x0's contribution) plus the per-stage gains for the free
    stages (K over [x; th]).

    This is the O(N) stage-structured consensus solve: the cross-particle
    consensus reduction is just a SUM of (S, s) over particles — a psum when
    particles are sharded over a mesh axis.
    """
    N, xdim = c.shape
    udim = B.shape[-1]
    nc = Nc * udim
    dtype = c.dtype
    na = xdim + nc

    # selector of theta block j: u_j = E_j theta for j < Nc
    def E(j):
        out = jnp.zeros((udim, nc), dtype)
        return lax.dynamic_update_slice(out, jnp.eye(udim, dtype=dtype), (0, j * udim))

    Es = jnp.stack([E(j) if Nc else jnp.zeros((udim, 0), dtype) for j in range(N)]) \
        if Nc else jnp.zeros((N, udim, 0), dtype)
    free = jnp.arange(N) >= Nc  # (N,) static-shaped mask

    def backward(carry, inp):
        P, p = carry  # quadratic over [x_j; theta] (value of stages j+1..)
        c_j, A_j, B_j, Qt_j, xt_j, Rt_j, ut_j, E_j, is_free = inp
        w = jnp.where(is_free, 1.0, 0.0)
        # augmented dynamics: [x_j; th] = Aa [x_{j-1}; th] + Ba u_j + ca
        Aa = jnp.zeros((na, na), dtype)
        Aa = Aa.at[:xdim, :xdim].set(A_j)
        Aa = Aa.at[xdim:, xdim:].set(jnp.eye(nc, dtype=dtype))
        # consensus stages route their control through theta
        Aa = Aa.at[:xdim, xdim:].add((1.0 - w) * (B_j @ E_j))
        Ba = jnp.concatenate([B_j, jnp.zeros((nc, udim), dtype)], axis=0)
        ca = jnp.concatenate([c_j, jnp.zeros((nc,), dtype)], axis=0)

        # fold stage j's costs into the next-state value: the state cost is on
        # x_j (the post-step state), and theta passes through unchanged so the
        # consensus-stage control cost lands exactly on the theta block
        Ru_th = E_j.T @ Rt_j @ E_j
        Mn = P.at[:xdim, :xdim].add(Qt_j)
        Mn = Mn.at[xdim:, xdim:].add((1.0 - w) * Ru_th)
        mn = p.at[:xdim].add(-xt_j)
        mn = mn.at[xdim:].add((1.0 - w) * (-(E_j.T @ ut_j)))

        # substitute [x_j; th] = Aa y + Ba u + ca  (y = [x_{j-1}; th])
        MA = Mn @ Aa
        MB = Mn @ Ba
        Mc_m = Mn @ ca + mn
        Pyy = Aa.T @ MA
        py = Aa.T @ Mc_m
        Huu = Rt_j + Ba.T @ MB
        Huy = Ba.T @ MA
        hu = -ut_j + Ba.T @ Mc_m

        # free stage: eliminate u; consensus stage: u ignored (B routed via E)
        rhs = jnp.concatenate([Huy, hu[:, None]], axis=1)
        sol = psd_solve(Huu, rhs)
        K_j = -sol[:, :na]
        k_j = -sol[:, na]
        P_elim = Pyy + Huy.T @ K_j
        p_elim = py + Huy.T @ k_j
        P_new = w * P_elim + (1.0 - w) * Pyy
        P_new = 0.5 * (P_new + P_new.T)
        p_new = w * p_elim + (1.0 - w) * py
        K_j = w * K_j
        k_j = w * k_j
        return (P_new, p_new), (K_j, k_j)

    init = (jnp.zeros((na, na), dtype), jnp.zeros((na,), dtype))
    (P0, p0), (K, k) = lax.scan(
        backward, init, (c, A, B, Qt, xt, Rt, ut, Es, free), reverse=True)

    # root: V(x0, th) -> quadratic in theta
    S = P0[xdim:, xdim:]
    s = p0[xdim:] + P0[xdim:, :xdim] @ x0
    return S, s, (K, k, Es, free)


def _theta_forward(x0, c, A, B, theta, gains):
    """Roll out one particle given theta and the free-stage gains."""
    K, k, Es, free = gains
    xdim = x0.shape[0]

    def fwd(x, inp):
        c_j, A_j, B_j, K_j, k_j, E_j, is_free = inp
        y = jnp.concatenate([x, theta])
        u_free = K_j @ y + k_j
        u_cons = E_j @ theta
        u = jnp.where(is_free, u_free, u_cons)
        x_next = c_j + A_j @ x + B_j @ u
        return x_next, (x_next, u)

    _, (X, U) = lax.scan(fwd, x0, (c, A, B, K, k, Es, free))
    return X, U


@partial(jax.jit, static_argnames=("Nc",))
@with_matmul_precision("highest")
def riccati_consensus_solve(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                            reg_x, reg_u, Nc: int,
                            slew_reg=None, slew_reg0=None, slew_um1=None):
    """O(N) consensus solve of the joint M-particle SCP subproblem (eq-only).

    All inputs batched over the leading particle axis M. The consensus system
    over theta (the shared first-Nc controls) is the SUM over particles of the
    per-particle theta-quadratics — the Schur complement of the arrow system,
    computed without ever materializing the O(N^2) condensed ``Ft``.
    Slew coupling (optional (M,) ``slew_reg``/``slew_reg0`` + (M, udim)
    ``slew_um1``) is handled by `augment_slew_stages` state augmentation.
    Returns (X (M,N,xdim), U (M,N,udim)).
    """
    xdim = x0.shape[-1]
    c, Qt, xt, Rt, ut = jax.vmap(
        lambda x0_, f_, fx_, fu_, Xp, Up, Q_, R_, Xr, Ur, rx, ru:
        _scp_stage_terms(x0_, f_, fx_, fu_, Xp, Up, Q_, R_, Xr, Ur, rx, ru)
    )(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref, reg_x, reg_u)
    A, B = fx, fu
    x0s = x0
    if slew_reg is not None:
        x0s, c, A, B, Qt, xt = jax.vmap(augment_slew_stages)(
            x0, c, A, B, Qt, xt, slew_reg, slew_reg0, slew_um1)

    S, s, gains = jax.vmap(partial(_theta_backward, Nc=Nc))(
        x0s, c, A, B, Qt, xt, Rt, ut)
    # consensus reduction: sum the theta-quadratics over particles
    S_tot = jnp.sum(S, axis=0)
    s_tot = jnp.sum(s, axis=0)
    theta = -psd_solve(S_tot, s_tot) if S_tot.shape[-1] else s_tot

    X, U = jax.vmap(lambda x0_, c_, A_, B_, g: _theta_forward(x0_, c_, A_, B_, theta, g)
                    )(x0s, c, A, B, gains)
    return X[..., :xdim], U
