"""Parallel-in-time (associative-scan) Riccati sweeps: O(log N) depth LQR.

`riccati.py` solves the stage-structured SCP subproblem with sequential
`lax.scan` sweeps — O(N) tiny matmuls whose latency chain dominates at long
horizons. This module solves the SAME problems with
`lax.associative_scan`: the backward value recursion is re-expressed as a
suffix product of *conditional value function* elements, giving O(log N)
combine depth with batched (all-stages-at-once) dense work. This is the parallel-in-time ("context/sequence parallel")
analog the SURVEY's long-context note calls optional — the reference keeps
the horizon sparse-sequential (block-bidiagonal chains handed to CPU solvers,
``PMPC.jl/src/lqp_utils.jl:219-303``).

Formulation (temporal parallelization of dynamic programming / parallel LQT):
the conditional cost of steering y_{j-1} -> y_j through stage j,

    g_j(y, z) = dep_j(y) + min_u { 1/2 u'R u - r'u :  z = Aa y + Ba u + ca },

is represented in the dual form

    g(y, z) = max_l [ l'(z - A y - b) - 1/2 l'C l ] + 1/2 y'J y - eta'y,

an element e = (A, b, C, eta, J) with C = Ba R^{-1} Ba' (C = 0 when the stage
has no free control). Elements compose associatively under

    (e_i (*) e_j)(y, z) = min_w e_i(y, w) + e_j(w, z):
        T   = I + C_i J_j
        A   = A_j T^{-1} A_i
        b   = A_j T^{-1} (b_i + C_i eta_j) + b_j
        C   = A_j T^{-1} C_i A_j' + C_j
        eta = A_i' (I + J_j C_i)^{-1} (eta_j - J_j b_i) + eta_i
        J   = A_i' (I + J_j C_i)^{-1} J_j A_i + J_i

and the suffix products s_j = e_j (*) ... (*) e_T give every value-to-go
directly: V(y_j) = min_z s_{j+1}(y_j, z) = 1/2 y'J y - eta'y (the max over l
with z free forces l = 0). A reverse `associative_scan` therefore yields all
stage value functions in O(log N) combine depth; gain extraction and the
forward (affine prefix-scan) rollout are then embarrassingly stage-parallel.

Stage costs land on the ARRIVAL state in `riccati.py`'s convention, so
element j carries the arrival cost of stage j-1 as its departure quadratic
(J, eta) and one extra terminal element carries stage N-1's arrival cost.

Consensus (shared first-Nc controls) uses the same theta-augmented dynamics
as `riccati._theta_backward` — y = [x; theta] — so the root suffix quadratic
restricted to the theta block IS the per-particle consensus Schur complement
(S, s), summed across particles exactly as in the sequential path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.linalg import psd_solve
from ..utils import with_matmul_precision
from .riccati import LQRSolution, _scp_stage_terms


def _combine(ei, ej):
    """Associative combination of value-function elements (earlier, later).

    Batched over arbitrary leading axes; the two linear solves share the
    (non-symmetric but always-invertible) matrix T = I + C_i J_j and its
    transpose I + J_j C_i.
    """
    A_i, b_i, C_i, eta_i, J_i = ei
    A_j, b_j, C_j, eta_j, J_j = ej
    na = A_i.shape[-1]
    eye = jnp.eye(na, dtype=A_i.dtype)
    T = eye + C_i @ J_j
    # one batched solve against [A_i | b_i + C_i eta_j | C_i]
    rhs = jnp.concatenate(
        [A_i, (b_i + (C_i @ eta_j[..., None])[..., 0])[..., None], C_i], axis=-1)
    sol = jnp.linalg.solve(T, rhs)
    TA, Tb, TC = sol[..., :na], sol[..., na], sol[..., na + 1:]
    A = A_j @ TA
    b = (A_j @ Tb[..., None])[..., 0] + b_j
    C = A_j @ TC @ jnp.swapaxes(A_j, -1, -2) + C_j
    C = 0.5 * (C + jnp.swapaxes(C, -1, -2))
    # transpose system: (I + J_j C_i)^{-1} [eta_j - J_j b_i | J_j A_i]
    rhs2 = jnp.concatenate(
        [(eta_j - (J_j @ b_i[..., None])[..., 0])[..., None], J_j @ A_i], axis=-1)
    sol2 = jnp.linalg.solve(jnp.swapaxes(T, -1, -2), rhs2)
    AiT = jnp.swapaxes(A_i, -1, -2)
    eta = (AiT @ sol2[..., 0][..., None])[..., 0] + eta_i
    J = AiT @ sol2[..., 1:] + J_i
    J = 0.5 * (J + jnp.swapaxes(J, -1, -2))
    return A, b, C, eta, J


def _affine_combine(ei, ej):
    """Prefix composition of affine maps x -> F x + d (earlier, later)."""
    F_i, d_i = ei
    F_j, d_j = ej
    return F_j @ F_i, (F_j @ d_i[..., None])[..., 0] + d_j


def affine_scan_rollout(F, d, x0):
    """x_j for x_j = F_j x_{j-1} + d_j, x_0 given — O(log N) prefix scan."""
    Fc, dc = lax.associative_scan(_affine_combine, (F, d))
    return (Fc @ x0[..., None])[..., 0] + dc


def _theta_parallel_value(x0, c, A, B, Qt, xt, Rt, ut, Nc: int):
    """Suffix value functions of one theta-augmented particle, in parallel.

    Returns (S, s, aux) where (S, s) is the root theta-quadratic (consensus
    Schur complement, parity with `riccati._theta_backward`) and ``aux``
    carries everything gain extraction and the rollout need.
    """
    N, xdim = c.shape
    udim = B.shape[-1]
    dtype = c.dtype
    nc = Nc * udim
    nct = max(nc, 1)  # dummy-padded theta block when Nc == 0
    na = xdim + nct

    # stage selectors / masks
    if Nc:
        eye_nc = jnp.eye(nc, dtype=dtype).reshape(Nc, udim, nc)
        Es = jnp.concatenate(
            [eye_nc, jnp.zeros((N - Nc, udim, nc), dtype)], axis=0)
        if nct > nc:
            Es = jnp.concatenate([Es, jnp.zeros((N, udim, nct - nc), dtype)], -1)
    else:
        Es = jnp.zeros((N, udim, nct), dtype)
    w = (jnp.arange(N) >= Nc).astype(dtype)[:, None, None]  # free-stage mask
    maskc = (jnp.arange(nct) < nc).astype(dtype)

    # augmented per-stage data (batched over j)
    Aa = jnp.zeros((N, na, na), dtype)
    Aa = Aa.at[:, :xdim, :xdim].set(A)
    Aa = Aa.at[:, xdim:, xdim:].set(jnp.eye(nct, dtype=dtype))
    Aa = Aa.at[:, :xdim, xdim:].add((1.0 - w) * (B @ Es))
    ca = jnp.concatenate([c, jnp.zeros((N, nct), dtype)], axis=-1)
    EtRE = jnp.swapaxes(Es, -1, -2) @ Rt @ Es
    Ma = jnp.zeros((N, na, na), dtype)
    Ma = Ma.at[:, :xdim, :xdim].set(Qt)
    Ma = Ma.at[:, xdim:, xdim:].add((1.0 - w) * EtRE)
    ma = jnp.concatenate(
        [xt, (1.0 - w[:, :, 0]) * (jnp.swapaxes(Es, -1, -2) @ ut[..., None])[..., 0]],
        axis=-1)

    # elements: free-stage control eliminated through C = Ba R^{-1} Ba'
    Rinv_Bt = psd_solve(Rt, jnp.swapaxes(B, -1, -2))  # (N, udim, xdim)
    BRB = B @ Rinv_Bt                                  # (N, xdim, xdim)
    C_e = jnp.zeros((N, na, na), dtype).at[:, :xdim, :xdim].set(w * BRB)
    Rinv_ut = psd_solve(Rt, ut[..., None])[..., 0]
    b_e = ca.at[:, :xdim].add(w[:, :, 0] * (B @ Rinv_ut[..., None])[..., 0])
    zero_q = jnp.zeros((1, na, na), dtype)
    zero_l = jnp.zeros((1, na), dtype)
    J_e = jnp.concatenate([zero_q, Ma], axis=0)    # dep cost of elem j = arrival j-1
    eta_e = jnp.concatenate([zero_l, ma], axis=0)
    A_e = jnp.concatenate([Aa, jnp.zeros((1, na, na), dtype)], axis=0)
    b_e = jnp.concatenate([b_e, zero_l], axis=0)
    C_e = jnp.concatenate([C_e, zero_q], axis=0)

    # reverse=True hands fn the LATER aggregate as its first argument; swap so
    # suffixes compose as e_j (*) e_{j+1} (*) ... (earlier-first)
    suf = lax.associative_scan(lambda a, b: _combine(b, a),
                               (A_e, b_e, C_e, eta_e, J_e), reverse=True)
    _, _, _, eta_s, J_s = suf

    # value-to-go AFTER arriving at y_j (stage-j arrival cost included)
    P = J_s[1:]            # (N, na, na)
    p = -eta_s[1:]         # (N, na)
    # root quadratic over y0 = [x0; theta]
    J0, eta0 = J_s[0], eta_s[0]
    S = J0[xdim:, xdim:]
    s = -eta0[xdim:] + J0[xdim:, :xdim] @ x0

    # gains of the free stages (batched over j; consensus stages masked to 0)
    BtP = jnp.swapaxes(B, -1, -2) @ P[:, :xdim, :]     # (N, udim, na)
    Hu = Rt + BtP[:, :, :xdim] @ B
    rhs = jnp.concatenate(
        [BtP @ Aa,
         ((BtP @ ca[..., None])[..., 0]
          + (jnp.swapaxes(B, -1, -2) @ p[:, :xdim, None])[..., 0] - ut)[..., None]],
        axis=-1)
    sol = psd_solve(Hu, rhs)
    K = -w * sol[:, :, :na]
    k = -w[:, :, 0] * sol[:, :, na]
    aux = dict(K=K, k=k, Es=Es, w=w, maskc=maskc, Aa=Aa, ca=ca)
    return S, s, aux


def _theta_parallel_forward(x0, c, A, B, theta, aux):
    """Parallel rollout given theta: affine prefix scan in the x block."""
    K, k, Es, w = aux["K"], aux["k"], aux["Es"], aux["w"]
    xdim = x0.shape[0]
    # u_j = w (Kx x_{j-1} + Kth theta + k) + (1-w) E theta
    Kx = K[:, :, :xdim]
    u_aff = (K[:, :, xdim:] @ theta[None, :, None])[..., 0] + k
    u_aff = u_aff + ((1.0 - w[:, :, 0]) * (Es @ theta[None, :, None])[..., 0])
    F = A + w * (B @ Kx)
    d = c + (B @ u_aff[..., None])[..., 0]
    X = affine_scan_rollout(F, d, x0)
    Xm1 = jnp.concatenate([x0[None], X[:-1]], axis=0)
    U = w[:, :, 0] * ((Kx @ Xm1[..., None])[..., 0]) + u_aff
    return X, U


@partial(jax.jit, static_argnames=("Nc",))
@with_matmul_precision("highest")
def priccati_consensus_solve(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                             reg_x, reg_u, Nc: int):
    """Parallel-in-time twin of `riccati.riccati_consensus_solve`: O(log N)
    depth consensus solve of the joint M-particle eq-only SCP subproblem.
    Returns (X (M,N,xdim), U (M,N,udim))."""
    c, Qt, xt, Rt, ut = jax.vmap(_scp_stage_terms)(
        x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref, reg_x, reg_u)
    S, s, aux = jax.vmap(partial(_theta_parallel_value, Nc=Nc))(
        x0, c, fx, fu, Qt, xt, Rt, ut)
    maskc = aux["maskc"][0]
    nct = S.shape[-1]
    eye = jnp.eye(nct, dtype=S.dtype)
    S_tot = jnp.sum(S, axis=0) * maskc[:, None] * maskc[None, :] \
        + (1.0 - maskc) * eye
    s_tot = jnp.sum(s, axis=0) * maskc
    theta = -psd_solve(S_tot, s_tot)
    X, U = jax.vmap(
        lambda x0_, c_, A_, B_, K_, k_, E_, w_: _theta_parallel_forward(
            x0_, c_, A_, B_, theta, dict(K=K_, k=k_, Es=E_, w=w_))
    )(x0, c, fx, fu, aux["K"], aux["k"], aux["Es"], aux["w"])
    return X, U


@jax.jit
@with_matmul_precision("highest")
def priccati_solve(x0, c, A, B, Qt, xt, Rt, ut) -> LQRSolution:
    """Parallel-in-time twin of `riccati.riccati_solve` (single particle,
    same stage-cost convention and outputs, O(log N) combine depth)."""
    _, _, aux = _theta_parallel_value(x0, c, A, B, Qt, xt, Rt, ut, Nc=0)
    theta = jnp.zeros((aux["Es"].shape[-1],), c.dtype)
    X, U = _theta_parallel_forward(x0, c, A, B, theta, aux)
    xdim = x0.shape[0]
    return LQRSolution(X=X, U=U, K=aux["K"][:, :, :xdim], k=aux["k"])


def priccati_solve_scp(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                       reg_x, reg_u) -> LQRSolution:
    """Parallel twin of `riccati.riccati_solve_scp`."""
    c, Qt, xt, Rt, ut = _scp_stage_terms(x0, f, fx, fu, X_prev, U_prev,
                                         Q, R, X_ref, U_ref, reg_x, reg_u)
    return priccati_solve(x0, c, fx, fu, Qt, xt, Rt, ut)
