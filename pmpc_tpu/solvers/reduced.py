"""Condensed consensus QP: assembly and the equality-only (unconstrained) solve.

This is the on-device replacement for the reference's sparse canonical-form
assembly (``PMPC.jl/src/lqp_utils.jl:2-424``). Instead of one big sparse matrix
handed to a CPU solver, states are eliminated through the condensed dynamics map
``vec(X_i) = Ft_i @ vec(U_i - U_prev_i) + ft_i`` so the joint decision variable
is only the controls with the consensus layout

    z = [ u_cons (Nc*udim) ; u_free_1 ((N-Nc)*udim) ; ... ; u_free_M ]

(same variable-layout contract as ``lqp_utils.jl:2-216`` / ``README.md:232-239``).
The Hessian then has ARROW structure: a shared consensus block coupled to M
independent per-particle free blocks — solved by batched dense Cholesky of the
per-particle blocks plus a Schur complement on the consensus block. Everything
is matmul-shaped and vmaps over particles and scenario batches.

Cost semantics match ``lqp_repr_Pq`` (``lqp_utils.jl:2-216``): per particle i,
stage j,

    0.5 (x-X_ref)'Q(x-X_ref) + 0.5 (u-U_ref)'R(u-U_ref)
  + 0.5 reg_x ||x - X_prev||^2 + 0.5 reg_u ||u - U_prev||^2
  + 0.5 slew_reg sum_j ||u_{j+1}-u_j||^2 + 0.5 slew_reg0 ||u_0 - slew_um1||^2

summed over particles, with the first Nc controls shared.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..dynamics import condense
from ..ops.linalg import spd_apply, spd_factor, spd_factor_diag
from ..utils import with_matmul_precision


class CondensedQP(NamedTuple):
    """A single joint (M-particle) condensed QP. Shapes: nc=Nc*udim, nf=(N-Nc)*udim,
    NU=N*udim, NX=N*xdim.

    The factored pieces (Qt/Rt/slew) are kept alongside the explicit Hessian
    blocks: the explicit H has condition ~kappa(Ft)^2, so float32 residuals
    computed as H w + q carry O(kappa^2 eps) error, while the factored form
    Ft'(Qt(Ft w)) + Rt w + slew terms stays at O(kappa eps) — inexact-Newton
    steps with factored residuals converge to the accurate solution."""

    Hcc: jax.Array  # (nc, nc)   consensus block (summed over particles)
    Hcf: jax.Array  # (M, nc, nf) consensus-to-free coupling
    Hff: jax.Array  # (M, nf, nf) per-particle free blocks
    qc: jax.Array  # (nc,)
    qf: jax.Array  # (M, nf)
    Ft: jax.Array  # (M, NX, NU) condensed dynamics sensitivity
    g: jax.Array  # (M, NX)     x = Ft @ w + g  (w = vec(U))
    w_prev: jax.Array  # (M, NU)
    Qt: Optional[jax.Array] = None  # (M, N, xdim, xdim) state Hessian blocks
    Rt: Optional[jax.Array] = None  # (M, N, udim, udim) control Hessian blocks
    sl_reg: Optional[jax.Array] = None  # (M,) slew coupling weight
    sl_reg0: Optional[jax.Array] = None  # (M,) first-control slew weight

    @property
    def M(self) -> int:
        return self.Hff.shape[0]

    @property
    def nc(self) -> int:
        return self.Hcc.shape[-1]

    @property
    def nf(self) -> int:
        return self.Hff.shape[-1]


def _slew_T(N: int, dtype) -> jnp.ndarray:
    """Time-coupling matrix of sum_{j<N-1} ||u_{j+1} - u_j||^2 (without udim kron)."""
    T = 2.0 * jnp.eye(N, dtype=dtype)
    off = jnp.eye(N, k=1, dtype=dtype) + jnp.eye(N, k=-1, dtype=dtype)
    T = T - off
    T = T.at[0, 0].add(-1.0).at[N - 1, N - 1].add(-1.0)
    return T


def _block_diag(Bs: jnp.ndarray) -> jnp.ndarray:
    """(N, d, d) -> (N*d, N*d) block-diagonal embedding.

    Built by broadcast-masking, not scatter: one elementwise product."""
    N, d = Bs.shape[0], Bs.shape[-1]
    onehot = jnp.eye(N, dtype=Bs.dtype)
    out = onehot[:, None, :, None] * Bs[:, :, None, :]
    return out.reshape(N * d, N * d)


def _bdiag_mm(Qs: jnp.ndarray, Ft: jnp.ndarray) -> jnp.ndarray:
    """blockdiag(Qs) @ Ft without materializing the block diagonal.

    Qs: (N, d, d); Ft: (N*d, K) -> (N*d, K)."""
    N, d = Qs.shape[0], Qs.shape[-1]
    return jnp.einsum("nij,njk->nik", Qs, Ft.reshape(N, d, -1)).reshape(N * d, -1)


def particle_H_q(
    x0,
    f,
    fx,
    fu,
    X_prev,
    U_prev,
    Q,
    R,
    X_ref,
    U_ref,
    reg_x,
    reg_u,
    slew_reg,
    slew_reg0,
    slew_um1,
):
    """Reduced Hessian/linear term per particle over w = vec(U) (NU = N*udim).

    Accepts arbitrary leading batch dims (f: (..., N, xdim), reg_x: (...),
    slew_um1: (..., udim)): the whole chain is ellipsis-batched einsums, so
    callers with explicit particle/scenario axes get direct batched HLO
    instead of the vmap batching transform (the per-particle ``.at[].add``
    copies and per-particle ``kron`` are replaced by constant masks).

    Returns (H (..., NU, NU), q (..., NU), Ft, g) with x = Ft @ w + g."""
    N, xdim = f.shape[-2:]
    udim = fu.shape[-1]
    batch = f.shape[:-2]
    dtype = f.dtype
    NU = N * udim
    Ft, ft = condense(x0, f, fx, fu, X_prev, U_prev)
    w_prev = U_prev.reshape(batch + (NU,))
    g = ft - jnp.einsum("...ij,...j->...i", Ft, w_prev)

    eye_x = jnp.eye(xdim, dtype=dtype)
    eye_u = jnp.eye(udim, dtype=dtype)
    ex = lambda a: a[..., None, None, None]  # (...,) -> broadcast over (N,d,d)
    Qt = Q + ex(reg_x) * eye_x  # (..., N, xdim, xdim)
    Rt = R + ex(reg_u) * eye_u
    xt = (jnp.einsum("...nij,...nj->...ni", Q, X_ref)
          + reg_x[..., None, None] * X_prev).reshape(batch + (-1,))  # (..., NX)
    ut = (jnp.einsum("...nij,...nj->...ni", R, U_ref)
          + reg_u[..., None, None] * U_prev).reshape(batch + (-1,))  # (..., NU)

    Ft_r = Ft.reshape(batch + (N, xdim, NU))
    QtFt = jnp.einsum("...nij,...njk->...nik", Qt, Ft_r) \
        .reshape(batch + (N * xdim, NU))
    H = jnp.einsum("...ji,...jk->...ik", Ft, QtFt)
    # blockdiag(Rt) by broadcast-masking (scatter-free, batch-agnostic)
    onehot = jnp.eye(N, dtype=dtype)
    D = onehot[:, None, :, None] * Rt[..., :, :, None, :]
    H = H + D.reshape(batch + (NU, NU))
    S = jnp.kron(_slew_T(N, dtype), eye_u)  # constant (NU, NU)
    E00 = jnp.zeros((NU, NU), dtype).at[:udim, :udim].set(eye_u)  # constant
    H = H + slew_reg[..., None, None] * S + slew_reg0[..., None, None] * E00

    Qg = jnp.einsum("...nij,...nj->...ni", Qt,
                    g.reshape(batch + (N, xdim))).reshape(batch + (-1,))
    q = jnp.einsum("...ji,...j->...i", Ft, Qg - xt) - ut
    um1_pad = jnp.concatenate(
        [slew_um1, jnp.zeros(batch + (NU - udim,), dtype)], axis=-1)
    q = q - slew_reg0[..., None] * um1_pad
    return H, q, Ft, g


@partial(jax.jit, static_argnames=("Nc", "scale_slew_target"))
@with_matmul_precision("highest")
def assemble_condensed(
    x0,
    f,
    fx,
    fu,
    X_prev,
    U_prev,
    Q,
    R,
    X_ref,
    U_ref,
    reg_x,
    reg_u,
    slew_reg,
    slew_reg0,
    slew_um1,
    Nc: int,
    weights: Optional[jax.Array] = None,
    scale_slew_target: bool = True,
) -> CondensedQP:
    """Assemble the joint M-particle condensed QP with consensus horizon ``Nc``.

    Array args are batched over the leading particle axis M (x0: (M,xdim),
    f: (M,N,xdim), ..., reg_x/reg_u/slew_reg/slew_reg0: (M,), slew_um1: (M,udim)).
    ``weights`` (optional, (M,)) rescales per-particle costs like
    ``PMPC.jl/src/main.jl:96-112`` (normalized to sum to 1).

    ``scale_slew_target``: the reference scales the slew ANCHOR ``slew_um1`` by
    the weight as well (``main.jl:107``), which moves the anchor point, not
    just the penalty weight. That is reproduced by default for drop-in parity;
    pass False (``solver_settings["weights_scale_slew_target"]=False``) for the
    arguably-intended semantics that scale only the penalty.
    """
    M, N = f.shape[0], f.shape[1]
    udim = fu.shape[-1]
    if weights is not None:
        w = weights / jnp.sum(weights)
        wq = w[:, None, None, None]
        Q, R = Q * wq, R * wq
        reg_x, reg_u = reg_x * w, reg_u * w
        slew_reg, slew_reg0 = slew_reg * w, slew_reg0 * w
        if scale_slew_target:
            slew_um1 = slew_um1 * w[:, None]

    # particle_H_q is batch-dim-agnostic: the M axis rides the ellipsis
    # einsums directly (no vmap batching transform)
    H, q, Ft, g = particle_H_q(
        x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
        reg_x, reg_u, slew_reg, slew_reg0, slew_um1,
    )
    nc = Nc * udim
    Hcc = jnp.sum(H[:, :nc, :nc], axis=0)
    Hcf = H[:, :nc, nc:]
    Hff = H[:, nc:, nc:]
    qc = jnp.sum(q[:, :nc], axis=0)
    qf = q[:, nc:]
    w_prev = U_prev.reshape(M, -1)
    xdim = f.shape[-1]
    eye_x = jnp.eye(xdim, dtype=f.dtype)
    eye_u = jnp.eye(udim, dtype=f.dtype)
    Qt = Q + reg_x[:, None, None, None] * eye_x
    Rt = R + reg_u[:, None, None, None] * eye_u
    return CondensedQP(Hcc, Hcf, Hff, qc, qf, Ft, g, w_prev,
                       Qt=Qt, Rt=Rt, sl_reg=slew_reg, sl_reg0=slew_reg0)


def H_apply_factored(cqp: CondensedQP, uc: jax.Array, uf: jax.Array):
    """(H z)_c, (H z)_f computed in FACTORED form: Ft'(Qt(Ft w)) + Rt w + slew.

    Error O(kappa(Ft) eps) instead of O(kappa(Ft)^2 eps) for the explicit-H
    product — the float32 accuracy backbone (see CondensedQP docstring)."""
    M, nc = cqp.M, cqp.nc
    N = cqp.Qt.shape[1]
    xdim = cqp.Qt.shape[-1]
    udim = cqp.Rt.shape[-1]
    w = jnp.concatenate([jnp.broadcast_to(uc, (M, nc)), uf], axis=-1)  # (M, NU)
    Ftw = jnp.einsum("mij,mj->mi", cqp.Ft, w)  # (M, NX)
    QFtw = jnp.einsum("mnij,mnj->mni", cqp.Qt, Ftw.reshape(M, N, xdim)).reshape(M, -1)
    Hw = jnp.einsum("mji,mj->mi", cqp.Ft, QFtw)  # (M, NU)
    U = w.reshape(M, N, udim)
    Hw = Hw + jnp.einsum("mnij,mnj->mni", cqp.Rt, U).reshape(M, -1)
    # slew coupling: sl_reg * (T kron I) w + sl_reg0 on the first block
    d = U[:, 1:] - U[:, :-1]  # (M, N-1, udim)
    Sw = jnp.zeros_like(U)
    Sw = Sw.at[:, :-1].add(-d).at[:, 1:].add(d)
    Hw = Hw + cqp.sl_reg[:, None] * Sw.reshape(M, -1)
    Hw = Hw.at[:, :udim].add(cqp.sl_reg0[:, None] * U[:, 0])
    Hw_c = jnp.sum(Hw[:, :nc], axis=0)
    Hw_f = Hw[:, nc:]
    return Hw_c, Hw_f


class ArrowFactors(NamedTuple):
    """Cached factorization of the arrow-structured SPD system."""

    Lff: jax.Array  # (M, nf, nf) Cholesky of per-particle blocks
    W: jax.Array  # (M, nf, nc)  Hff^{-1} Hcf'
    LS: jax.Array  # (nc, nc)    Cholesky of the consensus Schur complement
    Hcf: jax.Array  # (M, nc, nf) kept for rhs reduction


def arrow_factor(Hcc, Hcf, Hff, jitter: float = 0.0) -> ArrowFactors:
    """Factor the arrow system (batched per-particle SPD factor + consensus
    Schur), both through `ops.linalg.spd_factor`."""
    nc, nf = Hcc.shape[-1], Hff.shape[-1]
    if nf == 0:
        LS = spd_factor(Hcc, jitter=jitter) if nc > 0 else Hcc
        return ArrowFactors(Hff, jnp.zeros_like(Hcf), LS, Hcf)
    Lff = spd_factor(Hff, jitter=jitter)  # (M, nf, nf)
    if nc == 0:
        return ArrowFactors(Lff, jnp.zeros_like(jnp.swapaxes(Hcf, -1, -2)), Hcc, Hcf)
    W = spd_apply(Lff, jnp.swapaxes(Hcf, -1, -2))  # (M, nf, nc)
    S = Hcc - jnp.einsum("mij,mjk->ik", Hcf, W)
    LS = spd_factor(S, jitter=jitter)
    return ArrowFactors(Lff, W, LS, Hcf)


def arrow_factor_diag(Hcc, Hcf, Hff, wc, wf, jitter: float = 0.0) -> ArrowFactors:
    """`arrow_factor` of the box-IPM Newton system K = H + diag([wc; wf]):
    the barrier weights only touch the block diagonals (Kcf = Hcf), so the
    loop-invariant H blocks are passed through to a diag-adding factor
    (`spd_factor_diag`) and never re-materialize per iteration."""
    nc, nf = Hcc.shape[-1], Hff.shape[-1]
    Kcc = Hcc + jnp.diag(wc) if nc > 0 else Hcc
    if nf == 0:
        LS = spd_factor(Kcc, jitter=jitter) if nc > 0 else Kcc
        return ArrowFactors(Hff, jnp.zeros_like(Hcf), LS, Hcf)
    Lff = spd_factor_diag(Hff, wf, jitter=jitter)  # (M, nf, nf)
    if nc == 0:
        return ArrowFactors(Lff, jnp.zeros_like(jnp.swapaxes(Hcf, -1, -2)), Hcc, Hcf)
    W = spd_apply(Lff, jnp.swapaxes(Hcf, -1, -2))  # (M, nf, nc)
    S = Kcc - jnp.einsum("mij,mjk->ik", Hcf, W)
    LS = spd_factor(S, jitter=jitter)
    return ArrowFactors(Lff, W, LS, Hcf)


def arrow_apply(F: ArrowFactors, bc, bf):
    """Solve the factored arrow system for rhs ([bc; bf]); returns (uc, uf) with
        K [uc; uf] = [bc; bf]."""
    nc, nf = F.LS.shape[-1] if F.LS.ndim == 2 else 0, F.Lff.shape[-1]
    if nf == 0:
        uc = spd_apply(F.LS, bc) if nc > 0 else bc
        return uc, bf
    if nc == 0:
        return bc, spd_apply(F.Lff, bf)
    y = spd_apply(F.Lff, bf)  # (M, nf)
    rhs = bc - jnp.einsum("mij,mj->i", F.Hcf, y)
    uc = spd_apply(F.LS, rhs)
    uf = y - jnp.einsum("mij,j->mi", F.W, uc)
    return uc, uf


def solve_arrow(Hcc, Hcf, Hff, qc, qf, jitter: float = 0.0):
    """Solve the arrow-structured SPD system

        [ Hcc  Hcf_1 ... Hcf_M ] [uc  ]   [ -qc  ]
        [ Hcf_1'  Hff_1        ] [uf_1] = [ -qf_1]
        [  ...        ...      ] [ ...]   [  ... ]

    via batched per-particle Cholesky + Schur complement on the consensus block.
    Returns (uc (nc,), uf (M, nf)).
    """
    F = arrow_factor(Hcc, Hcf, Hff, jitter=jitter)
    return arrow_apply(F, -qc, -qf)


@partial(jax.jit, static_argnames=("refine",))
@with_matmul_precision("highest")
def solve_eq(cqp: CondensedQP, refine: int = 2):
    """Solve the unconstrained condensed QP. Returns (uc, uf).

    ``refine`` rounds of iterative refinement with FACTORED-form residuals
    recover O(kappa(Ft) eps) accuracy from the O(kappa^2 eps) explicit-H
    factorization (essential in float32)."""
    F = arrow_factor(cqp.Hcc, cqp.Hcf, cqp.Hff)
    uc, uf = arrow_apply(F, -cqp.qc, -cqp.qf)
    if cqp.Qt is not None:
        for _ in range(refine):
            Hc, Hf = H_apply_factored(cqp, uc, uf)
            rc, rf = -(cqp.qc + Hc), -(cqp.qf + Hf)
            duc, duf = arrow_apply(F, rc, rf)
            uc, uf = uc + duc, uf + duf
    return uc, uf


def z_to_w(uc: jax.Array, uf: jax.Array, M: int) -> jax.Array:
    """Per-particle stacked control vectors w_i = [uc; uf_i], shape (M, NU)."""
    return jnp.concatenate([jnp.broadcast_to(uc, (M,) + uc.shape), uf], axis=-1)


@partial(jax.jit, static_argnames=("N",))
@with_matmul_precision("highest")
def recover_XU(cqp: CondensedQP, uc: jax.Array, uf: jax.Array, N: int):
    """Recover (X (M,N,xdim), U (M,N,udim)) from the consensus solution."""
    M = cqp.M
    w = z_to_w(uc, uf, M)  # (M, NU)
    x = jnp.einsum("mij,mj->mi", cqp.Ft, w) + cqp.g  # (M, NX)
    xdim, udim = x.shape[-1] // N, w.shape[-1] // N
    return x.reshape(M, N, xdim), w.reshape(M, N, udim)


def rollout_ft(x0, f, fx, X_prev):
    """The affine-rollout half of `condense`: ft only (O(N) scan on (xdim,)
    carries — the cheap part; the Ft rows scan is the expensive one)."""
    batch = f.shape[:-2]
    N, xdim = f.shape[-2:]
    nb = len(batch)
    xlin = jnp.concatenate([x0[..., None, :], X_prev[..., :-1, :]], axis=-2)
    mv = lambda a: jnp.moveaxis(a, nb, 0) if nb else a

    def step(x, inp):
        f_j, fx_j, xlin_j = inp
        x_next = f_j + jnp.einsum("...ij,...j->...i", fx_j, x - xlin_j)
        return x_next, x_next

    _, xs = jax.lax.scan(step, x0, (mv(f), mv(fx), mv(xlin)))
    return jnp.moveaxis(xs, 0, nb).reshape(batch + (N * xdim,))


def update_condensed_linear(
    cqp: CondensedQP, X_prev, U_prev, Q, R, X_ref, U_ref,
    reg_x, reg_u, slew_reg0, slew_um1,
) -> CondensedQP:
    """Refresh the PROX/REF cost terms (q) of a condensed QP for a new prox
    center, keeping the affine dynamics map (Ft, g) and every Hessian block
    frozen.

    This is the stale-Jacobian SCP sub-iteration's assembly: the affine map
    ``x = Ft w + g`` is anchored at the OLD linearization point and stays
    valid for any w, so a sub-iteration only moves the proximal centers
    (reg_x X_prev / reg_u U_prev in xt/ut) and costs one Ft' matvec chain
    (~0.1 ms at headline shapes vs ~5 ms for the full assembly). At the SCP
    fixed point consecutive iterates coincide, so the stale subproblem
    equals the fresh one and the converged point/step-size test are
    unchanged."""
    M, nc = cqp.M, cqp.nc
    N = cqp.Qt.shape[1]
    xt = (jnp.einsum("...nij,...nj->...ni", Q, X_ref)
          + reg_x[..., None, None] * X_prev).reshape(M, -1)
    ut = (jnp.einsum("...nij,...nj->...ni", R, U_ref)
          + reg_u[..., None, None] * U_prev).reshape(M, -1)
    Qg = jnp.einsum("...nij,...nj->...ni", cqp.Qt,
                    cqp.g.reshape(M, N, -1)).reshape(M, -1)
    q = jnp.einsum("...ji,...j->...i", cqp.Ft, Qg - xt) - ut
    udim = cqp.Rt.shape[-1]
    NU = q.shape[-1]
    um1_pad = jnp.concatenate(
        [slew_um1, jnp.zeros(slew_um1.shape[:-1] + (NU - udim,),
                             slew_um1.dtype)], axis=-1)
    q = q - slew_reg0[..., None] * um1_pad
    qc = jnp.sum(q[:, :nc], axis=0)
    qf = q[:, nc:]
    return cqp._replace(qc=qc, qf=qf)
