"""Stage-structured (Riccati) box-constrained IPM: the O(N) long-horizon path.

The condensed IPM (`ipm.py`) materializes the O(N^2) sensitivity ``Ft`` and
factors (Nf udim)^2 dense blocks per particle — ideal at short horizons. This
module runs the SAME Mehrotra predictor-corrector box IPM but solves every
Newton system with a theta-parameterized Riccati sweep (the `riccati.py`
machinery), never building ``Ft``:

- the QP stays in stage form (states implicit through the dynamics chain),
- box-constraint barrier weights are DIAGONAL in control space, so the IPM
  Newton matrix ``H + G' diag(w) G`` is the same stage-structured Hessian
  with ``diag(w_j)`` added to the free stages' ``Rt_j`` and ``diag(w_c)``
  added to the consensus Schur complement at the root — the Riccati
  factorization absorbs them at no extra cost,
- STATE-box barrier weights are diagonal in state space, so they land on the
  per-stage ``Qt_j`` the same way (``Qt_j + diag(wx_j)``) — the recursion
  propagates them through the dynamics chain, which is exactly the
  ``G' diag(w) G`` term of the condensed formulation without ever forming
  the condensed sensitivity; the state rows' primal values/directions come
  from the forward rollouts the sweeps already do, and their adjoint
  (gradient) contributions ride the same ``jax.grad``-of-rollout used for
  the objective. This is the O(N) route to the reference's state-box rows
  (``PMPC.jl/src/lqp_utils.jl:306-393``), which its sparse CPU solvers
  carry at any N,
- gradients are computed by rollout + adjoint (``jax.grad`` of the stage
  objective), which is the FACTORED form: no condensation-squared
  conditioning loss in f32,
- consensus (shared first-Nc controls) is the per-particle theta-quadratic
  sum of `riccati._theta_backward` — a psum when particles are sharded.

Each IPM iteration costs one quadratic backward sweep (the factorization,
reused by predictor and corrector) + two linear backward/forward sweep pairs
+ one gradient rollout: all O(N) scans of tiny dense ops, vmapped over
particles x scenarios.

Role parity: long-horizon replacement for the reference's sparse CPU
factorizations (block-bidiagonal equality chains handed to ECOS/OSQP,
``PMPC.jl/src/lqp_utils.jl:219-303``); SURVEY §5 long-context note. Slew
coupling enters via `riccati.augment_slew_stages` state augmentation; state
boxes ride the per-stage ``Qt_j`` diagonal; per-stage control-norm cones
put NT blocks on ``Rt_j``/the theta Schur; LINEAR extras border the Newton
system as reduced dense rows (see `riccati_ipm_core`'s ex_* args). Only
SOC/exp/aux extras and squareplus smoothing still need the condensed path
(gated by the dispatcher).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.linalg import cholesky_factor, cholesky_solve
from ..utils import with_matmul_precision
from .riccati import _scp_stage_terms


class RiccatiFactor(NamedTuple):
    """Stored factorization of one stage-structured Newton matrix, batched
    over particles (leading (M, N, ...) axes); ``P0`` is the root value
    quadratic over the augmented variable y0 = [x0; theta]."""

    Aa: jax.Array   # (M, N, na, na) augmented transitions [[A, B E],[0, I]]
    Mn: jax.Array   # (M, N, na, na) cost-to-go + stage cost quadratic
    L: jax.Array    # (M, N, udim, udim) chol(Huu) (garbage on consensus stages)
    K: jax.Array    # (M, N, udim, na) feedback gains (zeroed on consensus stages)
    Huy: jax.Array  # (M, N, udim, na) cross terms (zeroed on consensus stages)
    P0: jax.Array   # (M, na, na)


def _selectors(N: int, Nc: int, udim: int, dtype):
    """Consensus selectors E_j (u_j = E_j theta for j < Nc) and the free-stage
    mask. ``nct = max(nc, 1)``: the theta block is padded to one dummy entry
    when Nc == 0 (zero-sized arrays in while_loop carries hang the remote
    compiler), masked out everywhere."""
    nc = Nc * udim
    nct = max(nc, 1)
    if Nc:
        eye = jnp.eye(nc, dtype=dtype).reshape(Nc, udim, nc)
        Es = jnp.concatenate([eye, jnp.zeros((N - Nc, udim, nc), dtype)], axis=0)
    else:
        Es = jnp.zeros((N, udim, nct), dtype)
    free = (jnp.arange(N) >= Nc).astype(dtype)
    maskc = (jnp.arange(nct) < nc).astype(dtype)  # live theta entries
    return Es, free, nct, maskc


def _factor_one(A, B, Qt, Rt_eff, Es, free, xdim: int, kappa: float,
                unroll: int = 1):
    """Backward quadratic sweep of ONE particle: factor the stage-structured
    Hessian (barrier weights already folded into ``Rt_eff``). RHS-independent,
    reused for every linear solve against this Newton matrix."""
    nct = Es.shape[-1]
    na = xdim + nct
    dtype = A.dtype
    eye_nc = jnp.eye(nct, dtype=dtype)

    def backward(P, inp):
        A_j, B_j, Qt_j, Rt_j, E_j, w = inp
        Aa = jnp.zeros((na, na), dtype)
        Aa = Aa.at[:xdim, :xdim].set(A_j)
        Aa = Aa.at[xdim:, xdim:].set(eye_nc)
        Aa = Aa.at[:xdim, xdim:].add((1.0 - w) * (B_j @ E_j))
        # stage cost on y_j = [x_j; theta]: Qt on x; consensus-stage control
        # cost routed through E onto the theta block
        Mn = P.at[:xdim, :xdim].add(Qt_j)
        Mn = Mn.at[xdim:, xdim:].add((1.0 - w) * (E_j.T @ Rt_j @ E_j))
        MA = Mn @ Aa
        MB = Mn[:, :xdim] @ B_j  # Ba = [B; 0]
        Huu = Rt_j + B_j.T @ MB[:xdim]
        L = cholesky_factor(Huu, jitter=kappa)
        Huy = B_j.T @ MA[:xdim]
        K_j = -cholesky_solve(L, Huy)
        AtMA = Aa.T @ MA
        P_new = AtMA + w * (Huy.T @ K_j)
        P_new = 0.5 * (P_new + P_new.T)
        return P_new, (Aa, Mn, L, w * K_j, w * Huy)

    P0, (Aa, Mn, L, K, Huy) = lax.scan(
        backward, jnp.zeros((na, na), dtype), (A, B, Qt, Rt_eff, Es, free),
        reverse=True, unroll=unroll)
    return Aa, Mn, L, K, Huy, P0


def riccati_factor(A, B, Qt, Rt_eff, Es, free, xdim: int,
                   kappa: float = 0.0, unroll: int = 1) -> RiccatiFactor:
    """Particle-vmapped quadratic backward sweep."""
    out = jax.vmap(
        lambda A_, B_, Q_, R_: _factor_one(A_, B_, Q_, R_, Es, free, xdim,
                                           kappa, unroll=unroll)
    )(A, B, Qt, Rt_eff)
    return RiccatiFactor(*out)


def _lin_backward_one(Aa, Mn, L, Huy, B, c, xt, utf, utc, Es, free,
                      xdim: int, unroll: int = 1):
    """Backward LINEAR sweep of one particle against a stored factor.

    Cost convention (matches `riccati.py`): stage linear terms enter the
    objective as ``- xt_j' x_j - ut_j' u_j``; ``utf`` applies to eliminated
    (free) stage controls, ``utc`` to consensus-stage controls (routed onto
    the theta block). ``c`` is the dynamics offset (zero for Newton solves).
    Returns (p0 (na,), k (N, udim))."""

    def backward(p, inp):
        Aa_j, Mn_j, L_j, Huy_j, B_j, c_j, xt_j, utf_j, utc_j, E_j, w = inp
        mn = p.at[:xdim].add(-xt_j)
        mn = mn.at[xdim:].add(-(1.0 - w) * (E_j.T @ utc_j))
        Mc_m = Mn_j[:, :xdim] @ c_j + mn
        hu = -utf_j + B_j.T @ Mc_m[:xdim]
        k_j = -cholesky_solve(L_j, hu)
        p_new = Aa_j.T @ Mc_m + Huy_j.T @ k_j  # Huy already zeroed on cons stages
        return p_new, w * k_j

    p0, k = lax.scan(
        backward, jnp.zeros((Aa.shape[-1],), Aa.dtype),
        (Aa, Mn, L, Huy, B, c, xt, utf, utc, Es, free), reverse=True,
        unroll=unroll)
    return p0, k


def _forward_one(x0, c, A, B, K, k, Es, free, theta, unroll: int = 1):
    """Forward rollout of one particle given theta and the stage gains."""

    def fwd(x, inp):
        c_j, A_j, B_j, K_j, k_j, E_j, w = inp
        y = jnp.concatenate([x, theta])
        u = (K_j @ y + k_j) + (1.0 - w) * (E_j @ theta)  # K,k zeroed on cons
        x_next = c_j + A_j @ x + B_j @ u
        return x_next, (x_next, u)

    _, (X, U) = lax.scan(fwd, x0, (c, A, B, K, k, Es, free),
                         unroll=unroll)
    return X, U


def _consensus_solve(fac: RiccatiFactor, B, c, x0, xt, utf, utc,
                     wc, theta_lin, Es, free, maskc, xdim: int, kappa: float,
                     S_extra=None, unroll: int = 1):
    """Solve one stage-structured system against a stored factor: per-particle
    linear backward sweeps, theta Schur reduction (the consensus sum — a psum
    when particles are sharded), per-particle forward rollouts.

    Returns (theta (nct,), X (M, N, xdim), U (M, N, udim))."""
    dtype = fac.Aa.dtype
    p0, k = jax.vmap(
        lambda Aa, Mn, L, Huy, B_, c_, xt_, utf_, utc_: _lin_backward_one(
            Aa, Mn, L, Huy, B_, c_, xt_, utf_, utc_, Es, free, xdim,
            unroll=unroll)
    )(fac.Aa, fac.Mn, fac.L, fac.Huy, B, c, xt, utf, utc)
    S = fac.P0[:, xdim:, xdim:]
    s = p0[:, xdim:] + jnp.einsum("mij,mj->mi", fac.P0[:, xdim:, :xdim], x0)
    nct = S.shape[-1]
    eye = jnp.eye(nct, dtype=dtype)
    # dead (padded / Nc=0) theta entries pinned to 0 via identity rows
    S_tot = jnp.sum(S, axis=0) * maskc[:, None] * maskc[None, :] \
        + jnp.diag(wc * maskc) + (1.0 - maskc) * eye + kappa * eye
    if S_extra is not None:  # e.g. consensus-stage SOC NT blocks
        S_tot = S_tot + S_extra * maskc[:, None] * maskc[None, :]
    rhs = (theta_lin - jnp.sum(s, axis=0)) * maskc
    theta = cholesky_solve(cholesky_factor(S_tot), rhs)
    X, U = jax.vmap(
        lambda x0_, c_, A_, B_, K_, k_: _forward_one(
            x0_, c_, A_, B_, K_, k_, Es, free, theta, unroll=unroll)
    )(x0, c, fac.Aa[:, :, :xdim, :xdim], B, fac.K, k)
    return theta, X, U


def _stage_obj_grad(theta, uf, x0, c, A, B, Qt, xt, Rt, ut, Nc: int,
                    maskc, unroll: int = 1):
    """Gradient of the stage objective w.r.t. (theta, uf): the FACTORED
    ``H z + q`` (rollout + adjoint via jax.grad — no condensed Ft)."""
    M, N = c.shape[0], c.shape[1]
    udim = B.shape[-1]

    def obj_one(th, uf_i, x0_i, c_i, A_i, B_i, Qt_i, xt_i, Rt_i, ut_i):
        U_cons = (th * maskc).reshape(Nc, udim) if Nc else \
            jnp.zeros((0, udim), th.dtype)
        U = jnp.concatenate([U_cons, uf_i.reshape(N - Nc, udim)], axis=0)

        def step(x, inp):
            c_j, A_j, B_j, u_j = inp
            xn = c_j + A_j @ x + B_j @ u_j
            return xn, xn

        _, X = lax.scan(step, x0_i, (c_i, A_i, B_i, U), unroll=unroll)
        cx = 0.5 * jnp.einsum("ni,nij,nj->", X, Qt_i, X) - jnp.sum(xt_i * X)
        cu = 0.5 * jnp.einsum("ni,nij,nj->", U, Rt_i, U) - jnp.sum(ut_i * U)
        return cx + cu

    def total(th, uf_all):
        vals = jax.vmap(
            lambda uf_i, x0_i, c_i, A_i, B_i, Q_i, xt_i, R_i, ut_i: obj_one(
                th, uf_i, x0_i, c_i, A_i, B_i, Q_i, xt_i, R_i, ut_i)
        )(uf_all, x0, c, A, B, Qt, xt, Rt, ut)
        return jnp.sum(vals)

    return jax.grad(total, argnums=(0, 1))(theta, uf)


class RIPMState(NamedTuple):
    theta: jax.Array  # (nct,)
    uf: jax.Array     # (M, nfu)
    s: jax.Array      # (mtot,) slacks [c_lo; c_hi; f_lo; f_hi; x_lo; x_hi]
    lam: jax.Array    # (mtot,)
    sq: jax.Array     # (nq, udim+1) SOC slacks (dummy (1,1) without cones)
    zq: jax.Array     # (nq, udim+1) SOC duals
    mu: jax.Array
    done: jax.Array
    ok: jax.Array
    iters: jax.Array
    badc: jax.Array    # consecutive breakdown counter (SOC retry contract)
    failed: jax.Array  # froze on a bad (non-finite/diverged) step without converging


@partial(jax.jit, static_argnames=("Nc", "iters", "tol_exp", "kappa", "tau",
                                   "mu_target", "scan_unroll"))
@with_matmul_precision("highest")
def riccati_ipm_core(
    x0, c, A, B, Qt, xt, Rt, ut,
    lo_c, hi_c, lo_f, hi_f,
    Nc: int,
    iters: int = 20,
    tol_exp: int = -6,
    kappa: float = 0.0,
    warm: Optional[Tuple] = None,
    tol_dynamic: Optional[jax.Array] = None,
    tau: Optional[float] = None,
    x_lo=None,
    x_hi=None,
    soc_rc=None,
    soc_rf=None,
    mu_target: float = 0.0,
    ex_Gc=None,
    ex_Gf=None,
    ex_Gx=None,
    ex_h=None,
    scan_unroll: int = 1,
):
    """Mehrotra box IPM over (theta, u_free) with Riccati-sweep Newton solves.

    Args:
        x0 (M, xdim); c/A/B/Qt/xt/Rt/ut: per-particle stage data (M, N, ...)
            in the `riccati.py` cost convention.
        lo_c/hi_c (nct,): consensus control bounds (+-inf when absent;
            particle-0 convention of ``lqp_utils.jl:323-331``).
        lo_f/hi_f (M, nfu): free control bounds, nfu = (N - Nc) * udim.
        warm: (theta, uf, s, lam) from a previous nearby solve.
        x_lo/x_hi (M, N, nxb): STATE box bounds on the rolled-out states
            x_1..x_N (+-inf rows inactive). ``nxb`` may be smaller than the
            stage state dim (slew augmentation appends control memory the box
            must not see). State rows stay O(N): their slacks/directions come
            from forward rollouts, their multiplier adjoints from a backward
            scan, and their barrier weights land on the per-stage ``Qt_j``
            diagonal, which the Riccati factorization absorbs — the O(N)
            analog of the reference's sparse state rows
            (``PMPC.jl/src/lqp_utils.jl:306-393``).
        soc_rc (Nc,) / soc_rf (M, Nf): per-stage control-norm cone radii
            ``||u_j|| <= r_j`` (+inf rows inactive; consensus stages one
            shared cone each, particle-0 convention). The cones' NT scalings
            are dense (udim x udim) per stage — the free-stage blocks land
            on ``Rt_j`` (the Riccati factor takes dense Rt) and the
            consensus-stage blocks on the theta Schur complement, so the
            O(N) structure is untouched (stage-structured analog of the
            arrow path's SocSpec handling, `ipm.py:194-238`).
        ex_Gc (l, nct) / ex_Gf (l, M, nfu) / ex_Gx (l, M, N, nxe) / ex_h
            (l,): LINEAR extra rows ``g'z <= h`` over the full consensus
            layout, pre-split by variable block (+inf h rows inactive).
            The state block is eliminated through ONE adjoint sweep per row
            (A/B are constant within the subproblem, so the reduced rows
            over (theta, uf) are constant), then the rows border the
            Riccati Newton system exactly like `ipm.ExtraRows` borders the
            arrow: l+2 Riccati solves per direction + an l x l Schur factor
            per iteration, with the extras dual step taken from the Schur
            solve (the flat recovery cancels at row weights ~1/mu). This is
            the O(N) long-horizon route for the reference's linear
            ``extra_cstrs`` (main.jl:292-316) that round 3 gated to the
            condensed path.

    Returns (theta (nct,), uf (M, nfu), stats) — recover trajectories with
    `recover_XU_stage`.
    """
    M, N = c.shape[0], c.shape[1]
    xdim = x0.shape[-1]
    udim = B.shape[-1]
    dtype = c.dtype
    Es, free, nct, maskc = _selectors(N, Nc, udim, dtype)
    nfu = (N - Nc) * udim
    Nf = N - Nc
    has_x = x_lo is not None
    nxb = x_lo.shape[-1] if has_x else 0
    has_ex = ex_h is not None
    l_ex = ex_h.shape[0] if has_ex else 0
    mx = M * N * nxb
    mtot = 2 * nct + 2 * M * nfu + 2 * mx + l_ex
    o_chi, o_flo, o_fhi = nct, 2 * nct, 2 * nct + M * nfu
    o_xlo = 2 * nct + 2 * M * nfu
    o_xhi = o_xlo + mx
    o_ex = o_xhi + mx

    tol = jnp.asarray(10.0 ** tol_exp, dtype=dtype)
    if tol_dynamic is not None:
        tol = jnp.maximum(jnp.asarray(tol_dynamic, dtype=dtype), tol)
    tau = jnp.asarray(0.99 if tau is None else tau, dtype=dtype)
    # mu_target > 0 stops ON the central path at duality measure mu_target
    # (the logbarrier-smoothed problem's solution is the central-path point
    # at mu = 1/alpha — ipm_core contract, cone_utils.jl:173-202)
    mu_target_pos = float(mu_target) > 0.0  # static
    mu_t = jnp.asarray(mu_target, dtype=dtype)

    bound_blocks = [lo_c, hi_c, lo_f.reshape(-1), hi_f.reshape(-1)]
    if has_x:
        bound_blocks += [x_lo.reshape(-1), x_hi.reshape(-1)]
    if has_ex:
        bound_blocks += [ex_h]
    lo_flat = jnp.concatenate(bound_blocks)
    mask = jnp.isfinite(lo_flat) & jnp.concatenate([
        maskc > 0, maskc > 0,
        jnp.ones((mtot - 2 * nct,), bool)])

    # ---- per-stage control-norm SOC cones (||u_j|| <= r_j) ----
    has_soc = soc_rc is not None
    from .coneipm import _soc_W, _soc_inv, _soc_prod, _soc_step_len

    if has_soc:
        p_soc = udim + 1
        nq = Nc + M * Nf
        r_flat = jnp.concatenate([soc_rc, soc_rf.reshape(-1)])  # (nq,)
        rmask = jnp.isfinite(r_flat)
        rmaskf = rmask.astype(dtype)
        e_soc = jnp.zeros((nq, p_soc), dtype).at[:, 0].set(1.0)

        def cone_vals(theta, uf):
            """h - G z per cone: [r_k; u_stage] (nq, p); e on masked cones."""
            ths = (theta * maskc)[:Nc * udim].reshape(Nc, udim) if Nc \
                else jnp.zeros((0, udim), dtype)
            u_all = jnp.concatenate([ths, uf.reshape(M * Nf, udim)], axis=0)
            vals = jnp.concatenate([r_flat[:, None], u_all], axis=-1)
            return jnp.where(rmask[:, None], vals, e_soc)

        def cone_scatter(vq):
            """S' vq[1:] -> (gth (nct,), gf (M, nfu)); masked cones -> 0."""
            vq = vq * rmaskf[:, None]
            gth = jnp.zeros((nct,), dtype)
            if Nc:
                gth = gth.at[:Nc * udim].set(vq[:Nc, 1:].reshape(-1))
            gf = vq[Nc:, 1:].reshape(M, nfu) if Nf else \
                jnp.zeros((M, nfu), dtype)
            return gth * maskc, gf

        def cone_gdv(dth, duf):
            """G dz per cone = [0; -du_stage]; masked cones -> 0."""
            dvals = cone_vals(dth, duf)
            gd = jnp.concatenate(
                [jnp.zeros((nq, 1), dtype), -dvals[:, 1:]], axis=-1)
            return gd * rmaskf[:, None]

        def shift_soc(u):
            a = jnp.linalg.norm(u[:, 1:], axis=-1) - u[:, 0]
            shift = jnp.where(a < -1e-3, 0.0,
                              1e-3 + jnp.maximum(a, 0.0) * 1.001)
            return u.at[:, 0].add(shift)

        n_act = jnp.sum(mask).astype(dtype) + jnp.sum(rmask).astype(dtype)
    else:
        # dummy single-element placeholders, NOT zero-sized (one carry
        # layout, no 0-sized arrays in the while_loop carry)
        nq, p_soc = 0, 1
        e_soc = jnp.zeros((1, 1), dtype)
        rmaskf = jnp.zeros((1,), dtype)
        n_act = jnp.sum(mask).astype(dtype)
    n_act = jnp.maximum(n_act, 1.0)

    # ---- state-row machinery (all O(N) scans; no condensed sensitivity) ----
    def _stage_U(theta, uf):
        """Full (M, N, udim) stage controls from the reduced variables."""
        Uc = jnp.einsum("nuk,k->nu", Es, theta * maskc)
        pad = jnp.zeros((M, Nc, udim), dtype)
        Uf = jnp.concatenate([pad, uf.reshape(M, Nf, udim)], axis=1)
        return Uc[None] + Uf

    def _roll_one(x0_, c_, A_, B_, U_):
        def fstep(x, inp):
            c_j, A_j, B_j, u_j = inp
            xn = c_j + A_j @ x + B_j @ u_j
            return xn, xn

        return lax.scan(fstep, x0_, (c_, A_, B_, U_))[1]

    def _states_of(theta, uf):
        X = jax.vmap(_roll_one)(x0, c, A, B, _stage_U(theta, uf))
        return X[..., :nxb]

    def _dstates_of(dth, duf):
        dU = _stage_U(dth, duf)
        dX = jax.vmap(_roll_one)(
            jnp.zeros_like(x0), jnp.zeros_like(c), A, B, dU)
        return dX[..., :nxb]

    def _adj_one(A_, B_, vX_):
        """Backward adjoint: gradient w.r.t. stage controls of sum_j v_j'x_j."""

        def bstep(p, inp):
            A_j, B_j, v_j = inp
            p = p + v_j
            return A_j.T @ p, B_j.T @ p

        _, gU = lax.scan(bstep, jnp.zeros((A_.shape[-1],), A_.dtype),
                         (A_, B_, vX_), reverse=True)
        return gU

    def _x_adjoint_gen(vx, d):
        """G_x' vx for state-row multipliers vx (M, N, d) -> (gth, gf)."""
        vX = jnp.zeros((M, N, xdim), dtype).at[..., :d].set(vx)
        gU = jax.vmap(_adj_one)(A, B, vX)
        gth = jnp.einsum("nuk,mnu->k", Es, gU) * maskc
        gf = gU[:, Nc:, :].reshape(M, nfu)
        return gth, gf

    def _x_adjoint(vx):
        return _x_adjoint_gen(vx, nxb)

    # ---- linear extras rows, reduced over (theta, uf) ----------------------
    # A/B are constant within the subproblem, so each row's state block
    # collapses through ONE adjoint sweep into a constant dense row over the
    # reduced variables, and the constant state offset (rollout with zero
    # controls) shifts h: g'z <= h becomes exr.(theta, uf) <= h_eff. This is
    # the stage-space analog of `ipm.map_extras_rows` without ever forming
    # the condensed sensitivity.
    if has_ex:
        nxe = ex_Gx.shape[-1]
        gx_th, gx_f = jax.vmap(lambda gx: _x_adjoint_gen(gx, nxe))(ex_Gx)
        exr_c = ex_Gc * maskc[None, :] + gx_th      # (l, nct)
        exr_f = ex_Gf + gx_f                        # (l, M, nfu)
        X_zero = jax.vmap(_roll_one)(
            x0, c, A, B, jnp.zeros((M, N, udim), dtype))[..., :nxe]
        h_eff = ex_h - jnp.einsum("lmnd,mnd->l", ex_Gx, X_zero)

        def ex_dot(th_, uf_):
            return exr_c @ th_ + jnp.einsum("lmn,mn->l", exr_f, uf_)

    def slack_vals(theta, uf):
        base = [theta - lo_c, hi_c - theta,
                (uf - lo_f).reshape(-1), (hi_f - uf).reshape(-1)]
        if has_x:
            Xb = _states_of(theta, uf)
            base += [(Xb - x_lo).reshape(-1), (x_hi - Xb).reshape(-1)]
        if has_ex:
            base += [h_eff - ex_dot(theta * maskc, uf)]
        return jnp.concatenate(base)

    def g_dot_z(dth, duf):
        duf_f = duf.reshape(-1)
        blocks = [-dth, dth, -duf_f, duf_f]
        if has_x:
            dX = _dstates_of(dth, duf).reshape(-1)
            blocks += [-dX, dX]
        if has_ex:
            blocks += [ex_dot(dth * maskc, duf)]
        return jnp.concatenate(blocks)

    def gT_dot(v):
        bc = v[o_chi:o_flo] - v[:nct]
        bf = (v[o_fhi:o_xlo] - v[o_flo:o_fhi]).reshape(M, nfu)
        if has_x:
            vx = (v[o_xhi:o_ex] - v[o_xlo:o_xhi]).reshape(M, N, nxb)
            gth, gf = _x_adjoint(vx)
            bc = bc + gth
            bf = bf + gf
        if has_ex:
            ve = v[o_ex:]
            bc = bc + ve @ exr_c
            bf = bf + jnp.einsum("l,lmn->mn", ve, exr_f)
        return bc, bf

    def grad_lagrangian(theta, uf, lam):
        gc, gf = _stage_obj_grad(theta, uf, x0, c, A, B, Qt, xt, Rt, ut,
                                 Nc, maskc, unroll=scan_unroll)
        dc, df = gT_dot(lam)
        return (gc + dc) * maskc, gf + df

    # stage views of the free-control RHS/weights: (M, nfu) <-> (M, Nf, udim)
    def to_stages(bf):
        pad = jnp.zeros((M, Nc, udim), dtype)
        return jnp.concatenate([pad, bf.reshape(M, Nf, udim)], axis=1)

    zeros_utc = jnp.zeros((M, N, udim), dtype)
    zeros_xt = jnp.zeros((M, N, xdim), dtype)
    zeros_c = jnp.zeros((M, N, xdim), dtype)
    zeros_x0 = jnp.zeros((M, xdim), dtype)

    def newton_factor(wc, wf, wx=None, Bq_free=None, Sc_blk=None):
        """Factor H + diag(w) (+ cone blocks): free-stage box weights onto
        Rt_j, consensus box weights onto the theta Schur complement (applied
        in `solve`), state-box weights onto the Qt_j diagonal (the stage
        form of G_x' diag(wx) G_x — the recursion propagates them through
        the dynamics chain), free-stage SOC NT blocks (dense udim x udim)
        onto Rt_j, consensus-stage SOC blocks onto the theta Schur."""
        wf_stage = to_stages(wf)  # (M, N, udim), zero on consensus stages
        eye_u = jnp.eye(udim, dtype=dtype)
        Rt_eff = Rt + wf_stage[:, :, :, None] * eye_u
        if Bq_free is not None:  # (M, Nf, udim, udim) dense NT blocks
            Rt_eff = Rt_eff.at[:, Nc:].add(Bq_free)
        Qt_eff = Qt
        if wx is not None:
            ixb = jnp.arange(nxb)
            Qt_eff = Qt.at[:, :, ixb, ixb].add(wx)
        fac = riccati_factor(A, B, Qt_eff, Rt_eff, Es, free, xdim,
                             kappa=kappa, unroll=scan_unroll)

        def solve(bc, bf):
            th, _, dU = _consensus_solve(
                fac, B, zeros_c, zeros_x0, zeros_xt, to_stages(bf),
                zeros_utc, wc, bc, Es, free, maskc, xdim, kappa,
                S_extra=Sc_blk)
            return th, dU[:, Nc:, :].reshape(M, nfu)

        return solve

    # -- initialization --------------------------------------------------------
    if warm is not None:
        th0, uf0, warm_s, warm_lam = warm[:4]
        delta = jnp.asarray(1e-2, dtype)
        sv = slack_vals(th0, uf0)
        s0 = jnp.where(mask, jnp.maximum(sv, delta), 1.0)
        lam0 = jnp.where(mask, jnp.maximum(warm_lam, delta), 0.0)
    else:
        # cold start: the unconstrained (equality) stage solve
        fac0 = riccati_factor(A, B, Qt, Rt, Es, free, xdim, kappa=kappa,
                              unroll=scan_unroll)
        th0, _, U0 = _consensus_solve(
            fac0, B, c, x0, xt, to_stages(ut[:, Nc:].reshape(M, nfu)),
            ut, jnp.zeros((nct,), dtype), jnp.zeros((nct,), dtype),
            Es, free, maskc, xdim, kappa)
        uf0 = U0[:, Nc:, :].reshape(M, nfu)
        sv = slack_vals(th0, uf0)
        s0 = jnp.where(mask, jnp.maximum(sv, 1.0), 1.0)
        lam0 = jnp.where(mask, 1.0 / s0, 0.0)
    if has_soc:
        sq0 = shift_soc(cone_vals(th0, uf0))
        if warm is not None and len(warm) >= 6:
            rmask_col = jnp.isfinite(r_flat)[:, None]
            zq0 = shift_soc(jnp.where(rmask_col, warm[5], e_soc))
        else:
            zq0 = e_soc
        mu0 = (jnp.sum(jnp.where(mask, s0 * lam0, 0.0))
               + jnp.sum(rmaskf * jnp.sum(sq0 * zq0, axis=-1))) / n_act
    else:
        sq0, zq0 = e_soc, e_soc
        mu0 = jnp.sum(jnp.where(mask, s0 * lam0, 0.0)) / n_act
    state0 = RIPMState(th0, uf0, s0, lam0, sq0, zq0, mu0,
                       jnp.asarray(False), jnp.asarray(False),
                       jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                       jnp.asarray(False))

    w_max = jnp.asarray(1e14 if dtype == jnp.float64 else 1e7, dtype)

    def body(state, mehrotra=True):
        theta, uf, s, lam, sq, zq, mu, done, ok, it_count, badc, failed = \
            state
        sv = slack_vals(theta, uf)
        r_p = jnp.where(mask, s - sv, 0.0)
        gc, gf = grad_lagrangian(theta, uf, lam)
        if has_soc:
            # cone Jacobian G_k' z_k = -S_k' z_k[1:]
            zc, zf = cone_scatter(zq)
            gc, gf = gc - zc, gf - zf
        w = jnp.where(mask, jnp.minimum(lam / s, w_max), 0.0)
        wx = (w[o_xlo:o_xhi] + w[o_xhi:o_ex]).reshape(M, N, nxb) \
            if has_x else None
        soc_kw = {}
        if has_soc:
            r_pq = (sq - cone_vals(theta, uf)) * rmaskf[:, None]
            Wq, Wqinv, Wq2inv, lamq = jax.vmap(_soc_W)(sq, zq)
            Bq = Wq2inv[:, 1:, 1:] * rmaskf[:, None, None]
            # breakdown-retry regularization (ipm.py contract): a bad step
            # keeps the iterate and re-solves with boosted jitter instead of
            # freezing — f32 cone scalings blow up ~1/mu near the boundary
            boost = badc.astype(dtype) ** 2 \
                * jnp.asarray(1e-5, dtype) * (1.0 + mu)
            eye_u = jnp.eye(udim, dtype=dtype)
            Bq_free = (Bq[Nc:].reshape(M, Nf, udim, udim) + boost * eye_u) \
                if Nf else jnp.zeros((M, 0, udim, udim), dtype)
            Sc_blk = boost * jnp.eye(nct, dtype=dtype)
            if Nc:
                blk = jnp.einsum("ab,aij->aibj", jnp.eye(Nc, dtype=dtype),
                                 Bq[:Nc]).reshape(Nc * udim, Nc * udim)
                Sc_blk = Sc_blk.at[:Nc * udim, :Nc * udim].add(blk)
            soc_kw = dict(Bq_free=Bq_free, Sc_blk=Sc_blk)
        base_solve = newton_factor(
            w[:nct] + w[o_chi:o_flo],
            (w[o_flo:o_fhi] + w[o_fhi:o_xlo]).reshape(M, nfu), wx, **soc_kw)

        if has_ex:
            # augmented bordered solve (ipm.py ExtraRows contract): the l
            # extras rows stay explicit — their dual step comes from the
            # l x l Schur system (exr A^-1 exr' + W^-1) dlam = exr A^-1 b
            # - c2, the primal step from one more Riccati solve of
            # (b - exr' dlam). Cost: l+2 Riccati sweeps per direction + one
            # l x l factor per iteration, all O(N).
            from ..ops.linalg import spd_apply, spd_factor

            w_ex = w[o_ex:]
            mask_ex = mask[o_ex:]
            Zc, Zf = jax.vmap(base_solve)(exr_c, exr_f)
            S_ex = exr_c @ Zc.T + jnp.einsum("kmn,lmn->kl", exr_f, Zf)
            S_ex = S_ex + jnp.diag(jnp.where(
                mask_ex, 1.0 / jnp.maximum(w_ex, 1e-30),
                jnp.asarray(1e30, dtype)))
            LS_ex = spd_factor(S_ex, jitter=1e-12)

            def solve_K(bc_, bf_, c2_):
                yc, yf = base_solve(bc_, bf_)
                rl = exr_c @ yc + jnp.einsum("lmn,mn->l", exr_f, yf)
                dle = jnp.where(mask_ex, spd_apply(LS_ex, rl - c2_), 0.0)
                dth_, duf_ = base_solve(
                    bc_ - dle @ exr_c,
                    bf_ - jnp.einsum("l,lmn->mn", dle, exr_f))
                return dth_, duf_, dle
        else:
            def solve_K(bc_, bf_, c2_):
                dth_, duf_ = base_solve(bc_, bf_)
                return dth_, duf_, None

        def winv_lam_dc(Wi, lam_, dc):
            return Wi @ _soc_prod(_soc_inv(lam_), dc)

        def newton_rhs(r_c, dq_c):
            v = jnp.where(mask, (lam * r_p - r_c) / s, 0.0)
            if has_ex:
                # extras rows stay EXPLICIT (folding them through v like the
                # diagonal families multiplies the solve error by w_ex ~
                # 1/mu and the dual residual diverges — ipm.py contract)
                v_fold = v.at[o_ex:].set(0.0)
                c2 = jnp.where(mask[o_ex:],
                               -r_p[o_ex:] + r_c[o_ex:]
                               / jnp.maximum(lam[o_ex:], 1e-30), 0.0)
            else:
                v_fold, c2 = v, None
            dc, df = gT_dot(v_fold)
            bc, bf = -(gc + dc) * maskc, -(gf + df)
            vq = None
            if has_soc:
                vq = jnp.einsum("cpr,cr->cp", Wq2inv, r_pq) \
                    - jax.vmap(winv_lam_dc)(Wqinv, lamq, dq_c)
                vqc, vqf = cone_scatter(vq)  # rhs -= G' vq = +S' vq[1:]
                bc, bf = bc + vqc, bf + vqf
            return (bc, bf), v, vq, c2

        def recover_steps(dth, duf, v, vq, dlam_ex=None):
            gdz = g_dot_z(dth, duf)
            ds = jnp.where(mask, -r_p - gdz, 0.0)
            dlam = jnp.where(mask, w * gdz + v, 0.0)
            if has_ex:
                # the Schur-computed extras dual step is the numerically
                # stable one (w*gdz + v cancels at w ~ 1/mu)
                dlam = dlam.at[o_ex:].set(
                    jnp.where(mask[o_ex:], dlam_ex, 0.0))
            dsq = dzq = None
            if has_soc:
                gdq = cone_gdv(dth, duf)
                dsq = (-r_pq - gdq) * rmaskf[:, None]
                dzq = (jnp.einsum("cpr,cr->cp", Wq2inv, gdq) + vq) \
                    * rmaskf[:, None]
            return ds, dlam, dsq, dzq

        def step_len(s_, ds, lam_, dlam, sq_, dsq, zq_, dzq):
            rp_ = jnp.where(mask & (ds < 0), -s_ / jnp.where(ds < 0, ds, -1.0),
                            jnp.inf)
            rd_ = jnp.where(mask & (dlam < 0),
                            -lam_ / jnp.where(dlam < 0, dlam, -1.0), jnp.inf)
            ap = jnp.minimum(1.0, tau * jnp.min(rp_))
            ad = jnp.minimum(1.0, tau * jnp.min(rd_))
            if has_soc:
                aq_p = jnp.where(rmaskf > 0,
                                 jax.vmap(_soc_step_len)(sq_, dsq), jnp.inf)
                aq_d = jnp.where(rmaskf > 0,
                                 jax.vmap(_soc_step_len)(zq_, dzq), jnp.inf)
                ap = jnp.minimum(ap, tau * jnp.min(aq_p))
                ad = jnp.minimum(ad, tau * jnp.min(aq_d))
                # NT scaling assumes s and z move together: separate steps
                # let a cone crash into the boundary and stall (ipm.py:455)
                ap = ad = jnp.minimum(ap, ad)
            return ap, ad

        def mu_of(s_, lam_, sq_, zq_):
            tot = jnp.sum(jnp.where(mask, s_ * lam_, 0.0))
            if has_soc:
                tot = tot + jnp.sum(rmaskf * jnp.sum(sq_ * zq_, axis=-1))
            return tot / n_act

        if mehrotra:
            # predictor (affine)
            dq_aff = jax.vmap(_soc_prod)(lamq, lamq) if has_soc else None
            (bc, bf), v_aff, vq_aff, c2_aff = newton_rhs(
                jnp.where(mask, s * lam, 0.0), dq_aff)
            dth_a, duf_a, dle_a = solve_K(bc, bf, c2_aff)
            ds_a, dlam_a, dsq_a, dzq_a = recover_steps(dth_a, duf_a, v_aff,
                                                       vq_aff, dle_a)
            ap_a, ad_a = step_len(s, ds_a, lam, dlam_a, sq, dsq_a, zq, dzq_a)
            mu_aff = mu_of(s + ap_a * ds_a, lam + ad_a * dlam_a,
                           sq + ap_a * dsq_a if has_soc else sq,
                           zq + ad_a * dzq_a if has_soc else zq)
            sigma = jnp.clip((mu_aff / jnp.maximum(mu, 1e-30)) ** 3, 0.0, 1.0)
            sig_mu = jnp.maximum(sigma * mu, mu_t)  # central-path floor
            # corrector (same factorization)
            r_c = jnp.where(mask, s * lam + ds_a * dlam_a - sig_mu, 0.0)
            dq_c = None
            if has_soc:
                so_q = jax.vmap(_soc_prod)(
                    jax.vmap(lambda Wi, x_: Wi @ x_)(Wqinv, dsq_a),
                    jax.vmap(lambda Wm, x_: Wm @ x_)(Wq, dzq_a))
                lam2 = jax.vmap(_soc_prod)(lamq, lamq)
                dq_c = lam2 + so_q - sig_mu * e_soc
        else:
            # pure centering Newton on the perturbed KKT at mu_target
            r_c = jnp.where(mask, s * lam - mu_t, 0.0)
            dq_c = (jax.vmap(_soc_prod)(lamq, lamq) - mu_t * e_soc) \
                if has_soc else None
        (bc, bf), v, vq, c2_m = newton_rhs(r_c, dq_c)
        dth, duf, dle_m = solve_K(bc, bf, c2_m)
        ds, dlam, dsq, dzq = recover_steps(dth, duf, v, vq, dle_m)
        ap, ad = step_len(s, ds, lam, dlam, sq, dsq, zq, dzq)

        th_n = theta + ap * dth
        uf_n = uf + ap * duf
        s_n = jnp.where(mask, s + ap * ds, 1.0)
        lam_n = jnp.where(mask, lam + ad * dlam, 0.0)
        if has_soc:
            sq_n = jnp.where(rmaskf[:, None] > 0, sq + ap * dsq, e_soc)
            zq_n = jnp.where(rmaskf[:, None] > 0, zq + ad * dzq, e_soc)
        else:
            sq_n, zq_n = sq, zq
        mu_n = mu_of(s_n, lam_n, sq_n, zq_n)

        rp_inf = jnp.max(jnp.abs(r_p))
        if has_soc:
            rp_inf = jnp.maximum(rp_inf, jnp.max(jnp.abs(r_pq)))
        # full consensus (Nc=N) leaves the free block zero-sized
        gd_inf = jnp.maximum(
            jnp.max(jnp.abs(gc)) if gc.size else jnp.asarray(0.0, gc.dtype),
            jnp.max(jnp.abs(gf)) if gf.size else jnp.asarray(0.0, gf.dtype))
        step_bad = ~(jnp.isfinite(mu_n) & jnp.isfinite(jnp.sum(th_n))
                     & jnp.isfinite(jnp.sum(uf_n)))
        if has_soc:
            # a missed boundary crossing leaves a cone point OUTSIDE: all
            # later algebra is meaningless — treat the escape as a breakdown
            _esc = lambda u_: jnp.max(
                rmaskf * (jnp.linalg.norm(u_[:, 1:], axis=-1) - u_[:, 0]))
            step_bad = step_bad | (_esc(sq_n) > 0) | (_esc(zq_n) > 0)
        # with SOC cones the achievable dual accuracy is cancellation-limited
        # by the NT scaling near the boundary; extras borders by the
        # bordered-solve accuracy at row weights ~1/mu (both ~sqrt(tol);
        # ipm.py contract)
        gd_tol = jnp.sqrt(tol) if (has_soc or has_ex) else 1e3 * tol
        mu_ok = mu_n < jnp.maximum(tol, mu_t * 1.05)
        if mu_target_pos:
            # the products must also be CENTERED at mu_target (that is what
            # makes the point the logbarrier solution)
            center_err = jnp.max(jnp.where(mask,
                                           jnp.abs(s_n * lam_n - mu_t), 0.0))
            if has_soc:
                prod_q = jnp.sum(sq_n * zq_n, axis=-1)
                center_err = jnp.maximum(
                    center_err, jnp.max(rmaskf * jnp.abs(prod_q - mu_t)))
            centered = center_err < 0.002 * mu_t + tol
        else:
            centered = jnp.asarray(True)
        now_done = mu_ok & centered & (rp_inf < jnp.sqrt(tol)) \
            & (gd_inf < gd_tol)
        now_bad = step_bad | (mu_n > 1e12)

        if has_soc:
            # convergence additionally requires the NEW primal point to be
            # cone-feasible (the ultimate contract of the solve)
            cvn = cone_vals(th_n, uf_n)
            viol_n = jnp.max(
                rmaskf * (jnp.linalg.norm(cvn[:, 1:], axis=-1) - cvn[:, 0]))
            now_done = now_done & (viol_n < jnp.sqrt(tol))
            # retry contract: keep the iterate on a bad step, bump badc (the
            # next factorization gets boosted regularization) and SHIFT the
            # offending cone points back into the interior (a crashed cone's
            # NT scaling overflows — regularization alone cannot fix the
            # iterate, ipm.py:595-606); only repeated breakdowns give up
            frozen = done | now_bad
            sel = lambda a_, b_: jnp.where(frozen, b_, a_)
            badc_n = jnp.where(done, badc,
                               jnp.where(now_bad, badc + 1, 0))
            give_up = badc_n >= 4
            retry = now_bad & ~done
            sq_k = sel(sq_n, sq)
            zq_k = sel(zq_n, zq)
            sq_k = jnp.where(retry, shift_soc(sq_k), sq_k)
            zq_k = jnp.where(retry, shift_soc(zq_k), zq_k)
            return RIPMState(
                sel(th_n, theta), sel(uf_n, uf), sel(s_n, s), sel(lam_n, lam),
                sq_k, zq_k,
                sel(mu_n, mu), done | now_done | give_up, ok | now_done,
                it_count + 1, badc_n,
                failed | (give_up & ~done & ~now_done))
        frozen = done | now_bad
        sel = lambda a_, b_: jnp.where(frozen, b_, a_)
        return RIPMState(
            sel(th_n, theta), sel(uf_n, uf), sel(s_n, s), sel(lam_n, lam),
            sel(sq_n, sq), sel(zq_n, zq),
            sel(mu_n, mu), done | now_done | now_bad, ok | now_done,
            it_count + 1, badc,
            failed | (now_bad & ~done & ~now_done))

    state = lax.while_loop(
        lambda st: (~st.done) & (st.iters < iters), lambda st: body(st), state0)
    if mu_target_pos:
        # finish with pure centering steps: Mehrotra's second-order
        # correction hunts mu -> 0 and wobbles around the mu_target point
        # (ipm_core contract)
        ok_main = state.ok
        state = state._replace(done=state.done & ~state.ok,
                               ok=jnp.asarray(False))
        state = lax.fori_loop(
            0, 10, lambda _, st: body(st, mehrotra=False), state)
        state = state._replace(failed=state.failed & ~ok_main,
                               ok=state.ok | ok_main)

    stats = dict(mu=state.mu, iters=state.iters, converged=state.ok,
                 failed=state.failed & ~state.ok, s=state.s, lam=state.lam,
                 sq=state.sq, zq=state.zq)
    return state.theta, state.uf, stats


def recover_XU_stage(theta, uf, x0, c, A, B, Nc: int, maskc=None):
    """Trajectories from an IPM point: stitch stage controls, roll out the
    (linearized) dynamics. Returns (X (M, N, xdim), U (M, N, udim))."""
    M, N = c.shape[0], c.shape[1]
    udim = B.shape[-1]
    dtype = c.dtype
    if maskc is None:
        maskc = jnp.ones(theta.shape, dtype)
    U_cons = (theta * maskc)[: Nc * udim].reshape(Nc, udim) if Nc else \
        jnp.zeros((0, udim), dtype)
    U = jnp.concatenate([
        jnp.broadcast_to(U_cons, (M, Nc, udim)),
        uf.reshape(M, N - Nc, udim)], axis=1)

    def fwd(x, inp):
        c_j, A_j, B_j, u_j = inp
        xn = c_j + A_j @ x + B_j @ u_j
        return xn, xn

    X = jax.vmap(lambda x0_, c_, A_, B_, U_: lax.scan(
        fwd, x0_, (c_, A_, B_, U_))[1])(x0, c, A, B, U)
    return X, U


def riccati_ipm_solve_np(
    base_args, reg_args, u_l, u_u, Nc: int,
    settings: Optional[dict] = None,
    x_l=None, x_u=None, u_soc_r=None,
    ex_G=None, ex_h=None,
):
    """numpy frontend of the stage-structured box IPM (host-path analog of
    `ipm.ipm_solve_np`): threads a warm start through
    ``settings["solver_state"]["riccati_warm"]`` across SCP iterations."""
    settings = settings or {}
    f = base_args[1]
    M, N = f.shape[0], f.shape[1]
    xdim = np.asarray(base_args[0]).shape[-1]
    udim = base_args[3].shape[-1]
    dtype = np.dtype(np.asarray(f).dtype)
    nc = Nc * udim
    nct = max(nc, 1)
    nfu = (N - Nc) * udim
    has_x = x_l is not None or x_u is not None
    has_ex = ex_G is not None
    l_ex = int(np.shape(ex_G)[0]) if has_ex else 0
    mtot = 2 * nct + 2 * M * nfu + (2 * M * N * xdim if has_x else 0) + l_ex

    has_soc = u_soc_r is not None
    nq = (Nc + M * (N - Nc)) if has_soc else 0

    warm = None
    prev_state = settings.get("solver_state") or {}
    cand = prev_state.get("riccati_warm") if isinstance(prev_state, dict) else None
    if cand is not None and len(cand) >= 4:
        th_w, uf_w, s_w, lam_w = cand[:4]
        shapes_ok = (np.shape(th_w) == (nct,) and np.shape(uf_w) == (M, nfu)
                     and np.shape(s_w) == (mtot,)
                     and np.shape(lam_w) == (mtot,))
        if has_soc:
            shapes_ok = shapes_ok and len(cand) >= 6 \
                and np.shape(cand[4]) == (nq, udim + 1)
        if shapes_ok:
            # warm tuples stay DEVICE arrays across SCP iterations (pulling
            # them would cost ~6 device->host round trips per iteration)
            warm = tuple(
                z if isinstance(z, jax.Array) and z.dtype == dtype
                else jnp.asarray(np.asarray(z, dtype=dtype)) for z in cand)

    iters = int(settings.get("ipm_iters", 30))
    tol_exp = int(settings.get("ipm_tol_exp", -8 if dtype == np.float64 else -5))
    kappa = float(settings.get("ipm_kappa", 0.0 if dtype == np.float64 else 1e-7))

    # inexact-Newton forcing from the SCP residual (same rule as ipm_solve_np;
    # an explicit ipm_tol_exp disables it unless ipm_adaptive_tol is set)
    tol_dyn = None
    r_scp = settings.get("scp_residual")
    adaptive_dflt = "ipm_tol_exp" not in settings
    if r_scp is not None and np.isfinite(r_scp) \
            and settings.get("ipm_adaptive_tol", adaptive_dflt):
        r = min(float(r_scp), 1e3)
        tol_dyn = jnp.asarray(min(1e-3 * r * r, 1e-3), dtype=dtype)

    # slew coupling present (host numpy check -> static trace shape): route
    # through the augmented stage state
    has_slew = any(np.any(np.asarray(a) != 0) for a in reg_args[2:4])
    slew_kw = {}
    if has_slew:
        slew_kw = dict(
            slew_reg=jnp.asarray(np.asarray(reg_args[2], dtype=dtype)),
            slew_reg0=jnp.asarray(np.asarray(reg_args[3], dtype=dtype)),
            slew_um1=jnp.asarray(np.asarray(reg_args[4], dtype=dtype)))
    xbox_kw = {}
    if has_x:
        # one-sided state boxes: absent side at +-inf (the core masks them)
        xl = x_l if x_l is not None else np.full((M, N, xdim), -np.inf)
        xu = x_u if x_u is not None else np.full((M, N, xdim), np.inf)
        xbox_kw = dict(x_l=jnp.asarray(np.asarray(xl, dtype=dtype)),
                       x_u=jnp.asarray(np.asarray(xu, dtype=dtype)))
    soc_kw = {}
    if has_soc:
        soc_kw = dict(u_soc_r=jnp.asarray(np.asarray(u_soc_r, dtype=dtype)))
    if float(settings.get("mu_target", 0.0) or 0.0) > 0.0:
        soc_kw["mu_target"] = float(settings["mu_target"])
    if has_ex:
        soc_kw["ex_G"] = jnp.asarray(np.asarray(ex_G, dtype=dtype))
        soc_kw["ex_h"] = jnp.asarray(np.asarray(ex_h, dtype=dtype))
    X, U, stats = riccati_ipm_solve_scp(
        *[jnp.asarray(np.asarray(a, dtype=dtype)) for a in base_args],
        *[jnp.asarray(np.asarray(a, dtype=dtype)) for a in reg_args[:2]],
        jnp.asarray(np.asarray(u_l, dtype=dtype)),
        jnp.asarray(np.asarray(u_u, dtype=dtype)),
        Nc=Nc, iters=iters, tol_exp=tol_exp, kappa=kappa, warm=warm,
        tol_dynamic=tol_dyn,
        tau=(float(settings["ipm_tau"]) if settings.get("ipm_tau") is not None
             else None),
        # unroll=8 at long N: a partly unrolled sweep, the default where
        # horizons are long (its compile and warm time on the card are not
        # measured yet)
        scan_unroll=int(settings.get("riccati_unroll", 8 if N >= 64 else 1)),
        **slew_kw, **xbox_kw, **soc_kw)
    # ONE packed device->host transfer: each device_get element is its own
    # round trip, and this function would otherwise pull twelve per SCP
    # iteration. X/U/scalars ride one flat vector; the warm primal/dual
    # tuple never leaves the device (see above).
    dt_j = X.dtype
    packed = jnp.concatenate([
        X.reshape(-1), U.reshape(-1),
        jnp.stack([stats["mu"].astype(dt_j),
                   stats["iters"].astype(dt_j),
                   stats["converged"].astype(dt_j),
                   stats["failed"].astype(dt_j)])])
    host = np.asarray(jax.device_get(packed), dtype=dtype)
    nX = X.size
    nU = U.size
    X_h = host[:nX].reshape(X.shape)
    U_h = host[nX:nX + nU].reshape(U.shape)
    mu_h, it_h, conv_h, fail_h = host[nX + nU:]
    warm_out = (stats["theta"], stats["uf"], stats["s"], stats["lam"]) \
        if not has_soc else \
        (stats["theta"], stats["uf"], stats["s"], stats["lam"],
         stats["sq"], stats["zq"])
    data = dict(
        solver_state=dict(riccati_warm=warm_out),
        ipm_mu=float(mu_h),
        ipm_iters=int(it_h),
        ipm_converged=bool(conv_h > 0),
        ipm_failed=bool(fail_h > 0),
    )
    return X_h, U_h, data


def riccati_ipm_solve_scp(x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
                          reg_x, reg_u, u_l, u_u, Nc: int,
                          slew_reg=None, slew_reg0=None, slew_um1=None,
                          x_l=None, x_u=None, u_soc_r=None,
                          ex_G=None, ex_h=None, **kw):
    """One box-constrained SCP subproblem via the stage-structured IPM.

    Batched over the leading particle axis; bounds (M, N, udim) with the
    consensus stages taking particle 0's rows. Slew coupling (optional,
    (M,)/(M, udim) arrays) enters via `riccati.augment_slew_stages` state
    augmentation — the bounds/IPM layout is control-space and unchanged.
    State boxes x_l/x_u (M, N, xdim) apply to the ORIGINAL state entries
    (the slew augmentation's control-memory tail is unbounded).
    Returns (X, U, stats)."""
    from .riccati import augment_slew_stages

    M, N = f.shape[0], f.shape[1]
    xdim = x0.shape[-1]
    udim = U_prev.shape[-1]
    dtype = f.dtype
    c, Qt, xt, Rt, ut = jax.vmap(_scp_stage_terms)(
        x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref, reg_x, reg_u)
    A, B = fx, fu
    x0s = x0
    if slew_reg is not None:
        x0s, c, A, B, Qt, xt = jax.vmap(augment_slew_stages)(
            x0, c, A, B, Qt, xt, slew_reg, slew_reg0, slew_um1)
    nc = Nc * udim
    nct = max(nc, 1)
    ul = u_l.reshape(M, N * udim)
    uu = u_u.reshape(M, N * udim)
    if nc:
        lo_c, hi_c = ul[0, :nc], uu[0, :nc]
    else:
        lo_c = jnp.full((nct,), -jnp.inf, dtype)
        hi_c = jnp.full((nct,), jnp.inf, dtype)
    soc_kw = {}
    if u_soc_r is not None:
        r = jnp.broadcast_to(jnp.asarray(u_soc_r, dtype), (M, N))
        soc_kw = dict(soc_rc=r[0, :Nc], soc_rf=r[:, Nc:])
    ex_kw = {}
    if ex_h is not None:
        # split the full-layout rows [u_cons; u_free_1..M; x_1..M] into the
        # core's (theta, u_free, state) blocks; the state block keeps the
        # ORIGINAL xdim (slew augmentation's control-memory tail is not a
        # user-visible variable)
        l = ex_h.shape[0]
        nfu_ = (N - Nc) * udim
        Gc_raw = ex_G[:, :nc]
        ex_Gc = jnp.zeros((l, nct), dtype).at[:, :nc].set(Gc_raw)
        ex_Gf = ex_G[:, nc:nc + M * nfu_].reshape(l, M, nfu_)
        ex_Gx = ex_G[:, nc + M * nfu_:].reshape(l, M, N, xdim)
        ex_kw = dict(ex_Gc=ex_Gc, ex_Gf=ex_Gf, ex_Gx=ex_Gx, ex_h=ex_h)
    theta, uf, stats = riccati_ipm_core(
        x0s, c, A, B, Qt, xt, Rt, ut,
        lo_c, hi_c, ul[:, nc:], uu[:, nc:], Nc=Nc,
        x_lo=x_l, x_hi=x_u, **soc_kw, **ex_kw, **kw)
    _, _, _, maskc = _selectors(N, Nc, udim, dtype)
    X, U = recover_XU_stage(theta, uf, x0s, c, A, B, Nc, maskc)
    return X[..., :xdim], U, dict(stats, theta=theta, uf=uf)
