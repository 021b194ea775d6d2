"""Batched primal-dual interior-point method for the condensed consensus QP.

This is the on-device replacement for the reference's CPU cone/QP solvers
(ECOS interior-point, ``PMPC.jl/src/cone_solver.jl``; OSQP ADMM,
``PMPC.jl/src/osqp_solver.jl``): a Mehrotra predictor-corrector primal-dual
IPM over the condensed variable z = [u_cons; u_free_1..M] with box constraints
on controls and (condensed) states, plus optional per-stage second-order cones
on controls (thrust-cone style ||u_j|| <= r_j),

    min 0.5 z'Hz + q'z   s.t.  lo_u <= u <= hi_u,  lo_x <= Ft z + g <= hi_x,
                               ||u_j||_2 <= r_j  (per stage, optional).

Key structural facts exploited:
- every IPM Newton matrix is H plus diagonal updates (control boxes), plus
  per-particle ``Ft' D Ft`` terms (state boxes), plus BLOCK-DIAGONAL per-stage
  (udim x udim) terms from the control cones' NT scalings — it keeps the ARROW
  structure, so each iteration costs one batched per-particle Cholesky +
  consensus Schur solve, reused for both the predictor and corrector steps,
- infinite/absent bounds are handled by static flags (groups compiled out) and
  per-row masks (rows frozen at s=1, lam=0); absent cones by per-cone masks
  (frozen at the SOC unit element),
- everything vmaps over a leading scenario-batch axis; per-particle work is
  already batched internally.

The iteration count is a static bound; converged problems freeze in place
(`jnp.where`), so one compiled program serves the whole batch.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.linalg import spd_apply, spd_factor
from ..utils import with_matmul_precision
from .coneipm import _soc_W, _soc_inv, _soc_prod, _soc_step_len
from .reduced import (
    CondensedQP,
    H_apply_factored,
    _block_diag,
    arrow_apply,
    arrow_factor,
    arrow_factor_diag,
    assemble_condensed,
    recover_XU,
)


class BoxBounds(NamedTuple):
    """Two-sided bounds in the consensus layout (entries +-inf when absent)."""

    lo_c: jax.Array  # (nc,)     consensus control lower bounds
    hi_c: jax.Array  # (nc,)
    lo_f: jax.Array  # (M, nf)   free control bounds
    hi_f: jax.Array  # (M, nf)
    lo_x: jax.Array  # (M, NX)   state bounds
    hi_x: jax.Array  # (M, NX)


class SocSpec(NamedTuple):
    """Per-stage control norm cones ||u_j||_2 <= r (entries +inf when absent).

    Consensus stages carry ONE cone each (the controls are shared variables);
    the radii follow the particle-0 convention of the box bounds
    (``lqp_utils.jl:323-331``)."""

    r_c: jax.Array  # (Nc,)  consensus-stage radii
    r_f: jax.Array  # (M, Nf) free-stage radii


class ExtraRows(NamedTuple):
    """Dense linear inequality rows ``g'w <= h`` over the consensus variable
    w = [uc; uf_1..M] (state contributions already eliminated through the
    condensed map at the caller). The rows border the arrow Newton matrix as
    a rank-l update, solved by Sherman-Morrison-Woodbury against the arrow
    factorization — l+1 arrow solves + one l x l factor per iteration
    instead of densifying the whole program (the structured route for the
    reference's LINEAR `extra_cstrs`, main.jl:292-316; SOC/exp extras and
    aux-variable rows keep the composed cone path)."""

    Gc: jax.Array  # (l, nc)
    Gf: jax.Array  # (l, M, nf)
    h: jax.Array   # (l,)  (+inf rows inactive)


class IPMState(NamedTuple):
    uc: jax.Array
    uf: jax.Array
    s: jax.Array  # flat slacks [c_lo; c_hi; f_lo; f_hi; x_lo; x_hi]
    lam: jax.Array  # flat multipliers, same order
    sq: jax.Array  # (nq, 1+udim) SOC slacks ([ (0,1) ] when no cones)
    zq: jax.Array  # (nq, 1+udim) SOC multipliers
    mu: jax.Array  # scalar duality measure
    done: jax.Array  # scalar bool (converged OR diverged: stop updating)
    ok: jax.Array  # scalar bool (converged)
    iters: jax.Array  # iterations actually taken
    badc: jax.Array  # consecutive factorization/step breakdowns (retry counter)
    failed: jax.Array  # scalar bool: gave up on repeated breakdowns (the
    #                    returned iterate has NO feasibility guarantee)


def box_weighted_K(cqp: CondensedQP, wc, wf, wx, Ftc, Ftf, has_u: bool, has_x: bool):
    """Arrow blocks of ``H + G' diag(w) G`` for the box-constraint Jacobians:
    diagonal updates from control boxes, per-particle ``Ft' D Ft`` from state
    boxes. Shared by the IPM and the smooth-barrier Newton solver."""
    dtype = cqp.qf.dtype
    nc, nf = cqp.nc, cqp.nf
    Kcc, Kcf, Kff = cqp.Hcc, cqp.Hcf, cqp.Hff
    if has_u:
        Kcc = Kcc + jnp.diag(wc)
        eye_f = jnp.eye(nf, dtype=dtype)
        Kff = Kff + wf[:, :, None] * eye_f
    if has_x:
        DFtf = wx[:, :, None] * Ftf
        Kff = Kff + jnp.einsum("mji,mjk->mik", Ftf, DFtf)
        if nc > 0:
            DFtc = wx[:, :, None] * Ftc
            Kcc = Kcc + jnp.einsum("mji,mjk->ik", Ftc, DFtc)
            Kcf = Kcf + jnp.einsum("mji,mjk->mik", Ftc, DFtf)
    return Kcc, Kcf, Kff


@partial(jax.jit, static_argnames=("has_u", "has_x", "has_soc", "has_ex",
                                   "iters", "tol_exp",
                                   "kappa", "mu_target", "tau", "diagnostics",
                                   "gondzio", "predictor"))
@with_matmul_precision("highest")
def ipm_core(
    cqp: CondensedQP,
    bounds: BoxBounds,
    has_u: bool,
    has_x: bool,
    iters: int = 30,
    tol_exp: int = -8,
    kappa: float = 0.0,
    mu_target: float = 0.0,
    warm: Optional[Tuple] = None,
    tol_dynamic: Optional[jax.Array] = None,
    tau: Optional[float] = None,
    socs: Optional[SocSpec] = None,
    has_soc: bool = False,
    diagnostics: bool = False,
    gondzio: int = 0,
    ex: Optional[ExtraRows] = None,
    has_ex: bool = False,
    predictor: bool = True,
):
    """Run the predictor-corrector IPM. Returns (uc, uf, stats dict of arrays).

    ``mu_target > 0`` stops on the CENTRAL PATH at duality measure mu_target
    instead of at the exact solution: the central-path point at mu = 1/alpha is
    precisely the solution of the reference's logbarrier-smoothed problem
    (``cone_utils.jl:173-202``), so the ``smooth_cstr="logbarrier"`` path reuses
    this solver with ``mu_target = 1/smooth_alpha``.

    Internally all 2x(consensus + free + state) box constraint groups live in
    ONE flat vector (order [c_lo; c_hi; f_lo; f_hi; x_lo; x_hi]) so the per-
    iteration bookkeeping is a handful of fused vector ops instead of dozens
    of small per-group kernels. SOC cones (``socs`` + ``has_soc=True``) are a
    stacked (nq, 1+udim) array: consensus-stage cones first, then free cones
    (particle-major). ``warm`` is (uc, uf, s_flat, lam_flat) or, with cones,
    (uc, uf, s_flat, lam_flat, sq, zq).
    """
    dtype = cqp.qf.dtype
    # `tol_dynamic` (a traced scalar, e.g. an inexact-Newton forcing term tied
    # to the SCP residual) overrides the static tol when provided
    tol = jnp.asarray(10.0 ** tol_exp, dtype=dtype)
    if tol_dynamic is not None:
        tol = jnp.maximum(jnp.asarray(tol_dynamic, dtype=dtype), tol)
    mu_target_pos = float(mu_target) > 0.0  # static: selects the centering phase
    mu_target = jnp.asarray(mu_target, dtype=dtype)
    M, nc, nf = cqp.M, cqp.nc, cqp.nf
    NX = cqp.g.shape[-1]
    Ftc, Ftf = cqp.Ft[:, :, :nc], cqp.Ft[:, :, nc:]  # (M, NX, nc/nf)
    if tau is None:
        # 0.99: fewer IPM iterations than 0.95; its f32 accuracy on the
        # flagship bounded config is checked by benchmarks/accuracy_probe.py
        # and tests/test_accuracy.py
        tau = 0.99
    tau = jnp.asarray(tau, dtype=dtype)
    mnf, mnx = M * nf, M * NX
    # state-bound rows exist in the flat layout ONLY when state bounds are
    # active (static has_x): for box-only problems they would be ~70% of the
    # vector width — pure dead weight in every per-iteration elementwise op
    mnxl = mnx if has_x else 0
    l_ex = ex.h.shape[0] if has_ex else 0
    o_chi, o_flo, o_fhi, o_xlo, o_xhi, o_ex = (
        nc, 2 * nc, 2 * nc + mnf, 2 * nc + 2 * mnf, 2 * nc + 2 * mnf + mnxl,
        2 * nc + 2 * mnf + 2 * mnxl,
    )
    mtot = o_ex + l_ex

    if has_u:
        lo_parts = [bounds.lo_c, bounds.hi_c,
                    bounds.lo_f.reshape(-1), bounds.hi_f.reshape(-1)]
    else:
        # has_u=False must IGNORE the control bounds entirely (the contract:
        # static flags compile groups out) — finite entries would otherwise
        # activate mask rows whose barrier terms box_weighted_K skips,
        # leaving the Newton system inconsistent with the residual
        lo_parts = [jnp.full_like(bounds.lo_c, -jnp.inf),
                    jnp.full_like(bounds.hi_c, -jnp.inf),
                    jnp.full_like(bounds.lo_f.reshape(-1), -jnp.inf),
                    jnp.full_like(bounds.hi_f.reshape(-1), -jnp.inf)]
    if has_x:
        lo_parts += [bounds.lo_x.reshape(-1), bounds.hi_x.reshape(-1)]
    if has_ex:
        lo_parts += [ex.h]
    lo_flat = jnp.concatenate(lo_parts)
    mask = jnp.isfinite(lo_flat)

    # -- SOC bookkeeping ---------------------------------------------------------
    if has_soc:
        assert socs is not None
        Nc_soc = socs.r_c.shape[0]
        Nf_soc = socs.r_f.shape[-1]
        udim = (nc // Nc_soc) if Nc_soc else (nf // max(Nf_soc, 1))
        p = udim + 1
        nq = Nc_soc + M * Nf_soc
        r_flat = jnp.concatenate([socs.r_c, socs.r_f.reshape(-1)])  # (nq,)
        rmask = jnp.isfinite(r_flat)
        rmaskf = rmask.astype(dtype)
        e_soc = jnp.zeros((nq, p), dtype).at[:, 0].set(1.0)

        def cone_vals(uc, uf):
            """h - G z per cone: [r_k; u_stage] (nq, p); unit e on masked cones."""
            ucs = uc.reshape(Nc_soc, udim) if Nc_soc else uc.reshape(0, udim)
            ufs = uf.reshape(M * Nf_soc, udim)
            u_all = jnp.concatenate([ucs, ufs], axis=0)
            vals = jnp.concatenate([r_flat[:, None], u_all], axis=-1)
            return jnp.where(rmask[:, None], vals, e_soc)

        def cone_scatter(vq):
            """S' vq[1:] -> (vc (nc,), vf (M, nf)); masked cones contribute 0."""
            vq = vq * rmaskf[:, None]
            vc = vq[:Nc_soc, 1:].reshape(nc) if Nc_soc else jnp.zeros((nc,), dtype)
            vf = vq[Nc_soc:, 1:].reshape(M, nf) if Nf_soc else jnp.zeros((M, nf), dtype)
            return vc, vf

        def cone_gdv(duc, duf):
            """G dz per cone = [0; -du_stage], masked cones -> 0."""
            dvals = cone_vals(duc, duf)  # first coords r (ignored), rest du
            gd = jnp.concatenate([jnp.zeros((nq, 1), dtype), -dvals[:, 1:]], axis=-1)
            return gd * rmaskf[:, None]

        def shift_soc(u):
            """Shift each cone point into the interior along e."""
            a = jnp.linalg.norm(u[:, 1:], axis=-1) - u[:, 0]
            shift = jnp.where(a < -1e-3, 0.0, 1e-3 + jnp.maximum(a, 0.0) * 1.001)
            return u.at[:, 0].add(shift)
        n_act = (jnp.sum(mask) + jnp.sum(rmask)).astype(dtype)
    else:
        # dummy single-element placeholders, NOT zero-sized: one carry
        # layout for the cone and cone-free programs, with no 0-sized
        # arrays in the while_loop carry
        nq, p = 0, 1
        e_soc = jnp.zeros((1, 1), dtype)
        rmaskf = jnp.zeros((1,), dtype)
        n_act = jnp.sum(mask).astype(dtype)
    n_act = jnp.maximum(n_act, 1.0)

    def slack_vals(uc, uf):
        """s = h - Gz as one flat vector (garbage on masked rows)."""
        vals = [uc - bounds.lo_c, bounds.hi_c - uc,
                (uf - bounds.lo_f).reshape(-1), (bounds.hi_f - uf).reshape(-1)]
        if has_x:
            x = jnp.einsum("mij,mj->mi", cqp.Ft, jnp.concatenate(
                [jnp.broadcast_to(uc, (M, nc)), uf], axis=-1)) + cqp.g
            vals += [(x - bounds.lo_x).reshape(-1),
                     (bounds.hi_x - x).reshape(-1)]
        if has_ex:
            vals += [ex.h - ex.Gc @ uc
                     - jnp.einsum("lmn,mn->l", ex.Gf, uf)]
        return jnp.concatenate(vals)

    def g_dot_z(duc, duf):
        """G dz as a flat vector (state rows only when they exist)."""
        duf_f = duf.reshape(-1)
        parts = [-duc, duc, -duf_f, duf_f]
        if has_x:
            dx = jnp.einsum("mij,mj->mi", cqp.Ft, jnp.concatenate(
                [jnp.broadcast_to(duc, (M, nc)), duf], axis=-1)).reshape(-1)
            parts += [-dx, dx]
        if has_ex:
            parts += [ex.Gc @ duc + jnp.einsum("lmn,mn->l", ex.Gf, duf)]
        return jnp.concatenate(parts)

    def gT_dot(v):
        """(G' v) split into consensus/free contributions."""
        bc = v[o_chi:o_flo] - v[:nc]
        bf = (v[o_fhi:o_xlo] - v[o_flo:o_fhi]).reshape(M, nf)
        if has_x:
            dv = (v[o_xhi:o_ex] - v[o_xlo:o_xhi]).reshape(M, NX)
            bc = bc + jnp.einsum("mji,mj->i", Ftc, dv)
            bf = bf + jnp.einsum("mji,mj->mi", Ftf, dv)
        if has_ex:
            ve = v[o_ex:]
            bc = bc + ve @ ex.Gc
            bf = bf + jnp.einsum("l,lmn->mn", ve, ex.Gf)
        return bc, bf

    # -- initialization ----------------------------------------------------------
    if warm is not None:
        # warm start from a previous (slightly perturbed) solve: reuse the
        # primal/dual point with a Yildirim-Wright style interior shift —
        # skips the eq-solve factorization and typically cuts the iteration
        # count when the active set is stable (the jitted-loop analog of the
        # reference's threaded solver_state, pmpc/scp_mpc.py:366-373)
        uc0, uf0, _, warm_lam = warm[:4]  # warm slacks recomputed below
        delta = jnp.asarray(1e-2, dtype)
        # slacks recomputed from the warm PRIMAL against the new bounds (the
        # subproblem changed since the warm point was produced): primal
        # residual starts at ~0 and only the interior floor perturbs it
        sv = slack_vals(uc0, uf0)
        s0 = jnp.where(mask, jnp.maximum(sv, delta), 1.0)
        lam0 = jnp.where(mask, jnp.maximum(warm_lam, delta), 0.0)
    else:
        F0 = arrow_factor(cqp.Hcc, cqp.Hcf, cqp.Hff, jitter=kappa)
        uc0, uf0 = arrow_apply(F0, -cqp.qc, -cqp.qf)
        sv = slack_vals(uc0, uf0)
        s0 = jnp.where(mask, jnp.maximum(sv, 1.0), 1.0)
        lam0 = jnp.where(mask, 1.0 / s0, 0.0)
    if has_soc:
        sq0 = shift_soc(cone_vals(uc0, uf0))
        if warm is not None and len(warm) >= 6:
            zq0 = shift_soc(jnp.where(rmask[:, None], warm[5], e_soc))
        else:
            zq0 = e_soc
        mu0 = (jnp.sum(jnp.where(mask, s0 * lam0, 0.0))
               + jnp.sum(rmaskf * jnp.sum(sq0 * zq0, axis=-1))) / n_act
    else:
        sq0, zq0 = e_soc, e_soc
        mu0 = jnp.sum(jnp.where(mask, s0 * lam0, 0.0)) / n_act
    state0 = IPMState(uc0, uf0, s0, lam0, sq0, zq0, mu0,
                      jnp.asarray(False), jnp.asarray(False),
                      jnp.asarray(0, dtype=jnp.int32),
                      jnp.asarray(0, dtype=jnp.int32),
                      jnp.asarray(False))

    def grad_lagrangian(uc, uf, lam, zq):
        """(gc, gf) = Hz + q + G'lam (+ cone duals); Hz in FACTORED form when
        available (condensation squares the conditioning — factored residuals
        keep f32 gradients accurate, and inexact Newton with accurate
        residuals converges to the accurate KKT point)."""
        if cqp.Qt is not None:
            Hc, Hf = H_apply_factored(cqp, uc, uf)
            gc, gf = Hc + cqp.qc, Hf + cqp.qf
        else:
            gc = cqp.Hcc @ uc + jnp.einsum("mij,mj->i", cqp.Hcf, uf) + cqp.qc
            gf = jnp.einsum("mji,mj->mi", cqp.Hcf, jnp.broadcast_to(uc, (M, nc))) \
                + jnp.einsum("mij,mj->mi", cqp.Hff, uf) + cqp.qf
        dc, df = gT_dot(lam)
        gc, gf = gc + dc, gf + df
        if has_soc:
            # cone Jacobian G_k' z_k = -S_k' z_k[1:]
            zc, zf = cone_scatter(zq)
            gc, gf = gc - zc, gf - zf
        return gc, gf

    def make_body(mehrotra: bool):
        return partial(body, mehrotra)

    def body(mehrotra, k, state):
        uc, uf, s, lam, sq, zq, mu, done, ok, it_count, badc, failed = state
        sv = slack_vals(uc, uf)
        r_p = jnp.where(mask, s - sv, 0.0)
        gc, gf = grad_lagrangian(uc, uf, lam, zq)

        # capped scaling ratios: uncapped lam/s overflows f32 Cholesky late
        w_max = jnp.asarray(1e14 if dtype == jnp.float64 else 1e7, dtype)
        w = jnp.where(mask, jnp.minimum(lam / s, w_max), 0.0)

        wc_d = w[:nc] + w[o_chi:o_flo]
        wf_d = (w[o_flo:o_fhi] + w[o_fhi:o_xlo]).reshape(M, nf)
        if has_u and not has_x and not has_soc:
            # box-only fast path: K = H + diag(w) — the diagonal is folded
            # into the factor kernel (`arrow_factor_diag`), so the loop-
            # invariant H blocks are padded/relayouted ONCE outside the
            # while-loop and the Newton matrix never materializes in HBM
            F = arrow_factor_diag(cqp.Hcc, cqp.Hcf, cqp.Hff, wc_d, wf_d,
                                  jitter=kappa)
            Kcc = Kcf = Kff = None
        else:
            Kcc, Kcf, Kff = box_weighted_K(
                cqp, wc_d, wf_d,
                ((w[o_xlo:o_xhi] + w[o_xhi:o_ex]).reshape(M, NX)
                 if has_x else None),
                Ftc, Ftf, has_u=has_u, has_x=has_x,
            )
        if has_soc:
            # NT scalings per cone; r_pq = s - (h - Gz)
            r_pq = (sq - cone_vals(uc, uf)) * rmaskf[:, None]
            Wq, Wqinv, Wq2inv, lamq = jax.vmap(_soc_W)(sq, zq)
            # K += S' (W^{-2})[1:,1:] S — block-diagonal per stage
            Bq = Wq2inv[:, 1:, 1:] * rmaskf[:, None, None]
            if nc:
                Kcc = Kcc + _block_diag(Bq[:Nc_soc])
            if Nf_soc:
                Kff = Kff + jax.vmap(_block_diag)(
                    Bq[Nc_soc:].reshape(M, Nf_soc, udim, udim))
        if has_soc:
            # breakdown retries boost the regularization: a near-singular K
            # (cone scalings blow up ~1/mu near convergence) makes the
            # factorization produce NaN; the retry re-solves the same iterate
            # with extra jitter. Box-only problems don't hit this (they keep
            # the freeze-on-bad contract) so the extra per-iteration ops are
            # compiled out.
            diag_scale = jnp.mean(jnp.diagonal(Kff, axis1=-2, axis2=-1)) + 1.0 \
                if nf else jnp.mean(jnp.abs(jnp.diag(Kcc))) + 1.0
            boost = badc.astype(dtype) ** 2 * jnp.asarray(1e-5, dtype) * diag_scale
            if nc:
                Kcc = Kcc + boost * jnp.eye(nc, dtype=dtype)
            if nf:
                Kff = Kff + boost * jnp.eye(nf, dtype=dtype)
        if Kcc is not None:
            F = arrow_factor(Kcc, Kcf, Kff, jitter=kappa)

        def base_solve(bc_, bf_):
            """Arrow solve; with cones, one round of iterative refinement —
            the recovered cone dual multiplies the solve error by W^{-2}
            (~1/mu near convergence), so the raw O(kappa eps) solve error
            shows up as a growing dual residual without refinement."""
            duc_, duf_ = arrow_apply(F, bc_, bf_)
            if has_soc:
                oc = Kcc @ duc_ + jnp.einsum("mij,mj->i", Kcf, duf_)
                of = jnp.einsum("mji,j->mi", Kcf, duc_) \
                    + jnp.einsum("mij,mj->mi", Kff, duf_)
                ddc, ddf = arrow_apply(F, bc_ - oc, bf_ - of)
                duc_, duf_ = duc_ + ddc, duf_ + ddf
            return duc_, duf_

        if has_ex:
            # augmented bordered solve: the l dense extras rows stay explicit
            # — their dual step comes from the l x l Schur system
            #   (G A^-1 G' + W^-1) dlam = G A^-1 b - c2
            # and the primal step from one more arrow solve of (b - G'dlam).
            # This is exact at ANY border weight (the SMW elimination form
            # cancels catastrophically at w ~ 1/mu); cost: l+2 arrow solves
            # per direction + one l x l factor per iteration.
            w_ex = w[o_ex:]
            mask_ex = mask[o_ex:]
            Zc, Zf = jax.vmap(base_solve)(ex.Gc, ex.Gf)  # (l, nc), (l, M, nf)
            S = ex.Gc @ Zc.T + jnp.einsum("kmn,lmn->kl", ex.Gf, Zf)
            S = S + jnp.diag(jnp.where(mask_ex, 1.0 / jnp.maximum(w_ex, 1e-30),
                                       jnp.asarray(1e30, dtype)))
            LS_ex = spd_factor(S, jitter=1e-12)

            def solve_K(bc_, bf_, c2_):
                yc, yf = base_solve(bc_, bf_)
                rl = ex.Gc @ yc + jnp.einsum("lmn,mn->l", ex.Gf, yf)
                dle = jnp.where(mask_ex, spd_apply(LS_ex, rl - c2_), 0.0)
                duc_, duf_ = base_solve(
                    bc_ - dle @ ex.Gc,
                    bf_ - jnp.einsum("l,lmn->mn", dle, ex.Gf))
                return duc_, duf_, dle
        else:
            def solve_K(bc_, bf_, c2_):
                duc_, duf_ = base_solve(bc_, bf_)
                return duc_, duf_, None

        def winv_lam_dc(Wi, lam_, dc):
            return Wi @ _soc_prod(_soc_inv(lam_), dc)

        def newton_rhs(r_c, dq_c):
            v = jnp.where(mask, (lam * r_p - r_c) / s, 0.0)
            if has_ex:
                # extras rows stay EXPLICIT in the Newton system (augmented
                # form): folding them through v like the diagonal families
                # multiplies the solve error by w_ex ~ 1/mu and the dual
                # residual diverges (measured: gd_inf 1e13). Their dual step
                # comes from the l x l Schur solve instead; c2 is that
                # system's rhs (-r_p + r_c/lam per active row).
                v_fold = v.at[o_ex:].set(0.0)
                c2 = jnp.where(mask[o_ex:],
                               -r_p[o_ex:] + r_c[o_ex:]
                               / jnp.maximum(lam[o_ex:], 1e-30), 0.0)
            else:
                v_fold, c2 = v, None
            dc, df = gT_dot(v_fold)
            bc, bf = -(gc + dc), -(gf + df)
            vq = None
            if has_soc:
                vq = jnp.einsum("cpr,cr->cp", Wq2inv, r_pq) \
                    - jax.vmap(winv_lam_dc)(Wqinv, lamq, dq_c)
                # rhs -= G' vq = +S' vq[1:]
                vqc, vqf = cone_scatter(vq)
                bc, bf = bc + vqc, bf + vqf
            return (bc, bf), v, vq, c2

        def recover_steps(duc, duf, v, vq, dlam_ex=None):
            gdz = g_dot_z(duc, duf)
            ds = jnp.where(mask, -r_p - gdz, 0.0)
            dlam = jnp.where(mask, w * gdz + v, 0.0)
            if has_ex:
                # the Schur-computed extras dual step is the numerically
                # stable one (the w*gdz + v form cancels at w ~ 1/mu)
                dlam = dlam.at[o_ex:].set(
                    jnp.where(mask[o_ex:], dlam_ex, 0.0))
            dsq = dzq = None
            if has_soc:
                gdq = cone_gdv(duc, duf)
                dsq = (-r_pq - gdq) * rmaskf[:, None]
                # dzq = W^{-2}(G dz + r_pq) - W^{-1}(lam^{-1} o dq_c)
                #     = W^{-2} (G dz) + vq   (vq = W^{-2} r_pq - winv_lam_dc)
                dzq = (jnp.einsum("cpr,cr->cp", Wq2inv, gdq) + vq) * rmaskf[:, None]
            return ds, dlam, dsq, dzq

        def step_len(s_, ds, lam_, dlam, sq_, dsq, zq_, dzq):
            rp_ = jnp.where(mask & (ds < 0), -s_ / jnp.where(ds < 0, ds, -1.0), jnp.inf)
            rd_ = jnp.where(mask & (dlam < 0), -lam_ / jnp.where(dlam < 0, dlam, -1.0),
                            jnp.inf)
            if mtot:
                # ONE stacked reduction for both ratio families: the chain is
                # latency-bound at these sizes, and every separate reduction
                # is its own small op
                mins = jnp.min(jnp.stack([rp_, rd_]), axis=1)
                ap = jnp.minimum(1.0, tau * mins[0])
                ad = jnp.minimum(1.0, tau * mins[1])
            else:
                ap = ad = jnp.asarray(1.0, dtype)
            if has_soc:
                aq_p = jax.vmap(_soc_step_len)(sq_, dsq)
                aq_d = jax.vmap(_soc_step_len)(zq_, dzq)
                aq_p = jnp.where(rmaskf > 0, aq_p, jnp.inf)
                aq_d = jnp.where(rmaskf > 0, aq_d, jnp.inf)
                ap = jnp.minimum(ap, tau * jnp.min(aq_p))
                ad = jnp.minimum(ad, tau * jnp.min(aq_d))
            return ap, ad

        def mu_of(s_, lam_, sq_, zq_):
            tot = jnp.sum(jnp.where(mask, s_ * lam_, 0.0))
            if has_soc:
                tot = tot + jnp.sum(rmaskf * jnp.sum(sq_ * zq_, axis=-1))
            return tot / n_act

        if mehrotra and not predictor:
            # single-solve mode (``predictor=False``): skip the affine probe
            # and pick the centering parameter from the LOQO distance-to-
            # centrality heuristic (xi = min complementarity product / mu).
            # One factor + ONE arrow solve per iteration instead of two
            # solves — where the per-iteration op chain is the binding
            # resource, trading Mehrotra's iteration savings for a shorter
            # chain is a measurable A/B (off by default).
            prods = jnp.where(mask, s * lam, jnp.inf)
            xi_min = jnp.min(prods) if mtot else mu
            if has_soc:
                prod_q = jnp.sum(sq * zq, axis=-1)
                xi_min = jnp.minimum(
                    xi_min, jnp.min(jnp.where(rmaskf > 0, prod_q, jnp.inf)))
            xi = jnp.clip(xi_min / jnp.maximum(mu, 1e-30), 1e-6, 1.0)
            sigma = 0.1 * jnp.minimum(0.05 * (1.0 - xi) / xi, 2.0) ** 3
            sigma = jnp.clip(sigma, 0.05, 0.8)
            sig_mu = jnp.maximum(sigma * mu, mu_target)
            r_c = jnp.where(mask, s * lam - sig_mu, 0.0)
            dq_c = (jax.vmap(_soc_prod)(lamq, lamq) - sig_mu * e_soc) \
                if has_soc else None
        elif mehrotra:
            # predictor (affine) step
            r_c_aff = jnp.where(mask, s * lam, 0.0)
            dq_aff = jax.vmap(_soc_prod)(lamq, lamq) if has_soc else None
            (bc, bf), v_aff, vq_aff, c2_aff = newton_rhs(r_c_aff, dq_aff)
            duc_a, duf_a, dle_a = solve_K(bc, bf, c2_aff)
            ds_a, dlam_a, dsq_a, dzq_a = recover_steps(
                duc_a, duf_a, v_aff, vq_aff, dle_a)
            ap_a, ad_a = step_len(s, ds_a, lam, dlam_a, sq, dsq_a, zq, dzq_a)
            if has_soc:
                # NT scaling assumes s and z move together: separate
                # primal/dual steps let a cone crash into the boundary
                # (det_s << mu^2) and stall all later progress
                ap_a = ad_a = jnp.minimum(ap_a, ad_a)
            mu_aff = mu_of(s + ap_a * ds_a, lam + ad_a * dlam_a,
                           sq + ap_a * dsq_a if has_soc else sq,
                           zq + ad_a * dzq_a if has_soc else zq)
            sigma = jnp.clip((mu_aff / jnp.maximum(mu, 1e-30)) ** 3, 0.0, 1.0)
            sig_mu = jnp.maximum(sigma * mu, mu_target)  # central-path floor
            # corrector (reuses the factorization)
            r_c = jnp.where(mask, s * lam + ds_a * dlam_a - sig_mu, 0.0)
            if has_soc:
                eta_a = jax.vmap(lambda Wi, x_: Wi @ x_)(Wqinv, dsq_a)
                th_a = jax.vmap(lambda Wm, x_: Wm @ x_)(Wq, dzq_a)
                dq_c = (jax.vmap(_soc_prod)(lamq, lamq)
                        + jax.vmap(_soc_prod)(eta_a, th_a) - sig_mu * e_soc)
            else:
                dq_c = None
        else:
            # pure centering Newton on the perturbed KKT at mu_target
            r_c = jnp.where(mask, s * lam - mu_target, 0.0)
            dq_c = (jax.vmap(_soc_prod)(lamq, lamq) - mu_target * e_soc) \
                if has_soc else None
        (bc, bf), v, vq, c2_m = newton_rhs(r_c, dq_c)
        duc, duf, dle_m = solve_K(bc, bf, c2_m)
        ds, dlam, dsq, dzq = recover_steps(duc, duf, v, vq, dle_m)
        ap, ad = step_len(s, ds, lam, dlam, sq, dsq, zq, dzq)
        if has_soc:
            ap = ad = jnp.minimum(ap, ad)  # single combined step (see above)

        if mehrotra and gondzio > 0 and not has_soc:
            # Gondzio multiple centrality correctors: each extra corrector
            # REUSES the factorization (one more back-substitution, ~5-10% of
            # the factor cost at the flagship/pod sizes where the per-particle
            # Cholesky dominates the iteration) and pushes outlier
            # complementarity products of the TRIAL point back into a
            # neighborhood of the central path — fewer factorized iterations
            # for the same progress. Computed unconditionally and kept only
            # when the step length actually improves (lax.cond would stop the
            # while-body fusing; same pattern as coneipm's adaptive damping).
            for _ in range(gondzio):
                d_a = jnp.asarray(0.1, dtype)
                ap_t = jnp.minimum(ap + d_a, 1.0)
                ad_t = jnp.minimum(ad + d_a, 1.0)
                prod = jnp.where(mask, (s + ap_t * ds) * (lam + ad_t * dlam),
                                 sig_mu)
                target = jnp.clip(prod, 0.1 * sig_mu, 10.0 * sig_mu)
                r_c2 = jnp.where(mask, r_c + (prod - target), 0.0)
                (bc2, bf2), v2, _, c2_g = newton_rhs(r_c2, None)
                duc2, duf2, dle_g = solve_K(bc2, bf2, c2_g)
                ds2, dlam2, _, _ = recover_steps(duc2, duf2, v2, None, dle_g)
                ap2, ad2 = step_len(s, ds2, lam, dlam2, sq, None, zq, None)
                acc = (ap2 + ad2) > (ap + ad) + 0.01
                pk = lambda x_, y_: jnp.where(acc, y_, x_)
                duc, duf = pk(duc, duc2), pk(duf, duf2)
                ds, dlam = pk(ds, ds2), pk(dlam, dlam2)
                ap, ad, r_c = pk(ap, ap2), pk(ad, ad2), pk(r_c, r_c2)

        uc_n = uc + ap * duc
        uf_n = uf + ap * duf
        s_n = jnp.where(mask, s + ap * ds, 1.0)
        lam_n = jnp.where(mask, lam + ad * dlam, 0.0)
        if has_soc:
            sq_n = jnp.where(rmask[:, None], sq + ap * dsq, e_soc)
            zq_n = jnp.where(rmask[:, None], zq + ad * dzq, e_soc)
            # f32 hazard: the step-length quadratic's discriminant cancels
            # near the boundary, so a boundary crossing can be missed and a
            # full step lands OUTSIDE the cone — after which the primal
            # residual still contracts (it does so by construction) and the
            # solver silently "converges" to an infeasible point. Detect the
            # escape and treat it as a breakdown (-> restoration retry).
            _esc = lambda v: jnp.max(
                rmaskf * (jnp.linalg.norm(v[:, 1:], axis=-1) - v[:, 0]))
            cone_escaped = (_esc(sq_n) > 0) | (_esc(zq_n) > 0)
        else:
            sq_n, zq_n = sq, zq
        mu_n = mu_of(s_n, lam_n, sq_n, zq_n)

        # convergence / divergence tests
        rp_inf = jnp.max(jnp.abs(r_p)) if mtot else jnp.asarray(0.0, dtype)
        if has_soc:
            rp_inf = jnp.maximum(rp_inf, jnp.max(jnp.abs(r_pq)))
        # one reduction over the concatenated gradient instead of two
        g_all = jnp.concatenate([gc.reshape(-1), gf.reshape(-1)])
        gd_inf = jnp.max(jnp.abs(g_all)) if g_all.size \
            else jnp.asarray(0.0, dtype)
        # non-finite steps freeze to the PREVIOUS iterate (before any write)
        step_bad = ~(jnp.isfinite(mu_n)
                     & jnp.isfinite(jnp.sum(uc_n) if uc_n.size else jnp.asarray(0.0, dtype))
                     & jnp.isfinite(jnp.sum(uf_n)))
        mu_ok = mu_n < jnp.maximum(tol, mu_target * 1.05)
        # with a central-path target, the products must also be CENTERED at
        # mu_target (that is what makes the point the logbarrier solution)
        center_err = jnp.max(jnp.where(mask, jnp.abs(s_n * lam_n - mu_target), 0.0)) \
            if mtot else jnp.asarray(0.0, dtype)
        if has_soc:
            prod_q = jnp.sum(sq_n * zq_n, axis=-1)
            center_err = jnp.maximum(
                center_err, jnp.max(rmaskf * jnp.abs(prod_q - mu_target)))
        centered = (mu_target <= 0) | (center_err < 0.002 * mu_target + tol)
        # dual-residual criterion: with SOC cones the achievable accuracy is
        # cancellation-limited by the NT scaling near the boundary (~sqrt(tol)
        # in practice); demanding 1e3*tol would keep iterating past the best
        # point and drift
        # SOC cones: dual accuracy is cancellation-limited by the NT scaling
        # near the boundary. Extras borders: limited by the bordered-solve
        # accuracy once the row weights reach ~1/mu. Both ~sqrt(tol).
        gd_tol = jnp.sqrt(tol) if (has_soc or has_ex) else 1e3 * tol
        now_done = mu_ok & centered & (rp_inf < jnp.sqrt(tol)) & (gd_inf < gd_tol)
        now_bad = step_bad | (mu_n > 1e12)
        if has_soc:
            # convergence additionally requires the NEW primal point itself to
            # be cone-feasible (the ultimate contract of the solve)
            cvn = cone_vals(uc_n, uf_n)
            viol_n = jnp.max(
                rmaskf * (jnp.linalg.norm(cvn[:, 1:], axis=-1) - cvn[:, 0]))
            now_done = now_done & (viol_n < jnp.sqrt(tol))
            now_bad = now_bad | cone_escaped
        if has_soc:
            badc_n = jnp.where(now_bad, badc + 1, 0)
            give_up = badc_n >= 4  # repeated breakdowns: stop at best iterate
        else:
            badc_n = badc
            give_up = now_bad  # box path: freeze on the first bad step

        frozen = done | now_bad
        keep = lambda new, old: jax.tree.map(lambda a, b: jnp.where(frozen, b, a), new, old)
        # already-done lanes do not count an iteration (the centering phase
        # runs a fixed fori_loop over possibly-frozen states)
        it_old = it_count + jnp.where(done, 0, 1).astype(it_count.dtype)
        new_state = IPMState(uc_n, uf_n, s_n, lam_n, sq_n, zq_n, mu_n,
                             jnp.asarray(False), ok | now_done, it_count + 1,
                             badc_n, failed)
        old_state = IPMState(uc, uf, s, lam, sq, zq, mu,
                             jnp.asarray(False), ok, it_old, badc_n, failed)
        merged = keep(new_state, old_state)
        if has_soc:
            # restoration: a breakdown here is usually a cone point crashed
            # into the boundary (f32: det(s) rounds to <= 0, the NT scaling
            # overflows, the factorization NaNs) — regularization cannot fix
            # the ITERATE, so shift the offending cone points back into the
            # interior before the retry (shift_soc is a no-op on points that
            # are comfortably interior)
            retry = now_bad & ~done
            sq_r = jnp.where(retry, shift_soc(merged.sq), merged.sq)
            zq_r = jnp.where(retry, shift_soc(merged.zq), merged.zq)
            merged = merged._replace(sq=sq_r, zq=zq_r)
        return merged._replace(done=done | now_done | give_up, ok=ok | now_done,
                               failed=failed | (give_up & ~ok & ~now_done))

    # while_loop: under vmap the loop stops when EVERY lane is done
    main_body = make_body(True)

    def while_cond(state):
        return (~state.done) & (state.iters < iters)

    state = lax.while_loop(while_cond, lambda st: main_body(0, st), state0)
    if mu_target_pos:
        # finish with pure centering steps: Mehrotra's second-order correction
        # hunts mu -> 0 and wobbles around the mu_target point
        ok_main = state.ok
        state = state._replace(done=state.done & ~state.ok, ok=jnp.asarray(False))
        state = lax.fori_loop(0, 10, make_body(False), state)
        # a transient breakdown during centering must not latch `failed` for a
        # solve whose main phase already converged: the frozen iterate is the
        # previously-converged point, not garbage
        state = state._replace(failed=state.failed & ~ok_main,
                               ok=state.ok | (ok_main & ~state.failed))
    failed = state.failed
    if has_soc:
        # iteration-cap exits can leave any primal point; only FEASIBLE
        # iterates may be handed back as usable (callers reject failed=True)
        cvf = cone_vals(state.uc, state.uf)
        viol_f = jnp.max(rmaskf * (jnp.linalg.norm(cvf[:, 1:], axis=-1) - cvf[:, 0]))
        failed = failed | (viol_f > 2.0 * jnp.sqrt(tol))
    stats = dict(mu=state.mu, iters=state.iters, converged=state.ok,
                 failed=failed,
                 s=state.s, lam=state.lam, sq=state.sq, zq=state.zq)
    if diagnostics:
        # final KKT residuals (one extra gradient/slack evaluation)
        gc_f, gf_f = grad_lagrangian(state.uc, state.uf, state.lam, state.zq)
        stats["gd_inf"] = jnp.maximum(
            jnp.max(jnp.abs(gc_f)) if gc_f.size else jnp.asarray(0.0, dtype),
            jnp.max(jnp.abs(gf_f)) if gf_f.size else jnp.asarray(0.0, dtype),
        )
        stats["rp_inf"] = jnp.max(jnp.abs(jnp.where(
            mask, state.s - slack_vals(state.uc, state.uf), 0.0))) \
            if mtot else jnp.asarray(0.0, dtype)
    return state.uc, state.uf, stats


def _layout_bounds(u_l, u_u, x_l, x_u, M, N, NX, nc, nf, udim, dtype):
    """Map (M,N,udim)/(M,N,xdim) bound arrays to the consensus layout, filling
    +-inf where absent. Consensus control bounds come from particle 0
    (parity with ``lqp_utils.jl:323-331``)."""
    inf = np.inf

    def flat_u(b, fill):
        if b is None:
            return np.full((M, N * udim), fill, dtype=dtype)
        return np.asarray(b, dtype=dtype).reshape(M, N * udim)

    def flat_x(b, fill):
        if b is None:
            return np.full((M, NX), fill, dtype=dtype)
        return np.asarray(b, dtype=dtype).reshape(M, NX)

    ul, uu = flat_u(u_l, -inf), flat_u(u_u, inf)
    return BoxBounds(
        lo_c=jnp.asarray(ul[0, :nc]), hi_c=jnp.asarray(uu[0, :nc]),
        lo_f=jnp.asarray(ul[:, nc:]), hi_f=jnp.asarray(uu[:, nc:]),
        lo_x=jnp.asarray(flat_x(x_l, -inf)), hi_x=jnp.asarray(flat_x(x_u, inf)),
    )


def layout_socs(u_soc_r, M, N, Nc, dtype) -> SocSpec:
    """Map an (M, N) per-stage control-norm radius array into the consensus
    cone layout (+inf = no cone; consensus stages take particle 0's radius)."""
    r = np.broadcast_to(np.asarray(u_soc_r, dtype=dtype), (M, N))
    return SocSpec(r_c=jnp.asarray(r[0, :Nc]), r_f=jnp.asarray(r[:, Nc:]))


def map_extras_rows(cqp: CondensedQP, ex_G, ex_h, nc, nf, M, NX) -> ExtraRows:
    """Eliminate the state block of full-layout linear rows through the
    condensed map x = Ft w + g: rows over [u_cons; u_free; x] become dense
    rows over w = [uc; uf] plus an h shift."""
    nu_total = nc + M * nf
    G_u = ex_G[:, :nu_total]
    G_x = ex_G[:, nu_total:].reshape(ex_G.shape[0], M, NX)
    Gc = G_u[:, :nc] + jnp.einsum("lmx,mxc->lc", G_x, cqp.Ft[:, :, :nc])
    Gf = G_u[:, nc:].reshape(ex_G.shape[0], M, nf) \
        + jnp.einsum("lmx,mxn->lmn", G_x, cqp.Ft[:, :, nc:])
    h = ex_h - jnp.einsum("lmx,mx->l", G_x, cqp.g)
    return ExtraRows(Gc=Gc, Gf=Gf, h=h)


@partial(jax.jit, static_argnames=("Nc", "scale_slew_target", "N", "has_u",
                                   "has_x", "has_soc", "has_ex", "iters",
                                   "tol_exp",
                                   "kappa", "mu_target", "tau", "gondzio",
                                   "predictor"))
def _host_box_solve(base_args, reg_args, bounds, socs, warm, tol_dyn,
                    weights, Nc, scale_slew_target, N, has_u, has_x,
                    has_soc, iters, tol_exp, kappa, mu_target, tau,
                    gondzio=0, ex_G=None, ex_h=None, has_ex=False,
                    predictor=True):
    """assemble + IPM + recover as ONE compiled program: the host loop pays
    one dispatch (and one host sync) per subproblem instead of three."""
    cqp = assemble_condensed(*base_args, *reg_args, Nc=Nc, weights=weights,
                             scale_slew_target=scale_slew_target)
    ex = None
    if has_ex:
        M = cqp.Ft.shape[0]
        NX = cqp.g.shape[-1]
        ex = map_extras_rows(cqp, ex_G, ex_h, cqp.nc, cqp.nf, M, NX)
    uc, uf, stats = ipm_core(
        cqp, bounds, has_u=has_u, has_x=has_x, iters=iters, tol_exp=tol_exp,
        kappa=kappa, mu_target=mu_target, warm=warm, tol_dynamic=tol_dyn,
        tau=tau, socs=socs, has_soc=has_soc, gondzio=gondzio,
        ex=ex, has_ex=has_ex, predictor=predictor)
    X, U = recover_XU(cqp, uc, uf, N=N)
    return X, U, uc, uf, stats


def ipm_solve_np(
    base_args, reg_args, u_l, u_u, x_l, x_u,
    Nc: int,
    weights: Optional[jax.Array] = None,
    settings: Optional[Dict[str, Any]] = None,
    ex_G=None, ex_h=None,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """numpy frontend: assemble the condensed QP and run the IPM.

    ``ex_G (l, n_full)`` / ``ex_h (l,)``: LINEAR extra rows over the full
    consensus layout [u_cons; u_free; x] — solved structurally as SMW
    borders of the arrow system (see `ExtraRows`)."""
    settings = settings or {}
    f = base_args[1]
    M, N = f.shape[0], f.shape[1]
    udim = base_args[3].shape[-1]
    xdim = f.shape[-1]
    dtype = np.dtype(np.asarray(f).dtype)

    nc, nf = Nc * udim, (N - Nc) * udim
    bounds = _layout_bounds(u_l, u_u, x_l, x_u, M, N, N * xdim, nc, nf, udim, dtype)

    u_soc_r = settings.get("u_soc_r", None)
    has_soc = u_soc_r is not None
    socs = layout_socs(u_soc_r, M, N, Nc, dtype) if has_soc else None

    has_u = u_l is not None or u_u is not None
    has_x = x_l is not None or x_u is not None
    iters = int(settings.get("ipm_iters", 30))
    tol_exp = int(settings.get("ipm_tol_exp", -8 if dtype == np.float64 else -5))
    kappa = float(settings.get("ipm_kappa", 0.0 if dtype == np.float64 else 1e-7))
    mu_target = float(settings.get("mu_target", 0.0))

    # warm start from the previous SCP iteration's primal/dual point, threaded
    # through ``solver_settings["solver_state"]`` by the host SCP loop (role of
    # the reference's solver_state reuse, pmpc/scp_mpc.py:366-373 /
    # osqp_solver.jl:34-72); ignored when shapes don't match the new problem
    warm = None
    prev_state = settings.get("solver_state") or {}
    has_ex = ex_G is not None
    l_ex = int(np.shape(ex_G)[0]) if has_ex else 0
    cand = prev_state.get("ipm_warm") if isinstance(prev_state, dict) else None
    if cand is not None:
        uc_w, uf_w, s_w, lam_w = cand[:4]
        mtot = 2 * nc + 2 * M * nf + (2 * M * (N * xdim) if has_x else 0) \
            + l_ex
        if (np.shape(uc_w) == (nc,) and np.shape(uf_w) == (M, nf)
                and np.shape(s_w) == (mtot,) and np.shape(lam_w) == (mtot,)):
            warm = tuple(jnp.asarray(np.asarray(z, dtype=dtype)) for z in cand)
            if has_soc and len(warm) < 6:
                warm = None  # cone duals missing: cold start

    # inexact-Newton forcing from the SCP residual (same rule as the fused
    # path's adaptive_tol): early SCP iterations only need loose subproblem
    # solves — the host loop threads settings["scp_residual"] each iteration.
    # An EXPLICIT ipm_tol_exp is a request for that accuracy on every
    # subproblem (e.g. the reference-parity equal-budget comparisons), so it
    # disables the forcing unless ipm_adaptive_tol is itself set.
    tol_dyn = None
    r_scp = settings.get("scp_residual")
    adaptive_dflt = "ipm_tol_exp" not in settings
    if r_scp is not None and np.isfinite(r_scp) \
            and settings.get("ipm_adaptive_tol", adaptive_dflt):
        r = min(float(r_scp), 1e3)
        tol_dyn = jnp.asarray(min(1e-3 * r * r, 1e-3), dtype=dtype)

    X, U, uc, uf, stats = _host_box_solve(
        tuple(jnp.asarray(a) for a in base_args),
        tuple(jnp.asarray(a) for a in reg_args),
        bounds, socs, warm, tol_dyn,
        jnp.asarray(weights, dtype) if weights is not None else None,
        Nc=Nc,
        scale_slew_target=bool(
            settings.get("weights_scale_slew_target", True)),
        N=N, has_u=has_u, has_x=has_x, has_soc=has_soc,
        iters=iters, tol_exp=tol_exp, kappa=kappa, mu_target=mu_target,
        tau=(float(settings["ipm_tau"]) if settings.get("ipm_tau") is not None
             else None),
        gondzio=int(settings.get("ipm_gondzio", 0)),
        predictor=bool(settings.get("ipm_predictor", True)),
        ex_G=jnp.asarray(np.asarray(ex_G, dtype=dtype)) if has_ex else None,
        ex_h=jnp.asarray(np.asarray(ex_h, dtype=dtype)) if has_ex else None,
        has_ex=has_ex,
    )
    # ONE device->host transfer for everything: each separate np.asarray on a
    # device array is its own blocking round trip, and this function would
    # otherwise make ten of them per SCP iteration
    pull = [X, U, uc, uf, stats["s"], stats["lam"],
            stats["mu"], stats["iters"], stats["converged"], stats["failed"]]
    if has_soc:
        pull += [stats["sq"], stats["zq"]]
    pulled = jax.device_get(pull)
    X, U, uc_h, uf_h, s_h, lam_h, mu_h, it_h, conv_h, fail_h = pulled[:10]
    warm_out = [uc_h, uf_h, s_h, lam_h]
    if has_soc:
        warm_out += [pulled[10], pulled[11]]
    data = dict(
        solver_state=dict(ipm_warm=tuple(warm_out)),
        ipm_mu=float(mu_h),
        ipm_iters=int(it_h),
        ipm_converged=bool(conv_h),
        ipm_failed=bool(fail_h),
    )
    return np.asarray(X), np.asarray(U), data
