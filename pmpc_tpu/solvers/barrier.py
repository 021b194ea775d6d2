"""Smooth-constraint path: damped Newton over the condensed consensus problem.

Parity with the reference's constraint smoothing
(``PMPC.jl/src/cone_utils.jl:173-232`` / ``main.jl:242-290``): each box row
``a'z <= b`` is replaced by a smooth penalty of the violation ``y = a'z - b``,

- ``logbarrier``: phi(y) = -(1/alpha) log(-alpha y)       (domain y < 0),
  the exp-cone reformulation the reference hands to ECOS/Mosek — and exactly
  the smoothed objective of the experimental GPU path
  (``pmpc/experimental/solver_definitions.py:45-86``),
- ``squareplus``: phi(y) = (beta/2) (y + sqrt(y^2 + 1/alpha^2)),
  the SOC reformulation at ``cone_utils.jl:222-228``.

The Newton matrix is ``H + G' diag(phi''(y)) G`` which keeps the arrow
structure (`box_weighted_K`), so each Newton step costs the same batched
factorization as an IPM iteration. A backtracking linesearch on the objective
(+inf outside the logbarrier domain) keeps iterates strictly feasible; the
start point is ``U_prev`` like the reference GPU solver.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..utils import with_matmul_precision
from .ipm import BoxBounds, _layout_bounds, box_weighted_K
from .reduced import CondensedQP, arrow_apply, arrow_factor, assemble_condensed, recover_XU


def _phi(method: str, y, alpha, beta):
    """Penalty value/derivative/curvature of a violation y (elementwise)."""
    if method == "logbarrier":
        val = jnp.where(y < 0, -jnp.log(jnp.maximum(-alpha * y, 1e-300)) / alpha, jnp.inf)
        d1 = jnp.where(y < 0, -1.0 / (alpha * y), 0.0)
        d2 = jnp.where(y < 0, 1.0 / (alpha * y * y), 0.0)
    elif method == "squareplus":
        s = jnp.sqrt(y * y + 1.0 / (alpha * alpha))
        val = 0.5 * beta * (y + s)
        d1 = 0.5 * beta * (1.0 + y / s)
        d2 = 0.5 * beta / (alpha * alpha * s * s * s)
    else:  # pragma: no cover
        raise ValueError(f"unknown smoothing method {method}")
    return val, d1, d2


@partial(jax.jit, static_argnames=("method", "has_u", "has_x", "iters", "ls_steps", "kappa"))
@with_matmul_precision("highest")
def barrier_core(
    cqp: CondensedQP,
    bounds: BoxBounds,
    method: str,
    alpha,
    beta,
    has_u: bool,
    has_x: bool,
    iters: int = 20,
    ls_steps: int = 25,
    kappa: float = 0.0,
    start: Optional[Tuple[jax.Array, jax.Array]] = None,
):
    """Damped Newton on F(z) = 0.5 z'Hz + q'z + sum phi(violations)."""
    dtype = cqp.qf.dtype
    M, nc, nf = cqp.M, cqp.nc, cqp.nf
    Ftc, Ftf = cqp.Ft[:, :, :nc], cqp.Ft[:, :, nc:]
    alpha = jnp.asarray(alpha, dtype=dtype)
    beta = jnp.asarray(beta, dtype=dtype)

    masks = (
        jnp.isfinite(bounds.lo_c), jnp.isfinite(bounds.hi_c),
        jnp.isfinite(bounds.lo_f), jnp.isfinite(bounds.hi_f),
        jnp.isfinite(bounds.lo_x), jnp.isfinite(bounds.hi_x),
    )

    def violations(uc, uf):
        """y = a'z - b per group (lo rows: lo - v; hi rows: v - hi)."""
        x = jnp.einsum("mij,mj->mi", cqp.Ft, jnp.concatenate(
            [jnp.broadcast_to(uc, (M, nc)), uf], axis=-1)) + cqp.g
        return (
            bounds.lo_c - uc, uc - bounds.hi_c,
            bounds.lo_f - uf, uf - bounds.hi_f,
            bounds.lo_x - x, x - bounds.hi_x,
        )

    def objective(uc, uf):
        quad = 0.5 * uc @ (cqp.Hcc @ uc) + cqp.qc @ uc
        quad += jnp.sum(uf * jnp.einsum("mij,mj->mi", cqp.Hff, uf)) * 0.5
        quad += jnp.sum(jnp.einsum("mij,mj->mi", cqp.Hcf, uf) * uc)
        quad += jnp.sum(cqp.qf * uf)
        ys = violations(uc, uf)
        pen = sum(
            jnp.sum(jnp.where(m, _phi(method, jnp.where(m, y, -1.0), alpha, beta)[0], 0.0))
            for m, y in zip(masks, ys)
        )
        return quad + pen

    def newton_step(carry, _):
        uc, uf, fval = carry
        ys = violations(uc, uf)
        phis = [
            _phi(method, jnp.where(m, y, -1.0), alpha, beta) for m, y in zip(masks, ys)
        ]
        d1 = [jnp.where(m, p[1], 0.0) for m, p in zip(masks, phis)]
        d2 = [jnp.where(m, p[2], 0.0) for m, p in zip(masks, phis)]
        clo1, chi1, flo1, fhi1, xlo1, xhi1 = d1
        clo2, chi2, flo2, fhi2, xlo2, xhi2 = d2

        # gradient: Hz + q + sum phi' * a  (lo rows have a = -e, hi rows a = +e)
        gc = cqp.Hcc @ uc + jnp.einsum("mij,mj->i", cqp.Hcf, uf) + cqp.qc
        gf = jnp.einsum("mji,mj->mi", cqp.Hcf, jnp.broadcast_to(uc, (M, nc))) \
            + jnp.einsum("mij,mj->mi", cqp.Hff, uf) + cqp.qf
        if has_u:
            gc = gc + (chi1 - clo1)
            gf = gf + (fhi1 - flo1)
        if has_x:
            dx1 = xhi1 - xlo1
            gc = gc + jnp.einsum("mji,mj->i", Ftc, dx1)
            gf = gf + jnp.einsum("mji,mj->mi", Ftf, dx1)

        Kcc, Kcf, Kff = box_weighted_K(
            cqp, clo2 + chi2, flo2 + fhi2, xlo2 + xhi2,
            Ftc, Ftf, has_u=has_u, has_x=has_x,
        )
        F = arrow_factor(Kcc, Kcf, Kff, jitter=kappa)
        duc, duf = arrow_apply(F, -gc, -gf)

        # backtracking linesearch (handles +inf outside logbarrier domain)
        def ls_body(k, best):
            t = 0.5 ** k
            f_t = objective(uc + t * duc, uf + t * duf)
            better = f_t < best[0]
            return (jnp.where(better, f_t, best[0]), jnp.where(better, t, best[1]))

        f_best, t_best = lax.fori_loop(0, ls_steps, ls_body,
                                       (fval, jnp.asarray(0.0, dtype)))
        uc_n = uc + t_best * duc
        uf_n = uf + t_best * duf
        return (uc_n, uf_n, f_best), jnp.max(jnp.abs(t_best * duc)) if nc else t_best

    if start is None:
        uc0 = jnp.mean(cqp.w_prev[:, :nc], axis=0)
        uf0 = cqp.w_prev[:, nc:]
    else:
        uc0, uf0 = start
    f0 = objective(uc0, uf0)
    (uc, uf, fval), _ = lax.scan(newton_step, (uc0, uf0, f0), None, length=iters)
    return uc, uf, dict(obj=fval)


#: stable function object per cloudpickle byte-hash: jit keys static callables
#: by IDENTITY, so a fresh diff_cost_fn closure per SCP iteration would
#: recompile every call — equal-code closures are canonicalized to one object
_FN_REGISTRY: Dict[bytes, Any] = {}


def canonical_fn(fn):
    """Return a stable equivalent of ``fn`` keyed by its cloudpickle bytes
    (parity with the reference's fn-hash solver registry,
    ``solver_definitions.py:92-105`` / ``remote.py:41-55``)."""
    if fn is None:
        return None
    try:
        import hashlib

        import cloudpickle

        key = hashlib.sha256(cloudpickle.dumps(fn)).digest()
    except Exception:
        return fn
    return _FN_REGISTRY.setdefault(key, fn)


@partial(jax.jit, static_argnames=("method", "has_u", "has_x", "iters", "extra_obj",
                                   "N", "xdim", "udim", "memory_size"))
@with_matmul_precision("highest")
def lbfgs_core(
    cqp: CondensedQP,
    bounds: BoxBounds,
    method: str,
    alpha,
    beta,
    has_u: bool,
    has_x: bool,
    iters: int = 100,
    extra_obj=None,
    N: int = 0,
    xdim: int = 0,
    udim: int = 0,
    memory_size: int = 10,
):
    """L-BFGS on the smoothed objective (optax), role parity with the reference
    experimental solvers BFGS/LBFGS (``solver_definitions.py:25-28,137-145``).
    Slower than the Newton path; kept for API compatibility
    (``solver_settings={"solver": "LBFGS"}`` on the smooth path)."""
    import optax

    dtype = cqp.qf.dtype
    M, nc, nf = cqp.M, cqp.nc, cqp.nf
    alpha = jnp.asarray(alpha, dtype=dtype)
    beta = jnp.asarray(beta, dtype=dtype)

    masks = (
        jnp.isfinite(bounds.lo_c), jnp.isfinite(bounds.hi_c),
        jnp.isfinite(bounds.lo_f), jnp.isfinite(bounds.hi_f),
        jnp.isfinite(bounds.lo_x), jnp.isfinite(bounds.hi_x),
    )

    def violations(uc, uf):
        x = jnp.einsum("mij,mj->mi", cqp.Ft, jnp.concatenate(
            [jnp.broadcast_to(uc, (M, nc)), uf], axis=-1)) + cqp.g
        return (
            bounds.lo_c - uc, uc - bounds.hi_c,
            bounds.lo_f - uf, uf - bounds.hi_f,
            bounds.lo_x - x, x - bounds.hi_x,
        )

    def objective(params):
        uc, uf = params
        quad = 0.5 * uc @ (cqp.Hcc @ uc) + cqp.qc @ uc
        quad += jnp.sum(uf * jnp.einsum("mij,mj->mi", cqp.Hff, uf)) * 0.5
        quad += jnp.sum(jnp.einsum("mij,mj->mi", cqp.Hcf, uf) * uc)
        quad += jnp.sum(cqp.qf * uf)
        pen = sum(
            jnp.sum(jnp.where(m, _phi(method, jnp.where(m, y, -1.0), alpha, beta)[0], 0.0))
            for m, y in zip(masks, violations(uc, uf))
        )
        if extra_obj is not None:
            # additive differentiable cost over the trajectory (parity with
            # the experimental diff_cost_fn, jax_solver.py:126-137)
            w = jnp.concatenate([jnp.broadcast_to(uc, (M, nc)), uf], axis=-1)
            X = (jnp.einsum("mij,mj->mi", cqp.Ft, w) + cqp.g).reshape(M, N, xdim)
            U = w.reshape(M, N, udim)
            pen = pen + extra_obj(X, U)
        return quad + pen

    # memory_size = iters emulates full-memory BFGS (the "BFGS" solver name)
    opt = optax.lbfgs(memory_size=memory_size)
    params = (jnp.mean(cqp.w_prev[:, :nc], axis=0), cqp.w_prev[:, nc:])
    state = opt.init(params)
    value_and_grad = optax.value_and_grad_from_state(objective)

    def step(carry, _):
        params, state = carry
        value, grad = value_and_grad(params, state=state)
        updates, state = opt.update(grad, state, params,
                                    value=value, grad=grad, value_fn=objective)
        params = optax.apply_updates(params, updates)
        return (params, state), None

    (params, state), _ = lax.scan(step, (params, state), None, length=iters)
    uc, uf = params
    return uc, uf, dict(obj=objective(params))


import functools


@functools.lru_cache(maxsize=64)
def _dense_objective_fn(method: str, extra_obj, M: int, N: int, xdim: int,
                        udim: int, nc: int):
    """Cached module-level smoothed objective over the stacked z (dense
    CVX/SQP solvers). All problem data arrives as traced args so repeated
    calls with fresh arrays hit the jit cache."""
    nf = N * udim - nc

    def objective(z, Hcc, Hcf, Hff, qc, qf, Ft, g,
                  lo_c, hi_c, lo_f, hi_f, lo_x, hi_x, alpha, beta):
        uc = z[:nc]
        uf = z[nc:].reshape(M, nf)
        quad = 0.5 * uc @ (Hcc @ uc) + qc @ uc
        quad += jnp.sum(uf * jnp.einsum("mij,mj->mi", Hff, uf)) * 0.5
        quad += jnp.sum(jnp.einsum("mij,mj->mi", Hcf, uf) * uc)
        quad += jnp.sum(qf * uf)
        w = jnp.concatenate([jnp.broadcast_to(uc, (M, nc)), uf], axis=-1)
        x = jnp.einsum("mij,mj->mi", Ft, w) + g
        pen = jnp.asarray(0.0, z.dtype)
        for lo, hi, v in ((lo_c, hi_c, uc), (lo_f, hi_f, uf), (lo_x, hi_x, x)):
            for mask, y in ((jnp.isfinite(lo), lo - v), (jnp.isfinite(hi), v - hi)):
                pen += jnp.sum(jnp.where(
                    mask, _phi(method, jnp.where(mask, y, -1.0), alpha, beta)[0], 0.0))
        if extra_obj is not None:
            pen += extra_obj(x.reshape(M, N, xdim), w.reshape(M, N, udim))
        return quad + pen

    return objective


def barrier_solve_np(
    base_args, reg_args, u_l, u_u, x_l, x_u,
    Nc: int,
    weights=None,
    method: str = "logbarrier",
    alpha: float = 1.0,
    beta: float = 1.0,
    settings: Optional[Dict[str, Any]] = None,
    extra_obj=None,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """numpy frontend for the smooth-barrier Newton path."""
    settings = settings or {}
    f = base_args[1]
    M, N = f.shape[0], f.shape[1]
    udim = base_args[3].shape[-1]
    xdim = f.shape[-1]
    dtype = np.dtype(np.asarray(f).dtype)

    cqp = assemble_condensed(
        *base_args, *reg_args, Nc=Nc, weights=weights,
        scale_slew_target=bool(settings.get("weights_scale_slew_target", True)))
    nc, nf = Nc * udim, (N - Nc) * udim
    bounds = _layout_bounds(u_l, u_u, x_l, x_u, M, N, N * xdim, nc, nf, udim, dtype)
    has_u = u_l is not None or u_u is not None
    has_x = x_l is not None or x_u is not None

    solver_name = str(settings.get("solver", "")).upper()
    extra_obj = canonical_fn(extra_obj)

    if solver_name in ("CVX", "SQP"):
        # dense second-order solvers over the stacked variable (registry
        # parity with solver_definitions.py SOLVER_CVX / SOLVER_SQP)
        from .second_order import dense_newton_solve

        obj_z = _dense_objective_fn(method, extra_obj, M, N, xdim, udim, nc)
        obj_args = (cqp.Hcc, cqp.Hcf, cqp.Hff, cqp.qc, cqp.qf, cqp.Ft, cqp.g,
                    bounds.lo_c, bounds.hi_c, bounds.lo_f, bounds.hi_f,
                    bounds.lo_x, bounds.hi_x,
                    jnp.asarray(alpha, dtype), jnp.asarray(beta, dtype))
        z0 = np.concatenate(
            [np.mean(np.asarray(cqp.w_prev)[:, :nc], axis=0),
             np.asarray(cqp.w_prev)[:, nc:].reshape(-1)])
        z, obj = dense_newton_solve(
            obj_z, jnp.asarray(z0, dtype), obj_args,
            iters=int(settings.get("newton_iters", 30)),
            ls_steps=int(settings.get("ls_steps", 25)),
            regularized=solver_name == "SQP",
        )
        z = np.asarray(z)
        uc, uf = jnp.asarray(z[:nc]), jnp.asarray(z[nc:].reshape(M, nf))
        X, U = recover_XU(cqp, uc, uf, N=N)
        return (np.asarray(X), np.asarray(U),
                dict(solver_state=settings.get("solver_state"), obj=float(obj)))

    if extra_obj is not None or solver_name in ("BFGS", "LBFGS"):
        # arbitrary additive costs need a general smooth solver: L-BFGS
        iters = int(settings.get("max_it", 100 if extra_obj is None else 200))
        uc, uf, stats = lbfgs_core(
            cqp, bounds, method=method, alpha=alpha, beta=beta,
            has_u=has_u, has_x=has_x,
            iters=iters,
            extra_obj=extra_obj, N=N, xdim=xdim, udim=udim,
            memory_size=iters if solver_name == "BFGS" else 10,
        )
        X, U = recover_XU(cqp, uc, uf, N=N)
        return (np.asarray(X), np.asarray(U),
                dict(solver_state=settings.get("solver_state"), obj=float(stats["obj"])))

    kappa = float(settings.get("ipm_kappa", 0.0 if dtype == np.float64 else 1e-7))
    # warm start from the exact box-QP solution: the smoothed optimum is a
    # small perturbation of it, and the Newton then converges in a few steps
    from .ipm import ipm_core

    uc0, uf0, _ = ipm_core(
        cqp, bounds, has_u=has_u, has_x=has_x,
        iters=int(settings.get("ipm_iters", 30)),
        tol_exp=int(settings.get("ipm_tol_exp", -8 if dtype == np.float64 else -5)),
        kappa=kappa,
    )
    uc, uf, stats = barrier_core(
        cqp, bounds, method=method,
        alpha=alpha, beta=beta, has_u=has_u, has_x=has_x,
        iters=int(settings.get("newton_iters", 20)),
        ls_steps=int(settings.get("ls_steps", 25)),
        kappa=kappa,
        start=(uc0, uf0),
    )
    X, U = recover_XU(cqp, uc, uf, N=N)
    data = dict(solver_state=settings.get("solver_state"), obj=float(stats["obj"]))
    return np.asarray(X), np.asarray(U), data


# -- stage-structured (riccati) smooth Newton --------------------------------------


def _riccati_consensus_raw(x0s, c, A, B, Qt, xt, Rt, ut, Nc: int):
    """O(N) consensus LQR on RAW per-particle stage terms (leading M axis).

    Same theta-sweep as `riccati.riccati_consensus_solve`, but the caller
    supplies the stage cost terms directly — the smooth-Newton subproblem
    modifies Qt/xt/Rt/ut per iteration (curvature/gradient of the penalty)."""
    from functools import partial as _partial

    from .riccati import _theta_backward, _theta_forward
    from ..ops.linalg import psd_solve as _psd

    S, s, gains = jax.vmap(_partial(_theta_backward, Nc=Nc))(
        x0s, c, A, B, Qt, xt, Rt, ut)
    S_tot = jnp.sum(S, axis=0)
    s_tot = jnp.sum(s, axis=0)
    theta = -_psd(S_tot, s_tot) if S_tot.shape[-1] else s_tot
    X, U = jax.vmap(lambda x0_, c_, A_, B_, g:
                    _theta_forward(x0_, c_, A_, B_, theta, g))(
        x0s, c, A, B, gains)
    return X, U


@partial(jax.jit, static_argnames=("method", "has_u", "has_x", "has_slew",
                                   "Nc", "iters", "ls_steps"))
@with_matmul_precision("highest")
def riccati_barrier_core(
    x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref, reg_x, reg_u,
    u_l, u_u, x_l, x_u,
    Nc: int,
    method: str,
    alpha,
    beta,
    has_u: bool,
    has_x: bool,
    has_slew: bool = False,
    slew_reg=None,
    slew_reg0=None,
    slew_um1=None,
    iters: int = 25,
    ls_steps: int = 25,
):
    """Damped Newton on the smoothed box problem with O(N) riccati solves.

    The Newton subproblem around (X, U) is ITSELF a stage-diagonal LQR: the
    penalty curvature phi'' lands on the Qt/Rt diagonals and phi' in the
    stage linear terms, so each Newton step is one consensus theta-sweep —
    the long-horizon route for ``smooth_cstr="squareplus"`` (the last
    constraint class without an O(N) path; round-5 task #7). The damped
    update z + t dz stays dynamics-feasible for every t because the
    constraint is affine and both endpoints satisfy it. Reference smoothing
    semantics: ``cone_utils.jl:204-232`` squareplus reformulation.

    Single flat (M, N, ...) problem; vmap over a scenario batch.
    """
    from .riccati import _scp_stage_terms, augment_slew_stages

    dtype = f.dtype
    M, N, xdim = f.shape
    udim = fu.shape[-1]
    alpha = jnp.asarray(alpha, dtype)
    beta = jnp.asarray(beta, dtype)

    c, Qt, xt, Rt, ut = jax.vmap(_scp_stage_terms)(
        x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref, reg_x, reg_u)
    A, B = fx, fu
    x0s = x0
    if has_slew:
        x0s, c, A, B, Qt, xt = jax.vmap(augment_slew_stages)(
            x0, c, A, B, Qt, xt, slew_reg, slew_reg0, slew_um1)
    na = c.shape[-1]  # xdim or xdim + 2 udim

    # consensus-stage controls are SHARED variables: their box rows exist
    # once, with particle 0's bounds (lqp_utils.jl:323-331 convention, same
    # as the condensed layout) — penalizing them per particle would scale
    # the smoothing force by M on the shared block
    keep = ((jnp.arange(N) >= Nc)[None, :, None]
            | (jnp.arange(M) == 0)[:, None, None])
    m_ulo = (jnp.isfinite(u_l) & keep) if has_u \
        else jnp.zeros_like(u_l, bool)
    m_uhi = (jnp.isfinite(u_u) & keep) if has_u \
        else jnp.zeros_like(u_u, bool)
    m_xlo = jnp.isfinite(x_l) if has_x else jnp.zeros_like(x_l, bool)
    m_xhi = jnp.isfinite(x_u) if has_x else jnp.zeros_like(x_u, bool)

    def penalty(Xr, U):
        pen = jnp.asarray(0.0, dtype)
        for m, y in ((m_ulo, u_l - U), (m_uhi, U - u_u),
                     (m_xlo, x_l - Xr), (m_xhi, Xr - x_u)):
            pen += jnp.sum(jnp.where(
                m, _phi(method, jnp.where(m, y, -1.0), alpha, beta)[0], 0.0))
        return pen

    def quad(Xa, U):
        # base stage cost on the (possibly augmented) trajectory
        v = 0.5 * jnp.einsum("mni,mnij,mnj->", Xa, Qt, Xa) \
            - jnp.einsum("mni,mni->", xt, Xa)
        v += 0.5 * jnp.einsum("mni,mnij,mnj->", U, Rt, U) \
            - jnp.einsum("mni,mni->", ut, U)
        return v

    def objective(Xa, U):
        return quad(Xa, U) + penalty(Xa[..., :xdim], U)

    # start: the equality-only consensus solve
    X0a, U0 = _riccati_consensus_raw(x0s, c, A, B, Qt, xt, Rt, ut, Nc)

    def newton_step(carry, _):
        Xa, U, fval = carry
        Xr = Xa[..., :xdim]
        d1u = d2u = jnp.zeros_like(U)
        d1x = d2x = jnp.zeros_like(Xr)
        if has_u:
            plo = _phi(method, jnp.where(m_ulo, u_l - U, -1.0), alpha, beta)
            phi_ = _phi(method, jnp.where(m_uhi, U - u_u, -1.0), alpha, beta)
            d1u = jnp.where(m_uhi, phi_[1], 0.0) - jnp.where(m_ulo, plo[1], 0.0)
            d2u = jnp.where(m_ulo, plo[2], 0.0) + jnp.where(m_uhi, phi_[2], 0.0)
        if has_x:
            plo = _phi(method, jnp.where(m_xlo, x_l - Xr, -1.0), alpha, beta)
            phi_ = _phi(method, jnp.where(m_xhi, Xr - x_u, -1.0), alpha, beta)
            d1x = jnp.where(m_xhi, phi_[1], 0.0) - jnp.where(m_xlo, plo[1], 0.0)
            d2x = jnp.where(m_xlo, plo[2], 0.0) + jnp.where(m_xhi, phi_[2], 0.0)

        eye_u = jnp.eye(udim, dtype=dtype)
        Rt_n = Rt + d2u[..., :, None] * eye_u
        ut_n = ut + d2u * U - d1u
        Qt_n = Qt
        xt_n = xt
        if has_x:
            pad = jnp.zeros((M, N, na), dtype).at[..., :xdim].set(d2x)
            eye_a = jnp.eye(na, dtype=dtype)
            Qt_n = Qt + pad[..., :, None] * eye_a
            xt_n = xt + jnp.zeros((M, N, na), dtype).at[..., :xdim].set(
                d2x * Xr - d1x)

        Xn, Un = _riccati_consensus_raw(x0s, c, A, B, Qt_n, xt_n, Rt_n, ut_n,
                                        Nc)
        dX, dU = Xn - Xa, Un - U

        def ls_body(k, best):
            t = 0.5 ** k
            f_t = objective(Xa + t * dX, U + t * dU)
            better = f_t < best[0]
            return (jnp.where(better, f_t, best[0]),
                    jnp.where(better, t, best[1]))

        f_best, t_best = lax.fori_loop(
            0, ls_steps, ls_body, (fval, jnp.asarray(0.0, dtype)))
        return (Xa + t_best * dX, U + t_best * dU, f_best), None

    f0 = objective(X0a, U0)
    (Xa, U, fval), _ = lax.scan(newton_step, (X0a, U0, f0), None,
                                length=iters)
    return Xa[..., :xdim], U, dict(obj=fval)


def riccati_barrier_solve_np(
    base_args, reg_args, u_l, u_u, x_l, x_u,
    Nc: int,
    method: str = "squareplus",
    alpha: float = 1.0,
    beta: float = 1.0,
    settings: Optional[Dict[str, Any]] = None,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """numpy frontend for the riccati smooth-Newton path (squareplus at long
    horizon; dispatched when method='riccati' or the auto-N route fires)."""
    settings = settings or {}
    (x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref) = base_args
    (reg_x, reg_u, slew_reg, slew_reg0, slew_um1) = reg_args
    f_np = np.asarray(f)
    M, N = f_np.shape[0], f_np.shape[1]
    udim = np.asarray(fu).shape[-1]
    xdim = f_np.shape[-1]
    dtype = np.dtype(f_np.dtype)
    inf = np.inf

    has_u = u_l is not None or u_u is not None
    has_x = x_l is not None or x_u is not None
    has_slew = bool(np.any(np.asarray(slew_reg) != 0)
                    or np.any(np.asarray(slew_reg0) != 0))

    def bnd(b, d, fill):
        if b is None:
            return jnp.full((M, N, d), fill, dtype)
        return jnp.asarray(np.broadcast_to(
            np.asarray(b, dtype).reshape(-1, N, d), (M, N, d)))

    X, U, stats = riccati_barrier_core(
        *[jnp.asarray(a) for a in base_args],
        jnp.asarray(reg_x), jnp.asarray(reg_u),
        bnd(u_l, udim, -inf), bnd(u_u, udim, inf),
        bnd(x_l, xdim, -inf), bnd(x_u, xdim, inf),
        Nc=Nc, method=method, alpha=alpha, beta=beta,
        has_u=has_u, has_x=has_x, has_slew=has_slew,
        slew_reg=jnp.asarray(slew_reg), slew_reg0=jnp.asarray(slew_reg0),
        slew_um1=jnp.asarray(slew_um1),
        iters=int(settings.get("newton_iters", 25)),
        ls_steps=int(settings.get("ls_steps", 25)),
    )
    return (np.asarray(X), np.asarray(U),
            dict(solver_state=settings.get("solver_state"),
                 obj=float(stats["obj"])))
