"""Fully on-device SCP: the whole linearize->solve->reroll loop under one jit.

This is the throughput path that replaces the reference's host-driven loop
(``pmpc/scp_mpc.py:337-428`` calls a Python/torch callback and a CPU solver
every iteration; its experimental GPU clone ``pmpc/experimental/jax_solver.py``
still runs the outer loop in Python). Here the SCP iteration is a
``lax.scan`` body: dynamics linearization (JAX dynamics protocol), condensed
consensus assembly, arrow/IPM solve, residual bookkeeping — one XLA program,
no host round-trips, vmappable over a scenario batch and shardable over a
device mesh.

Usage:
    solver = build_scp_solver(dynamics, N=30, xdim=4, udim=2, M=32, Nc=5,
                              max_it=12, has_u_bounds=True)
    X, U, info = solver(prob)          # prob: SCPData of (M, ...) arrays
    batched = jax.vmap(solver)         # (B, M, ...) scenario batch
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .dynamics import linearize
from .solvers.ipm import BoxBounds, ipm_core
from .solvers.reduced import assemble_condensed, recover_XU, solve_eq
from .utils import with_matmul_precision


class SCPData(NamedTuple):
    """One joint M-particle SCP problem instance (all arrays, leading M axis)."""

    x0: jax.Array  # (M, xdim)
    Q: jax.Array  # (M, N, xdim, xdim)
    R: jax.Array  # (M, N, udim, udim)
    X_ref: jax.Array  # (M, N, xdim)
    U_ref: jax.Array  # (M, N, udim)
    X_prev: jax.Array  # (M, N, xdim)
    U_prev: jax.Array  # (M, N, udim)
    reg_x: jax.Array  # (M,)
    reg_u: jax.Array  # (M,)
    slew_reg: jax.Array  # (M,)
    slew_reg0: jax.Array  # (M,)
    slew_um1: jax.Array  # (M, udim)
    u_l: jax.Array  # (M, N, udim)  (+-inf where absent)
    u_u: jax.Array  # (M, N, udim)
    x_l: jax.Array  # (M, N, xdim)
    x_u: jax.Array  # (M, N, xdim)
    params: Any = None  # optional per-particle dynamics params pytree
    u_soc_r: Any = None  # (M, N) per-stage control-norm radii (+inf = no cone)


def make_scp_data(
    x0, Q, R,
    X_ref=None, U_ref=None, X_prev=None, U_prev=None,
    reg_x=1.0, reg_u=1e-2, slew_reg=0.0, slew_reg0=0.0, slew_um1=None,
    u_l=None, u_u=None, x_l=None, x_u=None, params=None, u_soc_r=None, dtype=None,
) -> SCPData:
    """Convenience constructor with reference-compatible defaults."""
    x0 = jnp.asarray(x0, dtype=dtype)
    Q, R = jnp.asarray(Q, dtype=dtype), jnp.asarray(R, dtype=dtype)
    M, N, xdim = Q.shape[:3]
    udim = R.shape[-1]
    dt = Q.dtype

    def arr(v, shape, fill=0.0):
        if v is None:
            return jnp.full(shape, fill, dtype=dt)
        return jnp.broadcast_to(jnp.asarray(v, dtype=dt), shape)

    X_ref = arr(X_ref, (M, N, xdim))
    U_ref = arr(U_ref, (M, N, udim))
    return SCPData(
        x0=x0,
        Q=Q, R=R, X_ref=X_ref, U_ref=U_ref,
        X_prev=arr(X_prev, (M, N, xdim)) if X_prev is not None else X_ref,
        U_prev=arr(U_prev, (M, N, udim)) if U_prev is not None else U_ref,
        reg_x=arr(reg_x, (M,)), reg_u=arr(reg_u, (M,)),
        slew_reg=arr(slew_reg, (M,)), slew_reg0=arr(slew_reg0, (M,)),
        slew_um1=arr(slew_um1, (M, udim)),
        u_l=arr(u_l, (M, N, udim), -jnp.inf), u_u=arr(u_u, (M, N, udim), jnp.inf),
        x_l=arr(x_l, (M, N, xdim), -jnp.inf), x_u=arr(x_u, (M, N, xdim), jnp.inf),
        params=params,
        u_soc_r=arr(u_soc_r, (M, N), jnp.inf) if u_soc_r is not None else None,
    )


def build_scp_solver(
    dynamics: Callable,
    N: int,
    xdim: int,
    udim: int,
    M: int,
    Nc: int = -1,
    max_it: int = 10,
    res_tol: float = 1e-5,
    has_u_bounds: bool = False,
    has_x_bounds: bool = False,
    ipm_iters: int = 20,
    ipm_tol_exp: Optional[int] = None,
    mu_target: float = 0.0,
    kappa: Optional[float] = None,
    lin_cost_fn: Optional[Callable] = None,
    warm_start: bool = True,
    jit: bool = True,
    collect_stats: bool = False,
    adaptive_tol: bool = True,
    adaptive_cap: float = 3e-2,
    ipm_gondzio: int = 0,
    ipm_predictor: bool = True,
    ipm_tau: Optional[float] = None,
    has_u_soc: bool = False,
    method: str = "condensed",
    has_slew: bool = False,
    return_state: bool = False,
    accel: str = "",
    accel_window: int = 5,
    accel_it0: int = 2,
    accel_wmax: float = 50.0,
    relin_stale: int = 0,
    riccati_unroll: Optional[int] = None,
) -> Callable:
    """Build a jitted end-to-end SCP solver for fixed problem dimensions.

    Args:
        dynamics: JAX step fn ``f(x, u)`` or ``f(x, u, p)`` when ``SCPData.params``
            is provided (p is the per-particle leaf, vmapped over M).
        Nc: consensus horizon; -1 means full consensus (reference default,
            ``main.jl:127``).
        has_u_bounds / has_x_bounds: static switches; when False the bound
            arrays in SCPData are ignored and the direct arrow solve is used
            when both are False.
        lin_cost_fn: optional JAX fn (X_prev, U_prev, data) -> (cx, cu) for
            nonconvex cost linearization (parity with ``scp_mpc.py:171-185``).
        accel: "" (plain fixed-point iteration) or "AA" — Anderson
            acceleration of the SCP fixed point INSIDE the device loop: the
            next linearization point is the affine combination of the last
            ``accel_window`` subproblem solutions whose weights solve the
            Tikhonov-regularized residual least squares (Type-II AA, the
            device twin of the host loop's ``filter_method="AA"``,
            role parity with ``pmpc/scp_mpc.py:37-62``). The RETURNED
            solution is always the last accepted raw subproblem solution
            (bound-feasible); acceleration only steers the linearization
            point, so the converged fixed point is unchanged.
        accel_it0: first iteration index at which acceleration engages.
        accel_wmax: safeguard — fall back to the plain iterate whenever the
            combination's total weight mass exceeds this (an exploding
            extrapolation signals a locally nonlinear map).
        relin_stale: number of STALE-JACOBIAN sub-iterations after each
            fresh one (condensed method only): the stale sub-steps reuse
            (f, fx, fu) and the Hessian blocks, so their assembly is only
            the q-vector refresh (`reduced.update_condensed_linear`). The
            iteration counter counts sub-steps, so `max_it` still bounds
            total subproblem solves (the while_loop checks between
            super-iterations, so the cap can overshoot by relin_stale).

    Returns:
        solver(data: SCPData) -> (X (M,N+1,xdim), U (M,N,udim), info dict)
    """
    Nc = Nc if Nc >= 0 else N
    if M == 1:
        Nc = 0  # single particle: consensus is a no-op; keep stage structure
    has_bounds = has_u_bounds or has_x_bounds or has_u_soc
    if method not in ("condensed", "riccati", "priccati"):
        raise ValueError(f"unknown method {method!r}")
    if method == "priccati" and (has_x_bounds or has_u_soc):
        raise NotImplementedError(
            "method='priccati' does not support state boxes or SOC cones; "
            "use method='riccati'")
    # unroll=8 at long N: a partly unrolled Riccati sweep (compile and warm
    # time of the choice on the card are not measured yet)
    _runroll = riccati_unroll if riccati_unroll is not None \
        else (8 if N >= 64 else 1)
    if relin_stale and method != "condensed":
        raise ValueError(
            "relin_stale (stale-Jacobian sub-iterations) is only supported "
            "with method='condensed'")
    if not ipm_predictor and method != "condensed":
        # the single-solve (LOQO-sigma) mode only exists in the condensed
        # arrow IPM; the riccati stage-structured IPM always runs Mehrotra —
        # silently ignoring the flag would misreport the A/B being requested
        raise ValueError(
            "ipm_predictor=False is only supported with method='condensed' "
            "(the riccati IPM has no single-solve mode)")

    def linearize_particles(data: SCPData, X_prev, U_prev):
        X_ = jnp.concatenate([data.x0[:, None, :], X_prev[:, :-1, :]], axis=1)
        if data.params is None:
            return linearize(dynamics, X_, U_prev)

        def one(x0_, u_, p_):
            return linearize(lambda x, u: dynamics(x, u, p_), x0_, u_)

        return jax.vmap(one)(X_, U_prev, data.params)

    if accel not in ("", "AA"):
        raise ValueError(f"unknown accel {accel!r} (use '' or 'AA')")
    AW = int(accel_window)
    n_flat = M * N * (xdim + udim)

    def _aa_combine(histF, histZ, nh, Fk, Zk):
        """Type-II Anderson weights over the valid window (masked fixed-size
        buffers; the (AW-1)^2 normal system is tiny). Returns the combined
        flat iterate and its total weight mass."""
        dt = Fk.dtype
        valid = (jnp.arange(AW - 1) >= (AW - nh)).astype(dt)  # older slots
        D = (histF[:-1] - Fk[None, :]) * valid[:, None]  # (AW-1, n_flat)
        G = D @ D.T
        rhs = -(D @ Fk)
        eps = jnp.asarray(1e-6, dt) * (jnp.trace(G) / (AW - 1) + 1e-30)
        theta = jnp.linalg.solve(G + eps * jnp.eye(AW - 1, dtype=dt), rhs)
        theta = theta * valid
        w_last = 1.0 - jnp.sum(theta)
        Z_acc = theta @ histZ[:-1] + w_last * Zk
        wmass = jnp.sum(jnp.abs(theta)) + jnp.abs(w_last)
        return Z_acc, wmass

    def iteration(data: SCPData, carry, _):
        f, fx, fu = linearize_particles(data, carry[0], carry[1])
        carry, ys, cqp = _sub_iteration(data, carry, f, fx, fu, None)
        # stale-Jacobian sub-iterations: reuse (f, fx, fu) — Ft and every
        # Hessian block are loop-invariant, so the sub-step's assembly is
        # only the ft rollout + q chain (~0.1 ms vs ~5 ms at headline
        # shapes; see reduced.update_condensed_linear). At the fixed point
        # a stale subproblem equals the fresh one, so the converged point
        # and the step-size convergence test are unchanged.
        for _ in range(relin_stale):
            carry, ys, cqp = _sub_iteration(data, carry, f, fx, fu, cqp)
        return carry, ys

    def _sub_iteration(data: SCPData, carry, f, fx, fu, cqp_prev):
        X_prev, U_prev, it, done, resid, resid_m, warm, acc = carry

        X_ref, U_ref = data.X_ref, data.U_ref
        if lin_cost_fn is not None:
            cx, cu = lin_cost_fn(X_prev, U_prev, data)
            if cx is not None:
                X_ref = X_ref - jnp.linalg.solve(data.Q, cx[..., None])[..., 0]
            if cu is not None:
                U_ref = U_ref - jnp.linalg.solve(data.R, cu[..., None])[..., 0]

        if method in ("riccati", "priccati"):
            # O(N) stage-structured consensus solve: no O(N^2) Ft, the
            # consensus Schur complement is a per-particle theta-quadratic sum.
            # 'priccati' runs the sweeps as associative scans (O(log N) depth).
            # Slew coupling is expressible via state augmentation
            # (riccati.augment_slew_stages) behind the STATIC has_slew flag
            # (the augmented sweep costs (xdim+2 udim)^3 per stage, so it is
            # opt-in); when the flag is off but the data carries slew terms, a
            # silent drop would return wrong solutions — poison the result
            # instead (the NaN contract freezes the iterate and reports
            # not-converged).
            slew_kw = {}
            if has_slew:
                poison = jnp.ones((), data.Q.dtype)
                slew_kw = dict(slew_reg=data.slew_reg,
                               slew_reg0=data.slew_reg0,
                               slew_um1=data.slew_um1)
            else:
                slew_present = (jnp.max(data.slew_reg) > 0) | \
                    (jnp.max(data.slew_reg0) > 0)
                poison = jnp.where(slew_present, jnp.nan,
                                   1.0).astype(data.Q.dtype)
            if has_bounds:
                from .solvers.riccati_ipm import riccati_ipm_solve_scp

                dt = data.Q.dtype
                dflt_tol = -8 if dt == jnp.float64 else -6
                dflt_kappa = 0.0 if dt == jnp.float64 else 1e-7
                tol_dyn = None
                if adaptive_tol:
                    r = jnp.minimum(resid, 1e3)
                    tol_dyn = jnp.clip(1e-3 * r * r, 0.0,
                                       adaptive_cap).astype(dt)
                xbox_kw = {}
                if has_x_bounds:
                    xbox_kw = dict(x_l=data.x_l, x_u=data.x_u)
                if has_u_soc:
                    xbox_kw["u_soc_r"] = data.u_soc_r
                u_l = data.u_l if has_u_bounds else \
                    jnp.full_like(data.u_l, -jnp.inf)
                u_u = data.u_u if has_u_bounds else \
                    jnp.full_like(data.u_u, jnp.inf)
                X, U, stats = riccati_ipm_solve_scp(
                    data.x0, f, fx, fu, X_prev, U_prev, data.Q, data.R,
                    X_ref, U_ref, data.reg_x, data.reg_u,
                    u_l, u_u, Nc=Nc,
                    iters=ipm_iters,
                    tol_exp=ipm_tol_exp if ipm_tol_exp is not None else dflt_tol,
                    kappa=kappa if kappa is not None else dflt_kappa,
                    warm=warm, tol_dynamic=tol_dyn, tau=ipm_tau,
                    scan_unroll=_runroll, **slew_kw,
                    **xbox_kw)
                if warm_start:
                    warm_new = (stats["theta"], stats["uf"],
                                stats["s"], stats["lam"])
                    if has_u_soc:
                        warm_new = warm_new + (stats["sq"], stats["zq"])
                else:
                    warm_new = warm
            else:
                if method == "priccati":
                    from .solvers.priccati import (
                        priccati_consensus_solve as _consensus)
                else:
                    from .solvers.riccati import (
                        riccati_consensus_solve as _consensus)

                if method == "priccati" and has_slew:
                    raise NotImplementedError(
                        "method='priccati' does not support slew coupling; "
                        "use method='riccati'")
                X, U = _consensus(
                    data.x0, f, fx, fu, X_prev, U_prev, data.Q, data.R,
                    X_ref, U_ref, data.reg_x, data.reg_u, Nc=Nc, **slew_kw)
                warm_new = warm
                stats = None
            X = X * poison
            U = U * poison
        else:
            if cqp_prev is None:
                cqp = assemble_condensed(
                    data.x0, f, fx, fu, X_prev, U_prev, data.Q, data.R,
                    X_ref, U_ref,
                    data.reg_x, data.reg_u, data.slew_reg, data.slew_reg0,
                    data.slew_um1, Nc=Nc,
                )
            else:
                from .solvers.reduced import update_condensed_linear

                cqp = update_condensed_linear(
                    cqp_prev, X_prev, U_prev, data.Q, data.R, X_ref, U_ref,
                    data.reg_x, data.reg_u, data.slew_reg0, data.slew_um1)
            if has_bounds:
                nc = Nc * udim
                dt = cqp.qf.dtype
                ul = data.u_l.reshape(M, N * udim)
                uu = data.u_u.reshape(M, N * udim)
                bounds = BoxBounds(
                    lo_c=ul[0, :nc], hi_c=uu[0, :nc],
                    lo_f=ul[:, nc:], hi_f=uu[:, nc:],
                    lo_x=data.x_l.reshape(M, N * xdim),
                    hi_x=data.x_u.reshape(M, N * xdim),
                )
                dflt_tol = -8 if dt == jnp.float64 else -6
                dflt_kappa = 0.0 if dt == jnp.float64 else 1e-7
                # inexact-Newton forcing: early SCP iterations (large residual)
                # only need a loose subproblem solve — the tolerance tightens
                # quadratically with the SCP residual down to the static floor
                tol_dyn = None
                if adaptive_tol:
                    r = jnp.minimum(resid, 1e3)  # resid starts at +inf
                    tol_dyn = jnp.clip(1e-3 * r * r, 0.0,
                                       adaptive_cap).astype(dt)
                socs = None
                if has_u_soc:
                    from .solvers.ipm import SocSpec

                    socs = SocSpec(r_c=data.u_soc_r[0, :Nc],
                                   r_f=data.u_soc_r[:, Nc:])
                uc, uf, stats = ipm_core(
                    cqp, bounds, has_u=has_u_bounds, has_x=has_x_bounds,
                    iters=ipm_iters,
                    tol_exp=ipm_tol_exp if ipm_tol_exp is not None else dflt_tol,
                    kappa=kappa if kappa is not None else dflt_kappa,
                    mu_target=mu_target,
                    warm=warm,
                    tol_dynamic=tol_dyn,
                    tau=ipm_tau,
                    socs=socs, has_soc=has_u_soc,
                    gondzio=ipm_gondzio,
                    predictor=ipm_predictor,
                )
                if warm_start:
                    warm_new = (uc, uf, stats["s"], stats["lam"])
                    if has_u_soc:
                        warm_new = warm_new + (stats["sq"], stats["zq"])
                else:
                    warm_new = warm
            else:
                uc, uf = solve_eq(cqp)
                warm_new = warm
                stats = None
            X, U = recover_XU(cqp, uc, uf, N=N)

        dX, dU = X - X_prev, U - U_prev
        # per-particle residuals (M,) feed the batch API's per-problem
        # convergence reporting; the solve-wide residual is their max
        resid_m_new = jnp.maximum(
            jnp.max(jnp.linalg.norm(dX, axis=-1), axis=-1),
            jnp.max(jnp.linalg.norm(dU, axis=-1), axis=-1),
        )
        new_resid = jnp.max(resid_m_new)
        # non-finite subproblem solution: fall back to the previous iterate
        # (per-iteration NaN guard of the reference GPU path, jax_solver.py:151-154)
        bad = ~jnp.isfinite(new_resid)
        if has_bounds:
            # a gave-up IPM (box or cone) returns an iterate with NO
            # feasibility guarantee (it froze mid-solve): reject it — keep
            # the last accepted iterate, whose solve converged to its
            # tolerance (mirror of the host loop's ipm_failed contract)
            bad = bad | stats["failed"]
        now_done = (new_resid < res_tol) & ~bad

        freeze = done | bad
        X_lin, U_lin = X, U
        acc_out = acc
        if accel:
            histF, histZ, nh, X_sol, U_sol = acc
            Fk = jnp.concatenate([dX.reshape(-1), dU.reshape(-1)])
            Zk = jnp.concatenate([X.reshape(-1), U.reshape(-1)])
            histF_n = jnp.roll(histF, -1, axis=0).at[-1].set(Fk)
            histZ_n = jnp.roll(histZ, -1, axis=0).at[-1].set(Zk)
            nh_n = jnp.minimum(nh + 1, AW)
            Z_acc, wmass = _aa_combine(histF_n, histZ_n, nh_n, Fk, Zk)
            use = ((it + 1 >= accel_it0) & (nh_n >= 2)
                   & (wmass < accel_wmax) & jnp.isfinite(wmass)
                   & ~now_done)
            Z_lin = jnp.where(use, Z_acc, Zk)
            nx = M * N * xdim
            X_lin = Z_lin[:nx].reshape(M, N, xdim)
            U_lin = Z_lin[nx:].reshape(M, N, udim)
            sel_a = lambda a_, b_: jnp.where(freeze, b_, a_)
            acc_out = (sel_a(histF_n, histF), sel_a(histZ_n, histZ),
                       sel_a(nh_n, nh), sel_a(X, X_sol), sel_a(U, U_sol))
        X_out = jnp.where(freeze, X_prev, X_lin)
        U_out = jnp.where(freeze, U_prev, U_lin)
        resid_out = jnp.where(freeze, resid, new_resid)
        resid_m_out = jnp.where(freeze, resid_m, resid_m_new)
        it_out = it + jnp.where(done, 0, 1).astype(jnp.int32)
        warm_out = jax.tree.map(lambda a, b: jnp.where(freeze, b, a), warm_new, warm) \
            if warm is not None else None
        ys = None
        if collect_stats:
            ipm_it = stats["iters"] if has_bounds else jnp.asarray(0, jnp.int32)
            ys = dict(ipm_iters=ipm_it, resid=new_resid)
            if has_bounds:
                ys["ipm_failed"] = stats["failed"]
                ys["ipm_converged"] = stats["converged"]
                ys["accepted"] = ~freeze
        cqp_out = None if method in ("riccati", "priccati") else cqp
        return (X_out, U_out, it_out, done | now_done, resid_out, resid_m_out,
                warm_out, acc_out), ys, cqp_out

    def init_carry(data: SCPData, state=None):
        """Initial SCP loop carry for `run_chunk` (continuous-batching
        support: a converged lane's carry is re-initialized with a fresh
        problem's data while the other lanes keep iterating)."""
        dt = data.Q.dtype
        warm0, acc0 = _init_warm_acc(data, state)
        return (
            data.X_prev, data.U_prev,
            jnp.asarray(0, jnp.int32), jnp.asarray(False),
            jnp.asarray(jnp.inf, dt),
            jnp.full((M,), jnp.inf, dt),
            warm0, acc0,
        )

    @with_matmul_precision("highest")
    def run_chunk(data: SCPData, carry, n_it: int = 1):
        """Advance the SCP loop by up to ``n_it`` iterations (converged/
        frozen lanes no-op). Building block of the lane-refill serving loop
        (`pmpc_tpu.batch.solve_stream`): the host swaps finished problems
        out between chunks instead of running every lane to the batch max —
        the on-device analog of the farm's greedy requeue
        (``pmpc/remote.py:391-452``)."""
        def body(c, _):
            return iteration(data, c, None)[0], None

        carry, _ = lax.scan(body, carry, None, length=n_it)
        return carry

    def extract(data: SCPData, carry):
        """(X_traj, U, info) from a carry (same contract as the solver)."""
        X, U, it, done, resid, resid_m, warm_fin, acc_fin = carry
        if accel:
            X, U = acc_fin[3], acc_fin[4]
        X_traj = jnp.concatenate([data.x0[:, None, :], X], axis=1)
        info = dict(iters=it, resid=resid, converged=resid < res_tol,
                    resid_particle=resid_m)
        if return_state:
            info["solver_state"] = warm_fin
        return X_traj, U, info

    def _init_warm_acc(data: SCPData, state=None):
        dt = data.Q.dtype
        if has_bounds and warm_start:
            if state is not None:
                warm0 = state
            else:
                # neutral warm point for the first iteration: primal from
                # U_prev, slacks/multipliers at the cold-start heuristics
                nc = Nc * udim
                nf = (N - Nc) * udim
                uc_w = jnp.mean(data.U_prev.reshape(M, -1)[:, :nc], axis=0)
                uf_w = data.U_prev.reshape(M, -1)[:, nc:]
                if method in ("riccati", "priccati"):
                    # stage-structured IPM layout: padded theta; state rows
                    # appended when state bounds are active
                    nct = max(nc, 1)
                    th_w = jnp.zeros((nct,), dt).at[:nc].set(uc_w)
                    mtot = 2 * nct + 2 * M * nf \
                        + (2 * M * N * xdim if has_x_bounds else 0)
                    s_w = jnp.ones((mtot,), dt)
                    warm0 = (th_w, uf_w, s_w, s_w)
                else:
                    # state rows exist in the IPM's flat layout only when
                    # state bounds are active (see ipm_core)
                    mtot = 2 * nc + 2 * M * nf \
                        + (2 * M * (N * xdim) if has_x_bounds else 0)
                    s_w = jnp.ones((mtot,), dt)
                    warm0 = (uc_w, uf_w, s_w, s_w)
                if has_u_soc:
                    nq = Nc + M * (N - Nc)
                    e0 = jnp.zeros((nq, udim + 1), dt).at[:, 0].set(1.0)
                    warm0 = warm0 + (e0, e0)
        else:
            warm0 = None
        acc0 = None
        if accel:
            acc0 = (jnp.zeros((AW, n_flat), dt), jnp.zeros((AW, n_flat), dt),
                    jnp.asarray(0, jnp.int32), data.X_prev, data.U_prev)
        return warm0, acc0

    @with_matmul_precision("highest")
    def solver(data: SCPData, state=None):
        """``state``: the IPM primal/dual/slack tuple a previous call returned
        in ``info["solver_state"]`` (when built with ``return_state=True``) —
        receding-horizon MPC threads it across `solve()` calls so the first
        subproblem's IPM starts at the previous step's point instead of the
        cold heuristic (the reference's solver_state contract,
        ``pmpc/scp_mpc.py:366-373``)."""
        carry0 = init_carry(data, state)
        if collect_stats:
            (X, U, it, done, resid, resid_m, warm_fin, acc_fin), ys = lax.scan(
                partial(iteration, data), carry0, None, length=max_it
            )
        else:
            # early exit: a while_loop stops as soon as every (vmapped) lane
            # is converged — the scan would keep burning full frozen
            # iterations up to max_it (a real cost for warm-started
            # receding-horizon steps that converge in 2-3 iterations)
            def wcond(carry):
                return (~carry[3]) & (carry[2] < max_it)

            (X, U, it, done, resid, resid_m, warm_fin, acc_fin) = \
                lax.while_loop(
                    wcond, lambda c: iteration(data, c, None)[0], carry0)
            ys = None
        if accel:
            # return the last accepted RAW subproblem solution: it satisfies
            # the subproblem's constraints to IPM tolerance, while the AA
            # combination in X/U (the linearization carry) may extrapolate
            # slightly outside the feasible box
            X, U = acc_fin[3], acc_fin[4]
        X_traj = jnp.concatenate([data.x0[:, None, :], X], axis=1)
        info = dict(iters=it, resid=resid, converged=resid < res_tol,
                    resid_particle=resid_m)
        if collect_stats:
            info["scan_stats"] = ys
        if return_state:
            info["solver_state"] = warm_fin
        return X_traj, U, info

    jitted = jax.jit(solver) if jit else solver

    def out(data: SCPData, state=None):
        return jitted(data, state)

    # continuous-batching building blocks (unjitted — callers compose them
    # under their own jit/vmap; see batch.solve_stream)
    out.init_carry = init_carry
    out.run_chunk = run_chunk
    out.extract = extract
    return out
