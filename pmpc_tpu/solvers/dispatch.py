"""Affine-solve method dispatch: route a linearized consensus MPC instance to the
right on-device solver.

Replaces the reference's backend selection (``pmpc/static_backend.py:242-253``):
- no inequality constraints -> direct arrow-structured solve (`reduced.solve_eq`),
- box/extra constraints, exact -> batched primal-dual IPM (`ipm`),
- ``smooth_cstr`` in {"logbarrier", "squareplus"} -> smooth Newton path
  (`barrier`), parity with ``PMPC.jl/src/cone_utils.jl:173-232``.

The top-level entry `affine_solve_np` takes numpy arrays (already canonicalized
by ``pmpc_tpu.scp.aff_solve``) and returns numpy; the jitted cores cache per
shape signature.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .reduced import assemble_condensed, solve_eq, recover_XU


def _cone_precision_scope(dtype, device="auto"):
    """Precision/placement scope for the dense cone paths (CVaR / extras).

    These run in f64 by default (reference parity: its cone solvers are f64
    CPU — ECOS/OSQP/Mosek), which needs ``enable_x64`` when the session
    default is 32-bit. The f64 program is additionally pinned to the
    in-process XLA CPU backend — still jit-compiled batched assembly + IPM,
    just on the host, exactly where the reference runs these solves; moving
    it onto the accelerator is open work that needs its own measurement.
    ``device='auto'`` pins to
    CPU iff the default backend is not already CPU; pass an explicit platform
    name (settings["cone_device"]) to override."""
    import contextlib

    import jax

    stack = contextlib.ExitStack()
    if np.dtype(dtype) == np.float64 and not jax.config.jax_enable_x64:
        stack.enter_context(jax.enable_x64(True))
    try:
        plat = jax.default_backend()
    except Exception:
        plat = "cpu"
    want = "cpu" if device == "auto" else str(device)
    # an EXPLICIT device request is honored regardless of dtype; 'auto' only
    # pins to CPU for the f64 default (f32 cone programs may stay on the
    # accelerator)
    pin = (device != "auto") or np.dtype(dtype) == np.float64
    if pin and plat != want:
        try:
            stack.enter_context(jax.default_device(jax.devices(want)[0]))
        except RuntimeError:
            pass  # no such platform: stay on the default backend
    return stack


@jax.jit
def _batched_particle_H_q(*args):
    """jitted vmap of the per-particle condensed builder — the bare vmap
    dispatches the condense scan op-by-op through the batching interpreter
    (~1s/call of pure interpreter overhead at M=16, N=20)."""
    from .reduced import particle_H_q

    return jax.vmap(particle_H_q)(*args)


def _coerce_rollout(X, U):
    """Consensus controls are shared variables in our formulation and the
    condensed dynamics are satisfied by construction, so the reference's
    ``coerce`` re-average + re-rollout (``PMPC.jl/src/main.jl:338-344``) is an
    exact no-op here; kept for API parity."""
    return X, U


def affine_solve_np(
    x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
    reg_x, reg_u, slew_reg, slew_reg0, slew_um1,
    u_l, u_u, x_l, x_u,
    Nc: int,
    settings: Optional[Dict[str, Any]] = None,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """Solve one joint M-particle affine problem; returns (X (M,N,xdim), U, data)."""
    settings = settings or {}
    N = f.shape[1]
    M = f.shape[0]

    weights = settings.get("weights", None)
    weights = jnp.asarray(weights, dtype=f.dtype) if weights is not None else None

    diff_cost_fn = settings.get("diff_cost_fn", None)
    smooth_cstr = settings.get("smooth_cstr", None)
    smooth_alpha = settings.get("smooth_alpha", None)
    if smooth_alpha is not None and (
        isinstance(smooth_alpha, float) and np.isnan(smooth_alpha)
    ):
        smooth_cstr, smooth_alpha = "", None  # NaN sentinel: smoothing NOT requested
    if smooth_alpha is not None and smooth_cstr is None:
        smooth_cstr = "logbarrier"

    extra_cstrs = settings.get("extra_cstrs", None)
    u_soc_r = settings.get("u_soc_r", None)  # per-stage ||u_j|| <= r cones
    has_ineq = (any(z is not None for z in (u_l, u_u, x_l, x_u))
                or bool(extra_cstrs) or u_soc_r is not None)

    k = settings.get("k", None)
    has_cvar = k is not None and int(k) >= 0 and int(k) != M
    Hf = settings.get("Hf", None)

    # LINEAR-only extras (no SOC/exp rows, no aux variables, no cost terms)
    # combined with nothing conic stay STRUCTURED: the rows border the arrow
    # Newton matrix as a rank-l SMW update (ipm.ExtraRows) instead of
    # densifying the whole program through the composed cone path. This
    # includes logbarrier smoothing: the smoothed problem's solution is the
    # central-path point at mu = 1/alpha with the extras rows in the SAME
    # flat product family as the box rows (the reference smooths box AND
    # extras' linear rows together, main.jl:301-316), so the mu_target stop
    # delivers it exactly. Squareplus keeps extras EXACT on the composed
    # path (the reference smooths extras only in its logbarrier branch).
    ex_lin = None
    ex_consumed = False  # every extras row absorbed by a structured path
    if extra_cstrs and not has_cvar and Hf is None \
            and smooth_cstr in (None, "", "logbarrier") \
            and diff_cost_fn is None \
            and bool(settings.get("extras_structured", True)) \
            and str(settings.get("solver", "")).upper() not in (
                "BFGS", "LBFGS", "CVX", "SQP"):
        from .extras import _canon_extras

        udim_ = fu.shape[-1]
        xdim_ = f.shape[-1]
        Nc_ = Nc if Nc >= 0 else N
        n_full = Nc_ * udim_ + M * (N - Nc_) * udim_ + M * N * xdim_
        try:
            sig_ex, arr_ex = _canon_extras(extra_cstrs, n_full)
        except (ValueError, AssertionError):
            sig_ex, arr_ex = None, None
        if sig_ex is not None and all(
                q == () and e == 0 and na == 0 for (_, q, e, na) in sig_ex) \
                and all(np.all(np.asarray(a[3]) == 0.0) for a in arr_ex):
            ex_lin = (np.concatenate([a[0] for a in arr_ex], axis=0),
                      np.concatenate([a[2] for a in arr_ex]))
            ex_consumed = True
        elif sig_ex is not None and smooth_cstr in (None, ""):
            # SOC blocks that are per-stage control-norm cones (the natural
            # extra_cstrs encoding of thrust cones) + linear rows: convert
            # the cones to u_soc_r and keep the structured arrow IPM —
            # far cheaper than the dense composed program. Gated off under
            # smoothing (the reference smooths box+extras rows together on
            # that path, main.jl:301-316 — semantics differ).
            from .extras import split_stage_u_cones

            Nc_eff = Nc if Nc >= 0 else N
            det = split_stage_u_cones(sig_ex, arr_ex, M, N, Nc_eff, udim_)
            if det is not None:
                r_det, lg, lh = det
                if u_soc_r is not None:
                    r_det = np.minimum(
                        np.broadcast_to(np.asarray(u_soc_r, float), (M, N)),
                        r_det)
                u_soc_r = r_det
                settings = dict(settings, u_soc_r=r_det)
                ex_lin = (lg, lh) if lg.shape[0] else None
                ex_consumed = True

    # the composed dense cone program handles every combination the
    # reference's lcone_solve builds in one conic program (main.jl:204-317):
    # k-worst epigraph, extras, Hf, smoothing of box + extras' linear rows,
    # and per-stage control-norm cones (u_soc_r alone stays on the fast
    # structured IPM; composed with smoothing/extras it joins this program)
    needs_compose = (has_cvar or (bool(extra_cstrs) and not ex_consumed)
                     or Hf is not None
                     or (u_soc_r is not None
                         and smooth_cstr in ("logbarrier", "squareplus")))
    if needs_compose:
        if has_cvar and Hf is not None:
            # a cross-particle terminal cost cannot be attributed to a single
            # particle's epigraph cone; the reference cannot compose these
            # either (Hf exists only on its QP path, lqp_utils.jl:105-163)
            raise NotImplementedError(
                "k (CVaR) combined with Hf is not supported: the "
                "cross-particle terminal cost has no per-particle epigraph")
        if settings.get("diff_cost_fn") is not None:
            # arbitrary differentiable costs need the smooth solvers, which
            # cannot enforce cone programs; silently dropping either side
            # would change semantics (the reference experimental path rejects
            # extra constraints outright, jax_solver.py:347-352)
            raise NotImplementedError(
                "diff_cost_fn cannot be combined with extra_cstrs/Hf/k: the "
                "cone path has no smooth-objective hook")
        if str(settings.get("solver", "")).upper() in ("BFGS", "LBFGS",
                                                       "CVX", "SQP"):
            raise NotImplementedError(
                "named smooth solvers (BFGS/LBFGS/CVX/SQP) cannot solve cone "
                "programs (extra_cstrs/Hf/k); use the default cone IPM")
        from .compose import CvarParts, COST_ANCHOR_EPS, composed_cone_solve
        from .extras import terminal_cross_cost
        from .reduced import assemble_condensed as _assemble

        xdim = f.shape[-1]
        udim = fu.shape[-1]
        alpha = smooth_alpha if smooth_alpha is not None else 1.0
        beta = settings.get("smooth_beta", 1.0)
        # the cone programs square conditioning (explicit condensed Hessians
        # +/- their Cholesky factors), so they run in f64 like the reference's
        # CPU cone solvers (override via ``cone_dtype``); ``enable_x64``
        # scopes the 64-bit trace to this path only
        cdt = np.dtype(settings.get("cone_dtype", np.float64))
        with _cone_precision_scope(cdt, settings.get("cone_device", "auto")):
            cast = lambda a: jnp.asarray(np.asarray(a), cdt)
            cvar = None
            if has_cvar:
                if weights is not None:
                    # particle weights scale each particle's cost terms
                    # before the k-worst epigraph program is built
                    # (main.jl:202-204 via scale_probs_cost!, main.jl:96-112)
                    w = weights / jnp.sum(weights)
                    wq = np.asarray(w)[:, None, None, None]
                    Q, R = np.asarray(Q) * wq, np.asarray(R) * wq
                    wv = np.asarray(w)
                    reg_x, reg_u = (np.asarray(reg_x) * wv,
                                    np.asarray(reg_u) * wv)
                    slew_reg = np.asarray(slew_reg) * wv
                    slew_reg0 = np.asarray(slew_reg0) * wv
                    if bool(settings.get("weights_scale_slew_target", True)):
                        slew_um1 = np.asarray(slew_um1) * wv[:, None]
                args16 = [cast(a)
                          for a in (x0, f, fx, fu, X_prev, U_prev, Q, R,
                                    X_ref, U_ref, reg_x, reg_u,
                                    slew_reg, slew_reg0, slew_um1)]
                H_per, q_per, Ft, g = _batched_particle_H_q(*args16)
                nc = Nc * udim
                from .reduced import CondensedQP as _CQP

                cqp = _CQP(
                    Hcc=jnp.sum(H_per[:, :nc, :nc], axis=0),
                    Hcf=H_per[:, :nc, nc:], Hff=H_per[:, nc:, nc:],
                    qc=jnp.sum(q_per[:, :nc], axis=0), qf=q_per[:, nc:],
                    Ft=Ft, g=g,
                    w_prev=cast(U_prev).reshape(M, -1),
                )
                from .cvar import particle_constants

                c_per = particle_constants(
                    np.asarray(g), X_prev, U_prev, Q, R, X_ref, U_ref,
                    reg_x, reg_u, slew_reg0, slew_um1)
                eps = float(settings.get("cost_anchor_eps", COST_ANCHOR_EPS))
                cvar = CvarParts(
                    H_per=H_per, q_per=q_per,
                    c_per=jnp.asarray(c_per, cdt),
                    k=jnp.asarray(float(k), cdt),
                    eps=jnp.asarray(eps, cdt))
            else:
                cqp = _assemble(
                    cast(x0), cast(f), cast(fx), cast(fu),
                    cast(X_prev), cast(U_prev), cast(Q), cast(R),
                    cast(X_ref), cast(U_ref),
                    cast(reg_x), cast(reg_u),
                    cast(slew_reg), cast(slew_reg0), cast(slew_um1),
                    Nc=Nc,
                    weights=cast(weights) if weights is not None else None,
                    scale_slew_target=bool(
                        settings.get("weights_scale_slew_target", True)),
                )
            H_extra = q_extra = None
            if Hf is not None:
                H_extra, q_extra = terminal_cross_cost(
                    cqp, N=N, xdim=xdim, Hf=Hf, hf=settings.get("hf", None))
            X, U, data = composed_cone_solve(
                cqp, N=N, udim=udim, xdim=xdim,
                u_l=u_l, u_u=u_u, x_l=x_l, x_u=x_u,
                extra_cstrs=extra_cstrs or [], settings=settings,
                H_extra=H_extra, q_extra=q_extra,
                u_soc_r=u_soc_r,
                smooth_method=smooth_cstr or "",
                smooth_alpha=alpha, smooth_beta=beta,
                cvar=cvar,
            )
        return np.asarray(X), np.asarray(U), data

    base_args = (
        jnp.asarray(x0), jnp.asarray(f), jnp.asarray(fx), jnp.asarray(fu),
        jnp.asarray(X_prev), jnp.asarray(U_prev), jnp.asarray(Q), jnp.asarray(R),
        jnp.asarray(X_ref), jnp.asarray(U_ref),
    )
    reg_args = (
        jnp.asarray(reg_x), jnp.asarray(reg_u),
        jnp.asarray(slew_reg), jnp.asarray(slew_reg0), jnp.asarray(slew_um1),
    )

    if u_soc_r is not None and (
        diff_cost_fn is not None
        or str(settings.get("solver", "")).upper()
        in ("BFGS", "LBFGS", "CVX", "SQP")
    ):
        # smoothing combinations route through the composed cone program
        # above; only genuinely smooth-objective solves remain incompatible
        # with exact cones
        raise NotImplementedError(
            "u_soc_r cones cannot be combined with smooth-objective solves "
            "(diff_cost_fn / named BFGS/LBFGS/CVX/SQP solvers)"
        )

    if diff_cost_fn is not None:
        # arbitrary additive differentiable cost (experimental diff_cost_fn
        # parity, jax_solver.py:126-137): smooth path with L-BFGS; box
        # constraints are smoothed like the reference GPU solver
        from .barrier import barrier_solve_np

        alpha = float(smooth_alpha if smooth_alpha is not None else 1e2)
        return barrier_solve_np(
            base_args, reg_args, u_l, u_u, x_l, x_u, Nc=Nc, weights=weights,
            method=smooth_cstr if smooth_cstr in ("logbarrier", "squareplus")
            else "logbarrier",
            alpha=alpha, beta=float(settings.get("smooth_beta", 1.0)),
            settings=settings, extra_obj=diff_cost_fn,
        )

    method_s = str(settings.get("method", "")).lower()
    want_riccati = method_s == "riccati"
    if not method_s:
        # automatic long-horizon routing: the O(N^2) condensation OVERFLOWS
        # in float32 around N~240 (unstable dynamics compound in Ft, and
        # the residual goes to inf) exactly where the
        # O(N) stage-structured path starts winning on throughput too. Route
        # eligible long-horizon problems to it; anything the riccati path
        # cannot express (cones, extras, smoothing) stays on the condensed
        # path. Override with settings["method"] either way.
        auto_N = int(settings.get("riccati_auto_N", 240))
        eligible = (
            # LINEAR-only extras border the Riccati Newton system; stage
            # control-norm SOC extras became u_soc_r cones (both ex_consumed
            # above); other SOC/exp/aux extras need the condensed machinery
            (not extra_cstrs or ex_consumed)
            # logbarrier smoothing = central-path stop (mu_target) on the
            # stage-structured IPM; squareplus = the riccati smooth Newton
            # (riccati_barrier_core) — with u_soc/extras those combinations
            # were already routed composed above
            and (not smooth_cstr
                 or smooth_cstr in ("logbarrier", "squareplus"))
            and diff_cost_fn is None
            and str(settings.get("solver", "")).upper()
            not in ("BFGS", "LBFGS", "CVX", "SQP")
        )
        if N >= auto_N and eligible:
            want_riccati = True
    if want_riccati:
        # O(N) stage-structured path (long horizons): slew coupling enters
        # via state augmentation (riccati.augment_slew_stages), weights by
        # pre-scaling the per-particle costs (scale_probs_cost! role,
        # main.jl:96-112) — the theta-consensus sum then weights itself
        if weights is not None:
            w = np.asarray(weights / jnp.sum(weights))
            wq = w[:, None, None, None]
            Q, R = np.asarray(Q) * wq, np.asarray(R) * wq
            reg_x, reg_u = np.asarray(reg_x) * w, np.asarray(reg_u) * w
            slew_reg = np.asarray(slew_reg) * w
            slew_reg0 = np.asarray(slew_reg0) * w
            if bool(settings.get("weights_scale_slew_target", True)):
                slew_um1 = np.asarray(slew_um1) * w[:, None]
            base_args = base_args[:6] + (jnp.asarray(Q), jnp.asarray(R)) \
                + base_args[8:]
            reg_args = (jnp.asarray(reg_x), jnp.asarray(reg_u),
                        jnp.asarray(slew_reg), jnp.asarray(slew_reg0),
                        jnp.asarray(slew_um1))
    has_slew = bool(np.any(np.asarray(slew_reg) != 0)
                    or np.any(np.asarray(slew_reg0) != 0))

    if want_riccati and has_ineq:
        # box bounds (control AND state) + per-stage control-norm cones +
        # logbarrier smoothing (central-path stop): the stage-structured
        # Mehrotra IPM (riccati_ipm); extras and squareplus smoothing need
        # the condensed machinery
        if (extra_cstrs and not ex_consumed) \
                or (smooth_cstr
                    and smooth_cstr not in ("logbarrier", "squareplus")):
            raise NotImplementedError(
                "method='riccati' supports box bounds, u_soc_r cones, "
                "LINEAR extras, logbarrier and squareplus smoothing; "
                "SOC/exp/aux extras need the condensed path")
        if smooth_cstr == "squareplus":
            # damped Newton with O(N) riccati subproblem solves: the last
            # constraint class gaining a long-horizon route (round-5 #7).
            # u_soc/extras combinations were routed composed above.
            from .barrier import riccati_barrier_solve_np

            return riccati_barrier_solve_np(
                base_args, reg_args, u_l, u_u, x_l, x_u, Nc=Nc,
                method="squareplus",
                alpha=float(smooth_alpha if smooth_alpha is not None else 1.0),
                beta=float(settings.get("smooth_beta", 1.0)),
                settings=settings)
        st = settings
        if smooth_cstr == "logbarrier":
            alpha = float(smooth_alpha if smooth_alpha is not None else 1.0)
            st = dict(settings, mu_target=1.0 / alpha)
        udim = fu.shape[-1]
        if u_l is None:  # one-sided bounds: absent side at -inf/+inf
            u_l = np.full((M, N, udim), -np.inf, dtype=f.dtype)
        if u_u is None:
            u_u = np.full((M, N, udim), np.inf, dtype=f.dtype)
        from .riccati_ipm import riccati_ipm_solve_np

        return riccati_ipm_solve_np(
            base_args, reg_args, u_l, u_u, Nc=Nc, settings=st,
            x_l=x_l, x_u=x_u, u_soc_r=u_soc_r,
            ex_G=ex_lin[0] if ex_lin is not None else None,
            ex_h=ex_lin[1] if ex_lin is not None else None)

    if not has_ineq:
        if want_riccati:
            from .riccati import riccati_consensus_solve

            slew_kw = {}
            if has_slew:
                slew_kw = dict(slew_reg=reg_args[2], slew_reg0=reg_args[3],
                               slew_um1=reg_args[4])
            X, U = riccati_consensus_solve(
                *base_args, reg_args[0], reg_args[1], Nc=Nc, **slew_kw)
            return (np.asarray(X), np.asarray(U),
                    dict(solver_state=settings.get("solver_state")))
        cqp = assemble_condensed(
            *base_args, *reg_args, Nc=Nc, weights=weights,
            scale_slew_target=bool(
                settings.get("weights_scale_slew_target", True)))
        uc, uf = solve_eq(cqp)
        X, U = recover_XU(cqp, uc, uf, N=N)
        data: Dict[str, Any] = dict(solver_state=settings.get("solver_state"))
        return np.asarray(X), np.asarray(U), data

    if smooth_cstr == "logbarrier":
        alpha = float(smooth_alpha if smooth_alpha is not None else 1.0)
        if str(settings.get("solver", "")).upper() in ("BFGS", "LBFGS", "CVX", "SQP"):
            # experimental-stack parity: named smooth solvers on the smoothed
            # objective (solver_definitions.py BFGS/LBFGS/CVX/SQP registry)
            from .barrier import barrier_solve_np

            return barrier_solve_np(
                base_args, reg_args, u_l, u_u, x_l, x_u, Nc=Nc, weights=weights,
                method="logbarrier", alpha=alpha,
                beta=float(settings.get("smooth_beta", 1.0)), settings=settings,
            )
        # the logbarrier-smoothed problem's solution is the central-path point
        # at mu = 1/alpha of the same box QP (extras' linear rows included —
        # they sit in the same flat product family): reuse the IPM with a
        # mu floor
        from .ipm import ipm_solve_np

        return ipm_solve_np(
            base_args, reg_args, u_l, u_u, x_l, x_u, Nc=Nc,
            weights=weights,
            settings=dict(settings, mu_target=1.0 / alpha),
            ex_G=ex_lin[0] if ex_lin is not None else None,
            ex_h=ex_lin[1] if ex_lin is not None else None,
        )

    if smooth_cstr == "squareplus":
        from .barrier import barrier_solve_np

        return barrier_solve_np(
            base_args, reg_args, u_l, u_u, x_l, x_u, Nc=Nc, weights=weights,
            method="squareplus",
            alpha=float(smooth_alpha if smooth_alpha is not None else 1.0),
            beta=float(settings.get("smooth_beta", 1.0)),
            settings=settings,
        )

    from .ipm import ipm_solve_np

    return ipm_solve_np(
        base_args, reg_args, u_l, u_u, x_l, x_u, Nc=Nc, weights=weights,
        settings=settings,
        ex_G=ex_lin[0] if ex_lin is not None else None,
        ex_h=ex_lin[1] if ex_lin is not None else None,
    )
