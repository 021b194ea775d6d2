"""Scenario-batched SCP over composed cone programs (extras / CVaR-k / Hf /
control-norm cones / squareplus smoothing).

`solve_problems(fused=True)` covers the box/SOC feature subset with the whole
SCP loop under one jit (`jax_scp`). The cone-program features CANNOT ride
that path (their subproblem is a general conic program, not the structured
box IPM), and solving them one problem per call runs at ~0.5-1.5 solves/s
(each call is a full f64 cone IPM). This module batches them: B
same-SIGNATURE problems (possibly M particles each) run a host-driven SCP
loop whose per-iteration work is ONE device program — vmapped condensed
assembly + cone-program build + NT cone IPM
(`compose.composed_solve_batch_device`) — with per-problem convergence,
failure flags, reject contracts and warm starts carried on device.

The reference solves these strictly serially (its only parallelism is
``@threads`` sparse assembly inside one problem, ``cone_utils.jl:64-95``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .utils import atleast_nd

_UNSUPPORTED_PROBLEM_KEYS = ("lin_cost_fn", "extra_cstrs_fns", "filter_method",
                             "return_min_viol", "diff_cost_fn")


def _cone_scp_step(state, warm_in, probs_c, bounds_c, ecs_c, extras_q_c,
                   alpha, beta, kv, eps, *, dyn, dims, sig, smooth_method,
                   Nc, has_cvar, iters, tol_exp, kappa, adaptive, res_tol):
    """ONE device program for one batched SCP iteration: linearize +
    adaptive forcing + composed cone solve + accept/reject bookkeeping.
    Module-level (persistently jit-cached per static signature) — the host
    loop pulls a single ``done.all()`` scalar per iteration; the previous
    host-side accept logic pulled full X/U batches every iteration and
    dominated once the IPM got fast."""
    import jax
    import jax.numpy as jnp

    from .solvers.compose import composed_solve_batch_device
    from .dynamics import linearize

    X_p, U_p, resid_v, done_v, failed_v = state
    B = X_p.shape[0]
    x_at = jnp.concatenate(
        [probs_c["x0"][:, :, None, :], X_p[:, :, :-1, :]], axis=2)
    f, fx, fu = linearize(dyn, x_at, U_p)
    probs_it = dict(probs_c, f=f, fx=fx, fu=fu, X_prev=X_p, U_prev=U_p)
    tol_dyn = None
    if adaptive:
        r = jnp.minimum(jnp.where(jnp.isfinite(resid_v), resid_v, 1e3), 1e3)
        tol_dyn = jnp.clip(1e-3 * r * r, 0.0, 1e-3).astype(X_p.dtype)
    X_new, U_new, aux, stats, warm_new = composed_solve_batch_device(
        probs_it, bounds_c, ecs_c, extras_q_c, dims, sig, smooth_method,
        alpha, beta, Nc=Nc, k=kv, eps=eps, has_cvar=has_cvar,
        iters=iters, tol_exp=tol_exp, kappa=kappa,
        tol_dynamic=tol_dyn, warm=warm_in)
    mu_v, conv_v = stats["mu"], stats["converged"]
    # per-problem reject contract: a hard-failed subproblem (IPM far from
    # its central path) freezes that problem's iterate
    tol_eff = jnp.maximum(
        10.0 ** tol_exp, 0.0 if tol_dyn is None else jnp.max(tol_dyn))
    hard_fail = (~conv_v) & (~jnp.isfinite(mu_v) | (mu_v > 1e2 * tol_eff))
    dX, dU = X_new - X_p, U_new - U_p
    r_new = jnp.maximum(
        jnp.max(jnp.linalg.norm(dX, axis=-1), axis=(1, 2)),
        jnp.max(jnp.linalg.norm(dU, axis=-1), axis=(1, 2)))
    bad = hard_fail | ~jnp.isfinite(r_new)
    accept = ~(done_v | bad)
    failed_v = failed_v | (bad & ~done_v & ~jnp.isfinite(resid_v))
    acc4 = accept[:, None, None, None]
    X_o = jnp.where(acc4, X_new, X_p)
    U_o = jnp.where(acc4, U_new, U_p)
    if warm_in is None:
        warm_out = warm_new
    else:
        warm_out = jax.tree.map(
            lambda n, o: jnp.where(
                accept.reshape((B,) + (1,) * (n.ndim - 1)), n, o),
            warm_new, warm_in)
    resid_o = jnp.where(accept, r_new, resid_v)
    done_o = done_v | (accept & (r_new < res_tol)) | bad
    return (X_o, U_o, resid_o, done_o, failed_v), warm_out


def _struct_scp_step(state, warm_in, probs_c, bounds_c, socs_c, ex_c,
                     *, dyn, Nc, N, has_u, has_x, has_soc, has_ex,
                     iters, tol_exp, kappa, adaptive, res_tol):
    """ONE device program for one batched SCP iteration on the STRUCTURED
    route: linearize + vmapped (condensed assembly + arrow IPM + recover).

    Eligible signatures — boxes, per-stage control-norm cones, and
    LINEAR-only extras (which border the arrow system, `ipm.ExtraRows`) —
    never build the dense composed cone program at all: each problem's
    subproblem is the same arrow-structured Mehrotra IPM the serial host
    path runs, vmapped over the batch axis (`ipm_core` freezes per-lane on
    convergence, so the inner while_loop runs to the batch max)."""
    import jax
    import jax.numpy as jnp

    from .dynamics import linearize
    from .solvers.ipm import ipm_core, map_extras_rows
    from .solvers.reduced import assemble_condensed, recover_XU

    X_p, U_p, resid_v, done_v, failed_v = state
    B = X_p.shape[0]
    x_at = jnp.concatenate(
        [probs_c["x0"][:, :, None, :], X_p[:, :, :-1, :]], axis=2)
    f, fx, fu = linearize(dyn, x_at, U_p)
    tol_dyn = None
    if adaptive:
        r = jnp.minimum(jnp.where(jnp.isfinite(resid_v), resid_v, 1e3), 1e3)
        tol_dyn = jnp.clip(1e-3 * r * r, 0.0, 1e-3).astype(X_p.dtype)

    def one(f_b, fx_b, fu_b, Xp_b, Up_b, pc, bounds_b, socs_b, ex_b,
            warm_b, tol_dyn_b):
        cqp = assemble_condensed(
            pc["x0"], f_b, fx_b, fu_b, Xp_b, Up_b,
            pc["Q"], pc["R"], pc["X_ref"], pc["U_ref"],
            pc["reg_x"], pc["reg_u"], pc["slew_reg"], pc["slew_reg0"],
            pc["slew_um1"], Nc=Nc)
        ex = None
        if has_ex:
            M_ = cqp.Ft.shape[0]
            NX_ = cqp.g.shape[-1]
            ex = map_extras_rows(cqp, ex_b[0], ex_b[1], cqp.nc, cqp.nf,
                                 M_, NX_)
        uc, uf, stats = ipm_core(
            cqp, bounds_b, has_u=has_u, has_x=has_x, iters=iters,
            tol_exp=tol_exp, kappa=kappa, warm=warm_b,
            tol_dynamic=tol_dyn_b, socs=socs_b, has_soc=has_soc,
            ex=ex, has_ex=has_ex)
        X_b, U_b = recover_XU(cqp, uc, uf, N=N)
        warm_out = (uc, uf, stats["s"], stats["lam"])
        if has_soc:
            warm_out = warm_out + (stats["sq"], stats["zq"])
        return X_b, U_b, warm_out, stats["mu"], stats["converged"], \
            stats["failed"]

    X_new, U_new, warm_new, mu_v, conv_v, fail_v = jax.vmap(one)(
        f, fx, fu, X_p, U_p,
        {k: probs_c[k] for k in ("x0", "Q", "R", "X_ref", "U_ref", "reg_x",
                                 "reg_u", "slew_reg", "slew_reg0",
                                 "slew_um1")},
        bounds_c, socs_c, ex_c, warm_in, tol_dyn)

    # same hard-fail contract as the composed step: an unconverged IPM whose
    # duality measure is far from its target never produced a usable iterate
    # (infeasible rows drive mu to a plateau, not to tol)
    tol_eff = jnp.maximum(
        10.0 ** tol_exp, 0.0 if tol_dyn is None else jnp.max(tol_dyn))
    hard_fail = fail_v | ~jnp.isfinite(mu_v) \
        | ((~conv_v) & (mu_v > 1e2 * tol_eff))
    dX, dU = X_new - X_p, U_new - U_p
    r_new = jnp.maximum(
        jnp.max(jnp.linalg.norm(dX, axis=-1), axis=(1, 2)),
        jnp.max(jnp.linalg.norm(dU, axis=-1), axis=(1, 2)))
    bad = hard_fail | ~jnp.isfinite(r_new)
    accept = ~(done_v | bad)
    failed_v = failed_v | (bad & ~done_v & ~jnp.isfinite(resid_v))
    acc4 = accept[:, None, None, None]
    X_o = jnp.where(acc4, X_new, X_p)
    U_o = jnp.where(acc4, U_new, U_p)
    if warm_in is None:
        warm_out = warm_new
    else:
        warm_out = jax.tree.map(
            lambda n, o: jnp.where(
                accept.reshape((B,) + (1,) * (n.ndim - 1)), n, o),
            warm_new, warm_in)
    resid_o = jnp.where(accept, r_new, resid_v)
    done_o = done_v | (accept & (r_new < res_tol)) | bad
    return (X_o, U_o, resid_o, done_o, failed_v), warm_out


_STEP_JIT = None
_STRUCT_STEP_JIT = None


def _get_step_jit():
    """The ONE persistent jit wrapper of `_cone_scp_step` (a fresh jax.jit
    per solve call would recompile the whole step every time)."""
    global _STEP_JIT
    if _STEP_JIT is None:
        import jax

        _STEP_JIT = jax.jit(_cone_scp_step, static_argnames=(
            "dyn", "dims", "sig", "smooth_method", "Nc", "has_cvar",
            "iters", "tol_exp", "kappa", "adaptive", "res_tol"))
    return _STEP_JIT


def _get_struct_step_jit():
    global _STRUCT_STEP_JIT
    if _STRUCT_STEP_JIT is None:
        import jax

        _STRUCT_STEP_JIT = jax.jit(_struct_scp_step, static_argnames=(
            "dyn", "Nc", "N", "has_u", "has_x", "has_soc", "has_ex",
            "iters", "tol_exp", "kappa", "adaptive", "res_tol"))
    return _STRUCT_STEP_JIT


def _canon_problem(p: Dict[str, Any]) -> Dict[str, Any]:
    """Canonicalize one problem dict to batched (M, ...) float64 arrays
    (the `scp._SCPProblem.build` conventions, minus callbacks)."""
    out = {}
    Q = np.array(p["Q"], dtype=float)
    single = np.asarray(p["x0"]).ndim == 1
    Q = Q[None] if single else Q
    R = np.array(p["R"], dtype=float)
    R = R[None] if single else R
    M, N, xdim = Q.shape[:3]
    udim = R.shape[-1]
    x0 = np.asarray(p["x0"], dtype=float).reshape(M, xdim)

    def ref(name, d):
        v = p.get(name)
        if v is None:
            return np.zeros((M, N, d))
        return np.asarray(v, dtype=float).reshape(M, N, d)

    X_ref, U_ref = ref("X_ref", xdim), ref("U_ref", udim)

    def traj(name, fallback):
        v = p.get(name)
        if v is None:
            return fallback.copy()
        return np.asarray(v, dtype=float).reshape(fallback.shape)

    def bound(name, d, fill):
        v = p.get(name)
        if v is None or (np.asarray(v, dtype=float).size
                         and np.any(np.isnan(np.asarray(v, dtype=float)))):
            return None
        return np.broadcast_to(
            atleast_nd(np.asarray(v, dtype=float), 3), (M, N, d)).copy()

    out.update(
        x0=x0, Q=Q, R=R, X_ref=X_ref, U_ref=U_ref,
        X_prev=traj("X_prev", X_ref), U_prev=traj("U_prev", U_ref),
        u_l=bound("u_l", udim, -np.inf), u_u=bound("u_u", udim, np.inf),
        x_l=bound("x_l", xdim, -np.inf), x_u=bound("x_u", xdim, np.inf),
        reg_x=float(p.get("reg_x", 1.0)), reg_u=float(p.get("reg_u", 1e-2)),
        M=M, N=N, xdim=xdim, udim=udim,
    )
    ss = dict(p.get("solver_settings") or {})
    slew_rate = p.get("slew_rate")
    out["slew_reg"] = float(slew_rate) if slew_rate else 0.0
    u0_slew = p.get("u_slew", p.get("u0_slew"))
    if u0_slew is not None:
        out["slew_reg0"] = float(ss.get("slew_reg0",
                                        ss.get("slew_reg", out["slew_reg"])))
        out["slew_um1"] = np.broadcast_to(
            np.asarray(u0_slew, dtype=float), (M, udim)).copy()
    else:
        out["slew_reg0"] = 0.0
        out["slew_um1"] = np.zeros((M, udim))
    return out


def solve_problems_cone(
    problems: Sequence[Dict[str, Any]],
    split: bool = True,
) -> List[Tuple[np.ndarray, np.ndarray, Dict[str, Any]]]:
    """Batched SCP solve of B cone-featured problems in lockstep.

    Requirements (checked): homogeneous shapes/settings, the JAX dynamics
    protocol (``make_f_fx_fu_fn``), identical extras SIGNATURE (numeric
    values may differ per problem). Exponential-cone signatures (logbarrier
    smoothing, ``e`` rows) batch through the vmapped central-path barrier
    driver; symmetric signatures batch through the NT cone IPM.
    """
    import jax
    import jax.numpy as jnp

    from .solvers.compose import composed_solve_batch_device, COST_ANCHOR_EPS
    from .solvers.coneipm import cone_host_stats
    from .solvers.dispatch import _cone_precision_scope
    from .solvers.extras import _canon_extras
    from .dynamics import linearize

    p0 = problems[0]
    dyn = getattr(p0.get("f_fx_fu_fn"), "__wrapped_dynamics__", None)
    if dyn is None:
        raise ValueError(
            "batched cone solves need the JAX dynamics protocol: build "
            "f_fx_fu_fn with pmpc_tpu.make_f_fx_fu_fn(step_fn)")
    for k in _UNSUPPORTED_PROBLEM_KEYS:
        if p0.get(k):
            raise ValueError(f"batched cone solves do not support {k!r}")
    ss0 = dict(p0.get("solver_settings") or {})
    smooth = str(ss0.get("smooth_cstr") or "")
    if smooth == "" and ss0.get("smooth_alpha") is not None \
            and np.isfinite(float(ss0["smooth_alpha"])):
        smooth = "logbarrier"
    # logbarrier smoothing generates exponential cones; those signatures
    # vmap the device central-path barrier driver (expbarrier) instead of
    # the NT cone IPM — see composed_solve_batch_device
    B = len(problems)
    cps = [_canon_problem(p) for p in problems]
    M, N, xdim, udim = cps[0]["M"], cps[0]["N"], cps[0]["xdim"], cps[0]["udim"]
    Nc = int(ss0.get("Nc", -1))
    Nc = Nc if Nc >= 0 else N
    if M == 1:
        Nc = 0  # single particle: keep the per-particle layout (scp.py rule)
    dims = (N, udim, xdim)

    # stack problem arrays (B, M, ...)
    def stack(key):
        vals = [cp[key] for cp in cps]
        if any(v is None for v in vals):
            if not all(v is None for v in vals):
                raise ValueError(f"field {key} present in only some problems")
            return None
        return np.stack([np.asarray(v, dtype=float) for v in vals])

    probs_np = {k: stack(k) for k in
                ("x0", "Q", "R", "X_ref", "U_ref", "X_prev", "U_prev",
                 "slew_um1")}
    for k in ("reg_x", "reg_u", "slew_reg", "slew_reg0"):
        probs_np[k] = np.stack([np.full((M,), cp[k]) for cp in cps])

    # particle weights: pre-scale each problem's cost terms exactly like the
    # serial path's scale_probs_cost! parity (dispatch.py CVaR branch /
    # assemble_condensed weights=..., main.jl:96-112) — both batched routes
    # then see an unweighted problem with weighted costs. Values may differ
    # per problem; presence must be homogeneous (it changes the numerics of
    # every cost array).
    w_list = [(p.get("solver_settings") or {}).get("weights")
              for p in problems]
    if any(w is not None for w in w_list):
        if not all(w is not None for w in w_list):
            raise ValueError(
                "weights present in only some problems of the batch")
        W = np.stack([np.asarray(w, dtype=float).reshape(M)
                      for w in w_list])  # (B, M)
        W = W / W.sum(axis=1, keepdims=True)
        probs_np["Q"] = probs_np["Q"] * W[:, :, None, None, None]
        probs_np["R"] = probs_np["R"] * W[:, :, None, None, None]
        for k in ("reg_x", "reg_u", "slew_reg", "slew_reg0"):
            probs_np[k] = probs_np[k] * W
        if bool(ss0.get("weights_scale_slew_target", True)):
            probs_np["slew_um1"] = probs_np["slew_um1"] * W[:, :, None]
    bounds_np = {k: stack(k) for k in ("u_l", "u_u", "x_l", "x_u")}
    bounds_np = {k: v for k, v in bounds_np.items() if v is not None}

    u_soc_r = ss0.get("u_soc_r")
    if u_soc_r is not None:
        rs = [np.broadcast_to(np.asarray(
            (p.get("solver_settings") or {}).get("u_soc_r"), dtype=float),
            (M, N)) for p in problems]
        bounds_np["u_soc_r"] = np.stack(rs)

    # extras: identical static signature across the batch, stacked numerics
    nu_total = Nc * udim + M * (N - Nc) * udim
    n_full = nu_total + M * N * xdim
    sigs, arrays = [], []
    for p in problems:
        ec = (p.get("solver_settings") or {}).get("extra_cstrs") or []
        sig_i, arr_i = _canon_extras(ec, n_full)
        sigs.append(sig_i)
        arrays.append(arr_i)
    sig = sigs[0]
    if any(s != sig for s in sigs):
        raise ValueError(
            "batched cone solves need the same extras signature (l, q, e, "
            "n_aux) for every problem; numeric values may differ")
    ecs_np = tuple(
        tuple(np.stack([arrays[b][i][j] for b in range(B)])
              for j in range(5))
        for i in range(len(sig)))

    extras_q_np = {}
    if ss0.get("Hf") is not None:
        extras_q_np["Hf"] = np.stack([
            np.asarray((p.get("solver_settings") or {})["Hf"], dtype=float)
            for p in problems])
        if ss0.get("hf") is not None:
            extras_q_np["hf"] = np.stack([
                np.asarray((p.get("solver_settings") or {})["hf"],
                           dtype=float).reshape(-1) for p in problems])

    k_set = ss0.get("k")
    has_cvar = k_set is not None and int(k_set) >= 0 and int(k_set) != M
    if has_cvar and "Hf" in extras_q_np:
        raise NotImplementedError("k (CVaR) combined with Hf is not supported")

    max_it = int(p0.get("max_it", 100))
    res_tol = float(p0.get("res_tol", 1e-5))

    # STRUCTURED route: boxes + per-stage control cones + LINEAR-only extras
    # never need the dense composed cone program — each subproblem is the
    # arrow IPM (with the extras rows as SMW borders), vmapped over B. This
    # runs at the box-path's dtype on the default backend, not the
    # CPU-pinned f64 cone path.
    lin_only = all(q == () and e == 0 and na == 0 for (_, q, e, na) in sig)
    c_left_zero = all(np.all(arrs[i][3] == 0.0)
                      for arrs in arrays for i in range(len(sig)))
    struct_base = (not has_cvar and not smooth and not extras_q_np
                   and c_left_zero
                   and ss0.get("mu_target") is None
                   and bool(ss0.get("extras_structured", True))
                   and "cone_dtype" not in ss0 and "cone_device" not in ss0)
    struct_ok = struct_base and lin_only
    if struct_base and not lin_only:
        # per-stage control-norm SOC extras -> u_soc_r cones on the
        # structured route (same detection as the serial dispatch,
        # extras.split_stage_u_cones); every problem's blocks must match
        from .solvers.extras import split_stage_u_cones

        dets = [split_stage_u_cones(sig, arrays[b], M, N, Nc, udim)
                for b in range(B)]
        if all(d is not None for d in dets):
            r_stack = np.stack([d[0] for d in dets])  # (B, M, N)
            prev = bounds_np.get("u_soc_r")
            if prev is not None:
                r_stack = np.minimum(prev, r_stack)
            bounds_np["u_soc_r"] = r_stack
            ltot = dets[0][1].shape[0]
            if ltot:
                n_cols = dets[0][1].shape[1]
                sig = ((ltot, (), 0, 0),)
                arrays = tuple(
                    (d[1], np.zeros((ltot, 0)), d[2], np.zeros(n_cols),
                     np.zeros(0)) for d in dets)
            else:
                sig, arrays = (), tuple(() for _ in range(B))
            struct_ok = True
    if struct_ok:
        X_np, U_np, resid_b, failed_b, iters_used, t_aff = \
            _run_struct_batched(
                probs_np, bounds_np, cps, sig, arrays, dyn=dyn, B=B, M=M,
                N=N, xdim=xdim, udim=udim, Nc=Nc, ss0=ss0, max_it=max_it,
                res_tol=res_tol)
        return _emit(problems, probs_np, X_np, U_np, resid_b, failed_b,
                     iters_used, t_aff, res_tol, split)

    cdt = np.dtype(ss0.get("cone_dtype", np.float64))
    f64 = cdt == np.float64
    iters = int(ss0.get("ipm_iters", 100 if f64 else (50 if has_cvar else 35)))
    tol_exp = int(ss0.get("ipm_tol_exp",
                          -8 if f64 else (-3 if has_cvar else -5)))
    kappa = float(ss0.get("ipm_kappa",
                          1e-10 if f64 else (1e-6 if has_cvar else 1e-7)))
    adaptive = bool(ss0.get("ipm_adaptive_tol", "ipm_tol_exp" not in ss0))

    with _cone_precision_scope(cdt, ss0.get("cone_device", "auto")):
        cast = lambda a: jnp.asarray(np.asarray(a), cdt)
        probs = {k: cast(v) for k, v in probs_np.items()}
        bounds = {k: cast(v) for k, v in bounds_np.items()}
        ecs = tuple(tuple(cast(a) for a in ec) for ec in ecs_np)
        extras_q = {k: cast(v) for k, v in extras_q_np.items()}

        # multi-core: the f64 cone path is CPU-pinned (reference parity) and
        # XLA:CPU executes one batched program mostly single-threaded. When
        # the process exposes several XLA CPU devices (run with
        # XLA_FLAGS=--xla_force_host_platform_device_count=<cores>), shard
        # the batch axis across them: the B cone IPMs are independent, so
        # GSPMD runs the partitions on separate device threads.
        shard_b = None
        try:
            cpudevs = jax.devices("cpu")
        except RuntimeError:
            cpudevs = []
        on_cpu = (np.dtype(cdt) == np.float64
                  or jax.default_backend() == "cpu")
        nshard = len(cpudevs)
        while nshard > 1 and B % nshard:
            nshard -= 1
        if on_cpu and nshard > 1 and str(
                ss0.get("cone_device", "auto")) in ("auto", "cpu"):
            from jax.sharding import Mesh, NamedSharding, PartitionSpec

            mesh = Mesh(np.asarray(cpudevs[:nshard]), ("b",))
            shard_b = NamedSharding(mesh, PartitionSpec("b"))
            place = lambda t: jax.tree.map(
                lambda a: jax.device_put(a, shard_b), t)
            probs, bounds, ecs, extras_q = place(
                (probs, bounds, ecs, extras_q))
        alpha = cast(float(ss0.get("smooth_alpha", 1.0) or 1.0))
        beta = cast(float(ss0.get("smooth_beta", 1.0) or 1.0))
        kv = cast(float(k_set)) if has_cvar else None
        eps = cast(float(ss0.get("cost_anchor_eps", COST_ANCHOR_EPS))) \
            if has_cvar else None

        X_prev = probs["X_prev"]  # (B, M, N, xdim) device
        U_prev = probs["U_prev"]
        iters_used = 0
        t_aff = []
        import time as _time

        state = (X_prev, U_prev, cast(np.full((B,), np.inf)),
                 jnp.zeros((B,), bool), jnp.zeros((B,), bool))
        if shard_b is not None:
            state = jax.tree.map(lambda a: jax.device_put(a, shard_b), state)
        warm = None
        for it in range(max_it):
            t0 = _time.time()
            state, warm = _get_step_jit()(
                state, warm, probs, bounds, ecs, extras_q, alpha, beta,
                kv, eps, dyn=dyn, dims=dims, sig=sig, smooth_method=smooth,
                Nc=Nc, has_cvar=has_cvar, iters=iters, tol_exp=tol_exp,
                kappa=kappa, adaptive=adaptive, res_tol=res_tol)
            done_all = bool(np.asarray(state[3].all()))  # the one sync point
            t_aff.append(_time.time() - t0)
            iters_used = it + 1
            if done_all:
                break

        X_np, U_np, resid_b, done, failed_b = (np.asarray(z) for z in state)

    return _emit(problems, probs_np, X_np, U_np, resid_b, failed_b,
                 iters_used, t_aff, res_tol, split)


def _emit(problems, probs_np, X_np, U_np, resid_b, failed_b, iters_used,
          t_aff, res_tol, split):
    """Shared result packaging for both batched routes (the scp.py
    per-problem contract: `(None, None, None)` on hard failure)."""
    B = X_np.shape[0]
    X_traj = np.concatenate([np.asarray(probs_np["x0"])[:, :, None, :], X_np],
                            axis=2)
    base = dict(fused_cone=True, iters=iters_used, t_aff_solve=t_aff)
    single = np.asarray(problems[0]["x0"]).ndim == 1
    if not split:
        return [(X_traj, U_np, dict(
            base, resid_problem=resid_b, converged=bool((resid_b < res_tol).all()),
            ipm_failed=failed_b))]
    out = []
    for i in range(B):
        d = dict(base, batch_index=i, resid=float(resid_b[i]),
                 converged=bool(resid_b[i] < res_tol),
                 ipm_failed=bool(failed_b[i]))
        Xi, Ui = X_traj[i], U_np[i]
        if single:
            Xi, Ui = Xi[0], Ui[0]
        if failed_b[i]:
            out.append((None, None, None))  # scp failure contract
        else:
            out.append((Xi, Ui, d))
    return out


def _run_struct_batched(probs_np, bounds_np, cps, sig, arrays, *, dyn, B, M,
                        N, xdim, udim, Nc, ss0, max_it, res_tol):
    """Drive the structured batched SCP loop (see `_struct_scp_step`)."""
    import jax
    import jax.numpy as jnp

    from .utils import default_dtype

    dtype = np.dtype(ss0.get("dtype", default_dtype()))
    has_u = any(bounds_np.get(k) is not None for k in ("u_l", "u_u"))
    has_x = any(bounds_np.get(k) is not None for k in ("x_l", "x_u"))
    has_soc = bounds_np.get("u_soc_r") is not None
    has_ex = len(sig) > 0

    iters = int(ss0.get("ipm_iters", 30))
    tol_exp = int(ss0.get("ipm_tol_exp",
                          -8 if dtype == np.float64 else -5))
    kappa = float(ss0.get("ipm_kappa",
                          0.0 if dtype == np.float64 else 1e-7))
    adaptive = bool(ss0.get("ipm_adaptive_tol", "ipm_tol_exp" not in ss0))

    try:
        cpudevs = jax.devices("cpu")
    except RuntimeError:
        cpudevs = []
    on_cpu = jax.default_backend() == "cpu"

    cast = lambda a: jnp.asarray(np.asarray(a), dtype)
    return _run_struct_loop(
        probs_np, bounds_np, cps, sig, arrays, cast=cast, dtype=dtype,
        dyn=dyn, B=B, M=M, N=N, xdim=xdim, udim=udim, Nc=Nc,
        has_u=has_u, has_x=has_x, has_soc=has_soc, has_ex=has_ex,
        iters=iters, tol_exp=tol_exp, kappa=kappa, adaptive=adaptive,
        max_it=max_it, res_tol=res_tol, on_cpu=on_cpu, cpudevs=cpudevs)


def _run_struct_loop(probs_np, bounds_np, cps, sig, arrays, *, cast, dtype,
                     dyn, B, M, N, xdim, udim, Nc, has_u, has_x, has_soc,
                     has_ex, iters, tol_exp, kappa, adaptive, max_it,
                     res_tol, on_cpu, cpudevs):
    import time as _time

    import jax
    import jax.numpy as jnp

    from .solvers.ipm import _layout_bounds, layout_socs

    nc, nf = Nc * udim, (N - Nc) * udim
    NX = N * xdim
    blist = [_layout_bounds(cp["u_l"], cp["u_u"], cp["x_l"], cp["x_u"],
                            M, N, NX, nc, nf, udim, dtype) for cp in cps]
    bounds_b = jax.tree.map(lambda *xs: jnp.stack(xs), *blist)
    socs_b = None
    if has_soc:
        slist = [layout_socs(bounds_np["u_soc_r"][b], M, N, Nc, dtype)
                 for b in range(B)]
        socs_b = jax.tree.map(lambda *xs: jnp.stack(xs), *slist)
    ex_b = None
    if has_ex:
        ex_b = (
            jnp.asarray(np.stack([np.concatenate(
                [arrays[b][i][0] for i in range(len(sig))], axis=0)
                for b in range(B)]).astype(dtype)),
            jnp.asarray(np.stack([np.concatenate(
                [arrays[b][i][2] for i in range(len(sig))])
                for b in range(B)]).astype(dtype)),
        )

    probs = {k: cast(probs_np[k]) for k in
             ("x0", "Q", "R", "X_ref", "U_ref", "X_prev", "U_prev", "reg_x",
              "reg_u", "slew_reg", "slew_reg0", "slew_um1")}

    # CPU backend with several XLA host devices: shard the batch axis (the
    # B arrow IPMs are independent; same discipline as the cone route)
    shard_b = None
    nshard = len(cpudevs)
    while nshard > 1 and B % nshard:
        nshard -= 1
    if on_cpu and nshard > 1:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec

        mesh = Mesh(np.asarray(cpudevs[:nshard]), ("b",))
        shard_b = NamedSharding(mesh, PartitionSpec("b"))
        place = lambda t: jax.tree.map(
            lambda a: jax.device_put(a, shard_b), t)
        probs, bounds_b, socs_b, ex_b = place((probs, bounds_b, socs_b, ex_b))

    state = (probs["X_prev"], probs["U_prev"],
             cast(np.full((B,), np.inf)),
             jnp.zeros((B,), bool), jnp.zeros((B,), bool))
    if shard_b is not None:
        state = jax.tree.map(lambda a: jax.device_put(a, shard_b), state)
    warm = None
    iters_used, t_aff = 0, []
    for it in range(max_it):
        t0 = _time.time()
        state, warm = _get_struct_step_jit()(
            state, warm, probs, bounds_b, socs_b, ex_b, dyn=dyn, Nc=Nc, N=N,
            has_u=has_u, has_x=has_x, has_soc=has_soc, has_ex=has_ex,
            iters=iters, tol_exp=tol_exp, kappa=kappa, adaptive=adaptive,
            res_tol=res_tol)
        done_all = bool(np.asarray(state[3].all()))  # the one sync point
        t_aff.append(_time.time() - t0)
        iters_used = it + 1
        if done_all:
            break

    X_np, U_np, resid_b, _done, failed_b = (np.asarray(z) for z in state)
    return X_np, U_np, resid_b, failed_b, iters_used, t_aff
