"""End-to-end parity against an INDEPENDENT implementation of the reference
semantics (BASELINE: ||U - U_ref||_inf <= 1e-3 at equal SCP iteration budget).

`ref_scp_solve` below re-implements, from the reference's documented behavior,
the full SCP pipeline the Julia/C backend executes — canonical consensus-QP
assembly per ``PMPC.jl/src/lqp_utils.jl:2-216`` (via tests/oracle.py's dense
derivation), particle weight scaling per ``main.jl:96-112`` (including the
slew_um1 anchor scaling at main.jl:107), the SCP loop semantics of
``pmpc/scp_mpc.py:337-428`` — and solves each subproblem with scipy
(equality KKT / trust-constr), never touching pmpc_tpu solver code.

The logbarrier test proves the exp-cone reformulation claim:
the reference encodes ``smooth_cstr="logbarrier"`` constraints as ECOS exp
cones adding sum_i -(1/alpha) log(alpha(b_i - a_i'z)) to the objective
(``cone_utils.jl:173-232``); pmpc_tpu solves the same problem as the central
path point at mu = 1/alpha. Here the smoothed problem is minimized DIRECTLY
(scipy on the barrier objective) and compared.
"""

import numpy as np
import pytest
import scipy.optimize as sopt

import pmpc_tpu
from fixtures import dubins_f_fx_fu_fn

import oracle


def _canonical_matrices(prob, weights=None):
    """P, q, A, b of the canonical consensus QP, with reference weight scaling
    (scale_probs_cost!: Q, R, reg_x, reg_u, slew_reg, slew_reg0, slew_um1 all
    scaled by the normalized weight)."""
    M = prob["Q"].shape[0]
    p = dict(prob)
    reg_x = np.broadcast_to(np.asarray(p.pop("reg_x"), float), (M,)).copy()
    reg_u = np.broadcast_to(np.asarray(p.pop("reg_u"), float), (M,)).copy()
    slew_reg = np.broadcast_to(np.asarray(p.pop("slew_reg"), float), (M,)).copy()
    slew_reg0 = np.broadcast_to(np.asarray(p.pop("slew_reg0"), float), (M,)).copy()
    udim = prob["R"].shape[-1]
    slew_um1 = np.broadcast_to(np.asarray(p.pop("slew_um1"), float), (M, udim)).copy()
    Q, R = np.array(p.pop("Q")), np.array(p.pop("R"))
    Nc = p.pop("Nc")
    if weights is not None:
        w = np.asarray(weights, float)
        w = w / w.sum()
        Q *= w[:, None, None, None]
        R *= w[:, None, None, None]
        reg_x, reg_u = reg_x * w, reg_u * w
        slew_reg, slew_reg0 = slew_reg * w, slew_reg0 * w
        slew_um1 = slew_um1 * w[:, None]
    P, q = oracle.build_Pq(Q=Q, R=R, reg_x=reg_x, reg_u=reg_u, slew_reg=slew_reg,
                           slew_reg0=slew_reg0, slew_um1=slew_um1, Nc=Nc, **p)
    A, b = oracle.build_Ab(prob["x0"], prob["f"], prob["fx"], prob["fu"],
                           prob["X_prev"], prob["U_prev"], Nc)
    return P, q, A, b


def _z_bounds(u_l, u_u, M, N, xdim, udim, Nc):
    """scipy Bounds over z for control box bounds (consensus takes particle 0,
    lqp_utils.jl:323-331)."""
    n, u_idx, x_idx = oracle.layout(N, xdim, udim, M, Nc)
    lo, hi = np.full(n, -np.inf), np.full(n, np.inf)
    for i in range(M):
        for j in range(N):
            sl = u_idx(i, j)
            src = 0 if j < Nc else i
            lo[sl] = np.maximum(lo[sl], u_l[src, j])
            hi[sl] = np.minimum(hi[sl], u_u[src, j])
    return sopt.Bounds(lo, hi)


def ref_scp_solve(f_fx_fu_fn, Q, R, x0, max_it, reg_x, reg_u,
                  X_ref=None, U_ref=None, slew_rate=0.0, u_slew=None,
                  u_l=None, u_u=None, Nc=-1, weights=None):
    """Independent reference-semantics SCP solve. Batched (M, ...) inputs."""
    M, N, xdim = Q.shape[:3]
    udim = R.shape[-1]
    Nc = Nc if Nc >= 0 else N
    X_ref = np.zeros((M, N, xdim)) if X_ref is None else X_ref
    U_ref = np.zeros((M, N, udim)) if U_ref is None else U_ref
    X_prev, U_prev = X_ref.copy(), U_ref.copy()
    slew_reg = float(slew_rate)
    # reference static-backend default: the first-control anchor weight
    # defaults to slew_reg (static_backend.py:262-272)
    slew_reg0 = slew_reg if u_slew is not None else 0.0
    slew_um1 = (np.broadcast_to(np.asarray(u_slew, float), (M, udim)).copy()
                if u_slew is not None else np.zeros((M, udim)))

    X = U = None
    for _ in range(max_it):
        x_at = np.concatenate([x0[:, None, :], X_prev[:, :-1, :]], axis=1)
        f, fx, fu = f_fx_fu_fn(x_at, U_prev)
        f = np.asarray(f, float).reshape(M, N, xdim)
        fx = np.asarray(fx, float).reshape(M, N, xdim, xdim)
        fu = np.asarray(fu, float).reshape(M, N, xdim, udim)
        prob = dict(x0=x0, f=f, fx=fx, fu=fu, X_prev=X_prev, U_prev=U_prev,
                    Q=Q, R=R, X_ref=X_ref, U_ref=U_ref,
                    reg_x=reg_x, reg_u=reg_u, slew_reg=slew_reg,
                    slew_reg0=slew_reg0, slew_um1=slew_um1, Nc=Nc)
        P, q, A, b = _canonical_matrices(prob, weights=weights)
        if u_l is None:
            z = oracle.solve_eq_kkt(P, q, A, b)
        else:
            bounds = _z_bounds(u_l, u_u, M, N, xdim, udim, Nc)
            z0 = np.clip(oracle.solve_eq_kkt(P, q, A, b), bounds.lb, bounds.ub)
            res = sopt.minimize(
                lambda z_: 0.5 * z_ @ P @ z_ + q @ z_, z0,
                jac=lambda z_: P @ z_ + q, hess=lambda z_: P,
                constraints=[sopt.LinearConstraint(A, b, b)], bounds=bounds,
                method="trust-constr",
                options=dict(maxiter=4000, gtol=1e-12, xtol=1e-14))
            z = res.x
        X, U = oracle.split_z(z, N, xdim, udim, M, Nc)
        X_prev, U_prev = X, U
    return X, U


def test_parity_slew_anchored_single_system():
    """Dubins car with slew coupling + first-control anchor, equal budget."""
    f_fn = dubins_f_fx_fu_fn()
    N, xdim, udim, max_it = 8, 4, 2, 5
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    x0 = np.ones(xdim)
    u_slew = np.array([0.3, -0.2])

    X, U, data = pmpc_tpu.solve(
        f_fn, Q, R, x0, max_it=max_it, res_tol=0.0, verbose=False,
        reg_x=1.0, reg_u=0.1, slew_rate=0.5, u0_slew=u_slew,
    )
    X_r, U_r = ref_scp_solve(
        f_fn, Q[None], R[None], x0[None], max_it=max_it,
        reg_x=1.0, reg_u=0.1, slew_rate=0.5, u_slew=u_slew,
    )
    err = np.abs(U - U_r[0]).max()
    assert err <= 1e-3, f"|U - U_ref|_inf = {err:.2e}"


def test_parity_weights_Nc_bounds_slew():
    """M=3 weighted particles, consensus Nc=2, box bounds, slew anchor —
    including the reference's slew_um1 weight scaling (main.jl:107)."""
    f_fn = dubins_f_fx_fu_fn()
    M, N, xdim, udim, max_it, Nc = 3, 6, 4, 2, 4, 2
    rng = np.random.default_rng(3)
    Q = np.tile(np.eye(xdim), (M, N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (M, N, 1, 1))
    x0 = np.ones((M, xdim)) + 0.1 * rng.normal(size=(M, xdim))
    weights = np.array([0.5, 0.3, 0.2])
    u_l = -0.8 * np.ones((M, N, udim))
    u_u = 0.8 * np.ones((M, N, udim))
    u_slew = np.array([0.2, 0.1])

    X, U, data = pmpc_tpu.solve(
        f_fn, Q, R, x0, max_it=max_it, res_tol=0.0, verbose=False,
        reg_x=1.0, reg_u=0.1, slew_rate=0.3, u0_slew=u_slew,
        u_l=u_l, u_u=u_u,
        solver_settings=dict(Nc=Nc, weights=weights, ipm_tol_exp=-9,
                             ipm_iters=50),
    )
    X_r, U_r = ref_scp_solve(
        f_fn, Q, R, x0, max_it=max_it,
        reg_x=1.0, reg_u=0.1, slew_rate=0.3, u_slew=u_slew,
        u_l=u_l, u_u=u_u, Nc=Nc, weights=weights,
    )
    err = np.abs(U - U_r).max()
    assert err <= 1e-3, f"|U - U_ref|_inf = {err:.2e}"
    # consensus block shared in both
    assert np.ptp(U[:, :Nc], axis=0).max() < 1e-6
    assert np.ptp(U_r[:, :Nc], axis=0).max() < 1e-6


def test_parity_logbarrier_smoothing_is_expcone_solution():
    """The reference encodes logbarrier smoothing as ECOS exp
    cones, i.e. it MINIMIZES 0.5 z'Pz + q'z + sum_i -(1/a) log(a(b_i - g_i'z))
    (cone_utils.jl:173-232). pmpc_tpu's central-path solve (mu_target = 1/a)
    must land on the same point."""
    f_fn = dubins_f_fx_fu_fn()
    N, xdim, udim = 6, 4, 2
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    x0 = np.ones(xdim)
    alpha = 50.0
    lim = 0.6
    max_it = 4

    X, U, data = pmpc_tpu.solve(
        f_fn, Q, R, x0, max_it=max_it, res_tol=0.0, verbose=False,
        reg_x=1.0, reg_u=0.1,
        u_l=-lim * np.ones((N, udim)), u_u=lim * np.ones((N, udim)),
        solver_settings=dict(smooth_cstr="logbarrier", smooth_alpha=alpha,
                             ipm_iters=60, ipm_tol_exp=-10),
    )

    # independent: same SCP loop, subproblem = barrier objective minimized
    # directly over the null space of the dynamics equality
    M, Nc = 1, N
    Qb, Rb, x0b = Q[None], R[None], x0[None]
    X_prev = np.zeros((M, N, xdim))
    U_prev = np.zeros((M, N, udim))
    for _ in range(max_it):
        x_at = np.concatenate([x0b[:, None, :], X_prev[:, :-1, :]], axis=1)
        f, fx, fu = f_fn(x_at, U_prev)
        prob = dict(x0=x0b, f=np.asarray(f, float).reshape(M, N, xdim),
                    fx=np.asarray(fx, float).reshape(M, N, xdim, xdim),
                    fu=np.asarray(fu, float).reshape(M, N, xdim, udim),
                    X_prev=X_prev, U_prev=U_prev, Q=Qb, R=Rb,
                    X_ref=np.zeros((M, N, xdim)), U_ref=np.zeros((M, N, udim)),
                    reg_x=1.0, reg_u=0.1, slew_reg=0.0, slew_reg0=0.0,
                    slew_um1=np.zeros((M, udim)), Nc=Nc)
        P, q, A, b = _canonical_matrices(prob)
        n, u_idx, x_idx = oracle.layout(N, xdim, udim, M, Nc)
        # barrier terms on every control coordinate: g'z <= lim and -g'z <= lim
        rows = []
        for i in range(M):
            for j in range(N):
                sl = u_idx(i, j)
                for r in range(udim):
                    e = np.zeros(n)
                    e[sl.start + r] = 1.0
                    rows.append((e, lim))
                    rows.append((-e, lim))

        G_rows = np.stack([gi for gi, _ in rows])
        h_rows = np.array([bi for _, bi in rows])

        def kkt_resid(z, nu):
            slack = h_rows - G_rows @ z
            rz = P @ z + q + G_rows.T @ (1.0 / (alpha * slack)) + A.T @ nu
            return rz, A @ z - b, slack

        # damped Newton on the equality-constrained barrier optimality system
        # (quadratic convergence to the exact smoothed optimum)
        z = oracle.solve_eq_kkt(P, q, A, b)
        for i in range(M):
            for j in range(N):
                sl = u_idx(i, j)
                z[sl] = np.clip(z[sl], -0.95 * lim, 0.95 * lim)
        nu = np.zeros(A.shape[0])
        for _ in range(80):
            rz, ra, slack = kkt_resid(z, nu)
            H = P + (G_rows.T / (alpha * slack**2)) @ G_rows
            KKT = np.block([[H, A.T], [A, np.zeros((A.shape[0], A.shape[0]))]])
            step = np.linalg.solve(KKT, -np.concatenate([rz, ra]))
            dz, dnu = step[:n], step[n:]
            # damp to stay strictly inside the barrier domain
            ds = -G_rows @ dz
            neg = ds < 0
            amax = np.min(-slack[neg] / ds[neg]) if np.any(neg) else np.inf
            a = min(1.0, 0.99 * amax)
            z, nu = z + a * dz, nu + a * dnu
            if max(np.abs(rz).max(), np.abs(ra).max()) < 1e-12:
                break
        Xr, Ur = oracle.split_z(z, N, xdim, udim, M, Nc)
        X_prev, U_prev = Xr, Ur

    err = np.abs(U - Ur[0]).max()
    assert err <= 1e-3, f"|U_smooth - U_barrier|_inf = {err:.2e}"
    # the smoothed solution must differ measurably from the EXACT box solution
    X_e, U_e, _ = pmpc_tpu.solve(
        f_fn, Q, R, x0, max_it=max_it, res_tol=0.0, verbose=False,
        reg_x=1.0, reg_u=0.1,
        u_l=-lim * np.ones((N, udim)), u_u=lim * np.ones((N, udim)),
        solver_settings=dict(ipm_iters=60, ipm_tol_exp=-10),
    )
    assert np.abs(U_e - U).max() > 1e-3, "smoothing should visibly relax the bound"
