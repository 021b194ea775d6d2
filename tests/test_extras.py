"""extra_cstrs: user SOC constraints through the full solve path (config 3)."""

import numpy as np
import pytest
import scipy.optimize as sopt

import pmpc_tpu
from pmpc_tpu.solvers.dispatch import affine_solve_np
from fixtures import dubins_f_fx_fu_fn

import oracle


def _u_norm_socs(M, N, xdim, udim, Nc, umax):
    """One SOC per (particle, step): ||u_{i,j}|| <= umax.

    Built in the reference extra_cstrs format over the canonical layout
    z_full = [u_cons; u_free; x]."""
    nc, nf = Nc * udim, (N - Nc) * udim
    nu_total = nc + M * nf
    n_full = nu_total + M * N * xdim
    n, u_idx, x_idx = oracle.layout(N, xdim, udim, M, Nc)
    rows = []
    hs = []
    qsizes = []
    seen = set()
    for i in range(M):
        for j in range(N):
            sl = u_idx(i, j)
            key = (sl.start, sl.stop)
            if key in seen:  # consensus controls shared: constrain once
                continue
            seen.add(key)
            G = np.zeros((1 + udim, n_full))
            h = np.zeros(1 + udim)
            h[0] = umax
            for r in range(udim):
                G[1 + r, sl.start + r] = -1.0  # s_r = u_r (s = h - Gz)
            rows.append(G)
            hs.append(h)
            qsizes.append(1 + udim)
    G_left = np.concatenate(rows, axis=0)
    h = np.concatenate(hs)
    G_right = np.zeros((G_left.shape[0], 0))
    c_left = np.zeros(n_full)
    c_right = np.zeros(0)
    return (0, qsizes, 0, G_left, G_right, h, c_left, c_right)


def test_affine_solve_with_soc_matches_oracle():
    rng = np.random.default_rng(21)
    M, N, xdim, udim, Nc = 2, 6, 3, 2, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    umax = 0.6
    ec = _u_norm_socs(M, N, xdim, udim, Nc, umax)

    X, U, data = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"],
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M), slew_um1=np.zeros((M, udim)),
        u_l=None, u_u=None, x_l=None, x_u=None,
        Nc=Nc, settings=dict(extra_cstrs=[ec]),
    )
    assert data["ipm_converged"], data
    norms = np.linalg.norm(U, axis=-1)
    assert norms.max() <= umax + 1e-6
    # consensus shared
    assert np.ptp(U[:, :Nc, :], axis=0).max() < 1e-10

    # oracle: canonical z_full QP with eq dynamics + per-step SOC constraints
    P, q = oracle.build_Pq(**p, reg_x=1.0, reg_u=0.1, slew_reg=np.zeros(M),
                           slew_reg0=np.zeros(M), slew_um1=np.zeros((M, udim)), Nc=Nc)
    A, b = oracle.build_Ab(p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"], Nc)
    n, u_idx, x_idx = oracle.layout(N, xdim, udim, M, Nc)
    cons = [sopt.LinearConstraint(A, b, b)]
    seen = set()
    for i in range(M):
        for j in range(N):
            sl = u_idx(i, j)
            if (sl.start, sl.stop) in seen:
                continue
            seen.add((sl.start, sl.stop))

            def make(sl=sl):
                return lambda z: umax - np.linalg.norm(z[sl])

            cons.append(sopt.NonlinearConstraint(make(), 0.0, np.inf))
    z0 = oracle.solve_eq_kkt(P, q, A, b)
    res = sopt.minimize(lambda z: 0.5 * z @ P @ z + q @ z, z0,
                        jac=lambda z: P @ z + q, hess=lambda z: P,
                        constraints=cons, method="trust-constr",
                        options=dict(maxiter=3000, gtol=1e-12, xtol=1e-14))
    X_o, U_o = oracle.split_z(res.x, N, xdim, udim, M, Nc)
    np.testing.assert_allclose(U, U_o, atol=2e-4)


def test_scp_solve_with_soc_extra_cstrs():
    """End-to-end SCP with a thrust-cone style constraint on the Dubins car."""
    N, xdim, udim = 12, 4, 2
    umax = 0.8
    f_fn = dubins_f_fx_fu_fn()
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))

    def extra_cstrs_fns(X_prev, U_prev, problems):
        return [_u_norm_socs(1, N, xdim, udim, N, umax)]  # default full consensus

    X, U, data = pmpc_tpu.solve(
        f_fn, Q, R, np.ones(xdim),
        extra_cstrs_fns=extra_cstrs_fns,
        reg_x=1.0, reg_u=0.1, max_it=40, res_tol=1e-5, verbose=False,
    )
    assert X is not None
    assert data["hist"][-1]["resid"] < 1e-4
    norms = np.linalg.norm(U, axis=-1)
    assert norms.max() <= umax + 1e-5
    assert norms.max() > umax - 0.05, "the cone constraint should be active"


def test_terminal_cross_particle_cost_Hf():
    """Hf couples final states across particles (lqp_utils.jl:105-163):
    a strong cross-particle attraction should pull final states together."""
    rng = np.random.default_rng(40)
    M, N, xdim, udim, Nc = 2, 6, 3, 2, 0
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)

    def solve(Hf=None):
        ss = {} if Hf is None else dict(Hf=Hf)
        return affine_solve_np(
            p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"],
            reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
            slew_reg=np.zeros(M), slew_reg0=np.zeros(M), slew_um1=np.zeros((M, udim)),
            u_l=None, u_u=None, x_l=None, x_u=None, Nc=Nc, settings=ss,
        )

    # Hf implementing w * ||xN_1 - xN_2||^2 (PSD, couples particles)
    w = 50.0
    I = np.eye(xdim)
    Hf = w * np.block([[I, -I], [-I, I]])
    X0, U0, _ = solve()
    X1, U1, d1 = solve(Hf)
    gap0 = np.linalg.norm(X0[0, -1] - X0[1, -1])
    gap1 = np.linalg.norm(X1[0, -1] - X1[1, -1])
    assert gap1 < 0.25 * gap0, (gap0, gap1)

    # oracle: dense canonical QP with the Hf block at the final states
    P, q = oracle.build_Pq(**p, reg_x=1.0, reg_u=0.1, slew_reg=np.zeros(M),
                           slew_reg0=np.zeros(M), slew_um1=np.zeros((M, udim)), Nc=Nc)
    A, b = oracle.build_Ab(p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"], Nc)
    n, u_idx, x_idx = oracle.layout(N, xdim, udim, M, Nc)
    for i in range(M):
        for i2 in range(M):
            P[x_idx(i, N - 1), x_idx(i2, N - 1)] += Hf[i * xdim:(i + 1) * xdim,
                                                       i2 * xdim:(i2 + 1) * xdim]
    z = oracle.solve_eq_kkt(P, q, A, b)
    X_o, U_o = oracle.split_z(z, N, xdim, udim, M, Nc)
    np.testing.assert_allclose(U1, U_o, atol=1e-5)


def test_exp_cone_extra_constraint():
    """User exp-cone extra constraints (reference-legal: cone_utils.jl encodes
    logbarrier terms as exp cones) solve on the device central-path barrier
    solver, with the scipy host fallback agreeing. Encoding under
    this framework's s = h - Gz convention: minimize +t subject to
    exp(-a t) <= a (b - g'z), i.e. t >= -(1/a) log(a (b - g'z)) — so the
    optimum equals the barrier optimum min f(z) - (1/a) log(a (b - g'z)) + t*,
    checked against an independent damped-Newton barrier solve."""
    rng = np.random.default_rng(11)
    M, N, xdim, udim, Nc = 1, 5, 3, 2, 5
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    alpha, b_lim = 25.0, 0.2
    nc, nf = Nc * udim, (N - Nc) * udim
    nu_total = nc + M * nf
    n_full = nu_total + M * N * xdim
    # constrain the first coordinate of u_0: g'z <= b_lim
    g = np.zeros(n_full)
    g[0] = 1.0
    G_left = np.vstack([np.zeros(n_full), alpha * g, np.zeros(n_full)])
    G_right = np.array([[alpha], [0.0], [0.0]])
    h = np.array([0.0, alpha * b_lim, 1.0])
    c_left = np.zeros(n_full)
    c_right = np.array([1.0])
    ec = (0, [], 1, G_left, G_right, h, c_left, c_right)

    from pmpc_tpu.solvers.dispatch import affine_solve_np

    X, U, data = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"],
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M), slew_um1=np.zeros((M, udim)),
        u_l=None, u_u=None, x_l=None, x_u=None,
        Nc=Nc, settings=dict(extra_cstrs=[ec]),
    )
    # exp cones default to the device central-path barrier solver
    assert data.get("exp_device"), data

    # the scipy host fallback must agree with the device path
    X_h, U_h, data_h = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"],
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M), slew_um1=np.zeros((M, udim)),
        u_l=None, u_u=None, x_l=None, x_u=None,
        Nc=Nc, settings=dict(extra_cstrs=[ec], exp_device=False),
    )
    assert data_h.get("exp_host_fallback"), data_h
    np.testing.assert_allclose(U, U_h, atol=1e-6)

    # independent barrier optimum: damped Newton on the equality-constrained
    # optimality system of f(z) - (1/alpha) log(alpha (b - g'z))
    P, q = oracle.build_Pq(**p, reg_x=1.0, reg_u=0.1, slew_reg=np.zeros(M),
                           slew_reg0=np.zeros(M), slew_um1=np.zeros((M, udim)), Nc=Nc)
    A, bb = oracle.build_Ab(p["x0"], p["f"], p["fx"], p["fu"],
                            p["X_prev"], p["U_prev"], Nc)
    n = P.shape[0]
    z = oracle.solve_eq_kkt(P, q, A, bb)
    z[0] = min(z[0], 0.9 * b_lim)
    nu = np.zeros(A.shape[0])
    for _ in range(60):
        slack = b_lim - g @ z
        rz = P @ z + q + g / (alpha * slack) + A.T @ nu
        ra = A @ z - bb
        H = P + np.outer(g, g) / (alpha * slack**2)
        KKT = np.block([[H, A.T], [A, np.zeros((A.shape[0], A.shape[0]))]])
        step = np.linalg.solve(KKT, -np.concatenate([rz, ra]))
        dz, dnu = step[:n], step[n:]
        dslack = -(g @ dz)
        amax = (-slack / dslack) if dslack < 0 else np.inf
        a = min(1.0, 0.99 * amax)
        z, nu = z + a * dz, nu + a * dnu
        if max(np.abs(rz).max(), np.abs(ra).max()) < 1e-12:
            break
    X_o, U_o = oracle.split_z(z, N, xdim, udim, M, Nc)
    np.testing.assert_allclose(U, U_o, atol=5e-4)


def test_exp_device_with_mixed_cone_families():
    """Exp cones + box bounds (nonneg rows) + a SOC in ONE program: all three
    barrier families of the device central-path solver active together,
    checked against the scipy host fallback."""
    rng = np.random.default_rng(13)
    M, N, xdim, udim, Nc = 1, 4, 3, 2, 4
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    alpha, b_lim = 20.0, 0.25
    nc = Nc * udim
    n_full = nc + M * N * xdim
    g = np.zeros(n_full)
    g[1] = 1.0  # second control coordinate
    G_exp = np.vstack([np.zeros(n_full), alpha * g, np.zeros(n_full)])
    Gr_exp = np.array([[alpha], [0.0], [0.0]])
    h_exp = np.array([0.0, alpha * b_lim, 1.0])
    ec_exp = (0, [], 1, G_exp, Gr_exp, h_exp, np.zeros(n_full), np.array([1.0]))
    # SOC on u_1: ||u_1|| <= 0.8
    G_soc = np.zeros((1 + udim, n_full))
    for r in range(udim):
        G_soc[1 + r, udim + r] = -1.0
    h_soc = np.concatenate([[0.8], np.zeros(udim)])
    ec_soc = (0, [1 + udim], 0, G_soc, np.zeros((1 + udim, 0)), h_soc,
              np.zeros(n_full), np.zeros(0))

    udim_arr = 1.2 * np.ones((M, N, udim))
    kw = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=-udim_arr, u_u=udim_arr, x_l=None, x_u=None, Nc=Nc)
    X_d, U_d, d_d = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"],
        settings=dict(extra_cstrs=[ec_exp, ec_soc]), **kw)
    assert d_d.get("exp_device"), d_d
    X_h, U_h, d_h = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"],
        settings=dict(extra_cstrs=[ec_exp, ec_soc], exp_device=False), **kw)
    assert d_h.get("exp_host_fallback"), d_h
    np.testing.assert_allclose(U_d, U_h, atol=2e-5)
    # constraints hold on the device solution
    assert U_d[0, 0, 1] <= b_lim + 1e-6
    assert np.linalg.norm(U_d[0, 1]) <= 0.8 + 1e-6
    assert np.abs(U_d).max() <= 1.2 + 1e-6


def test_extras_row_count_mismatch_raises():
    """Under/over-declared constraint rows must raise, not silently truncate
    (the sliced assembly would otherwise 'converge' on the wrong geometry)."""
    import pytest

    rng = np.random.default_rng(78)
    M, N, xdim, udim, Nc = 1, 4, 3, 2, 4
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    n_full = N * udim + N * xdim
    # declares one 3-row SOC but provides only 2 rows
    bad = (0, [3], 0, np.zeros((2, n_full)), np.zeros((2, 0)), np.zeros(2),
           np.zeros(n_full), np.zeros(0))
    with pytest.raises(ValueError, match="rows"):
        affine_solve_np(
            p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"],
            reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
            slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
            slew_um1=np.zeros((M, udim)),
            u_l=None, u_u=None, x_l=None, x_u=None,
            Nc=Nc, settings=dict(extra_cstrs=[bad]),
        )


def _lin_rows_feasible(rng, M, N, xdim, udim, Nc, l=4, margin=2.5):
    """Random LINEAR rows g'z <= h over the full consensus layout, with h
    chosen loose enough relative to control-only activity to stay feasible
    (control coefficients only — state-involving feasibility is exercised by
    the dedicated active-row test below)."""
    nc, nf = Nc * udim, (N - Nc) * udim
    n_full = nc + M * nf + M * N * xdim
    nu_total = nc + M * nf
    G = np.zeros((l, n_full))
    G[:, :nu_total] = 0.5 * rng.standard_normal((l, nu_total))
    h = margin + 0.2 * rng.random(l)
    return (l, [], 0, G, np.zeros((l, 0)), h, np.zeros(n_full), np.zeros(0))


def test_linear_extras_structured_matches_composed_and_oracle():
    """LINEAR-only extra rows ride the arrow IPM as SMW borders
    (ipm.ExtraRows) instead of densifying through the composed cone path;
    both routes and the scipy oracle must agree. Reference: linear
    `extra_cstrs` rows of main.jl:292-316."""
    rng = np.random.default_rng(55)
    M, N, xdim, udim, Nc = 2, 6, 3, 2, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    nc, nf = Nc * udim, (N - Nc) * udim
    n_full = nc + M * nf + M * N * xdim
    # one ACTIVE control row + one loose state-involving row
    G = np.zeros((2, n_full))
    G[0, :udim] = 1.0                       # sum of first consensus controls
    G[1, nc + M * nf:] = 0.01 * rng.standard_normal(M * N * xdim)
    h = np.array([0.05, 50.0])
    ec = (2, [], 0, G, np.zeros((2, 0)), h, np.zeros(n_full), np.zeros(0))

    kw = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=None, u_u=None, x_l=None, x_u=None, Nc=Nc,
    )
    X_s, U_s, d_s = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"], **kw,
        settings=dict(extra_cstrs=[ec]))
    assert d_s["ipm_converged"], d_s
    assert "aux" not in d_s, "linear extras must stay on the structured path"

    X_c, U_c, d_c = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"], **kw,
        settings=dict(extra_cstrs=[ec], extras_structured=False))
    assert d_c["ipm_converged"], d_c
    assert "aux" in d_c, "extras_structured=False must take the composed path"
    np.testing.assert_allclose(U_s, U_c, atol=5e-5)

    # scipy oracle on the canonical QP with the linear rows
    P, q = oracle.build_Pq(**p, reg_x=1.0, reg_u=0.1, slew_reg=np.zeros(M),
                           slew_reg0=np.zeros(M),
                           slew_um1=np.zeros((M, udim)), Nc=Nc)
    A, b = oracle.build_Ab(p["x0"], p["f"], p["fx"], p["fu"],
                           p["X_prev"], p["U_prev"], Nc)
    z0 = oracle.solve_eq_kkt(P, q, A, b)
    res = sopt.minimize(
        lambda z: 0.5 * z @ P @ z + q @ z, z0,
        jac=lambda z: P @ z + q, hess=lambda z: P,
        constraints=[sopt.LinearConstraint(A, b, b),
                     sopt.LinearConstraint(G, -np.inf, h)],
        method="trust-constr",
        options=dict(maxiter=3000, gtol=1e-12, xtol=1e-14))
    X_o, U_o = oracle.split_z(res.x, N, xdim, udim, M, Nc)
    np.testing.assert_allclose(U_s, U_o, atol=2e-4)
    # the control row is active
    assert abs(float(U_s[0, 0].sum()) - 0.05) < 1e-4


def test_linear_extras_structured_with_boxes_and_soc():
    """The bordered extras rows compose with u-boxes AND per-stage control
    SOC cones on the same arrow solve (has_u + has_soc + has_ex): the dense
    composed path is the cross-check."""
    rng = np.random.default_rng(56)
    M, N, xdim, udim, Nc = 2, 5, 3, 2, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    ec = _lin_rows_feasible(rng, M, N, xdim, udim, Nc, l=3, margin=0.3)
    umax = 0.7
    kw = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=-0.9 * np.ones((M, N, udim)), u_u=0.9 * np.ones((M, N, udim)),
        x_l=None, x_u=None, Nc=Nc,
    )
    X_s, U_s, d_s = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"], **kw,
        settings=dict(extra_cstrs=[ec], u_soc_r=np.full((M, N), umax),
                      ipm_iters=40, ipm_tol_exp=-9))
    assert d_s["ipm_converged"], d_s
    assert "aux" not in d_s

    # cross-check: same program with the SOC cones expressed as SOC extras,
    # with the structured detection OFF so the dense composed path solves it
    # (round 5's split_stage_u_cones would otherwise convert the q-rows
    # right back to u_soc_r cones)
    from test_extras import _u_norm_socs
    ec_soc = _u_norm_socs(M, N, xdim, udim, Nc, umax)
    X_c, U_c, d_c = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"], **kw,
        settings=dict(extra_cstrs=[ec, ec_soc], extras_structured=False))
    assert d_c["ipm_converged"], d_c
    assert "aux" in d_c
    np.testing.assert_allclose(U_s, U_c, atol=2e-4)
    assert np.linalg.norm(U_s, axis=-1).max() <= umax + 1e-5
    assert np.abs(U_s).max() <= 0.9 + 1e-6


def test_linear_extras_structured_warm_start():
    """solver_state warm starts thread through the bordered solve: the
    extended multiplier vector (incl. the l extras rows) round-trips and the
    re-solve accepts it."""
    rng = np.random.default_rng(57)
    M, N, xdim, udim, Nc = 2, 5, 3, 2, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    ec = _lin_rows_feasible(rng, M, N, xdim, udim, Nc, l=3, margin=0.3)
    kw = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=None, u_u=None, x_l=None, x_u=None, Nc=Nc,
    )
    X1, U1, d1 = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"], **kw,
        settings=dict(extra_cstrs=[ec]))
    assert d1["ipm_converged"]
    st = d1["solver_state"]
    assert "ipm_warm" in st
    X2, U2, d2 = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"], **kw,
        settings=dict(extra_cstrs=[ec], solver_state=st))
    assert d2["ipm_converged"]
    np.testing.assert_allclose(U1, U2, atol=1e-6)
    assert int(d2["ipm_iters"]) <= int(d1["ipm_iters"])


def test_stage_u_cone_extras_take_structured_route():
    """Per-stage control-norm SOC extras are detected (split_stage_u_cones)
    and solved as u_soc_r cones on the structured arrow IPM — the composed
    dense cone program must NOT be built. Mixed with linear rows, the rows
    ride the SMW border; numerics match the composed route."""
    from pmpc_tpu.solvers import compose as comp

    rng = np.random.default_rng(33)
    M, N, xdim, udim, Nc = 3, 8, 3, 2, 3
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    umax = 0.55
    ec = _u_norm_socs(M, N, xdim, udim, Nc, umax)
    # one extra LINEAR row: sum of first-stage controls bounded
    nc, nf = Nc * udim, (N - Nc) * udim
    n_full = nc + M * nf + M * N * xdim
    gl = np.zeros((1, n_full))
    gl[0, :udim] = 1.0
    ec_lin = (1, [], 0, gl, np.zeros((1, 0)), np.array([0.3]),
              np.zeros(n_full), np.zeros(0))

    args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"])
    kw = dict(reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
              slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
              slew_um1=np.zeros((M, udim)),
              u_l=None, u_u=None, x_l=None, x_u=None, Nc=Nc)

    orig = comp.composed_cone_solve

    def boom(*a, **k):
        raise AssertionError("stage u-cone extras must not densify through "
                             "the composed cone path")

    comp.composed_cone_solve = boom
    try:
        X, U, data = affine_solve_np(
            *args, **kw, settings=dict(extra_cstrs=[ec, ec_lin]))
    finally:
        comp.composed_cone_solve = orig
    assert data["ipm_converged"], data
    assert np.linalg.norm(U, axis=-1).max() <= umax + 1e-6
    assert U[:, 0, :].sum(axis=-1).max() <= 0.3 + 1e-6

    # composed reference (detection off)
    X2, U2, d2 = affine_solve_np(
        *args, **kw,
        settings=dict(extra_cstrs=[ec, ec_lin], extras_structured=False))
    np.testing.assert_allclose(U, U2, atol=5e-4)


def test_non_stage_soc_extras_stay_composed():
    """A SOC over a STATE slice does not match the stage-control pattern:
    detection must decline and the composed path must solve it."""
    rng = np.random.default_rng(34)
    M, N, xdim, udim, Nc = 2, 6, 3, 2, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    nc, nf = Nc * udim, (N - Nc) * udim
    n_full = nc + M * nf + M * N * xdim
    n, u_idx, x_idx = oracle.layout(N, xdim, udim, M, Nc)
    sl = x_idx(0, N - 1)
    G = np.zeros((1 + xdim, n_full))
    h = np.zeros(1 + xdim)
    h[0] = 2.0
    for r in range(xdim):
        G[1 + r, sl.start + r] = -1.0
    ec = (0, [1 + xdim], 0, G, np.zeros((1 + xdim, 0)), h,
          np.zeros(n_full), np.zeros(0))
    X, U, data = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"],
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=None, u_u=None, x_l=None, x_u=None,
        Nc=Nc, settings=dict(extra_cstrs=[ec]))
    assert data["ipm_converged"], data
    xN = X[:, -1, :]
    assert np.linalg.norm(xN, axis=-1).max() <= 2.0 + 1e-6
