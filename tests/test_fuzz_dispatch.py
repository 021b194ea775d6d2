"""Property fuzz: random problems x random feature combos vs the f64 oracle.

Sweeps the subtle interactions of the consensus layout (`lqp_utils.jl:26-103`
is the reference's hairiest indexing): consensus split Nc, per-particle
weights, slew coupling + u0 anchor, box bounds on controls/states — through
`affine_solve_np` (the host dispatch) and checks the returned controls against
the dense-KKT / trust-constr oracle on the SAME canonical QP.
"""

import numpy as np
import pytest

from pmpc_tpu.solvers.dispatch import affine_solve_np

import oracle


def _features(rng):
    """Random feature combo for one fuzz case."""
    return dict(
        use_weights=bool(rng.integers(2)),
        use_slew=bool(rng.integers(2)),
        use_slew0=bool(rng.integers(2)),
        bounds=rng.choice(["none", "u", "x", "ux"]),
    )


def _run_case(seed):
    rng = np.random.default_rng(seed)
    M = int(rng.integers(1, 4))
    N = int(rng.integers(3, 8))
    xdim = int(rng.integers(2, 5))
    udim = int(rng.integers(1, 4))
    Nc = int(rng.integers(0, N + 1))
    feat = _features(rng)

    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    reg_x = np.full(M, 1.0)
    reg_u = np.full(M, 0.1)
    slew_reg = np.full(M, 0.5 if feat["use_slew"] else 0.0)
    slew_reg0 = np.full(M, 0.7 if feat["use_slew0"] else 0.0)
    slew_um1 = (0.3 * rng.normal(size=(M, udim))
                if feat["use_slew0"] else np.zeros((M, udim)))
    weights = np.abs(rng.normal(size=M)) + 0.2 if feat["use_weights"] else None

    u_l = u_u = x_l = x_u = None
    if "u" in feat["bounds"]:
        c = 0.2 * rng.normal(size=(M, N, udim))
        u_l, u_u = c - 0.6, c + 0.6
    if "x" in feat["bounds"]:
        # state bounds around a rollout that RESPECTS the u box and the
        # consensus split — random bounds around X_prev easily make the
        # joint u+x problem infeasible (the IPM then rightly reports
        # ipm_failed, but there is nothing to compare against the oracle)
        U_feas = (c.copy() if u_l is not None
                  else 0.2 * rng.normal(size=(M, N, udim)))
        U_feas[:, :Nc, :] = U_feas[:1, :Nc, :]  # consensus block shared
        X_feas = np.zeros((M, N, xdim))
        xc = None
        for j in range(N):
            du = U_feas[:, j] - p["U_prev"][:, j]
            step = p["f"][:, j] + np.einsum("mij,mj->mi", p["fu"][:, j], du)
            if j > 0:
                dx = xc - p["X_prev"][:, j - 1]
                step = step + np.einsum("mij,mj->mi", p["fx"][:, j], dx)
            xc = step
            X_feas[:, j] = xc
        x_l = np.minimum(X_feas, p["X_prev"]) - 2.0
        x_u = np.maximum(X_feas, p["X_prev"]) + 2.0

    settings = dict(Nc=Nc)
    if weights is not None:
        settings["weights"] = weights
    X, U, data = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"],
        reg_x=reg_x, reg_u=reg_u,
        slew_reg=slew_reg, slew_reg0=slew_reg0, slew_um1=slew_um1,
        u_l=u_l, u_u=u_u, x_l=x_l, x_u=x_u,
        Nc=Nc, settings=settings,
    )
    assert np.isfinite(U).all(), (seed, feat)

    # oracle on the same canonical QP (weights scale each particle's cost
    # terms before assembly, reference main.jl:96-112)
    if weights is not None:
        w = weights / np.sum(weights)
        Qw = p["Q"] * w[:, None, None, None]
        Rw = p["R"] * w[:, None, None, None]
        reg_x_o, reg_u_o = reg_x * w, reg_u * w
        slew_o, slew0_o = slew_reg * w, slew_reg0 * w
        slew_um1_o = slew_um1 * w[:, None]
    else:
        Qw, Rw = p["Q"], p["R"]
        reg_x_o, reg_u_o, slew_o, slew0_o = reg_x, reg_u, slew_reg, slew_reg0
        slew_um1_o = slew_um1
    P, q = oracle.build_Pq(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        Qw, Rw, p["X_ref"], p["U_ref"],
        reg_x_o, reg_u_o, slew_o, slew0_o, slew_um1_o, Nc)
    A, b = oracle.build_Ab(p["x0"], p["f"], p["fx"], p["fu"],
                           p["X_prev"], p["U_prev"], Nc)
    if feat["bounds"] == "none":
        z = oracle.solve_eq_kkt(P, q, A, b)
        tol = 2e-4
    else:
        lo, hi = oracle.bounds_vectors(x_l, x_u, u_l, u_u, N, xdim, udim, M, Nc)
        z = oracle.solve_box_qp(P, q, A, b, lo, hi, tol=1e-11)
        tol = 2e-3  # trust-constr active-set accuracy
    _, U_o = oracle.split_z(z, N, xdim, udim, M, Nc)
    err = np.max(np.abs(U - U_o))
    assert err < tol, (seed, feat, M, N, xdim, udim, Nc, err)
    # consensus contract: shared first-Nc controls identical across particles
    if M > 1 and Nc > 0:
        assert np.ptp(U[:, :Nc, :], axis=0).max() < 1e-5, (seed, feat)


@pytest.mark.parametrize("seed", range(101, 106))
def test_fuzz_consensus_qp_routes(seed):
    _run_case(seed)


@pytest.mark.nightly
@pytest.mark.parametrize("seed", range(106, 115))
def test_fuzz_consensus_qp_routes_full(seed):
    """Full-depth seed sweep (nightly marker; same oracle as the default
    subset above — suite-time budget)."""
    _run_case(seed)


def test_u_soc_r_combinations_enforce_cones():
    """u_soc_r must never be silently dropped: the CVaR and extras branches
    now COMPOSE the thrust cones into the same cone program (previously a
    NotImplementedError); the returned controls must respect every cone.
    Genuinely smooth-objective combinations still refuse loudly."""
    import pytest

    rng = np.random.default_rng(77)
    M, N, xdim, udim = 2, 5, 3, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    common = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=None, u_u=None, x_l=None, x_u=None, Nc=1)
    args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"])
    r = np.full((M, N), 0.5)
    nu_total = 1 * udim + M * (N - 1) * udim
    n_full = nu_total + M * N * xdim
    g = np.zeros((1, n_full))
    g[0, :udim] = 1.0
    ec = (1, [], 0, g, np.zeros((1, 0)), np.array([0.2]),
          np.zeros(n_full), np.zeros(0))

    _, U1, d1 = affine_solve_np(*args, **common,
                                settings=dict(u_soc_r=r, k=1))
    assert d1["ipm_converged"]
    assert np.linalg.norm(U1, axis=-1).max() <= 0.5 + 1e-6

    _, U2, d2 = affine_solve_np(*args, **common,
                                settings=dict(u_soc_r=r, extra_cstrs=[ec]))
    assert d2["ipm_converged"]
    assert np.linalg.norm(U2, axis=-1).max() <= 0.5 + 1e-6
    assert g[0, :nu_total] @ np.concatenate(
        [U2[0, :1].reshape(-1), U2[:, 1:].reshape(-1)]) <= 0.2 + 1e-6

    with pytest.raises(NotImplementedError):
        affine_solve_np(*args, **common,
                        settings=dict(u_soc_r=r, smooth_cstr="logbarrier",
                                      smooth_alpha=10.0, solver="CVX",
                                      extra_cstrs=[ec]))
    with pytest.raises(NotImplementedError):
        affine_solve_np(*args, **common,
                        settings=dict(u_soc_r=r,
                                      diff_cost_fn=lambda X, U: 0.0))


def test_batch_heterogeneous_scalars_fall_back_to_serial():
    """Differing scalar kwargs (reg_x) must not be silently overridden by
    problem 0's values in the stacked route."""
    import pmpc_tpu
    from fixtures import double_integrator_f_fx_fu_fn

    f_fn = double_integrator_f_fx_fu_fn()
    N, xdim, udim = 8, 2, 1
    base = dict(f_fx_fu_fn=f_fn, Q=np.tile(np.eye(xdim), (N, 1, 1)),
                R=np.tile(0.1 * np.eye(udim), (N, 1, 1)),
                x0=np.ones(xdim), max_it=8, res_tol=1e-7)
    problems = [dict(base, reg_u=0.1), dict(base, reg_u=50.0)]
    rets = pmpc_tpu.solve_problems(problems, verbose=False)
    for (X, U, data), p in zip(rets, problems):
        Xi, Ui, _ = pmpc_tpu.solve(**dict(p, verbose=False))
        np.testing.assert_allclose(U, Ui, atol=1e-8)
    # the two solutions must genuinely differ (reg_u=50 damps controls)
    assert np.abs(rets[0][1] - rets[1][1]).max() > 1e-3
