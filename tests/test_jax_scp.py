"""Fully-jitted SCP loop: agreement with the host-loop frontend + batching."""

import numpy as np
import jax
import jax.numpy as jnp

import pmpc_tpu
from pmpc_tpu.jax_scp import build_scp_solver, make_scp_data
from fixtures import unicycle_step, dubins_f_fx_fu_fn


def _dubins_data(M=1, N=15, xdim=4, udim=2, bounds=False):
    Q = np.tile(np.eye(xdim), (M, N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (M, N, 1, 1))
    x0 = np.tile(np.ones(xdim), (M, 1))
    kw = dict(reg_x=1.0, reg_u=0.1)
    if bounds:
        kw.update(u_l=-np.ones((M, N, udim)), u_u=np.ones((M, N, udim)))
    return make_scp_data(x0, Q, R, **kw)


def test_jitted_scp_matches_host_loop_unconstrained():
    M, N, xdim, udim = 1, 15, 4, 2
    data = _dubins_data(M, N)
    solver = build_scp_solver(unicycle_step, N, xdim, udim, M, Nc=0,
                              max_it=25, res_tol=1e-7)
    X, U, info = solver(data)
    assert X.shape == (M, N + 1, xdim)

    X_h, U_h, d = pmpc_tpu.solve(
        dubins_f_fx_fu_fn(), np.asarray(data.Q[0]), np.asarray(data.R[0]),
        np.ones(xdim), reg_x=1.0, reg_u=0.1, max_it=25, res_tol=1e-7,
        verbose=False, solver_settings=dict(Nc=0),
    )
    np.testing.assert_allclose(np.asarray(U[0]), U_h, atol=1e-6)
    np.testing.assert_allclose(np.asarray(X[0]), X_h, atol=1e-6)


def test_jitted_scp_matches_host_loop_bounded():
    M, N, xdim, udim = 1, 15, 4, 2
    data = _dubins_data(M, N, bounds=True)
    solver = build_scp_solver(unicycle_step, N, xdim, udim, M, Nc=0,
                              max_it=60, res_tol=1e-6, has_u_bounds=True,
                              ipm_iters=30, ipm_tol_exp=-8)
    X, U, info = solver(data)
    X_h, U_h, d = pmpc_tpu.solve(
        dubins_f_fx_fu_fn(), np.asarray(data.Q[0]), np.asarray(data.R[0]),
        np.ones(xdim),
        u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
        reg_x=1.0, reg_u=0.1, max_it=60, res_tol=1e-6,
        verbose=False, solver_settings=dict(Nc=0),
    )
    assert bool(info["converged"]), f"resid={info['resid']}"
    np.testing.assert_allclose(np.asarray(U[0]), U_h, atol=1e-4)


def test_jitted_scp_vmap_batch():
    """A scenario batch via vmap: each problem solved as if alone."""
    M, N, xdim, udim, B = 2, 10, 4, 2, 3
    rng = np.random.default_rng(0)
    datas = []
    for b in range(B):
        Q = np.tile(np.eye(xdim), (M, N, 1, 1))
        R = np.tile(1e-2 * np.eye(udim), (M, N, 1, 1))
        x0 = rng.normal(size=(M, xdim))
        datas.append(make_scp_data(x0, Q, R, reg_x=1.0, reg_u=0.1))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)
    solver = build_scp_solver(unicycle_step, N, xdim, udim, M, Nc=3,
                              max_it=15, res_tol=1e-6)
    Xb, Ub, infob = jax.vmap(solver)(stacked)
    assert Xb.shape == (B, M, N + 1, xdim)
    for b in range(B):
        X1, U1, _ = solver(datas[b])
        # vmap reassociates reductions; differences amplify over SCP iterations
        np.testing.assert_allclose(np.asarray(Ub[b]), np.asarray(U1), atol=5e-4)
    # consensus within each scenario
    assert np.ptp(np.asarray(Ub)[:, :, :3, :], axis=1).max() < 1e-10


def test_jitted_scp_per_particle_params():
    """Per-particle dynamics parameters (sampled-dynamics particles)."""
    M, N, xdim, udim = 3, 10, 4, 2
    params = jnp.stack([jnp.array([1.0 + 0.2 * i, 1.0, 0.3]) for i in range(M)])
    Q = np.tile(np.eye(xdim), (M, N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (M, N, 1, 1))
    data = make_scp_data(np.tile(np.ones(xdim), (M, 1)), Q, R,
                         reg_x=1.0, reg_u=0.1, params=params)

    def dyn(x, u, p):
        return unicycle_step(x, u, (p[0], p[1], p[2]))

    solver = build_scp_solver(dyn, N, xdim, udim, M, Nc=4, max_it=20, res_tol=1e-6)
    X, U, info = solver(data)
    assert np.ptp(np.asarray(U)[:, :4, :], axis=0).max() < 1e-10
    assert np.ptp(np.asarray(U)[:, 4:, :], axis=0).max() > 1e-8


def test_has_u_bounds_false_ignores_finite_bound_arrays():
    """The static has_u_bounds=False contract: finite bound arrays in SCPData
    are IGNORED (they used to activate mask rows whose barrier terms the
    Newton matrix skipped, stalling the IPM)."""
    import jax

    from fixtures import unicycle_step

    N, xdim, udim, M = 8, 4, 2, 2
    d = make_scp_data(
        np.ones((M, xdim)),
        np.tile(np.eye(xdim), (M, N, 1, 1)),
        np.tile(1e-2 * np.eye(udim), (M, N, 1, 1)),
        reg_x=1.0, reg_u=0.1,
        # tiny bounds that WOULD bind hard if they were enforced
        u_l=-1e-3 * np.ones((M, N, udim)), u_u=1e-3 * np.ones((M, N, udim)),
        x_l=-np.ones((M, N, xdim)), x_u=np.ones((M, N, xdim)),
    )
    s = build_scp_solver(unicycle_step, N=N, xdim=xdim, udim=udim, M=M, Nc=2,
                         max_it=8, res_tol=1e-6, has_u_bounds=False,
                         has_x_bounds=True, jit=False)
    X, U, info = jax.jit(s)(d)
    U = np.asarray(U)
    assert np.isfinite(U).all()
    assert np.abs(U).max() > 1e-2, "u bounds must be ignored when has_u=False"
    # the x bounds ARE active
    assert np.asarray(X)[:, 1:].max() <= 1.0 + 1e-4


def test_accel_aa_same_fixed_point_fewer_iterations():
    """Device-loop Anderson acceleration (accel="AA"): reaches the SAME SCP
    fixed point as the plain iteration (the returned iterate is always a raw
    subproblem solution, so bound feasibility is preserved), in fewer
    iterations on this fixture (device twin of the host loop's
    filter_method="AA", role of pmpc/scp_mpc.py:37-62)."""
    M, N, xdim, udim, Nc = 4, 15, 4, 2, 3
    rng = np.random.default_rng(7)
    x0 = np.ones((M, xdim)) + 0.1 * rng.normal(size=(M, xdim))
    data = make_scp_data(
        x0, np.tile(np.eye(xdim), (M, N, 1, 1)),
        np.tile(1e-2 * np.eye(udim), (M, N, 1, 1)),
        reg_x=1.0, reg_u=0.1,
        u_l=-0.8 * np.ones((M, N, udim)), u_u=0.8 * np.ones((M, N, udim)),
        dtype=jnp.float64)
    kw = dict(N=N, xdim=xdim, udim=udim, M=M, Nc=Nc, max_it=60,
              res_tol=1e-6, has_u_bounds=True, ipm_iters=30, ipm_tol_exp=-9)
    plain = build_scp_solver(unicycle_step, **kw)
    accel = build_scp_solver(unicycle_step, accel="AA", **kw)
    Xp, Up, ip = plain(data)
    Xa, Ua, ia = accel(data)
    assert bool(ip["converged"]) and bool(ia["converged"])
    np.testing.assert_allclose(np.asarray(Ua), np.asarray(Up), atol=2e-5)
    # bound feasibility of the returned (raw, not extrapolated) solution
    assert np.asarray(Ua).max() <= 0.8 + 1e-7
    assert np.asarray(Ua).min() >= -0.8 - 1e-7
    assert int(ia["iters"]) < int(ip["iters"]), (
        f"AA {int(ia['iters'])} vs plain {int(ip['iters'])}")


def test_accel_aa_scan_path_matches_while_path():
    """collect_stats=True (scan) and False (while_loop) agree under AA."""
    M, N, xdim, udim = 2, 10, 4, 2
    data = _dubins_data(M, N, bounds=True)
    kw = dict(N=N, xdim=xdim, udim=udim, M=M, Nc=2, max_it=20,
              res_tol=1e-8, has_u_bounds=True, accel="AA")
    s_scan = build_scp_solver(unicycle_step, collect_stats=True, **kw)
    s_while = build_scp_solver(unicycle_step, collect_stats=False, **kw)
    X1, U1, i1 = s_scan(data)
    X2, U2, i2 = s_while(data)
    np.testing.assert_allclose(np.asarray(U1), np.asarray(U2), atol=1e-6)


def test_return_state_warm_starts_across_calls():
    """Receding-horizon contract: build_scp_solver(return_state=True) returns
    the final IPM primal/dual/slack point and accepts it on the next call —
    the warm-started step must converge in fewer SCP iterations than the
    cold-started one (role of the reference's solver_state threading,
    pmpc/scp_mpc.py:366-373)."""
    import numpy as np
    import jax.numpy as jnp
    from pmpc_tpu.jax_scp import build_scp_solver, make_scp_data
    from fixtures import unicycle_step

    M, N, xdim, udim, Nc = 4, 12, 4, 2, 3
    solver = build_scp_solver(unicycle_step, N=N, xdim=xdim, udim=udim, M=M,
                              Nc=Nc, max_it=40, res_tol=1e-5,
                              has_u_bounds=True, return_state=True)
    rng = np.random.default_rng(5)
    x0 = np.ones((M, xdim)) + 0.05 * rng.normal(size=(M, xdim))
    mk = lambda x0_, Xp, Up: make_scp_data(
        x0_, np.tile(np.eye(xdim), (M, N, 1, 1)),
        np.tile(1e-2 * np.eye(udim), (M, N, 1, 1)),
        X_prev=Xp, U_prev=Up,
        u_l=-0.7 * np.ones((M, N, udim)), u_u=0.7 * np.ones((M, N, udim)),
        dtype=jnp.float64)
    d0 = mk(x0, None, None)
    X, U, info0 = solver(d0, None)
    assert bool(info0["converged"])
    state = info0["solver_state"]
    assert state is not None and all(np.isfinite(np.asarray(s)).all()
                                     for s in state)
    # next control step: slightly advanced x0, shifted plan
    x1 = x0 + 0.02
    Xs = np.asarray(X[:, 2:])
    Xp = np.concatenate([Xs, Xs[:, -1:]], axis=1)
    Us = np.asarray(U[:, 1:])
    Up = np.concatenate([Us, Us[:, -1:]], axis=1)
    d1 = mk(x1, Xp, Up)
    _, U_cold, i_cold = solver(d1, None)
    _, U_warm, i_warm = solver(d1, state)
    assert bool(i_cold["converged"]) and bool(i_warm["converged"])
    # same answer, fewer (or equal) SCP iterations, and strictly fewer on
    # this fixture
    np.testing.assert_allclose(np.asarray(U_warm), np.asarray(U_cold),
                               atol=1e-5)
    assert int(i_warm["iters"]) <= int(i_cold["iters"])


def test_relin_stale_same_fixed_point():
    """Stale-Jacobian sub-iterations (relin_stale) keep the affine map and
    Hessians frozen and only move the prox/ref terms: at the fixed point a
    stale subproblem equals the fresh one, so both solvers must land on the
    same solution (they do on this mildly nonlinear problem; the mode stays
    off by default)."""
    import jax

    def dyn(x, u):
        return x + 0.1 * jnp.concatenate([jnp.sin(x[2:4]), u])

    N, xdim, udim, M = 12, 4, 2, 3
    data = make_scp_data(
        np.ones((M, xdim), np.float32),
        np.tile(np.eye(xdim, dtype=np.float32), (M, N, 1, 1)),
        np.tile(1e-2 * np.eye(udim, dtype=np.float32), (M, N, 1, 1)),
        u_l=-np.ones((M, N, udim), np.float32),
        u_u=np.ones((M, N, udim), np.float32))
    kw = dict(N=N, xdim=xdim, udim=udim, M=M, Nc=3, max_it=40, res_tol=1e-6,
              has_u_bounds=True, accel="AA", jit=False)
    s0 = build_scp_solver(dyn, **kw)
    s1 = build_scp_solver(dyn, relin_stale=1, **kw)
    X0, U0, i0 = jax.jit(s0)(data)
    X1, U1, i1 = jax.jit(s1)(data)
    assert bool(np.asarray(i0["converged"])) and bool(np.asarray(i1["converged"]))
    np.testing.assert_allclose(np.asarray(U0), np.asarray(U1), atol=2e-5)
