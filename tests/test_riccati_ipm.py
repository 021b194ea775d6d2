"""Stage-structured (Riccati) box IPM vs the condensed IPM and the oracle.

The O(N) path must produce the SAME iterates as the condensed path: both run
identical Mehrotra steps, only the Newton-system solver differs (theta-
parameterized Riccati sweeps vs arrow factorization of the condensed K)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import oracle
from fixtures import unicycle_step

from pmpc_tpu.jax_scp import build_scp_solver, make_scp_data
from pmpc_tpu.solvers.ipm import ipm_solve_np
from pmpc_tpu.solvers.riccati_ipm import riccati_ipm_solve_scp


@pytest.mark.parametrize("M,N,Nc", [(3, 10, 3), (2, 8, 0), (4, 12, 4)])
def test_riccati_ipm_matches_condensed(M, N, Nc):
    rng = np.random.default_rng(3 + M + N)
    xdim, udim = 4, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    u_l = np.full((M, N, udim), -0.5)
    u_u = np.full((M, N, udim), 0.5)
    base_args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
                 p["Q"], p["R"], p["X_ref"], p["U_ref"])
    reg_args = (np.full(M, 1.0), np.full(M, 0.1), np.zeros(M), np.zeros(M),
                np.zeros((M, udim)))
    Xc, Uc, dc = ipm_solve_np(base_args, reg_args, u_l, u_u, None, None, Nc=Nc,
                              settings=dict(ipm_iters=40, ipm_tol_exp=-10))
    assert dc["ipm_converged"]
    Xr, Ur, st = riccati_ipm_solve_scp(
        *[jnp.asarray(a) for a in base_args],
        jnp.full((M,), 1.0), jnp.full((M,), 0.1),
        jnp.asarray(u_l), jnp.asarray(u_u), Nc=Nc, iters=40, tol_exp=-10)
    assert bool(st["converged"]) and not bool(st["failed"])
    np.testing.assert_allclose(np.asarray(Ur), Uc, atol=1e-8)
    np.testing.assert_allclose(np.asarray(Xr), Xc, atol=1e-8)
    # bounds must be active somewhere for the test to mean anything
    assert (np.abs(np.abs(np.asarray(Ur)) - 0.5) < 1e-6).any()


def test_fused_riccati_scp_matches_condensed():
    """Full fused SCP loop: method='riccati' must track method='condensed'
    step for step (same warm-started IPM iteration counts, same solution)."""
    N, xdim, udim, M, Nc = 14, 4, 2, 3, 3
    rng = np.random.default_rng(0)
    d = make_scp_data(
        np.ones((M, xdim)) + 0.05 * rng.normal(size=(M, xdim)),
        np.tile(np.eye(xdim), (M, N, 1, 1)),
        np.tile(1e-2 * np.eye(udim), (M, N, 1, 1)),
        reg_x=1.0, reg_u=0.1,
        u_l=-0.6 * np.ones((M, N, udim)), u_u=0.6 * np.ones((M, N, udim)))
    kw = dict(N=N, xdim=xdim, udim=udim, M=M, Nc=Nc, max_it=8, res_tol=1e-7,
              has_u_bounds=True, ipm_iters=40, ipm_tol_exp=-10,
              collect_stats=True, adaptive_tol=False)
    Xc, Uc, ic = build_scp_solver(unicycle_step, **kw)(d)
    Xr, Ur, ir = build_scp_solver(unicycle_step, method="riccati", **kw)(d)
    np.testing.assert_allclose(np.asarray(Ur), np.asarray(Uc), atol=1e-8)
    np.testing.assert_array_equal(np.asarray(ir["scan_stats"]["ipm_iters"]),
                                  np.asarray(ic["scan_stats"]["ipm_iters"]))
    # warm start across SCP iterations cuts the IPM iteration count
    its = np.asarray(ir["scan_stats"]["ipm_iters"])
    assert its[-1] < its[0]
    U = np.asarray(Ur)
    assert np.abs(U).max() <= 0.6 + 1e-8
    assert np.ptp(U[:, :Nc], axis=0).max() < 1e-10  # exact consensus


def test_riccati_gates_unsupported():
    with pytest.raises(NotImplementedError):
        build_scp_solver(unicycle_step, N=8, xdim=4, udim=2, M=2, Nc=2,
                         method="priccati", has_u_soc=True)
    with pytest.raises(NotImplementedError):
        build_scp_solver(unicycle_step, N=8, xdim=4, udim=2, M=2, Nc=2,
                         method="priccati", has_x_bounds=True)


@pytest.mark.parametrize("M,N,Nc", [(3, 10, 3), (2, 9, 0)])
def test_riccati_ipm_state_boxes_match_condensed(M, N, Nc):
    """State-box rows on the O(N) path: barrier weights on Qt_j + rollout
    slacks + adjoint multiplier pulls must reproduce the condensed IPM's
    solution (same Mehrotra algebra, different Newton solver). Role of the
    reference's sparse state rows, PMPC.jl/src/lqp_utils.jl:306-393."""
    rng = np.random.default_rng(31 + M + N)
    xdim, udim = 4, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    u_l = np.full((M, N, udim), -0.6)
    u_u = np.full((M, N, udim), 0.6)
    base_args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
                 p["Q"], p["R"], p["X_ref"], p["U_ref"])
    reg_args = (np.full(M, 1.0), np.full(M, 0.1), np.zeros(M), np.zeros(M),
                np.zeros((M, udim)))
    # state box derived from the u-box-only solve so it binds but stays
    # feasible (a fixed box can be infeasible against random dynamics)
    X0, U0, d0 = ipm_solve_np(base_args, reg_args, u_l, u_u, None, None,
                              Nc=Nc, settings=dict(ipm_iters=60,
                                                   ipm_tol_exp=-10))
    assert d0["ipm_converged"]
    hi = 0.93 * np.abs(X0).max()
    x_l = np.full((M, N, xdim), -hi)
    x_u = np.full((M, N, xdim), hi)
    Xc, Uc, dc = ipm_solve_np(base_args, reg_args, u_l, u_u, x_l, x_u, Nc=Nc,
                              settings=dict(ipm_iters=60, ipm_tol_exp=-10))
    assert dc["ipm_converged"]
    Xr, Ur, st = riccati_ipm_solve_scp(
        *[jnp.asarray(a) for a in base_args],
        jnp.full((M,), 1.0), jnp.full((M,), 0.1),
        jnp.asarray(u_l), jnp.asarray(u_u), Nc=Nc, iters=60, tol_exp=-10,
        x_l=jnp.asarray(x_l), x_u=jnp.asarray(x_u))
    assert bool(st["converged"]) and not bool(st["failed"])
    np.testing.assert_allclose(np.asarray(Ur), Uc, atol=1e-6)
    np.testing.assert_allclose(np.asarray(Xr), Xc, atol=1e-6)
    # the state box must actually bind for this test to mean anything
    assert (np.abs(np.abs(np.asarray(Xr)) - hi) < 1e-4).any()
    assert np.abs(np.asarray(Xr)).max() <= hi + 1e-5


def test_riccati_ipm_one_sided_state_box():
    """One-sided state boxes (x_u only) through the host dispatcher with
    method='riccati' match the condensed route."""
    from pmpc_tpu.solvers.dispatch import affine_solve_np

    rng = np.random.default_rng(41)
    M, N, xdim, udim, Nc = 2, 8, 3, 2, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    common = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=np.full((M, N, udim), -0.6), u_u=np.full((M, N, udim), 0.6),
        x_l=None, x_u=None, Nc=Nc)
    args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"])
    ipm_settings = dict(ipm_tol_exp=-10, ipm_iters=60)
    # binding-but-feasible one-sided cap from the u-box-only solve
    X0, U0, d0 = affine_solve_np(*args, **common, settings=ipm_settings)
    x_u = np.full((M, N, xdim), 0.95 * X0.max())
    common["x_u"] = x_u
    Xc, Uc, dc = affine_solve_np(*args, **common, settings=ipm_settings)
    assert dc["ipm_converged"]
    Xr, Ur, dr = affine_solve_np(
        *args, **common, settings=dict(method="riccati", **ipm_settings))
    assert dr["ipm_converged"]
    np.testing.assert_allclose(Ur, Uc, atol=1e-6)
    assert Xr.max() <= x_u.flat[0] + 1e-6


def test_riccati_ipm_state_boxes_with_slew():
    """State boxes + slew coupling together on the O(N) path: the slew
    augmentation widens the stage state, the box must keep applying only to
    the original entries. Condensed f64 is the oracle."""
    from pmpc_tpu.solvers.dispatch import affine_solve_np

    rng = np.random.default_rng(47)
    M, N, xdim, udim, Nc = 2, 9, 3, 2, 3
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    common = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.full(M, 0.3), slew_reg0=np.full(M, 0.5),
        slew_um1=rng.normal(size=(M, udim)) * 0.1,
        u_l=np.full((M, N, udim), -0.7), u_u=np.full((M, N, udim), 0.7),
        x_l=None, x_u=None, Nc=Nc)
    args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"])
    ipm_settings = dict(ipm_iters=60, ipm_tol_exp=-10)
    X0, U0, d0 = affine_solve_np(*args, **common, settings=ipm_settings)
    hi = 0.95 * np.abs(X0).max()
    common["x_l"] = np.full((M, N, xdim), -hi)
    common["x_u"] = np.full((M, N, xdim), hi)
    Xc, Uc, dc = affine_solve_np(*args, **common, settings=ipm_settings)
    assert dc["ipm_converged"]
    Xr, Ur, dr = affine_solve_np(
        *args, **common, settings=dict(method="riccati", **ipm_settings))
    assert dr["ipm_converged"]
    np.testing.assert_allclose(Ur, Uc, atol=1e-6)
    np.testing.assert_allclose(Xr, Xc, atol=1e-6)


def test_fused_riccati_state_boxes_matches_condensed():
    """Fused device loop with method='riccati' + has_x_bounds (no u bounds:
    the finite u arrays in SCPData must be ignored per the static contract)."""
    N, xdim, udim, M, Nc = 12, 4, 2, 3, 3
    rng = np.random.default_rng(51)
    d = make_scp_data(
        np.ones((M, xdim)) + 0.05 * rng.normal(size=(M, xdim)),
        np.tile(np.eye(xdim), (M, N, 1, 1)),
        np.tile(1e-2 * np.eye(udim), (M, N, 1, 1)),
        reg_x=1.0, reg_u=0.1,
        x_l=-1.05 * np.ones((M, N, xdim)), x_u=1.05 * np.ones((M, N, xdim)))
    kw = dict(N=N, xdim=xdim, udim=udim, M=M, Nc=Nc, max_it=10, res_tol=1e-7,
              has_x_bounds=True, ipm_iters=50, ipm_tol_exp=-10,
              collect_stats=True, adaptive_tol=False)
    Xc, Uc, ic = build_scp_solver(unicycle_step, **kw)(d)
    Xr, Ur, ir = build_scp_solver(unicycle_step, method="riccati", **kw)(d)
    np.testing.assert_allclose(np.asarray(Ur), np.asarray(Uc), atol=1e-7)
    X = np.asarray(Xr)
    assert X[:, 1:].max() <= 1.05 + 1e-6
    assert (np.abs(X[:, 1:].max() - 1.05) < 1e-4) or (
        np.abs(np.abs(X[:, 1:]) - 1.05) < 1e-4).any()


def test_host_dispatch_riccati_bounds():
    """Host path: settings={'method': 'riccati'} + u bounds routes to the
    stage-structured IPM, threads riccati_warm solver state, and matches the
    default condensed route."""
    from pmpc_tpu.solvers.dispatch import affine_solve_np

    rng = np.random.default_rng(11)
    M, N, xdim, udim, Nc = 3, 10, 4, 2, 3
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    u_l = np.full((M, N, udim), -0.5)
    u_u = np.full((M, N, udim), 0.5)
    common = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=u_l, u_u=u_u, x_l=None, x_u=None, Nc=Nc)
    args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"])
    Xc, Uc, dc = affine_solve_np(*args, **common, settings={})
    st = dict(method="riccati", ipm_tol_exp=-10, ipm_iters=40)
    Xr, Ur, dr = affine_solve_np(*args, **common, settings=st)
    assert dr["ipm_converged"] and not dr["ipm_failed"]
    np.testing.assert_allclose(Ur, Uc, atol=1e-6)
    # warm state round-trips and cuts iterations on a re-solve
    st2 = dict(st, solver_state=dr["solver_state"])
    Xw, Uw, dw = affine_solve_np(*args, **common, settings=st2)
    assert dw["ipm_iters"] < dr["ipm_iters"]
    np.testing.assert_allclose(Uw, Ur, atol=1e-5)


def test_host_dispatch_riccati_one_sided():
    from pmpc_tpu.solvers.dispatch import affine_solve_np

    rng = np.random.default_rng(12)
    M, N, xdim, udim, Nc = 2, 8, 3, 2, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    u_u = np.full((M, N, udim), 0.4)
    common = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=None, u_u=u_u, x_l=None, x_u=None, Nc=Nc)
    args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"])
    Xc, Uc, dc = affine_solve_np(*args, **common, settings={})
    Xr, Ur, dr = affine_solve_np(
        *args, **common, settings=dict(method="riccati", ipm_tol_exp=-10))
    np.testing.assert_allclose(Ur, Uc, atol=1e-6)
    assert Ur.max() <= 0.4 + 1e-8


def test_host_dispatch_riccati_full_consensus():
    """Nc=-1 (full consensus) leaves the free block zero-sized; the riccati
    IPM used to crash on a zero-size jnp.max there. Must match condensed."""
    from pmpc_tpu.solvers.dispatch import affine_solve_np

    rng = np.random.default_rng(13)
    M, N, xdim, udim = 2, 8, 3, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    u_l = np.full((M, N, udim), -0.5)
    u_u = np.full((M, N, udim), 0.5)
    common = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=u_l, u_u=u_u, x_l=None, x_u=None, Nc=N)
    args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"])
    Xc, Uc, dc = affine_solve_np(*args, **common, settings={})
    Xr, Ur, dr = affine_solve_np(
        *args, **common, settings=dict(method="riccati", ipm_tol_exp=-10))
    np.testing.assert_allclose(Ur, Uc, atol=1e-6)


def test_solve_method_kwarg_top_level():
    """solve(method="riccati") as a top-level kwarg (it is in SOLVE_KWS) must
    select the riccati path, not be silently dropped into extra_kw."""
    import pmpc_tpu
    from fixtures import dubins_f_fx_fu_fn

    N, xdim, udim = 8, 4, 2
    f_fn = dubins_f_fx_fu_fn()
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    kw = dict(max_it=5, verbose=False, res_tol=1e-7,
              u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)))
    Xc, Uc, _ = pmpc_tpu.solve(f_fn, Q, R, np.ones(xdim), **kw)
    Xr, Ur, _ = pmpc_tpu.solve(f_fn, Q, R, np.ones(xdim), method="riccati", **kw)
    np.testing.assert_allclose(Ur, Uc, atol=1e-4)


def test_auto_riccati_long_horizon(monkeypatch):
    """With no method requested, eligible problems at N >= riccati_auto_N
    route to the stage-structured path (condensation overflows f32 there);
    ineligible ones (slew) stay condensed."""
    import pmpc_tpu.solvers.riccati_ipm as ri
    from pmpc_tpu.solvers.dispatch import affine_solve_np

    calls = []
    orig = ri.riccati_ipm_solve_np
    monkeypatch.setattr(ri, "riccati_ipm_solve_np",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))

    rng = np.random.default_rng(14)
    M, N, xdim, udim = 2, 8, 3, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    common = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=np.full((M, N, udim), -0.5), u_u=np.full((M, N, udim), 0.5),
        x_l=None, x_u=None, Nc=2)
    args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"])
    # below the threshold: condensed
    affine_solve_np(*args, **common, settings=dict(riccati_auto_N=100))
    assert not calls
    # above it: riccati
    affine_solve_np(*args, **common, settings=dict(riccati_auto_N=4))
    assert len(calls) == 1
    # slew problems route too (state-augmented sweep) and match condensed
    Xs, Us, _ = affine_solve_np(
        *args, **dict(common, slew_reg=np.full(M, 0.1)),
        settings=dict(riccati_auto_N=4, ipm_tol_exp=-10, ipm_iters=40))
    assert len(calls) == 2
    Xc, Uc, _ = affine_solve_np(
        *args, **dict(common, slew_reg=np.full(M, 0.1)),
        settings=dict(ipm_tol_exp=-10, ipm_iters=40))
    assert len(calls) == 2  # condensed baseline did not take the riccati route
    np.testing.assert_allclose(Us, Uc, atol=1e-6)
    # state boxes are now eligible for the auto route too
    affine_solve_np(*args, **dict(common, x_l=np.full((M, N, xdim), -50.0),
                                  x_u=np.full((M, N, xdim), 50.0)),
                    settings=dict(riccati_auto_N=4))
    assert len(calls) == 3
    # above it but ineligible (smoothing): condensed, no raise
    affine_solve_np(*args, **common,
                    settings=dict(riccati_auto_N=4, smooth_cstr="squareplus",
                                  smooth_alpha=50.0))
    assert len(calls) == 3


def test_long_horizon_default_settings_solves():
    """solve() with DEFAULT settings (Nc=-1) at N past the condensation
    overflow: M=1 normalizes consensus to Nc=0 and the auto riccati route
    returns a finite bounded solution (this exact call used to return the
    (None, None, None) failure triple — full consensus made the theta block
    span the whole horizon)."""
    import pmpc_tpu
    from fixtures import dubins_f_fx_fu_fn

    N, xdim, udim = 240, 4, 2
    f_fn = dubins_f_fx_fu_fn()
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    X, U, d = pmpc_tpu.solve(
        f_fn, Q, R, np.ones(xdim), max_it=2, res_tol=1e-6, verbose=False,
        u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)))
    assert X is not None and np.isfinite(U).all()
    assert np.abs(U).max() <= 1.0 + 1e-6


@pytest.mark.parametrize("M,N,Nc", [(3, 10, 3), (2, 9, 0)])
def test_riccati_ipm_u_soc_matches_condensed(M, N, Nc):
    """Per-stage control-norm cones ||u_j|| <= r on the O(N) path: the dense
    NT blocks land on Rt_j (free stages) / the theta Schur complement
    (consensus stages) and must reproduce the condensed arrow IPM's solution
    (same Mehrotra algebra, different Newton solver)."""
    from pmpc_tpu.solvers.dispatch import affine_solve_np

    rng = np.random.default_rng(61 + M + N)
    xdim, udim = 4, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    common = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=None, u_u=None, x_l=None, x_u=None, Nc=Nc)
    args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"])
    # the condensed structured-SOC path plateaus at mu ~6e-6 on these
    # random instances (pre-existing; boundary-collision freezes) — -5
    # converges crisply on both sides and is plenty for equivalence
    ipm_settings = dict(ipm_tol_exp=-5, ipm_iters=150)
    # binding-but-feasible radius from the unconstrained solve (tight radii
    # send the condensed SOC path into a ~100-iteration crawl on some
    # instances; 0.92 binds without the crawl)
    X0, U0, d0 = affine_solve_np(*args, **common, settings=ipm_settings)
    u_top = float(np.linalg.norm(U0, axis=-1).max())
    for frac in (0.92, 0.85, 0.95):  # condensed baseline is radius-sensitive
        r = frac * u_top
        soc = dict(u_soc_r=np.full((M, N), r))
        Xc, Uc, dc = affine_solve_np(*args, **common,
                                     settings=dict(ipm_settings, **soc))
        if dc["ipm_converged"]:
            break
    assert dc["ipm_converged"]
    Xr, Ur, dr = affine_solve_np(
        *args, **common,
        settings=dict(ipm_settings, method="riccati", **soc))
    assert dr["ipm_converged"] and not dr["ipm_failed"]
    np.testing.assert_allclose(Ur, Uc, atol=1e-4)
    np.testing.assert_allclose(Xr, Xc, atol=1e-4)
    norms = np.linalg.norm(Ur, axis=-1)
    assert norms.max() <= r + 1e-4
    assert (np.abs(norms - r) < 1e-2).any(), "cone must bind"


def test_riccati_ipm_u_soc_with_u_box_and_state_box():
    """All three constraint families together on the stage-structured path
    (u-box + state box + per-stage cones) vs the condensed oracle."""
    from pmpc_tpu.solvers.dispatch import affine_solve_np

    rng = np.random.default_rng(71)
    M, N, xdim, udim, Nc = 2, 8, 3, 2, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    common = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=None, u_u=None, x_l=None, x_u=None, Nc=Nc)
    args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"])
    ipm_settings = dict(ipm_tol_exp=-5, ipm_iters=80)
    X0, U0, d0 = affine_solve_np(*args, **common, settings=ipm_settings)
    r = 0.9 * float(np.linalg.norm(U0, axis=-1).max())
    hi = 0.95 * float(np.abs(X0).max())
    common.update(
        u_l=np.full((M, N, udim), -0.95 * r), u_u=np.full((M, N, udim),
                                                          0.95 * r),
        x_l=np.full((M, N, xdim), -hi), x_u=np.full((M, N, xdim), hi))
    soc = dict(u_soc_r=np.full((M, N), r))
    Xc, Uc, dc = affine_solve_np(*args, **common,
                                 settings=dict(ipm_settings, **soc))
    assert dc["ipm_converged"]
    Xr, Ur, dr = affine_solve_np(
        *args, **common,
        settings=dict(ipm_settings, method="riccati", **soc))
    assert dr["ipm_converged"] and not dr["ipm_failed"]
    np.testing.assert_allclose(Ur, Uc, atol=1e-4)
    np.testing.assert_allclose(Xr, Xc, atol=1e-4)


def test_fused_riccati_u_soc_matches_condensed():
    """Fused device loop: method='riccati' + has_u_soc tracks the condensed
    method on the same data (warm-started cone duals threaded through the
    SCP carry)."""
    N, xdim, udim, M, Nc = 10, 4, 2, 3, 3
    rng = np.random.default_rng(81)
    d = make_scp_data(
        np.ones((M, xdim)) + 0.05 * rng.normal(size=(M, xdim)),
        np.tile(np.eye(xdim), (M, N, 1, 1)),
        np.tile(1e-2 * np.eye(udim), (M, N, 1, 1)),
        reg_x=1.0, reg_u=0.1,
        u_soc_r=0.5 * np.ones((M, N)))
    kw = dict(N=N, xdim=xdim, udim=udim, M=M, Nc=Nc, max_it=8, res_tol=1e-7,
              has_u_soc=True, ipm_iters=50, ipm_tol_exp=-6,
              collect_stats=True, adaptive_tol=False)
    Xc, Uc, ic = build_scp_solver(unicycle_step, **kw)(d)
    Xr, Ur, ir = build_scp_solver(unicycle_step, method="riccati", **kw)(d)
    np.testing.assert_allclose(np.asarray(Ur), np.asarray(Uc), atol=1e-7)
    norms = np.linalg.norm(np.asarray(Ur), axis=-1)
    assert norms.max() <= 0.5 + 1e-7


def test_long_horizon_state_box_default_settings():
    """N past the condensation overflow with STATE boxes + slew at default
    settings: the auto riccati route (now carrying state rows) must return a
    feasible converging solution — this exact problem class had no f32 route
    in round 3 (dispatch gated state boxes off riccati; condensed overflows
    at N~240)."""
    import pmpc_tpu
    from fixtures import dubins_f_fx_fu_fn

    N, xdim, udim = 250, 4, 2
    f_fn = dubins_f_fx_fu_fn()
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    X, U, d = pmpc_tpu.solve(
        f_fn, Q, R, np.ones(xdim), max_it=10, res_tol=1e-3, verbose=False,
        u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
        x_l=-np.full((N, xdim), 6.0), x_u=np.full((N, xdim), 6.0),
        slew_reg=0.1)
    assert X is not None and np.isfinite(U).all()
    assert np.abs(U).max() <= 1.0 + 1e-5
    assert np.abs(X).max() <= 6.0 + 1e-3
    assert d["hist"][-1]["resid"] < d["hist"][0]["resid"]


def test_riccati_logbarrier_mu_target_matches_condensed():
    """Logbarrier smoothing on the O(N) path: the smoothed problem's
    solution is the central-path point at mu = 1/alpha, so the riccati IPM
    with mu_target must match the condensed IPM's mu_target route
    (dispatch smooth_cstr='logbarrier' contract, cone_utils.jl:173-202)."""
    from pmpc_tpu.solvers.dispatch import affine_solve_np

    rng = np.random.default_rng(91)
    M, N, xdim, udim, Nc = 2, 9, 3, 2, 3
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    common = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=np.full((M, N, udim), -0.6), u_u=np.full((M, N, udim), 0.6),
        x_l=None, x_u=None, Nc=Nc)
    args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"])
    st = dict(smooth_cstr="logbarrier", smooth_alpha=100.0,
              ipm_iters=80, ipm_tol_exp=-10)
    Xc, Uc, dc = affine_solve_np(*args, **common, settings=st)
    Xr, Ur, dr = affine_solve_np(*args, **common,
                                 settings=dict(st, method="riccati"))
    assert dr["ipm_converged"]
    np.testing.assert_allclose(Ur, Uc, atol=1e-5)
    np.testing.assert_allclose(Xr, Xc, atol=1e-5)
    # the smoothed solution must sit strictly INSIDE the box (mu=1/alpha
    # keeps a barrier margin) but near it
    assert 0.55 < np.abs(Ur).max() < 0.6


def test_long_horizon_logbarrier_default_settings():
    """Logbarrier-smoothed box MPC past the condensation overflow:
    the auto riccati route carries the central-path stop."""
    import pmpc_tpu
    from fixtures import dubins_f_fx_fu_fn

    N, xdim, udim = 250, 4, 2
    f_fn = dubins_f_fx_fu_fn()
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    X, U, d = pmpc_tpu.solve(
        f_fn, Q, R, np.ones(xdim), max_it=8, res_tol=1e-3, verbose=False,
        u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
        solver_settings=dict(smooth_cstr="logbarrier", smooth_alpha=200.0))
    assert X is not None and np.isfinite(U).all()
    assert np.abs(U).max() < 1.0  # strictly interior (barrier margin)
    assert d["hist"][-1]["resid"] < d["hist"][0]["resid"]


def test_long_horizon_u_soc_default_settings():
    """Per-stage control-norm cones past the condensation overflow: the
    auto riccati route (now carrying SOC cones) returns a feasible,
    progressing solution — this class had no f32 long-horizon route before
    (the dispatcher gated u_soc_r off riccati)."""
    import pmpc_tpu
    from fixtures import dubins_f_fx_fu_fn

    N, xdim, udim = 250, 4, 2
    f_fn = dubins_f_fx_fu_fn()
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    X, U, d = pmpc_tpu.solve(
        f_fn, Q, R, np.ones(xdim), max_it=10, res_tol=1e-3, verbose=False,
        solver_settings=dict(u_soc_r=np.full((1, N), 0.8)))
    assert X is not None and np.isfinite(U).all()
    assert np.linalg.norm(U, axis=-1).max() <= 0.8 + 1e-4
    assert d["hist"][-1]["resid"] < d["hist"][0]["resid"]


def test_riccati_slew_eq_matches_condensed():
    """Slew coupling via state augmentation (riccati.augment_slew_stages):
    the O(N) equality-only consensus solve must match the condensed path
    exactly, including the slew_reg0 anchor term."""
    from pmpc_tpu.solvers.dispatch import affine_solve_np

    rng = np.random.default_rng(21)
    M, N, xdim, udim, Nc = 3, 9, 3, 2, 3
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    common = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.full(M, 0.4), slew_reg0=np.full(M, 0.7),
        slew_um1=rng.normal(size=(M, udim)),
        u_l=None, u_u=None, x_l=None, x_u=None, Nc=Nc)
    args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"])
    Xc, Uc, _ = affine_solve_np(*args, **common, settings={})
    Xr, Ur, _ = affine_solve_np(*args, **common,
                                settings=dict(method="riccati"))
    np.testing.assert_allclose(Ur, Uc, atol=1e-7)
    np.testing.assert_allclose(Xr, Xc, atol=1e-7)


def test_riccati_ipm_slew_matches_condensed():
    """Bounded + slew through the stage-structured IPM == condensed IPM."""
    from pmpc_tpu.solvers.dispatch import affine_solve_np

    rng = np.random.default_rng(22)
    M, N, xdim, udim, Nc = 2, 10, 3, 2, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    common = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.full(M, 0.5), slew_reg0=np.full(M, 0.2),
        slew_um1=rng.normal(size=(M, udim)),
        u_l=np.full((M, N, udim), -0.5), u_u=np.full((M, N, udim), 0.5),
        x_l=None, x_u=None, Nc=Nc)
    args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"])
    Xc, Uc, dc = affine_solve_np(
        *args, **common, settings=dict(ipm_tol_exp=-10, ipm_iters=40))
    assert dc["ipm_converged"]
    Xr, Ur, dr = affine_solve_np(
        *args, **common,
        settings=dict(method="riccati", ipm_tol_exp=-10, ipm_iters=40))
    assert dr["ipm_converged"] and not dr["ipm_failed"]
    np.testing.assert_allclose(Ur, Uc, atol=1e-6)
    assert (np.abs(np.abs(Ur) - 0.5) < 1e-6).any()  # bounds active somewhere


def test_riccati_weights_matches_condensed():
    """Particle weights on the riccati route (pre-scaled per-particle costs)
    == the condensed route's weighted assembly."""
    from pmpc_tpu.solvers.dispatch import affine_solve_np

    rng = np.random.default_rng(23)
    M, N, xdim, udim, Nc = 3, 8, 3, 2, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    w = np.array([0.2, 1.0, 3.0])
    common = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.full(M, 0.3), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=np.full((M, N, udim), -0.6), u_u=np.full((M, N, udim), 0.6),
        x_l=None, x_u=None, Nc=Nc)
    args = (p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
            p["Q"], p["R"], p["X_ref"], p["U_ref"])
    Xc, Uc, _ = affine_solve_np(
        *args, **common,
        settings=dict(weights=w, ipm_tol_exp=-10, ipm_iters=40))
    Xr, Ur, dr = affine_solve_np(
        *args, **common,
        settings=dict(weights=w, method="riccati", ipm_tol_exp=-10,
                      ipm_iters=40))
    assert dr["ipm_converged"]
    np.testing.assert_allclose(Ur, Uc, atol=1e-6)


def test_fused_riccati_slew_matches_condensed():
    """build_scp_solver(method='riccati', has_slew=True): the fully fused SCP
    loop with slew coupling matches the condensed fused loop (the NaN-poison
    fallback is gone for the flagged path)."""
    M, N, xdim, udim, Nc = 2, 10, 4, 2, 3
    rng = np.random.default_rng(24)
    x0 = np.ones((M, xdim)) + 0.05 * rng.normal(size=(M, xdim))
    kw = dict(x0=x0,
              Q=np.tile(np.eye(xdim), (M, N, 1, 1)),
              R=np.tile(1e-2 * np.eye(udim), (M, N, 1, 1)),
              slew_reg=0.3, slew_reg0=0.5,
              slew_um1=0.1 * np.ones((M, udim)),
              u_l=-0.8 * np.ones((M, N, udim)),
              u_u=0.8 * np.ones((M, N, udim)), dtype=jnp.float64)
    data = make_scp_data(**kw)
    bkw = dict(N=N, xdim=xdim, udim=udim, M=M, Nc=Nc, max_it=25,
               has_u_bounds=True, ipm_iters=40, ipm_tol_exp=-10)
    s_cond = build_scp_solver(unicycle_step, method="condensed", **bkw)
    s_ricc = build_scp_solver(unicycle_step, method="riccati",
                              has_slew=True, **bkw)
    Xc, Uc, ic = s_cond(data)
    Xr, Ur, ir = s_ricc(data)
    assert bool(ic["converged"]) and bool(ir["converged"]), (ic, ir)
    np.testing.assert_allclose(np.asarray(Ur), np.asarray(Uc), atol=1e-5)
    np.testing.assert_allclose(np.asarray(Xr), np.asarray(Xc), atol=1e-5)


def test_long_horizon_slew_default_settings_solves():
    """Receding-horizon style long-N problem WITH slew: the auto riccati
    route (augmented stage state) returns a finite bounded solution under
    default settings (the condensed route overflows in f32 at this N)."""
    import pmpc_tpu
    from fixtures import dubins_f_fx_fu_fn

    N, xdim, udim = 280, 4, 2
    f_fn = dubins_f_fx_fu_fn()
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    X, U, d = pmpc_tpu.solve(
        f_fn, Q, R, np.ones(xdim), max_it=3, res_tol=1e-6, verbose=False,
        slew_rate=0.5, u0_slew=np.zeros(udim),
        u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)))
    assert X is not None and np.isfinite(U).all()
    assert np.abs(U).max() <= 1.0 + 1e-6


def _active_lin_row(M, N, xdim, udim, Nc, rhs, state_coeffs=False, seed=0):
    """Full-layout linear extras: one active control row (sum of the first
    consensus stage's controls <= rhs) + one loose state-involving row."""
    rng = np.random.default_rng(seed)
    nc, nf = Nc * udim, (N - Nc) * udim
    n_full = nc + M * nf + M * N * xdim
    G = np.zeros((2, n_full))
    if Nc:
        G[0, :udim] = 1.0
    else:
        G[0, nc:nc + udim] = 1.0
    if state_coeffs:
        G[1, nc + M * nf:] = 0.02 * rng.standard_normal(M * N * xdim)
    h = np.array([rhs, 30.0])
    return G, h


@pytest.mark.parametrize("M,N,Nc,rhs", [(2, 9, 3, -2.0), (3, 10, 0, -4.0)])
def test_riccati_ipm_linear_extras_match_condensed(M, N, Nc, rhs):
    """LINEAR extras border the Riccati Newton system (reduced via one
    adjoint sweep per row) — must match the condensed bordered path on an
    ACTIVE row, including state-involving coefficients."""
    from pmpc_tpu.solvers.dispatch import affine_solve_np

    rng = np.random.default_rng(11 + M)
    xdim, udim = 3, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    G, h = _active_lin_row(M, N, xdim, udim, Nc, rhs=rhs,
                           state_coeffs=True, seed=M)
    n_full = G.shape[1]
    ec = (2, [], 0, G, np.zeros((2, 0)), h, np.zeros(n_full), np.zeros(0))
    kw = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)),
        u_l=None, u_u=None, x_l=None, x_u=None, Nc=Nc)
    Xr, Ur, dr = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"], **kw,
        settings=dict(extra_cstrs=[ec], method="riccati"))
    Xc, Uc, dc = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"], **kw,
        settings=dict(extra_cstrs=[ec]))
    assert dr["ipm_converged"] and dc["ipm_converged"]
    assert "riccati_warm" in dr["solver_state"], "must take the riccati route"
    np.testing.assert_allclose(Ur, Uc, atol=1e-7)
    np.testing.assert_allclose(Xr, Xc, atol=1e-7)
    # the control row is ACTIVE (otherwise this test proves nothing)
    assert abs(float(Ur[0, 0].sum()) - rhs) < 1e-6


def test_riccati_ipm_linear_extras_with_slew_and_state_boxes():
    """Extras borders compose with slew state-augmentation AND state boxes
    on the same O(N) factorization (the augmented stage state's control-
    memory tail is invisible to both the rows and the boxes)."""
    from pmpc_tpu.solvers.dispatch import affine_solve_np

    rng = np.random.default_rng(11)
    M, N, xdim, udim, Nc = 2, 9, 3, 2, 3
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    G, h = _active_lin_row(M, N, xdim, udim, Nc, rhs=-2.0,
                           state_coeffs=True, seed=7)
    n_full = G.shape[1]
    ec = (2, [], 0, G, np.zeros((2, 0)), h, np.zeros(n_full), np.zeros(0))
    kw = dict(
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.full(M, 0.5), slew_reg0=np.full(M, 0.5),
        slew_um1=0.1 * np.ones((M, udim)),
        u_l=None, u_u=None,
        x_l=-4.0 * np.ones((M, N, xdim)), x_u=4.0 * np.ones((M, N, xdim)),
        Nc=Nc)
    Xr, Ur, dr = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"], **kw,
        settings=dict(extra_cstrs=[ec], method="riccati"))
    Xc, Uc, dc = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"], **kw,
        settings=dict(extra_cstrs=[ec]))
    assert dr["ipm_converged"] and dc["ipm_converged"]
    np.testing.assert_allclose(Ur, Uc, atol=1e-7)
    assert abs(float(Ur[0, 0].sum()) - (-2.0)) < 1e-6


def test_long_horizon_linear_extras_default_settings():
    """N=280 with a linear extra row: the auto long-horizon route carries it
    in O(N) — the f32 route for extras past the condensation overflow."""
    import pmpc_tpu
    from fixtures import dubins_f_fx_fu_fn

    N, xdim, udim = 280, 4, 2
    n_full = N * udim + N * xdim
    G = np.zeros((1, n_full))
    G[0, :udim] = 1.0
    ec = (1, [], 0, G, np.zeros((1, 0)), np.array([-0.5]),
          np.zeros(n_full), np.zeros(0))
    f_fn = dubins_f_fx_fu_fn()
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    X, U, d = pmpc_tpu.solve(
        f_fn, Q, R, np.ones(xdim), max_it=3, res_tol=1e-6, verbose=False,
        u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
        extra_cstrs_fns=lambda X_, U_, pr: [ec])
    assert X is not None and np.isfinite(U).all()
    assert float(U[0, 0].sum()) <= -0.5 + 1e-5
