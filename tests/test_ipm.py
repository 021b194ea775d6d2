"""Primal-dual IPM vs scipy trust-constr oracle (box-constrained consensus QPs)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pmpc_tpu.solvers.dispatch import affine_solve_np

import oracle


def _solve_ours(p, reg_x, reg_u, Nc, u_bounds=None, x_bounds=None, settings=None):
    M, N, xdim = p["f"].shape
    udim = p["fu"].shape[-1]
    u_l = u_u = x_l = x_u = None
    if u_bounds is not None:
        u_l = np.full((M, N, udim), u_bounds[0])
        u_u = np.full((M, N, udim), u_bounds[1])
    if x_bounds is not None:
        x_l = np.full((M, N, xdim), x_bounds[0])
        x_u = np.full((M, N, xdim), x_bounds[1])
    X, U, data = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"],
        reg_x=np.full(M, reg_x), reg_u=np.full(M, reg_u),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M), slew_um1=np.zeros((M, 2)),
        u_l=u_l, u_u=u_u, x_l=x_l, x_u=x_u,
        Nc=Nc, settings=dict(settings or {}),
    )
    return X, U, data, (u_l, u_u, x_l, x_u)


def _solve_oracle(p, reg_x, reg_u, Nc, bounds_arrays):
    M, N, xdim = p["f"].shape
    udim = p["fu"].shape[-1]
    u_l, u_u, x_l, x_u = bounds_arrays
    P, q = oracle.build_Pq(**p, reg_x=reg_x, reg_u=reg_u, slew_reg=np.zeros(M),
                           slew_reg0=np.zeros(M), slew_um1=np.zeros((M, udim)), Nc=Nc)
    A, b = oracle.build_Ab(p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"], Nc)
    lo, hi = oracle.bounds_vectors(x_l, x_u, u_l, u_u, N, xdim, udim, M, Nc)
    z = oracle.solve_box_qp(P, q, A, b, lo, hi)
    return oracle.split_z(z, N, xdim, udim, M, Nc)


@pytest.mark.parametrize("Nc", [0, 3])
def test_ipm_u_bounds(Nc):
    rng = np.random.default_rng(10 + Nc)
    M, N, xdim, udim = 2, 8, 3, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    X, U, data, ba = _solve_ours(p, 1.0, 0.1, Nc, u_bounds=(-0.5, 0.5))
    assert data["ipm_converged"], f"IPM did not converge: mu={data['ipm_mu']}"
    X_o, U_o = _solve_oracle(p, 1.0, 0.1, Nc, ba)
    np.testing.assert_allclose(U, U_o, atol=5e-5)
    assert U.max() <= 0.5 + 1e-6 and U.min() >= -0.5 - 1e-6
    # some bounds must actually be active for this to be a meaningful test
    assert (np.abs(np.abs(U) - 0.5) < 1e-5).any()


def test_ipm_ux_bounds():
    rng = np.random.default_rng(20)
    M, N, xdim, udim = 2, 8, 3, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    X, U, data, ba = _solve_ours(p, 1.0, 0.1, 2, u_bounds=(-0.6, 0.6), x_bounds=(-4.0, 4.0))
    assert data["ipm_converged"]
    X_o, U_o = _solve_oracle(p, 1.0, 0.1, 2, ba)
    np.testing.assert_allclose(U, U_o, atol=1e-4)
    np.testing.assert_allclose(X, X_o, atol=1e-4)
    assert X.max() <= 4.0 + 1e-5 and X.min() >= -4.0 - 1e-5


def test_ipm_infeasible_reports_failure():
    """Control bounds too tight to keep states in range -> infeasible QP; the
    IPM must flag non-convergence instead of returning garbage silently."""
    rng = np.random.default_rng(20)
    M, N = 2, 8
    p = oracle.random_problem(rng, M=M, N=N, xdim=3, udim=2)
    X, U, data, _ = _solve_ours(p, 1.0, 0.1, 2, u_bounds=(-0.6, 0.6), x_bounds=(-2.0, 2.0))
    assert not data["ipm_converged"]


def test_ipm_one_sided_x_bounds():
    rng = np.random.default_rng(30)
    M, N, xdim, udim = 1, 6, 3, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    u_l = np.full((M, N, udim), -0.4)
    u_u = np.full((M, N, udim), np.inf)  # one-sided via +inf entries
    X, U, data = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"],
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M), slew_um1=np.zeros((M, udim)),
        u_l=u_l, u_u=u_u, x_l=None, x_u=None, Nc=0, settings={},
    )
    assert data["ipm_converged"]
    assert U.min() >= -0.4 - 1e-6
    P, q = oracle.build_Pq(**p, reg_x=1.0, reg_u=0.1, slew_reg=np.zeros(M),
                           slew_reg0=np.zeros(M), slew_um1=np.zeros((M, udim)), Nc=0)
    A, b = oracle.build_Ab(p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"], 0)
    lo, hi = oracle.bounds_vectors(None, None, u_l, u_u, N, xdim, udim, M, 0)
    z = oracle.solve_box_qp(P, q, A, b, lo, hi)
    X_o, U_o = oracle.split_z(z, N, xdim, udim, M, 0)
    np.testing.assert_allclose(U, U_o, atol=5e-5)


def test_ipm_inactive_bounds_match_eq():
    """With very loose bounds the IPM must reproduce the equality solution."""
    rng = np.random.default_rng(40)
    M, N, xdim, udim = 2, 6, 3, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    X_b, U_b, data, _ = _solve_ours(p, 1.0, 0.1, 0, u_bounds=(-1e4, 1e4))
    X_e, U_e, _ = affine_solve_np(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"],
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M), slew_um1=np.zeros((M, udim)),
        u_l=None, u_u=None, x_l=None, x_u=None, Nc=0, settings={},
    )
    np.testing.assert_allclose(U_b, U_e, atol=1e-5)


def test_ipm_single_solve_mode_matches_mehrotra():
    """``ipm_core(predictor=False)`` — the LOQO heuristic-sigma single-solve
    mode (off by default, but a supported option) must still reach the
    Mehrotra solution on a box QP."""
    import jax.numpy as jnp

    from pmpc_tpu.solvers.ipm import BoxBounds, ipm_core
    from pmpc_tpu.solvers.reduced import assemble_condensed

    rng = np.random.default_rng(33)
    M, N, xdim, udim = 2, 8, 3, 2
    Nc = 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    cqp = assemble_condensed(
        p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"],
        p["Q"], p["R"], p["X_ref"], p["U_ref"],
        reg_x=np.full(M, 1.0), reg_u=np.full(M, 0.1),
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M),
        slew_um1=np.zeros((M, udim)), Nc=Nc,
    )
    nc = Nc * udim
    NX = N * xdim
    lo = np.full((M, N * udim), -0.5)
    hi = np.full((M, N * udim), 0.5)
    bounds = BoxBounds(
        lo_c=jnp.asarray(lo[0, :nc]), hi_c=jnp.asarray(hi[0, :nc]),
        lo_f=jnp.asarray(lo[:, nc:]), hi_f=jnp.asarray(hi[:, nc:]),
        lo_x=jnp.full((M, NX), -jnp.inf), hi_x=jnp.full((M, NX), jnp.inf),
    )
    sols = {}
    for pred in (True, False):
        uc, uf, stats = ipm_core(cqp, bounds, has_u=True, has_x=False,
                                 iters=80, tol_exp=-9, predictor=pred)
        assert bool(stats["converged"]), f"predictor={pred} did not converge"
        sols[pred] = (np.asarray(uc), np.asarray(uf), int(stats["iters"]))
    np.testing.assert_allclose(sols[False][0], sols[True][0], atol=1e-5)
    np.testing.assert_allclose(sols[False][1], sols[True][1], atol=1e-5)
    # the mode trades solves-per-iteration for iterations: it must take MORE
    # iterations than Mehrotra (this pins that the flag actually switches the
    # step computation rather than silently running the predictor path)
    assert sols[False][2] > sols[True][2]
