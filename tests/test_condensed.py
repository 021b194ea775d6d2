"""Condensed consensus QP vs. dense numpy oracle (equality-only solves)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pmpc_tpu.dynamics import condense, rollout
from pmpc_tpu.solvers.reduced import assemble_condensed, solve_eq, recover_XU

import oracle


def _np_rollout(x0, f, fx, fu, X_prev, U_prev, U):
    N, xdim = f.shape
    X = np.zeros((N, xdim))
    xlin = np.concatenate([x0[None], X_prev[:-1]], axis=0)
    x = x0
    for j in range(N):
        x = f[j] + fx[j] @ (x - xlin[j]) + fu[j] @ (U[j] - U_prev[j])
        X[j] = x
    return X


def test_rollout_matches_numpy():
    rng = np.random.default_rng(0)
    p = oracle.random_problem(rng, M=1, N=10)
    U = rng.normal(size=(10, 2))
    args = [p[k][0] for k in ["x0", "f", "fx", "fu", "X_prev", "U_prev"]]
    X_np = _np_rollout(*args, U)
    X_jx = rollout(*[jnp.asarray(a) for a in args], jnp.asarray(U))
    np.testing.assert_allclose(np.asarray(X_jx), X_np, atol=1e-10)


def test_condense_matches_rollout():
    rng = np.random.default_rng(1)
    N, xdim, udim = 7, 3, 2
    p = oracle.random_problem(rng, M=1, N=N, xdim=xdim, udim=udim)
    args = [jnp.asarray(p[k][0]) for k in ["x0", "f", "fx", "fu", "X_prev", "U_prev"]]
    Ft, ft = condense(*args)
    for _ in range(3):
        U = rng.normal(size=(N, udim))
        X_roll = rollout(*args, jnp.asarray(U))
        du = (U - p["U_prev"][0]).reshape(-1)
        X_cond = (np.asarray(Ft) @ du + np.asarray(ft)).reshape(N, xdim)
        np.testing.assert_allclose(np.asarray(X_roll), X_cond, atol=1e-9)


@pytest.mark.parametrize("Nc", [0, 3, 8])
@pytest.mark.parametrize("slew", [False, True])
def test_eq_solve_matches_kkt_oracle(Nc, slew):
    rng = np.random.default_rng(2 + Nc)
    M, N, xdim, udim = 3, 8, 4, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    reg_x, reg_u = 1.0, 0.1
    if slew:
        slew_reg = 0.7 * np.ones(M)
        slew_reg0 = 0.3 * np.ones(M)
        slew_um1 = rng.normal(size=(M, udim))
    else:
        slew_reg = np.zeros(M)
        slew_reg0 = np.zeros(M)
        slew_um1 = np.zeros((M, udim))

    # oracle
    P, q = oracle.build_Pq(
        **p, reg_x=reg_x, reg_u=reg_u,
        slew_reg=slew_reg, slew_reg0=slew_reg0, slew_um1=slew_um1, Nc=Nc,
    )
    A, b = oracle.build_Ab(p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"], Nc)
    z = oracle.solve_eq_kkt(P, q, A, b)
    X_o, U_o = oracle.split_z(z, N, xdim, udim, M, Nc)

    # condensed on-device solve
    cqp = assemble_condensed(
        *[jnp.asarray(p[k]) for k in
          ["x0", "f", "fx", "fu", "X_prev", "U_prev", "Q", "R", "X_ref", "U_ref"]],
        reg_x=jnp.full(M, reg_x), reg_u=jnp.full(M, reg_u),
        slew_reg=jnp.asarray(slew_reg), slew_reg0=jnp.asarray(slew_reg0),
        slew_um1=jnp.asarray(slew_um1), Nc=Nc,
    )
    uc, uf = solve_eq(cqp)
    X, U = recover_XU(cqp, uc, uf, N=N)

    np.testing.assert_allclose(np.asarray(U), U_o, atol=1e-7)
    np.testing.assert_allclose(np.asarray(X), X_o, atol=1e-7)
    # consensus controls identical across particles
    if Nc > 0:
        assert np.ptp(np.asarray(U)[:, :Nc, :], axis=0).max() < 1e-12


def test_weights_rescale_costs():
    rng = np.random.default_rng(7)
    M, N, xdim, udim = 2, 5, 3, 2
    p = oracle.random_problem(rng, M=M, N=N, xdim=xdim, udim=udim)
    weights = np.array([0.25, 0.75])
    # oracle: scale Q,R,reg per particle by normalized weights
    Qw = p["Q"] * weights[:, None, None, None]
    Rw = p["R"] * weights[:, None, None, None]
    P, q = oracle.build_Pq(
        **dict(p, Q=Qw, R=Rw), reg_x=weights * 1.0, reg_u=weights * 0.1,
        slew_reg=np.zeros(M), slew_reg0=np.zeros(M), slew_um1=np.zeros((M, udim)), Nc=2,
    )
    A, b = oracle.build_Ab(p["x0"], p["f"], p["fx"], p["fu"], p["X_prev"], p["U_prev"], 2)
    z = oracle.solve_eq_kkt(P, q, A, b)
    X_o, U_o = oracle.split_z(z, N, xdim, udim, M, 2)

    cqp = assemble_condensed(
        *[jnp.asarray(p[k]) for k in
          ["x0", "f", "fx", "fu", "X_prev", "U_prev", "Q", "R", "X_ref", "U_ref"]],
        reg_x=jnp.full(M, 1.0), reg_u=jnp.full(M, 0.1),
        slew_reg=jnp.zeros(M), slew_reg0=jnp.zeros(M), slew_um1=jnp.zeros((M, udim)),
        Nc=2, weights=jnp.asarray(weights),
    )
    uc, uf = solve_eq(cqp)
    X, U = recover_XU(cqp, uc, uf, N=N)
    np.testing.assert_allclose(np.asarray(U), U_o, atol=1e-7)
