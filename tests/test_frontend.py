"""Frontend parity: Problem struct, batched solve_problems, accelerated, tune."""

import numpy as np
import pytest

import pmpc_tpu
from pmpc_tpu.problem import Problem
from fixtures import dubins_f_fx_fu_fn, double_integrator_f_fx_fu_fn


def test_problem_dim_inference_and_defaults():
    p = Problem(N=20, xdim=4, udim=2)
    assert p.N == 20 and p.xdim == 4 and p.udim == 2
    assert p.Q.shape == (20, 4, 4) and np.allclose(p.Q[0], np.eye(4))
    assert p.R.shape == (20, 2, 2) and np.allclose(p.R[0], 0.1 * np.eye(2))
    assert p.reg_x == 1.0 and p.reg_u == 1.0
    assert p.max_it == 30 and p.res_tol == 1e-6 and p.verbose is True
    assert p.Nc == 0

    p2 = Problem(Q=np.tile(np.eye(3), (7, 1, 1)), R=np.tile(np.eye(1), (7, 1, 1)))
    assert p2.N == 7 and p2.xdim == 3 and p2.udim == 1

    with pytest.raises(ValueError):
        Problem(N=5, xdim=2)  # missing udim


def test_problem_tiling_for_M():
    p = Problem(N=10, xdim=4, udim=2, M=3)
    assert p.Q.shape == (3, 10, 4, 4)
    p.x0 = np.ones(4)
    assert p.x0.shape == (3, 4)
    with pytest.raises(AssertionError):
        p.x0 = np.ones(5)


def test_problem_mapping_protocol_solves():
    p = Problem(N=8, xdim=4, udim=2)
    p.f_fx_fu_fn = dubins_f_fx_fu_fn()
    p.x0 = np.ones(4)
    d = dict(p)
    assert "Q" in d and "solver_settings" in d
    X, U, data = pmpc_tpu.solve(**dict(p, verbose=False, max_it=3))
    assert X.shape == (9, 4)


def test_solve_problems_stacked_matches_individual():
    f_fn = double_integrator_f_fx_fu_fn()
    N, xdim, udim = 10, 2, 1
    rng = np.random.default_rng(0)
    problems = []
    for i in range(4):
        problems.append(dict(
            f_fx_fu_fn=f_fn,
            Q=np.tile(np.eye(xdim), (N, 1, 1)),
            R=np.tile(0.1 * np.eye(udim), (N, 1, 1)),
            x0=rng.normal(size=xdim),
            max_it=10, res_tol=1e-7,
        ))
    rets = pmpc_tpu.solve_problems(problems, verbose=False)
    assert len(rets) == 4
    for (X, U, data), p in zip(rets, problems):
        X_i, U_i, _ = pmpc_tpu.solve(**dict(p, verbose=False))
        np.testing.assert_allclose(U, U_i, atol=1e-7)


def test_solve_problems_heterogeneous_falls_back():
    f_fn = double_integrator_f_fx_fu_fn()
    p1 = dict(f_fx_fu_fn=f_fn, Q=np.tile(np.eye(2), (10, 1, 1)),
              R=np.tile(np.eye(1), (10, 1, 1)), x0=np.ones(2), max_it=3)
    p2 = dict(f_fx_fu_fn=f_fn, Q=np.tile(np.eye(2), (12, 1, 1)),
              R=np.tile(np.eye(1), (12, 1, 1)), x0=np.ones(2), max_it=3)
    rets = pmpc_tpu.solve_problems([p1, p2], verbose=False)
    assert rets[0][0].shape == (11, 2) and rets[1][0].shape == (13, 2)


def test_solve_problems_array_valued_settings():
    """Array values (e.g. weights) in solver_settings must not break the
    homogeneity check, and each split result gets its own data dict."""
    f_fn = double_integrator_f_fx_fu_fn()
    N, xdim, udim = 8, 2, 1
    rng = np.random.default_rng(1)
    ss = dict(weights=np.array([1.0]))
    problems = [dict(
        f_fx_fu_fn=f_fn,
        Q=np.tile(np.eye(xdim), (N, 1, 1)),
        R=np.tile(0.1 * np.eye(udim), (N, 1, 1)),
        x0=rng.normal(size=xdim), max_it=4,
        solver_settings=dict(ss),
    ) for _ in range(3)]
    rets = pmpc_tpu.solve_problems(problems, verbose=False)
    assert len(rets) == 3
    datas = [d for (_, _, d) in rets]
    assert datas[0] is not datas[1] and datas[0]["hist"] is not datas[1]["hist"]
    datas[0]["hist"][-1]["marker"] = 1
    assert "marker" not in datas[1]["hist"][-1]


def test_accelerated_scp_solve_runs():
    f_fn = dubins_f_fx_fu_fn()
    M, N, xdim, udim = 1, 10, 4, 2
    Q = np.tile(np.eye(xdim), (M, N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (M, N, 1, 1))
    x0 = np.ones((M, xdim))
    X, U, data = pmpc_tpu.accelerated_scp_solve(
        f_fn, Q, R, x0, verbose=False, max_it=15, res_tol=1e-5, reg_x=1.0, reg_u=0.1,
    )
    assert X is not None and X.shape == (M, N + 1, xdim)
    assert data["hist"][-1]["resid"] < 1e-2


def test_tune_scp_picks_a_reg():
    f_fn = dubins_f_fx_fu_fn()
    N, xdim, udim = 8, 4, 2
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    reg_x, reg_u = pmpc_tpu.tune_scp(
        f_fn, Q, R, np.ones(xdim), sample_nb=3, reg_rng=(-1, 1), max_it=5,
    )
    assert reg_x > 0 and np.isclose(reg_u, 0.1 * reg_x)


def test_shorten_horizon():
    from pmpc_tpu.dynamics import shorten_horizon

    N, xdim, udim = 10, 3, 2
    f = np.zeros((N, xdim))
    fx = np.zeros((N, xdim, xdim))
    Q = np.zeros((5, N, xdim, xdim))
    U = np.zeros((N, udim))
    f2, fx2, Q2, U2 = shorten_horizon(6, f, fx, Q, U)
    assert f2.shape == (6, xdim) and fx2.shape == (6, xdim, xdim)
    assert Q2.shape == (5, 6, xdim, xdim) and U2.shape == (6, udim)


def test_remote_farm_scheduler():
    """Greedy batch scheduler over a localhost worker (remote.py parity)."""
    import os
    import subprocess
    import sys
    import time as _time

    import pmpc_tpu.remote as remote
    from fixtures import double_integrator_f_fx_fu_fn

    PORT = 58431
    env = dict(os.environ)
    env["PMPC_TPU_NO_CACHE"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "pmpc_tpu.remote", "--port", str(PORT),
         "--worker-num", "1", "--no-warmup"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    try:
        _time.sleep(3.0)
        f_fn = double_integrator_f_fx_fu_fn()
        rng = np.random.default_rng(0)
        problems = [dict(
            f_fx_fu_fn=f_fn,
            Q=np.tile(np.eye(2), (8, 1, 1)),
            R=np.tile(0.1 * np.eye(1), (8, 1, 1)),
            x0=rng.normal(size=2), max_it=4, verbose=False,
        ) for _ in range(3)]
        rets = remote.solve_problems(problems, workers=[("localhost", PORT)],
                                     max_solve_time=60.0)
        assert len(rets) == 3
        for (X, U, data) in rets:
            assert X.shape == (9, 2)
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_solve_problems_fused_matches_host():
    """fused=True runs the whole batch as one device program; solutions must
    match the host-loop route to solver tolerance."""
    from pmpc_tpu.dynamics import make_f_fx_fu_fn
    import jax.numpy as jnp

    def step(x, u):
        return jnp.stack([x[0] + 0.1 * x[1], x[1] + 0.1 * u[0]])

    f_fn = make_f_fx_fu_fn(step)
    N, xdim, udim = 10, 2, 1
    rng = np.random.default_rng(1)
    problems = [dict(
        f_fx_fu_fn=f_fn,
        Q=np.tile(np.eye(xdim), (N, 1, 1)),
        R=np.tile(0.1 * np.eye(udim), (N, 1, 1)),
        x0=rng.normal(size=xdim),
        u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
        max_it=12, res_tol=1e-5,
    ) for _ in range(3)]
    rets_f = pmpc_tpu.solve_problems(problems, fused=True)
    rets_h = pmpc_tpu.solve_problems(problems, verbose=False)
    assert len(rets_f) == 3
    for (Xf, Uf, df), (Xh, Uh, dh) in zip(rets_f, rets_h):
        assert df["fused"] and df["converged"]
        np.testing.assert_allclose(Uf, Uh, atol=1e-5)


def test_solve_problems_fused_rejects_unsupported():
    from pmpc_tpu.dynamics import make_f_fx_fu_fn
    import jax.numpy as jnp
    import pytest as _pytest

    f_fn = make_f_fx_fu_fn(lambda x, u: x + 0.1 * jnp.concatenate([u, u]))
    p = dict(f_fx_fu_fn=f_fn, Q=np.tile(np.eye(2), (5, 1, 1)),
             R=np.tile(np.eye(1), (5, 1, 1)), x0=np.ones(2),
             solver_settings=dict(diff_cost_fn=lambda X, U: 0.0))
    # diff_cost_fn cannot ride any batched route: clear rejection
    # (weights USED to be rejected here; round 5 routes them through the
    # cone batcher's cost pre-scaling — see test_batched_weights...)
    with _pytest.raises(ValueError, match="not support"):
        pmpc_tpu.solve_problems([p, p], fused=True)
    # and a non-protocol callback is rejected with a clear message
    p2 = dict(p, solver_settings=None)
    p2["f_fx_fu_fn"] = lambda X, U: (np.zeros((5, 2)),
                                     np.zeros((5, 2, 2)), np.zeros((5, 2, 1)))
    with _pytest.raises(ValueError, match="dynamics protocol"):
        pmpc_tpu.solve_problems([p2, p2], fused=True)


def test_problem_xprev_tracks_x0():
    """Setting x0 refreshes the default X_prev (x0 tiled over the horizon,
    reference parity); an explicit X_prev wins over the refresh."""
    p = Problem(N=6, xdim=3, udim=1)
    p.x0 = np.array([2.0, -1.0, 0.5])
    np.testing.assert_allclose(p.X_prev, np.tile(p.x0, (6, 1)))
    p.X_prev = np.ones((6, 3))
    p.x0 = np.zeros(3)  # user X_prev must survive later x0 updates
    np.testing.assert_allclose(p.X_prev, np.ones((6, 3)))
    # x0 passed at construction also tiles
    p2 = Problem(N=4, xdim=2, udim=1, x0=np.array([3.0, 4.0]))
    np.testing.assert_allclose(p2.X_prev, np.tile([3.0, 4.0], (4, 1)))


def test_warmup_cli_smoke():
    import subprocess
    import sys as _sys
    import os as _os

    env = dict(_os.environ, JAX_PLATFORMS="cpu",
               PMPC_TPU_NO_CACHE="1")
    r = subprocess.run(
        [_sys.executable, "-m", "pmpc_tpu.warmup",
         "--N", "6", "--M", "1", "--max-it", "2", "--bounded"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "warm" in r.stdout
