"""Property fuzz: the HOST loop and the FUSED device loop must produce the
same trajectories on random problems x random feature combos.

Both run the same number of SCP iterations (res_tol=0 disables early exit)
with exact subproblem solves, so the iterate sequences coincide up to solver
tolerance — any divergence is contract drift between the two entry points
(layouts, slew encoding, bound handling, consensus split)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import pmpc_tpu
from pmpc_tpu.dynamics import make_f_fx_fu_fn
from pmpc_tpu.jax_scp import build_scp_solver, make_scp_data


def _step(x, u):
    dt = 0.2
    px, py, v, th = x[0], x[1], x[2], x[3]
    return jnp.stack([
        px + dt * v * jnp.cos(th),
        py + dt * v * jnp.sin(th),
        v + dt * u[0],
        th + dt * u[1],
    ])


def _run_case(seed):
    rng = np.random.default_rng(seed)
    M = int(rng.integers(1, 4))
    N = int(rng.integers(4, 10))
    Nc = int(rng.integers(0, min(N, 4)))
    xdim, udim = 4, 2
    max_it = int(rng.integers(2, 5))
    bounds = str(rng.choice(["none", "u", "u_onesided", "ux"]))
    use_slew = bool(rng.integers(2))
    use_slew0 = bool(rng.integers(2))

    f_fn = make_f_fx_fu_fn(_step)
    Q = np.tile(np.eye(xdim), (M, N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (M, N, 1, 1))
    x0 = np.ones((M, xdim)) + 0.1 * rng.normal(size=(M, xdim))
    X_ref = 0.3 * rng.normal(size=(M, N, xdim))

    u_l = u_u = x_l = x_u = None
    if bounds in ("u", "ux"):
        u_l, u_u = -0.6 * np.ones((M, N, udim)), 0.6 * np.ones((M, N, udim))
    elif bounds == "u_onesided":
        u_u = 0.5 * np.ones((M, N, udim))
    if bounds == "ux":
        x_l, x_u = -5.0 * np.ones((M, N, xdim)), 5.0 * np.ones((M, N, xdim))

    slew_rate = 0.4 if use_slew else 0.0
    u0_slew = 0.2 * rng.normal(size=udim) if use_slew0 else None

    # host path (f64 on CPU)
    Xh, Uh, dh = pmpc_tpu.solve(
        f_fn, Q, R, x0, X_ref=X_ref,
        u_l=u_l, u_u=u_u, x_l=x_l, x_u=x_u,
        reg_x=1.0, reg_u=0.1,
        slew_rate=slew_rate, u0_slew=u0_slew,
        max_it=max_it, res_tol=0.0, verbose=False,
        solver_settings=dict(Nc=Nc, ipm_tol_exp=-10, ipm_iters=60),
    )
    assert Xh is not None, f"host solve failed (seed {seed})"

    # fused path, same dtype/tolerances
    data = make_scp_data(
        x0, Q, R, X_ref=X_ref,
        reg_x=1.0, reg_u=0.1,
        slew_reg=slew_rate,
        slew_reg0=(slew_rate if u0_slew is not None else 0.0),
        slew_um1=(np.tile(u0_slew, (M, 1)) if u0_slew is not None else None),
        u_l=u_l, u_u=u_u, x_l=x_l, x_u=x_u,
        dtype=np.float64,
    )
    s = build_scp_solver(
        _step, N=N, xdim=xdim, udim=udim, M=M, Nc=Nc,
        max_it=max_it, res_tol=0.0,
        has_u_bounds=u_l is not None or u_u is not None,
        has_x_bounds=x_l is not None,
        ipm_iters=60, ipm_tol_exp=-10, adaptive_tol=False,
        jit=False,
    )
    Xf, Uf, info = jax.jit(s)(data)
    dU = float(np.max(np.abs(np.asarray(Uf) - Uh)))
    assert dU < 5e-5, (
        f"seed {seed} (M={M} N={N} Nc={Nc} bounds={bounds} slew={use_slew}"
        f"/{use_slew0} its={max_it}): |dU|_inf = {dU:.2e}")


@pytest.mark.parametrize("seed", range(200, 205))
def test_host_vs_fused_paths_agree(seed):
    _run_case(seed)


def _run_soc_case(seed):
    rng = np.random.default_rng(seed)
    M = int(rng.integers(1, 3))
    N = int(rng.integers(4, 9))
    Nc = int(rng.integers(0, 3))
    xdim, udim = 4, 2
    max_it = int(rng.integers(2, 4))
    r = float(rng.uniform(0.3, 0.8))

    f_fn = make_f_fx_fu_fn(_step)
    Q = np.tile(np.eye(xdim), (M, N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (M, N, 1, 1))
    x0 = np.ones((M, xdim)) + 0.1 * rng.normal(size=(M, xdim))
    u_l = -np.ones((M, N, udim))
    u_u = np.ones((M, N, udim))
    soc = np.full((M, N), r)

    Xh, Uh, dh = pmpc_tpu.solve(
        f_fn, Q, R, x0, u_l=u_l, u_u=u_u,
        reg_x=1.0, reg_u=0.1, max_it=max_it, res_tol=0.0, verbose=False,
        solver_settings=dict(Nc=Nc, u_soc_r=soc, ipm_tol_exp=-10,
                             ipm_iters=80),
    )
    assert Xh is not None

    data = make_scp_data(x0, Q, R, reg_x=1.0, reg_u=0.1,
                         u_l=u_l, u_u=u_u, u_soc_r=soc, dtype=np.float64)
    s = build_scp_solver(
        _step, N=N, xdim=xdim, udim=udim, M=M, Nc=Nc,
        max_it=max_it, res_tol=0.0, has_u_bounds=True, has_u_soc=True,
        ipm_iters=80, ipm_tol_exp=-10, adaptive_tol=False, jit=False)
    Xf, Uf, info = jax.jit(s)(data)
    dU = float(np.max(np.abs(np.asarray(Uf) - Uh)))
    norms = np.linalg.norm(np.asarray(Uf), axis=-1)
    assert norms.max() <= r + 1e-6, f"seed {seed}: cone violated"
    assert dU < 1e-4, (
        f"seed {seed} (M={M} N={N} Nc={Nc} r={r:.2f} its={max_it}): "
        f"|dU|_inf = {dU:.2e}")


@pytest.mark.parametrize("seed", range(300, 304))
def test_host_vs_fused_soc_agree(seed):
    _run_soc_case(seed)


@pytest.mark.nightly
@pytest.mark.parametrize("seed", range(205, 212))
def test_host_vs_fused_paths_agree_full(seed):
    """Full-depth seed sweep (nightly)."""
    test_host_vs_fused_paths_agree(seed)


@pytest.mark.nightly
@pytest.mark.parametrize("seed", range(304, 308))
def test_host_vs_fused_soc_agree_full(seed):
    """Full-depth seed sweep (nightly)."""
    test_host_vs_fused_soc_agree(seed)
