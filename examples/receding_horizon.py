"""Closed-loop receding-horizon MPC with warm starting (role parity with the
reference's documented warm-start workflow, README "Warm-start support": shift
``X_prev/U_prev`` each step and anchor the first action with ``u_slew``).

A unicycle car tracks a moving waypoint for T steps. Each control step:
 1. solve the horizon problem warm-started from the SHIFTED previous solution,
 2. apply the first control to the plant,
 3. anchor the next solve's first action to it (slew anchor) for smooth
    actuation.

The control loop uses the FUSED solver (`jax_scp.build_scp_solver`): one
device call per control step — the on-device latency path (the host-loop
`pmpc_tpu.solve` API works identically but pays per-iteration dispatch;
set PMPC_RH_HOST=1 to run it for comparison).

Run:  python examples/receding_horizon.py    (JAX's default device)
Set PMPC_EXAMPLES_FAST=1 for a seconds-long smoke run.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import pmpc_tpu

FAST = os.environ.get("PMPC_EXAMPLES_FAST") == "1"
RUN_HOST = os.environ.get("PMPC_RH_HOST") == "1"
DT = 0.25


def unicycle(x, u):
    import jax.numpy as jnp

    px, py, v, th = x[0], x[1], x[2], x[3]
    return jnp.stack([
        px + DT * v * jnp.cos(th),
        py + DT * v * jnp.sin(th),
        v + DT * u[0],
        th + DT * u[1],
    ])


def plant_step(x, u):
    px, py, v, th = x
    return np.array([
        px + DT * v * np.cos(th),
        py + DT * v * np.sin(th),
        v + DT * u[0],
        th + DT * u[1],
    ])


def closed_loop_fused(N, T, xdim, udim, shift_warm=True, carry_duals=True,
                      quiet=False, **build_kw):
    """One fused device program per control step.

    ``shift_warm``/``carry_duals`` expose the two warm-start mechanisms for
    A/B (benchmarks/ab_warmstart.py): plan shifting (X_prev/U_prev) and the
    IPM primal/dual state carried across control steps. ``build_kw`` extends
    the solver build (e.g. ``accel="AA"``)."""
    import jax.numpy as jnp

    from pmpc_tpu.jax_scp import build_scp_solver, make_scp_data

    f32 = np.float32
    # max_it well above the warm-started need: the while_loop exits early on
    # convergence, so the cap costs nothing and the iteration counts below
    # show the real warm-start effect instead of saturating the budget
    bk = dict(max_it=3 if FAST else 15, res_tol=1e-4)
    bk.update(build_kw)
    solver = build_scp_solver(unicycle, N=N, xdim=xdim, udim=udim, M=1, Nc=0,
                              has_u_bounds=True, return_state=True, **bk)
    Q = np.tile(np.eye(xdim, dtype=f32), (1, N, 1, 1))
    R = np.tile((1e-2 * np.eye(udim)).astype(f32), (1, N, 1, 1))
    u_l = -np.ones((1, N, udim), f32)
    u_u = np.ones((1, N, udim), f32)

    x = np.zeros(xdim, f32)
    X_prev = U_prev = None
    u_last = np.zeros(udim, f32)
    state = None  # IPM primal/dual/slack point carried across control steps
    errs, times, iters_log = [], [], []
    for t in range(T):
        target = np.array([0.1 * t + 1.0, 1.0, 0.0, 0.0], f32)
        t0 = time.perf_counter()
        data = make_scp_data(
            x[None], Q, R,
            X_ref=np.tile(target, (1, N, 1)),
            X_prev=X_prev, U_prev=U_prev,
            reg_x=1.0, reg_u=0.1, slew_reg=0.5,
            slew_reg0=0.5 if t else 0.0, slew_um1=u_last[None],
            u_l=u_l, u_u=u_u,
        )
        X, U, info = solver(data, state)
        if carry_duals:
            state = info["solver_state"]
        u = np.asarray(U[0, 0], f32)
        times.append(time.perf_counter() - t0)
        iters_log.append(int(np.asarray(info["iters"])))
        x = plant_step(x, u).astype(f32)
        errs.append(float(np.linalg.norm(x[:2] - target[:2])))
        if shift_warm:
            # warm start: shift the plan one step (repeat the tail)
            Xs = np.asarray(X[0, 2:])  # drop x0 row and the consumed step
            X_prev = np.concatenate([Xs, Xs[-1:]], axis=0)[None]
            Us = np.asarray(U[0, 1:])
            U_prev = np.concatenate([Us, Us[-1:]], axis=0)[None]
        u_last = u
    if not quiet:
        print(f"  SCP iterations: cold {iters_log[0]}, warm median "
              f"{int(np.median(iters_log[1:]))} (max_it cap "
              f"{bk['max_it']})")
    return np.array(times) * 1e3, errs, iters_log


def closed_loop_host(N, T, xdim, udim):
    """Same loop through the reference-parity host API."""
    f_fn = pmpc_tpu.make_f_fx_fu_fn(unicycle)
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    x = np.zeros(xdim)
    X_prev = U_prev = None
    u_last = None
    errs, times = [], []
    for t in range(T):
        target = np.array([0.1 * t + 1.0, 1.0, 0.0, 0.0])
        t0 = time.perf_counter()
        X, U, data = pmpc_tpu.solve(
            f_fn, Q, R, x, X_ref=np.tile(target, (N, 1)),
            X_prev=X_prev, U_prev=U_prev,
            u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
            slew_rate=0.5, u0_slew=u_last,
            reg_x=1.0, reg_u=1e-1,
            max_it=3 if FAST else (20 if t == 0 else 6),
            res_tol=1e-5, verbose=False,
        )
        times.append(time.perf_counter() - t0)
        u = np.asarray(U[0], float)
        x = plant_step(x, u)
        errs.append(float(np.linalg.norm(x[:2] - target[:2])))
        X_prev = np.concatenate([X[2:], X[-1:]], axis=0)
        U_prev = np.concatenate([U[1:], U[-1:]], axis=0)
        u_last = u
    return np.array(times) * 1e3, errs


def report(tag, times_ms, errs, T, N):
    print(f"{tag}: {T} steps, horizon N={N}")
    print(f"  cold first solve: {times_ms[0]:8.1f} ms")
    print(f"  warm steps p50:   {np.median(times_ms[1:]):8.1f} ms "
          f"(min {times_ms[1:].min():.1f})")
    print(f"  tracking error: start {errs[0]:.2f} -> final {errs[-1]:.2f}")
    assert np.isfinite(times_ms).all()


def main():
    N = 8 if FAST else 20
    T = 4 if FAST else 30
    xdim, udim = 4, 2
    times_ms, errs, _ = closed_loop_fused(N, T, xdim, udim)
    report("closed loop (fused)", times_ms, errs, T, N)
    if not FAST:
        assert errs[-1] < errs[0], "closed loop should reduce tracking error"
    if RUN_HOST:
        times_ms, errs = closed_loop_host(N, T, xdim, udim)
        report("closed loop (host API)", times_ms, errs, T, N)


if __name__ == "__main__":
    main()
