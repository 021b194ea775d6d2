"""Solve a batch of 1000 MPC problems in ONE device program (role parity with
the reference's ``examples/gpu_solver.ipynb``, which vmaps its experimental
GPU solver over M=1000 problems — here the whole SCP loop is fused and
vmapped, so the batch costs one dispatch).

Two paths are shown:
 1. the list-of-problems API ``pmpc_tpu.solve_problems`` (stacks compatible
    problems and solves them in one vmapped call, like the reference's
    ``remote_like_interface.solve_problems``),
 2. the explicit fused solver (``jax_scp.build_scp_solver`` + ``jax.vmap``),
    the deployment-mode API with full control over batching,
and path 2's first problem is cross-checked against the host-loop
``pmpc_tpu.solve`` (the reference-architecture per-iteration path).

Run:  python examples/batch_solver.py      (JAX's default device)
Set PMPC_EXAMPLES_FAST=1 for a seconds-long smoke run.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

FAST = os.environ.get("PMPC_EXAMPLES_FAST") == "1"


def unicycle(x, u):
    import jax.numpy as jnp

    dt = 0.25
    px, py, v, th = x[0], x[1], x[2], x[3]
    return jnp.stack([
        px + dt * v * jnp.cos(th),
        py + dt * v * jnp.sin(th),
        v + dt * u[0],
        th + dt * u[1],
    ])


def main():
    import jax
    import jax.numpy as jnp

    import pmpc_tpu
    from pmpc_tpu.jax_scp import build_scp_solver, make_scp_data

    B = 16 if FAST else 1000
    N, xdim, udim = 8 if FAST else 20, 4, 2
    max_it = 3 if FAST else 32
    rng = np.random.default_rng(0)
    f32 = np.float32

    # -- path 1: list-of-problems API -------------------------------------------
    n_list = 4 if FAST else 32
    f_fn = pmpc_tpu.make_f_fx_fu_fn(unicycle)
    problems = [dict(
        f_fx_fu_fn=f_fn,
        Q=np.tile(np.eye(xdim), (N, 1, 1)),
        R=np.tile(1e-2 * np.eye(udim), (N, 1, 1)),
        x0=np.ones(xdim) + 0.1 * rng.normal(size=xdim),
        reg_x=1.0, reg_u=1e-1, max_it=max_it, res_tol=1e-5,
    ) for _ in range(n_list)]
    t0 = time.perf_counter()
    rets = pmpc_tpu.solve_problems(problems, verbose=False)
    dt = time.perf_counter() - t0
    print(f"solve_problems: {n_list} problems in {dt:.2f}s "
          f"(stacked into one vmapped host-loop solve)")
    rets_fused = pmpc_tpu.solve_problems(problems, fused=True)  # compile
    t0 = time.perf_counter()
    rets_fused = pmpc_tpu.solve_problems(problems, fused=True)
    dt = time.perf_counter() - t0
    dU = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(rets, rets_fused))
    print(f"  fused=True:   {n_list} problems in {dt*1e3:.0f} ms warm "
          f"(whole SCP loop as ONE device program; |dU|_inf vs host {dU:.1e})")

    # -- path 2: fused batch, one device program ---------------------------------
    solver = build_scp_solver(unicycle, N=N, xdim=xdim, udim=udim, M=1, Nc=0,
                              max_it=max_it, res_tol=1e-5, has_u_bounds=True,
                              jit=False)
    batched = jax.jit(jax.vmap(solver))
    one = make_scp_data(
        np.ones((1, xdim), f32),
        np.tile(np.eye(xdim, dtype=f32), (1, N, 1, 1)),
        np.tile((1e-2 * np.eye(udim)).astype(f32), (1, N, 1, 1)),
        reg_x=1.0, reg_u=0.1,
        u_l=-np.ones((1, N, udim), f32), u_u=np.ones((1, N, udim), f32),
    )
    data = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (B,) + x.shape), one)
    x0 = (np.ones((B, 1, xdim)) + 0.1 * rng.normal(size=(B, 1, xdim))).astype(f32)
    data = data._replace(x0=jnp.asarray(x0))
    jax.block_until_ready(batched(data))  # compile
    t0 = time.perf_counter()
    X, U, info = jax.block_until_ready(batched(data))
    dt = time.perf_counter() - t0
    conv = float(np.mean(np.asarray(info["converged"])))
    res_med = float(np.median(np.asarray(info["resid"])))
    print(f"fused batch:    {B} problems in {dt*1e3:.1f} ms warm "
          f"({B/dt:.0f} solves/s, {100*conv:.0f}% converged, "
          f"median resid {res_med:.1e})")

    # -- cross-check problem 0 against the host path ------------------------------
    Xh, Uh, _ = pmpc_tpu.solve(
        f_fn,
        np.tile(np.eye(xdim), (N, 1, 1)),
        np.tile(1e-2 * np.eye(udim), (N, 1, 1)),
        x0[0, 0].astype(np.float64),
        u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
        reg_x=1.0, reg_u=1e-1, max_it=max_it, res_tol=1e-5, verbose=False,
    )
    dU = float(np.max(np.abs(np.asarray(U[0, 0]) - Uh)))
    print(f"fused vs host-loop on problem 0: |dU|_inf = {dU:.2e}")


if __name__ == "__main__":
    main()
