"""Arbitrary convex-cone constraints (role parity with the reference README's
"Arbitrary Constraints" section: linear, second-order-cone, and the dedicated
per-stage thrust-cone fast path).

 1. per-stage control-norm cones ``||u_j|| <= r`` via ``u_soc_r`` — the FAST
    path: exact cones inside the structured arrow IPM, fused/batchable,
 2. the general ``extra_cstrs_fns`` route (reference 8-tuple format over the
    canonical variable layout ``z = [u_cons; u_free; x]``): a linear
    constraint on the first control plus per-stage SOC cones, solved by the
    NT-scaled cone IPM.

Run:  python examples/arbitrary_constraints.py   (JAX's default device)
Set PMPC_EXAMPLES_FAST=1 for a seconds-long smoke run.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import pmpc_tpu

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


def demo_thrust_cone_fast_path():
    print("== 1. per-stage thrust cones ||u_j|| <= 0.7 (structured IPM) ==")
    N, xdim, udim = 8 if FAST else 20, 4, 2
    f_fn = pmpc_tpu.make_f_fx_fu_fn(unicycle)
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    X, U, data = pmpc_tpu.solve(
        f_fn, Q, R, np.ones(xdim),
        reg_x=1.0, reg_u=0.1, max_it=4 if FAST else 30, res_tol=1e-5,
        verbose=False,
        solver_settings=dict(u_soc_r=np.full((1, N), 0.7)),
    )
    norms = np.linalg.norm(U, axis=-1)
    print(f"  max ||u_j|| = {norms.max():.6f} (radius 0.7), "
          f"residual {data['hist'][-1]['resid']:.1e}")


def demo_extra_cstrs():
    print("== 2. general extra_cstrs: linear + SOC via the 8-tuple format ==")
    N, xdim, udim = 8 if FAST else 12, 4, 2
    umax, budget = 0.8, 0.5
    f_fn = pmpc_tpu.make_f_fx_fu_fn(unicycle)
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))

    # canonical layout for M=1, full consensus: z = [u (N*udim); x (N*xdim)]
    n_full = N * udim + N * xdim

    def extra_cstrs_fns(X_prev, U_prev, problems):
        # (a) one linear row: u_0[0] + u_0[1] <= budget  (s = h - Gz >= 0)
        G_lin = np.zeros((1, n_full))
        G_lin[0, 0] = G_lin[0, 1] = 1.0
        h_lin = np.array([budget])
        lin = (1, [], 0, G_lin, np.zeros((1, 0)), h_lin,
               np.zeros(n_full), np.zeros(0))
        # (b) one SOC per stage: ||u_j|| <= umax — rows [umax; u_j]
        rows, hs, qs = [], [], []
        for j in range(N):
            G = np.zeros((1 + udim, n_full))
            for r in range(udim):
                G[1 + r, j * udim + r] = -1.0
            rows.append(G)
            h = np.zeros(1 + udim)
            h[0] = umax
            hs.append(h)
            qs.append(1 + udim)
        soc = (0, qs, 0, np.concatenate(rows), np.zeros((len(qs) * (1 + udim), 0)),
               np.concatenate(hs), np.zeros(n_full), np.zeros(0))
        return [lin, soc]

    X, U, data = pmpc_tpu.solve(
        f_fn, Q, R, np.ones(xdim),
        extra_cstrs_fns=extra_cstrs_fns,
        reg_x=1.0, reg_u=0.1, max_it=4 if FAST else 30, res_tol=1e-5,
        verbose=False,
    )
    norms = np.linalg.norm(U, axis=-1)
    print(f"  u_0 sum = {U[0, 0] + U[0, 1]:.4f} (budget {budget}), "
          f"max ||u_j|| = {norms.max():.4f} (radius {umax}), "
          f"residual {data['hist'][-1]['resid']:.1e}")
    assert U[0, 0] + U[0, 1] <= budget + 1e-4
    assert norms.max() <= umax + 1e-4


if __name__ == "__main__":
    demo_thrust_cone_fast_path()
    demo_extra_cstrs()
    print("done")
