"""Custom-cost MPC (role parity with ``examples/custom_cost.ipynb``):

 1. ``lin_cost_fn`` — an arbitrary extra cost supplied through its gradient,
    re-linearized every SCP iteration (here: a pull toward a secondary
    target), solved on the exact-constraint IPM path,
 2. ``diff_cost_fn`` — an arbitrary DIFFERENTIABLE extra cost (autodiffed on
    device), which routes the subproblems to the smooth solver stack
    (L-BFGS / Newton over the condensed variable with log-barrier bounds);
    also shown with a named solver choice (``solver="SQP"``).

Run:  python examples/custom_cost.py       (JAX's default device)
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


def main():
    import jax.numpy as jnp

    N, xdim, udim = 8 if FAST else 20, 4, 2
    max_it = 4 if FAST else 30
    f_fn = pmpc_tpu.make_f_fx_fu_fn(unicycle)
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    base = dict(
        u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
        reg_x=3.0, reg_u=1.0, max_it=max_it, res_tol=1e-5, verbose=False,
    )

    # -- 1. linearized custom cost (gradient callback) ---------------------------
    def lin_cost_fn(X, U, problems=None):
        cx = -5.0 * np.ones(X.shape)  # constant pull toward +x
        return cx, None

    X, U, data = pmpc_tpu.solve(f_fn, Q, R, np.ones(xdim),
                                lin_cost_fn=lin_cost_fn, **base)
    print(f"lin_cost_fn:  residual {data['hist'][-1]['resid']:.2e}, "
          f"final pos ({X[-1, 0]:.2f}, {X[-1, 1]:.2f}), "
          f"u range [{U.min():.2f}, {U.max():.2f}]")

    # -- 2. differentiable custom cost (smooth path, autodiff on device) ---------
    def diff_cost_fn(X, U, *args, **kw):
        X_ref = -5.0 * jnp.ones(X.shape)
        U_ref = jnp.ones(U.shape)
        return jnp.mean((X - X_ref) ** 2) + jnp.mean((U - U_ref) ** 2)

    X2, U2, data2 = pmpc_tpu.solve(f_fn, Q, R, np.ones(xdim),
                                   diff_cost_fn=diff_cost_fn, **base)
    print(f"diff_cost_fn: residual {data2['hist'][-1]['resid']:.2e}, "
          f"final pos ({X2[-1, 0]:.2f}, {X2[-1, 1]:.2f})  (pulled toward -5)")

    # -- 3. same, with an explicit named smooth solver ----------------------------
    X3, U3, data3 = pmpc_tpu.solve(
        f_fn, Q, R, np.ones(xdim), diff_cost_fn=diff_cost_fn,
        **dict(base, solver_settings=dict(solver="SQP")))
    dU = float(np.max(np.abs(U3 - U2)))
    print(f"solver='SQP': residual {data3['hist'][-1]['resid']:.2e}, "
          f"|dU vs LBFGS|_inf = {dU:.2e}")


if __name__ == "__main__":
    main()
