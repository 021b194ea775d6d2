"""Three introductory solves (role parity with the reference's
``examples/simple_demo.ipynb``, rewritten as a runnable script):

 1. a random linear system through the ``Problem`` struct,
 2. a nonlinear unicycle car tracking a moved target via ``lin_cost_fn``
    with control bounds and a slew penalty,
 3. the signature *contingency / consensus* demo: M=2 dynamics particles —
    one loses all actuation authority after step 10 — that must share their
    first Nc=3 controls. The shared prefix hedges against the failure mode;
    the suffix splits per scenario.

Run:  python examples/simple_demo.py        (JAX's default device)
Set PMPC_EXAMPLES_FAST=1 for a seconds-long smoke run (used by the tests).
Plots are saved to examples/out/ when matplotlib is importable.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import pmpc_tpu
from pmpc_tpu import Problem

FAST = os.environ.get("PMPC_EXAMPLES_FAST") == "1"
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def save_plot(name, X, U, M=None):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    os.makedirs(OUT, exist_ok=True)
    fig, ax = plt.subplots(1, 2, figsize=(9, 3.2))
    Xs = X if X.ndim == 3 else X[None]
    Us = U if U.ndim == 3 else U[None]
    for m in range(Xs.shape[0]):
        ls = "-" if m == 0 else "--"
        for i in range(Xs.shape[-1]):
            ax[0].plot(Xs[m, :, i], ls, color=f"C{i}", alpha=0.7,
                       label=f"x{i}" if m == 0 else None)
        for i in range(Us.shape[-1]):
            ax[1].plot(Us[m, :, i], ls, color=f"C{i}", alpha=0.7,
                       label=f"u{i}" if m == 0 else None)
    ax[0].set_title("states")
    ax[1].set_title("controls")
    ax[0].legend(fontsize=7)
    ax[1].legend(fontsize=7)
    path = os.path.join(OUT, f"{name}.png")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"  plot -> {path}")


def demo_linear_system():
    print("== 1. random linear system (Problem struct) ==")
    rng = np.random.default_rng(0)
    p = Problem(N=10 if FAST else 20, xdim=4, udim=2)
    A = rng.normal(size=(p.xdim, p.xdim)) * 0.3 + 0.5 * np.eye(p.xdim)
    B = np.array([[0.0, 0.0], [0.0, 0.0], [0.0, 0.3], [0.3, 0.0]])
    A_t = np.tile(A, (p.N, 1, 1))
    B_t = np.tile(B, (p.N, 1, 1))

    def f_fx_fu_fn(x, u):
        xp = np.einsum("...ij,...j->...i", A_t, x) + np.einsum(
            "...ij,...j->...i", B_t, u)
        sh = x.shape[:-1]
        return xp, np.broadcast_to(A_t, sh + A.shape).copy(), \
            np.broadcast_to(B_t, sh + B.shape).copy()

    p.f_fx_fu_fn = f_fx_fu_fn
    p.x0 = rng.normal(size=p.xdim)
    p.reg_x, p.reg_u = 1e-3, 1e-3
    p.max_it = 3 if FAST else 10
    X, U, data = pmpc_tpu.solve(**p)
    print(f"  residual {data['hist'][-1]['resid']:.2e}, |x_N| = "
          f"{np.linalg.norm(X[-1]):.3f} (from |x_0| = {np.linalg.norm(p.x0):.3f})")
    save_plot("linear_system", X, U)


def unicycle(x, u):
    """Unicycle car: [px, py, v, theta], controls [accel, turn rate]."""
    import jax.numpy as jnp

    dt = 0.25
    px, py, v, th = x[0], x[1], x[2], x[3]
    a, w = u[0], u[1]
    return jnp.stack([
        px + dt * v * jnp.cos(th),
        py + dt * v * jnp.sin(th),
        v + dt * a,
        th + dt * w,
    ])


def demo_car_tracking():
    print("== 2. unicycle car, moved target via lin_cost_fn + bounds + slew ==")
    N = 12 if FAST else 50
    xdim, udim = 4, 2
    f_fn = pmpc_tpu.make_f_fx_fu_fn(unicycle)
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    Q[-1] *= 1e2  # strong terminal weight
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    X_ref = np.ones((N, xdim))
    target2 = 3.0 * np.ones(xdim)

    def lin_cost_fn(X, U, problems=None):
        # extra linear cost pulling toward a SECOND target: gradient of
        # 0.5||x - target2||^2 evaluated at the linearization point
        return (X - target2), None

    X, U, data = pmpc_tpu.solve(
        f_fn, Q, R, np.zeros(xdim),
        X_ref=X_ref, lin_cost_fn=lin_cost_fn,
        u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
        slew_rate=1.0, reg_x=1.0, reg_u=1e-1,
        max_it=4 if FAST else 40, res_tol=1e-5, verbose=False,
    )
    print(f"  residual {data['hist'][-1]['resid']:.2e}, "
          f"u range [{U.min():.3f}, {U.max():.3f}] (bounds +-1), "
          f"final pos ({X[-1, 0]:.2f}, {X[-1, 1]:.2f})")
    save_plot("car_tracking", X, U)


def demo_contingency_consensus():
    print("== 3. contingency MPC: M=2 particles, one loses actuation at t=10 ==")
    M, N, xdim, udim = 2, 10 if FAST else 20, 4, 2
    Nc = 3
    rng = np.random.default_rng(1)
    A = rng.normal(size=(xdim, xdim)) * 0.3 + 0.4 * np.eye(xdim)
    B = np.array([[0.0, 0.0], [0.0, 0.0], [0.0, 0.3], [0.3, 0.0]])
    A_t = np.tile(A, (M, N, 1, 1))
    B_t = np.tile(B, (M, N, 1, 1))
    B_t[1, min(10, N - 1):] = 0.0  # particle 1: actuation lost after step 10

    def f_fx_fu_fn(x, u):
        xp = np.einsum("mnij,mnj->mni", A_t, x) \
            + np.einsum("mnij,mnj->mni", B_t, u)
        return xp, A_t.copy(), B_t.copy()

    Q = np.tile(np.eye(xdim), (M, N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (M, N, 1, 1))
    X_ref = np.stack([np.ones((N, xdim)), -np.ones((N, xdim))])
    x0 = np.ones((M, xdim))
    X, U, data = pmpc_tpu.solve(
        f_fx_fu_fn, Q, R, x0, X_ref=X_ref,
        reg_x=1.0, reg_u=1e-1,
        max_it=5 if FAST else 50, res_tol=1e-6, verbose=False,
        solver_settings=dict(Nc=Nc),
    )
    spread_cons = float(np.ptp(U[:, :Nc, :], axis=0).max())
    spread_free = float(np.ptp(U[:, Nc:, :], axis=0).max())
    print(f"  consensus spread over first {Nc} controls: {spread_cons:.2e} "
          f"(shared), over the rest: {spread_free:.3f} (split per scenario)")
    save_plot("contingency_consensus", X, U, M=M)
    assert spread_cons < 1e-5, "consensus controls must agree across particles"


if __name__ == "__main__":
    demo_linear_system()
    demo_car_tracking()
    demo_contingency_consensus()
    print("done")
