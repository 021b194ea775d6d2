"""Accelerator f32 vs CPU f64 accuracy probe on the flagship bounded config.

`--ref` runs on CPU x64 (a subprocess, so x64 stays out of the measured
process) and writes the f64 converged controls; the default mode runs on the
default device in f32 (current solver defaults + any overrides) and
compares. Exit code 1 when the 1e-3 BASELINE tolerance is violated.
"""

import argparse
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
REF_PATH = os.path.join(REPO, "benchmarks", "accuracy_ref_u64.npy")


def build(dtype, tau):
    from pmpc_tpu.jax_scp import build_scp_solver, make_scp_data
    from fixtures import unicycle_step

    M, N, xdim, udim, Nc = 8, 30, 4, 2, 5
    rng = np.random.default_rng(0)
    x0 = (np.ones((M, xdim)) + 0.05 * rng.normal(size=(M, xdim))).astype(dtype)
    Q = np.tile(np.eye(xdim, dtype=dtype), (M, N, 1, 1))
    R = np.tile((1e-2 * np.eye(udim)).astype(dtype), (M, N, 1, 1))
    data = make_scp_data(x0, Q, R, reg_x=1.0, reg_u=0.1,
                         u_l=-np.ones((M, N, udim), dtype),
                         u_u=np.ones((M, N, udim), dtype))
    solver = build_scp_solver(
        unicycle_step, N=N, xdim=xdim, udim=udim, M=M, Nc=Nc,
        max_it=60, res_tol=1e-5, has_u_bounds=True, ipm_iters=25,
        ipm_tol_exp=-9 if dtype == np.float64 else -6,
        ipm_tau=tau,
    )
    return solver, data


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", action="store_true")
    ap.add_argument("--tau", type=float, default=None)
    args = ap.parse_args()

    if args.ref:
        import jax

        jax.config.update("jax_enable_x64", True)
        solver, data = build(np.float64, None)
        X, U, info = solver(data)
        np.save(REF_PATH, np.asarray(U, np.float64))
        print("ref resid:", float(info["resid"]))
        return

    if not os.path.exists(REF_PATH):
        env = dict(os.environ, JAX_PLATFORMS="cpu", PMPC_TPU_NO_CACHE="1")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--ref"],
                       check=True, env=env)

    solver, data = build(np.float32, args.tau)
    X, U, info = solver(data)
    U32 = np.asarray(U, np.float64)
    U64 = np.load(REF_PATH)
    err = np.abs(U32 - U64).max()
    print(f"tau={args.tau}  resid={float(np.asarray(info['resid'])):.2e}  "
          f"|U32 - U64|_inf = {err:.2e}  (tolerance 1e-3)")
    sys.exit(0 if err <= 1e-3 else 1)


if __name__ == "__main__":
    main()
