"""Randomized accelerator-f32 vs CPU-f64 accuracy sweep over fused-path configs.

The single-config probe (`accuracy_probe.py`) covers the flagship; this sweep
draws K random problem configurations across the fused features —
dimensions, consensus horizon, box bounds (one/two sided), per-stage SOC
cones — and checks ‖U32−U64‖∞ ≤ 1e-3 on each. The f64 references come from
a CPU-x64 subprocess; the f32 solves run on the default device.

Usage: python benchmarks/accuracy_sweep.py [--k 8] [--seed 0]
Exit code 1 if any config violates the tolerance.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
REF_DIR = os.path.join(REPO, "benchmarks", "accuracy_sweep_refs")


def draw_config(rng):
    N = int(rng.integers(8, 41))
    M = int(rng.choice([1, 2, 4, 8]))
    Nc = int(rng.integers(0, min(N, 6)))
    xdim, udim = 4, 2
    kind = rng.choice(["eq", "box", "onesided", "soc"])
    return dict(N=N, M=M, Nc=Nc, xdim=xdim, udim=udim, kind=str(kind),
                seed=int(rng.integers(0, 2**31)))


def build(cfg, dtype):
    from pmpc_tpu.jax_scp import build_scp_solver, make_scp_data
    from fixtures import unicycle_step

    N, M, Nc = cfg["N"], cfg["M"], cfg["Nc"]
    xdim, udim = cfg["xdim"], cfg["udim"]
    rng = np.random.default_rng(cfg["seed"])
    x0 = (np.ones((M, xdim)) + 0.1 * rng.normal(size=(M, xdim))).astype(dtype)
    Q = np.tile(np.eye(xdim, dtype=dtype), (M, N, 1, 1))
    R = np.tile((1e-2 * np.eye(udim)).astype(dtype), (M, N, 1, 1))
    kw = dict(reg_x=1.0, reg_u=0.1)
    skw = dict(Nc=Nc, max_it=120, res_tol=1e-5, ipm_iters=25,
               ipm_tol_exp=-9 if dtype == np.float64 else -6)
    if cfg["kind"] in ("box", "soc"):
        kw.update(u_l=-np.ones((M, N, udim), dtype),
                  u_u=np.ones((M, N, udim), dtype))
        skw["has_u_bounds"] = True
    elif cfg["kind"] == "onesided":
        kw.update(u_u=np.full((M, N, udim), 0.7, dtype))
        skw["has_u_bounds"] = True
    if cfg["kind"] == "soc":
        kw["u_soc_r"] = np.full((M, N), 0.9, dtype)
        skw["has_u_soc"] = True
    data = make_scp_data(x0, Q, R, **kw)
    solver = build_scp_solver(unicycle_step, N=N, xdim=xdim, udim=udim, M=M,
                              **skw)
    return solver, data


#: solver-budget tag baked into the cache filename: stale references solved
#: under a DIFFERENT budget must never be compared against
_SOLVER_TAG = "mi120_ii25_te9"


def ref_path(cfg):
    key = "_".join(f"{k}{cfg[k]}" for k in
                   ("N", "M", "Nc", "kind", "seed"))
    return os.path.join(REF_DIR, f"u64_{key}_{_SOLVER_TAG}.npz")


def run_ref(cfg):
    import jax

    jax.config.update("jax_enable_x64", True)
    solver, data = build(cfg, np.float64)
    X, U, info = solver(data)
    os.makedirs(REF_DIR, exist_ok=True)
    resid = float(info["resid"])
    np.savez(ref_path(cfg), U=np.asarray(U, np.float64), resid=resid)
    print(f"  ref resid {resid:.1e}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ref-config", type=str, default=None)
    args = ap.parse_args()

    if args.ref_config:
        run_ref(json.loads(args.ref_config))
        return

    rng = np.random.default_rng(args.seed)
    cfgs = [draw_config(rng) for _ in range(args.k)]

    env = dict(os.environ, JAX_PLATFORMS="cpu", PMPC_TPU_NO_CACHE="1")
    for cfg in cfgs:
        if not os.path.exists(ref_path(cfg)):
            print(f"ref {cfg} ...", flush=True)
            subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--ref-config", json.dumps(cfg)],
                check=True, env=env)

    bad = skipped = 0
    for cfg in cfgs:
        ref = np.load(ref_path(cfg))
        U64, ref_resid = ref["U"], float(ref["resid"])
        if ref_resid > 1e-4:
            # the f64 run did not CONVERGE within the budget: comparing two
            # mid-trajectory iterates measures path divergence, not solver
            # accuracy (the BASELINE contract is vs CONVERGED controls)
            skipped += 1
            print(f"  N={cfg['N']:3d} M={cfg['M']} Nc={cfg['Nc']} "
                  f"{cfg['kind']:9s}: SKIPPED (ref not converged, "
                  f"resid {ref_resid:.1e})", flush=True)
            continue
        solver, data = build(cfg, np.float32)
        X, U, info = solver(data)
        U32 = np.asarray(U, np.float64)
        err = float(np.abs(U32 - U64).max())
        ok = err <= 1e-3
        bad += 0 if ok else 1
        print(f"  N={cfg['N']:3d} M={cfg['M']} Nc={cfg['Nc']} "
              f"{cfg['kind']:9s}: |U32-U64|_inf = {err:.2e}  "
              f"resid={float(np.asarray(info['resid'])):.1e}  "
              f"{'ok' if ok else 'VIOLATION'}", flush=True)
    print(f"{args.k - bad - skipped}/{args.k - skipped} within 1e-3 "
          f"({skipped} skipped: reference not converged in budget)")
    sys.exit(0 if bad == 0 else 1)


if __name__ == "__main__":
    main()
