"""Throughput of the device-native CVaR-k and extras-SOC cone paths.

These cone programs once were assembled with per-iteration host numpy
loops; the G/h assembly now runs on device (batched Cholesky + broadcast-mask embeddings,
one jitted program per constraint signature — solvers/cvar.py,
solvers/extras.py). This measures the end-to-end `pmpc_tpu.solve` rate for
both paths (warm, after the per-signature jit compile) plus correctness
signals (cone feasibility, consensus spread).

Role of the reference's k-worst CVaR objective (main.jl:221-232) and
extra user cones (main.jl:292-316).
"""

import json
import os
import sys
import time

# the f64 batched cone path is CPU-pinned and shards its batch over the
# process's XLA CPU devices (conebatch auto-shard): expose one per core.
# Must happen before jax initializes -> re-exec.
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={os.cpu_count()}").strip()
    os.execv(sys.executable, [sys.executable] + sys.argv)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import numpy as np


def _u_norm_soc_fns(umax, Nc):
    """extra_cstrs_fns returning one SOC per (particle, step): ||u_ij|| <= umax."""

    def fns(X_prev, U_prev, problems):
        M, N, udim = U_prev.shape
        xdim = X_prev.shape[-1]
        nc, nf = Nc * udim, (N - Nc) * udim
        n_full = nc + M * nf + M * N * xdim
        rows, hs, qsizes = [], [], []
        seen = set()
        for i in range(M):
            for j in range(N):
                if j < Nc:
                    start = j * udim
                else:
                    start = nc + i * nf + (j - Nc) * udim
                if (start,) in seen:
                    continue
                seen.add((start,))
                G = np.zeros((1 + udim, n_full))
                h = np.zeros(1 + udim)
                h[0] = umax
                for r in range(udim):
                    G[1 + r, start + r] = -1.0
                rows.append(G)
                hs.append(h)
                qsizes.append(1 + udim)
        return [(0, qsizes, 0, np.concatenate(rows, 0), np.zeros((sum(qsizes), 0)),
                 np.concatenate(hs), np.zeros(n_full), np.zeros(0))]

    return fns


def main():
    import pmpc_tpu
    from fixtures import dubins_f_fx_fu_fn

    f_fx_fu = dubins_f_fx_fu_fn()
    M, N, xdim, udim, Nc = 16, 20, 4, 2, 5
    rng = np.random.default_rng(7)
    Q = np.tile(np.eye(xdim), (M, N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (M, N, 1, 1))
    x0 = np.ones((M, xdim)) + 0.05 * rng.normal(size=(M, xdim))

    def run(tag, reps=5, **kw):
        # cold call (per-signature compile) then timed warm calls
        X, U, data = pmpc_tpu.solve(f_fx_fu, Q, R, x0, max_it=6, res_tol=1e-7,
                                    verbose=False, **kw)
        t0 = time.perf_counter()
        for _ in range(reps):
            X, U, data = pmpc_tpu.solve(f_fx_fu, Q, R, x0, max_it=6,
                                        res_tol=1e-7, verbose=False, **kw)
        dt = (time.perf_counter() - t0) / reps
        return dict(config=tag, solves_per_s=round(1.0 / dt, 2),
                    ms_per_solve=round(1e3 * dt, 1)), X, U, data

    # 1) CVaR k-worst-particle consensus objective. Full consensus (Nc=N):
    # with free per-particle controls the k-worst epigraph leaves non-worst
    # particles' controls gradient-free (same property as the reference's
    # formulation, main.jl:221-232) and the SCP wanders.
    line, X, U, data = run("cvar_k4_M16_N20",
                           solver_settings=dict(k=4))
    line["consensus_spread"] = float(np.ptp(U, axis=0).max())
    print(json.dumps(line), flush=True)

    # 2) user extras: per-stage SOC ||u|| <= 0.9 via extra_cstrs_fns
    umax = 0.9
    line, X, U, data = run("extras_soc_M16_N20",
                           solver_settings=dict(Nc=Nc),
                           extra_cstrs_fns=_u_norm_soc_fns(umax, Nc))
    line["u_norm_max"] = float(np.linalg.norm(U, axis=-1).max())
    line["consensus_spread"] = float(np.ptp(U[:, :Nc, :], axis=0).max())
    print(json.dumps(line), flush=True)

    # 3) SCENARIO-BATCHED cone paths (round-3): B problems, one vmapped
    # device cone solve per SCP iteration (conebatch.solve_problems_cone).
    # The per-problem serial rates above are the baseline to beat >=10x.
    from pmpc_tpu.batch import solve_problems
    from fixtures import unicycle_step

    f_jax = pmpc_tpu.make_f_fx_fu_fn(unicycle_step)
    B = 64
    Mb = 4  # B x Mb particles total on device per iteration

    def mk(seed, **ss):
        r = np.random.default_rng(seed)
        return dict(
            f_fx_fu_fn=f_jax,
            Q=np.tile(np.eye(xdim), (Mb, N, 1, 1)),
            R=np.tile(1e-2 * np.eye(udim), (Mb, N, 1, 1)),
            x0=np.ones((Mb, xdim)) + 0.05 * r.normal(size=(Mb, xdim)),
            max_it=6, res_tol=1e-7,
            solver_settings=dict(Nc=Nc, **ss))

    def run_batch(tag, probs):
        out = solve_problems(probs, fused=True)  # cold: compile
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = solve_problems(probs, fused=True)
        dt = (time.perf_counter() - t0) / reps
        n_ok = sum(1 for r in out if r[2] is not None and r[2]["converged"])
        return dict(config=tag, B=len(probs),
                    solves_per_s=round(len(probs) / dt, 2),
                    ms_per_batch=round(1e3 * dt, 1), converged=n_ok), out

    # serial baseline on the IDENTICAL M=4 problem (apples-to-apples for the
    # batched ratio — the M=16 serial configs above carry ~4x more work)
    p0 = mk(0, k=2)
    Xs, Us, ds = pmpc_tpu.solve(
        f_fx_fu, p0["Q"], p0["R"], p0["x0"], max_it=6, res_tol=1e-7,
        verbose=False, solver_settings=p0["solver_settings"])
    t0 = time.perf_counter()
    for _ in range(3):
        Xs, Us, ds = pmpc_tpu.solve(
            f_fx_fu, p0["Q"], p0["R"], p0["x0"], max_it=6, res_tol=1e-7,
            verbose=False, solver_settings=p0["solver_settings"])
    dt = (time.perf_counter() - t0) / 3
    print(json.dumps(dict(
        config=f"serial_cvar_k2_M{Mb}", solves_per_s=round(1.0 / dt, 2),
        ms_per_solve=round(1e3 * dt, 1),
        resid=float(ds["hist"][-1]["resid"]))), flush=True)

    line, out = run_batch(
        f"batched_cvar_k2_B{B}_M{Mb}", [mk(i, k=2) for i in range(B)])
    line["resid_median"] = float(np.median(
        [r[2]["resid"] for r in out if r[2] is not None]))
    print(json.dumps(line), flush=True)

    # CONVERGING batched CVaR: FULL consensus (the reference's CVaR default,
    # main.jl:127) keeps every control in the k-worst objective's gradient
    # (with Nc<N the non-worst particles' free tails are gradient-free and
    # the SCP wanders — measured in round 3), k=M-1 keeps the k-worst set
    # stable, and a reachable res_tol lets the convergence contract latch
    # under load, not only in unit tests
    probs_c = [dict(mk(i), max_it=40, res_tol=1e-3) for i in range(B)]
    for p in probs_c:
        p["solver_settings"] = dict(k=Mb - 1)
    line, out = run_batch(f"batched_cvar_k{Mb-1}_fullcons_B{B}_M{Mb}_tol1e-3",
                          probs_c)
    line["resid_median"] = float(np.median(
        [r[2]["resid"] for r in out if r[2] is not None]))
    print(json.dumps(line), flush=True)

    nu_total = Nc * udim + Mb * (N - Nc) * udim
    n_full = nu_total + Mb * N * xdim

    def ec(i):
        g = np.zeros((1, n_full))
        g[0, :udim] = 1.0
        return (1, [], 0, g, np.zeros((1, 0)), np.array([0.2 + 0.01 * i]),
                np.zeros(n_full), np.zeros(0))

    # linear extras + per-stage control cones ride the STRUCTURED batched
    # route (vmapped arrow IPM with SMW-bordered rows — conebatch
    # _run_struct_batched), not the dense composed cone program.
    line, out = run_batch(
        f"batched_extras_usoc_B{B}_M{Mb}",
        [mk(i, extra_cstrs=[ec(i)], u_soc_r=np.full((Mb, N), umax))
         for i in range(B)])
    line["u_norm_max"] = float(max(
        np.linalg.norm(r[1], axis=-1).max() for r in out if r[1] is not None))
    print(json.dumps(line), flush=True)
    print("done", flush=True)


if __name__ == "__main__":
    main()
