"""Smoke run of the solver's main path on one NVIDIA GPU.

    python chip_smoke.py           # one card: device, factor, fused flagship, host API
    python chip_smoke.py --four    # four cards: the sharded path and its reference only

Phases, in order (each raises on failure, and the script then exits non-zero):

- device: requires ``jax.devices()[0].platform == "gpu"``; prints the device,
  the JAX version, ``XLA_FLAGS`` and ``nvidia-smi``'s name and power limit.
- factor: times ``ops.linalg.spd_factor`` + ``spd_apply`` (XLA Cholesky +
  triangular solves) and the blocked inverse Cholesky of ``ops/block_chol``
  at the flagship and config-5 factor shapes, under "high" and "highest"
  matmul precision, and checks each against a numpy float64 solve.
- fused: the flagship consensus batch (``__graft_entry__._flagship`` with
  ``bench.HEADLINE_KW``, B=64 varied-x0 scenarios, ``jit(vmap(solver))``)
  under the shipped precision ("highest" in every solver core) and, for the
  record, under "high" everywhere (TF32 on the card), each checked for
  convergence and against float64 solves of the same scenarios on the host
  CPU backend (see `phase_fused` for the bars; only the shipped run must
  meet them)
- host: ``pmpc_tpu.solve`` (M=1, and M=8 with Nc=5) and
  ``pmpc_tpu.solve_problems(..., fused=True)`` checked against serial solves.
- sharded (``--four`` only): ``make_sharded_solver`` on 4x1 and 2x2 meshes,
  condensed and Riccati methods, against the unsharded single-card vmap
  (checked in float64; see `phase_sharded`).

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU the script prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

# the float64 reference runs on the host CPU backend: keep it available when
# the environment names the accelerator platforms only
_plats = os.environ.get("JAX_PLATFORMS", "")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

FACTOR_SHAPES = ((2048, 50), (4096, 90))  # flagship B*M, nf; config 5 B*M, nf
FACTOR_TOL = 1e-4    # relative residual bound under "highest" (cond <= 1e3)
FUSED_B = 64
FUSED_REF = 4        # scenarios re-solved in float64 on the host CPU
ACC_TOL = 1e-3       # ||U - U_f64||_inf, the BASELINE f32 bar
# tests/test_accuracy.py's f32-vs-f64 configuration: a converged budget,
# where the 1e-3 bar measures arithmetic precision and not where the SCP
# loop happened to stop
ACC_KW = dict(max_it=60, res_tol=1e-5, ipm_iters=25)
HEADLINE_ERR_TOL = 5e-3  # tests/test_accuracy.py's bound for the headline budget
SHARDED_B = 256
SHARDED_TOL = 5e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu(count: int = 1) -> list:
    """The GPU devices, or SystemExit when JAX finds none (no CPU fallback)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX's default device is "
                         f"{devs[0].platform}); nothing was run")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {len(devs)}")
    return devs


def timed(fn, *args, reps: int = 5):
    """(first-call seconds, median warm seconds, output); every call is
    fenced by block_until_ready."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        warm.append(time.perf_counter() - t0)
    return first, float(np.median(warm)), out


def precision_scope(prec):
    """``None``: the shipped precision. Otherwise every matmul at ``prec``,
    the solver cores' own setting included."""
    from pmpc_tpu.utils import hot_precision_scope

    stack = contextlib.ExitStack()
    if prec is not None:
        stack.enter_context(hot_precision_scope(prec))
        stack.enter_context(jax.default_matmul_precision(prec))
    return stack


def peak_bytes(dev) -> int | None:
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# -- phases ------------------------------------------------------------------------


def phase_device(count: int = 1) -> dict:
    from bench import card_name_and_power_limit

    devs = require_gpu(count)
    d = devs[0]
    log(f"[device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)} jax={jax.__version__} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[device] nvidia-smi name, power.limit: {card_name_and_power_limit()}")
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


def spd_batch(B: int, n: int, cond: float, seed: int):
    """B random SPD matrices with eigenvalues log-spaced in [1, cond], and
    right-hand sides, in float64."""
    rng = np.random.default_rng(seed)
    Qm, _ = np.linalg.qr(rng.normal(size=(B, n, n)))
    lam = np.logspace(0.0, np.log10(cond), n)
    A = np.einsum("bij,j,bkj->bik", Qm, lam, Qm)
    A = 0.5 * (A + np.swapaxes(A, -1, -2))
    b = rng.normal(size=(B, n))
    return A, b


def factor_routes():
    """The solver's route (XLA's Cholesky + triangular solves) and the
    blocked inverse Cholesky it was chosen over."""
    from pmpc_tpu.ops import block_chol, linalg

    return {
        "spd_factor": (linalg.spd_factor, linalg.spd_apply),
        "block_chol": (block_chol.inv_cholesky, block_chol.inv_chol_apply),
    }


def phase_factor(shapes=FACTOR_SHAPES, reps: int = 20) -> dict:
    """Time and check the batched SPD factor + apply routes."""
    results = {}
    for B, n in shapes:
        A64, b64 = spd_batch(B, n, cond=1e3, seed=n)
        x64 = np.linalg.solve(A64, b64[..., None])[..., 0]
        A = jnp.asarray(A64, jnp.float32)
        b = jnp.asarray(b64, jnp.float32)
        for route, (factor, apply) in factor_routes().items():
            for prec in ("high", "highest"):
                with jax.default_matmul_precision(prec):
                    fn = jax.jit(lambda A, b: apply(factor(A), b))
                    first, warm, x = timed(fn, A, b, reps=reps)
                x = np.asarray(x, np.float64)
                res = (np.linalg.norm(np.einsum("bij,bj->bi", A64, x) - b64,
                                      axis=-1) / np.linalg.norm(b64, axis=-1))
                err = (np.linalg.norm(x - x64, axis=-1)
                       / np.linalg.norm(x64, axis=-1))
                key = f"({B},{n},{n}) {route} {prec}"
                results[key] = dict(warm_ms=warm * 1e3, compile_s=first,
                                    resid_max=float(res.max()),
                                    relerr_max=float(err.max()))
                log(f"[factor] {key}: factor+apply {warm * 1e3:.4f} ms "
                    f"(first call {first:.2f} s), relative residual "
                    f"{res.max():.3e}, relative error vs numpy f64 "
                    f"{err.max():.3e}")
                if prec == "highest" and not res.max() <= FACTOR_TOL:
                    raise AssertionError(
                        f"{key}: relative residual {res.max():.3e} > "
                        f"{FACTOR_TOL:g}")
    return results


def varied_batch(data, B: int, seed: int = 1):
    """Broadcast one instance to a B-batch with varied x0 (host arrays)."""
    stack = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x)[None], (B,) + x.shape), data)
    rng = np.random.default_rng(seed)
    x0 = stack.x0 + 0.05 * rng.normal(size=stack.x0.shape).astype(
        stack.x0.dtype)
    return stack._replace(x0=x0)


def f64_on_host(solver_kw: dict, stack, n: int, M: int, N: int):
    """(U, resid) of the first ``n`` scenarios solved in float64 on the host
    CPU backend (explicit placement: the reference, not a fallback)."""
    from __graft_entry__ import _flagship

    ref_solver, _ = _flagship(M=M, N=N, **solver_kw)
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        d64 = jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a)[:n], jnp.float64), stack)
        _, U, info = jax.block_until_ready(jax.jit(jax.vmap(ref_solver))(d64))
        return np.asarray(U), np.asarray(info["resid"])


def phase_fused(B: int = FUSED_B, n_ref: int = FUSED_REF, M: int = 32,
                N: int = 30, Nc: int = 5, M_acc: int = 8,
                reps: int = 3) -> dict:
    """The flagship consensus batch under the shipped precision and under
    "high" everywhere; the shipped one must meet every bar.

    Headline budget (``bench.HEADLINE_KW``, exit at residual 1e-3): every
    scenario converges, and ``n_ref`` of them match a float64 host solve of
    the same budget on the consensus controls U[:, :, :Nc] (the ones an MPC
    applies) within 1e-3 and on the whole of U within 5e-3 — an exit at
    residual 1e-3 leaves the free tail ~1e-3 from the fixed point whatever
    the arithmetic. Accuracy budget (`ACC_KW`, M=8): the whole of U within
    1e-3 of the float64 solve."""
    import bench
    from __graft_entry__ import _flagship

    dev = jax.devices()[0]
    solver, data = _flagship(M=M, N=N, **bench.HEADLINE_KW)
    stack = varied_batch(data, B)
    acc_solver, acc_data = _flagship(M=M_acc, N=N, **ACC_KW, ipm_tol_exp=-6)
    acc_stack = varied_batch(acc_data, n_ref)
    t0 = time.perf_counter()
    U_ref, resid_ref = f64_on_host(dict(bench.HEADLINE_KW, ipm_tol_exp=-9),
                                   stack, n_ref, M, N)
    U_acc_ref, _ = f64_on_host(dict(ACC_KW, ipm_tol_exp=-9), acc_stack,
                               n_ref, M_acc, N)
    log(f"[fused] float64 host-CPU references ({n_ref} scenarios each): "
        f"{time.perf_counter() - t0:.1f} s, headline resid max "
        f"{resid_ref.max():.3e}")
    results = {}
    for name, prec in (("shipped", None), ("high", "high")):
        with precision_scope(prec):
            fn = jax.jit(jax.vmap(solver))
            first, warm, (X, U, info) = timed(
                fn, jax.device_put(stack, dev), reps=reps)
            _, U_acc, _ = jax.block_until_ready(
                jax.jit(jax.vmap(acc_solver))(jax.device_put(acc_stack, dev)))
        U = np.asarray(U, np.float64)
        resid = np.asarray(info["resid"], np.float64)
        frac = float(np.asarray(info["converged"]).mean())
        iters = np.asarray(info["iters"])
        dU = np.abs(U[:n_ref] - U_ref)
        err, err_nc = float(dU.max()), float(dU[:, :, :Nc].max())
        err_acc = float(np.abs(np.asarray(U_acc, np.float64) - U_acc_ref).max())
        ok = bool(np.isfinite(U).all() and U.shape == (B, M, N, 2)
                  and frac == 1.0 and resid.max() <= bench.RES_TOL
                  and err_nc <= ACC_TOL and err <= HEADLINE_ERR_TOL
                  and err_acc <= ACC_TOL)
        results[name] = dict(compile_s=first, warm_s=warm,
                             converged_frac=frac, resid_max=float(resid.max()),
                             iters_median=float(np.median(iters)),
                             err_vs_f64=err, err_vs_f64_consensus=err_nc,
                             err_vs_f64_acc_budget=err_acc,
                             peak_bytes=peak_bytes(dev), ok=ok)
        log(f"[fused] {name}: B={B} M={M} N={N} compile {first:.2f} s, "
            f"warm {warm:.4f} s/call, converged_frac {frac}, resid max "
            f"{resid.max():.3e}, iters median {np.median(iters)}, "
            f"|U-U_f64|_inf {err:.3e} (consensus controls {err_nc:.3e}); "
            f"accuracy budget M={M_acc} |U-U_f64|_inf {err_acc:.3e}; "
            f"peak_bytes_in_use {peak_bytes(dev)}; meets every bar: {ok}")
    if not results["shipped"]["ok"]:
        raise AssertionError(f"fused flagship under the shipped precision "
                             f"fails a bar: {results['shipped']}")
    return results


def dubins_problem(N: int = 20, xdim: int = 4, udim: int = 2):
    """The host-API recipe: Dubins car (the flagship dynamics) with box
    bounds on u, as keyword arguments of ``pmpc_tpu.solve``."""
    import pmpc_tpu
    from __graft_entry__ import _dubins

    return dict(
        f_fx_fu_fn=pmpc_tpu.make_f_fx_fu_fn(_dubins),
        Q=np.tile(np.eye(xdim), (N, 1, 1)),
        R=np.tile(1e-2 * np.eye(udim), (N, 1, 1)),
        u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
        max_it=100, res_tol=2e-4, verbose=False)


def phase_host(n_fused: int = 64, n_check: int = 4, M: int = 8,
               Nc: int = 5) -> dict:
    import pmpc_tpu

    base = dubins_problem()
    xdim = base["Q"].shape[-1]
    out = {}
    rng = np.random.default_rng(2)
    for m in (1, M):
        x0 = np.ones(xdim) if m == 1 else \
            np.ones((m, xdim)) + 0.05 * rng.normal(size=(m, xdim))
        kw = dict(base, x0=x0)
        if m > 1:  # per-particle copies of the cost and bounds
            for k in ("Q", "R", "u_l", "u_u"):
                kw[k] = np.broadcast_to(base[k], (m,) + base[k].shape)
            kw["solver_settings"] = dict(Nc=Nc)
        t0 = time.perf_counter()
        X, U, data = pmpc_tpu.solve(**kw)
        dt = time.perf_counter() - t0
        resids = [h["resid"] for h in data["hist"]]
        U = np.asarray(U)
        spread = float(np.ptp(U[:, :Nc], axis=0).max()) if m > 1 else 0.0
        log(f"[host] solve M={m}: {len(resids)} SCP iterations in {dt:.2f} s "
            f"(first call, compiles included), residuals {resids[0]:.3e} -> "
            f"{resids[-1]:.3e}, consensus spread {spread:.3e}")
        if not (np.isfinite(U).all() and resids[-1] < resids[0]
                and resids[-1] < base["res_tol"]):
            raise AssertionError(f"host solve M={m} did not converge: {resids}")
        if spread > 1e-6:
            raise AssertionError(f"consensus spread {spread:.3e} > 1e-6")
        out[f"solve_M{m}"] = dict(iters=len(resids), resid=resids[-1],
                                  spread=spread)

    problems = [dict(base, x0=np.ones(xdim) + 0.05 * rng.normal(size=xdim))
                for _ in range(n_fused)]
    t0 = time.perf_counter()
    rets = pmpc_tpu.solve_problems(problems, fused=True)
    dt = time.perf_counter() - t0
    errs = []
    for i in np.linspace(0, n_fused - 1, n_check).astype(int):
        _, Uf, df = rets[i]
        _, Us, _ = pmpc_tpu.solve(**problems[i])
        errs.append(float(np.abs(np.asarray(Uf) - np.asarray(Us)).max()))
        if not df["converged"]:
            raise AssertionError(f"fused problem {i} not converged: {df}")
    log(f"[host] solve_problems(fused=True) x{n_fused}: {dt:.2f} s "
        f"(first call, compile included); |U_fused - U_serial|_inf over "
        f"{n_check} problems: {max(errs):.3e}")
    if max(errs) > ACC_TOL:
        raise AssertionError(f"fused vs serial solve differ by {max(errs):.3e}")
    out["solve_problems_fused"] = dict(n=n_fused, err_max=max(errs))
    return out


def phase_sharded(B: int = SHARDED_B, M: int = 32, N: int = 30,
                  n_devices: int = 4, reps: int = 3) -> dict:
    """make_sharded_solver over 4x1 and 2x2 meshes vs the unsharded
    single-device vmap, condensed and Riccati methods, a fixed 8 SCP passes.

    The equality check runs in float64, which the GPU computes natively: the
    float32 flagship solve moves by ~1e-3 when its input moves by 1e-7
    relative, so any change of reduction order (another per-device batch, a
    split particle sum) moves float32 U by about as much; in float64 a
    partitioning fault still shows and rounding does not. The float32 runs
    are printed beside that measured sensitivity."""
    from __graft_entry__ import _flagship
    from pmpc_tpu.parallel import (make_mesh, make_sharded_solver,
                                   shard_batched_data)

    devs = jax.devices()[:n_devices]
    meshes = ((n_devices, 1), (n_devices // 2, 2))
    out = {}

    def compare(solver, stack, tag):
        """(unsharded U, {mesh: (err, warm_s)}) for one solver and batch."""
        _, warm_ref, (_, U_ref, _) = timed(
            jax.jit(jax.vmap(solver)), jax.device_put(stack, devs[0]),
            reps=reps)
        U_ref = np.asarray(U_ref)
        for nb, npart in meshes:
            mesh = make_mesh(n_batch=nb, n_particle=npart, devices=devs)
            fn = make_sharded_solver(solver, mesh, shard_particles=npart > 1)
            d = shard_batched_data(stack, mesh, shard_particles=npart > 1)
            first, warm, (_, U, _) = timed(fn, d, reps=reps)
            U = np.asarray(U)
            err = float(np.abs(U - U_ref).max())
            key = f"{tag} {nb}x{npart}"
            out[key] = dict(err=err, finite=bool(np.isfinite(U).all()),
                            warm_s=warm, compile_s=first,
                            unsharded_warm_s=warm_ref)
            log(f"[sharded] {key}: B={B} M={M} N={N} |U - U_unsharded|_inf "
                f"{err:.3e}, warm {warm:.4f} s/call (unsharded on one "
                f"device {warm_ref:.4f} s/call), compile {first:.2f} s")
        return U_ref

    solver, data = _flagship(M=M, N=N)
    stack = varied_batch(data, B)
    U32 = compare(solver, stack, "float32 condensed")
    rng = np.random.default_rng(0)
    nudged = stack._replace(x0=(stack.x0 * (
        1 + 1e-7 * rng.normal(size=stack.x0.shape))).astype(stack.x0.dtype))
    _, U_nudged, _ = jax.block_until_ready(
        jax.jit(jax.vmap(solver))(jax.device_put(nudged, devs[0])))
    sens = float(np.abs(np.asarray(U_nudged) - U32).max())
    out["float32 sensitivity"] = sens
    log(f"[sharded] float32 unsharded solve, x0 moved by 1e-7 relative: "
        f"|dU|_inf {sens:.3e}")

    with jax.enable_x64(True):
        for method in ("condensed", "riccati"):
            solver, data = _flagship(M=M, N=N, method=method)
            stack = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 varied_batch(data, B))
            compare(solver, stack, f"float64 {method}")
    bad = {k: v for k, v in out.items() if k.startswith("float64")
           and not (v["finite"] and v["err"] <= SHARDED_TOL)}
    if bad:
        raise AssertionError(f"sharded vs unsharded: {bad}")
    return out


def phases(four: bool) -> list:
    """The phases a run executes, in order, after the device phase."""
    if four:
        return [phase_sharded]
    return [phase_factor, phase_fused, phase_host]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the sharded path on four GPUs")
    args = parser.parse_args(argv)
    device = phase_device(count=4 if args.four else 1)
    for phase in phases(args.four):
        t0 = time.perf_counter()
        phase()
        log(f"[{phase.__name__}] done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
