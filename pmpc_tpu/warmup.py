"""Compile-cache warmup CLI (AOT-workload parity with the reference's
PackageCompiler precompile sweep, ``PMPC.jl/src/c_precompile.jl:53-144``).

The persistent XLA compilation cache (enabled on import, ``__init__.py``)
makes first compiles a one-time cost per machine; this tool pays that cost
up front for the caller's production shapes so the first REAL solve is warm:

    python -m pmpc_tpu.warmup --N 30 --M 32 --Nc 5 --max-it 8 --bounded \
        [--soc] [--batch 64]          # fused path (default)
    python -m pmpc_tpu.warmup --N 30 --bounded --host   # host-loop programs

Without arguments it runs a small option sweep over {eq, box, SOC} x
{host, fused} on toy shapes (the reference precompile workload's role).
"""

from __future__ import annotations

import time
from argparse import ArgumentParser

import numpy as np


def _dubins(x, u):
    import jax.numpy as jnp

    dt = 0.25
    px, py, v, th = x[0], x[1], x[2], x[3]
    return jnp.stack([
        px + dt * v * jnp.cos(th),
        py + dt * v * jnp.sin(th),
        v + dt * u[0],
        th + dt * u[1],
    ])


def warm_fused(N, M, Nc, max_it, bounded, soc, batch, xdim=4, udim=2):
    """Compile (and run once on tiny data) the fused solver for one shape."""
    import jax
    import jax.numpy as jnp

    from .jax_scp import build_scp_solver, make_scp_data

    f32 = np.float32
    kw = {}
    if bounded:
        kw.update(u_l=-np.ones((M, N, udim), f32),
                  u_u=np.ones((M, N, udim), f32))
    if soc:
        kw["u_soc_r"] = np.full((M, N), 0.9, f32)
    data = make_scp_data(
        np.ones((M, xdim), f32),
        np.tile(np.eye(xdim, dtype=f32), (M, N, 1, 1)),
        np.tile((1e-2 * np.eye(udim)).astype(f32), (M, N, 1, 1)),
        reg_x=1.0, reg_u=0.1, **kw)
    solver = build_scp_solver(
        _dubins, N=N, xdim=xdim, udim=udim, M=M, Nc=Nc, max_it=max_it,
        res_tol=1e-5, has_u_bounds=bounded, has_u_soc=soc, jit=False)
    if batch and batch > 1:
        fn = jax.jit(jax.vmap(solver))
        stack = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (batch,) + x.shape), data)
        X, U, info = fn(stack)
    else:
        X, U, info = jax.jit(solver)(data)
    jax.block_until_ready(U)


def warm_host(N, M, Nc, max_it, bounded, soc, xdim=4, udim=2):
    """Compile the host-path subproblem programs for one shape."""
    from .dynamics import make_f_fx_fu_fn
    from .scp import scp_solve

    f_fn = make_f_fx_fu_fn(_dubins)
    kw = {}
    if bounded:
        kw.update(u_l=-np.ones((M, N, udim)), u_u=np.ones((M, N, udim)))
    ss = dict(Nc=Nc)
    if soc:
        ss["u_soc_r"] = np.full((M, N), 0.9)
    scp_solve(f_fn,
              np.tile(np.eye(xdim), (M, N, 1, 1)),
              np.tile(1e-2 * np.eye(udim), (M, N, 1, 1)),
              np.ones((M, xdim)), max_it=max_it, res_tol=1e-5,
              verbose=False, solver_settings=ss, **kw)


def main():
    ap = ArgumentParser("pmpc_tpu.warmup",
                        description="prime the persistent compile cache")
    ap.add_argument("--N", type=int, default=None)
    ap.add_argument("--M", type=int, default=1)
    ap.add_argument("--Nc", type=int, default=0)
    ap.add_argument("--max-it", type=int, default=8)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--bounded", action="store_true")
    ap.add_argument("--soc", action="store_true")
    ap.add_argument("--host", action="store_true",
                    help="warm the host path instead of the fused one")
    args = ap.parse_args()

    t0 = time.time()
    if args.N is not None:
        if args.host and args.batch:
            ap.error("--batch applies to the fused path only (drop --host)")
        if args.host:
            warm_host(args.N, args.M, args.Nc, args.max_it,
                      args.bounded, args.soc)
        else:
            warm_fused(args.N, args.M, args.Nc, args.max_it,
                       args.bounded, args.soc, args.batch)
        print(f"warm ({time.time() - t0:.1f}s)")
        return
    # default: the precompile-workload-style sweep on toy shapes
    for bounded, soc in ((False, False), (True, False), (True, True)):
        warm_fused(6, 2, 1, 2, bounded, soc, 0)
        warm_host(6, 2, 1, 2, bounded, soc)
        print(f"  sweep bounded={bounded} soc={soc} ok "
              f"({time.time() - t0:.1f}s)")
    print("done")


if __name__ == "__main__":
    main()
