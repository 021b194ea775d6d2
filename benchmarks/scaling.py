"""Weak-scaling harness: solves/s as devices are added (BASELINE config 5).

On a multi-GPU host this measures scaling over NVLink directly; on a CPU
host it can run with virtual devices for wiring validation (no timing from
such a run is a device number):

    JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 python benchmarks/scaling.py

Prints one JSON line per device count with per-device throughput and the
weak-scaling efficiency vs 1 device.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    import pmpc_tpu  # noqa: F401
    from pmpc_tpu.jax_scp import build_scp_solver, make_scp_data
    from pmpc_tpu.parallel import make_mesh, make_sharded_solver, shard_batched_data
    from __graft_entry__ import _dubins

    devices = jax.devices()
    n_dev = len(devices)
    M, N, xdim, udim, Nc = int(os.environ.get("PMPC_SCALE_M", "16")), 30, 4, 2, 5
    B_per_dev = int(os.environ.get("PMPC_SCALE_B", "32"))
    max_it = 8
    reps = 3

    rng = np.random.default_rng(0)

    def run(nd):
        mesh = make_mesh(n_batch=nd, n_particle=1, devices=devices[:nd])
        B = B_per_dev * nd
        solver = build_scp_solver(_dubins, N=N, xdim=xdim, udim=udim, M=M, Nc=Nc,
                                  max_it=max_it, res_tol=1e-5, has_u_bounds=True,
                                  ipm_iters=15, jit=False)
        datas = [
            make_scp_data(
                (np.ones((M, xdim)) + 0.05 * rng.normal(size=(M, xdim))).astype(np.float32),
                np.tile(np.eye(xdim, dtype=np.float32), (M, N, 1, 1)),
                np.tile((1e-2 * np.eye(udim)).astype(np.float32), (M, N, 1, 1)),
                reg_x=1.0, reg_u=0.1,
                u_l=-np.ones((M, N, udim), np.float32),
                u_u=np.ones((M, N, udim), np.float32),
            )
            for _ in range(B)
        ]
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)
        sharded = shard_batched_data(stacked, mesh, shard_particles=False)
        fn = make_sharded_solver(solver, mesh, shard_particles=False)
        X, U, info = fn(sharded)
        jax.block_until_ready(U)
        t0 = time.perf_counter()
        for _ in range(reps):
            X, U, info = fn(sharded)
        jax.block_until_ready(U)
        dt = time.perf_counter() - t0
        return B * reps / dt

    base = None
    counts = [c for c in [1, 2, 4, 8] if c <= n_dev]
    for nd in counts:
        sps = run(nd)
        if base is None:
            base = sps
        eff = sps / (base * nd)
        print(json.dumps({
            "devices": nd,
            "solves_per_s": round(sps, 2),
            "per_device": round(sps / nd, 2),
            "weak_scaling_efficiency": round(eff, 4),
        }), flush=True)

    # On virtual (CPU) devices the per-device efficiency above is dominated by
    # core contention, not communication. The meaningful virtual-mesh metric is
    # the SHARDING OVERHEAD at equal total work: the same global batch run (a)
    # sharded over all devices vs (b) as one unsharded vmap on one device.
    if n_dev > 1 and devices[0].platform == "cpu":
        B = B_per_dev * n_dev
        solver = build_scp_solver(_dubins, N=N, xdim=xdim, udim=udim, M=M, Nc=Nc,
                                  max_it=max_it, res_tol=1e-5, has_u_bounds=True,
                                  ipm_iters=15, jit=False)
        datas = [
            make_scp_data(
                (np.ones((M, xdim)) + 0.05 * rng.normal(size=(M, xdim))).astype(np.float32),
                np.tile(np.eye(xdim, dtype=np.float32), (M, N, 1, 1)),
                np.tile((1e-2 * np.eye(udim)).astype(np.float32), (M, N, 1, 1)),
                reg_x=1.0, reg_u=0.1,
                u_l=-np.ones((M, N, udim), np.float32),
                u_u=np.ones((M, N, udim), np.float32),
            )
            for _ in range(B)
        ]
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)

        plain = jax.jit(jax.vmap(solver))
        X, U, _ = plain(stacked)
        jax.block_until_ready(U)
        t0 = time.perf_counter()
        for _ in range(reps):
            X, U, _ = plain(stacked)
        jax.block_until_ready(U)
        t_plain = (time.perf_counter() - t0) / reps

        mesh = make_mesh(n_batch=n_dev, n_particle=1, devices=devices)
        sharded = shard_batched_data(stacked, mesh, shard_particles=False)
        fn = make_sharded_solver(solver, mesh, shard_particles=False)
        X, U, _ = fn(sharded)
        jax.block_until_ready(U)
        t0 = time.perf_counter()
        for _ in range(reps):
            X, U, _ = fn(sharded)
        jax.block_until_ready(U)
        t_shard = (time.perf_counter() - t0) / reps
        print(json.dumps({
            "equal_work_B": B,
            "t_unsharded_vmap_s": round(t_plain, 4),
            "t_sharded_mesh_s": round(t_shard, 4),
            "sharding_overhead": round(t_shard / t_plain - 1.0, 4),
        }), flush=True)


if __name__ == "__main__":
    main()
