"""Long-horizon bench entry.

One JSON line per N in {140, 280}: the fused riccati solver's warm
per-SCP-iteration latency (state boxes + slew, M=1, f32) and the
warm-cache startup cost.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    import pmpc_tpu  # noqa: F401
    from pmpc_tpu.jax_scp import build_scp_solver, make_scp_data
    from __graft_entry__ import _dubins

    xdim, udim, M = 4, 2, 1
    f32 = np.float32
    for N in (140, 280):
        mk = lambda max_it: build_scp_solver(
            _dubins, N=N, xdim=xdim, udim=udim, M=M, Nc=0,
            max_it=max_it, res_tol=1e-9, has_u_bounds=True,
            has_x_bounds=True, has_slew=True, method="riccati", ipm_iters=8)
        data = make_scp_data(
            np.ones((M, xdim), f32),
            np.tile(np.eye(xdim, dtype=f32), (M, N, 1, 1)),
            np.tile((1e-2 * np.eye(udim)).astype(f32), (M, N, 1, 1)),
            reg_x=1.0, reg_u=0.1, slew_reg=0.1,
            u_l=-np.ones((M, N, udim), f32), u_u=np.ones((M, N, udim), f32),
            x_l=-np.full((M, N, xdim), 6.0, f32),
            x_u=np.full((M, N, xdim), 6.0, f32))
        out = {}
        for max_it in (4, 12):
            solver = mk(max_it)
            t0 = time.time()
            X, U, info = jax.block_until_ready(solver(data))
            out[f"startup{max_it}_s"] = round(time.time() - t0, 1)
            t0 = time.time()
            for _ in range(3):
                X, U, info = jax.block_until_ready(solver(data))
            out[f"warm{max_it}_s"] = (time.time() - t0) / 3
        ms_it = (out["warm12_s"] - out["warm4_s"]) / 8 * 1e3
        print(json.dumps(dict(
            metric=f"long_horizon_fused_N{N}",
            ms_per_scp_iteration=round(ms_it, 1),
            warm12_s=round(out["warm12_s"], 3),
            startup_warmcache_s=out["startup4_s"],
            target_ms=100.0, met=bool(ms_it <= 100.0))), flush=True)


if __name__ == "__main__":
    main()
