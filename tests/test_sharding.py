"""Multi-device sharding: batch x particle mesh on the 8-device virtual CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pmpc_tpu.jax_scp import build_scp_solver, make_scp_data
from pmpc_tpu.parallel import make_mesh, make_sharded_solver, shard_batched_data
from fixtures import unicycle_step


@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")


def _batch_data(B, M, N, xdim, udim, seed=0, bounds=False):
    rng = np.random.default_rng(seed)
    Q = np.tile(np.eye(xdim), (B, M, N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (B, M, N, 1, 1))
    x0 = rng.normal(size=(B, M, xdim))
    datas = [
        make_scp_data(
            x0[b], Q[b], R[b], reg_x=1.0, reg_u=0.1,
            **(dict(u_l=-np.ones((M, N, udim)), u_u=np.ones((M, N, udim)))
               if bounds else {}),
        )
        for b in range(B)
    ]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *datas), datas


@pytest.mark.parametrize("shard_particles", [False, True])
def test_sharded_solve_matches_single_device(shard_particles):
    B, M, N, xdim, udim = 8, 4, 10, 4, 2
    mesh = make_mesh(n_batch=4 if shard_particles else 8,
                     n_particle=2 if shard_particles else 1)
    solver = build_scp_solver(unicycle_step, N, xdim, udim, M, Nc=3,
                              max_it=10, res_tol=1e-6, jit=False)
    stacked, datas = _batch_data(B, M, N, xdim, udim)
    sharded = shard_batched_data(stacked, mesh, shard_particles=shard_particles)
    fn = make_sharded_solver(solver, mesh, shard_particles=shard_particles)
    Xb, Ub, info = fn(sharded)
    assert Xb.shape == (B, M, N + 1, xdim)

    one = jax.jit(solver)
    for b in [0, B - 1]:
        X1, U1, _ = one(datas[b])
        np.testing.assert_allclose(np.asarray(Ub[b]), np.asarray(U1), atol=1e-5)
    # consensus controls identical across particles even when M is sharded
    assert np.ptp(np.asarray(Ub)[:, :, :3, :], axis=1).max() < 1e-10


def test_sharded_bounded_ipm():
    """The IPM's global reductions must partition correctly over the mesh."""
    B, M, N, xdim, udim = 4, 4, 8, 4, 2
    mesh = make_mesh(n_batch=4, n_particle=2)
    solver = build_scp_solver(unicycle_step, N, xdim, udim, M, Nc=2,
                              max_it=6, res_tol=1e-6, has_u_bounds=True,
                              jit=False)
    stacked, datas = _batch_data(B, M, N, xdim, udim, bounds=True)
    sharded = shard_batched_data(stacked, mesh, shard_particles=True)
    fn = make_sharded_solver(solver, mesh, shard_particles=True)
    Xb, Ub, info = fn(sharded)
    one = jax.jit(solver)
    X1, U1, _ = one(datas[0])
    np.testing.assert_allclose(np.asarray(Ub[0]), np.asarray(U1), atol=1e-5)
    assert np.asarray(Ub).max() <= 1.0 + 1e-6


def test_sharded_soc_ipm():
    """Per-stage SOC cones under the batch x particle mesh."""
    B, M, N, xdim, udim = 4, 4, 8, 4, 2
    mesh = make_mesh(n_batch=4, n_particle=2)
    solver = build_scp_solver(unicycle_step, N, xdim, udim, M, Nc=2,
                              max_it=6, res_tol=1e-6, has_u_bounds=True,
                              has_u_soc=True, jit=False)
    rng = np.random.default_rng(3)
    datas = [
        make_scp_data(
            rng.normal(size=(M, xdim)),
            np.tile(np.eye(xdim), (M, N, 1, 1)),
            np.tile(1e-2 * np.eye(udim), (M, N, 1, 1)),
            reg_x=1.0, reg_u=0.1,
            u_l=-np.ones((M, N, udim)), u_u=np.ones((M, N, udim)),
            u_soc_r=np.full((M, N), 0.9),
        )
        for _ in range(B)
    ]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)
    sharded = shard_batched_data(stacked, mesh, shard_particles=True)
    fn = make_sharded_solver(solver, mesh, shard_particles=True)
    Xb, Ub, info = fn(sharded)
    one = jax.jit(solver)
    X1, U1, _ = one(datas[0])
    np.testing.assert_allclose(np.asarray(Ub[0]), np.asarray(U1), atol=1e-5)
    norms = np.linalg.norm(np.asarray(Ub), axis=-1)
    assert norms.max() <= 0.9 + 1e-4


def test_sharded_riccati_method():
    """The O(N) stage-structured path under the mesh matches single-device."""
    B, M, N, xdim, udim = 4, 4, 8, 4, 2
    mesh = make_mesh(n_batch=4, n_particle=2)
    solver = build_scp_solver(unicycle_step, N, xdim, udim, M, Nc=2,
                              max_it=6, res_tol=1e-6, has_u_bounds=True,
                              method="riccati", jit=False)
    stacked, datas = _batch_data(B, M, N, xdim, udim, bounds=True)
    sharded = shard_batched_data(stacked, mesh, shard_particles=True)
    fn = make_sharded_solver(solver, mesh, shard_particles=True)
    Xb, Ub, info = fn(sharded)
    one = jax.jit(solver)
    X1, U1, _ = one(datas[0])
    np.testing.assert_allclose(np.asarray(Ub[0]), np.asarray(U1), atol=1e-5)
