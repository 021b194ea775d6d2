"""Batched SPD factor + apply on both plain routes, against numpy float64:
the solver's `ops/linalg.spd_factor` / `spd_apply` (XLA's Cholesky +
triangular solves) and the blocked inverse Cholesky of `ops/block_chol.py`
(matmul-only applies), which `chip_smoke.py` times as the alternative."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pmpc_tpu.ops import block_chol, linalg

ROUTES = {
    "spd_factor": (linalg.spd_factor, linalg.spd_apply),
    "block_chol": (block_chol.inv_cholesky, block_chol.inv_chol_apply),
}


@pytest.fixture(params=sorted(ROUTES))
def route(request):
    return ROUTES[request.param]


def _spd(B, n, cond=1e2, seed=0):
    """B SPD matrices with eigenvalues log-spaced in [1, cond]."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(B, n, n)))
    lam = np.logspace(0.0, np.log10(cond), n)
    A = np.einsum("bij,j,bkj->bik", Q, lam, Q)
    return 0.5 * (A + np.swapaxes(A, -1, -2))


def _solver(route, jitter=0.0):
    factor, apply = route
    return lambda A, b: apply(factor(A, jitter=jitter), b)


@pytest.mark.parametrize("n", [12, 50, 90])
def test_spd_solve_matches_numpy_f64(route, n):
    """Vector and matrix right-hand sides; n=12 is under one 16-block,
    50 and 90 pad to a multiple of it on the blocked route."""
    A = _spd(4, n, seed=n)
    rng = np.random.default_rng(1)
    b = rng.normal(size=(4, n))
    Bm = rng.normal(size=(4, n, 3))
    solve = jax.jit(_solver(route))
    x = np.asarray(solve(jnp.asarray(A), jnp.asarray(b)))
    X = np.asarray(solve(jnp.asarray(A), jnp.asarray(Bm)))
    np.testing.assert_allclose(x, np.linalg.solve(A, b[..., None])[..., 0],
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(X, np.linalg.solve(A, Bm), rtol=1e-9,
                               atol=1e-11)


def test_spd_solve_float32_accuracy(route):
    """float32 at the flagship factor size, condition number 1e3: relative
    residual within 1e-4 (the bound the GPU smoke run holds "highest" to)."""
    n = 50
    A = _spd(8, n, cond=1e3, seed=3)
    b = np.random.default_rng(2).normal(size=(8, n))
    with jax.default_matmul_precision("highest"):
        x = np.asarray(jax.jit(_solver(route))(
            jnp.asarray(A, jnp.float32), jnp.asarray(b, jnp.float32)))
    res = np.linalg.norm(np.einsum("bij,bj->bi", A, x) - b, axis=-1) \
        / np.linalg.norm(b, axis=-1)
    assert res.max() <= 1e-4


def test_spd_jitter_solves_shifted_system(route):
    n, jit = 20, 0.5
    A = _spd(3, n, seed=4)
    b = np.random.default_rng(3).normal(size=(3, n))
    x = np.asarray(_solver(route, jitter=jit)(jnp.asarray(A), jnp.asarray(b)))
    ref = np.linalg.solve(A + jit * np.eye(n), b[..., None])[..., 0]
    np.testing.assert_allclose(x, ref, rtol=1e-9, atol=1e-11)


def test_spd_non_spd_gives_nan(route):
    """An indefinite block yields NaN (the IPM's breakdown guards rely on
    it); the SPD neighbour in the same batch stays exact."""
    n = 18
    A = _spd(2, n, seed=5)
    A[1] -= 200.0 * np.eye(n)  # eigenvalues now negative
    b = np.ones((2, n))
    x = np.asarray(jax.jit(_solver(route))(jnp.asarray(A), jnp.asarray(b)))
    assert np.isnan(x[1]).any()
    np.testing.assert_allclose(
        x[0], np.linalg.solve(A[0], b[0]), rtol=1e-9, atol=1e-11)


def test_spd_vmap_matches_batched_call(route):
    n = 30
    A = jnp.asarray(_spd(6, n, seed=6))
    b = jnp.asarray(np.random.default_rng(4).normal(size=(6, n)))
    solve = _solver(route)
    batched = np.asarray(jax.jit(solve)(A, b))
    mapped = np.asarray(jax.jit(jax.vmap(solve))(A, b))
    np.testing.assert_allclose(mapped, batched, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [12, 90, 160])
def test_spd_factor_is_the_cholesky_factor(n):
    """Up to n=160 (and everywhere off the CPU backend) the solver's factor
    is the lower Cholesky factor itself; past it the CPU backend hands back
    an inverse factor from the host (tests/test_linalg_host.py)."""
    A = _spd(2, n, seed=n + 1)
    F = np.asarray(linalg.spd_factor(jnp.asarray(A)))
    np.testing.assert_allclose(F, np.linalg.cholesky(A), rtol=1e-9,
                               atol=1e-11)


def test_spd_factor_diag_unbatched_A_batched_w():
    """The IPM's Newton matrix: one loop-invariant A plus a per-lane barrier
    diagonal w — the factor broadcasts A over w's leading axis."""
    n, B = 24, 5
    A = _spd(1, n, seed=7)[0]
    rng = np.random.default_rng(5)
    w = rng.uniform(0.1, 2.0, size=(B, n))
    b = rng.normal(size=(B, n))
    F = linalg.spd_factor_diag(jnp.asarray(A), jnp.asarray(w))
    assert F.shape == (B, n, n)
    x = np.asarray(linalg.spd_apply(F, jnp.asarray(b)))
    ref = np.stack([np.linalg.solve(A + np.diag(w[i]), b[i])
                    for i in range(B)])
    np.testing.assert_allclose(x, ref, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("n", [40, 200])
def test_spd_factor_diag_matches_spd_factor(n):
    """Both representations: n=200 takes the CPU host inverse factor."""
    A = _spd(3, n, seed=8)
    w = np.random.default_rng(6).uniform(0.0, 1.0, size=(3, n))
    Fd = np.asarray(linalg.spd_factor_diag(jnp.asarray(A), jnp.asarray(w),
                                           jitter=1e-3))
    F = np.asarray(linalg.spd_factor(
        jnp.asarray(A + w[:, :, None] * np.eye(n)), jitter=1e-3))
    np.testing.assert_allclose(Fd, F, rtol=1e-9, atol=1e-9)
