"""Batched dense linear algebra primitives for the solver core.

The solver's systems are small dense SPD blocks batched over particles x
scenarios, factored once per IPM iteration and applied several times. The
reference reaches for sparse CPU factorizations
(``PMPC.jl/src/cone_utils.jl:36-42`` SuiteSparse Cholesky); here the
per-stage blocks are tiny, so one batched dense factor per block is the
layout: XLA's batched Cholesky and triangular solves (cuSOLVER and cuBLAS on
an NVIDIA GPU). On an H100 (700 W) that route beat the blocked inverse
Cholesky of `block_chol` at both hot shapes, factor + apply 0.47 vs 0.79 ms
at (2048, 50, 50) and 1.50 vs 2.16 ms at (4096, 90, 90) f32 (PERF.md);
`block_chol` stays as the measured alternative and as the inverse-factor
apply of the CPU host path below.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .block_chol import inv_chol_apply


def _use_host_inverse_factor(n: int) -> bool:
    """Static rule: on the CPU backend, large factorizations go to the host
    BLAS via pure_callback. jaxlib's ``lapack_potrf_ffi`` on this class of
    machine runs UNBLOCKED reference code (~0.1 GFLOP/s: 370 ms for a 490^2
    f64 factor that numpy/OpenBLAS does in 9 ms), and the XLA-traced blocked
    factor pays 40-150 s of compile time at this size. The callback returns
    the INVERSE factor so applies stay XLA matmuls (same representation as
    `inv_cholesky`)."""
    if os.environ.get("PMPC_TPU_HOST_CHOL", "1") != "1":
        return False
    try:
        # jax.default_backend() IGNORES an active jax.default_device scope
        # (it names the accelerator inside default_device(cpu)) — the cone
        # paths pin CPU exactly that way, so consult the scoped device first
        dev = jax.config.jax_default_device
        if dev is not None:
            on_cpu = getattr(dev, "platform", None) == "cpu"
        else:
            on_cpu = jax.default_backend() == "cpu"
    except Exception:
        # unknown backend: STAY on the device path — wrongly guessing "cpu"
        # would route jitted accelerator factorizations through a host
        # callback
        on_cpu = False
    return on_cpu and n > 160


_BLAS_LIMIT = None


def _blas_single_thread():
    """Scoped single-thread BLAS for host callbacks: multithreaded OpenBLAS
    spinning against XLA's own busy-waiting threadpool is a 10x slowdown
    (measured 82 ms vs 8 ms for a 490^2 f64 factor inside pure_callback)."""
    global _BLAS_LIMIT
    try:
        if _BLAS_LIMIT is None:
            from threadpoolctl import ThreadpoolController

            _BLAS_LIMIT = ThreadpoolController()
        return _BLAS_LIMIT.limit(limits=1, user_api="blas")
    except Exception:
        import contextlib

        return contextlib.nullcontext()


def _host_inv_chol_np(A_u8, jitter: float, dtype: str):
    """Host kernel: Minv = L^{-1} per batch element; NaN on a non-SPD block
    (keeps the callers' breakdown-detection contract).

    Operates on uint8 BITCASTS (trailing itemsize axis): ``jax.enable_x64``
    is thread-local, and pure_callback buffers are canonicalized on an XLA
    runtime thread that sees the global (x64-off) config — float64 operands
    would be silently downcast. Bytes pass through untouched."""
    import scipy.linalg as sla

    dt = np.dtype(dtype)
    A = np.ascontiguousarray(A_u8).view(dt)[..., 0]
    n = A.shape[-1]
    if jitter:
        A = A + np.asarray(jitter, dt) * np.eye(n, dtype=dt)
    flat = A.reshape((-1, n, n))
    out = np.empty_like(flat)
    eye = np.eye(n, dtype=dt)
    with _blas_single_thread():
        for i in range(flat.shape[0]):
            try:
                L = np.linalg.cholesky(flat[i])
                out[i] = sla.solve_triangular(L, eye, lower=True,
                                              check_finite=False)
            except np.linalg.LinAlgError:
                out[i] = np.nan
    # return an OWNING contiguous uint8 array, not a view: the callback
    # bridge may capture the buffer pointer without holding the view's base
    return np.ascontiguousarray(out.reshape(A.shape))[..., None] \
        .view(np.uint8).copy()


def spd_factor(A: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """Factor a (batched) SPD matrix for `spd_apply`: the Cholesky factor, or
    on the CPU backend past n=160 the inverse Cholesky factor. The
    representation is a static function of size and backend, so
    factor/apply pairs always agree."""
    n = A.shape[-1]
    if _use_host_inverse_factor(n):
        A_u8 = lax.bitcast_convert_type(A, jnp.uint8)
        out_u8 = jax.pure_callback(
            partial(_host_inv_chol_np, jitter=float(jitter),
                    dtype=str(A.dtype)),
            jax.ShapeDtypeStruct(A_u8.shape, jnp.uint8), A_u8,
            vmap_method="expand_dims")
        return lax.bitcast_convert_type(out_u8, A.dtype)
    return cholesky_factor(A, jitter=jitter)


def spd_factor_diag(A: jnp.ndarray, w: jnp.ndarray,
                    jitter: float = 0.0) -> jnp.ndarray:
    """Factor (A + diag(w)) for `spd_apply` (the IPM's Newton matrix: a
    loop-invariant A plus the iteration's barrier diagonal)."""
    n = A.shape[-1]
    K = A + w[..., :, None] * jnp.eye(n, dtype=A.dtype)
    return spd_factor(K, jitter=jitter)


def spd_apply(F: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b given F = spd_factor(A)."""
    n = F.shape[-1]
    if _use_host_inverse_factor(n):
        return inv_chol_apply(F, b)
    return cholesky_solve(F, b)


def cholesky_factor(A: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """Cholesky factor of a (batched) SPD matrix, with optional diagonal jitter."""
    if jitter:
        n = A.shape[-1]
        A = A + jitter * jnp.eye(n, dtype=A.dtype)
    return jnp.linalg.cholesky(A)


def cholesky_solve(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve ``A x = b`` given the (batched) Cholesky factor ``L`` of ``A``.

    ``b`` may be a vector (..., n) or matrix (..., n, k)."""
    vector = b.ndim == L.ndim - 1
    if vector:
        b = b[..., None]
    y = lax.linalg.triangular_solve(L, b, left_side=True, lower=True)
    x = lax.linalg.triangular_solve(L, y, left_side=True, lower=True, transpose_a=True)
    return x[..., 0] if vector else x


def psd_solve(A: jnp.ndarray, b: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """Solve a (batched) SPD system via Cholesky."""
    return cholesky_solve(cholesky_factor(A, jitter=jitter), b)
