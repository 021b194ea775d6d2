"""Blocked batched Cholesky with explicit inverse factor — matmul-only solves.

The IPM factors a large batch of small SPD matrices once per iteration and
applies each factor several times. This module computes, in one pass,

    Minv = L^{-1}  where  A = L L',

using a right-looking BLOCKED factorization whose panel updates are batched
GEMMs; the diagonal blocks (<=16x16) use an unrolled column Cholesky and an
unrolled forward-substitution inverse (static Python loops -> fused
elementwise code). Solves then cost two batched GEMMs instead of two
triangular solves:  A^{-1} b = Minv' (Minv b).

`ops.linalg.spd_factor` does not use this factor: on an H100 XLA's batched
Cholesky + triangular solves were faster at both hot shapes (PERF.md).
`chip_smoke.py` keeps timing it as the alternative route, and
`inv_chol_apply` applies the CPU host path's inverse factors.

Numerical note: explicit triangular inverses are mildly less stable than
back-substitution, which is acceptable here — the IPM regularizes its Newton
matrices (kappa jitter) and all tests compare end-to-end solutions against
f64 oracles.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _small_chol_inv(A: jnp.ndarray):
    """Unrolled Cholesky + L^{-1} of a (..., m, m) SPD block, m small & static.

    Returns (L, Linv), both lower-triangular."""
    m = A.shape[-1]
    dtype = A.dtype
    # column (outer-product) Cholesky, unrolled over static m
    cols = []
    S = A
    for j in range(m):
        # a non-positive pivot means the matrix is not SPD: produce NaN (0/0)
        # so the callers' non-finite freeze/fallback guards catch the
        # breakdown instead of silently using a wrong factorization
        # (expressed without a literal NaN so jax_debug_nans stays usable)
        piv = S[..., j, j]
        d = jnp.sqrt(jnp.maximum(piv, 0.0)) / jnp.where(piv > 0, 1.0, 0.0)
        col = S[..., :, j] / d[..., None]  # (..., m); entries < j are garbage
        # zero the strictly-upper part of the column
        keep = jnp.arange(m) >= j
        col = jnp.where(keep, col, 0.0)
        cols.append(col)
        S = S - col[..., :, None] * col[..., None, :]
    L = jnp.stack(cols, axis=-1)  # (..., m, m) lower-triangular

    # forward substitution for Linv, unrolled: row i of Linv solves
    # L[i, :i] @ Linv[:i, :] + L[i,i] * Linv[i, :] = e_i
    rows = []
    eye = jnp.eye(m, dtype=dtype)
    for i in range(m):
        acc = eye[i]
        for k in range(i):
            acc = acc - L[..., i, k][..., None] * rows[k]
        rows.append(acc / L[..., i, i][..., None])
    Linv = jnp.stack(rows, axis=-2)
    return L, Linv


@partial(jax.jit, static_argnames=("block", "jitter"))
def inv_cholesky(A: jnp.ndarray, jitter: float = 0.0, block: int = 16) -> jnp.ndarray:
    """Minv = L^{-1} for (..., n, n) SPD A (A = L L'), batched, matmul-shaped.

    n is padded internally to a multiple of ``block``; the returned factor has
    the original size."""
    n = A.shape[-1]
    dtype = A.dtype
    if jitter:
        A = A + jitter * jnp.eye(n, dtype=dtype)
    if n == 0:
        return A
    nb = -(-n // block)
    npad = nb * block
    if npad != n:
        pad = [(0, 0)] * (A.ndim - 2) + [(0, npad - n), (0, npad - n)]
        A = jnp.pad(A, pad)
        # identity on the padded diagonal keeps the factorization well-defined
        idx = jnp.arange(n, npad)
        A = A.at[..., idx, idx].set(1.0)

    bs = block
    # L blocks and Linv diagonal blocks
    Lb = {}      # (i, j) -> (..., bs, bs) block of L, i >= j
    Dinv = {}    # j -> inv(L[j,j])
    for k in range(nb):
        Akk = A[..., k * bs:(k + 1) * bs, k * bs:(k + 1) * bs]
        for j in range(k):
            Akk = Akk - Lb[(k, j)] @ jnp.swapaxes(Lb[(k, j)], -1, -2)
        Lkk, Linv_kk = _small_chol_inv(Akk)
        Lb[(k, k)] = Lkk
        Dinv[k] = Linv_kk
        for i in range(k + 1, nb):
            Aik = A[..., i * bs:(i + 1) * bs, k * bs:(k + 1) * bs]
            for j in range(k):
                Aik = Aik - Lb[(i, j)] @ jnp.swapaxes(Lb[(k, j)], -1, -2)
            Lb[(i, k)] = Aik @ jnp.swapaxes(Linv_kk, -1, -2)

    # Minv = inv(L) blockwise: M[k,k] = Dinv[k];
    # M[i,k] = -Dinv[i] @ sum_{k<=j<i} L[i,j] M[j,k]
    Mb = {}
    for k in range(nb):
        Mb[(k, k)] = Dinv[k]
        for i in range(k + 1, nb):
            acc = None
            for j in range(k, i):
                t = Lb[(i, j)] @ Mb[(j, k)]
                acc = t if acc is None else acc + t
            Mb[(i, k)] = -(Dinv[i] @ acc)

    # assemble
    rows = []
    zero = jnp.zeros(A.shape[:-2] + (bs, bs), dtype)
    for i in range(nb):
        row = [Mb[(i, j)] if j <= i else zero for j in range(nb)]
        rows.append(jnp.concatenate(row, axis=-1))
    Minv = jnp.concatenate(rows, axis=-2)
    return Minv[..., :n, :n]


def inv_chol_apply(Minv: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """A^{-1} b = Minv' (Minv b); b (..., n) or (..., n, k)."""
    vector = b.ndim == Minv.ndim - 1
    if vector:
        b = b[..., None]
    y = Minv @ b
    x = jnp.swapaxes(Minv, -1, -2) @ y
    return x[..., 0] if vector else x
