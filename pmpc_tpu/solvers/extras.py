"""User extra cone constraints: canonicalization + host fallback pieces.

Implements the reference's ``extra_cstrs`` interface (``README.md:219-229``,
``PMPC.jl/src/cone_utils.jl:99-170`` ``augment_cone_problem!``): each
constraint is a tuple

    (l, q, e, G_left, G_right, h, c_left, c_right)

with ``G_left`` over the canonical consensus variable
``z_full = [u_cons; u_free_1..M; x_1..M]`` (layout ``lqp_utils.jl:2-216``),
``G_right`` over fresh auxiliary variables appended to the decision vector,
``l`` leading nonneg rows, ``q`` a list of SOC sizes, ``e`` a COUNT of 3-dim
exponential cones (triples of rows after the lin/SOC sections).

The actual program assembly and solve live in `solvers.compose`
(`build_cone_program` / `composed_cone_solve`), which splices extras into the
same dense device-native cone program as box bounds, smoothing, control-norm
cones and the CVaR epigraph — mirroring how the reference composes them all
in one conic program (``main.jl:204-317``). This module keeps the host-side
pieces: user-tuple validation, the cross-particle terminal cost
(``Hf``/``hf``), and the scipy fallback for exp-cone programs.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from .compose import x_map
from .reduced import CondensedQP


def terminal_cross_cost(cqp: CondensedQP, N: int, xdim: int, Hf, hf=None):
    """Dense (H, q) updates from a cross-particle terminal cost
    0.5 xN' Hf xN + hf' xN over the stacked final states xN (M*xdim,)
    — parity with the Hf/hf settings of ``lqp_utils.jl:105-163,192-204``."""
    M, nc, nf = cqp.M, cqp.nc, cqp.nf
    nz = nc + M * nf
    dtype = cqp.qf.dtype
    Xmap, xoff = x_map(cqp)
    # rows selecting each particle's final state, without a host selector
    S = Xmap.reshape(M, N, xdim, nz)[:, N - 1].reshape(M * xdim, nz)
    s0 = xoff.reshape(M, N, xdim)[:, N - 1].reshape(M * xdim)
    Hf = jnp.asarray(Hf, dtype=dtype)
    hf = jnp.zeros(M * xdim, dtype) if hf is None \
        else jnp.asarray(hf, dtype=dtype).reshape(-1)
    H_extra = S.T @ Hf @ S
    q_extra = S.T @ (Hf @ s0 + hf)
    return H_extra, q_extra


def _canon_extras(extra_cstrs, n_full) -> Tuple[Tuple, Tuple]:
    """Canonicalize user tuples once on the host: numpy shapes cleaned up,
    split into a STATIC signature (cache key of the jitted assembly) and the
    dynamic arrays."""
    sig, arrays = [], []
    for ec in (extra_cstrs or []):
        l, qsizes, e, G_left, G_right, h, c_left, c_right = tuple(ec)
        G_left = np.asarray(G_left, dtype=float)
        if G_left.ndim == 1:
            G_left = G_left[None, :]
        assert G_left.shape[1] == n_full, (
            f"extra constraint G_left has {G_left.shape[1]} cols, expected "
            f"{n_full} (consensus layout [u_cons; u_free_1..M; x_1..M])")
        h = np.asarray(h, dtype=float).reshape(-1)
        G_right = np.asarray(G_right, dtype=float)
        if G_right.ndim != 2:
            G_right = G_right[:, None] if G_right.size else \
                G_right.reshape(len(h), 0)
        c_left = np.asarray(c_left, dtype=float).reshape(-1)
        c_right = np.asarray(c_right, dtype=float).reshape(-1)
        qsizes = tuple(int(s) for s in np.asarray(qsizes).reshape(-1))
        n_rows = int(l) + sum(qsizes) + 3 * int(e)
        # under-declared rows would be silently truncated by the slicing
        # below (and over-declared ones silently ignored) — the solver would
        # "converge" on the wrong constraint geometry
        if G_left.shape[0] != n_rows or h.shape[0] != n_rows \
                or G_right.shape[0] != n_rows:
            raise ValueError(
                f"extra constraint declares l={int(l)}, q={qsizes}, "
                f"e={int(e)} -> {n_rows} rows, but G_left has "
                f"{G_left.shape[0]}, G_right {G_right.shape[0]}, "
                f"h {h.shape[0]}")
        if c_right.size != G_right.shape[1]:
            raise ValueError(
                f"extra constraint c_right has {c_right.size} entries for "
                f"{G_right.shape[1]} auxiliary variables")
        sig.append((int(l), qsizes, int(e), int(G_right.shape[1])))
        arrays.append((G_left, G_right, h, c_left, c_right))
    return tuple(sig), tuple(arrays)


def _solve_exp_host(H, q, Gl, hl, soc_blocks, exp_blocks):
    """Host (scipy trust-constr) solve of the dense cone QP with exp cones.

    Exp cone (ECOS convention, ``cone_utils.jl:184-188``): the slack triple
    s = h - Gv lies in closure{(x, y, z): exp(x/z) <= y/z, z > 0}, i.e.
    z log(y/z) >= x with y, z > 0 — a concave constraint function, so the
    program stays convex."""
    import scipy.optimize as sopt

    nv = q.shape[0]
    H, q = np.asarray(H, float), np.asarray(q, float)
    cons = []
    Gl, hl = np.asarray(Gl, float), np.asarray(hl, float)
    if Gl.shape[0]:
        cons.append(sopt.LinearConstraint(Gl, -np.inf, hl))
    for qsizes, Gc, hc in soc_blocks:
        Gc, hc = np.asarray(Gc, float), np.asarray(hc, float)
        r = 0
        for sz in qsizes:
            G, h = Gc[r:r + sz], hc[r:r + sz]
            r += sz

            def soc_fun(v, G=G, h=h):
                s = h - G @ v
                return s[0] - np.linalg.norm(s[1:])

            cons.append(sopt.NonlinearConstraint(soc_fun, 0.0, np.inf))
    eps = 1e-12
    for G, h in exp_blocks:
        G, h = np.asarray(G, float), np.asarray(h, float)
        # domain: y, z > 0 (linear rows), cone: z log(y/z) - x >= 0
        cons.append(sopt.LinearConstraint(-G[1:], eps - h[1:], np.inf))

        def exp_fun(v, G=G, h=h):
            s = h - G @ v
            y, z = max(s[1], eps), max(s[2], eps)
            return z * np.log(y / z) - s[0]

        cons.append(sopt.NonlinearConstraint(exp_fun, 0.0, np.inf))
    res = sopt.minimize(
        lambda v: 0.5 * v @ H @ v + q @ v, np.zeros(nv),
        jac=lambda v: H @ v + q,
        constraints=cons, method="trust-constr",
        options=dict(maxiter=5000, gtol=1e-10, xtol=1e-12))
    # status 1 (gtol) / 2 (xtol) are converged; 0 (maxiter) / 3 are not
    return res.x, res.status in (1, 2) and np.isfinite(res.x).all()


def split_stage_u_cones(sig, arrays, M, N, Nc, udim):
    """Recognize extras SOC blocks as per-stage control-norm cones.

    A user writing thrust cones through the ``extra_cstrs`` interface
    produces, per (particle, stage), the block ``s = h - Gv in SOC`` with
    ``h = [r; 0..]`` and ``G`` rows 1..udim carrying ``c*I`` on one stage's
    contiguous control slice (``||c u_ij|| <= r``). Those are exactly the
    ``u_soc_r`` cones the structured arrow IPM (`ipm.SocSpec`) and the
    riccati IPM solve natively — far cheaper than densifying the whole
    program through the composed cone path (245 such cones make an nv=490
    dense program there). Runs on the host EVERY SCP
    iteration (extras may come from per-iteration callbacks), so the block
    checks are vectorized over all cones of a tuple at once.

    Returns ``(r_arr (M, N) with +inf where no cone, lin_G (l, n_full),
    lin_h (l,))`` when EVERY SOC block across the tuples matches the pattern
    and nothing else is conic (no exp rows, no aux variables, no cost
    terms); ``None`` otherwise (caller keeps the composed path). Consensus
    -stage cones (slice inside ``u_cons``) apply to the shared control: the
    radius is recorded for every particle row (the cone layout takes
    particle 0, ``lqp_utils.jl:323-331`` convention).
    """
    nc, nf = Nc * udim, (N - Nc) * udim
    r_arr = np.full((M, N), np.inf)
    lin_G, lin_h = [], []
    any_cone = False
    n_cols = None
    for (l, qsizes, e, na), (G_l, G_r, h, c_l, c_r) in zip(sig, arrays):
        if e or na:
            return None
        if np.any(np.asarray(c_l) != 0.0):
            return None
        if np.asarray(c_r).size and np.any(np.asarray(c_r) != 0.0):
            return None
        G_l = np.asarray(G_l, float)
        h = np.asarray(h, float)
        n_cols = G_l.shape[1]
        if l:
            lin_G.append(G_l[:l])
            lin_h.append(h[:l])
        if not qsizes:
            continue
        p = udim + 1
        if any(s != p for s in qsizes):
            return None
        c = len(qsizes)
        Gq = G_l[l:l + c * p].reshape(c, p, n_cols)
        hq = h[l:l + c * p].reshape(c, p)
        if np.any(Gq[:, 0, :] != 0.0) or np.any(hq[:, 1:] != 0.0):
            return None
        body = Gq[:, 1:, :]  # (c, udim, n_cols)
        nzmask = body != 0.0
        if not np.all(nzmask.sum(axis=2) == 1):
            return None
        cols = nzmask.argmax(axis=2)  # (c, udim)
        starts = cols[:, 0]
        if not np.array_equal(cols, starts[:, None] + np.arange(udim)):
            return None
        vals = np.take_along_axis(body, cols[..., None], axis=2)[..., 0]
        c0 = vals[:, 0]
        if np.any(c0 == 0.0) or not np.allclose(vals, c0[:, None]):
            return None
        r = hq[:, 0] / np.abs(c0)
        if not np.all(np.isfinite(r) & (r > 0)):
            return None
        cons = starts < nc
        if np.any(starts[cons] % udim):
            return None
        s2 = starts[~cons] - nc
        if np.any(s2 >= M * nf) or np.any((s2 % nf) % udim):
            return None
        for st, rr in zip(starts[cons], r[cons]):
            j = int(st // udim)
            r_arr[:, j] = np.minimum(r_arr[:, j], rr)
        i_f, rem = np.divmod(s2, nf)
        j_f = Nc + rem // udim
        for ii, jj, rr in zip(i_f, j_f, r[~cons]):
            r_arr[ii, jj] = min(r_arr[ii, jj], rr)
        any_cone = True
    if not any_cone:
        return None
    lg = np.concatenate(lin_G, axis=0) if lin_G \
        else np.zeros((0, n_cols))
    lh = np.concatenate(lin_h) if lin_h else np.zeros((0,))
    return r_arr, lg, lh
