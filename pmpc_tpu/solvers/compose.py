"""Unified dense cone-program composer for the condensed consensus problem.

The reference's cone path composes every constraint flavor into ONE conic
program (``PMPC.jl/src/main.jl:204-317``): the k-worst (CVaR) epigraph
objective, box bounds (optionally *smoothed* into exp cones for
``logbarrier`` / 3-dim SOCs for ``squareplus``, ``cone_utils.jl:204-232``),
user ``extra_cstrs`` splices (``cone_utils.jl:99-170``) whose leading linear
rows are themselves logbarrier-smoothed when smoothing is on
(``main.jl:292-316``), and per-stage control-norm cones. This module is the
on-device equivalent: it assembles the same composed program DENSELY over
the condensed variable (states eliminated through ``x = Xmap z + xoff``)
with batched jnp block/broadcast ops inside one jitted function per static
signature, then solves it with

- the NT-scaled symmetric-cone IPM (`coneipm.cone_qp_solve`) when the
  program has only nonneg + SOC cones, or
- the device central-path barrier method (`expbarrier.exp_barrier_solve`)
  when exponential cones are present (logbarrier smoothing, user ``e`` rows),
  with a scipy host solve as the last-resort fallback.

Variable layout of the composed program:

    v = [ z (nz = nc + M*nf) ;        condensed consensus controls
          y_1..y_M, t (cvar only) ;   k-worst epigraph variables
          aux (extras' G_right) ;     user auxiliary variables
          t_1..t_s (smoothing) ]      one epigraph var per smoothed row

Smoothing semantics (parity with ``smoothen_linear_inequlities``,
``cone_utils.jl:204-232``): a row ``g'v <= h`` becomes, with fresh aux ``t``
of objective cost 1,

- logbarrier:  exp-cone triple  t >= -(1/alpha) log(alpha (h - g'v)),
- squareplus:  SOC triple       t >= (beta/2) (r + sqrt(r^2 + alpha^-2)),
               r = g'v - h.

Like the reference, ``squareplus`` smooths only the box rows while
``logbarrier`` also smooths the extras' leading linear rows
(``main.jl:301-316`` smooths extras only in the logbarrier branch).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .coneipm import ConeLP, cone_qp_solve
from .reduced import CondensedQP

COST_ANCHOR_EPS = 1e-3  # main.jl:221 anchor to pin the y/t degree of freedom
BIG_BOUND = 1e8  # stand-in for +-inf entries of smoothed one-sided bounds


# -- shared condensed-layout helpers ------------------------------------------------


def dense_H_q(cqp: CondensedQP) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Densify the arrow-structured Hessian/linear term over z = [uc; uf_1..M]
    (jnp, trace-compatible: broadcast-mask block placement, no host loops)."""
    M, nc, nf = cqp.M, cqp.nc, cqp.nf
    Hcc, Hcf, Hff = cqp.Hcc, cqp.Hcf, cqp.Hff
    eyeM = jnp.eye(M, dtype=Hff.dtype)
    Hff_bd = (eyeM[:, None, :, None] * Hff[:, :, None, :]).reshape(M * nf, M * nf)
    top = jnp.transpose(Hcf, (1, 0, 2)).reshape(nc, M * nf)
    H = jnp.concatenate([
        jnp.concatenate([Hcc, top], axis=1),
        jnp.concatenate([top.T, Hff_bd], axis=1),
    ], axis=0)
    q = jnp.concatenate([cqp.qc, cqp.qf.reshape(-1)])
    return H, q


def x_map(cqp: CondensedQP) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dense map from z to the stacked states x_all = Xmap z + xoff (jnp)."""
    M, nc, nf = cqp.M, cqp.nc, cqp.nf
    NX = cqp.g.shape[-1]
    Ft = cqp.Ft
    eyeM = jnp.eye(M, dtype=Ft.dtype)
    left = Ft[:, :, :nc].reshape(M * NX, nc)
    right = (eyeM[:, None, :, None] * Ft[:, :, None, nc:]).reshape(M * NX, M * nf)
    return jnp.concatenate([left, right], axis=1), cqp.g.reshape(-1)


def full_layout_sizes(M, nc, nf, NX):
    """(nu_total, n_full) of the canonical full layout [u_cons; u_free; x]."""
    nu_total = nc + M * nf
    return nu_total, nu_total + M * NX


def recover_XU(w, Xmap, xoff, M, nc, nf, N, udim, xdim):
    """Stitch (M, N, udim) controls + roll states through the condensed map."""
    U = jnp.concatenate([
        jnp.broadcast_to(w[:nc], (M, nc)),
        w[nc:nc + M * nf].reshape(M, nf)], axis=1).reshape(M, N, udim)
    X = (Xmap @ w + xoff).reshape(M, N, xdim)
    return X, U


def pad_socs(soc_blocks, nv, dtype):
    """Stack SOC cones into padded (ncones, pmax, nv) arrays with ONE static
    gather. ``soc_blocks`` is [(qsizes, G_rows, h_rows), ...] per source;
    all cone sizes are static, so the padded row-index table is plain numpy
    (padding indexes a sentinel zero row)."""
    sizes = [int(s) for (qsizes, _, _) in soc_blocks for s in qsizes]
    ncones = len(sizes)
    if not ncones:
        return jnp.zeros((0, 1, nv), dtype), jnp.zeros((0, 1), dtype)
    pmax = max(sizes)
    G_all = jnp.concatenate([g for (_, g, _) in soc_blocks], axis=0)
    h_all = jnp.concatenate([h for (_, _, h) in soc_blocks])
    n_rows = int(G_all.shape[0])
    idx = np.full((ncones, pmax), n_rows, dtype=np.int32)  # sentinel = pad
    r = 0
    for i, sz in enumerate(sizes):
        idx[i, :sz] = np.arange(r, r + sz)
        r += sz
    Gq = jnp.concatenate([G_all, jnp.zeros((1, nv), dtype)], axis=0)[idx]
    hq = jnp.concatenate([h_all, jnp.zeros((1,), dtype)])[idx]
    return Gq, hq


# -- row/cone constructors -----------------------------------------------------------


def _box_rows(cqp, ubounds, xbounds, nv, Xmap, xoff, N, udim):
    """All box-bound rows as ``g'v <= h`` over v; consensus controls take
    particle 0's bounds (parity with ``lqp_utils.jl:323-331``). Rows whose
    bound is infinite are NEUTRALIZED (G=0, h=1) so one-sided bounds never
    leak an infinite slack into the IPM."""
    M, nc, nf = cqp.M, cqp.nc, cqp.nf
    NX = cqp.g.shape[-1]
    dtype = cqp.qf.dtype
    nz = nc + M * nf
    eye_v = jnp.eye(nv, dtype=dtype)
    G_rows, h_rows = [], []
    u_l, u_u = ubounds
    if u_l is not None and u_u is not None:
        ul = jnp.asarray(u_l, dtype).reshape(M, N * udim)
        uu = jnp.asarray(u_u, dtype).reshape(M, N * udim)
        if nc:
            sel_c = eye_v[:nc]
            G_rows += [sel_c, -sel_c]
            h_rows += [uu[0, :nc], -ul[0, :nc]]
        if nf:
            sel_f = eye_v[nc:nz]  # (M*nf, nv) particle-major
            G_rows += [sel_f, -sel_f]
            h_rows += [uu[:, nc:].reshape(-1), -ul[:, nc:].reshape(-1)]
    x_l, x_u = xbounds
    if x_l is not None and x_u is not None:
        xl = jnp.asarray(x_l, dtype).reshape(M * NX)
        xu = jnp.asarray(x_u, dtype).reshape(M * NX)
        Gx = jnp.zeros((M * NX, nv), dtype).at[:, :nz].set(Xmap)
        G_rows += [Gx, -Gx]
        h_rows += [xu - xoff, -(xl - xoff)]
    if not G_rows:
        return jnp.zeros((0, nv), dtype), jnp.zeros((0,), dtype)
    G = jnp.concatenate(G_rows, axis=0)
    h = jnp.concatenate(h_rows)
    return G, h


def _neutralize_infinite(G, h):
    """Disable rows with an infinite bound: 0'v <= 1 (always-slack row)."""
    finite = jnp.isfinite(h)
    return (jnp.where(finite[:, None], G, 0.0),
            jnp.where(finite, h, jnp.ones((), h.dtype)))


def _usoc_blocks(u_soc_r, nv, M, nc, nf, N, udim, dtype):
    """Per-stage control-norm cones ||u_{ij}|| <= r_{ij} as SOC rows over v.

    Consensus stages take particle 0's radius (layout parity with
    `solvers.ipm.layout_socs`); infinite radii give the neutral cone
    (h = e, G = 0). Returns (ncones, udim+1, nv) / (ncones, udim+1)."""
    Nc = nc // udim
    Nf = nf // udim
    r = jnp.asarray(u_soc_r, dtype)  # (M, N)
    eye_v = jnp.eye(nv, dtype=dtype)
    Gs, hs = [], []
    if nc:
        selc = eye_v[:nc].reshape(Nc, udim, nv)
        rc = r[0, :Nc]
        fin = jnp.isfinite(rc)
        G = jnp.concatenate([jnp.zeros((Nc, 1, nv), dtype), -selc], axis=1)
        G = jnp.where(fin[:, None, None], G, 0.0)
        h = jnp.zeros((Nc, udim + 1), dtype).at[:, 0].set(
            jnp.where(fin, rc, jnp.ones((), dtype)))
        Gs.append(G)
        hs.append(h)
    if nf:
        self_f = eye_v[nc:nc + M * nf].reshape(M, Nf, udim, nv)
        rf = r[:, Nc:]
        fin = jnp.isfinite(rf)
        G = jnp.concatenate([jnp.zeros((M, Nf, 1, nv), dtype), -self_f], axis=2)
        G = jnp.where(fin[:, :, None, None], G, 0.0)
        h = jnp.zeros((M, Nf, udim + 1), dtype).at[:, :, 0].set(
            jnp.where(fin, rf, jnp.ones((), dtype)))
        Gs.append(G.reshape(M * Nf, udim + 1, nv))
        hs.append(h.reshape(M * Nf, udim + 1))
    return jnp.concatenate(Gs, axis=0), jnp.concatenate(hs, axis=0)


def _smooth_logbarrier(G, h, alpha, sm_off, nv):
    """Rows ``g'v <= h`` -> exp-cone triples encoding the logbarrier epigraph
    ``t >= -(1/alpha) log(alpha (h - g'v))`` in this package's convention
    (slack s = h_3 - G_3 v, exp(s_x/s_z) <= s_y/s_z; the sign-flip of the
    reference's ``make_logbarrier_constraint`` rows, ``cone_utils.jl:173-202``).
    Infinite bounds clamp to BIG_BOUND (barrier term becomes a constant).
    Aux vars t_i live at columns sm_off..sm_off+m; their objective cost is 1.
    Returns (Ge (m,3,nv), he (m,3))."""
    m = G.shape[0]
    dtype = G.dtype
    fin = jnp.isfinite(h)
    Gf = jnp.where(fin[:, None], G, 0.0)
    hf = jnp.where(fin, h, jnp.asarray(BIG_BOUND, dtype))
    Ge = jnp.zeros((m, 3, nv), dtype)
    Ge = Ge.at[:, 0, sm_off:sm_off + m].set(alpha * jnp.eye(m, dtype=dtype))
    Ge = Ge.at[:, 1, :].set(alpha * Gf)
    he = jnp.stack([jnp.zeros((m,), dtype), alpha * hf, jnp.ones((m,), dtype)],
                   axis=1)
    return Ge, he


def _smooth_squareplus(G, h, alpha, beta, sm_off, nv):
    """Rows ``g'v <= h`` -> SOC triples encoding the squareplus epigraph
    ``t >= (beta/2) (r + sqrt(r^2 + alpha^-2))``, r = g'v - h (the SOC
    reformulation of ``cone_utils.jl:222-228``). Returns (Gq (m,3,nv),
    hq (m,3)); aux t_i at columns sm_off.., objective cost 1."""
    m = G.shape[0]
    dtype = G.dtype
    fin = jnp.isfinite(h)
    Gf = jnp.where(fin[:, None], G, 0.0)
    hf = jnp.where(fin, h, jnp.asarray(BIG_BOUND, dtype))
    Gq = jnp.zeros((m, 3, nv), dtype)
    Gq = Gq.at[:, 0, :].set(Gf)
    Gq = Gq.at[:, 0, sm_off:sm_off + m].add(-(2.0 / beta)
                                            * jnp.eye(m, dtype=dtype))
    Gq = Gq.at[:, 1, :].set(-Gf)
    hq = jnp.stack([hf, -hf, jnp.full((m,), 1.0, dtype) / alpha], axis=1)
    return Gq, hq


def _epigraph_blocks(H_per, q_per, c_per, nv, nc, nf, M, epi_off, dtype):
    """Per-particle k-worst epigraph SOCs ``J_i(z_i) <= y_i + t`` with
    J_i = 0.5 z_i'H_i z_i + q_i'z_i + c_i encoded through the Cholesky factor
    (the ``Pqr2Gh`` trick, ``cone_utils.jl:25-61``), batched over M with
    broadcast-mask embeddings. Returns ((M, nzi+2, nv), (M, nzi+2))."""
    nzi = nc + nf
    nz = nc + M * nf
    eyeM = jnp.eye(M, dtype=dtype)
    L = jnp.linalg.cholesky(H_per + 1e-12 * jnp.eye(nzi, dtype=dtype))
    A = jnp.swapaxes(L, -1, -2) / jnp.sqrt(jnp.asarray(2.0, dtype))
    Az = jnp.zeros((M, nzi, nv), dtype)
    Az = Az.at[:, :, :nc].set(A[:, :, :nc])
    free_cols = (eyeM[:, None, :, None] * A[:, :, None, nc:]).reshape(
        M, nzi, M * nf)
    Az = Az.at[:, :, nc:nz].set(free_cols)
    qv = jnp.zeros((M, nv), dtype)
    qv = qv.at[:, :nc].set(q_per[:, :nc])
    qv = qv.at[:, nc:nz].set(
        (eyeM[:, :, None] * q_per[:, None, nc:]).reshape(M, M * nf))
    # w_i = y_i + t
    wv = jnp.zeros((M, nv), dtype)
    wv = wv.at[:, epi_off:epi_off + M].set(eyeM)
    wv = wv.at[:, epi_off + M].set(1.0)
    # SOC rows: s = h - G v with s0 = 1 + (w - q'z - c), s_mid = 2 A z,
    # s_last = 1 - (w - q'z - c)
    G = jnp.concatenate([
        -(wv - qv)[:, None, :], -2.0 * Az, (wv - qv)[:, None, :]], axis=1)
    h = jnp.concatenate([
        (1.0 - c_per)[:, None], jnp.zeros((M, nzi), dtype),
        (1.0 + c_per)[:, None]], axis=1)
    # uniform per-cone scaling (a scaled SOC is the same constraint) keeps
    # the IPM well-conditioned when particle-cost constants are large
    scale = jnp.maximum(1.0, jnp.maximum(
        jnp.abs(c_per), jnp.max(jnp.abs(Az), axis=(1, 2))))
    return G / scale[:, None, None], h / scale[:, None]


class CvarParts(NamedTuple):
    """Traced pieces of the k-worst (CVaR) epigraph objective."""

    H_per: jax.Array  # (M, nc+nf, nc+nf) per-particle Hessians over z_i
    q_per: jax.Array  # (M, nc+nf)
    c_per: jax.Array  # (M,) per-particle constants (J_i at z_i = 0)
    k: jax.Array  # scalar (traced)
    eps: jax.Array  # COST_ANCHOR_EPS (traced)


class ComposedLayout(NamedTuple):
    """Static layout facts of the composed program (host ints)."""

    nz: int
    n_epi: int
    aux_off: int
    n_aux: int
    sm_off: int
    n_sm: int
    nv: int


def layout_sizes(M, nc, nf, NX, sig, ubounds_on, xbounds_on, smooth_method,
                 has_cvar) -> ComposedLayout:
    """Static variable-layout of the composed program for (dims, sig, flags)."""
    nz = nc + M * nf
    n_epi = (M + 1) if has_cvar else 0
    n_aux = sum(s[3] for s in sig)
    m_box = (2 * nz if ubounds_on else 0) + (2 * M * NX if xbounds_on else 0)
    lin_extras = sum(s[0] for s in sig)
    if smooth_method == "logbarrier":
        n_sm = m_box + lin_extras
    elif smooth_method == "squareplus":
        n_sm = m_box
    else:
        n_sm = 0
    aux_off = nz + n_epi
    sm_off = aux_off + n_aux
    return ComposedLayout(nz=nz, n_epi=n_epi, aux_off=aux_off, n_aux=n_aux,
                          sm_off=sm_off, n_sm=n_sm, nv=sm_off + n_sm)


def build_cone_program(
    cqp: CondensedQP,
    dims: Tuple[int, int, int],
    sig: Tuple,
    ecs: Tuple,
    ubounds, xbounds,
    smooth_method: str = "",
    smooth_alpha=None,
    smooth_beta=None,
    u_soc_r=None,
    H_extra=None,
    q_extra=None,
    cvar: Optional[CvarParts] = None,
):
    """Trace-time assembly of the fully composed dense cone program.

    Returns (P, q, Gl, hl, soc_blocks, Ge, he, Xmap, xoff, lay):
    - soc_blocks: [(sizes, G_rows (m, nv), h_rows (m,)), ...] for `pad_socs`,
    - Ge/he: stacked exp-cone triples (ne, 3, nv) / (ne, 3),
    - lay: the static `ComposedLayout`.
    All shapes are static functions of (dims, sig, flags, operand shapes)."""
    N, udim, xdim = dims
    M, nc, nf = cqp.M, cqp.nc, cqp.nf
    NX = cqp.g.shape[-1]
    nu_total, n_full = full_layout_sizes(M, nc, nf, NX)
    dtype = cqp.qf.dtype
    lay = layout_sizes(M, nc, nf, NX, sig,
                       ubounds[0] is not None, xbounds[0] is not None,
                       smooth_method, cvar is not None)
    nz, nv = lay.nz, lay.nv
    Xmap, xoff = x_map(cqp)

    # -- objective -------------------------------------------------------
    q_full = jnp.zeros((nv,), dtype)
    if cvar is None:
        H, q0 = dense_H_q(cqp)
        if H_extra is not None:
            H = H + H_extra
        if q_extra is not None:
            q0 = q0 + q_extra
        P = jnp.zeros((nv, nv), dtype).at[:nz, :nz].set(H)
        q_full = q_full.at[:nz].set(q0)
    else:
        # k-worst epigraph objective (main.jl:221-227); a tiny quadratic
        # regularization keeps the LP-like init sane
        P = 1e-8 * jnp.eye(nv, dtype=dtype)
        q_full = q_full.at[nz:nz + M].set(1.0 + cvar.eps)
        q_full = q_full.at[nz + M].set((1.0 - cvar.eps) * cvar.k)

    Gl_rows: List[jnp.ndarray] = []
    hl_rows: List[jnp.ndarray] = []
    soc_blocks: List[Tuple[Tuple[int, ...], jnp.ndarray, jnp.ndarray]] = []
    exp_G: List[jnp.ndarray] = []
    exp_h: List[jnp.ndarray] = []
    to_smooth_G: List[jnp.ndarray] = []  # rows deferred to the smoothers
    to_smooth_h: List[jnp.ndarray] = []

    if cvar is not None:
        # y >= 0 rows (main.jl:230-232) + per-particle epigraph SOCs
        eyeM = jnp.eye(M, dtype=dtype)
        Gy = jnp.zeros((M, nv), dtype).at[:, nz:nz + M].set(-eyeM)
        Gl_rows.append(Gy)
        hl_rows.append(jnp.zeros((M,), dtype))
        Gq_epi, hq_epi = _epigraph_blocks(
            cvar.H_per, cvar.q_per, cvar.c_per, nv, nc, nf, M, nz, dtype)
        nzi = nc + nf
        soc_blocks.append(((nzi + 2,) * M,
                           Gq_epi.reshape(M * (nzi + 2), nv),
                           hq_epi.reshape(M * (nzi + 2))))

    # -- box rows (plain, or deferred to smoothing) ------------------------
    Gb, hb = _box_rows(cqp, ubounds, xbounds, nv, Xmap, xoff, N, udim)
    if Gb.shape[0]:
        if smooth_method in ("logbarrier", "squareplus"):
            to_smooth_G.append(Gb)
            to_smooth_h.append(hb)
        else:
            Gb, hb = _neutralize_infinite(Gb, hb)
            Gl_rows.append(Gb)
            hl_rows.append(hb)

    # -- per-stage control-norm cones --------------------------------------
    if u_soc_r is not None:
        Gu, hu = _usoc_blocks(u_soc_r, nv, M, nc, nf, N, udim, dtype)
        ncu = Gu.shape[0]
        soc_blocks.append(((udim + 1,) * ncu,
                           Gu.reshape(ncu * (udim + 1), nv),
                           hu.reshape(ncu * (udim + 1))))

    # -- user extra constraints --------------------------------------------
    aux_off = lay.aux_off
    for (l, qsizes, e, _), (G_left, G_right, h, c_left, c_right) in zip(sig, ecs):
        G_left = jnp.asarray(G_left, dtype)
        G_right = jnp.asarray(G_right, dtype)
        h = jnp.asarray(h, dtype)
        n_aux = G_right.shape[1]
        # lift rows over z_full = [u; x] onto v (states eliminated)
        Gu_part = G_left[:, :nu_total]
        Gx_part = G_left[:, nu_total:]
        Gv = Gu_part + Gx_part @ Xmap
        h_adj = h - Gx_part @ xoff
        G_full = jnp.zeros((Gv.shape[0], nv), dtype).at[:, :nz].set(Gv)
        if n_aux:
            G_full = G_full.at[:, aux_off:aux_off + n_aux].set(G_right)

        if c_left.size:
            assert c_left.size in (n_full, nz), c_left.size
            cl = jnp.asarray(c_left, dtype)
            if c_left.size == n_full:
                q_full = q_full.at[:nz].add(cl[:nu_total] + Xmap.T @ cl[nu_total:])
            else:
                q_full = q_full.at[:nz].add(cl)
        if n_aux and c_right.size:
            q_full = q_full.at[aux_off:aux_off + n_aux].add(
                jnp.asarray(c_right, dtype))

        if l:
            if smooth_method == "logbarrier":
                # reference smooths extras' leading linear rows too
                # (main.jl:301-316)
                to_smooth_G.append(G_full[:l])
                to_smooth_h.append(h_adj[:l])
            else:
                Gl_rows.append(G_full[:l])
                hl_rows.append(h_adj[:l])
        nq = sum(qsizes)
        if nq:
            soc_blocks.append((qsizes, G_full[l:l + nq], h_adj[l:l + nq]))
        r = l + nq
        # exp cones: e TRIPLES of rows after the lin/SOC sections,
        # convention s = h - Gv with exp(s_x/s_z) <= s_y/s_z, s_z > 0
        if e:
            exp_G.append(G_full[r:r + 3 * e].reshape(e, 3, nv))
            exp_h.append(h_adj[r:r + 3 * e].reshape(e, 3))
        aux_off += n_aux

    # -- smoothing reformulation of the deferred rows -----------------------
    if to_smooth_G:
        Gs = jnp.concatenate(to_smooth_G, axis=0)
        hs = jnp.concatenate(to_smooth_h)
        assert Gs.shape[0] == lay.n_sm, (Gs.shape, lay)
        alpha = jnp.asarray(
            1.0 if smooth_alpha is None else smooth_alpha, dtype)
        # smoothing aux vars carry objective cost 1 (c_right = ones,
        # main.jl:260-261)
        q_full = q_full.at[lay.sm_off:].set(1.0)
        if smooth_method == "logbarrier":
            Ge_s, he_s = _smooth_logbarrier(Gs, hs, alpha, lay.sm_off, nv)
            exp_G.append(Ge_s)
            exp_h.append(he_s)
        else:
            beta = jnp.asarray(
                1.0 if smooth_beta is None else smooth_beta, dtype)
            Gq_s, hq_s = _smooth_squareplus(Gs, hs, alpha, beta, lay.sm_off, nv)
            m = Gq_s.shape[0]
            soc_blocks.append(((3,) * m, Gq_s.reshape(m * 3, nv),
                               hq_s.reshape(m * 3)))

    if cvar is not None:
        # normalize the LP objective by the particle-cost scale so the IPM
        # duality measure is a RELATIVE gap (uniform scaling of the whole
        # linear objective preserves the argmin, including extras'/smoothing
        # aux costs added above)
        sigma = jnp.maximum(1.0, jnp.mean(jnp.abs(cvar.c_per)))
        q_full = q_full / sigma

    Gl = jnp.concatenate(Gl_rows, axis=0) if Gl_rows \
        else jnp.zeros((0, nv), dtype)
    hl = jnp.concatenate(hl_rows) if hl_rows else jnp.zeros((0,), dtype)
    Ge = jnp.concatenate(exp_G, axis=0) if exp_G \
        else jnp.zeros((0, 3, nv), dtype)
    he = jnp.concatenate(exp_h, axis=0) if exp_h else jnp.zeros((0, 3), dtype)
    return P, q_full, Gl, hl, soc_blocks, Ge, he, Xmap, xoff, lay


# -- device drivers ------------------------------------------------------------------


@partial(jax.jit, static_argnames=("dims", "sig", "smooth_method", "iters",
                                   "tol_exp", "kappa"))
def _composed_symmetric_device(cqp, dims, sig, ubounds, xbounds, ecs,
                               H_extra, q_extra, smooth_method,
                               smooth_alpha, smooth_beta, u_soc_r, cvar,
                               iters: int, tol_exp: int, kappa: float,
                               tol_dynamic=None, warm=None):
    """One compiled program per static signature: assemble the composed cone
    QP (symmetric cones only) and solve with the NT-scaled cone IPM."""
    N, udim, xdim = dims
    M, nc, nf = cqp.M, cqp.nc, cqp.nf
    dtype = cqp.qf.dtype
    P, q, Gl, hl, soc_blocks, Ge, he, Xmap, xoff, lay = build_cone_program(
        cqp, dims, sig, ecs, ubounds, xbounds, smooth_method=smooth_method,
        smooth_alpha=smooth_alpha, smooth_beta=smooth_beta, u_soc_r=u_soc_r,
        H_extra=H_extra, q_extra=q_extra, cvar=cvar)
    assert Ge.shape[0] == 0  # exp cones take the barrier driver
    Gq, hq = pad_socs(soc_blocks, lay.nv, dtype)
    prob = ConeLP(P=P, q=q, Gl=Gl, hl=hl, Gq=Gq, hq=hq)
    v, s, z, stats = cone_qp_solve(prob, iters=iters, tol_exp=tol_exp,
                                   kappa=kappa, tol_dynamic=tol_dynamic,
                                   warm=warm)
    X, U = recover_XU(v[:lay.nz], Xmap, xoff, M, nc, nf, N, udim, xdim)
    return X, U, v[lay.nz:], stats, (v, z)


@partial(jax.jit, static_argnames=("dims", "sig", "smooth_method", "tol_exp"))
def _composed_exp_device(cqp, dims, sig, ubounds, xbounds, ecs,
                         H_extra, q_extra, smooth_method,
                         smooth_alpha, smooth_beta, u_soc_r, cvar,
                         tol_exp: int):
    """Assemble + solve the composed program WITH exponential cones via the
    device central-path barrier method (`expbarrier`)."""
    from .expbarrier import exp_barrier_solve

    N, udim, xdim = dims
    M, nc, nf = cqp.M, cqp.nc, cqp.nf
    dtype = cqp.qf.dtype
    P, q, Gl, hl, soc_blocks, Ge, he, Xmap, xoff, lay = build_cone_program(
        cqp, dims, sig, ecs, ubounds, xbounds, smooth_method=smooth_method,
        smooth_alpha=smooth_alpha, smooth_beta=smooth_beta, u_soc_r=u_soc_r,
        H_extra=H_extra, q_extra=q_extra, cvar=cvar)
    Gq, hq = pad_socs(soc_blocks, lay.nv, dtype)
    v, stats = exp_barrier_solve(P, q, Gl, hl, Gq, hq, Ge, he, tol_exp=tol_exp)
    X, U = recover_XU(v[:lay.nz], Xmap, xoff, M, nc, nf, N, udim, xdim)
    return X, U, v, stats


def composed_cone_solve(
    cqp: CondensedQP,
    N: int,
    udim: int,
    xdim: int,
    u_l, u_u, x_l, x_u,
    extra_cstrs,
    settings: Optional[Dict[str, Any]] = None,
    H_extra=None,
    q_extra=None,
    u_soc_r=None,
    smooth_method: str = "",
    smooth_alpha=None,
    smooth_beta=None,
    cvar: Optional[CvarParts] = None,
):
    """Host driver of the composed cone program. Returns (X, U, data).

    Covers every cone-path combination of the reference's ``lcone_solve``
    (``main.jl:204-317``): k-worst epigraph (``cvar``), box bounds, smoothing
    (box rows + extras' linear rows under logbarrier), per-stage control-norm
    cones, user extras, and the cross-particle terminal cost (``H_extra``)."""
    from .coneipm import cone_host_setup, cone_host_state, cone_host_stats
    from .extras import _canon_extras

    settings = settings or {}
    M, nc, nf = cqp.M, cqp.nc, cqp.nf
    NX = cqp.g.shape[-1]
    _, n_full = full_layout_sizes(M, nc, nf, NX)
    dtype = np.dtype(np.asarray(cqp.qf).dtype)
    dims = (N, udim, xdim)

    sig, ecs = _canon_extras(extra_cstrs, n_full)
    ecs_j = tuple(tuple(jnp.asarray(a, dtype) for a in ec) for ec in ecs)
    j = lambda a: None if a is None else jnp.asarray(a, dtype)
    ubounds = (j(u_l), j(u_u))
    xbounds = (j(x_l), j(x_u))
    alpha = None if smooth_alpha is None else jnp.asarray(smooth_alpha, dtype)
    beta = None if smooth_beta is None else jnp.asarray(smooth_beta, dtype)
    usoc = j(u_soc_r)

    has_user_exp = any(e for (_, _, e, _) in sig)
    has_exp = has_user_exp or smooth_method == "logbarrier"

    lay = layout_sizes(M, nc, nf, NX, sig, u_l is not None, x_l is not None,
                       smooth_method, cvar is not None)

    if has_exp:
        # exponential cones make the program non-symmetric (the NT-scaled
        # IPM is for symmetric cones): device central-path barrier (f64),
        # scipy host solve as fallback (settings["exp_device"]=False or a
        # non-converged device run)
        v = None
        data_extra: Dict[str, Any] = {}
        tol_exp = int(settings.get(
            "ipm_tol_exp", -8 if dtype == np.float64 else -5))
        if bool(settings.get("exp_device", True)):
            X, U, v_dev, stats = _composed_exp_device(
                cqp, dims, sig, ubounds, xbounds, ecs_j, H_extra, q_extra,
                smooth_method, alpha, beta, usoc, cvar, tol_exp=tol_exp)
            if bool(stats["converged"]) and np.isfinite(np.asarray(v_dev)).all():
                v = np.asarray(v_dev)
                data_extra = dict(exp_device=True, ipm_mu=float(stats["mu"]))
        if v is None:
            from .extras import _solve_exp_host

            P, q, Gl, hl, soc_blocks, Ge, he, Xmap, xoff, _ = \
                build_cone_program(
                    cqp, dims, sig, ecs_j, ubounds, xbounds,
                    smooth_method=smooth_method, smooth_alpha=alpha,
                    smooth_beta=beta, u_soc_r=usoc, H_extra=H_extra,
                    q_extra=q_extra, cvar=cvar)
            exp_blocks = [(Ge[i], he[i]) for i in range(Ge.shape[0])]
            v, host_ok = _solve_exp_host(P, q, Gl, hl, soc_blocks, exp_blocks)
            data_extra = dict(exp_host_fallback=True,
                              ipm_failed=not bool(host_ok))
            Xmap_, xoff_ = Xmap, xoff
            w = jnp.asarray(v[:lay.nz], dtype)
            X, U = recover_XU(w, Xmap_, xoff_, M, nc, nf, N, udim, xdim)
        data = dict(solver_state=settings.get("solver_state"),
                    ipm_converged=not data_extra.get("ipm_failed", False),
                    aux=np.asarray(v)[lay.nz:], **data_extra)
        return np.asarray(X), np.asarray(U), data

    # symmetric-cone path: shared host-cone prelude (early-exit iteration
    # cap, inexact-Newton forcing from the SCP residual, warm start keyed on
    # the exact problem signature)
    if cvar is not None:
        iters32, tolexp32, kappa32 = 50, -3, 1e-6
    else:
        iters32, tolexp32, kappa32 = 35, -5, 1e-7
    sig_key = ("composed", dims, sig, M, nc, nf,
               u_l is not None, x_l is not None, u_soc_r is not None,
               H_extra is not None, smooth_method,
               None if cvar is None else "cvar")
    iters, tol_exp, kappa, tol_eff, tol_dyn, warm = cone_host_setup(
        settings, dtype, sig_key, "cone_warm", iters32=iters32,
        tolexp32=tolexp32, kappa32=kappa32)
    X, U, aux, stats, (v_out, z_out) = _composed_symmetric_device(
        cqp, dims, sig, ubounds, xbounds, ecs_j, H_extra, q_extra,
        smooth_method, alpha, beta, usoc, cvar,
        iters=iters, tol_exp=tol_exp, kappa=kappa,
        tol_dynamic=None if tol_dyn is None else jnp.asarray(tol_dyn, dtype),
        warm=warm)
    data = dict(
        solver_state=cone_host_state(sig_key, "cone_warm", v_out, z_out),
        aux=np.asarray(aux),
        **cone_host_stats(stats, tol_eff),
    )
    if cvar is not None:
        data["ts"] = np.asarray(aux)[:lay.n_epi]
    return np.asarray(X), np.asarray(U), data


# -- scenario-batched driver -----------------------------------------------------------


def particle_constants_jnp(g, X_prev, U_prev, Q, R, X_ref, U_ref,
                           reg_x, reg_u, slew_reg0, slew_um1):
    """jnp twin of `cvar.particle_constants` (trace-compatible, vmappable):
    c_i = J_i at U = 0 so J_i(z) = 0.5 z'H_i z + q_i'z + c_i exactly."""
    M, N, xdim = X_prev.shape
    g = g.reshape(M, N, xdim)
    dX = g - X_ref
    c = 0.5 * jnp.einsum("mni,mnij,mnj->m", dX, Q, dX)
    c += 0.5 * reg_x * jnp.sum((g - X_prev) ** 2, axis=(1, 2))
    c += 0.5 * jnp.einsum("mni,mnij,mnj->m", U_ref, R, U_ref)
    c += 0.5 * reg_u * jnp.sum(U_prev ** 2, axis=(1, 2))
    c += 0.5 * slew_reg0 * jnp.sum(slew_um1 ** 2, axis=-1)
    return c


@partial(jax.jit, static_argnames=("dims", "sig", "smooth_method", "Nc",
                                   "has_cvar", "iters", "tol_exp", "kappa"))
def composed_solve_batch_device(
    probs,  # dict of (B, M, ...) problem arrays (x0, f, fx, fu, ...)
    bounds,  # dict possibly holding (B, ...) u_l/u_u/x_l/x_u/u_soc_r
    ecs,  # tuple of tuples of (B, ...) extras arrays
    extras_q,  # dict possibly holding (B, ...) Hf / hf
    dims, sig, smooth_method, smooth_alpha, smooth_beta,
    Nc: int, k=None, eps=None, has_cvar: bool = False,
    iters: int = 35, tol_exp: int = -5, kappa: float = 1e-7,
    tol_dynamic=None, warm=None,
):
    """ONE device program solving B same-signature composed cone problems:
    per-problem condensed assembly + program build + NT cone IPM, all under
    one vmap — the scenario-batched analog of the reference's serial
    per-problem ``lcone_solve`` calls (its only parallelism is ``@threads``
    sparse assembly, ``cone_utils.jl:64-95``).

    Returns (X (B,M,N,xdim), U, aux (B, nv-nz), stats dict of (B,) arrays,
    warm_out)."""
    from .reduced import assemble_condensed, CondensedQP, particle_H_q

    N, udim, xdim = dims

    def one(p, bd, ec, eq, td, w):
        x0, f, fx, fu = p["x0"], p["f"], p["fx"], p["fu"]
        M = f.shape[0]
        nc = Nc * udim
        args15 = (x0, f, fx, fu, p["X_prev"], p["U_prev"], p["Q"], p["R"],
                  p["X_ref"], p["U_ref"], p["reg_x"], p["reg_u"],
                  p["slew_reg"], p["slew_reg0"], p["slew_um1"])
        cvar = None
        if has_cvar:
            H_per, q_per, Ft, g = jax.vmap(particle_H_q)(*args15)
            cqp = CondensedQP(
                Hcc=jnp.sum(H_per[:, :nc, :nc], axis=0),
                Hcf=H_per[:, :nc, nc:], Hff=H_per[:, nc:, nc:],
                qc=jnp.sum(q_per[:, :nc], axis=0), qf=q_per[:, nc:],
                Ft=Ft, g=g, w_prev=p["U_prev"].reshape(M, -1))
            c_per = particle_constants_jnp(
                g, p["X_prev"], p["U_prev"], p["Q"], p["R"],
                p["X_ref"], p["U_ref"], p["reg_x"], p["reg_u"],
                p["slew_reg0"], p["slew_um1"])
            cvar = CvarParts(H_per=H_per, q_per=q_per, c_per=c_per,
                             k=k, eps=eps)
        else:
            cqp = assemble_condensed(*args15, Nc=Nc)
        H_extra = q_extra = None
        if "Hf" in eq:
            from .extras import terminal_cross_cost

            H_extra, q_extra = terminal_cross_cost(
                cqp, N=N, xdim=xdim, Hf=eq["Hf"], hf=eq.get("hf"))
        P, q, Gl, hl, soc_blocks, Ge, he, Xmap, xoff, lay = \
            build_cone_program(
                cqp, dims, sig, ec, (bd.get("u_l"), bd.get("u_u")),
                (bd.get("x_l"), bd.get("x_u")),
                smooth_method=smooth_method, smooth_alpha=smooth_alpha,
                smooth_beta=smooth_beta, u_soc_r=bd.get("u_soc_r"),
                H_extra=H_extra, q_extra=q_extra, cvar=cvar)
        Gq, hq = pad_socs(soc_blocks, lay.nv, q.dtype)
        nf = (N - Nc) * udim
        if Ge.shape[0]:
            # exponential cones (logbarrier smoothing / user e-rows): the
            # NT IPM is symmetric-cone-only, so this signature vmaps the
            # device central-path barrier driver instead (same driver the
            # serial path uses). It has no warm-start contract — neutral
            # placeholders keep the host's warm tree shape-stable.
            from .expbarrier import exp_barrier_solve

            v, stats = exp_barrier_solve(P, q, Gl, hl, Gq, hq, Ge, he,
                                         tol_exp=tol_exp)
            X, U = recover_XU(v[:lay.nz], Xmap, xoff, M, nc, nf, N, udim,
                              xdim)
            return X, U, v[lay.nz:], stats, (v, jnp.zeros_like(hl),
                                             jnp.zeros_like(hq))
        prob = ConeLP(P=P, q=q, Gl=Gl, hl=hl, Gq=Gq, hq=hq)
        v, s, z, stats = cone_qp_solve(prob, iters=iters, tol_exp=tol_exp,
                                       kappa=kappa, tol_dynamic=td, warm=w)
        X, U = recover_XU(v[:lay.nz], Xmap, xoff, M, nc, nf, N, udim, xdim)
        return X, U, v[lay.nz:], stats, (v, z[0], z[1])

    in_axes = (0, 0, 0,
               0 if extras_q else None,
               None if tol_dynamic is None else 0,
               None if warm is None else 0)
    return jax.vmap(one, in_axes=in_axes)(
        probs, bounds, ecs, extras_q, tol_dynamic, warm)
