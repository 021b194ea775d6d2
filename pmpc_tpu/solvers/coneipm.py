"""General cone IPM: nonnegative + second-order cones over a dense condensed KKT.

This covers what the reference delegates to ECOS/Mosek for *arbitrary* user
cone constraints (``extra_cstrs`` splicing, ``PMPC.jl/src/cone_utils.jl:99-170``;
``main.jl:292-316``): constraints that do not fit the box/arrow structure of
`pmpc_tpu.solvers.ipm`. Mehrotra predictor-corrector with Nesterov-Todd
scaling:

    min 0.5 v'Pv + q'v   s.t.  G v + s = h,  s in K = R+^l x SOC(p_1) x ... ,

- R+ rows: W^2 = diag(z/s),
- SOC cones: W = beta (2 w w' - J), the standard NT scaling point; cones are
  PADDED to a common size (padding rows of G/h are zero, so padded slack
  coordinates stay exactly zero and never affect the Jordan algebra),
- each Newton step factors K = P + G' W^2 G once (dense batched Cholesky,
  matmul-shaped) and reuses it for predictor and corrector.

Exponential cones are NOT implemented natively; the reference only generates
them for its own logbarrier smoothing, which `pmpc_tpu` solves directly as a
central-path target (see `solvers.ipm`). User exp-cone constraints should use
the squareplus/logbarrier reformulations.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.linalg import spd_apply, spd_factor
from ..utils import with_matmul_precision


class ConeLP(NamedTuple):
    """One cone QP instance (dense, static shapes)."""

    P: jax.Array  # (nv, nv)
    q: jax.Array  # (nv,)
    Gl: jax.Array  # (ml, nv)  nonneg rows
    hl: jax.Array  # (ml,)
    Gq: jax.Array  # (ncones, pmax, nv)  SOC blocks, zero-padded
    hq: jax.Array  # (ncones, pmax)


def _soc_W(s, z):
    """NT scaling for one padded SOC: returns (W, W2, lam, Winv), lam = W s.

    s, z: (p,) with padding zeros; zero padding is exactly neutral: padded
    coordinates of lam stay 0 and padded rows of G are 0, so they never
    influence K, steps, or mu."""
    p = s.shape[0]
    Jdiag = jnp.concatenate([jnp.ones((1,), s.dtype), -jnp.ones((p - 1,), s.dtype)])
    det_s = s[0] ** 2 - jnp.sum(s[1:] ** 2)
    det_z = z[0] ** 2 - jnp.sum(z[1:] ** 2)
    det_s = jnp.maximum(det_s, 1e-30)
    det_z = jnp.maximum(det_z, 1e-30)
    sbar = s / jnp.sqrt(det_s)
    zbar = z / jnp.sqrt(det_z)
    gamma = jnp.sqrt(jnp.maximum((1.0 + sbar @ zbar) / 2.0, 1e-12))
    wbar = (sbar + Jdiag * zbar) / (2.0 * gamma)  # normalized NT point, det=1
    beta = (det_s / det_z) ** 0.25
    # NT point w = beta * wbar has quadratic representation P(w) = W^2:
    #   P(u) = 2 u u' - det(u) J,  P(w) z = s,  det(w) = beta^2.
    # The scaling itself is W = P(sqrt_J(w)) (Jordan square root), which is the
    # symmetric PSD square root of P(w) and satisfies W z = W^{-1} s = lam.
    w = beta * wbar
    y0 = jnp.sqrt(jnp.maximum((w[0] + beta) / 2.0, 1e-20))  # sqrt_J(w)
    y1 = w[1:] / (2.0 * y0)
    y = jnp.concatenate([y0[None], y1])
    Jmat = jnp.diag(Jdiag)
    W = 2.0 * jnp.outer(y, y) - beta * Jmat  # det(y) = beta
    Jy = Jdiag * y
    Winv = (2.0 / (beta * beta)) * jnp.outer(Jy, Jy) - Jmat / beta
    Jw = Jdiag * w
    W2inv = (2.0 / beta**4) * jnp.outer(Jw, Jw) - Jmat / (beta * beta)
    lam = W @ z
    return W, Winv, W2inv, lam


def _soc_scaling(s, z):
    """NT scaling of one padded SOC in VECTOR form: (lam, y, w, beta) with

        W     = 2 y y' - beta J          (y = Jordan sqrt of the NT point w)
        W^-1  = (2/beta^2) (Jy)(Jy)' - J/beta
        W^-2  = (2/beta^4) (Jw)(Jw)' - J/beta^2
        lam   = W z

    i.e. every scaling is rank-1 + diagonal — O(p) storage/applies instead
    of the O(p^2) matrices of `_soc_W`, and G'W^-2 G reduces to a rank-1
    update of the CONSTANT J-gram G'JG (the per-iteration Newton assembly
    stops scaling with p^2). Padding stays exactly neutral (padded coords of
    y, w are 0)."""
    p = s.shape[0]
    Jdiag = jnp.concatenate([jnp.ones((1,), s.dtype),
                             -jnp.ones((p - 1,), s.dtype)])
    det_s = jnp.maximum(s[0] ** 2 - jnp.sum(s[1:] ** 2), 1e-30)
    det_z = jnp.maximum(z[0] ** 2 - jnp.sum(z[1:] ** 2), 1e-30)
    sbar = s / jnp.sqrt(det_s)
    zbar = z / jnp.sqrt(det_z)
    gamma = jnp.sqrt(jnp.maximum((1.0 + sbar @ zbar) / 2.0, 1e-12))
    wbar = (sbar + Jdiag * zbar) / (2.0 * gamma)
    beta = (det_s / det_z) ** 0.25
    w = beta * wbar
    y0 = jnp.sqrt(jnp.maximum((w[0] + beta) / 2.0, 1e-20))
    y = jnp.concatenate([y0[None], w[1:] / (2.0 * y0)])
    lam = 2.0 * y * (y @ z) - beta * (Jdiag * z)
    return lam, y, w, beta


def _soc_prod(u, v):
    """Jordan product for SOC: (u'v ; u0 v1 + v0 u1)."""
    first = jnp.sum(u * v, keepdims=True)
    rest = u[0] * v[1:] + v[0] * u[1:]
    return jnp.concatenate([first, rest])


def _soc_inv(u):
    """Jordan inverse: J u / det(u)."""
    p = u.shape[0]
    Jdiag = jnp.concatenate([jnp.ones((1,), u.dtype), -jnp.ones((p - 1,), u.dtype)])
    det = u[0] ** 2 - jnp.sum(u[1:] ** 2)
    return (Jdiag * u) / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)


def _soc_step_len(s, ds):
    """Largest alpha in [0, inf) with s + alpha ds in the SOC (padded ok).

    Boundary crossings are roots of det(s + t ds) = a t^2 + b t + c with
    c = det(s) >= 0 (current point inside). The roots use the
    cancellation-stable form (q = -(b + sign(b) sqrt(disc))/2; roots q/a and
    c/q) — the naive (-b - sqrt(disc))/(2a) cancels catastrophically in f32
    near-tangent steps. disc itself can still round to the wrong sign at
    near-tangency; the IPM treats any resulting cone escape as a breakdown."""
    a = ds[0] ** 2 - jnp.sum(ds[1:] ** 2)
    b = 2.0 * (s[0] * ds[0] - jnp.sum(s[1:] * ds[1:]))
    c = s[0] ** 2 - jnp.sum(s[1:] ** 2)
    disc = b * b - 4.0 * a * c
    sqrt_disc = jnp.sqrt(jnp.maximum(disc, 0.0))
    sgn_b = jnp.where(b < 0, -1.0, 1.0)
    qq = -0.5 * (b + sgn_b * sqrt_disc)
    r1 = jnp.where(jnp.abs(a) > 1e-30, qq / a, jnp.inf)
    r2 = jnp.where(jnp.abs(qq) > 1e-30, c / qq, jnp.inf)
    # also the first coordinate must stay nonneg: s0 + alpha ds0 >= 0
    r0 = jnp.where(ds[0] < 0, -s[0] / jnp.where(ds[0] < 0, ds[0], -1.0), jnp.inf)
    # if no boundary crossing (disc < 0) the quadratic roots are irrelevant
    rq = jnp.where(disc >= 0, jnp.stack([r1, r2]), jnp.inf)
    cands = jnp.concatenate([rq, r0[None]])
    return jnp.min(jnp.where(cands > 0, cands, jnp.inf))


def cone_host_setup(settings, dtype, sig_key, warm_name,
                    iters32=35, tolexp32=-5, kappa32=1e-7):
    """Shared prelude of the host cone paths (extras / CVaR).

    Returns (iters, tol_exp, kappa, tol_eff, tol_dyn, warm):
    - generous f64 iteration cap (the while_loop exits early on convergence;
      cold solves to 1e-8 need ~25 its, warm ones 3-6),
    - inexact-Newton forcing from the previous SCP residual (the fused
      path's adaptive_tol rule: tol = clip(1e-3 r^2, 0, 1e-3)),
    - warm (v, zl, zq) tuple from solver_state, accepted only when the
      stored problem signature matches ``sig_key`` exactly."""
    import numpy as _np

    f64 = dtype == _np.float64
    iters = int(settings.get("ipm_iters", 100 if f64 else iters32))
    tol_exp = int(settings.get("ipm_tol_exp", -8 if f64 else tolexp32))
    kappa = float(settings.get("ipm_kappa", 1e-10 if f64 else kappa32))
    tol_eff = 10.0 ** tol_exp
    tol_dyn = None
    r = settings.get("scp_residual", None)
    # same rule as ipm_solve_np / riccati_ipm_solve_np: an EXPLICIT
    # ipm_tol_exp disables the forcing unless ipm_adaptive_tol is itself set
    adaptive_dflt = "ipm_tol_exp" not in settings
    if bool(settings.get("ipm_adaptive_tol", adaptive_dflt)) and r is not None \
            and _np.isfinite(r):
        tol_dyn = float(_np.clip(1e-3 * r * r, 0.0, 1e-3))
        tol_eff = max(tol_eff, tol_dyn)
    warm = None
    prev = settings.get("solver_state")
    if bool(settings.get("ipm_warm_start", True)) and isinstance(prev, dict) \
            and prev.get(warm_name + "_key") == sig_key:
        cand = prev.get(warm_name)
        if cand is not None:
            warm = tuple(jnp.asarray(a, dtype) for a in cand)
    return iters, tol_exp, kappa, tol_eff, tol_dyn, warm


def cone_host_state(sig_key, warm_name, v, z):
    """solver_state payload carrying the warm tuple + its signature key."""
    import numpy as _np

    warm_out = (v, z[0], z[1])
    return {warm_name: tuple(_np.asarray(a) for a in warm_out),
            warm_name + "_key": sig_key}


def cone_host_stats(stats, tol_eff):
    """Shared solve-quality report incl. the hard-failure flag: a cone IPM
    far from its central path returned garbage, not an approximation — the
    SCP loop rejects that subproblem."""
    import numpy as _np

    mu = float(stats["mu"])
    converged = bool(stats["converged"])
    return dict(
        ipm_mu=mu,
        ipm_iters=int(stats["iters"]),
        ipm_converged=converged,
        ipm_failed=bool((not converged)
                        and (not _np.isfinite(mu) or mu > 1e2 * tol_eff)),
    )


@partial(jax.jit, static_argnames=("iters", "tol_exp", "kappa", "debug_trace"))
@with_matmul_precision("highest")
def cone_qp_solve(
    prob: ConeLP,
    iters: int = 35,
    tol_exp: int = -8,
    kappa: float = 0.0,
    tol_dynamic=None,
    warm=None,
    debug_trace: bool = False,
):
    """Solve the cone QP; returns (v, s, z, stats).

    ``debug_trace=True`` swaps the early-exit while_loop for a fixed-length
    scan and adds ``stats["trace"]`` with per-iteration (mu, a, a_aff,
    sigma, rp, rd, bad) — the IPM's own profiler.

    ``tol_dynamic`` is an optional TRACED scalar: the effective tolerance is
    ``max(10^tol_exp, tol_dynamic)`` — inexact-Newton forcing without a
    recompile per value.

    ``warm`` is an optional (v, zl, zq) tuple from a previous solve of the
    same signature (e.g. the last SCP iteration's subproblem): slacks are
    recomputed from the warm PRIMAL against the new constraints (primal
    residual starts ~0) and nudged into the cone interiors; duals carry
    over. Shapes must match the PADDED problem, i.e. exactly what a prior
    call returned."""
    dtype = prob.q.dtype
    tol = jnp.asarray(10.0 ** tol_exp, dtype=dtype)
    if tol_dynamic is not None:
        tol = jnp.maximum(tol, jnp.asarray(tol_dynamic, dtype=dtype))
    nv = prob.q.shape[0]
    ml = prob.hl.shape[0]
    ncones, pmax = prob.hq.shape

    if ml == 0 and ncones == 0:
        # unconstrained QP: the Newton solution is exact, no IPM needed
        v = spd_apply(spd_factor(prob.P, jitter=kappa), -prob.q)
        zero = jnp.zeros((0,), dtype)
        zeroq = jnp.zeros((0, pmax), dtype)
        stats = dict(mu=jnp.asarray(0.0, dtype),
                     iters=jnp.asarray(0, jnp.int32),
                     converged=jnp.asarray(True))
        return v, (zero, zeroq), (zero, zeroq), stats

    # keep zero-sized arrays out of the while_loop carry (one carry layout
    # for every constraint mix): pad an empty constraint family with one
    # NEUTRAL dummy row (0'v <= 1 /
    # a free SOC slack at e). The dummy's slack converges to (1, mu) like any
    # inactive constraint and never touches K or the primal.
    if ml == 0:
        prob = prob._replace(Gl=jnp.zeros((1, nv), dtype),
                             hl=jnp.ones((1,), dtype))
        ml = 1
    if ncones == 0:
        pmax = max(pmax, 2)
        prob = prob._replace(
            Gq=jnp.zeros((1, pmax, nv), dtype),
            hq=jnp.zeros((1, pmax), dtype).at[0, 0].set(1.0))
        ncones = 1

    nu = ml + ncones  # cone degree for mu normalization
    tau = jnp.asarray(0.99 if dtype == jnp.float64 else 0.95, dtype=dtype)

    e_soc = jnp.zeros((ncones, pmax), dtype).at[:, 0].set(1.0)
    Jq = jnp.concatenate([jnp.ones((1,), dtype),
                          -jnp.ones((pmax - 1,), dtype)])  # SOC J diagonal
    Gq2d = prob.Gq.reshape(ncones * pmax, nv)
    # wide cones (the CVaR epigraph class): G'W^-2 G = rank-1 - weighted
    # J-gram, and the per-cone J-grams G_c'JG_c are CONSTANT — precompute
    # them once and the per-iteration Newton assembly drops from
    # O(c p nv^2 + c p^2 nv) to O(c nv^2 + c p nv). For narrow cones (p ~ 3)
    # the (c, nv, nv) buffer costs more than it saves — keep the diagonal
    # -scaled gram there.
    use_jgram = pmax >= 32
    if use_jgram:
        Tq = jnp.einsum("cpv,cpw->cvw", prob.Gq * Jq[None, :, None], prob.Gq)

    def _shift_nonneg(u):
        a = -jnp.min(u) if u.size else jnp.asarray(-1.0, dtype)
        return jnp.where(a < 0, u, u + (1.0 + a))

    def _shift_soc(u):
        """Shift u (c, p) into the SOC interiors along e."""
        a = jnp.linalg.norm(u[:, 1:], axis=-1) - u[:, 0]  # (c,)
        shift = jnp.where(a < 0, 0.0, 1.0 + a)
        return u.at[:, 0].add(shift)

    def init():
        # least-squares KKT primal; slacks shifted into the cone interiors;
        # SOC duals started on the CENTRAL RAY (z = scale * e per cone,
        # scale ~ the residual magnitude). The previous shifted-residual
        # dual start hugs the cone boundary when the program mixes scales
        # (CVaR epigraph rows carry O(10) cost constants): lambda collapses
        # in some directions and every Mehrotra step gets blocked at
        # alpha ~ 1e-2 for hundreds of iterations (measured 202 -> 21
        # iterations on the k-worst program this was debugged on).
        GtG = prob.Gl.T @ prob.Gl + jnp.einsum("cpv,cpw->vw", prob.Gq, prob.Gq)
        Gth = prob.Gl.T @ prob.hl + jnp.einsum("cpv,cp->v", prob.Gq, prob.hq)
        v = spd_apply(spd_factor(prob.P + GtG, jitter=1e-8), -prob.q + Gth)
        res_l = prob.hl - prob.Gl @ v  # = s_hat
        res_q = prob.hq - jnp.einsum("cpv,v->cp", prob.Gq, v)
        sl = _shift_nonneg(res_l)
        zl = jnp.maximum(-res_l, 1.0)
        sq = _shift_soc(res_q) if ncones else res_q
        scale_q = jnp.maximum(jnp.linalg.norm(res_q, axis=-1), 1.0)  # (c,)
        zq = e_soc * scale_q[:, None]
        return v, sl, zl, sq, zq

    def init_warm(w):
        vw, zlw, zqw = w
        vw = jnp.asarray(vw, dtype)
        delta = jnp.asarray(1e-2, dtype)
        # slacks from the warm primal against the NEW h (r_p starts ~0
        # where the warm point is still feasible); small interior margin
        res_l = prob.hl - prob.Gl @ vw
        sl = jnp.maximum(res_l, delta)
        zl = jnp.maximum(jnp.asarray(zlw, dtype), delta)
        res_q = prob.hq - jnp.einsum("cpv,v->cp", prob.Gq, vw)
        a = jnp.linalg.norm(res_q[:, 1:], axis=-1) - res_q[:, 0]  # >0: outside
        sq = res_q.at[:, 0].add(jnp.maximum(a, 0.0) + delta)
        zq = jnp.asarray(zqw, dtype)
        az = jnp.linalg.norm(zq[:, 1:], axis=-1) - zq[:, 0]
        zq = zq.at[:, 0].add(jnp.maximum(az, 0.0) + delta)
        return vw, sl, zl, sq, zq

    v0, sl0, zl0, sq0, zq0 = init() if warm is None else init_warm(warm)

    def body(carry):
        v, sl, zl, sq, zq, done, ok, mu_prev, nsteps, badc = carry
        # residuals
        r_d = prob.P @ v + prob.q + prob.Gl.T @ zl + jnp.einsum("cpv,cp->v", prob.Gq, zq)
        r_pl = prob.Gl @ v + sl - prob.hl
        r_pq = jnp.einsum("cpv,v->cp", prob.Gq, v) + sq - prob.hq

        # scalings (vector form: rank-1 + diagonal, see _soc_scaling)
        # capped ratios keep K finite/PD-ish in float32 near the boundary
        wl_max = jnp.asarray(1e14 if dtype == jnp.float64 else 1e7, dtype)
        wl2 = jnp.minimum(zl / sl, wl_max)  # (ml,)
        lamq, Yq, Wvq, betaq = jax.vmap(_soc_scaling)(sq, zq)
        mu = (jnp.sum(sl * zl) + jnp.sum(sq * zq)) / nu
        JYq = Jq * Yq   # (c, p)
        JWq = Jq * Wvq
        b2 = betaq * betaq

        def socW(x):
            return 2.0 * Yq * jnp.sum(Yq * x, -1, keepdims=True) \
                - betaq[:, None] * (Jq * x)

        def socWinv(x):
            return (2.0 / b2)[:, None] * JYq * jnp.sum(JYq * x, -1,
                                                       keepdims=True) \
                - (Jq * x) / betaq[:, None]

        def socW2inv(x):
            return (2.0 / (b2 * b2))[:, None] * JWq \
                * jnp.sum(JWq * x, -1, keepdims=True) \
                - (Jq * x) / b2[:, None]

        # G'W^-2 G = (2/beta^4) (G'Jw)(G'Jw)' - (1/beta^2) G'JG per cone
        Uq = jnp.einsum("cpv,cp->cv", prob.Gq, JWq)  # (c, nv)
        K_soc = jnp.einsum("c,cv,cw->vw", 2.0 / (b2 * b2), Uq, Uq)
        if use_jgram:
            K_soc = K_soc - jnp.einsum("c,cvw->vw", 1.0 / b2, Tq)
        else:
            dJ = (Jq[None, :] / b2[:, None]).reshape(-1)  # (c*p,)
            K_soc = K_soc - (Gq2d.T * dJ) @ Gq2d
        K = prob.P + (prob.Gl.T * wl2) @ prob.Gl + K_soc
        # breakdown retries boost the regularization (badc grows on bad steps)
        diag_scale = jnp.mean(jnp.diagonal(K)) + 1.0
        boost = badc.astype(dtype) ** 2 * jnp.asarray(1e-4, dtype) * diag_scale
        K = K + boost * jnp.eye(nv, dtype=dtype)
        L = spd_factor(K, jitter=kappa)

        def winv_lam_dc(dq_c):
            """W^{-1} (lam^{-1} o d_c), all cones at once."""
            t = jax.vmap(lambda l, d: _soc_prod(_soc_inv(l), d))(lamq, dq_c)
            return socWinv(t)

        def solve_dir(dl_c, dq_c):
            """Newton direction for complementarity targets (dl_c over R+,
            dq_c over SOC, both in scaled space).

            Reduction: dz = W^{-2}(G dv + r_p) - W^{-1}(lam^{-1} o d_c),
            K dv = -(r_d + G'[W^{-2} r_p - W^{-1}(lam^{-1} o d_c)])."""
            wld = winv_lam_dc(dq_c)
            rhs = -(r_d
                    + prob.Gl.T @ (wl2 * r_pl - dl_c / sl)
                    + jnp.einsum("cpv,cp->v", prob.Gq,
                                 socW2inv(r_pq) - wld))
            dv = spd_apply(L, rhs)
            Gdv_l = prob.Gl @ dv
            Gdv_q = jnp.einsum("cpv,v->cp", prob.Gq, dv)
            dsl = -r_pl - Gdv_l
            dsq = -r_pq - Gdv_q
            dzl = wl2 * (Gdv_l + r_pl) - dl_c / sl
            dzq = socW2inv(Gdv_q + r_pq) - wld
            return dv, dsl, dzl, dsq, dzq

        def step_len(sl_, dsl, zl_, dzl, sq_, dsq, zq_, dzq):
            def posratio(val, dval):
                r = jnp.where(dval < 0, -val / jnp.where(dval < 0, dval, -1.0), jnp.inf)
                return jnp.min(r) if r.size else jnp.asarray(jnp.inf, dtype)
            ap = jnp.minimum(posratio(sl_, dsl),
                             jnp.min(jax.vmap(_soc_step_len)(sq_, dsq)) if ncones else jnp.asarray(jnp.inf, dtype))
            ad = jnp.minimum(posratio(zl_, dzl),
                             jnp.min(jax.vmap(_soc_step_len)(zq_, dzq)) if ncones else jnp.asarray(jnp.inf, dtype))
            return jnp.minimum(1.0, tau * ap), jnp.minimum(1.0, tau * ad)

        # predictor
        dl_aff = sl * zl
        dq_aff = jax.vmap(_soc_prod)(lamq, lamq)
        dv_a, dsl_a, dzl_a, dsq_a, dzq_a = solve_dir(dl_aff, dq_aff)
        ap_a, ad_a = step_len(sl, dsl_a, zl, dzl_a, sq, dsq_a, zq, dzq_a)
        a_a = jnp.minimum(ap_a, ad_a)
        mu_aff = (jnp.sum((sl + a_a * dsl_a) * (zl + a_a * dzl_a))
                  + jnp.sum((sq + a_a * dsq_a) * (zq + a_a * dzq_a))) / nu
        sigma = jnp.clip((mu_aff / jnp.maximum(mu, 1e-30)) ** 3, 0.0, 1.0)

        # corrector: d_c = lam o lam + (W^{-T} ds_aff) o (W dz_aff) - sigma mu e
        eta_a = socWinv(dsq_a)  # W^{-T} ds_aff (W symmetric)
        th_a = socW(dzq_a)  # W dz_aff
        so_l = dsl_a * dzl_a  # second-order complementarity terms
        so_q = jax.vmap(_soc_prod)(eta_a, th_a)
        lam2 = jax.vmap(_soc_prod)(lamq, lamq)
        dv, dsl, dzl, dsq, dzq = solve_dir(
            sl * zl + so_l - sigma * mu, lam2 + so_q - sigma * mu * e_soc)
        ap, ad = step_len(sl, dsl, zl, dzl, sq, dsq, zq, dzq)
        a = jnp.minimum(ap, ad)

        # adaptive corrector damping: the FULL Mehrotra correction can
        # overshoot SOC walls (corrector step stuck at ~0.2 with a_aff ~ 0.6
        # -> linear tail), while DAMPING the second-order term by a_aff^2
        # stalls LP-like programs whose a_aff is tiny (the full correction is
        # what cuts through). Compute both (the extra back-substitution
        # reuses the factorization and costs ~1/10 of the K build; lax.cond
        # here is a 9x PESSIMIZATION on XLA:CPU — the captured operands stop
        # the while-body fusing) and keep the larger step whenever the full
        # corrector collapses vs the affine step.
        damp = a_a * a_a
        dv2, dsl2, dzl2, dsq2, dzq2 = solve_dir(
            sl * zl + damp * so_l - sigma * mu,
            lam2 + damp * so_q - sigma * mu * e_soc)
        ap2, ad2 = step_len(sl, dsl2, zl, dzl2, sq, dsq2, zq, dzq2)
        a2 = jnp.minimum(ap2, ad2)
        use2 = (a < 0.5 * a_a) & (a2 > a)
        pick2 = lambda x_, y_: jnp.where(use2, y_, x_)
        dv, dsl, dzl, dsq, dzq = (pick2(dv, dv2), pick2(dsl, dsl2),
                                  pick2(dzl, dzl2), pick2(dsq, dsq2),
                                  pick2(dzq, dzq2))
        a = pick2(a, a2)

        # recovery: if the corrector step still collapses (boundary collision
        # from the second-order term), fall back to a plain centering
        # direction with sigma = 0.8 — reuses the factorization, restores
        # progress (computed unconditionally: lax.cond would stop the
        # while-body fusing, see above)
        dl_safe = sl * zl - 0.8 * mu
        dq_safe = lam2 - 0.8 * mu * e_soc
        dv3, dsl3, dzl3, dsq3, dzq3 = solve_dir(dl_safe, dq_safe)
        ap3, ad3 = step_len(sl, dsl3, zl, dzl3, sq, dsq3, zq, dzq3)
        a3 = jnp.minimum(ap3, ad3)
        use_safe = a < 0.05
        pick = lambda x_, y_: jnp.where(use_safe, y_, x_)
        dv, dsl, dzl, dsq, dzq = (pick(dv, dv3), pick(dsl, dsl3),
                                  pick(dzl, dzl3), pick(dsq, dsq3),
                                  pick(dzq, dzq3))
        a = pick(a, a3)

        v_n = v + a * dv
        sl_n, zl_n = sl + a * dsl, zl + a * dzl
        sq_n, zq_n = sq + a * dsq, zq + a * dzq
        mu_n = (jnp.sum(sl_n * zl_n) + jnp.sum(sq_n * zq_n)) / nu

        rp_inf = jnp.maximum(
            jnp.max(jnp.abs(r_pl)) if ml else jnp.asarray(0.0, dtype),
            jnp.max(jnp.abs(r_pq)) if ncones else jnp.asarray(0.0, dtype),
        )
        rd_inf = jnp.max(jnp.abs(r_d))
        # a non-finite/exploding step keeps the PREVIOUS iterate (checked
        # before the state write so NaN never escapes) and bumps the retry
        # counter — the next iteration re-solves with boosted regularization;
        # only repeated breakdowns give up
        step_bad = ~(jnp.isfinite(mu_n) & jnp.isfinite(jnp.sum(v_n))) \
            | (mu_n > jnp.maximum(1e4 * mu_prev, 1e12))
        if ncones:
            # a missed boundary crossing (f32 discriminant rounding in
            # _soc_step_len) can land sq/zq OUTSIDE the cone, after which all
            # later algebra is meaningless: treat the escape as a breakdown
            _esc = lambda u_: jnp.max(jnp.linalg.norm(u_[:, 1:], axis=-1) - u_[:, 0])
            step_bad = step_bad | (_esc(sq_n) > 0) | (_esc(zq_n) > 0)
        # a broken step's slack products can be NEGATIVE, pushing mu_n below
        # tol spuriously while the state freezes to the pre-step iterate —
        # convergence must come from a CLEAN step
        now_done = (~step_bad) & (mu_n < tol) \
            & (rp_inf < jnp.sqrt(tol)) & (rd_inf < 1e3 * tol)

        frozen = done | step_bad
        sel = lambda a_, b_: jnp.where(frozen, b_, a_)
        new = (v_n, sl_n, zl_n, sq_n, zq_n)
        old = (v, sl, zl, sq, zq)
        v_o, sl_o, zl_o, sq_o, zq_o = jax.tree.map(sel, new, old)
        mu_o = jnp.where(frozen, mu_prev, mu_n)
        steps_o = nsteps + jnp.where(done, 0, 1).astype(jnp.int32)
        badc_o = jnp.where(done, badc, jnp.where(step_bad, badc + 1, 0))
        give_up = badc_o >= 4
        trace = dict(mu=mu_n, a=a, a_aff=a_a, sigma=sigma, rp=rp_inf,
                     rd=rd_inf, bad=step_bad) if debug_trace else None
        return (v_o, sl_o, zl_o, sq_o, zq_o,
                done | now_done | give_up, ok | now_done, mu_o, steps_o,
                badc_o), trace

    carry0 = (v0, sl0, zl0, sq0, zq0,
              jnp.asarray(False), jnp.asarray(False),
              jnp.asarray(1.0, dtype), jnp.asarray(0, jnp.int32),
              jnp.asarray(0, jnp.int32))
    if debug_trace:
        # fixed-length scan carrying the per-iteration diagnostics
        (v, sl, zl, sq, zq, done, ok, mu, nsteps, _), tr = lax.scan(
            lambda c, _: body(c), carry0, None, length=iters)
        stats = dict(mu=mu, iters=nsteps, converged=ok, trace=tr)
        return v, (sl, sq), (zl, zq), stats
    # while_loop exits as soon as `done` latches (converged or gave up):
    # a generous `iters` cap costs nothing on easy/warm solves
    v, sl, zl, sq, zq, done, ok, mu, nsteps, _ = lax.while_loop(
        lambda c: (~c[5]) & (c[8] < iters), lambda c: body(c)[0], carry0)
    stats = dict(mu=mu, iters=nsteps, converged=ok)
    return v, (sl, sq), (zl, zq), stats
