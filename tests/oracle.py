"""Dense numpy oracle for the consensus QP canonical form.

Independent re-derivation of the reference's canonical-form math
(``PMPC.jl/src/lqp_utils.jl``): variable layout

    z = [u_cons (Nc*udim); u_free_1 ((N-Nc)*udim); ...; u_free_M; x_1 (N*xdim); ...; x_M]

objective 0.5 z'Pz + q'z, dynamics equality A z = b, optional box bounds.
Solved with dense KKT (equality-only) or scipy trust-constr (with bounds),
used as the golden reference for the on-device solver's outputs.
"""

from __future__ import annotations

import numpy as np


def layout(N, xdim, udim, M, Nc):
    nc = Nc * udim
    nf = (N - Nc) * udim
    nu_total = nc + M * nf
    n = nu_total + M * N * xdim

    def u_idx(i, j):  # particle i, step j -> slice of z for u_{i,j}
        if j < Nc:
            return slice(j * udim, (j + 1) * udim)
        s = nc + i * nf + (j - Nc) * udim
        return slice(s, s + udim)

    def x_idx(i, j):
        s = nu_total + i * N * xdim + j * xdim
        return slice(s, s + xdim)

    return n, u_idx, x_idx


def build_Pq(
    x0, f, fx, fu, X_prev, U_prev, Q, R, X_ref, U_ref,
    reg_x, reg_u, slew_reg, slew_reg0, slew_um1, Nc,
):
    """P, q of the consensus QP. All inputs batched over particles (M leading)."""
    M, N, xdim = f.shape
    udim = fu.shape[-1]
    reg_x = np.broadcast_to(np.asarray(reg_x, dtype=float), (M,))
    reg_u = np.broadcast_to(np.asarray(reg_u, dtype=float), (M,))
    slew_reg = np.broadcast_to(np.asarray(slew_reg, dtype=float), (M,))
    slew_reg0 = np.broadcast_to(np.asarray(slew_reg0, dtype=float), (M,))
    slew_um1 = np.broadcast_to(np.asarray(slew_um1, dtype=float), (M, udim))
    n, u_idx, x_idx = layout(N, xdim, udim, M, Nc)
    P = np.zeros((n, n))
    q = np.zeros(n)
    for i in range(M):
        for j in range(N):
            ui = u_idx(i, j)
            P[ui, ui] += R[i, j] + reg_u[i] * np.eye(udim)
            q[ui] += -(R[i, j] @ U_ref[i, j] + reg_u[i] * U_prev[i, j])
            xi = x_idx(i, j)
            P[xi, xi] += Q[i, j] + reg_x[i] * np.eye(xdim)
            q[xi] += -(Q[i, j] @ X_ref[i, j] + reg_x[i] * X_prev[i, j])
        # slew: 0.5*slew_reg*sum_j ||u_{j+1}-u_j||^2 + 0.5*slew_reg0*||u_0 - slew_um1||^2
        for j in range(N - 1):
            a, b = u_idx(i, j), u_idx(i, j + 1)
            P[a, a] += slew_reg[i] * np.eye(udim)
            P[b, b] += slew_reg[i] * np.eye(udim)
            P[a, b] += -slew_reg[i] * np.eye(udim)
            P[b, a] += -slew_reg[i] * np.eye(udim)
        u0 = u_idx(i, 0)
        P[u0, u0] += slew_reg0[i] * np.eye(udim)
        q[u0] += -slew_reg0[i] * slew_um1[i]
    return P, q


def build_Ab(x0, f, fx, fu, X_prev, U_prev, Nc):
    """Dynamics equality constraints A z = b (consensus layout)."""
    M, N, xdim = f.shape
    udim = fu.shape[-1]
    n, u_idx, x_idx = layout(N, xdim, udim, M, Nc)
    m = M * N * xdim
    A = np.zeros((m, n))
    b = np.zeros(m)
    for i in range(M):
        for j in range(N):
            r = slice((i * N + j) * xdim, (i * N + j + 1) * xdim)
            A[r, u_idx(i, j)] = fu[i, j]
            A[r, x_idx(i, j)] = -np.eye(xdim)
            rhs = -f[i, j] + fu[i, j] @ U_prev[i, j]
            if j > 0:
                A[r, x_idx(i, j - 1)] = fx[i, j]
                rhs += fx[i, j] @ X_prev[i, j - 1]
            b[r] = rhs
    return A, b


def bounds_vectors(x_l, x_u, u_l, u_u, N, xdim, udim, M, Nc):
    """Variable lower/upper bound vectors over z (np.inf where unbounded).

    Consensus controls take particle 0's bounds (parity with
    ``lqp_utils.jl:323-331`` which uses probs[1])."""
    n, u_idx, x_idx = layout(N, xdim, udim, M, Nc)
    lo, hi = -np.inf * np.ones(n), np.inf * np.ones(n)
    if u_l is not None and u_u is not None:
        for j in range(Nc):
            lo[u_idx(0, j)], hi[u_idx(0, j)] = u_l[0, j], u_u[0, j]
        for i in range(M):
            for j in range(Nc, N):
                lo[u_idx(i, j)], hi[u_idx(i, j)] = u_l[i, j], u_u[i, j]
    if x_l is not None and x_u is not None:
        for i in range(M):
            for j in range(N):
                lo[x_idx(i, j)], hi[x_idx(i, j)] = x_l[i, j], x_u[i, j]
    return lo, hi


def solve_eq_kkt(P, q, A, b):
    """Equality-constrained QP via dense KKT."""
    n, m = P.shape[0], A.shape[0]
    K = np.block([[P, A.T], [A, np.zeros((m, m))]])
    rhs = np.concatenate([-q, b])
    sol = np.linalg.solve(K, rhs)
    return sol[:n]


def solve_box_qp(P, q, A, b, lo, hi, tol=1e-10):
    """QP with equality constraints and variable bounds via scipy trust-constr."""
    import scipy.optimize as sopt

    n = P.shape[0]
    x0 = solve_eq_kkt(P, q, A, b)
    x0 = np.clip(x0, lo, hi)
    res = sopt.minimize(
        lambda z: 0.5 * z @ P @ z + q @ z,
        x0,
        jac=lambda z: P @ z + q,
        hess=lambda z: P,
        bounds=sopt.Bounds(lo, hi),
        constraints=[sopt.LinearConstraint(A, b, b)],
        method="trust-constr",
        options=dict(gtol=tol, xtol=tol, maxiter=3000),
    )
    return res.x


def split_z(z, N, xdim, udim, M, Nc):
    """z -> (X (M,N,xdim), U (M,N,udim))."""
    n, u_idx, x_idx = layout(N, xdim, udim, M, Nc)
    X = np.zeros((M, N, xdim))
    U = np.zeros((M, N, udim))
    for i in range(M):
        for j in range(N):
            U[i, j] = z[u_idx(i, j)]
            X[i, j] = z[x_idx(i, j)]
    return X, U


def random_problem(rng, M=3, N=8, xdim=4, udim=2, controllable=True):
    """A random well-conditioned linearized problem batch (particles only)."""
    x0 = rng.normal(size=(M, xdim))
    fx = 0.9 * np.tile(np.eye(xdim), (M, N, 1, 1)) + 0.1 * rng.normal(size=(M, N, xdim, xdim))
    fu = rng.normal(size=(M, N, xdim, udim))
    X_prev = rng.normal(size=(M, N, xdim))
    U_prev = rng.normal(size=(M, N, udim))
    f = rng.normal(size=(M, N, xdim))
    Qs = rng.normal(size=(M, N, xdim, xdim))
    Q = np.einsum("mnij,mnkj->mnik", Qs, Qs) / xdim + 0.5 * np.eye(xdim)
    Rs = rng.normal(size=(M, N, udim, udim))
    R = np.einsum("mnij,mnkj->mnik", Rs, Rs) / udim + 0.5 * np.eye(udim)
    X_ref = rng.normal(size=(M, N, xdim))
    U_ref = rng.normal(size=(M, N, udim))
    return dict(
        x0=x0, f=f, fx=fx, fu=fu, X_prev=X_prev, U_prev=U_prev,
        Q=Q, R=R, X_ref=X_ref, U_ref=U_ref,
    )
