"""Batched cone solves, SOC-heavy half (own module so xdist loadscope
spreads the conebatch battery across workers — suite-time budget)."""

import numpy as np

import pmpc_tpu
from pmpc_tpu.batch import solve_problems
from test_conebatch import _mk_problem, _extras_row


def test_batched_cvar_respects_cones_and_consensus():
    M, N = 4, 8
    B = 4
    probs = [_mk_problem(10 + i, M=M, N=N, k=2,
                         u_soc_r=np.full((M, N), 0.7)) for i in range(B)]
    out = solve_problems(probs, fused=True)
    for X, U, d in out:
        assert np.isfinite(U).all()
        assert np.linalg.norm(U, axis=-1).max() <= 0.7 + 1e-6
        assert np.ptp(U[:, :3], axis=0).max() < 1e-7  # Nc=3 consensus
    # batched CVaR tracks the serial solution on the DETERMINED variables:
    # the consensus block (non-worst particles' free controls are loosely
    # determined by the k-worst objective, so exact-U equality is not a
    # property of the problem)
    i = 1
    Xs, Us, _ = pmpc_tpu.solve(**{k: v for k, v in probs[i].items()})
    np.testing.assert_allclose(out[i][1][:, :3], Us[:, :3], atol=2e-3)


def test_batched_linear_extras_usoc_structured_route():
    """Linear extras + per-stage control cones batch on the STRUCTURED arrow
    IPM (vmapped `ipm_core` with `ExtraRows` borders) — the dense composed
    cone program must not be built at all, and the result matches serial."""
    import pmpc_tpu.solvers.compose as compose

    M, N, xdim, udim, Nc = 3, 8, 4, 2, 3
    B = 4
    probs = [dict(_mk_problem(30 + i, M=M, N=N),
                  solver_settings=dict(
                      Nc=Nc, u_soc_r=np.full((M, N), 0.8),
                      extra_cstrs=[
                          _extras_row(M, N, xdim, udim, Nc, 0.1 + 0.05 * i)]))
             for i in range(B)]

    orig = compose.composed_solve_batch_device

    def boom(*a, **k):
        raise AssertionError("linear extras + u_soc must not densify "
                             "through the composed cone path")

    compose.composed_solve_batch_device = boom
    try:
        out = solve_problems(probs, fused=True)
    finally:
        compose.composed_solve_batch_device = orig

    assert len(out) == B
    for i, (X, U, d) in enumerate(out):
        assert d["converged"], (i, d)
        assert U[0, 0].sum() <= 0.1 + 0.05 * i + 1e-5
        assert np.linalg.norm(U, axis=-1).max() <= 0.8 + 1e-5
        assert np.ptp(U[:, :Nc], axis=0).max() < 1e-6  # consensus
    i = 1
    Xs, Us, ds = pmpc_tpu.solve(**{k: v for k, v in probs[i].items()})
    np.testing.assert_allclose(out[i][1], Us, atol=2e-4)


import pytest


@pytest.mark.nightly
@pytest.mark.parametrize("seed", range(900, 906))
def test_fuzz_batched_struct_matches_serial(seed):
    """Nightly fuzz: random mixes of boxes / per-stage control cones /
    linear extras / weights across a batch must match each problem's serial
    solve (the batched structured route shares no code with the serial
    dispatch above the IPM)."""
    rng = np.random.default_rng(seed)
    M, N, xdim, udim = 3, 8, 4, 2
    B = 3
    use_soc = bool(rng.integers(2))
    use_lin = bool(rng.integers(2)) or not use_soc
    use_w = bool(rng.integers(2))
    probs = []
    for b in range(B):
        ss = dict(Nc=3)
        if use_soc:
            ss["u_soc_r"] = np.full((M, N), 0.6 + 0.3 * rng.random())
        if use_w:
            ss["weights"] = 1.0 + rng.uniform(0, 2, size=M)
        p = dict(_mk_problem(int(rng.integers(1e6)), M=M, N=N),
                 solver_settings=ss)
        if use_lin:
            nu_total = 3 * udim + M * (N - 3) * udim
            n_full = nu_total + M * N * xdim
            g = np.zeros((1, n_full))
            g[0, :udim] = 1.0
            p["solver_settings"]["extra_cstrs"] = [
                (1, [], 0, g, np.zeros((1, 0)),
                 np.array([0.1 + 0.2 * rng.random()]),
                 np.zeros(n_full), np.zeros(0))]
        probs.append(p)
    out = solve_problems(probs, fused=True)
    i = int(rng.integers(B))
    Xs, Us, ds = pmpc_tpu.solve(**{k: v for k, v in probs[i].items()})
    assert out[i][2]["converged"], out[i][2]
    np.testing.assert_allclose(out[i][1], Us, atol=5e-4)
