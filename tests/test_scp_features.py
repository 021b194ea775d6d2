"""SCP loop feature parity: filters, min-violation tracking, debug, time limit."""

import time

import numpy as np

import pmpc_tpu
from pmpc_tpu.filters import AA_method, select_method, smooth_method
from fixtures import dubins_f_fx_fu_fn


def _args(N=10, xdim=4, udim=2):
    f_fn = dubins_f_fx_fu_fn()
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    return f_fn, Q, R, np.ones(xdim)


def test_filter_methods_weights():
    rng = np.random.default_rng(0)
    Fs = [rng.normal(size=20) for _ in range(4)]
    for method in (AA_method, smooth_method, select_method):
        w = method(Fs)
        assert w.shape == (4,)
        np.testing.assert_allclose(w.sum(), 1.0, atol=1e-8)
    # smooth is uniform
    np.testing.assert_allclose(smooth_method(Fs), 0.25)


def test_scp_filter_methods_run():
    for fm in ("AA", "smooth", "select"):
        X, U, data = pmpc_tpu.solve(
            *_args(), max_it=12, res_tol=1e-9, verbose=False,
            filter_method=fm, filter_it0=4, filter_window=3,
        )
        assert X is not None and np.isfinite(U).all(), fm


def test_return_min_viol():
    X, U, data = pmpc_tpu.solve(
        *_args(), max_it=8, res_tol=1e-9, verbose=False, return_min_viol=True,
    )
    assert "min_viol_sol" in data
    Xv, Uv = data["min_viol_sol"]
    assert Xv.shape == X.shape if Xv.ndim == X.ndim else True
    # the stored min-violation residual cannot exceed the last residual
    resids = [h["resid"] for h in data["hist"]]
    assert min(resids) <= resids[-1] + 1e-12


def test_debug_keeps_sol_hist():
    X, U, data = pmpc_tpu.solve(*_args(), max_it=4, verbose=False, debug=True)
    assert len(data["sol_hist"]) == len(data["hist"])
    X2, U2, data2 = pmpc_tpu.solve(*_args(), max_it=4, verbose=False, debug=False)
    assert "sol_hist" not in data2


def test_time_limit_stops_early():
    t0 = time.time()
    X, U, data = pmpc_tpu.solve(
        *_args(), max_it=10000, res_tol=0.0, time_limit=3.0, verbose=False,
    )
    assert time.time() - t0 < 30.0
    assert len(data["hist"]) < 10000


def test_verbose_table_output(capsys):
    pmpc_tpu.solve(*_args(), max_it=3, verbose=True)
    out = capsys.readouterr().out
    assert "resid" in out and "+---" in out


def test_host_path_warm_start_cuts_ipm_iterations():
    """solver_state threads the IPM primal/dual point across SCP iterations on
    the host path; later (slightly perturbed) subproblems must converge in
    fewer IPM iterations than the cold first solve."""
    f_fn, Q, R, x0 = _args(N=12)
    N, udim = 12, 2
    X, U, data = pmpc_tpu.solve(
        f_fn, Q, R, x0, max_it=8, res_tol=1e-9, verbose=False,
        u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
    )
    iters = [sd["ipm_iters"] for sd in data["solver_data"]]
    states = [sd["solver_state"] for sd in data["solver_data"]]
    assert all(st is not None and "ipm_warm" in st for st in states)
    # warm-started refinement iterations beat the cold start
    assert min(iters[1:]) < iters[0], iters


def test_registered_function_cache():
    from pmpc_tpu.remote import RegisteredFunction

    calls = []

    def fn(x):
        calls.append(x)
        return x * 2

    rf = RegisteredFunction(fn)
    assert rf(3) == 6
    rf2 = RegisteredFunction(fn)
    assert rf2(4) == 8  # dispatches through the registry by hash
    assert calls == [3, 4]


def test_f32_stall_guardrail_triggers_and_stays_silent():
    """The documented f32 failure signature (SCP residual plateau >=10x
    res_tol, the f32 envelope of benchmarks/accuracy_sweep.py) must surface as
    data['f32_stall_suspected'] + a RuntimeWarning suggesting f64; a
    well-conditioned f32 solve must stay silent."""
    import warnings

    import pmpc_tpu
    from fixtures import dubins_f_fx_fu_fn

    f_fn = dubins_f_fx_fu_fn()
    xdim, udim = 4, 2

    # hard instance from the envelope sweep class: N=36, M=8, scattered x0
    M, N = 8, 36
    rng = np.random.default_rng(11)
    Q = np.tile(np.eye(xdim), (M, N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (M, N, 1, 1))
    x0 = np.concatenate([rng.normal(size=(M, 2)) * 2.0,
                         1.0 + 0.3 * rng.normal(size=(M, 1)),
                         rng.normal(size=(M, 1))], axis=1)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        X, U, d = pmpc_tpu.solve(
            f_fn, Q, R, x0, max_it=25, res_tol=1e-5, verbose=False,
            u_l=-np.ones((M, N, udim)), u_u=np.ones((M, N, udim)),
            solver_settings=dict(dtype=np.float32))
    assert d.get("f32_stall_suspected") is True
    assert any("float64" in str(x.message) for x in w)

    # easy instance: converges in f32, no flag, no warning
    M2, N2 = 2, 10
    Q2 = np.tile(np.eye(xdim), (M2, N2, 1, 1))
    R2 = np.tile(1e-2 * np.eye(udim), (M2, N2, 1, 1))
    with warnings.catch_warnings(record=True) as w2:
        warnings.simplefilter("always")
        X2, U2, d2 = pmpc_tpu.solve(
            f_fn, Q2, R2, np.ones((M2, xdim)), max_it=20, res_tol=1e-4,
            verbose=False, solver_settings=dict(dtype=np.float32))
    assert "f32_stall_suspected" not in d2
    assert not any("plateaued" in str(x.message) for x in w2)
