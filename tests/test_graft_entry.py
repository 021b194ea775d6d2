"""Driver contract: entry() compiles and runs; dryrun_multichip works on the
virtual mesh; experimental shim parity."""

import numpy as np
import jax
import pytest


def test_entry_compiles_and_runs():
    import __graft_entry__ as g

    fn, args = g.entry()
    X, U, info = jax.jit(fn)(*args)
    jax.block_until_ready(U)
    assert np.isfinite(np.asarray(U)).all()
    assert np.asarray(U).max() <= 1.0 + 1e-5


def test_dryrun_multichip():
    import __graft_entry__ as g

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    # the 8-device mesh covers the (batch x particle) partitioning and all
    # three shard checks; a second full dryrun at another size doubled the
    # module's compile cost for no new coverage (the driver separately
    # exercises dryrun at its own device count every round)
    g.dryrun_multichip(8)


def test_experimental_shim():
    from pmpc_tpu import experimental
    from fixtures import dubins_f_fx_fu_fn

    N, xdim, udim = 10, 4, 2
    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(1e-2 * np.eye(udim), (N, 1, 1))
    X, U, data = experimental.scp_solve(
        dubins_f_fx_fu_fn(), Q, R, np.ones(xdim),
        u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)),
        max_it=10, verbose=False,
    )
    assert X.shape == (N + 1, xdim)
    # smoothed constraints: strictly interior
    assert np.abs(U).max() < 1.0

    with pytest.raises(ValueError):
        experimental.scp_solve(
            dubins_f_fx_fu_fn(), Q, R, np.ones(xdim),
            extra_cstrs_fns=lambda *a: [], max_it=2,
        )
