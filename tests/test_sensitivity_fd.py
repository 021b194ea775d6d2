"""Finite-difference sensitivity oracle (own module for xdist overlap
— suite-time budget)."""

import numpy as np
import jax
import jax.numpy as jnp
import scipy.optimize as sopt
from pmpc_tpu.sensitivity import (
    SensProblem,
    all_sensitivity_L,
    masked_rollout,
    nonlinear_rollout,
    sensitivity_L,
)
from fixtures import unicycle_step
from test_sensitivity import _solve_smooth


def test_sensitivity_L_matches_finite_difference():
    """dU*/dx0 from the IFT must match re-solving at a perturbed x0 (the
    finite-difference validation strategy of sens_test.jl:66-101)."""
    N, xdim, udim = 6, 4, 2
    base = SensProblem(
        x0=jnp.ones(xdim),
        Q=jnp.tile(jnp.eye(xdim), (N, 1, 1)),
        R=jnp.tile(0.1 * jnp.eye(udim), (N, 1, 1)),
        X_ref=jnp.zeros((N, xdim)), U_ref=jnp.zeros((N, udim)),
        reg_x=jnp.asarray(0.0), reg_u=jnp.asarray(0.0),
        u_l=-2.0 * jnp.ones((N, udim)), u_u=2.0 * jnp.ones((N, udim)),
        slew_reg=jnp.asarray(0.0), smooth_alpha=jnp.asarray(20.0),
    )
    U_star = _solve_smooth(unicycle_step, base, N, udim)
    X_star = nonlinear_rollout(unicycle_step, base.x0, U_star)
    L = sensitivity_L(unicycle_step, base, U_star, X_star, t=0)

    eps = 1e-5
    for k in range(xdim):
        dx = jnp.zeros(xdim).at[k].set(eps)
        Up = _solve_smooth(unicycle_step, base._replace(x0=base.x0 + dx), N, udim)
        Um = _solve_smooth(unicycle_step, base._replace(x0=base.x0 - dx), N, udim)
        fd = np.asarray((Up - Um) / (2 * eps))
        np.testing.assert_allclose(np.asarray(L)[:, :, k], fd, atol=5e-4,
                                   err_msg=f"x0 component {k}")
