"""pmpc_tpu: a particle sequential-convex-programming MPC engine in JAX.

A from-scratch JAX/XLA implementation with the capabilities of the
reference StanfordASL/pmpc library: nonlinear finite-horizon MPC via SCP with
consensus optimization over M sampled dynamics particles, convex-cone
constraints, and arbitrary linearized costs — with the convex subproblems
solved by batched on-device structured solvers instead of CPU ECOS/OSQP.

Public API parity with ``pmpc/__init__.py``: ``solve``, ``scp_solve``,
``Problem``, ``SOLVE_KWS``, plus ``accelerated_scp_solve``, ``tune_scp``,
``solve_problems``, and the ``remote`` farm module.
"""

import os

# the checkout's own cache directory, used when JAX_COMPILATION_CACHE_DIR is
# unset (a fixed path: the cache key includes it, so a moving one never hits)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _setup_compilation_cache():
    """Persistent XLA compilation cache (AOT-parity: stands in for the
    reference's PackageCompiler sysimage, ``build_pmpc_lib.jl:42-49``).

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is left
    alone; otherwise the cache goes to `CACHE_DIR`. ``PMPC_TPU_NO_CACHE=1``
    turns it off."""
    import jax

    if os.environ.get("PMPC_TPU_NO_CACHE") == "1":
        return
    if os.environ.get("JAX_COMPILATION_CACHE_DIR") or \
            jax.config.jax_compilation_cache_dir:
        return
    try:
        os.makedirs(CACHE_DIR, exist_ok=True)
    except OSError:  # read-only install: the cache is an optimization only
        return
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_setup_compilation_cache()

from .scp import (  # noqa: F401
    aff_solve,
    scp_solve,
    solve,
    solve_with_a_dict,
)
from .problem import Problem  # noqa: F401
from .dynamics import linearize, make_f_fx_fu_fn, rollout  # noqa: F401
from .canonical import lqp_generate_problem_matrices  # noqa: F401

__version__ = "0.1.0"

# Keyword-compatible arguments of `solve` (parity with pmpc/__init__.py:5-31).
SOLVE_KWS = {
    "X_ref",
    "U_ref",
    "X_prev",
    "U_prev",
    "x_l",
    "x_u",
    "u_l",
    "u_u",
    "verbose",
    "debug",
    "max_it",
    "time_limit",
    "res_tol",
    "reg_x",
    "reg_u",
    "slew_rate",
    "u_slew",
    "u0_slew",
    "cost_fn",
    "lin_cost_fn",
    "diff_cost_fn",  # ours: accepted directly by solve (reference: experimental-only)
    "extra_cstrs_fns",
    "method",
    "solver_settings",
    "solver_state",
    "filter_method",
    "filter_window",
    "filter_it0",
}


def __getattr__(name):
    # lazy imports to keep base import light
    if name == "accelerated_scp_solve":
        from .accelerated import accelerated_scp_solve

        return accelerated_scp_solve
    if name == "tune_scp":
        from .tune import tune_scp

        return tune_scp
    if name == "solve_problems":
        from .batch import solve_problems

        return solve_problems
    if name == "remote":
        import importlib
        import sys as _sys

        mod = _sys.modules.get(__name__ + ".remote")
        if mod is None:
            mod = importlib.import_module(".remote", __name__)
        return mod
    raise AttributeError(f"module 'pmpc_tpu' has no attribute {name!r}")
