import pytest

import jax

# Tests compare against float64 numpy oracles; the library itself is
# dtype-generic (float32 on the accelerator).
jax.config.update("jax_enable_x64", True)
# An 8-device virtual CPU mesh for the sharding tests. It must be set before
# any backend starts, so here, before a test module touches a device.
jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules.

    The XLA:CPU compiler in this jaxlib crashes (SIGSEGV/SIGABRT inside
    backend_compile_and_load) once a single process has accumulated roughly
    the full suite's worth of compiled programs — reproducibly at the same
    suite position, never in any half-suite subset, and not attributable to
    heap corruption (ASan/MALLOC_CHECK clean). Clearing caches per module
    keeps the live-executable count below the trigger."""
    yield
    jax.clear_caches()
