"""The examples/ scripts must stay runnable (FAST smoke mode)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["simple_demo.py", "batch_solver.py"]


def run_example(script):
    """Shared runner (test_examples2.py covers the other half of the
    examples so xdist loadscope spreads the ~25-35s subprocesses across
    workers — suite-time budget)."""
    env = dict(os.environ, PMPC_EXAMPLES_FAST="1", JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script)],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert r.returncode == 0, f"{script} failed:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}"


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_runs(script):
    run_example(script)
