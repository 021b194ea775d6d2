"""Placement of the persistent compilation cache (`pmpc_tpu/__init__.py`):
JAX_COMPILATION_CACHE_DIR when it is set, else the checkout's .jax_cache."""

import os
import subprocess
import sys

import pmpc_tpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import jax, pmpc_tpu
print(jax.config.jax_compilation_cache_dir)
print(jax.config.jax_persistent_cache_min_compile_time_secs)
jax.block_until_ready(jax.jit(lambda x: x * 2.0 + 1.0)(jax.numpy.ones(3)))
"""


def _probe(tmp_path, **env_over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "PMPC_TPU_NO_CACHE")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **env_over)
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout.split()


def test_cache_dir_is_the_checkouts_own():
    assert pmpc_tpu.CACHE_DIR == os.path.join(ROOT, ".jax_cache")


def test_cache_defaults_to_checkout_dir(tmp_path):
    cache_dir, _ = _probe(tmp_path, HOME=str(tmp_path))
    assert cache_dir == os.path.join(ROOT, ".jax_cache")
    assert os.path.isdir(cache_dir)
    assert not (tmp_path / ".cache").exists()  # nothing under HOME


def test_cache_env_var_wins_and_nothing_else_is_set(tmp_path):
    target = tmp_path / "cc"
    cache_dir, min_secs = _probe(
        tmp_path, HOME=str(tmp_path), JAX_COMPILATION_CACHE_DIR=str(target),
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
        JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1")
    assert cache_dir == str(target)
    assert float(min_secs) == 0.0  # the environment's, not the package's 0.5
    assert any(target.iterdir())  # the compiled program landed there
    assert not (tmp_path / ".cache").exists()


def test_no_cache_switch(tmp_path):
    cache_dir, _ = _probe(tmp_path, PMPC_TPU_NO_CACHE="1")
    assert cache_dir == "None"
