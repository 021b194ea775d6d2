"""Farm workers and cards (`pmpc_tpu.remote`): one worker per GPU, pinned
before JAX starts, and a clear refusal when workers outnumber cards."""

import os
import subprocess
import sys

import pytest

from pmpc_tpu import remote

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_workers_get_one_card_each():
    assert remote.worker_devices(2, ["0", "1", "2"]) == ["0", "1"]
    assert remote.worker_devices(3, ["4", "6", "7"]) == ["4", "6", "7"]


def test_cpu_farm_pins_nothing():
    assert remote.worker_devices(3, []) == [None, None, None]


def test_more_workers_than_cards_is_refused():
    with pytest.raises(ValueError, match="exceeds the 1 visible GPU"):
        remote.worker_devices(2, ["0"])


def test_visible_gpus_reads_cuda_visible_devices(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3, 5")
    assert remote.visible_gpus() == ["3", "5"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert remote.visible_gpus() == []


def test_visible_gpus_none_when_held_to_cpu(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    assert remote.visible_gpus() == []


def test_pin_worker_device(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    remote.pin_worker_device(None)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0,1,2,3"
    remote.pin_worker_device("2")
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "2"


def test_cli_refuses_more_workers_than_cards():
    env = dict(os.environ, JAX_PLATFORMS="", CUDA_VISIBLE_DEVICES="0")
    r = subprocess.run(
        [sys.executable, "-m", "pmpc_tpu.remote", "--worker-num", "2",
         "--no-warmup"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 2
    assert "exceeds the 1 visible GPU" in r.stderr
