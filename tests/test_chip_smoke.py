"""The parts of `chip_smoke.py` that a CPU can check: it refuses to run
without a GPU, its last line's format, which phases each mode runs, and the
sharded phase's comparison on the virtual CPU mesh at a tiny size."""

import json
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu()


def _fake_run(monkeypatch, argv):
    """Run main() with the device phase and the phases stubbed; return the
    requested device count, the phases run, and main's return code."""
    ran, asked = [], []

    def fake_device(count=1):
        asked.append(count)
        return {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                "count": count}

    def stub(name):
        def phase():
            ran.append(name)
        phase.__name__ = name
        return phase

    real_phases = chip_smoke.phases
    monkeypatch.setattr(chip_smoke, "phase_device", fake_device)
    monkeypatch.setattr(chip_smoke, "phases", lambda four: [
        stub(p.__name__) for p in real_phases(four)])
    return asked, ran, chip_smoke.main(argv)


def test_last_line_is_the_result_object(monkeypatch, capsys):
    asked, ran, rc = _fake_run(monkeypatch, [])
    assert rc == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {
        "ok": True, "device": {"platform": "gpu",
                               "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert asked == [1]
    assert ran == ["phase_factor", "phase_fused", "phase_host"]


def test_four_runs_only_the_sharded_phase(monkeypatch, capsys):
    asked, ran, rc = _fake_run(monkeypatch, ["--four"])
    assert rc == 0
    assert asked == [4]
    assert ran == ["phase_sharded"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"]["count"] == 4
    assert chip_smoke.phase_sharded not in chip_smoke.phases(False)


def test_sharded_phase_on_virtual_mesh():
    """The --four comparison (4x1 and 2x2 meshes, condensed and Riccati,
    against the unsharded vmap) on four virtual CPU devices, tiny shapes."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    out = chip_smoke.phase_sharded(B=8, M=4, N=8, reps=1)
    checked = sorted(k for k in out if k.startswith("float64"))
    assert checked == ["float64 condensed 2x2", "float64 condensed 4x1",
                       "float64 riccati 2x2", "float64 riccati 4x1"]
    assert all(out[k]["err"] <= 1e-9 for k in checked)
    assert "float32 condensed 2x2" in out and "float32 sensitivity" in out


def test_factor_phase_checks_each_route():
    out = chip_smoke.phase_factor(shapes=((16, 12),), reps=1)
    assert len(out) == 2 * 2  # two routes x two precisions
    assert all(v["resid_max"] <= chip_smoke.FACTOR_TOL for v in out.values())
