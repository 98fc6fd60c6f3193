"""The port's device reachability (``utils/platform.py``'s second half)
against the JAX package's.

The probe subprocess counts ``torch.cuda.device_count()`` under a hard
timeout; a crash or a timeout counts as 0.  Here there is no card, so a
probe gives 0, ``require_reachable_device`` exits with code 2, and each
attempt leaves a record in ``probe_history`` (and, with telemetry on,
a ``device_probe`` counter and decision event), as in the JAX package.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from veles.simd_tpu.utils import platform as jplat
from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.utils import config
from veles.simd_tpu_torch.utils import platform as plat

REPO = Path(__file__).resolve().parent.parent
# the JAX package's platform names that exist for JAX's platform
# plugins only (ROADMAP lists them as not applicable to the port)
JAX_ONLY = {"set_cpu_env", "pin_cpu", "cpu_devices",
            "maybe_override_platform"}


@pytest.fixture(autouse=True)
def _history():
    plat.reset_probe_history()
    yield
    plat.reset_probe_history()


def test_all_is_the_jax_all_without_the_jax_only_names():
    shared = [n for n in jplat.__all__ if n not in JAX_ONLY]
    assert plat.__all__[:len(shared)] == shared
    for name in JAX_ONLY:
        assert not hasattr(plat, name)
    for name in plat.__all__:
        assert hasattr(plat, name)


def test_probe_counts_no_card_here():
    assert plat.probe_device_count(timeout=120.0) == 0


def test_probe_timeout_counts_zero():
    count, detail = plat._probe_subprocess(timeout=0.01)
    assert count == 0
    assert "timed out" in detail


def test_probe_crash_counts_zero(monkeypatch):
    def crash(*a, **k):
        raise OSError("exec failed")

    monkeypatch.setattr(plat.subprocess, "run", crash)
    count, detail = plat._probe_subprocess(timeout=5.0)
    assert count == 0 and "failed" in detail


def test_require_reachable_device_exits_2_and_records(capsys):
    obs.enable()
    obs.reset()
    try:
        with pytest.raises(SystemExit) as e:
            plat.require_reachable_device(timeout=60.0, wait=0)
        assert e.value.code == 2
        hist = plat.probe_history()
        assert len(hist) == 1
        rec = hist[0]
        assert set(rec) == {"attempt", "ok", "devices", "detail",
                            "waited_s", "unix"}
        assert (rec["attempt"], rec["ok"], rec["devices"]) == (1, False, 0)
        assert obs.counter_value("device_probe",
                                 outcome="unreachable") == 1
        assert [e["decision"] for e in obs.events()
                if e["op"] == "device_probe"] == ["unreachable"]
        assert "no CUDA card reachable" in capsys.readouterr().err
    finally:
        obs.disable()
        obs.reset()


def test_wait_budget_reprobes_until_a_card_appears(monkeypatch):
    calls = []

    def fake_probe(timeout):
        calls.append(timeout)
        return (0, "wedged") if len(calls) < 3 else (1, "")

    monkeypatch.setattr(plat, "_probe_subprocess", fake_probe)
    monkeypatch.setattr(plat.time, "sleep", lambda s: None)
    plat.require_reachable_device(wait=3600.0)
    assert len(calls) == 3
    assert [r["ok"] for r in plat.probe_history()] == [False, False, True]
    # VELES_SIMD_DEVICE_WAIT=0 overrides the caller's wait: fail fast
    calls.clear()
    monkeypatch.setattr(plat, "_probe_subprocess", lambda t: (0, "gone"))
    monkeypatch.setenv("VELES_SIMD_DEVICE_WAIT", "0")
    with pytest.raises(SystemExit):
        plat.require_reachable_device(wait=3600.0)


def test_malformed_wait_warns_and_keeps_the_callers(monkeypatch, capsys):
    monkeypatch.setattr(plat, "_probe_subprocess", lambda t: (1, ""))
    monkeypatch.setenv("VELES_SIMD_DEVICE_WAIT", "soon")
    plat.require_reachable_device(wait=5)
    assert "malformed VELES_SIMD_DEVICE_WAIT" in capsys.readouterr().err


def test_history_record_matches_jax(monkeypatch):
    jplat.reset_probe_history()
    jplat._note_probe(2, 0, "x" * 400, 1.23456)
    plat._note_probe(2, 0, "x" * 400, 1.23456)
    want = {k: v for k, v in jplat.probe_history()[0].items()
            if k != "unix"}
    got = {k: v for k, v in plat.probe_history()[0].items()
           if k != "unix"}
    assert got == want
    jplat.reset_probe_history()
    for i in range(70):
        plat._note_probe(i, 1, "", 0.0)
    assert len(plat.probe_history()) == 64


def test_init_deadline_passes_a_quick_block(monkeypatch):
    with plat.init_deadline(60.0):
        pass
    monkeypatch.setenv("VELES_SIMD_INIT_DEADLINE", "0")
    with plat.init_deadline(0.001):     # disabled: no watchdog
        pass


def test_init_deadline_exits_a_wedged_block():
    code = ("import sys, time; sys.modules['jax'] = None\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "from veles.simd_tpu_torch.utils import platform as p\n"
            "with p.init_deadline(0.3, what='demo init'):\n"
            "    time.sleep(30)\n")
    env = dict(os.environ)
    env.pop("VELES_SIMD_INIT_DEADLINE", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "demo init did not complete" in out.stderr


def test_init_deadline_env_overrides(monkeypatch):
    code = ("import sys, time; sys.modules['jax'] = None\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "from veles.simd_tpu_torch.utils import platform as p\n"
            "with p.init_deadline(3600):\n"
            "    time.sleep(30)\n")
    env = dict(os.environ, VELES_SIMD_INIT_DEADLINE="0.3")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2


def test_to_host_and_to_device_round_trip():
    prev = config.get_config()
    config.set_config(device="cpu")
    try:
        x = np.arange(6, dtype=np.float64).reshape(2, 3)
        t = plat.to_device(x)
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float64
        assert plat.to_device(x, np.float32).dtype == torch.float32
        assert plat.to_device(t) is t
        assert plat.to_device(t, torch.float32).dtype == torch.float32
        c = np.array([1 + 2j, 3 - 4j], np.complex64)
        np.testing.assert_array_equal(plat.to_host(plat.to_device(c)), c)
        np.testing.assert_array_equal(plat.to_host(t), x)
        assert plat.to_host(x) is x
        np.testing.assert_array_equal(
            plat.to_host(np.asarray(jplat.to_host(c))), c)
    finally:
        config.set_config(device=prev.device)


def test_to_device_without_a_card_raises():
    prev = config.get_config()
    config.set_config(device="cuda")
    try:
        with pytest.raises(RuntimeError, match="is_available"):
            plat.to_device(np.zeros(2))
    finally:
        config.set_config(device=prev.device)
