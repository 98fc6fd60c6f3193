"""``bench_torch.py``'s stage supervision and fault policy, on the CPU.

The eight cases of ``tests/test_bench_stages.py`` and the five
stage-fault cases of ``tests/test_faults.py`` (``TestBenchStageRetry``)
against ``bench_torch`` with its configs stubbed: a stalled stage is
skipped and recorded and the rest still run, a transient device fault
is retried, a deterministic error is not, the headline's floor flags a
regression.  A ``bench_torch`` details file then goes through the
unchanged ``tools/bench_regress.py``.
"""

import dataclasses
import importlib.util
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench_torch  # noqa: E402
import tools.tpu_smoke_torch as smoke  # noqa: E402
from veles.simd_tpu_torch import obs  # noqa: E402
from veles.simd_tpu_torch.runtime import faults  # noqa: E402
from veles.simd_tpu_torch.utils import config  # noqa: E402

HEADLINE = "convolve 1M x 2047 overlap-save"

_SPEC = importlib.util.spec_from_file_location(
    "bench_regress", REPO / "tools" / "bench_regress.py")
bench_regress = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(bench_regress)


@pytest.fixture(autouse=True)
def _restore():
    prev = config.get_config()
    yield
    config.set_config(**dataclasses.asdict(prev))
    obs.reset()
    obs.disable()


@pytest.fixture
def telemetry():
    obs.enable()
    obs.reset()
    yield


def _runner(timeout, retries=None):
    dog = bench_torch._StageWatchdog(0)      # backstop disabled in tests
    return bench_torch._StageRunner(timeout, dog, retries=retries)


def _quick(name):
    def cfg(rng):
        return {"metric": name, "unit": "u", "value": 2.0,
                "baseline": 1.0}
    cfg.__name__ = name
    return cfg


def _stub_configs(monkeypatch, tmp_path, timeout="5"):
    """Every config stubbed, one passing smoke family, the CPU, the
    details file in ``tmp_path``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("VELES_SIMD_PLATFORM", "cpu")
    monkeypatch.setenv("VELES_SIMD_STAGE_TIMEOUT", timeout)
    monkeypatch.setenv("VELES_SIMD_DEVICE_WAIT", "0")
    monkeypatch.setattr(bench_torch, "_warm_device", lambda *a, **k: None)
    for name in bench_torch.CONFIGS:
        monkeypatch.setattr(bench_torch, name, _quick(name))
    monkeypatch.setattr(smoke, "FAMILIES",
                        [("fam_ok", lambda rng: (0.0, 1.0))])
    monkeypatch.setattr(sys, "argv", ["bench_torch.py"])


def _main():
    with np.errstate(all="ignore"):
        try:
            bench_torch.main()
            return 0
        except SystemExit as e:
            return e.code


def _details(tmp_path):
    return json.loads((tmp_path / bench_torch.DETAILS).read_text())


# ---------------------------------------------------------------------------
# the eight cases of tests/test_bench_stages.py
# ---------------------------------------------------------------------------

def test_ok_stage_returns_result():
    r = _runner(5.0)
    ok, res = r.run("fine", lambda: 42)
    assert ok and res == 42 and r.skipped == []


def test_wedged_stage_is_skipped_and_rest_continue():
    r = _runner(0.2)
    release = threading.Event()
    ok, res = r.run("wedge", release.wait)        # blocks past budget
    assert not ok and res is bench_torch._StageRunner._WEDGED
    ok2, res2 = r.run("after", lambda: "ran")
    assert ok2 and res2 == "ran"
    assert [s["stage"] for s in r.skipped] == ["wedge"]
    assert "wedged" in r.skipped[0]["reason"]
    release.set()


def test_raising_stage_is_recorded_not_fatal():
    r = _runner(5.0)

    def boom():
        raise RuntimeError("kaput")

    ok, err = r.run("boom", boom)
    assert not ok and isinstance(err, RuntimeError)
    assert r.skipped[0]["stage"] == "boom"
    assert "kaput" in r.skipped[0]["reason"]


def test_unsupervised_mode_runs_inline():
    r = _runner(0)
    main_thread = threading.current_thread()
    seen = {}

    def probe():
        seen["thread"] = threading.current_thread()
        return 7

    ok, res = r.run("inline", probe)
    assert ok and res == 7 and seen["thread"] is main_thread


def test_slow_but_within_budget_is_not_skipped():
    r = _runner(2.0)
    ok, res = r.run("slowish", lambda: (time.sleep(0.05), "done")[1])
    assert ok and res == "done" and r.skipped == []


def test_main_records_skips_in_json_tail(monkeypatch, tmp_path, capsys):
    """A stalled headline is skipped (a null JSON line, rc 2), the
    other configs and the smoke still run, and the skips land in the
    details file's tail."""
    _stub_configs(monkeypatch, tmp_path, timeout="1")
    release = threading.Event()
    monkeypatch.setattr(bench_torch, "bench_convolve_1m",
                        lambda rng: (release.wait(), None)[1])

    def boom(rng):
        raise RuntimeError("config kaput")

    boom.__name__ = "bench_dwt"
    monkeypatch.setattr(bench_torch, "bench_dwt", boom)
    try:
        rc = _main()
    finally:
        release.set()
    assert rc == 2
    out = capsys.readouterr().out
    line = json.loads(out.strip().splitlines()[0])
    assert line["value"] is None and "skipped" in line
    details = _details(tmp_path)
    metrics = [d.get("metric") for d in details if "metric" in d]
    assert metrics == [n for n in bench_torch.CONFIGS if n != "bench_dwt"]
    tail = details[-1]
    stages = [s["stage"] for s in tail["skipped_stages"]]
    assert "headline:convolve_1m" in stages
    assert "config:bench_dwt" in stages
    reasons = {s["stage"]: s["reason"] for s in tail["skipped_stages"]}
    assert "wedged" in reasons["headline:convolve_1m"]
    assert "kaput" in reasons["config:bench_dwt"]


def _run_main_with_headline(monkeypatch, tmp_path, vs_baseline):
    _stub_configs(monkeypatch, tmp_path)
    monkeypatch.setattr(
        bench_torch, "bench_convolve_1m",
        lambda rng: {"metric": HEADLINE, "unit": "Msamples/s",
                     "value": float(vs_baseline), "baseline": 1.0})
    return _main()


def test_headline_below_floor_warns_and_flags(monkeypatch, tmp_path,
                                              capsys):
    rc = _run_main_with_headline(
        monkeypatch, tmp_path, bench_torch.HEADLINE_VS_BASELINE_FLOOR - 10)
    assert rc == 0
    captured = capsys.readouterr()
    assert "BENCH-WARN" in captured.err
    # the headline's JSON line is the first line on stdout
    first = json.loads(captured.out.strip().splitlines()[0])
    assert first["metric"] == HEADLINE and first["unit"] == "Msamples/s"
    head = [d for d in _details(tmp_path) if d.get("metric") == HEADLINE]
    assert head and head[0].get("headline_regressed") is True


def test_headline_at_floor_not_flagged(monkeypatch, tmp_path, capsys):
    rc = _run_main_with_headline(
        monkeypatch, tmp_path, bench_torch.HEADLINE_VS_BASELINE_FLOOR + 10)
    assert rc == 0
    assert "BENCH-WARN" not in capsys.readouterr().err
    head = [d for d in _details(tmp_path) if d.get("metric") == HEADLINE]
    assert head and "headline_regressed" not in head[0]
    assert head[0]["device"] == "cpu"


# ---------------------------------------------------------------------------
# the five stage-fault cases of tests/test_faults.py
# ---------------------------------------------------------------------------

class TestBenchStageRetry:
    def test_transient_stage_fault_is_retried(self, telemetry):
        r = _runner(5.0, retries=2)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) == 1:
                raise faults.make_fault("device_lost", "stage")
            return "recovered"

        ok, res = r.run("flaky", flaky)
        assert ok and res == "recovered"
        assert r.skipped == []
        assert [f["kind"] for f in r.faults] == ["device_lost"]
        assert r.faults[0]["stage"] == "flaky"
        assert obs.counter_value("fault_stage_retry",
                                 stage="flaky") == 1

    def test_exhausted_transient_stage_is_recorded(self, telemetry):
        r = _runner(5.0, retries=1)

        def always_lost():
            raise faults.make_fault("device_lost", "stage")

        ok, res = r.run("lost", always_lost)
        assert not ok
        assert [s["stage"] for s in r.skipped] == ["lost"]
        assert len(r.faults) == 2               # attempt 0 and 1
        assert obs.counter_value("fault_stage_exhausted",
                                 stage="lost") == 1

    def test_non_transient_stage_error_is_not_retried(self):
        r = _runner(5.0, retries=3)
        calls = []

        def boom():
            calls.append(1)
            raise RuntimeError("kaput")

        ok, err = r.run("boom", boom)
        assert not ok and len(calls) == 1
        assert r.faults == []
        assert "kaput" in r.skipped[0]["reason"]

    def test_wedged_stage_retries_then_skips(self):
        r = _runner(0.2, retries=1)
        release = threading.Event()
        ok, res = r.run("wedge", release.wait)
        assert not ok and res is bench_torch._StageRunner._WEDGED
        assert [s["stage"] for s in r.skipped] == ["wedge"]
        assert [f["kind"] for f in r.faults] == ["wedged", "wedged"]
        release.set()

    def test_bench_main_survives_injected_stage_fault(
            self, telemetry, monkeypatch, tmp_path):
        """An injected stage fault is retried, recorded in the details
        file, and the run completes with rc 0."""
        _stub_configs(monkeypatch, tmp_path)
        monkeypatch.setattr(
            bench_torch, "bench_convolve_1m",
            lambda rng: {"metric": HEADLINE, "unit": "Msamples/s",
                         "value": 2000.0, "baseline": 1.0})
        flaky_calls = []

        def flaky_cfg(rng):
            flaky_calls.append(1)
            if len(flaky_calls) == 1:
                raise faults.make_fault("device_lost",
                                        "config:elementwise")
            return {"metric": "elementwise", "unit": "u",
                    "value": 2.0, "baseline": 1.0}

        flaky_cfg.__name__ = "bench_elementwise"
        monkeypatch.setattr(bench_torch, "bench_elementwise", flaky_cfg)
        assert _main() == 0
        details = _details(tmp_path)
        metrics = [d.get("metric") for d in details if "metric" in d]
        assert "elementwise" in metrics
        tail = details[-1]
        fault = tail["stage_faults"][0]
        assert fault["stage"] == "config:bench_elementwise"
        assert fault["kind"] == "device_lost"
        assert "skipped_stages" not in tail


# ---------------------------------------------------------------------------
# a bench_torch details file through the unchanged regression gate
# ---------------------------------------------------------------------------

def test_details_rows_feed_bench_regress(monkeypatch, tmp_path, capsys):
    history = str(tmp_path / "BENCH_HISTORY.jsonl")
    details = str(tmp_path / bench_torch.DETAILS)
    rcs = []
    for value in (2000.0, 2000.0, 900.0):
        assert _run_main_with_headline(monkeypatch, tmp_path, value) == 0
        rows = bench_regress.load_rows(details)
        assert {r["metric"] for r in rows} >= {HEADLINE,
                                                "bench_serve"}
        rcs.append(bench_regress.main(["--details", details,
                                       "--history", history]))
    # no baseline, then within noise, then the headline regressed
    assert rcs == [0, 0, 1]
    with open(history) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 3
    assert records[-1]["rows"][HEADLINE]["value"] == 900.0
    assert records[-1]["device"] == "cpu"
