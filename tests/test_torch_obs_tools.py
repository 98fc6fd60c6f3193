"""The port's obs readers against the JAX tools, on the same inputs.

* ``tools/obs_report_torch.py`` and ``tools/obs_report.py`` render the
  same snapshot JSON — written by the port's ``obs.save`` after served
  traffic, kernel-wrapper calls and a breaker cycle — to the same text,
  package names aside, in table, ``--prometheus`` and details modes.
* ``tools/obs_query_torch.py`` and ``tools/obs_query.py`` give the same
  filtered records, incidents, postmortem text, summary and trace JSON
  for one journal pack the port wrote.
* ``tools/obs_dash_torch.py`` renders a live port scrape endpoint, and
  a ``ReplicaGroup``'s fleet endpoint, as ``tools/obs_dash.py`` does
  (each route fetched once from the live endpoint, then handed to
  both renderers).
"""

import contextlib
import dataclasses
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import obs_dash  # noqa: E402
import obs_dash_torch  # noqa: E402
import obs_query  # noqa: E402
import obs_query_torch  # noqa: E402
import obs_report  # noqa: E402
import obs_report_torch  # noqa: E402
from veles.simd_tpu_torch import obs, serve  # noqa: E402
from veles.simd_tpu_torch.obs import incidents  # noqa: E402
from veles.simd_tpu_torch.ops import convolve as cv  # noqa: E402
from veles.simd_tpu_torch.ops import iir  # noqa: E402
from veles.simd_tpu_torch.runtime import breaker, faults  # noqa: E402
from veles.simd_tpu_torch.utils import config  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    prev = config.get_config()
    config.set_config(device="cpu")
    monkeypatch.setenv("VELES_SIMD_FAULT_BACKOFF", "0")
    for name in ("VELES_SIMD_FAULT_PLAN", "VELES_SIMD_OBS_PORT",
                 "VELES_SIMD_JOURNAL_DIR", "VELES_SIMD_SCALER"):
        monkeypatch.delenv(name, raising=False)
    obs.enable(compile_listeners=False)
    obs.reset()
    breaker.reset()
    faults.reset_fault_history()
    yield
    obs.configure(journal_dir="")
    obs.disable()
    obs.reset()
    breaker.reset()
    faults.reset_fault_history()
    incidents._reset_for_tests()
    config.set_config(**dataclasses.asdict(prev))


def _run(main, argv) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _unpackaged(text: str) -> str:
    return text.replace("veles.simd_tpu_torch", "veles.simd_tpu")


def _traffic(port=None):
    """A few served requests, kernel-wrapper calls and one breaker
    cycle: the snapshot's serving, span, resource and breaker
    sections all fill."""
    rng = np.random.RandomState(3)
    sos = iir.butterworth(4, 0.25, "lowpass")
    obs.slo("alice", target_ms=60000.0, hit_rate=0.99)
    with serve.Server(max_batch=4, max_wait_ms=2.0,
                      obs_port=port) as srv:
        tickets = [srv.submit(serve.Request(
            "sosfilt", rng.randn(256).astype(np.float32), {"sos": sos},
            tenant="alice")) for _ in range(6)]
        for t in tickets:
            t.result(timeout=60)
    h = cv.convolve_initialize(4096, 255)
    cv.convolve(h, rng.randn(4096).astype(np.float32),
                rng.randn(255).astype(np.float32))
    br = breaker.Breaker("serve.chaos", key="report", window=4,
                         threshold=0.5, min_events=2, probe_every=1)
    br.failure()
    br.failure()
    br.admit()
    br.success()


# -- obs_report --------------------------------------------------------------

@pytest.fixture
def snapshot_path(tmp_path):
    _traffic()
    path = tmp_path / "snap.json"
    obs.save(str(path))
    return path


@pytest.mark.parametrize("flags", [[], ["--prometheus"]])
def test_obs_report_renders_the_snapshot_as_the_jax_tool(snapshot_path,
                                                          flags):
    rc_t, text_t = _run(obs_report_torch.main, flags + [str(snapshot_path)])
    rc_j, text_j = _run(obs_report.main, flags + [str(snapshot_path)])
    assert rc_t == rc_j == 0
    assert _unpackaged(text_t) == _unpackaged(text_j)
    if not flags:
        for section in ("dispatch latency", "serving:"):
            assert section in text_t


def test_obs_report_renders_a_details_file_as_the_jax_tool(snapshot_path,
                                                            tmp_path):
    from veles.simd_tpu_torch.obs.export import (flatten_counters,
                                                 span_summary)

    snap = json.loads(snapshot_path.read_text())
    entries = [{"metric": "chaos requests answered", "value": 6.0,
                "unit": "req", "vs_baseline": None,
                "telemetry": {"counters": flatten_counters(snap),
                              "spans": span_summary(snap),
                              "resources": snap.get("resources", []),
                              "caches": snap.get("caches", {}),
                              "decisions": snap["events"][-4:]}},
               {"chaos_invariants": {"zero_lost": True}}]
    path = tmp_path / "CHAOS_DETAILS_torch.json"
    path.write_text(json.dumps(entries, default=str))
    rc_t, text_t = _run(obs_report_torch.main, [str(path)])
    rc_j, text_j = _run(obs_report.main, [str(path)])
    assert rc_t == rc_j == 0
    assert text_t == text_j
    assert "=== chaos requests answered ===" in text_t
    # a details file has no snapshot to expose
    assert _run(obs_report_torch.main, ["--prometheus", str(path)])[0] == 2


# -- obs_query ---------------------------------------------------------------

@pytest.fixture
def journal_pack(tmp_path):
    """A pack the port's journal wrote: a breaker cycle, an incident
    opened and closed, a scaler action linked to it and noop ticks
    carrying their inputs."""
    pack = tmp_path / "pack"
    obs.configure(journal_dir=str(pack))
    obs.record_decision("replica_lifecycle", "kill", replica="r0")
    obs.record_decision("incident", "open", id="inc-7-1",
                        rule="slo_burn", burn=4.0)
    br = breaker.Breaker("serve.chaos", key="journal", window=4,
                         threshold=0.5, min_events=2, probe_every=1)
    br.failure()
    br.failure()
    br.admit()
    br.success()
    inputs = {"burn_max": 4.0, "queue_depth_total": 9.0,
              "queue_velocity": 1.5, "alive": 1, "goodput": 0.5}
    obs.record_decision("scaler", "scale_up", rule="slo_burn",
                        replica="r1", incident_id="inc-7-1",
                        inputs=inputs)
    obs.record_decision("scaler", "noop", reason="cooldown",
                        inputs=dict(inputs, burn_max=0.2, alive=2))
    obs.record_decision("incident", "close", id="inc-7-1",
                        rule="slo_burn", reason="quiet")
    obs.record_decision("incident", "open", id="inc-7-2",
                        rule="replica_down", replica="r0")
    obs.configure(journal_dir="")
    return pack


def test_obs_query_functions_agree_on_a_port_pack(journal_pack):
    from veles.simd_tpu.obs import journal as jjournal
    from veles.simd_tpu_torch.obs import journal

    records, skipped = journal.read_pack(str(journal_pack))
    assert (records, skipped) == jjournal.read_pack(str(journal_pack))
    assert skipped == 0 and len(records) >= 8
    for kw in ({}, {"op": "scaler"}, {"replica": "r0"},
               {"kind": "decision"}, {"last": 0.0}):
        assert obs_query_torch.filter_records(records, **kw) == \
            obs_query.filter_records(records, **kw)
    incs = obs_query_torch.incidents_from(records)
    assert incs == obs_query.incidents_from(records)
    assert [(i["id"], i["close"] is not None) for i in incs] == [
        ("inc-7-1", True), ("inc-7-2", False)]
    for inc in incs:
        text = obs_query_torch.postmortem(records, inc)
        assert text == obs_query.postmortem(records, inc)
    assert "scaler actions linked (1)" in \
        obs_query_torch.postmortem(records, incs[0])
    acts = obs_query_torch.scaler_actions(records, "inc-7-1")
    assert acts == obs_query.scaler_actions(records, "inc-7-1")
    t_end = incs[0]["close"]["t_wall"]
    assert obs_query_torch.scaler_effect(records, acts, t_end) == \
        obs_query.scaler_effect(records, acts, t_end)
    trace_t = obs_query_torch.fleet_timeline_trace(records)
    trace_j = obs_query.fleet_timeline_trace(records)
    assert json.loads(_unpackaged(json.dumps(trace_t))) == trace_j
    assert obs_query_torch.summary(records, 0, str(journal_pack)) == \
        obs_query.summary(records, 0, str(journal_pack))


@pytest.mark.parametrize("flags", [[], ["--summary"], ["--json"],
                                   ["--postmortem"], ["--op", "scaler"],
                                   ["--replica", "r0"]])
def test_obs_query_cli_prints_as_the_jax_tool(journal_pack, flags):
    rc_t, text_t = _run(obs_query_torch.main, [str(journal_pack)] + flags)
    rc_j, text_j = _run(obs_query.main, [str(journal_pack)] + flags)
    assert rc_t == rc_j == 0
    assert text_t == text_j and text_t


def test_obs_query_trace_file_matches(journal_pack, tmp_path):
    out_t, out_j = tmp_path / "t.json", tmp_path / "j.json"
    assert _run(obs_query_torch.main,
                [str(journal_pack), "--trace", str(out_t)])[0] == 0
    assert _run(obs_query.main,
                [str(journal_pack), "--trace", str(out_j)])[0] == 0
    assert json.loads(_unpackaged(out_t.read_text())) == \
        json.loads(out_j.read_text())


def test_obs_query_refuses_an_empty_directory(tmp_path):
    assert _run(obs_query_torch.main, [str(tmp_path)])[0] == 2


# -- obs_dash ----------------------------------------------------------------

def _replay(monkeypatch, base, routes):
    """Fetch each route once from the live endpoint, then hand the same
    bodies to both tools' renderers."""
    bodies = {r: obs_dash_torch.fetch(base + r) for r in routes}

    def fetch(url, timeout=10.0):
        return bodies[url[len(base):]]

    monkeypatch.setattr(obs_dash_torch, "fetch", fetch)
    monkeypatch.setattr(obs_dash, "fetch", fetch)
    return bodies


def test_obs_dash_renders_a_live_port_endpoint(monkeypatch):
    with serve.Server(max_batch=4, max_wait_ms=2.0, obs_port=0) as srv:
        rng = np.random.RandomState(5)
        sos = iir.butterworth(4, 0.25, "lowpass")
        for t in [srv.submit(serve.Request(
                "sosfilt", rng.randn(256).astype(np.float32),
                {"sos": sos})) for _ in range(5)]:
            t.result(timeout=60)
        base = f"http://127.0.0.1:{srv.obs_port}"
        # the live endpoint answers the tool itself (rc 0)
        rc, text = _run(obs_dash_torch.main, ["--url", base])
        assert rc == 0 and "health: HEALTHY" in text
        _replay(monkeypatch, base,
                ("/healthz", "/metrics", "/debug/requests"))
        text_t, ok_t = obs_dash_torch.render(base)
        text_j, ok_j = obs_dash.render(base)
    assert ok_t and ok_j
    assert text_t == text_j
    assert "metrics:" in text_t and "requests:" in text_t


def test_obs_dash_renders_a_replica_groups_fleet_endpoint(monkeypatch):
    from veles.simd_tpu_torch.serve import cluster

    with cluster.ReplicaGroup(2, max_batch=8, max_wait_ms=5.0,
                              obs_port=0, fleet_tick_ms=25.0) as group:
        router = cluster.FrontRouter(group)
        rng = np.random.RandomState(6)
        sos = iir.butterworth(4, 0.25, "lowpass")
        for t in [router.submit(op="sosfilt",
                                x=rng.randn(256).astype(np.float32),
                                params={"sos": sos}) for _ in range(6)]:
            t.result(timeout=60)
        import time
        deadline = time.monotonic() + 10.0
        while obs.signals().ticks < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        base = f"http://127.0.0.1:{group.obs_port}"
        _replay(monkeypatch, base, ("/signals", "/scaler"))
        text_t, ok_t = obs_dash_torch.render_fleet(base)
        text_j, ok_j = obs_dash.render_fleet(base)
    assert ok_t and ok_j
    assert text_t == text_j
    assert "replicas:" in text_t and "r0" in text_t


def test_obs_dash_unreachable_endpoint_is_rc_1():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rc, text = _run(obs_dash_torch.main, ["--port", str(port)])
    assert rc == 1 and "unreachable" in text
