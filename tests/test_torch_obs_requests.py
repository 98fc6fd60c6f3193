"""The port's request axis (``obs/requests.py``) and scrape endpoint
(``obs/http.py``) against the JAX package's.

Mirrors ``tests/test_obs_requests.py`` in kind, through the port's
``serve.Server`` on the CPU (``set_config(device="cpu")``): cross-thread
traces (ids unique, events causal, phases summing to the total within
1e-3 s), every terminal outcome in ``serve.request_latency{op,
status}``, retry and degrade edges on degraded tickets, per-tenant SLO
accounting, the live endpoint (``/metrics``, ``/healthz`` with 503 while
degraded, ``/debug/requests``; the fleet routes ``/signals``,
``/incidents``, ``/scaler`` and ``POST /submit`` answer with the JAX
endpoint's schema stamps and keys) and the flight bundle's
``request_traces``.  The tracer runs the same event script in both
packages under one scripted clock, so phases, ``summary()``,
``slo_snapshot()`` and the registry's histograms must agree exactly.
"""

import dataclasses
import json
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import loadgen  # noqa: E402
from veles.simd_tpu import obs as jobs  # noqa: E402
from veles.simd_tpu.obs import http as jhttp  # noqa: E402
from veles.simd_tpu.obs import incidents as jincidents  # noqa: E402
from veles.simd_tpu.obs import registry as jregistry  # noqa: E402
from veles.simd_tpu.obs import requests as jreq  # noqa: E402
from veles.simd_tpu.obs import timeseries as jts  # noqa: E402
from veles.simd_tpu.ops import iir as jiir  # noqa: E402
from veles.simd_tpu.serve import rpc as jrpc  # noqa: E402
from veles.simd_tpu.serve import scaler as jscaler  # noqa: E402
from veles.simd_tpu_torch import obs, serve  # noqa: E402
from veles.simd_tpu_torch import pipeline as tpl  # noqa: E402
from veles.simd_tpu_torch.obs import flightrec  # noqa: E402
from veles.simd_tpu_torch.obs import http as obs_http  # noqa: E402
from veles.simd_tpu_torch.obs import requests as obs_requests  # noqa: E402
from veles.simd_tpu_torch.obs.registry import MetricsRegistry  # noqa: E402
from veles.simd_tpu_torch.runtime import breaker, faults  # noqa: E402
from veles.simd_tpu_torch.serve import rpc as trpc  # noqa: E402
from veles.simd_tpu_torch.utils import config  # noqa: E402

RNG = np.random.RandomState(7)
SOS = jiir.butterworth(4, 0.25, "lowpass")
# the fleet axis of the facade
FLEET_NAMES = ("signals", "fleet_record", "fleet_series",
               "stitch_fleet_trace", "incidents_snapshot",
               "scaler_snapshot", "FleetSeries", "FleetSignals")
REQUEST_AXIS = ("request_trace", "slo", "slo_snapshot", "request_summary",
                "request_snapshot", "quantiles", "RequestTrace",
                "RequestTracer")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    prev = config.get_config()
    config.set_config(device="cpu")
    monkeypatch.setenv("VELES_SIMD_FAULT_BACKOFF", "0")
    yield
    config.set_config(**dataclasses.asdict(prev))


@pytest.fixture
def telemetry():
    obs.enable(compile_listeners=False)
    obs.reset()
    breaker.reset()
    faults.reset_fault_history()
    yield
    obs.disable()
    obs.reset()
    breaker.reset()
    faults.reset_fault_history()
    faults.set_fault_plan(None)


def _signal(n=500):
    return RNG.randn(n).astype(np.float32)


def _request(tenant="default", n=500, deadline_ms=None):
    return serve.Request("sosfilt", _signal(n), {"sos": SOS},
                         tenant=tenant, deadline_ms=deadline_ms)


def _phase_sum_ok(trace, tol=1e-3):
    p = trace.phases()
    return abs(p["queue_wait_s"] + p["batch_wait_s"] + p["device_s"]
               - p["total_s"]) <= tol


# ---------------------------------------------------------------------------
# the public surface against the JAX package's
# ---------------------------------------------------------------------------

def test_requests_and_http_constants_equal_the_jax_ones():
    # (their __all__: tests/test_torch_import.py)
    for name in ("DEFAULT_MAX_TRACES", "DEFAULT_MAX_EXEMPLARS",
                 "DEFAULT_MAX_TENANTS", "DEFAULT_SLO_HIT_RATE",
                 "SLO_MS_ENV", "SLO_HIT_RATE_ENV", "MAX_TRACES_ENV",
                 "TERMINAL_STATUSES"):
        assert getattr(obs_requests, name) == getattr(jreq, name)
    for name in ("OBS_PORT_ENV", "BIND_HOST", "REQUESTS_SCHEMA"):
        assert getattr(obs_http, name) == getattr(jhttp, name)


def test_facade_all_is_the_jax_all_less_the_fleet_names():
    # the fleet names are ported now: the facade's __all__ is the JAX
    # package's, fleet names included
    assert jobs.__all__ == obs.__all__
    for name in REQUEST_AXIS + FLEET_NAMES:
        assert name in obs.__all__ and hasattr(obs, name)


class _Clock:
    """A scripted ``time`` stand-in: ``perf_counter`` reads ``now``."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now


def _script(req_mod, registry_cls, clock):
    """One event script through a package's tracer: 120 requests of five
    tenants (three labelled, two folded into ``_other``), every
    terminal status, an SLO, retries and degrades; returns what is
    compared across packages."""
    reg = registry_cls()
    decisions = []
    tracer = req_mod.RequestTracer(
        reg, decision=lambda op, d, **f: decisions.append((op, d, f)),
        max_tenants=3, max_exemplars=4)
    tracer.set_slo("alice", target_ms=5.0, hit_rate=0.9)
    statuses = ("ok", "degraded", "shed", "expired", "ok", "closed",
                "error", "ok")
    traces = []
    for i in range(120):
        tenant = ("alice", "bob", "carol", "dave", "erin")[i % 5]
        tr = tracer.start(("sosfilt", "stft")[i % 2], tenant,
                          shape_class=512, deadline_s=0.25)
        status = statuses[i % len(statuses)]
        clock.now += 0.001
        tr.event("admitted", depth=i, tenant_depth=1)
        tr.event("bucketed", bucket=512)
        if status not in ("shed", "expired"):
            clock.now += 0.002 * (i % 3)
            tr.event("batch_formed", batch=i // 4, co_batched=4,
                     padding_rows=0)
            clock.now += 0.0005
            tr.event("dispatched", route="device", breaker="closed")
            if status == "degraded":
                tr.event("retried", kind="device_lost", attempt=1)
                tr.event("degraded", to="oracle", reason="device_lost")
        clock.now += 0.001 * (1 + i % 4)
        tr.finish(status)
        traces.append(tr)
    snap = reg.snapshot()
    hists = sorted((h["name"], tuple(sorted(h["labels"].items())),
                    h["count"], round(h["sum"], 9))
                   for h in snap["histograms"])
    counters = sorted((c["name"], tuple(sorted(c["labels"].items())),
                       c["value"]) for c in snap["counters"])
    gauges = sorted((g["name"], tuple(sorted(g["labels"].items())),
                     round(g["value"], 9)) for g in snap["gauges"])
    return {
        "events": [[(e["event"], round(e["t_s"], 9))
                    for e in tr.events()] for tr in traces],
        "phases": [{k: round(v, 9) for k, v in tr.phases().items()}
                   for tr in traces],
        "summary": tracer.summary(),
        "slo": tracer.slo_snapshot(),
        "hists": hists, "counters": counters, "gauges": gauges,
        "decisions": [(op, d, sorted(f.items()))
                      for op, d, f in decisions],
        "exemplars": {k: len(v) for k, v in
                      tracer.traces_snapshot().items()
                      if isinstance(v, (list, dict))
                      and k != "summary" and k != "slo"},
    }


def test_tracer_matches_the_jax_tracer_on_one_event_script(monkeypatch):
    got = {}
    for name, mod, reg in (("port", obs_requests, MetricsRegistry),
                           ("jax", jreq, jregistry.MetricsRegistry)):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        got[name] = _script(mod, reg, clock)
    for key in got["jax"]:
        assert got["port"][key] == got["jax"][key], key
    # the script crossed alice's SLO: one breach in each package
    assert got["port"]["decisions"][0][:2] == ("slo", "breach")
    assert got["port"]["slo"]["accounts"]["alice"]["burn_rate"] > 1.0


# ---------------------------------------------------------------------------
# tracer unit contracts (standalone registry, no server)
# ---------------------------------------------------------------------------

class TestTracerUnit:
    def _tracer(self, **kw):
        return obs_requests.RequestTracer(MetricsRegistry(), **kw)

    def test_rids_unique_and_monotonic_under_concurrency(self):
        tracer = self._tracer()
        rids = []
        lock = threading.Lock()

        def mint():
            mine = [tracer.start("op").rid for _ in range(200)]
            assert mine == sorted(mine)
            with lock:
                rids.extend(mine)

        threads = [threading.Thread(target=mint) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive()
        assert len(rids) == 1600
        assert len(set(rids)) == 1600

    def test_phases_sum_exactly_with_full_chain(self):
        tr = self._tracer().start("op", "t")
        tr.event("admitted", depth=1)
        tr.event("bucketed", bucket=512)
        tr.event("batch_formed", batch=0, co_batched=1, padding_rows=0)
        tr.event("dispatched", route="device", breaker="closed")
        tr.finish("ok")
        assert _phase_sum_ok(tr, tol=1e-9)
        assert all(v >= 0 for v in tr.phases().values())

    def test_phases_collapse_for_shed(self):
        tr = self._tracer().start("op")
        tr.finish("shed")
        p = tr.phases()
        assert p["queue_wait_s"] == p["total_s"]
        assert p["batch_wait_s"] == 0.0 and p["device_s"] == 0.0
        assert _phase_sum_ok(tr, tol=0.0)

    def test_finish_is_idempotent_first_wins(self):
        tracer = self._tracer()
        tr = tracer.start("op")
        tr.finish("ok")
        tr.finish("error")
        assert tr.status == "ok"
        terminals = [e for e in tr.events()
                     if e["event"] in ("answered", "error")]
        assert len(terminals) == 1
        assert tracer.summary()["finished"] == 1

    def test_events_after_terminal_are_dropped(self):
        tr = self._tracer().start("op")
        tr.finish("ok")
        tr.event("retried", kind="late")
        assert [e["event"] for e in tr.events()] == ["answered"]

    def test_terminal_statuses_map_to_events(self):
        tracer = self._tracer()
        for status, event in obs_requests.TERMINAL_STATUSES.items():
            tr = tracer.start("op")
            tr.finish(status)
            assert tr.events()[-1]["event"] == event

    def test_every_status_lands_in_latency_histogram(self):
        reg = MetricsRegistry()
        tracer = obs_requests.RequestTracer(reg)
        for status in ("ok", "degraded", "shed", "expired"):
            tracer.start("op").finish(status)
        hists = {h["labels"].get("status"): h["count"]
                 for h in reg.snapshot()["histograms"]
                 if h["name"] == "serve.request_latency"}
        assert hists == {"ok": 1, "degraded": 1, "shed": 1, "expired": 1}
        assert reg.counter_value("serve_deadline_miss", op="op",
                                 tenant="default") == 1

    def test_tenant_label_cardinality_bound(self):
        reg = MetricsRegistry()
        tracer = obs_requests.RequestTracer(reg, max_tenants=3)
        for i in range(10):
            tracer.start("op", f"tenant{i}").finish("ok")
        labels = {h["labels"]["tenant"]
                  for h in reg.snapshot()["histograms"]
                  if h["name"] == "request.total"}
        assert "_other" in labels
        assert len(labels) == 4

    def test_exemplars_slowest_and_degraded(self):
        tracer = self._tracer(max_exemplars=2)
        tracer.start("op").finish("ok")
        for _ in range(3):
            tracer.start("op").finish("degraded")
        snap = tracer.traces_snapshot()
        assert set(snap["slowest_by_op"]) == {"op"}
        assert len(snap["degraded"]) == 2
        assert all(t["status"] == "degraded" for t in snap["degraded"])

    def test_slo_breach_decision_and_gauges(self):
        reg = MetricsRegistry()
        decisions, breaches = [], []
        tracer = obs_requests.RequestTracer(
            reg,
            decision=lambda op, d, **f: decisions.append((op, d, f)),
            on_breach=lambda t, burn: breaches.append((t, burn)))
        tracer.set_slo("alice", target_ms=100.0, hit_rate=0.99)
        for _ in range(25):
            tracer.start("op", "alice").finish("shed")
        assert reg.counter_value("slo_breach", tenant="alice") == 1
        assert [(d[0], d[1]) for d in decisions] == [("slo", "breach")]
        assert decisions[0][2]["burn_rate"] > 1.0
        assert breaches and breaches[0][0] == "alice"
        gauges = {(g["name"], g["labels"].get("tenant")): g["value"]
                  for g in reg.snapshot()["gauges"]}
        assert gauges[("slo_burn_rate", "alice")] > 1.0
        assert gauges[("slo_hit_rate", "alice")] == 0.0
        acct = tracer.slo_snapshot()["accounts"]["alice"]
        assert acct["breached"] and acct["requests"] == 25

    def test_slo_env_defaults(self, monkeypatch):
        monkeypatch.setenv(obs_requests.SLO_MS_ENV, "100")
        tracer = obs_requests.RequestTracer(MetricsRegistry())
        tracer.start("op", "nobody").finish("ok")
        acct = tracer.slo_snapshot()
        assert acct["env_default"]["target_ms"] == 100.0
        assert acct["accounts"]["nobody"]["requests"] == 1

    def test_slo_validation(self):
        tracer = self._tracer()
        with pytest.raises(ValueError):
            tracer.set_slo("t", target_ms=0)
        with pytest.raises(ValueError):
            tracer.set_slo("t", target_ms=10, hit_rate=1.5)

    def test_reset_keeps_rids_rising(self):
        tracer = self._tracer()
        first = tracer.start("op")
        tracer.reset()
        second = tracer.start("op")
        assert second.rid > first.rid
        assert tracer.summary()["started"] == 1

    def test_null_trace_when_disabled(self):
        obs.disable()
        try:
            tr = obs.request_trace("op")
            assert tr is obs_requests.NULL_REQUEST
            tr.event("admitted")
            tr.finish("ok")
            assert tr.phases() == {} and tr.events() == []
        finally:
            obs.reset()


# ---------------------------------------------------------------------------
# serving-layer threading: the causal chain across threads
# ---------------------------------------------------------------------------

class TestServerTraces:
    def test_concurrent_multi_tenant_traces(self, telemetry):
        per_thread = 12
        tickets: dict = {}
        lock = threading.Lock()
        with serve.Server(max_batch=4, max_wait_ms=1.0,
                          workers=2) as srv:
            def producer(tenant):
                mine = []
                for i in range(per_thread):
                    n = (384, 500, 777)[i % 3]
                    mine.append(srv.submit(_request(tenant, n)))
                with lock:
                    tickets[tenant] = mine

            threads = [threading.Thread(target=producer,
                                        args=(f"tenant{k}",))
                       for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
                assert not t.is_alive()
            for mine in tickets.values():
                for t in mine:
                    t.result(timeout=60.0)
        rids = []
        for tenant, mine in tickets.items():
            for t in mine:
                tr = t.trace
                rids.append(tr.rid)
                assert tr.tenant == tenant and tr.op == "sosfilt"
                assert tr.status == t.status == "ok"
                names = [e["event"] for e in tr.events()]
                assert names[0] == "admitted"
                assert names[-1] == "answered"
                assert {"bucketed", "batch_formed",
                        "dispatched"} <= set(names)
                stamps = [e["t_s"] for e in tr.events()]
                assert stamps == sorted(stamps)
                assert _phase_sum_ok(tr)
        assert len(set(rids)) == 4 * per_thread

    def test_batch_formed_edge_carries_cobatch_geometry(self, telemetry):
        srv = serve.Server(max_batch=4, max_wait_ms=50.0, workers=1)
        # queued before start: one batch of the three, whatever the
        # scheduler does
        tickets = [srv.submit(_request(n=500)) for _ in range(3)]
        with srv:
            for t in tickets:
                t.result(timeout=30.0)
        batches = set()
        for t in tickets:
            edge = next(e for e in t.trace.events()
                        if e["event"] == "batch_formed")
            assert edge["co_batched"] == 3
            assert edge["padding_rows"] == 1
            batches.add(edge["batch"])
        assert len(batches) == 1

    def test_all_terminal_outcomes_recorded_with_status(self, telemetry):
        with faults.fault_plan("serve.dispatch:device_lost:3"):
            with serve.Server(max_batch=2, max_wait_ms=1.0,
                              workers=1, queue_depth=64) as srv:
                t_deg = srv.submit(_request())
                t_deg.result(timeout=30.0)
        assert t_deg.status == "degraded"
        obs.reset()
        breaker.reset()
        with serve.Server(max_batch=2, max_wait_ms=1.0, workers=1,
                          queue_depth=2) as srv:
            t_ok = srv.submit(_request())
            t_ok.result(timeout=30.0)
            t_exp = srv.submit(_request(deadline_ms=1e-4))
            with pytest.raises(serve.DeadlineExceeded):
                t_exp.result(timeout=30.0)
        with serve.Server(max_batch=1, max_wait_ms=200.0, workers=1,
                          queue_depth=1) as srv:
            first = srv.submit(_request())
            shed = None
            for _ in range(8):
                t = srv.submit(_request())
                if t.status == "shed":
                    shed = t
                    break
            assert shed is not None
            first.result(timeout=30.0)
        statuses = {h["labels"]["status"]
                    for h in obs.snapshot()["histograms"]
                    if h["name"] == "serve.request_latency"}
        assert {"ok", "expired", "shed"} <= statuses
        for t in (t_ok, t_exp, shed):
            assert t.trace.status == t.status
            assert _phase_sum_ok(t.trace)

    def test_degraded_ticket_has_retry_and_degrade_edges(self, telemetry):
        with faults.fault_plan("serve.dispatch:device_lost:3"):
            with serve.Server(max_batch=2, max_wait_ms=1.0,
                              workers=1) as srv:
                t = srv.submit(_request())
                t.result(timeout=30.0)
        assert t.status == "degraded"
        names = [e["event"] for e in t.trace.events()]
        assert names.count("retried") == 2
        assert "degraded" in names
        retried = next(e for e in t.trace.events()
                       if e["event"] == "retried")
        assert retried["kind"] == "device_lost"

    def test_pipeline_invocation_traces(self, telemetry):
        compiled = tpl.pipeline_from_spec(loadgen.pipeline_spec("tracepipe"))
        with serve.Server(max_batch=2, max_wait_ms=1.0,
                          workers=1) as srv:
            op = srv.register_pipeline("tracepipe", compiled)
            t = srv.submit(op=op, x=_signal(compiled.block_len),
                           params={"state": None}, tenant="ps")
            t.result(timeout=60.0)
        names = [e["event"] for e in t.trace.events()]
        assert names[0] == "admitted" and names[-1] == "answered"
        assert "dispatched" in names
        assert t.trace.op == op
        assert _phase_sum_ok(t.trace)

    def test_loadgen_trace_gates_clean_run(self, telemetry):
        sched = loadgen.build_schedule(np.random.RandomState(0), 24,
                                       rate_hz=0.0)
        with serve.Server(max_batch=4, max_wait_ms=1.0,
                          workers=2) as srv:
            tickets = [srv.submit(serve.Request(
                r.op, r.x, r.params, tenant=r.tenant)) for _, r in sched]
            for t in tickets:
                t.result(timeout=120.0)
        report = dict.fromkeys(loadgen.TRACE_KEYS, 0)
        for t in tickets:
            for k, v in loadgen.trace_failures(t).items():
                report[k] += v
        assert report["trace_checked"] == 24
        assert report["trace_orphans"] == 0
        assert report["trace_phase_err"] == 0
        assert report["trace_degraded_missing_edge"] == 0

    def test_server_stats_carry_request_axis(self, telemetry):
        obs.slo("alice", target_ms=30000.0)
        with serve.Server(max_batch=2, max_wait_ms=1.0,
                          workers=1) as srv:
            srv.submit(_request("alice")).result(timeout=30.0)
            stats = srv.stats()
        assert stats["requests"]["finished"] >= 1
        assert "alice" in stats["slo"]["accounts"]


# ---------------------------------------------------------------------------
# the live scrape endpoint
# ---------------------------------------------------------------------------

def _get(url, timeout=10.0, data=None):
    try:
        with urllib.request.urlopen(url, timeout=timeout, data=data) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _get_bytes(url, timeout=10.0, data=None):
    try:
        with urllib.request.urlopen(url, timeout=timeout, data=data) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class TestScrapeEndpoint:
    def test_routes_serve_live_data(self, telemetry):
        with serve.Server(max_batch=2, max_wait_ms=1.0, workers=1,
                          obs_port=0) as srv:
            assert srv.obs_port and srv.obs_port > 0
            srv.submit(_request()).result(timeout=30.0)
            base = f"http://127.0.0.1:{srv.obs_port}"
            code, prom = _get(base + "/metrics")
            assert code == 200
            assert "veles_simd_serve_completed_total" in prom
            assert "veles_simd_serve_request_latency_bucket" in prom
            code, health = _get(base + "/healthz")
            assert code == 200
            body = json.loads(health)
            assert body["health"]["state"] == "healthy"
            assert "breakers" in body
            code, reqs = _get(base + "/debug/requests")
            assert code == 200
            debug = json.loads(reqs)
            assert debug["schema"] == obs_http.REQUESTS_SCHEMA
            assert debug["summary"]["finished"] >= 1
            assert debug["recent"][0]["events"]
            code, _ = _get(base + "/nope")
            assert code == 404

    @pytest.mark.parametrize("path,post", [("/signals", False),
                                           ("/incidents", False),
                                           ("/scaler", False),
                                           ("/submit", True)])
    def test_fleet_routes_answer_501_naming_item_6(self, telemetry, path,
                                                   post):
        # the fleet routes are ported: each answers as the JAX endpoint
        # does, its body stamped with the JAX schema and carrying the
        # JAX body's keys; a malformed /submit body answers a typed
        # bad_request frame (400), as the JAX serve_submit does
        from veles.simd_tpu import serve as jserve

        data = b"\x00" * 8 if post else None
        with serve.Server(max_batch=2, max_wait_ms=1.0, workers=1,
                          obs_port=0) as srv:
            code, body = _get_bytes(
                f"http://127.0.0.1:{srv.obs_port}{path}", data=data)
            # the endpoint still serves after the route
            ok, _ = _get(f"http://127.0.0.1:{srv.obs_port}/healthz")
        jobs.enable(compile_listeners=False)
        try:
            with jserve.Server(max_batch=2, max_wait_ms=1.0, workers=1,
                               obs_port=0) as jsrv:
                jcode, jbody = _get_bytes(
                    f"http://127.0.0.1:{jsrv.obs_port}{path}", data=data)
        finally:
            jobs.disable()
            jobs.reset()
        assert ok == 200
        assert code == jcode
        if post:
            assert code == 400
            got = trpc.unpack_response(body)
            want = jrpc.unpack_response(jbody)
            assert got["status"] == want["status"] == "error"
            assert got["error"]["kind"] == want["error"]["kind"] \
                == "bad_request"
            return
        assert code == 200
        got, want = json.loads(body), json.loads(jbody)
        stamp = {"/signals": jts.SIGNALS_SCHEMA,
                 "/incidents": jincidents.SCHEMA,
                 "/scaler": jscaler.SCHEMA}[path]
        assert got["schema"] == want["schema"] == stamp
        assert sorted(got) == sorted(want)

    def test_submit_handler_is_refused(self, telemetry):
        # the endpoint arms POST /submit with the handler it is given;
        # without one the route stays refused (404), and the handler
        # sees the exact body bytes
        seen = []

        def echo(body):
            seen.append(body)
            return 200, body[::-1]

        ep = obs_http.start(0, submit=echo)
        bare = obs_http.start(0)
        try:
            code, body = _get_bytes(f"{ep.url}/submit", data=b"abc")
            refused, _ = _get_bytes(f"{bare.url}/submit", data=b"abc")
        finally:
            ep.stop()
            bare.stop()
        assert (code, body, seen) == (200, b"cba", [b"abc"])
        assert refused == 404

    def test_healthz_503_while_degraded(self, telemetry):
        with faults.fault_plan("serve.dispatch:device_lost:9999"):
            with serve.Server(max_batch=2, max_wait_ms=1.0,
                              workers=1, probe_every=1000,
                              obs_port=0) as srv:
                t = srv.submit(_request())
                t.result(timeout=30.0)
                assert t.status == "degraded"
                code, _ = _get(
                    f"http://127.0.0.1:{srv.obs_port}/healthz")
                assert code == 503

    def test_endpoint_dies_with_server(self, telemetry):
        srv = serve.Server(max_batch=2, max_wait_ms=1.0, workers=1,
                           obs_port=0).start()
        port = srv.obs_port
        srv.stop()
        assert srv.obs_port is None
        with pytest.raises(Exception):  # noqa: B017 — refused/reset
            urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                   timeout=2.0)

    def test_env_port_arms_endpoint(self, telemetry, monkeypatch):
        monkeypatch.setenv(obs_http.OBS_PORT_ENV, "0")
        with serve.Server(max_batch=2, max_wait_ms=1.0,
                          workers=1) as srv:
            assert srv.obs_port is not None
            code, _ = _get(f"http://127.0.0.1:{srv.obs_port}/metrics")
            assert code == 200

    def test_env_port_parsing(self, monkeypatch):
        for raw in (None, "9100", "junk", "-1", "0", " 42 "):
            if raw is None:
                monkeypatch.delenv(obs_http.OBS_PORT_ENV, raising=False)
            else:
                monkeypatch.setenv(obs_http.OBS_PORT_ENV, raw)
            assert obs_http.env_port() == jhttp.env_port()
        monkeypatch.setenv(obs_http.OBS_PORT_ENV, "9100")
        assert obs_http.env_port() == 9100

    def test_disarmed_by_default(self, telemetry, monkeypatch):
        monkeypatch.delenv(obs_http.OBS_PORT_ENV, raising=False)
        with serve.Server(max_batch=2, max_wait_ms=1.0,
                          workers=1) as srv:
            assert srv.obs_port is None

    def test_negative_obs_port_disarms_despite_env(self, telemetry,
                                                   monkeypatch):
        monkeypatch.setenv(obs_http.OBS_PORT_ENV, "0")
        with serve.Server(max_batch=2, max_wait_ms=1.0, workers=1,
                          obs_port=-1) as srv:
            assert srv.obs_port is None

    def test_bind_failure_leaves_server_unstarted(self, telemetry):
        blocker = obs_http.start(0)
        try:
            srv = serve.Server(max_batch=2, max_wait_ms=1.0,
                               workers=1, obs_port=blocker.port)
            with pytest.raises(obs_http.EndpointUnavailable) as ei:
                srv.start()
            assert isinstance(ei.value, OSError)
            assert ei.value.port == blocker.port
            assert srv._started is False and srv._threads == []
        finally:
            blocker.stop()


# ---------------------------------------------------------------------------
# flight recorder + facade integration
# ---------------------------------------------------------------------------

class TestBundlesAndFacade:
    def test_bundle_embeds_request_traces(self, telemetry):
        obs.request_trace("op", "alice").finish("degraded")
        bundle = flightrec.build_bundle("test")
        traces = bundle["request_traces"]
        assert traces["summary"]["finished"] == 1
        assert traces["degraded"][0]["tenant"] == "alice"
        assert bundle["snapshot"]["requests"]["finished"] == 1

    def test_slo_breach_arms_a_flight_bundle(self, telemetry, tmp_path):
        flightrec._reset_auto_count()
        flightrec.configure_flight_dir(str(tmp_path))
        try:
            obs.slo("alice", target_ms=100.0, hit_rate=0.99)
            for _ in range(25):
                obs.request_trace("op", "alice").finish("shed")
            bundles = list(tmp_path.glob("flight-*.json"))
            assert len(bundles) == 1
            bundle = json.loads(bundles[0].read_text())
            assert bundle["reason"] == "slo_breach:alice"
            assert bundle["request_traces"]["slo"]["accounts"][
                "alice"]["breached"]
            assert ("slo", "breach") in [(e["op"], e["decision"])
                                         for e in obs.events()]
        finally:
            flightrec.configure_flight_dir(None)
            flightrec._reset_auto_count()

    def test_snapshot_and_prometheus_carry_request_axis(self, telemetry):
        obs.slo("alice", target_ms=100.0)
        obs.request_trace("op", "alice").finish("ok")
        snap = obs.snapshot()
        assert snap["requests"]["by_status"] == {"ok": 1}
        assert "alice" in snap["slo"]["accounts"]
        prom = obs.to_prometheus(snap)
        assert "veles_simd_slo_hit_rate" in prom
        assert "veles_simd_request_total_bucket" in prom

    def test_serving_summary_from_snapshot(self, telemetry):
        with serve.Server(max_batch=2, max_wait_ms=1.0,
                          workers=1) as srv:
            srv.submit(_request()).result(timeout=30.0)
        from veles.simd_tpu_torch.obs import export

        s = export.serving_summary(obs.snapshot())
        assert s is not None
        assert s["by_status"].get("ok") == 1
        assert any(k.startswith("sosfilt/ok") for k in s["latency"])

    def test_quantiles_match_the_jax_facade(self, telemetry):
        jobs.enable(compile_listeners=False)
        jobs.reset()
        try:
            for v in (0.001, 0.002, 0.004, 0.03, 0.5):
                obs.observe("serve.request_latency", v, op="x",
                            status="ok")
                jobs.observe("serve.request_latency", v, op="x",
                             status="ok")
            got = obs.quantiles("serve.request_latency", op="x",
                                status="ok")
            assert got == jobs.quantiles("serve.request_latency", op="x",
                                         status="ok")
            assert got["p99"] >= got["p50"] > 0
            assert obs.quantiles("serve.request_latency", op="y") is None
        finally:
            jobs.disable()
            jobs.reset()

    def test_request_axis_toggle_disarms_tracer_alone(self, telemetry):
        obs.configure(request_axis=False)
        try:
            tr = obs.request_trace("op")
            assert tr is obs_requests.NULL_REQUEST
            obs.count("still_recording")
            assert obs.counter_value("still_recording") == 1
        finally:
            obs.configure(request_axis=True)
        assert obs.request_trace("op") is not obs_requests.NULL_REQUEST

    def test_configure_rebounds_retention(self, telemetry):
        obs.configure(max_traces=2, max_exemplars=1)
        try:
            for _ in range(5):
                obs.request_trace("op").finish("degraded")
            snap = obs.request_snapshot()
            assert snap["summary"]["retained"] == 2
            assert len(snap["degraded"]) == 1
        finally:
            obs.configure(max_traces=obs_requests.DEFAULT_MAX_TRACES,
                          max_exemplars=obs_requests.DEFAULT_MAX_EXEMPLARS)
        with pytest.raises(ValueError):
            obs.configure(max_traces=0)
