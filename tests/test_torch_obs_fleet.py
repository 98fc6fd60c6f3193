"""The port's fleet axis (``obs/timeseries.py``) and incident engine
(``obs/incidents.py``) against the JAX package's.

Both modules are plain Python, copied rather than imported: the same
samples go through both packages' ``FleetSeries`` (rings, windowed
derivatives, flap counts, staleness, forgetting), the same sources
through ``FleetSignals.from_sources`` and the same signal sequences
through ``IncidentEngine.tick``, and each must give equal dicts (the
incident records less their wall and monotonic clock stamps).  Then
the facade: ``obs.signals()`` / ``fleet_record`` / ``save_trace(path,
fleet=)`` on the port, the stitched fleet trace of a scripted
failed-over ticket against the JAX stitcher, and the process ticker's
reference-counted start and stop.
"""

import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from veles.simd_tpu import obs as jobs
from veles.simd_tpu.obs import incidents as jinc
from veles.simd_tpu.obs import timeseries as jts
from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.obs import incidents as inc
from veles.simd_tpu_torch.obs import timeseries as ts

CLOCKS = ("opened_t_wall", "opened_t_mono", "closed_t_wall",
          "closed_t_mono")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in (ts.FLEET_TICK_MS_ENV, ts.FLEET_WINDOW_ENV) + tuple(
            getattr(inc, n) for n in inc.__all__ if n.endswith("_ENV")):
        monkeypatch.delenv(name, raising=False)
    for o in (obs, jobs):
        o.enable(compile_listeners=False)
        o.reset()
    inc._reset_for_tests()
    jinc._reset_for_tests()
    yield
    inc._reset_for_tests()
    jinc._reset_for_tests()
    for o in (obs, jobs):
        o.disable()
        o.reset()


def _samples(seed, replicas=3, ticks=60):
    """A seeded sweep log: ``[(replica, series, value, t_s), ...]``
    with a replica that dies mid-way and flapping breakers."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(ticks):
        t = 10.0 + 0.025 * k
        for r in range(replicas):
            rid = f"r{r}"
            dead = r == 0 and k > ticks // 2
            out.append((rid, "up", 0.0 if dead else 1.0, t))
            out.append((rid, "birth_age_s", 0.025 * k, t))
            if dead:
                continue
            out.append((rid, "depth", float(rng.randint(12)), t))
            out.append((rid, "occupancy", float(rng.randint(4)), t))
            out.append((rid, "healthy", float(rng.rand() > 0.1), t))
            out.append((rid, "completed", float(5 * k + r), t))
            out.append((rid, "breaker_open", float(rng.randint(2)), t))
            if r == 2:
                out.append((rid, "rpc_in_flight", float(rng.randint(4)),
                            t))
                out.append((rid, "rpc_reuse_ratio", rng.rand(), t))
                out.append((rid, "rpc_transport_errors", float(k // 20),
                            t))
        out.append(("_fleet", "queue_depth_total", float(rng.randint(30)),
                    t))
        out.append(("_fleet", "slo_burn:alice", 0.05 * k, t))
        out.append(("_fleet", "slo_burn:bob", float(rng.rand()), t))
        for state, v in (("up", 3 - (k > ticks // 2)), ("draining", 0),
                         ("down", int(k > ticks // 2))):
            out.append(("_fleet", f"replica_count_{state}", float(v), t))
    return out


def _fill(mod, samples, window=None, tick_s=0.025):
    store = mod.FleetSeries(window)
    store.tick_s = tick_s
    for rid, series, value, t in samples:
        store.record(rid, series, value, t)
    for _ in range(len({s[3] for s in samples})):
        store.tick()
    return store


@pytest.mark.parametrize("seed,window", [(0, None), (1, 16), (2, 2)])
def test_fleet_series_equal_between_packages(seed, window):
    samples = _samples(seed)
    a, b = _fill(ts, samples, window), _fill(jts, samples, window)
    assert a.snapshot() == b.snapshot()
    assert a.replicas() == b.replicas()
    now = samples[-1][3] + 0.3
    for rid in b.replicas():
        assert a.names(rid) == b.names(rid)
        assert a.staleness_s(rid, now) == b.staleness_s(rid, now)
        for series in b.names(rid):
            for fn in ("samples", "value", "rate", "delta", "ewma",
                       "flaps"):
                assert getattr(a, fn)(rid, series) == \
                    getattr(b, fn)(rid, series), (rid, series, fn)
    assert a.forget("r1") == b.forget("r1")
    assert a.snapshot() == b.snapshot()


def test_windowed_derivatives_equal_between_packages():
    rng = np.random.RandomState(5)
    for n in (0, 1, 2, 7, 40):
        s = [(0.1 * i, float(rng.randint(3))) for i in range(n)]
        for fn in ("rate", "delta", "ewma", "flaps"):
            assert getattr(ts, fn)(s) == getattr(jts, fn)(s), (n, fn)
    same_t = [(1.0, 1.0), (1.0, 5.0)]
    assert ts.rate(same_t) is None and jts.rate(same_t) is None


def _registry_snapshot():
    return {
        "counters": [
            {"name": "serve_useful_rows", "labels": {"op": "stft"},
             "value": 90},
            {"name": "serve_dispatched_rows", "labels": {"op": "stft"},
             "value": 96},
            {"name": "serve_useful_rows", "labels": {"op": "sosfilt"},
             "value": 30},
            {"name": "serve_dispatched_rows",
             "labels": {"op": "sosfilt"}, "value": 32},
            {"name": "fleet_scrape_stale", "labels": {"replica": "r2"},
             "value": 3}],
        "gauges": [
            {"name": "serve.goodput",
             "labels": {"op": "stft", "class": "16384"}, "value": 0.94},
            {"name": "serve.goodput", "labels": {}, "value": 0.9}],
        "histograms": []}


def _slo_snapshot():
    return {"accounts": {"alice": {"burn_rate": 1.7},
                         "bob": {"burn_rate": 0.2},
                         "carol": {"burn_rate": None}}}


@pytest.mark.parametrize("seed", [0, 3])
def test_fleet_signals_equal_between_packages(seed):
    samples = _samples(seed)
    now = samples[-1][3] + 0.2
    kw = dict(now=now, incidents=[{"id": "inc-1", "rule": "slo_burn"}],
              journal={"armed": False}, scaler={"armed": False})
    a = ts.FleetSignals.from_sources(_fill(ts, samples),
                                     _registry_snapshot(),
                                     _slo_snapshot(), **kw)
    b = jts.FleetSignals.from_sources(_fill(jts, samples),
                                      _registry_snapshot(),
                                      _slo_snapshot(), **kw)
    assert a.to_dict() == b.to_dict()
    assert a.health["r0"] == "down"
    assert a.to_dict()["schema"] == jts.SIGNALS_SCHEMA
    # a hand-wired store without replica_count series derives counts
    bare = [s for s in samples if not s[1].startswith("replica_count")]
    a = ts.FleetSignals.from_sources(_fill(ts, bare, tick_s=None), {},
                                     {}, now=now)
    b = jts.FleetSignals.from_sources(_fill(jts, bare, tick_s=None), {},
                                      {}, now=now)
    assert a.to_dict() == b.to_dict()


@pytest.mark.parametrize("raw", ["", "x", "0", "-5", "1", "2", "40.5",
                                 "250"])
def test_env_knobs_parse_as_the_jax_ones(monkeypatch, raw):
    monkeypatch.setenv(ts.FLEET_TICK_MS_ENV, raw)
    monkeypatch.setenv(ts.FLEET_WINDOW_ENV, raw)
    assert ts.env_tick_s() == jts.env_tick_s()
    assert ts.env_window() == jts.env_window()


def test_constants_are_the_jax_ones():
    for mod, ref in ((ts, jts), (inc, jinc)):
        for name in ref.__all__:
            if name.isupper():
                assert getattr(mod, name) == getattr(ref, name), name


# ---------------------------------------------------------------------------
# the incident engine
# ---------------------------------------------------------------------------

def _sig(t, *, burn=None, flaps=None, goodput=None, health=None,
         depth=0.0):
    return SimpleNamespace(at_s=t, slo_burn=burn or {},
                           breaker_flaps=flaps or {},
                           goodput_overall=goodput, health=health or {},
                           queue_depth_total=depth)


def _storyline(seed):
    """A seeded sequence that opens and closes every rule, with single
    spikes and flap storms between, and one malformed read."""
    rng = np.random.RandomState(seed)
    sigs = []
    for k in range(160):
        phase = (k // 20) % 5
        t = 0.25 * k
        sigs.append(_sig(
            t,
            burn={"alice": 1.5 if phase == 0 and k % 20 < 12 else
                  float(rng.rand() * 0.5)},
            flaps={"r1": 6 if phase == 1 and (k % 20 < 10 or k % 2)
                   else 0},
            goodput=(0.3 if phase == 2 and k % 20 < 10 else 0.9),
            health={"r0": ("down" if phase == 3 and k % 20 < 8 else
                           "stale" if phase == 3 and k % 20 < 10 else
                           "healthy"), "r1": "healthy"},
            depth=(float(k % 20) * 40.0 if phase == 4 else 1.0)))
    sigs.insert(37, SimpleNamespace(at_s="garbage", slo_burn=5))
    return sigs


def _timeless(snap):
    snap = json.loads(json.dumps(snap, default=str))
    for i in snap["incidents"]:
        for k in CLOCKS:
            i[k] = i[k] is not None
    return snap


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, {"open_ticks": 1, "close_ticks": 2}),
    (2, {"burn": 0.4, "flaps": 2, "goodput": 0.95,
         "queue_velocity": 10.0})])
def test_incident_engine_equal_between_packages(seed, kw):
    a, b = inc.IncidentEngine(**kw), jinc.IncidentEngine(**kw)
    edges_a, edges_b = [], []
    for sig in _storyline(seed):
        edges_a.append([(i.rule, i.state) for i in a.tick(sig)])
        edges_b.append([(i.rule, i.state) for i in b.tick(sig)])
    assert edges_a == edges_b
    sa, sb = _timeless(a.snapshot()), _timeless(b.snapshot())
    assert sa == sb
    assert sa["schema"] == jinc.SCHEMA
    assert {i["rule"] for i in sa["incidents"]} == set(inc.RULES)
    events = [e for e in obs.events() if e["op"] == "incident"]
    jevents = [e for e in jobs.events() if e["op"] == "incident"]
    strip = ("seq", "t", "t_s", "wall_s", "open_s")
    assert [{k: v for k, v in e.items() if k not in strip}
            for e in events] == [{k: v for k, v in e.items()
                                  if k not in strip} for e in jevents]


def test_incident_knobs_parse_as_the_jax_ones(monkeypatch):
    for raw in ("", "x", "0", "-1", "3", "0.75"):
        for name in ("OPEN_TICKS_ENV", "CLOSE_TICKS_ENV", "BURN_ENV",
                     "FLAPS_ENV", "GOODPUT_ENV", "QUEUE_VELOCITY_ENV"):
            monkeypatch.setenv(getattr(inc, name), raw)
        a, b = inc.IncidentEngine(), jinc.IncidentEngine()
        for k in ("open_ticks", "close_ticks", "burn", "flaps",
                  "goodput", "queue_velocity"):
            assert getattr(a, k) == getattr(b, k), (raw, k)


def test_process_ticker_is_reference_counted():
    assert inc.snapshot() == jinc.snapshot()
    assert inc.open_incidents() == []
    e = inc.start(0.01)
    inc.start(0.01)
    try:
        deadline = time.monotonic() + 10.0
        while e.ticks < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert e.ticks >= 3
        inc.stop()                      # one holder left: still ticking
        ticks = e.ticks
        time.sleep(0.1)
        assert e.ticks > ticks
    finally:
        inc.stop()
    time.sleep(0.05)
    ticks = e.ticks
    time.sleep(0.1)
    assert e.ticks == ticks
    inc.reset()
    assert e.snapshot()["ticks"] == 0
    assert obs.incidents_snapshot()["schema"] == jinc.SCHEMA


# ---------------------------------------------------------------------------
# the facade: signals, fleet_record, the stitched fleet trace
# ---------------------------------------------------------------------------

def test_facade_signals_and_fleet_record():
    assert obs.signals().to_dict().keys() == \
        jobs.signals().to_dict().keys()
    for o in (obs, jobs):
        for rid, series, value, t in _samples(4, ticks=8):
            o.fleet_record(rid, series, value, t)
        o.fleet_series().tick_s = 0.025
    a, b = obs.signals().to_dict(), jobs.signals().to_dict()
    for k in ("queue_depth", "health", "replica_count", "rpc",
              "breaker_flaps", "series", "scaler", "incidents"):
        assert a[k] == b[k], k
    obs.disable()
    obs.fleet_record("r9", "up", 1.0, 0.0)      # a no-op while off
    obs.enable(compile_listeners=False)
    assert "r9" not in obs.fleet_series().replicas()
    obs.reset()
    assert obs.fleet_series().replicas() == []
    snap = obs.snapshot()
    for k in ("fleet", "incidents", "scaler"):
        assert k in snap


class _Trace:
    def __init__(self, rid, t0, status, events):
        self.rid, self._t0, self.status = rid, t0, status
        self.op, self.deadline_s = "stft", 1.5
        self._events = events

    def events(self):
        return list(self._events)


def _ticket():
    dead = _Trace(7, 100.0, "closed",
                  [{"event": "admitted", "t_s": 0.0, "depth": 1},
                   {"event": "closed", "t_s": 0.012}])
    live = _Trace(8, 100.02, "ok",
                  [{"event": "admitted", "t_s": 0.0},
                   {"event": "dispatched", "t_s": 0.003,
                    "replica": "r1"},
                   {"event": "ok", "t_s": 0.009}])
    return SimpleNamespace(rid=3, op="stft", status="ok", failovers=1,
                           prior_traces=[dead, None], trace=live,
                           attempt_replicas=["r0", "r1"],
                           deadlines_ms=[1500.0, 1480.5], replica="r1")


def test_stitched_fleet_trace_equal_between_packages(tmp_path):
    a = ts.stitch_fleet_trace(_ticket())
    b = jts.stitch_fleet_trace(_ticket())
    name = a["traceEvents"][0]["args"]["name"]
    assert name.startswith("veles.simd_tpu_torch fleet request")
    a["traceEvents"][0]["args"]["name"] = \
        b["traceEvents"][0]["args"]["name"]
    assert a == b
    assert a["otherData"]["attempts"] == 2
    assert [e["name"] for e in a["traceEvents"]].count("failover_hop") \
        == 1
    path = obs.save_trace(os.path.join(tmp_path, "fleet.json"),
                          fleet=_ticket())
    with open(path) as f:
        saved = json.load(f)
    assert saved["otherData"] == a["otherData"]
    again = obs.save_trace(os.path.join(tmp_path, "again.json"),
                           fleet=a)
    with open(again) as f:
        assert json.load(f)["traceEvents"] == a["traceEvents"]


def test_concurrent_records_are_not_lost():
    store = ts.FleetSeries(window=100000)
    barrier = threading.Barrier(8)

    def writer(i):
        barrier.wait()
        for k in range(2000):
            store.record("r0", "depth", float(k), float(i * 10000 + k))

    threads = [threading.Thread(target=writer, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive()
    assert len(store.samples("r0", "depth")) == 16000
