"""The port's serving loop (``veles/simd_tpu_torch/serve/``) against the
JAX package's.

On the CPU (``set_config(device="cpu")``, ``JAX_PLATFORMS=cpu``):

* the public surface: the package's ``__all__`` is the JAX package's,
  the fleet names included (each module's own ``__all__``:
  ``tests/test_torch_import.py``); ``tools/lint.py``'s serve-layer
  and request-trace rules pass on the port's sources (read as the JAX
  package's; the fleet modules' own rules:
  ``tests/test_torch_cluster.py``);
* the deterministic parts through both packages: ``classify_request``
  keys and ``bucket_length`` over loadgen's mix, the admission
  controller's sheds and depths, the health machine's transitions;
* the slice as a whole: loadgen's seeded 160-request schedule through
  the JAX ``serve.Server`` and the port's — every answer within 2e-5
  (IIR, resampling) or 1e-4 (STFT) of max|y| of the other package's,
  nothing lost or answered twice, every trace closed with phases that
  sum to the total;
* ``tests/test_serve.py``'s cases in kind (coalescing, padding
  exactness, typed ``Overloaded`` and backpressure, degrade parity and
  probed recovery, deadlines, refill, ragged parity and one-ticket
  fault isolation, stop without drain, the endpoint's port conflict);
* what the card changes: one copy back per batch, the capture gate
  (one a process, held by every server in it), a served pipeline
  whose degraded block keeps its state exact, and ``Server.start``
  preloading an armed artifact store's warm pack (the packed kernel
  library placed under the build root; a stale pack places nothing and
  the server starts cold).

The same behaviours on the card: ``tests/test_torch_cuda.py -k serve``.
"""

import ast
import dataclasses
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import lint  # noqa: E402
import loadgen  # noqa: E402
from veles.simd_tpu import obs as jobs  # noqa: E402
from veles.simd_tpu import serve as jserve  # noqa: E402
from veles.simd_tpu.ops import iir as jiir  # noqa: E402
from veles.simd_tpu.runtime import breaker as jbreaker  # noqa: E402
from veles.simd_tpu_torch import obs, serve  # noqa: E402
from veles.simd_tpu_torch import pipeline as tpl  # noqa: E402
from veles.simd_tpu_torch.obs import http as obs_http  # noqa: E402
from veles.simd_tpu_torch.ops import iir  # noqa: E402
from veles.simd_tpu_torch.ops import resample as rs  # noqa: E402
from veles.simd_tpu_torch.ops import segments as seg  # noqa: E402
from veles.simd_tpu_torch.ops import spectral as sp  # noqa: E402
from veles.simd_tpu_torch.runtime import breaker, faults  # noqa: E402
from veles.simd_tpu_torch.serve import server as tserver  # noqa: E402
from veles.simd_tpu_torch.utils import config  # noqa: E402

RNG = np.random.RandomState(42)
SOS = jiir.butterworth(4, 0.25, "lowpass")
IIR_TOL = 2e-5          # of max|y|: IIR and resampling
STFT_TOL = 1e-4
TOLS = {"sosfilt": IIR_TOL, "lfilter": IIR_TOL,
        "resample_poly": IIR_TOL, "stft": STFT_TOL}
# the replica layer, the autoscaler and the RPC plane
FLEET_NAMES = ("ReplicaGroup", "FrontRouter", "RouterTicket",
               "NoReplicaAvailable", "ScalerEngine", "RpcClient",
               "RpcTicket", "RPC_CONNS_ENV", "RPC_TIMEOUT_ENV",
               "SCALER_ARM_ENV", "SCALER_TICK_MS_ENV", "REPLICAS_ENV",
               "ROUTER_POLICY_ENV", "HEARTBEAT_MS_ENV")
SERVE_SOURCES = ("__init__", "admission", "health", "batcher", "server",
                 "cluster", "rpc", "scaler")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    prev = config.get_config()
    config.set_config(device="cpu")
    monkeypatch.setenv("VELES_SIMD_FAULT_BACKOFF", "0")
    for name in (tserver.RAGGED_ENV, tserver.CONTINUOUS_ENV,
                 tserver.ARTIFACTS_ENV, tserver.DEADLINE_ENV,
                 obs_http.OBS_PORT_ENV):
        monkeypatch.delenv(name, raising=False)
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


def _rel(got, want):
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) or 1.0
    return float(np.max(np.abs(got - want)) / scale)


def _signal(n):
    return RNG.randn(n).astype(np.float32)


def _sosfilt64(x):
    return iir.sosfilt_na(SOS, x[None, :])[0]


def _phase_drift(trace):
    p = trace.phases()
    return abs(p["queue_wait_s"] + p["batch_wait_s"] + p["device_s"]
               - p["total_s"])


# ---------------------------------------------------------------------------
# the public surface and the JAX lint rules
# ---------------------------------------------------------------------------

def test_serve_package_all_is_the_jax_all_less_the_fleet_names():
    # the fleet names are ported now: serve's __all__ is the JAX
    # package's, and the fleet's environment names are the JAX ones
    assert jserve.__all__ == serve.__all__
    for name in FLEET_NAMES:
        assert hasattr(serve, name), name
    for name in ("RPC_CONNS_ENV", "RPC_TIMEOUT_ENV", "SCALER_ARM_ENV",
                 "SCALER_TICK_MS_ENV", "REPLICAS_ENV",
                 "ROUTER_POLICY_ENV", "HEARTBEAT_MS_ENV",
                 "DEFAULT_MAX_BATCH", "DEFAULT_MAX_WAIT_MS",
                 "DEFAULT_QUEUE_DEPTH", "DEFAULT_TENANT_DEPTH",
                 "MAX_BATCH_ENV", "MAX_WAIT_ENV", "QUEUE_DEPTH_ENV",
                 "TENANT_DEPTH_ENV", "DEADLINE_ENV", "SUPPORTED_OPS",
                 "HEALTHY", "DEGRADED"):
        assert getattr(serve, name) == getattr(jserve, name)
    for name in ("DEFAULT_WORKERS", "CONTINUOUS_ENV", "RAGGED_ENV",
                 "RAGGED_MAX_ENV", "DEFAULT_RAGGED_MAX"):
        assert getattr(tserver, name) == getattr(jserve.server, name)


@pytest.mark.parametrize("name", SERVE_SOURCES)
def test_jax_lint_rules_pass_on_the_port(name):
    # the port's source read as the JAX package's: guarded batched
    # dispatch, obs recording, no time import, no hand-rolled terminal
    # accounting
    path = REPO / "veles" / "simd_tpu_torch" / "serve" / f"{name}.py"
    text = path.read_text().replace("veles.simd_tpu_torch",
                                    "veles.simd_tpu")
    tree = ast.parse(text)
    assert lint.serve_layer_errors(tree, path.name) == []
    assert lint.request_trace_errors(tree, path.name) == []


def test_the_lint_rules_see_the_port_server():
    # the rule bodies are not vacuous on the rewritten text: dropping
    # the guard around the batched dispatch is an error
    path = REPO / "veles" / "simd_tpu_torch" / "serve" / "server.py"
    text = path.read_text().replace("veles.simd_tpu_torch",
                                    "veles.simd_tpu")
    bare = text.replace("ys = faults.guarded(", "ys = _unguarded(")
    errors = lint.serve_layer_errors(ast.parse(bare), "server.py")
    assert any("bare batched-op dispatch" in e for e in errors)
    timed = "import time\n" + text
    assert lint.serve_layer_errors(ast.parse(timed), "server.py")


# ---------------------------------------------------------------------------
# deterministic parts, equal between the packages
# ---------------------------------------------------------------------------

def _mix_requests():
    """Every (op, params, length) of loadgen's mix, plus the STFT
    acceptance geometry (512/128 on 16,384 samples)."""
    out = []
    for op, params, lengths in loadgen._mix():
        for n in lengths:
            out.append((op, params(), n))
    out.append(("stft", {"frame_length": 512, "hop": 128}, 16384))
    return out


@pytest.mark.parametrize("ragged", ["0", "1"])
def test_classify_request_keys_equal_the_jax_keys(monkeypatch, ragged):
    monkeypatch.setenv(tserver.RAGGED_ENV, ragged)
    for op, params, n in _mix_requests():
        x = _signal(n)
        tx, tn, tparams, tkey = tserver.classify_request(op, x, params)
        jx, jn, jparams, jkey = jserve.server.classify_request(op, x,
                                                               params)
        assert tkey == jkey and tn == jn == n
        assert np.array_equal(tx, jx)
        assert tparams.keys() == jparams.keys()
        for k in tparams:
            assert np.array_equal(np.asarray(tparams[k]),
                                  np.asarray(jparams[k]))
    for n in (1, 2, 3, 255, 256, 257, 1000, 16384, 16385):
        assert serve.bucket_length(n) == jserve.bucket_length(n)


@pytest.mark.parametrize("op,x,params", [
    ("fft9000", np.zeros(64, np.float32), {}),
    ("sosfilt", np.zeros((2, 64), np.float32), {"sos": SOS}),
    ("sosfilt", np.zeros(0, np.float32), {"sos": SOS}),
    ("stft", np.zeros(64, np.float32), {"frame_length": 128, "hop": 64}),
    ("stft", np.zeros(512, np.float32), {"frame_length": 128, "hop": 256}),
    ("resample_poly", np.zeros(64, np.float32), {"up": 0, "down": 2}),
])
def test_malformed_requests_raise_in_both_packages(op, x, params):
    with pytest.raises(ValueError):
        jserve.server.classify_request(op, x, params)
    with pytest.raises(ValueError):
        tserver.classify_request(op, x, params)


def _admission_script(mod):
    ac = mod.AdmissionController(max_depth=4, max_tenant_depth=2)
    seen = []
    for tenant in ("a", "a", "a", "b", "b", "c", "c"):
        try:
            seen.append(("ok",) + tuple(ac.admit(tenant)))
        except mod.Overloaded as e:
            seen.append(("shed", e.scope, e.tenant))
    ac.release("a")
    ac.release("b")
    for tenant in ("a", "c", "c"):
        try:
            seen.append(("ok",) + tuple(ac.admit(tenant)))
        except mod.Overloaded as e:
            seen.append(("shed", e.scope, e.tenant))
    return seen, ac.snapshot(), ac.depth(), ac.depth("c")


def test_admission_sheds_and_depths_equal_the_jax_controller():
    got = _admission_script(serve)
    assert got == _admission_script(jserve)
    assert ("shed", "tenant", "a") in got[0]
    assert ("shed", "global", "c") in got[0]


def _health_script(mod, probe_every):
    hm = mod.HealthMonitor(probe_every=probe_every)
    steps = [hm.trip("serve.dispatch"), hm.trip("serve.dispatch")]
    for i in range(2 * probe_every + 1):
        probe = hm.note_degraded_batch()
        steps.append(probe)
        if probe and i > probe_every:
            steps.append(hm.recover("serve.dispatch"))
    steps += [hm.note_degraded_batch(), hm.recover("serve.dispatch"),
              hm.state, hm.degraded]
    return steps, hm.snapshot()


@pytest.mark.parametrize("probe_every", [1, 2, 4])
def test_health_transitions_equal_the_jax_machine(probe_every):
    assert (_health_script(serve, probe_every)
            == _health_script(jserve, probe_every))
    with pytest.raises(ValueError):
        serve.HealthMonitor(probe_every=0)


def test_batcher_env_policy_equals_the_jax_batcher(monkeypatch):
    from veles.simd_tpu.serve import batcher as jb
    from veles.simd_tpu_torch.serve import batcher as tb

    for raw in ("", "16", "junk", "-3"):
        monkeypatch.setenv(tb.MAX_BATCH_ENV, raw)
        monkeypatch.setenv(tb.MAX_WAIT_ENV, raw)
        assert tb.env_policy() == jb.env_policy()


# ---------------------------------------------------------------------------
# the slice as a whole: one seeded loadgen schedule through both servers
# ---------------------------------------------------------------------------

def _serve_schedule(mod, schedule, make_request):
    """Queue the whole schedule, then start the server (flat-out
    arrivals); returns the tickets once every one is answered."""
    srv = mod.Server(max_batch=8, max_wait_ms=2.0, workers=2)
    tickets = [srv.submit(make_request(req)) for _, req in schedule]
    with srv:
        for t in tickets:
            t.result(timeout=300.0)
    return srv, tickets


def _trace_report(tickets):
    report = dict.fromkeys(loadgen.TRACE_KEYS, 0)
    for t in tickets:
        for k, v in loadgen.trace_failures(t).items():
            report[k] += v
    return report


def test_loadgen_schedule_through_both_servers(telemetry):
    schedule = loadgen.build_schedule(np.random.RandomState(11), 160,
                                      rate_hz=0.0)
    assert len(schedule) == 160
    jobs.enable(compile_listeners=False)
    jobs.reset()
    try:
        jsrv, jtickets = _serve_schedule(jserve, schedule, lambda r: r)
        jdouble = jobs.counter_value("serve_double_answer")
        jtrace = _trace_report(jtickets)
    finally:
        jobs.disable()
        jobs.reset()
        jbreaker.reset()
    tsrv, ttickets = _serve_schedule(
        serve, schedule,
        lambda r: serve.Request(r.op, r.x, r.params, tenant=r.tenant))
    assert obs.counter_value("serve_double_answer") == jdouble == 0
    for srv in (jsrv, tsrv):
        counts = srv.stats()["counts"]
        assert counts["submitted"] == counts["completed"] == 160
        assert counts["errors"] == counts["shed"] == 0
        assert srv.stats()["admission"]["depth"] == 0
    for report in (jtrace, _trace_report(ttickets)):
        assert report["trace_checked"] == 160
        assert report["trace_orphans"] == report["trace_phase_err"] == 0
    worst = {}
    for (_, req), jt, tt in zip(schedule, jtickets, ttickets):
        assert jt.status == tt.status == "ok"
        got, want = tt.result(), np.asarray(jt.result())
        assert isinstance(got, np.ndarray)
        err = _rel(got, want)
        worst[req.op] = max(worst.get(req.op, 0.0), err)
        assert err <= TOLS[req.op], (req.op, req.x.shape, err)
    assert set(worst) == set(TOLS)


def test_chip_smoke_rebuilds_loadgens_schedule():
    # chip_smoke's serve phase imports nothing of the JAX package or of
    # tools/loadgen.py: its mix draws what build_schedule draws
    import runpy

    cs = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke")
    mine = cs["serve_schedule"](np.random.RandomState(3), 60)
    ref = loadgen.build_schedule(np.random.RandomState(3), 60, rate_hz=0.0)
    assert len(mine) == len(ref) == 60
    for (op, params, x, tenant), (gap, req) in zip(mine, ref):
        assert (op, tenant, gap) == (req.op, req.tenant, 0.0)
        assert np.array_equal(x, req.x)
        assert params.keys() == req.params.keys()
        for k in params:
            np.testing.assert_allclose(params[k], req.params[k],
                                       rtol=1e-12, atol=1e-15)
        assert cs["SERVE_TOL"][op] == TOLS[op]


# ---------------------------------------------------------------------------
# tests/test_serve.py in kind, through the port
# ---------------------------------------------------------------------------

class TestSubmitContract:
    def test_unsupported_op_raises(self):
        with pytest.raises(ValueError, match="unsupported op"):
            serve.Server().submit(serve.Request("fft9000", _signal(64)))

    def test_non_1d_signal_raises(self):
        with pytest.raises(ValueError, match="1-D"):
            serve.Server().submit(serve.Request(
                "sosfilt", np.zeros((2, 64)), {"sos": SOS}))

    def test_stft_shorter_than_frame_raises(self):
        with pytest.raises(ValueError):
            serve.Server().submit(serve.Request(
                "stft", _signal(64), {"frame_length": 128, "hop": 64}))

    def test_unstarted_server_times_out_not_loses(self):
        srv = serve.Server(max_wait_ms=1.0)
        t = srv.submit(serve.Request("sosfilt", _signal(128),
                                     {"sos": SOS}))
        with pytest.raises(TimeoutError):
            t.result(timeout=0.05)
        assert not t.done()
        srv.stop()
        assert t.status == "closed"

    def test_submit_after_stop_raises(self):
        srv = serve.Server()
        srv.start()
        srv.stop()
        with pytest.raises(serve.ServerClosed):
            srv.submit(serve.Request("sosfilt", _signal(128),
                                     {"sos": SOS}))
        with pytest.raises(serve.ServerClosed):
            srv.start()


class TestBatchingPolicy:
    def test_same_class_requests_coalesce(self):
        with serve.Server(max_batch=4, max_wait_ms=60.0,
                          workers=1) as srv:
            xs = [_signal(500) for _ in range(4)]
            ts = [srv.submit(serve.Request("sosfilt", x, {"sos": SOS}))
                  for x in xs]
            outs = [t.result(timeout=120.0) for t in ts]
        assert srv.stats()["counts"]["batches"] == 1
        for x, y in zip(xs, outs):
            assert _rel(y, _sosfilt64(x)) < IIR_TOL

    def test_deadline_answers_partial_batch(self):
        with serve.Server(max_batch=64, max_wait_ms=20.0,
                          workers=1) as srv:
            t = srv.submit(serve.Request("sosfilt", _signal(256),
                                         {"sos": SOS}))
            y = t.result(timeout=120.0)
        assert t.status == "ok"
        assert y.shape == (256,)
        assert t.wait_s is not None and t.wait_s < 60.0

    def test_distinct_shape_classes_do_not_mix(self):
        with serve.Server(max_batch=8, max_wait_ms=5.0,
                          workers=1) as srv:
            a, b = _signal(500), _signal(900)
            ta = srv.submit(serve.Request("sosfilt", a, {"sos": SOS}))
            tb = srv.submit(serve.Request("sosfilt", b, {"sos": SOS}))
            ya, yb = ta.result(timeout=120.0), tb.result(timeout=120.0)
        assert srv.stats()["counts"]["batches"] == 2
        assert ya.shape == (500,) and yb.shape == (900,)
        assert _rel(ya, _sosfilt64(a)) < IIR_TOL
        assert _rel(yb, _sosfilt64(b)) < IIR_TOL

    def test_bucket_padding_is_exact_for_every_op(self):
        n = 777
        x = _signal(n)
        cases = [
            ("sosfilt", {"sos": SOS}, lambda: _sosfilt64(x), IIR_TOL),
            ("lfilter", {"b": [0.2, 0.3, 0.1], "a": [1.0, -0.4]},
             lambda: iir.lfilter_na([0.2, 0.3, 0.1], [1.0, -0.4],
                                    x[None, :])[0], IIR_TOL),
            ("resample_poly", {"up": 3, "down": 2},
             lambda: rs.resample_poly_na(x, 3, 2), IIR_TOL),
            ("stft", {"frame_length": 128, "hop": 64},
             lambda: sp.stft_na(x, 128, 64), STFT_TOL),
        ]
        with serve.Server(max_batch=4, max_wait_ms=5.0) as srv:
            for op, params, oracle, tol in cases:
                t = srv.submit(serve.Request(op, x, params))
                assert _rel(t.result(timeout=300.0), oracle()) < tol

    def test_padding_rows_counted_without_request_axis(self, telemetry):
        obs.configure(request_axis=False)
        try:
            srv = serve.Server(max_batch=4, max_wait_ms=60.0, workers=1)
            ts = [srv.submit(serve.Request("sosfilt", _signal(500),
                                           {"sos": SOS}))
                  for _ in range(3)]
            with srv:
                for t in ts:
                    t.result(timeout=120.0)
                good = srv.goodput()
                stats = srv.stats()
        finally:
            obs.configure(request_axis=True)
        snap = obs.snapshot()

        def counter(name):
            return sum(c["value"] for c in snap["counters"]
                       if c["name"] == name
                       and c["labels"].get("op") == "sosfilt"
                       and c["labels"].get("bucket") == "512")

        assert counter("serve_padding_rows") == 1
        assert counter("serve_useful_rows") == 3
        assert counter("serve_dispatched_rows") == 4
        gauges = {g["name"]: g["value"] for g in snap["gauges"]
                  if g["labels"].get("op") == "sosfilt"
                  and g["labels"].get("bucket") == "512"}
        assert gauges["serve.goodput"] == pytest.approx(0.75)
        assert gauges["serve.padding_waste"] == pytest.approx(0.25)
        assert good["sosfilt|512"]["goodput"] == pytest.approx(0.75)
        assert good["overall"]["goodput"] == pytest.approx(0.75)
        assert stats["goodput"]["overall"]["goodput"] == \
            pytest.approx(0.75)
        assert srv.counts()["useful_rows"] == 3
        assert srv.counts()["dispatched_rows"] == 4


class TestAdmission:
    def test_bounds_and_typed_overloaded(self):
        ac = serve.AdmissionController(max_depth=3, max_tenant_depth=2)
        ac.admit("a")
        ac.admit("a")
        with pytest.raises(serve.Overloaded) as ei:
            ac.admit("a")
        assert ei.value.scope == "tenant"
        assert faults.is_overload(ei.value)
        ac.admit("b")
        with pytest.raises(serve.Overloaded) as ei:
            ac.admit("c")
        assert ei.value.scope == "global"
        ac.release("a")
        ac.admit("c")
        snap = ac.snapshot()
        assert snap["depth"] == 3 and snap["shed"] == 2

    def test_backpressure_blocks_until_release(self):
        ac = serve.AdmissionController(max_depth=1, max_tenant_depth=1)
        ac.admit("a")
        done = threading.Event()

        def blocked():
            ac.admit("a", block=True, timeout=30.0)
            done.set()

        t = threading.Thread(target=blocked)
        t.start()
        assert not done.wait(0.05)
        ac.release("a")
        assert done.wait(5.0)
        t.join(timeout=5.0)
        assert not t.is_alive()

    def test_backpressure_deadline_expires_typed(self):
        ac = serve.AdmissionController(max_depth=1, max_tenant_depth=1)
        ac.admit("a")
        with pytest.raises(serve.Overloaded) as ei:
            ac.admit("a", block=True, timeout=0.05)
        assert ei.value.scope == "deadline"

    def test_injected_overload_sheds_deterministically(self, telemetry):
        with faults.fault_plan("serve.admission:overload:2"):
            with serve.Server(max_batch=2, max_wait_ms=5.0) as srv:
                ts = [srv.submit(serve.Request(
                    "sosfilt", _signal(256), {"sos": SOS}))
                    for _ in range(4)]
                statuses = []
                for t in ts:
                    try:
                        t.result(timeout=120.0)
                    except serve.Overloaded as e:
                        assert e.scope == "injected"
                    statuses.append(t.status)
        assert statuses == ["shed", "shed", "ok", "ok"]
        assert obs.counter_value("serve_shed", tenant="default",
                                 scope="injected") == 2


class TestHealthMachine:
    def test_degrade_parity_then_probed_recovery(self, telemetry):
        with faults.fault_plan("serve.dispatch:device_lost:3"):
            with serve.Server(max_batch=1, max_wait_ms=2.0,
                              workers=1, probe_every=2) as srv:
                xs = [_signal(256) for _ in range(3)]
                outs, statuses = [], []
                for x in xs:
                    t = srv.submit(serve.Request("sosfilt", x,
                                                 {"sos": SOS}))
                    outs.append(t.result(timeout=120.0))
                    statuses.append(t.status)
                health = srv.stats()["health"]
        assert statuses == ["degraded", "degraded", "ok"]
        for x, y in zip(xs[:2], outs[:2]):
            # a degraded answer IS the simd=False oracle's
            want = serve.server._oracle_call(
                "sosfilt", x[None, :], {"sos": np.asarray(SOS)})[0]
            assert np.array_equal(y, want)
        for x, y in zip(xs, outs):
            assert _rel(y, _sosfilt64(x)) < IIR_TOL
        assert health["state"] == serve.HEALTHY
        assert health["trips"] == 1 and health["recoveries"] == 1
        assert obs.counter_value("fault_exhausted",
                                 site="serve.dispatch",
                                 kind="device_lost") == 1
        assert obs.counter_value("serve_recovered",
                                 site="serve.dispatch") == 1
        decisions = [(e["op"], e["decision"]) for e in obs.events()]
        assert ("serve_health", "degrade") in decisions
        assert ("serve_health", "recover") in decisions

    def test_probe_failure_stays_degraded(self, telemetry):
        with faults.fault_plan("serve.dispatch:device_lost:4"):
            with serve.Server(max_batch=1, max_wait_ms=2.0,
                              workers=1, probe_every=1) as srv:
                statuses = []
                for _ in range(3):
                    t = srv.submit(serve.Request(
                        "sosfilt", _signal(256), {"sos": SOS}))
                    t.result(timeout=120.0)
                    statuses.append(t.status)
                health = srv.stats()["health"]
        assert statuses == ["degraded", "degraded", "ok"]
        assert health["trips"] == 2
        assert health["recoveries"] == 1
        assert health["probes"] == 2

    def test_poisoned_class_opens_its_breaker_siblings_ok(self,
                                                          telemetry):
        # the resilience triad's breaker leg: sosfilt's classes go to
        # the oracle behind an open breaker, lfilter stays on the
        # device, and the breaker recloses once the plan clears
        lf = {"b": [0.2, 0.3, 0.1], "a": [1.0, -0.4, 0.1]}
        with serve.Server(max_batch=1, max_wait_ms=1.0, workers=1,
                          probe_every=1) as srv:
            faults.set_fault_plan("serve.dispatch@sosfilt:device_lost:9999")
            try:
                sos_status = []
                for _ in range(6):
                    t = srv.submit(serve.Request(
                        "sosfilt", _signal(256), {"sos": SOS}))
                    t.result(timeout=60.0)
                    sos_status.append(t.status)
                sib = srv.submit(serve.Request("lfilter", _signal(256),
                                               lf))
                sib.result(timeout=60.0)
                states = {b["key"]: b["state"]
                          for b in srv.stats()["breakers"]}
            finally:
                faults.set_fault_plan(None)
            assert set(sos_status) == {"degraded"}
            assert sib.status == "ok"
            assert "open" in states.values()
            after = []
            for _ in range(12):
                t = srv.submit(serve.Request("sosfilt", _signal(256),
                                             {"sos": SOS}))
                t.result(timeout=60.0)
                after.append(t.status)
            closed = {b["key"]: b["state"]
                      for b in srv.stats()["breakers"]}
        assert after[-1] == "ok"
        assert set(closed.values()) == {"closed"}


class TestConcurrency:
    def test_producer_threads_mixed_classes(self, telemetry):
        n_threads, per_thread = 6, 12
        lengths = (256, 500)
        with serve.Server(max_batch=8, max_wait_ms=5.0, workers=2,
                          queue_depth=4096, tenant_depth=4096) as srv:
            all_tickets = [[] for _ in range(n_threads)]
            payloads = [[] for _ in range(n_threads)]

            def producer(slot):
                rng = np.random.RandomState(slot)
                for i in range(per_thread):
                    x = rng.randn(
                        lengths[i % len(lengths)]).astype(np.float32)
                    all_tickets[slot].append(srv.submit(serve.Request(
                        "sosfilt", x, {"sos": SOS}, tenant=f"t{slot}")))
                    payloads[slot].append(x)

            prev = sys.getswitchinterval()
            sys.setswitchinterval(1e-5)
            try:
                threads = [threading.Thread(target=producer, args=(s,))
                           for s in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120.0)
                    assert not t.is_alive()
            finally:
                sys.setswitchinterval(prev)
            flat = [(x, tk) for xs, tks in zip(payloads, all_tickets)
                    for x, tk in zip(xs, tks)]
            outs = [(x, tk, tk.result(timeout=300.0)) for x, tk in flat]
        assert len(outs) == n_threads * per_thread
        assert all(tk.done() for _, tk, _ in outs)
        assert obs.counter_value("serve_double_answer") == 0
        assert srv.stats()["counts"]["completed"] == len(outs)
        for x, _, y in outs[:: len(outs) // 8 or 1]:
            assert _rel(y, _sosfilt64(x)) < IIR_TOL
        assert srv.stats()["admission"]["depth"] == 0

    def test_double_completion_raises_and_counts(self, telemetry):
        t = serve.Ticket("sosfilt", "a")
        t._complete(value=1)
        with pytest.raises(RuntimeError, match="completed twice"):
            t._complete(value=2)
        assert obs.counter_value("serve_double_answer",
                                 op="sosfilt") == 1
        assert t.result() == 1


def test_latency_histogram_has_no_survivorship_bias(telemetry):
    with serve.Server(max_batch=8, max_wait_ms=200.0, workers=1,
                      queue_depth=64) as srv:
        srv.submit(serve.Request("sosfilt", _signal(256),
                                 {"sos": SOS})).result(timeout=30.0)
        expired = srv.submit(serve.Request("sosfilt", _signal(256),
                                           {"sos": SOS}),
                             deadline_ms=1e-4)
        with pytest.raises(serve.DeadlineExceeded):
            expired.result(timeout=30.0)
    with faults.fault_plan("serve.admission:overload:1"):
        with serve.Server(max_batch=8, max_wait_ms=1.0,
                          workers=1) as srv:
            shed = srv.submit(serve.Request("sosfilt", _signal(256),
                                            {"sos": SOS}))
            assert shed.status == "shed"
    by_status = {h["labels"]["status"]: h["count"]
                 for h in obs.snapshot()["histograms"]
                 if h["name"] == "serve.request_latency"
                 and h["labels"].get("op") == "sosfilt"}
    assert by_status.get("ok", 0) >= 1
    assert by_status.get("expired", 0) == 1
    assert by_status.get("shed", 0) == 1
    assert obs.counter_value("serve_completed", op="sosfilt",
                             status="expired") == 1
    assert obs.counter_value("serve_completed", op="sosfilt",
                             status="shed") == 1


def test_stop_nodrain_closes_traces_with_terminal_edge(telemetry):
    srv = serve.Server(max_batch=32, max_wait_ms=60000.0, workers=1)
    srv.start()
    tickets = [srv.submit(serve.Request("sosfilt", _signal(256),
                                        {"sos": SOS})) for _ in range(3)]
    srv.stop(drain=False)
    for t in tickets:
        assert t.status == "closed"
        with pytest.raises(serve.ServerClosed):
            t.result(timeout=1.0)
        assert t.trace.status == "closed"
        assert t.trace.events()[-1]["event"] in ("closed", "error")
    by_status = {h["labels"]["status"]: h["count"]
                 for h in obs.snapshot()["histograms"]
                 if h["name"] == "serve.request_latency"
                 and h["labels"].get("op") == "sosfilt"}
    assert by_status.get("closed", 0) == 3
    assert srv._admission.depth() == 0


def test_stop_nodrain_unstarted_server_loses_nothing(telemetry):
    srv = serve.Server(max_wait_ms=1.0)
    tickets = [srv.submit(serve.Request("sosfilt", _signal(128),
                                        {"sos": SOS})) for _ in range(4)]
    srv.stop(drain=False)
    for t in tickets:
        assert t.done() and t.status == "closed"
        assert t.trace.status == "closed"
    assert srv._admission.depth() == 0
    srv2 = serve.Server(max_wait_ms=1.0)
    t2 = srv2.submit(serve.Request("sosfilt", _signal(128),
                                   {"sos": SOS}))
    srv2.stop(drain=True)
    assert t2.done() and t2.status == "closed"


def test_obs_port_conflict_raises_typed_at_start(telemetry):
    first = serve.Server(max_wait_ms=1.0, obs_port=0).start()
    try:
        second = serve.Server(max_wait_ms=1.0, obs_port=first.obs_port)
        with pytest.raises(obs_http.EndpointUnavailable) as ei:
            second.start()
        assert ei.value.port == first.obs_port
        assert "obs_port=0" in str(ei.value)
        assert not second._started
        assert second._threads == []
        second._obs_port_arg = 0
        second.start()
        assert second.obs_port not in (None, first.obs_port)
        second.stop()
    finally:
        first.stop()


class TestDeadlines:
    def test_expired_request_is_shed_typed_before_dispatch(self,
                                                           telemetry):
        with serve.Server(max_batch=8, max_wait_ms=500.0,
                          workers=1) as srv:
            t = srv.submit(serve.Request("sosfilt", _signal(256),
                                         {"sos": SOS}), deadline_ms=15.0)
            with pytest.raises(serve.DeadlineExceeded) as ei:
                t.result(timeout=30.0)
            batches = srv.stats()["counts"]["batches"]
        assert t.status == "expired"
        assert faults.is_timeout(ei.value)
        assert batches == 0
        assert obs.counter_value("serve_deadline_miss", op="sosfilt",
                                 tenant="default") == 1
        assert srv.stats()["counts"]["expired"] == 1
        assert srv.stats()["admission"]["depth"] == 0

    def test_head_of_line_expiry_does_not_wedge_bucket(self, telemetry):
        with serve.Server(max_batch=8, max_wait_ms=150.0,
                          workers=1) as srv:
            t1 = srv.submit(serve.Request("sosfilt", _signal(256),
                                          {"sos": SOS}), deadline_ms=10.0)
            t2 = srv.submit(serve.Request("sosfilt", _signal(256),
                                          {"sos": SOS}),
                            deadline_ms=5000.0)
            with pytest.raises(serve.DeadlineExceeded):
                t1.result(timeout=30.0)
            y2 = t2.result(timeout=120.0)
        assert (t1.status, t2.status) == ("expired", "ok")
        assert y2.shape == (256,)
        assert srv.stats()["counts"]["batches"] == 1

    def test_fully_expired_bucket_dispatches_nothing(self, telemetry):
        with serve.Server(max_batch=8, max_wait_ms=300.0,
                          workers=1) as srv:
            ts = [srv.submit(serve.Request("sosfilt", _signal(256),
                                           {"sos": SOS}), deadline_ms=10.0)
                  for _ in range(4)]
            for t in ts:
                with pytest.raises(serve.DeadlineExceeded):
                    t.result(timeout=30.0)
            assert srv.stats()["counts"]["batches"] == 0
            assert srv.stats()["counts"]["expired"] == 4

    def test_env_default_deadline(self, telemetry, monkeypatch):
        monkeypatch.setenv(serve.DEADLINE_ENV, "15")
        assert serve.env_deadline_ms() == 15.0
        with serve.Server(max_batch=8, max_wait_ms=500.0,
                          workers=1) as srv:
            t = srv.submit(serve.Request("sosfilt", _signal(256),
                                         {"sos": SOS}))
            with pytest.raises(serve.DeadlineExceeded):
                t.result(timeout=30.0)
        assert t.status == "expired"
        for raw in ("", "0", "-4", "junk", "2.5"):
            monkeypatch.setenv(serve.DEADLINE_ENV, raw)
            assert serve.env_deadline_ms() == jserve.env_deadline_ms()

    def test_deadline_under_fault_storm_is_answered_in_budget(
            self, telemetry, monkeypatch):
        monkeypatch.setenv("VELES_SIMD_FAULT_BACKOFF", "0.02")
        monkeypatch.setenv("VELES_SIMD_FAULT_RETRIES", "10000")
        with faults.fault_plan("serve.dispatch:device_lost:100000"):
            with serve.Server(max_batch=1, max_wait_ms=2.0,
                              workers=1) as srv:
                t0 = faults.monotonic()
                t = srv.submit(serve.Request("sosfilt", _signal(256),
                                             {"sos": SOS}),
                               deadline_ms=150.0)
                y = t.result(timeout=30.0)
                elapsed = faults.monotonic() - t0
        assert t.status == "degraded"
        assert y.shape == (256,)
        assert elapsed < 2.0
        assert obs.counter_value("fault_budget_clipped",
                                 site="serve.dispatch") == 1

    def test_deadline_slack_histogram_flows(self, telemetry):
        with serve.Server(max_batch=1, max_wait_ms=2.0,
                          workers=1) as srv:
            srv.submit(serve.Request("sosfilt", _signal(256),
                                     {"sos": SOS}),
                       deadline_ms=60000.0).result(timeout=120.0)
        assert any(h["name"] == "serve.deadline_slack"
                   for h in obs.snapshot()["histograms"])


class TestRaggedServe:
    def test_ragged_classing_is_env_gated(self, monkeypatch):
        params = {"frame_length": 128, "hop": 64}
        monkeypatch.setenv(tserver.RAGGED_ENV, "0")
        *_, key = tserver.classify_request("stft", _signal(300), params)
        assert key == ("stft", (128, 64), 512)
        monkeypatch.setenv(tserver.RAGGED_ENV, "1")
        *_, key = tserver.classify_request("stft", _signal(300), params)
        assert key == ("stft", (128, 64), "ragged")
        n_long = tserver.ragged_max() + 1
        *_, key = tserver.classify_request("stft", _signal(n_long),
                                           params)
        assert key[-1] == tserver.bucket_length(n_long)
        *_, key = tserver.classify_request("sosfilt", _signal(300),
                                           {"sos": SOS})
        assert key[-1] == 512
        for raw in ("", "100", "junk", "0"):
            monkeypatch.setenv(tserver.RAGGED_MAX_ENV, raw)
            assert tserver.ragged_max() == jserve.server.ragged_max()

    def test_ragged_parity_and_sample_accounting(self, telemetry,
                                                 monkeypatch):
        monkeypatch.setenv(tserver.RAGGED_ENV, "1")
        lens = (200, 128, 513, 300)
        xs = [_signal(n) for n in lens]
        srv = serve.Server(max_batch=8, max_wait_ms=20.0, workers=1)
        ts = [srv.submit(serve.Request(
            "stft", x, {"frame_length": 128, "hop": 64})) for x in xs]
        with srv:
            for t, x in zip(ts, xs):
                got = t.result(timeout=120.0)
                assert _rel(got, sp.stft_na(x, 128, 64)) < STFT_TOL
                assert t.status == "ok"
        snap = obs.snapshot()

        def counter(name):
            return sum(c["value"] for c in snap["counters"]
                       if c["name"] == name
                       and c["labels"].get("bucket") == "ragged")

        width, rows, _ = seg.plan_pack([seg.stft_stride(n, 64)
                                        for n in lens])
        assert counter("serve_useful_samples") == sum(lens)
        assert counter("serve_dispatched_samples") == rows * width
        assert counter("serve_useful_rows") == rows
        assert counter("serve_dispatched_rows") == rows
        gp = srv.goodput()["stft|ragged"]
        assert 0.0 < gp["sample_goodput"] <= 1.0
        assert gp["useful_samples"] == sum(lens)

    def test_ragged_fault_degrades_one_ticket_only(self, telemetry,
                                                   monkeypatch):
        monkeypatch.setenv(tserver.RAGGED_ENV, "1")
        xs = [_signal(n) for n in (200, 128, 300)]
        faults.set_fault_plan("segments.dispatch@stft:device_lost:3,"
                              "segments.segment@1:device_lost:1")
        srv = serve.Server(max_batch=8, max_wait_ms=20.0, workers=1)
        ts = [srv.submit(serve.Request(
            "stft", x, {"frame_length": 128, "hop": 64})) for x in xs]
        with srv:
            vals = [t.result(timeout=120.0) for t in ts]
        assert [t.status for t in ts] == ["ok", "degraded", "ok"]
        for v, x in zip(vals, xs):
            assert _rel(v, sp.stft_na(x, 128, 64)) < STFT_TOL
        assert "degraded" in [e["event"] for e in ts[1].trace.events()]

    def test_refill_rides_expiry_freed_slots(self, telemetry,
                                             monkeypatch):
        monkeypatch.setenv(tserver.CONTINUOUS_ENV, "1")
        srv = serve.Server(max_batch=4, max_wait_ms=20.0, workers=1)
        doomed = srv.submit(serve.Request(
            "sosfilt", _signal(400), {"sos": SOS}), deadline_ms=60.0)
        live = [srv.submit(serve.Request(
            "sosfilt", _signal(400), {"sos": SOS})) for _ in range(3)]
        key, batch = srv._batcher.next_batch()
        assert len(batch) == 4
        rider = srv.submit(serve.Request("sosfilt", _signal(400),
                                         {"sos": SOS}))
        time.sleep(0.2)     # doomed's deadline lapses after the take
        srv._run_batch(key, batch)
        with pytest.raises(serve.DeadlineExceeded):
            doomed.result(timeout=5.0)
        for t in live + [rider]:
            t.result(timeout=5.0)
            assert t.status == "ok"
        formed = [e for e in rider.trace.events()
                  if e["event"] == "batch_formed"]
        assert formed and formed[0].get("refilled") is True
        assert srv.stats()["counts"]["refilled_rows"] == 1
        srv.stop()

    def test_refill_disabled_leaves_queue_untouched(self, telemetry,
                                                    monkeypatch):
        monkeypatch.setenv(tserver.CONTINUOUS_ENV, "0")
        srv = serve.Server(max_batch=4, max_wait_ms=20.0, workers=1)
        live = [srv.submit(serve.Request(
            "sosfilt", _signal(400), {"sos": SOS})) for _ in range(3)]
        key, batch = srv._batcher.next_batch()
        assert len(batch) == 3
        rider = srv.submit(serve.Request("sosfilt", _signal(400),
                                         {"sos": SOS}))
        srv._run_batch(key, batch)
        for t in live:
            t.result(timeout=5.0)
            assert t.status == "ok"
        assert srv.stats()["counts"]["refilled_rows"] == 0
        assert not rider.done()
        with srv:
            rider.result(timeout=120.0)
            assert rider.status == "ok"
        formed = [e for e in rider.trace.events()
                  if e["event"] == "batch_formed"]
        assert formed and not formed[0].get("refilled")


# ---------------------------------------------------------------------------
# what the card changes
# ---------------------------------------------------------------------------

def _count_copies(monkeypatch):
    """Record the shape of every tensor ``.cpu()`` copies."""
    shapes = []
    original = torch.Tensor.cpu

    def cpu(self, *args, **kwargs):
        shapes.append(tuple(self.shape))
        return original(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    return shapes


@pytest.mark.parametrize("op,params,n,out_shape", [
    ("sosfilt", {"sos": SOS}, 500, (512,)),
    ("resample_poly", {"up": 3, "down": 2}, 300, (768,)),
    ("stft", {"frame_length": 128, "hop": 64}, 1000, (15, 65)),
])
def test_one_copy_back_per_batch(monkeypatch, op, params, n, out_shape):
    srv = serve.Server(max_batch=8, max_wait_ms=50.0, workers=1)
    xs = [_signal(n) for _ in range(5)]
    ts = [srv.submit(serve.Request(op, x, params)) for x in xs]
    shapes = _count_copies(monkeypatch)
    with srv:
        outs = [t.result(timeout=60.0) for t in ts]
    # one batch of 5 rows padded to 8: the answer crossed once, whole
    assert srv.stats()["counts"]["batches"] == 1
    assert shapes.count((8,) + out_shape) == 1
    assert not [s for s in shapes if s == out_shape]     # never per row
    assert all(isinstance(y, np.ndarray) for y in outs)


def test_the_trace_device_phase_ends_after_the_copy(monkeypatch,
                                                    telemetry):
    # the copy back runs before any ticket completes: a slow copy
    # lands in the device phase of every co-batched trace
    original = tserver._platform.to_host

    def slow(ys):
        time.sleep(0.05)
        return original(ys)

    monkeypatch.setattr(tserver._platform, "to_host", slow)
    srv = serve.Server(max_batch=4, max_wait_ms=50.0, workers=1)
    ts = [srv.submit(serve.Request("sosfilt", _signal(500),
                                   {"sos": SOS})) for _ in range(2)]
    with srv:
        for t in ts:
            t.result(timeout=60.0)
    for t in ts:
        assert t.trace.phases()["device_s"] >= 0.05
        assert _phase_drift(t.trace) <= 1e-3


@pytest.fixture
def warm_pack(tmp_path, monkeypatch):
    """A warm pack bound through ``$VELES_SIMD_ARTIFACT_DIR``: a
    stand-in kernel library (random bytes where nvcc's output would be;
    nothing on the CPU loads it) packed in ``on`` mode, and an empty
    build root for the server to fill.  Yields the pack directory and
    where the library must land."""
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.runtime import artifacts as art

    prev = ck.set_build_root()
    ck.set_build_root(tmp_path / "built")
    out = ck._build_dir()
    out.mkdir(parents=True)
    (out / ck._LIB_NAME).write_bytes(np.random.RandomState(5).bytes(512))
    (out / "build.log").write_text("stand-in build log\n")
    pack = str(tmp_path / "pack")
    with art.private_artifact_store(pack), art.artifacts_mode_override("on"):
        assert art.store_kernel_library() == "stored"
    ck.set_build_root(tmp_path / "fresh")
    monkeypatch.setenv(art.ARTIFACT_DIR_ENV, pack)
    try:
        yield pack, ck._build_dir() / ck._LIB_NAME
    finally:
        ck.set_build_root(prev)


@pytest.mark.parametrize("mode", ["on", "readonly", " ON "])
def test_armed_artifact_store_preloads_at_start(monkeypatch, warm_pack,
                                                mode):
    pack, placed = warm_pack
    monkeypatch.setenv(tserver.ARTIFACTS_ENV, mode)
    srv = serve.Server(obs_port=0, workers=1)
    assert not placed.exists()
    srv.start()
    try:
        report = srv.stats()["artifact_preload"]
        assert report == {"loaded": 1, "failed": 0,
                          "mode": mode.strip().lower(), "path": pack}
        assert placed.exists()       # load_library's cache-hit path
        assert srv._started and len(srv._threads) == 1
        assert srv.obs_port is not None
        x = _signal(300)
        y = srv.submit(serve.Request("sosfilt", x, {"sos": SOS})).result(
            timeout=60.0)
        assert _rel(y, iir.sosfilt(SOS, x, simd=False)) <= IIR_TOL
    finally:
        srv.stop()


def test_stale_pack_starts_cold_and_never_raises(monkeypatch, warm_pack):
    pack, placed = warm_pack
    path = Path(pack) / "MANIFEST.json"
    manifest = json.loads(path.read_text())
    manifest["device"] = "NVIDIA H100 80GB HBM3 sm_90"
    path.write_text(json.dumps(manifest))
    monkeypatch.setenv(tserver.ARTIFACTS_ENV, "readonly")
    obs.enable(compile_listeners=False)
    obs.reset()
    try:
        with serve.Server(workers=1) as srv:
            report = srv.stats()["artifact_preload"]
        assert report["loaded"] == 0 and report["failed"] == 1
        assert obs.counter_value("artifact_stale", op="kernels",
                                 route="cuda") == 1
    finally:
        obs.disable()
        obs.reset()
    assert not placed.exists()


def test_failed_preload_counts_and_starts_cold(monkeypatch, warm_pack):
    def broken():
        raise OSError("pack unreadable")

    monkeypatch.setattr(tserver._artifacts, "preload", broken)
    monkeypatch.setenv(tserver.ARTIFACTS_ENV, "on")
    obs.enable(compile_listeners=False)
    obs.reset()
    try:
        with serve.Server(workers=1) as srv:
            assert srv.stats()["artifact_preload"] is None
            x = _signal(200)
            y = srv.submit(serve.Request("sosfilt", x, {"sos": SOS})
                           ).result(timeout=60.0)
        assert obs.counter_value("artifact_preload_error") == 1
    finally:
        obs.disable()
        obs.reset()
    assert _rel(y, iir.sosfilt(SOS, x, simd=False)) <= IIR_TOL


@pytest.mark.parametrize("mode", [None, "off", "junk"])
def test_artifact_store_off_starts_with_no_preload(monkeypatch, mode):
    if mode is not None:
        monkeypatch.setenv(tserver.ARTIFACTS_ENV, mode)
    from veles.simd_tpu.runtime import artifacts as jart

    assert jart.artifacts_mode() == "off"
    with serve.Server(workers=1) as srv:
        assert srv.stats()["artifact_preload"] is None


def test_capture_gate_keeps_a_capture_exclusive():
    gate = tserver._CaptureGate()
    log, entered = [], threading.Event()
    release = threading.Event()

    def plain():
        with gate.shared():
            log.append("plain in")
            entered.set()
            release.wait(10.0)
            log.append("plain out")

    def capture():
        with gate.exclusive():
            log.append("capture")

    def late_plain():
        with gate.shared():
            log.append("late plain")

    a = threading.Thread(target=plain)
    a.start()
    assert entered.wait(10.0)
    b = threading.Thread(target=capture)
    b.start()
    time.sleep(0.05)
    c = threading.Thread(target=late_plain)
    c.start()
    time.sleep(0.05)
    # the capture waits for the plain batch, the late one for it
    assert log == ["plain in"]
    release.set()
    for t in (a, b, c):
        t.join(timeout=10.0)
        assert not t.is_alive()
    assert log == ["plain in", "plain out", "capture", "late plain"]


def test_every_server_in_a_process_holds_one_capture_gate():
    # global capture mode spans the process's threads, so one server's
    # capture must keep out another server's device sections: two
    # servers hold the same gate, and an exclusive section on one keeps
    # out a shared section on the other until it is done
    a, b = serve.Server(workers=1), serve.Server(workers=1, name="r1")
    assert a._gate is b._gate is tserver._GATE
    log, inside = [], threading.Event()
    release = threading.Event()

    def capture():
        with a._gate.exclusive():
            log.append("capture in")
            inside.set()
            release.wait(10.0)
            log.append("capture out")

    def plain():
        with b._gate.shared():
            log.append("plain")

    t1 = threading.Thread(target=capture)
    t1.start()
    assert inside.wait(10.0)
    t2 = threading.Thread(target=plain)
    t2.start()
    time.sleep(0.05)
    assert log == ["capture in"]
    release.set()
    for t in (t1, t2):
        t.join(timeout=10.0)
        assert not t.is_alive()
    assert log == ["capture in", "capture out", "plain"]


def test_pipeline_capture_is_exclusive_only_on_the_card(monkeypatch):
    cp = tpl.pipeline_from_spec(loadgen.pipeline_spec("gate", 256))
    assert not cp.captures((8, 256))        # the CPU never captures
    monkeypatch.setattr(cp, "device", torch.device("cuda"))
    assert cp.captures((8, 256))
    cp._graphs[(8, 256)] = object()
    assert not cp.captures((8, 256)) and cp.captures((4, 256))


def _served_stream(srv, op, blocks, state=None):
    outs, statuses = [], []
    for b in blocks:
        t = srv.submit(op=op, x=b, params={"state": state})
        out, state = t.result(timeout=60.0)
        outs.append(out)
        statuses.append(t.status)
    return outs, state, statuses


def test_served_pipeline_degraded_block_keeps_state_exact(telemetry):
    cp = tpl.pipeline_from_spec(loadgen.pipeline_spec("served", 256))
    x = _signal(6 * 256)
    blocks = [x[i:i + 256] for i in range(0, x.size, 256)]
    want = cp.oracle(x)
    with serve.Server(max_batch=2, max_wait_ms=1.0, workers=1) as srv:
        op = srv.register_pipeline("served", cp)
        clean, _, st_clean = _served_stream(srv, op, blocks)
        # block 3 exhausts its retries (default 2) and degrades to the
        # stage-by-stage oracle; the stream goes on from its state
        outs, state = [], None
        statuses = []
        for i, b in enumerate(blocks):
            plan = "pipeline.dispatch:device_lost:3" if i == 3 else None
            faults.set_fault_plan(plan)
            try:
                t = srv.submit(op=op, x=b, params={"state": state})
                out, state = t.result(timeout=60.0)
            finally:
                faults.set_fault_plan(None)
            outs.append(out)
            statuses.append(t.status)
    assert st_clean == ["ok"] * 6
    assert statuses == ["ok", "ok", "ok", "degraded", "ok", "ok"]
    got = cp.assemble(outs)
    assert _rel(got, want) <= 1e-5
    assert _rel(cp.assemble(clean), want) <= 1e-5
    # the degraded block IS the oracle twin's answer on that state
    assert _rel(outs[3], cp.assemble(clean[3:4])) <= 1e-5
    # the served stream equals process() on the same blocks
    st = None
    for i, b in enumerate(blocks):
        out, st = cp.process(b, st)
        assert _rel(outs[i], np.asarray(out)) <= 1e-6
    assert all(isinstance(o, np.ndarray) for o in outs)


def test_served_pipeline_equals_the_jax_served_pipeline(telemetry):
    spec = loadgen.pipeline_spec("both", 256)
    x = _signal(4 * 256)
    blocks = [x[i:i + 256] for i in range(0, x.size, 256)]
    jobs.enable(compile_listeners=False)
    try:
        with jserve.Server(max_batch=2, max_wait_ms=1.0,
                           workers=1) as jsrv:
            from veles.simd_tpu import pipeline as jpl

            jop = jsrv.register_pipeline("both",
                                         jpl.pipeline_from_spec(spec))
            jouts, _, jst = _served_stream(jsrv, jop, blocks)
    finally:
        jobs.disable()
        jobs.reset()
        jbreaker.reset()
    with serve.Server(max_batch=2, max_wait_ms=1.0, workers=1) as srv:
        op = srv.register_pipeline("both", tpl.pipeline_from_spec(spec))
        touts, _, tst = _served_stream(srv, op, blocks)
    assert jst == tst == ["ok"] * 4
    for a, b in zip(touts, jouts):
        assert _rel(a, np.asarray(b)) <= 1e-5


def test_register_pipeline_validates(telemetry):
    srv = serve.Server()
    with pytest.raises(TypeError):
        srv.register_pipeline("p", object())
    cp = tpl.pipeline_from_spec(loadgen.pipeline_spec("valid", 256))
    with pytest.raises(ValueError):
        srv.register_pipeline("a:b", cp)
    op = srv.register_pipeline("valid", cp)
    assert op == "pipeline:valid" and srv.pipeline("valid") is cp
    with pytest.raises(ValueError, match="unregistered"):
        srv.submit(op="pipeline:nope", x=_signal(256))
    with pytest.raises(ValueError, match="256-sample block"):
        srv.submit(op=op, x=_signal(128))
    with pytest.raises(ValueError):
        srv.submit(op=op, x=_signal(256), params={"state": (1, 2, 3)})
    srv.stop()
