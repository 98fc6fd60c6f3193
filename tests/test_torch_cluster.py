"""The port's replica layer (``veles/simd_tpu_torch/serve/cluster.py``)
against the JAX package's.

On the CPU (``set_config(device="cpu")``, ``JAX_PLATFORMS=cpu``):

* the router's score and placement over the same replica states
  (admitted depth, an open per-class breaker, a degraded health
  machine, batch occupancy), equal between the packages, for both
  policies;
* the slice as a whole: one seeded loadgen schedule through a JAX
  thread group and a port thread group (3 replicas, ``max_batch`` 32,
  150 ms ``max_wait``, 2 workers: the JAX replica campaign's geometry,
  ``tools/chaos.py:596-609``), with the same kill of r0 and drain of
  r1 mid-traffic — every answer ``ok`` and within 2e-5 (IIR,
  resampling) or 1e-4 (STFT) of max|y| of the other package's, none
  lost or answered twice, every trace closed, a failover with its
  deadline carried in each;
* the fleet axis on a live group: the collector feeds
  ``obs.signals()`` and the group endpoint's ``/signals``,
  ``/incidents`` and ``/scaler``; a kill reads ``down``; a failed-over
  ticket stitches across two replicas;
* subprocess replicas with ``--device cpu``: a round trip over the RPC
  data plane with a pipeline spec, a SIGKILL failing over, a child
  told ``cuda`` where no card is refusing to start, and an armed
  artifact store's warm pack preloaded in both spawn modes;
* ``tools/lint.py``'s fleet rules (``cluster_router_errors``,
  ``rpc_transport_errors``, ``scaler_control_errors``,
  ``fleet_funnel_errors``) on the port's sources read as the JAX
  package's, each shown not to be vacuous.

The same path on the card: chip_smoke's ``fleet`` phase and
``tests/test_torch_cuda.py -k fleet``.
"""

import ast
import dataclasses
import json
import sys
import time
import urllib.error
import urllib.request
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
from veles.simd_tpu.obs import incidents as jinc  # noqa: E402
from veles.simd_tpu.runtime import breaker as jbreaker  # noqa: E402
from veles.simd_tpu.serve import cluster as jcluster  # noqa: E402
from veles.simd_tpu_torch import obs, serve  # noqa: E402
from veles.simd_tpu_torch import pipeline as tpl  # noqa: E402
from veles.simd_tpu_torch.obs import http as obs_http  # noqa: E402
from veles.simd_tpu_torch.obs import incidents  # noqa: E402
from veles.simd_tpu_torch.ops import iir  # noqa: E402
from veles.simd_tpu_torch.runtime import breaker, faults  # noqa: E402
from veles.simd_tpu_torch.serve import cluster  # noqa: E402
from veles.simd_tpu_torch.serve import server as tserver  # noqa: E402
from veles.simd_tpu_torch.utils import config  # noqa: E402

RNG = np.random.RandomState(29)
SOS = iir.butterworth(4, 0.25, "lowpass")
IIR_TOL = 2e-5          # of max|y|: IIR and resampling
STFT_TOL = 1e-4
TOLS = {"sosfilt": IIR_TOL, "lfilter": IIR_TOL,
        "resample_poly": IIR_TOL, "stft": STFT_TOL}
FLEET_SOURCES = ("__init__", "admission", "health", "batcher", "server",
                 "cluster", "rpc", "scaler")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    prev = config.get_config()
    config.set_config(device="cpu")
    monkeypatch.setenv("VELES_SIMD_FAULT_BACKOFF", "0")
    for name in (tserver.ARTIFACTS_ENV, tserver.DEADLINE_ENV,
                 obs_http.OBS_PORT_ENV, cluster.ROUTER_POLICY_ENV,
                 cluster.REPLICAS_ENV, "VELES_SIMD_SCALER",
                 "VELES_SIMD_FAULT_PLAN"):
        monkeypatch.delenv(name, raising=False)
    obs.enable(compile_listeners=False)
    obs.reset()
    breaker.reset()
    faults.reset_fault_history()
    incidents._reset_for_tests()
    yield
    incidents._reset_for_tests()
    obs.disable()
    obs.reset()
    breaker.reset()
    faults.reset_fault_history()
    faults.set_fault_plan(None)
    config.set_config(**dataclasses.asdict(prev))


@pytest.fixture
def jax_telemetry():
    jobs.enable(compile_listeners=False)
    jobs.reset()
    jbreaker.reset()
    jinc._reset_for_tests()
    yield
    jinc._reset_for_tests()
    jobs.disable()
    jobs.reset()
    jbreaker.reset()


def _rel(got, want):
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))
                 / (float(np.max(np.abs(want))) or 1.0))


def _wait_until(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10.0) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# ---------------------------------------------------------------------------
# the router's score and placement, equal between the packages
# ---------------------------------------------------------------------------

KEYS = (("sosfilt", (), 512), ("stft", (128, 64), 1024),
        ("sosfilt", (), 1024, "ragged"))


def _shape_states(mod_cluster, mod_breaker, group):
    """The same replica states in either package: r0 has 5 admitted
    requests, r1's sosfilt-512 breaker is open, r2 is degraded, r3 has
    3 rows forming in the stft class's batch."""
    r0, r1, r2, r3 = (group.replica(f"r{i}") for i in range(4))
    for _ in range(5):
        r0.server._admission.admit("x")
    br = mod_breaker.breaker_for(
        "serve.dispatch", r1.server.breaker_key(KEYS[0]))
    br.failure()
    br.failure()
    assert br.state == mod_breaker.OPEN
    r2.server._health.trip("serve.dispatch")
    occ = {KEYS[1]: 3}
    r3.server.open_occupancy = lambda key: occ.get(tuple(key), 0)


def _scores(mod_cluster, mod_breaker, policy, weight):
    with mod_cluster.ReplicaGroup(4, max_batch=8, max_wait_ms=2.0,
                                  workers=1, obs_port=-1) as group:
        _shape_states(mod_cluster, mod_breaker, group)
        router = mod_cluster.FrontRouter(group, policy=policy,
                                         occupancy_weight=weight)
        scores = {(r.rid, k): router.score(r, k)
                  for r in group.replicas for k in KEYS}
        picks = [router._pick(k, set()).rid for k in KEYS for _ in (0, 1)]
        picks += [router._pick(KEYS[0], {"r3", "r1"}).rid]
        group.kill("r3")
        picks += [router._pick(KEYS[1], set()).rid]
        return scores, picks


@pytest.mark.parametrize("policy,weight", [("least_loaded", None),
                                           ("least_loaded", 0.0),
                                           ("least_loaded", 0.9),
                                           ("round_robin", None)])
def test_score_and_placement_equal_between_packages(jax_telemetry,
                                                    policy, weight):
    mine = _scores(cluster, breaker, policy, weight)
    theirs = _scores(jcluster, jbreaker, policy, weight)
    assert mine == theirs
    if policy == "least_loaded":
        scores = mine[0]
        assert scores[("r1", KEYS[0])] >= cluster.BREAKER_OPEN_PENALTY
        assert scores[("r1", KEYS[1])] < cluster.BREAKER_OPEN_PENALTY
        assert scores[("r2", KEYS[0])] >= cluster.DEGRADED_PENALTY


def test_module_constants_and_env_readers_equal(monkeypatch):
    for name in ("UP", "DRAINING", "DEAD", "RESTARTING",
                 "BREAKER_OPEN_PENALTY", "DEGRADED_PENALTY",
                 "ROUTER_POLICIES", "DEFAULT_REPLICAS",
                 "DEFAULT_HEARTBEAT_MS", "DEFAULT_MISS_LIMIT",
                 "DEFAULT_OCCUPANCY_WEIGHT", "REPLICAS_ENV",
                 "ROUTER_POLICY_ENV", "HEARTBEAT_MS_ENV",
                 "OCCUPANCY_WEIGHT_ENV"):
        assert getattr(cluster, name) == getattr(jcluster, name), name
    for raw in ("", "x", "0", "-1", "3", "0.5", "round_robin"):
        for env in ("REPLICAS_ENV", "ROUTER_POLICY_ENV",
                    "HEARTBEAT_MS_ENV", "OCCUPANCY_WEIGHT_ENV"):
            monkeypatch.setenv(getattr(cluster, env), raw)
        for fn in ("env_replicas", "env_router_policy",
                   "env_heartbeat_s", "env_occupancy_weight"):
            assert getattr(cluster, fn)() == getattr(jcluster, fn)(), \
                (raw, fn)
    assert issubclass(cluster.NoReplicaAvailable, serve.Overloaded)


# ---------------------------------------------------------------------------
# the slice as a whole: a seeded schedule with a kill and a drain
# ---------------------------------------------------------------------------

def _fleet_schedule(mod_serve, mod_cluster, o, schedule, make_request):
    """The schedule in two waves through a 3-replica thread group: r0
    killed while the first wave is queued, r1 drained while the second
    is.  Returns the tickets, the router's stats and the counters."""
    half = len(schedule) // 2
    reqs = [make_request(r) for _, r in schedule]
    with mod_cluster.ReplicaGroup(3, max_batch=32, max_wait_ms=150.0,
                                  workers=2, heartbeat_ms=40.0,
                                  obs_port=-1,
                                  fleet_tick_ms=25.0) as group:
        router = mod_cluster.FrontRouter(group)
        wave1 = [router.submit(r, deadline_ms=120000.0)
                 for r in reqs[:half]]
        group.kill("r0")
        for t in wave1:
            t.result(timeout=300.0)
        wave2 = [router.submit(r, deadline_ms=120000.0)
                 for r in reqs[half:]]
        group.drain("r1")
        for t in wave2:
            t.result(timeout=300.0)
        stats = router.stats()
    counters = {n: o.counter_value(n) for n in ("router_dedup",
                                                "serve_double_answer")}
    return wave1 + wave2, stats, counters


def test_seeded_schedule_with_kill_and_drain_through_both_groups(
        jax_telemetry):
    schedule = loadgen.build_schedule(np.random.RandomState(17), 96,
                                      rate_hz=0.0)
    jt, jstats, jcounters = _fleet_schedule(
        jserve, jcluster, jobs, schedule, lambda r: r)
    tt, tstats, tcounters = _fleet_schedule(
        serve, cluster, obs, schedule,
        lambda r: serve.Request(r.op, r.x, r.params, tenant=r.tenant))
    for tickets, stats, counters in ((jt, jstats, jcounters),
                                     (tt, tstats, tcounters)):
        assert [t.status for t in tickets] == ["ok"] * len(schedule)
        assert counters == {"router_dedup": 0, "serve_double_answer": 0}
        assert sum(stats["answered_by_replica"].values()) == len(schedule)
        assert stats["failovers"] >= 1
        failed = [t for t in tickets if t.failovers]
        assert failed
        for t in failed:
            assert len(t.deadlines_ms) >= 2
            assert t.deadlines_ms[-1] <= t.deadlines_ms[0]
            assert t.prior_traces and all(
                tr.status == "closed" for tr in t.prior_traces)
            assert t.replica != "r0"
        report = dict.fromkeys(loadgen.TRACE_KEYS, 0)
        for t in tickets:
            for k, v in loadgen.trace_failures(t).items():
                report[k] += v
        assert report["trace_checked"] == len(schedule)
        assert report["trace_orphans"] == report["trace_phase_err"] == 0
    worst = {}
    for (_, req), a, b in zip(schedule, tt, jt):
        got = a.result()
        assert isinstance(got, np.ndarray)
        err = _rel(got, np.asarray(b.result()))
        worst[req.op] = max(worst.get(req.op, 0.0), err)
        assert err <= TOLS[req.op], (req.op, req.x.shape, err)
    assert set(worst) == set(TOLS)


def test_router_answers_typed_when_no_replica_is_left():
    with cluster.ReplicaGroup(1, max_batch=2, max_wait_ms=1.0, workers=1,
                              obs_port=-1) as group:
        router = cluster.FrontRouter(group)
        group.kill("r0")
        t = router.submit(op="sosfilt", x=RNG.randn(256).astype(
            np.float32), params={"sos": SOS})
        with pytest.raises(cluster.NoReplicaAvailable):
            t.result(timeout=30.0)
        assert t.status == "shed"
        with pytest.raises(ValueError):
            router.submit(op="nope", x=np.zeros(8, np.float32))


# ---------------------------------------------------------------------------
# the fleet axis on a live group
# ---------------------------------------------------------------------------

def test_collector_feeds_signals_routes_and_kill_visibility(tmp_path):
    with cluster.ReplicaGroup(3, max_batch=32, max_wait_ms=150.0,
                              workers=2, heartbeat_ms=40.0, obs_port=0,
                              fleet_tick_ms=25.0) as group:
        router = cluster.FrontRouter(group)
        xs = [RNG.randn(512).astype(np.float32) for _ in range(24)]
        tickets = [router.submit(op="sosfilt", x=x, params={"sos": SOS},
                                 deadline_ms=60000.0) for x in xs]
        group.kill("r0")
        ys = [t.result(timeout=60.0) for t in tickets]
        assert _wait_until(lambda: obs.signals().health.get("r0")
                           == "down")
        sig = obs.signals()
        assert sig.ticks >= 1 and sig.tick_s == 0.025
        assert sig.health["r1"] == sig.health["r2"] == "healthy"
        assert sig.replica_count == {"up": 2, "draining": 0, "down": 1}
        base = f"http://127.0.0.1:{group.obs_port}"
        codes = {p: _get(base + p) for p in ("/healthz", "/signals",
                                             "/incidents", "/scaler")}
        for path, (code, _) in codes.items():
            assert code == 200, path
        body = json.loads(codes["/signals"][1])
        assert body["health"]["r0"] == "down"
        assert json.loads(codes["/incidents"][1])["schema"] == \
            jinc.SCHEMA
        assert json.loads(codes["/healthz"][1])["alive"] == 2
        failed = [t for t in tickets if t.failovers]
        assert failed
        stitched = obs.stitch_fleet_trace(failed[0])
        meta = stitched["otherData"]
        assert meta["attempts"] >= 2 and len(set(meta["replicas"])) >= 2
        path = obs.save_trace(str(tmp_path / "fleet.json"),
                              fleet=failed[0])
        assert json.loads(Path(path).read_text())["otherData"]["fleet"]
    for x, y in zip(xs, ys):
        assert _rel(y, iir.sosfilt_na(SOS, x)) <= IIR_TOL


def test_restart_spawn_retire_and_pipelines_replayed():
    spec = loadgen.pipeline_spec("cl", 256)
    with cluster.ReplicaGroup(2, max_batch=4, max_wait_ms=1.0, workers=1,
                              obs_port=-1, pipeline_specs=[spec]) as group:
        router = cluster.FrontRouter(group)
        group.kill("r0")
        fresh = group.restart("r0")
        born = group.spawn_replica()
        assert born.rid == "r2" and group.alive() == 3
        group.retire("r1")
        assert [r.rid for r in group.replicas] == ["r0", "r2"]
        ref = tpl.pipeline_from_spec(spec)
        x = RNG.randn(256).astype(np.float32)
        for r in (fresh, born):
            t = r.server.submit(op="pipeline:cl", x=x,
                                params={"state": None})
            out, _ = t.result(timeout=60.0)
            want, _ = ref.process(x[None, :])
            assert _rel(out, want.numpy()[0]) <= 1e-6
        t = router.submit(op="pipeline:cl", x=x, params={"state": None})
        assert t.result(timeout=60.0)[0].shape == (256,)
        with pytest.raises(ValueError, match="not dead"):
            group.restart("r0")
    events = [(e["decision"], e.get("replica")) for e in obs.events()
              if e["op"] == "replica_lifecycle"]
    for edge in (("kill", "r0"), ("restart", "r0"), ("spawn", "r2"),
                 ("retire", "r1")):
        assert edge in events


# ---------------------------------------------------------------------------
# subprocess replicas, device cpu
# ---------------------------------------------------------------------------

def test_subprocess_round_trip_and_sigkill_failover():
    spec = loadgen.pipeline_spec("sub", 256)
    with cluster.ReplicaGroup(2, spawn="subprocess", max_batch=8,
                              max_wait_ms=100.0, workers=1,
                              heartbeat_ms=100.0, obs_port=0,
                              fleet_tick_ms=25.0,
                              pipeline_specs=[spec]) as group:
        for r in group.replicas:
            assert r.port and r.rpc is not None
            assert 0.0 < r.ready_s < 60.0
            body = r.ping()
            assert body["batcher"]["max_batch"] == 8
        router = cluster.FrontRouter(group)
        xs = [RNG.randn(n).astype(np.float32) for n in (300, 512) * 6]
        tickets = [router.submit(op="sosfilt", x=x, params={"sos": SOS},
                                 deadline_ms=60000.0) for x in xs]
        group.kill("r0")
        assert group.replica("r0").proc.poll() is not None
        ys = [t.result(timeout=60.0) for t in tickets]
        x = RNG.randn(256).astype(np.float32)
        pt = router.submit(op="pipeline:sub", x=x, params={"state": None},
                           deadline_ms=60000.0)
        out, state = pt.result(timeout=60.0)
        code, metrics = _get(
            f"http://127.0.0.1:{group.replica('r1').port}/metrics")
        assert _wait_until(lambda: obs.signals().rpc.get("r1")
                           is not None)
        stats = group.stats()
    assert {t.status for t in tickets} == {"ok"}
    assert all(t.replica == "r1" for t in tickets if t.failovers)
    for x_, y in zip(xs, ys):
        assert _rel(y, iir.sosfilt_na(SOS, x_)) <= IIR_TOL
    want, _ = tpl.pipeline_from_spec(spec).process(x[None, :])
    assert _rel(out, want.numpy()[0]) <= 1e-6 and pt.replica == "r1"
    assert code == 200 and "veles_simd_serve_completed_total" in metrics
    assert stats["replicas"][1]["rpc"]["transport_errors"] == 0


def test_subprocess_child_refuses_a_device_it_cannot_reach():
    # a child is told the parent's device; told cuda where no card is,
    # it reports a typed startup error and the group does not start
    config.set_config(device="cuda")
    group = cluster.ReplicaGroup(1, spawn="subprocess", obs_port=-1,
                                 max_wait_ms=1.0, workers=1)
    if torch.cuda.is_available():
        with group:
            assert group.replica("r0").port
        return
    with pytest.raises(RuntimeError, match="cuda"):
        group.start()
    assert group.replica("r0").proc.poll() is not None
    assert not group._started


@pytest.mark.parametrize("spawn", ["thread", "subprocess"])
def test_armed_artifact_store_preloads_in_every_replica(tmp_path,
                                                        monkeypatch,
                                                        spawn):
    # a warm pack of a stand-in kernel library (random bytes; nothing on
    # the CPU loads it) and an empty build root: a thread replica's
    # Server.start and a subprocess child (before its ready line, with
    # the store inherited through the environment and the build root
    # forwarded) each place it where load_library sees a cache hit
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.runtime import artifacts as art

    prev = ck.set_build_root()
    try:
        ck.set_build_root(tmp_path / "built")
        out = ck._build_dir()
        out.mkdir(parents=True)
        (out / ck._LIB_NAME).write_bytes(b"\x7fELF stand-in" * 32)
        (out / "build.log").write_text("stand-in build log\n")
        pack = str(tmp_path / "pack")
        with art.private_artifact_store(pack), \
                art.artifacts_mode_override("on"):
            assert art.store_kernel_library() == "stored"
        ck.set_build_root(tmp_path / "fresh")
        placed = ck._build_dir() / ck._LIB_NAME
        monkeypatch.setenv(art.ARTIFACT_DIR_ENV, pack)
        monkeypatch.setenv(tserver.ARTIFACTS_ENV, "readonly")
        group = cluster.ReplicaGroup(1, spawn=spawn, obs_port=-1,
                                     max_wait_ms=1.0, workers=1)
        with group:
            r0 = group.replica("r0")
            report = (r0.server.stats()["artifact_preload"]
                      if spawn == "thread" else r0.artifact_preload)
            assert report == {"loaded": 1, "failed": 0,
                              "mode": "readonly", "path": pack}
            assert placed.read_bytes() == b"\x7fELF stand-in" * 32
    finally:
        ck.set_build_root(prev)


def test_subprocess_replica_refuses_disarmed_endpoint():
    r = cluster.Replica("rx", spawn="subprocess",
                        server_kwargs={"obs_port": -1})
    with pytest.raises(ValueError, match="obs_port"):
        r.start()


# ---------------------------------------------------------------------------
# the JAX lint rules of the fleet, on the port's sources
# ---------------------------------------------------------------------------

def _source(name):
    path = REPO / "veles" / "simd_tpu_torch" / "serve" / f"{name}.py"
    return path.read_text().replace("veles.simd_tpu_torch",
                                    "veles.simd_tpu")


@pytest.mark.parametrize("name", FLEET_SOURCES)
def test_fleet_lint_rules_pass_on_the_port(name):
    tree = ast.parse(_source(name))
    fname = f"{name}.py"
    assert lint.fleet_funnel_errors(tree, fname) == []
    if name != "rpc":
        assert lint.rpc_transport_errors(tree, fname) == []
    if name == "cluster":
        assert lint.cluster_router_errors(tree, fname) == []
    if name == "scaler":
        assert lint.scaler_control_errors(tree, fname) == []


def test_a_second_submit_outside_the_funnel_is_caught():
    text = _source("cluster")
    anchor = "    def _on_backend(self, ticket: RouterTicket,"
    assert anchor in text
    bad = text.replace(anchor, "    def _shortcut(self, replica, request):\n"
                       "        return replica.server.submit(request)\n\n"
                       + anchor)
    errors = lint.cluster_router_errors(ast.parse(bad), "cluster.py")
    assert len(errors) == 1 and "funnel" in errors[0]


def test_the_transport_and_funnel_rules_are_not_vacuous():
    text = _source("cluster")
    raw = text.replace("import subprocess\n",
                       "import subprocess\nimport http.client\n")
    assert lint.rpc_transport_errors(ast.parse(raw), "cluster.py")
    anchor = "    def _on_backend(self, ticket: RouterTicket,"
    post = text.replace(anchor, "    def _post(self, url, body):\n"
                        "        import urllib.request\n"
                        "        return urllib.request.urlopen(url, "
                        "body)\n\n" + anchor)
    assert lint.rpc_transport_errors(ast.parse(post), "cluster.py")
    scrape = text.replace(anchor, "    def _peek(self, text):\n"
                          "        return obs_export.parse_prometheus("
                          "text)\n\n" + anchor)
    errors = lint.fleet_funnel_errors(ast.parse(scrape), "cluster.py")
    assert len(errors) == 1 and "_collect_fleet_sample" in errors[0]
    side = _source("scaler").replace(
        "        plan[\"action\"] = winner\n",
        "        obs.fleet_series()\n        plan[\"action\"] = winner\n")
    assert lint.fleet_funnel_errors(ast.parse(side), "scaler.py")
    assert lint.scaler_control_errors(ast.parse(side), "scaler.py")


def test_the_gate_is_shared_by_every_replica_of_a_group():
    group = cluster.ReplicaGroup(3, obs_port=-1, workers=1)
    gates = {id(r.server._gate) for r in group.replicas}
    assert gates == {id(tserver._GATE)}
