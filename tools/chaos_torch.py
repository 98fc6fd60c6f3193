#!/usr/bin/env python3
"""Scripted chaos-campaign runner of the port (``tools/chaos.py``'s twin
over ``veles.simd_tpu_torch``): the resilience triad, proven end to end.

Drives a live :class:`veles.simd_tpu_torch.serve.Server` (via
``tools/loadgen_torch.py`` traffic) *and* sharded ``parallel/``
dispatches
through a deterministic phase schedule of injected faults
(``VELES_SIMD_FAULT_PLAN`` phase syntax, ``label=entries;...``,
stepped with :func:`veles.simd_tpu_torch.runtime.faults.advance_phase`):

1. **baseline** — no faults; traffic + sharded calls establish the
   healthy numbers;
2. **overload** — injected admission overloads force the typed shed
   path under burst traffic;
3. **pipeline_poison** — a persistent ``device_lost`` poisons ONE
   served PIPELINE class (``pipeline.dispatch@chaosline``): its
   per-pipeline-class breaker opens, its invocation streams keep
   answering (degraded, state threading exact — parity still holds),
   and PLAIN-op traffic in the same phase stays entirely "ok";
4. **mesh_loss** — a persistent ``device_lost`` poisons ONE serve
   shape class (``serve.dispatch@sosfilt``) and the whole sharded
   matmul mesh (``parallel.sharded_matmul``): the per-class breaker
   opens after the retry ladder is paid twice, the health machine
   trips DEGRADED and recovers on a healthy-class probe, and sharded
   dispatch degrades to the single-card twin (``mesh_degrade``);
5. **recovery** — injection cleared; half-open breaker probes re-close
   every breaker and the server finishes HEALTHY.

Invariants asserted (rc=1 on any failure):

* zero lost / zero double-answered requests, answers parity-checked
  (pipeline streams included — degraded blocks must not corrupt the
  carried state);
* only *typed* errors reach clients (``Overloaded`` /
  ``DeadlineExceeded``; untyped per-request errors are a bug);
* deadline misses bounded (every request carries ``--deadline-ms``);
* the poisoned class's breaker walks closed -> open -> half_open ->
  closed, and its steady-state open segment records ZERO retry
  attempts (straight-to-fallback) while other classes keep answering;
* ``mesh_degrade`` recorded with mesh geometry; sharded dispatch
  re-enabled after recovery;
* the poisoned PIPELINE class's breaker cycles and re-closes while
  plain-op traffic in that phase records zero degraded answers;
* serve health walks DEGRADED -> HEALTHY;
* the REQUEST AXIS stays complete under fire (obs v4): every completed
  ticket in every phase carries a causal trace whose terminal status
  matches the ticket and whose phase latencies sum to its total, every
  degraded ticket carries a ``degraded`` edge, per-tenant SLO burn
  gauges are exported, and the live scrape endpoint
  (``/metrics`` + ``/healthz`` + ``/debug/requests``) answers
  MID-CAMPAIGN with a poisoned class and injection active.

The evidence — decision events, breaker/fault/serve counters, and the
``veles_simd_breaker_*``/``veles_simd_mesh_*`` Prometheus lines — is
embedded in ``CHAOS_DETAILS_torch.json`` alongside
``BENCH_DETAILS``-format metric rows, so ``python3
tools/bench_regress.py --details CHAOS_DETAILS_torch.json`` gates the
campaign like any bench family (rows stamped ``chaos_phase`` are
DEGRADED-not-gated when they dip).  The flags, the row ``metric``
names and the invariant names are the JAX tool's.

It runs on the card: the server's batches, the served pipeline's CUDA
graph and the sharded calls (``parallel.make_mesh({"sp": 8})``, eight
shards of ``cuda:0``) all compute there.  ``VELES_SIMD_PLATFORM=cpu``
asks for the CPU (``utils.platform.select_device``); without a card and
without that request it exits 2.

Usage::

    python3 tools/chaos_torch.py --smoke
    python3 tools/chaos_torch.py --replicas --smoke
    python3 tools/chaos_torch.py --replicas --spawn subprocess --smoke
    python3 tools/chaos_torch.py --scale --smoke
    python3 tools/chaos_torch.py --details CHAOS_DETAILS_torch.json

``--replicas --spawn subprocess`` runs the replica campaign over the
RPC data plane (``serve/rpc.py``): three CHILD PROCESSES behind the
front router, the abrupt kill a real SIGKILL mid-traffic — the same
zero-lost / carried-deadline / journal-reconstruction invariants must
hold across the wire, and the rows land spawn-suffixed (``replica
failover throughput subprocess``) in ``REPLICA_RPC_DETAILS_torch.json``.
Each child computes on the parent's ``Config.device`` (the card, or
the CPU when asked for), so the SIGKILL is of a process holding its
own CUDA context.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import loadgen_torch as loadgen  # noqa: E402
import obs_query_torch as obs_query  # noqa: E402
from veles.simd_tpu_torch import obs  # noqa: E402
from veles.simd_tpu_torch import serve  # noqa: E402
from veles.simd_tpu_torch.obs import incidents as obs_incidents  # noqa: E402
from veles.simd_tpu_torch.obs import journal as obs_journal  # noqa: E402
from veles.simd_tpu_torch.runtime import breaker, faults  # noqa: E402

MESH_AXIS = "sp"

# the poisoned shape class: one op, one length — a single serve bucket,
# so its breaker sees every failure (determinism over realism here;
# the mixed loadgen traffic supplies the realism)
POISON_OP = "sosfilt"
POISON_LEN = 512

# the poisoned served-pipeline class (loadgen's small compiled chain)
PIPE_NAME = "chaosline"

PHASE_SPEC = (
    "baseline=;"
    "overload=serve.admission:overload:{overloads};"
    "pipeline_poison=pipeline.dispatch@{pipe}:device_lost:9999;"
    "mesh_loss=serve.dispatch@{poison}:device_lost:9999,"
    "parallel.sharded_matmul:device_lost:9999;"
    "recovery="
)


def _poison_requests(rng, n: int, deadline_ms) -> list:
    """``n`` identical-class requests for the poisoned bucket."""
    from veles.simd_tpu_torch.ops import iir

    sos = iir.butterworth(4, 0.25, "lowpass")
    return [(0.0, serve.Request(
        POISON_OP, rng.randn(POISON_LEN).astype(np.float32),
        {"sos": sos}, tenant="chaos",
        deadline_ms=deadline_ms)) for _ in range(n)]


def _run_serial(server, items, timeout: float) -> dict:
    """Submit ``items`` one at a time, waiting for each answer — every
    request is its own batch, so breaker/health cadences tick once per
    request (the determinism the campaign's counting arguments
    need)."""
    return _merge_reports([
        loadgen.run_load(server, [item], result_timeout=timeout)
        for item in items])


def _merge_reports(reports: list) -> dict:
    """Sum the accounting categories across phase reports (request
    outcomes AND the request-axis trace-completeness categories)."""
    total: dict = {}
    for rep in reports:
        for k in ("requests", "ok", "degraded", "shed", "closed",
                  "errors", "lost", "deadline_miss",
                  "parity_failures") + loadgen.TRACE_KEYS:
            total[k] = total.get(k, 0) + rep.get(k, 0)
    total["double_answered"] = (obs.counter_value(
        "serve_double_answer") if obs.enabled() else 0)
    return total


def _counter_total(name: str) -> int:
    """Sum of one counter across every label set."""
    snap = obs.snapshot()
    return sum(c["value"] for c in snap["counters"]
               if c["name"] == name)


def _decisions(op: str) -> list:
    return [e for e in obs.events() if e["op"] == op]


def _mesh_calls(mesh, n_calls: int, a, b, want) -> int:
    """``n_calls`` sharded matmuls, each answer checked against the
    host oracle regardless of which path (mesh or single-card twin)
    served it.  Returns the number of wrong answers."""
    from veles.simd_tpu_torch import parallel as par
    from veles.simd_tpu_torch.utils.platform import to_host

    bad = 0
    for _ in range(n_calls):
        # a global tensor on the mesh's first device (the card)
        got = to_host(par.sharded_matmul(a, b, mesh, axis=MESH_AXIS))
        scale = float(np.max(np.abs(want))) or 1.0
        if float(np.max(np.abs(got - want)) / scale) > 2e-3:
            bad += 1
    return bad


def run_campaign(args) -> tuple:
    """Execute the four-phase campaign; returns ``(invariants, rows,
    evidence)`` — all JSON-native."""
    from veles.simd_tpu_torch import parallel as par

    from veles.simd_tpu_torch.parallel.mesh import local_devices

    rng = np.random.RandomState(args.seed)
    # --mesh-devices shards of Config.device: eight shards of cuda:0 on
    # one card, the JAX tool's virtual 8-device CPU mesh's counterpart
    mesh = par.make_mesh({MESH_AXIS: args.mesh_devices},
                         devices=local_devices(args.mesh_devices))
    a = rng.randn(32, 64).astype(np.float32)
    b = rng.randn(64, 16).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)

    spec = PHASE_SPEC.format(overloads=args.overloads,
                             poison=POISON_OP, pipe=PIPE_NAME)
    faults.set_fault_plan(spec)
    phase_reports: dict = {}
    mesh_bad = 0
    retry_steady = None
    plain_degraded_during_pipe = None
    scrape_mid = None
    try:
        # endpoint armed on an ephemeral port: the campaign proves it
        # serves live data MID-CAMPAIGN, faults active
        server = serve.Server(max_batch=4, max_wait_ms=5.0,
                              workers=args.workers, probe_every=2,
                              obs_port=0)
        compiled = loadgen.build_pipeline(PIPE_NAME)
        # per-tenant SLOs so burn-rate gauges export under chaos (the
        # campaign gates that the gauges EXIST, not a latency number)
        for tenant in loadgen.DEFAULT_TENANTS + ("chaos",):
            obs.slo(tenant, target_ms=60000.0, hit_rate=0.99)
        with server:
            pipe_op = server.register_pipeline(PIPE_NAME, compiled)
            # -- phase 1: baseline ------------------------------------
            t0 = time.perf_counter()
            sched = loadgen.build_schedule(
                rng, args.requests, rate_hz=0.0,
                deadline_ms=args.deadline_ms)
            base_load = loadgen.run_load(
                server, sched, verify=args.verify, rng=rng,
                result_timeout=args.result_timeout)
            base_pipe = loadgen.run_pipeline_streams(
                server, pipe_op, compiled, rng, streams=2, blocks=3,
                deadline_ms=args.deadline_ms,
                result_timeout=args.result_timeout)
            phase_reports["baseline"] = _merge_reports(
                [base_load, base_pipe])
            mesh_bad += _mesh_calls(mesh, 1, a, b, want)
            phase_reports["baseline"]["phase_wall_s"] = \
                time.perf_counter() - t0

            # -- phase 2: overload ------------------------------------
            assert faults.advance_phase() == "overload"
            t0 = time.perf_counter()
            sched = loadgen.build_schedule(
                rng, args.requests, rate_hz=0.0, burst_every=8,
                burst_size=4, deadline_ms=args.deadline_ms)
            phase_reports["overload"] = loadgen.run_load(
                server, sched, verify=args.verify, rng=rng,
                result_timeout=args.result_timeout)
            phase_reports["overload"]["phase_wall_s"] = \
                time.perf_counter() - t0

            # -- phase 3: pipeline_poison -----------------------------
            assert faults.advance_phase() == "pipeline_poison"
            t0 = time.perf_counter()
            # the poisoned pipeline class keeps answering — degraded,
            # through its OWN breaker, with exact state threading
            # (single-invocation batches so the breaker cadence ticks
            # once per block)
            pipe_poisoned = loadgen.run_pipeline_streams(
                server, pipe_op, compiled, rng, streams=1,
                blocks=max(4, args.steady),
                deadline_ms=args.deadline_ms,
                result_timeout=args.result_timeout)
            # plain-op traffic through the SAME server must be
            # untouched: zero degraded answers while the pipeline
            # class is poisoned
            mixed_pp = loadgen.run_load(
                server, loadgen.build_schedule(
                    rng, args.requests, rate_hz=0.0,
                    deadline_ms=args.deadline_ms),
                verify=args.verify, rng=rng,
                result_timeout=args.result_timeout)
            plain_degraded_during_pipe = mixed_pp["degraded"]
            rep = _merge_reports([pipe_poisoned, mixed_pp])
            rep["phase_wall_s"] = time.perf_counter() - t0
            rep["throughput_rps"] = (
                (rep["ok"] + rep["degraded"]) / rep["phase_wall_s"]
                if rep["phase_wall_s"] > 0 else 0.0)
            rep["pipeline_degraded"] = pipe_poisoned["degraded"]
            phase_reports["pipeline_poison"] = rep

            # -- phase 4: mesh_loss -----------------------------------
            assert faults.advance_phase() == "mesh_loss"
            t0 = time.perf_counter()
            # warm-up: enough poisoned-class dispatches to pay the
            # retry ladder twice and open the class breaker
            warm = _run_serial(
                server, _poison_requests(rng, 4, args.deadline_ms),
                args.result_timeout)
            # steady state: the open breaker must answer straight from
            # the oracle — zero retry attempts on the poisoned class
            retries_before = _counter_total("fault_retry")
            steady = _run_serial(
                server,
                _poison_requests(rng, args.steady, args.deadline_ms),
                args.result_timeout)
            retry_steady = _counter_total("fault_retry") \
                - retries_before
            # sibling classes keep flowing while the class is poisoned
            mixed = loadgen.run_load(
                server, loadgen.build_schedule(
                    rng, args.requests, rate_hz=0.0,
                    deadline_ms=args.deadline_ms),
                verify=args.verify, rng=rng,
                result_timeout=args.result_timeout)
            # the live-endpoint proof, at the campaign's worst moment:
            # a poisoned class, an open breaker, injection active
            scrape_mid = loadgen.scrape_endpoint(server.obs_port)
            mesh_bad += _mesh_calls(mesh, args.mesh_loss_calls,
                                    a, b, want)
            rep = _merge_reports([warm, steady, mixed])
            rep["phase_wall_s"] = time.perf_counter() - t0
            rep["throughput_rps"] = (
                (rep["ok"] + rep["degraded"]) / rep["phase_wall_s"]
                if rep["phase_wall_s"] > 0 else 0.0)
            phase_reports["mesh_loss"] = rep

            # -- phase 5: recovery ------------------------------------
            assert faults.advance_phase() == "recovery"
            t0 = time.perf_counter()
            rec_poison = _run_serial(
                server,
                _poison_requests(rng, args.recovery_calls,
                                 args.deadline_ms),
                args.result_timeout)
            rec_pipe = loadgen.run_pipeline_streams(
                server, pipe_op, compiled, rng, streams=1,
                blocks=max(4, args.recovery_calls),
                deadline_ms=args.deadline_ms,
                result_timeout=args.result_timeout)
            rec_mixed = loadgen.run_load(
                server, loadgen.build_schedule(
                    rng, args.requests, rate_hz=0.0,
                    deadline_ms=args.deadline_ms),
                verify=args.verify, rng=rng,
                result_timeout=args.result_timeout)
            mesh_bad += _mesh_calls(mesh, args.recovery_calls,
                                    a, b, want)
            rep = _merge_reports([rec_poison, rec_pipe, rec_mixed])
            rep["phase_wall_s"] = time.perf_counter() - t0
            rep["throughput_rps"] = (
                (rep["ok"] + rep["degraded"]) / rep["phase_wall_s"]
                if rep["phase_wall_s"] > 0 else 0.0)
            phase_reports["recovery"] = rep
            stats = server.stats()
            health = stats["health"]
            breakers = stats["breakers"]
    finally:
        faults.set_fault_plan(None)

    total = _merge_reports(list(phase_reports.values()))

    # -- invariants ---------------------------------------------------
    def _cycle_ok(seq: list) -> bool:
        """closed -> open -> half_open -> closed, in order."""
        try:
            i = seq.index("open")
            j = seq.index("half_open", i)
            seq.index("closed", j)
            return True
        except ValueError:
            return False

    poison_tag = f", {POISON_LEN})"
    poison_transitions = [
        e["decision"] for e in _decisions("breaker_transition")
        if e.get("site") == "serve.dispatch"
        and POISON_OP in e.get("key", "")
        and e.get("key", "").endswith(poison_tag)]
    mesh_transitions = [
        e["decision"] for e in _decisions("breaker_transition")
        if e.get("site") == "parallel.dispatch"]
    serve_events = [e["decision"] for e in _decisions("serve_health")]
    mesh_events = _decisions("mesh_degrade")
    poison_breaker = next(
        (i for i in breakers if POISON_OP in i["key"]
         and i["key"].endswith(poison_tag)), None)
    mesh_breaker = breaker.lookup(
        "parallel.dispatch",
        ("sharded_matmul", f"{MESH_AXIS}{args.mesh_devices}"
                           f"@{MESH_AXIS}"))
    pipe_transitions = [
        e["decision"] for e in _decisions("breaker_transition")
        if e.get("site") == "pipeline.dispatch"
        and PIPE_NAME in e.get("key", "")]
    pipe_breaker = breaker.lookup(
        "pipeline.dispatch", (PIPE_NAME, compiled.block_len))
    answered = total["ok"] + total["degraded"]
    invariants = {
        "zero_lost": total["lost"] == 0,
        "zero_double_answered": total["double_answered"] == 0,
        "zero_untyped_errors": total["errors"] == 0,
        "parity_clean": (total["parity_failures"] == 0
                         and mesh_bad == 0),
        "sheds_typed": phase_reports["overload"]["shed"]
        == args.overloads,
        "deadline_misses_bounded": total["deadline_miss"]
        <= max(1, int(args.max_miss_frac * total["requests"])),
        "breaker_cycle": _cycle_ok(poison_transitions),
        "breaker_closed_at_end": (
            poison_breaker is not None
            and poison_breaker["state"] == breaker.CLOSED),
        "zero_retry_steady_state": retry_steady == 0,
        "mesh_degrade_observed": (
            len(mesh_events) >= 1
            and all(e.get("mesh") for e in mesh_events)),
        "mesh_breaker_cycle": _cycle_ok(mesh_transitions),
        "mesh_breaker_closed_at_end": (
            mesh_breaker is not None
            and mesh_breaker.state == breaker.CLOSED),
        "pipeline_breaker_cycle": _cycle_ok(pipe_transitions),
        "pipeline_breaker_closed_at_end": (
            pipe_breaker is not None
            and pipe_breaker.state == breaker.CLOSED),
        "pipeline_degraded_then_served": (
            phase_reports["pipeline_poison"]["pipeline_degraded"]
            >= 1),
        "plain_ok_during_pipeline_poison":
            plain_degraded_during_pipe == 0,
        "health_degraded_then_healthy": (
            "degrade" in serve_events and "recover" in serve_events
            and health["state"] == serve.HEALTHY),
        "answers_accounted": (answered + total["shed"]
                              + total["deadline_miss"]
                              + total["closed"] + total["errors"]
                              == total["requests"]),
        # the request axis (obs v4): every completed ticket across
        # every phase carried a complete causal chain...
        "zero_orphaned_traces": (total["trace_checked"] > 0
                                 and total["trace_orphans"] == 0),
        # ...whose phase latencies sum to its total...
        "trace_phases_sum_to_total": total["trace_phase_err"] == 0,
        # ...and every degraded ticket carries a degrade edge
        "degraded_tickets_have_degrade_edge":
            total["trace_degraded_missing_edge"] == 0,
        # the scrape endpoint served all three routes mid-campaign
        "scrape_live_mid_campaign": (
            scrape_mid is not None and scrape_mid["ok"] == 3
            and scrape_mid["failed"] == 0),
        # per-tenant SLO burn gauges exported under chaos
        "slo_gauges_exported": any(
            g["name"] == "slo_burn_rate"
            for g in obs.snapshot()["gauges"]),
    }

    # -- CHAOS_DETAILS rows + evidence tail ---------------------------
    wall = sum(r["phase_wall_s"] for r in phase_reports.values())
    rows = [
        {"metric": "chaos requests answered", "value": float(answered),
         "unit": "req", "vs_baseline": None},
        {"metric": "chaos campaign throughput",
         "value": round(total["requests"] / wall, 2) if wall else 0.0,
         "unit": "req/s", "vs_baseline": None},
        {"metric": "chaos deadline hit rate",
         "value": round(answered / (answered + total["deadline_miss"]),
                        4) if answered + total["deadline_miss"]
         else 1.0,
         "unit": "fraction", "vs_baseline": None},
    ]
    for label in ("mesh_loss", "pipeline_poison", "recovery"):
        rows.append({
            "metric": f"chaos {label} throughput",
            "value": round(
                phase_reports[label].get("throughput_rps", 0.0), 2),
            "unit": "req/s", "vs_baseline": None,
            # rows measured with injection active are
            # DEGRADED-not-gated by bench_regress
            **({"chaos_phase": label} if label != "recovery"
               else {}),
        })
    snap = obs.snapshot()
    counters = {}
    for c in snap["counters"]:
        if c["name"].startswith(("serve_", "fault_", "breaker_",
                                 "mesh_")):
            counters[c["name"]] = counters.get(c["name"], 0) \
                + c["value"]
    rows.append({
        "metric": "chaos breaker short circuits",
        "value": float(counters.get("breaker_short_circuit", 0)),
        "unit": "calls", "vs_baseline": None,
        "telemetry": {"counters": counters},
    })
    prom = [line for line in obs.to_prometheus(snap).splitlines()
            if "breaker_" in line or "mesh_" in line
            or "deadline" in line]
    evidence = {
        "chaos_invariants": invariants,
        "phase_reports": {k: {kk: vv for kk, vv in v.items()
                              if not isinstance(vv, np.ndarray)}
                          for k, v in phase_reports.items()},
        "fault_phases": [e["decision"]
                         for e in _decisions("fault_phase")],
        "breaker_transitions": _decisions("breaker_transition"),
        "mesh_degrade_events": mesh_events[:8],
        "serve_health_events": _decisions("serve_health"),
        "prometheus_breaker_lines": prom,
        "retry_attempts_steady_state": retry_steady,
        "plain_degraded_during_pipeline_poison":
            plain_degraded_during_pipe,
        "pipeline_breaker_transitions": pipe_transitions,
        "scrape_mid_campaign": scrape_mid,
        "request_axis": obs.request_summary(),
        "slo": obs.slo_snapshot(),
    }
    return invariants, rows, evidence


# ---------------------------------------------------------------------------
# the replicated campaign (--replicas): kill one, drain one
# ---------------------------------------------------------------------------

# merged accounting keys specific to routed traffic (run_load only
# emits them when they fire, so merge with .get defaults)
_ROUTER_KEYS = ("failovers", "failover_deadline_checked",
                "failover_deadline_violations", "prior_trace_checked",
                "prior_trace_orphans")


def _replica_submit(replica, req):
    """Place one request directly on a replica over whichever
    transport it serves: the in-process Server, or the armed RPC data
    plane (``serve.rpc.RpcClient``) of a subprocess replica."""
    if replica.spawn == "thread":
        return replica.server.submit(req)
    return replica.rpc.submit(req)


def _merge_router(reports: list) -> dict:
    total = _merge_reports(reports)
    for rep in reports:
        for k in _ROUTER_KEYS:
            total[k] = total.get(k, 0) + rep.get(k, 0)
    return total


def run_replica_campaign(args) -> tuple:
    """Arm the goodput-at-saturation features, then run the replica
    campaign body: the kill/drain/restart invariants (zero lost, zero
    double-answered, every trace terminal) must hold WITH continuous
    batching refilling freed row slots and ragged packing co-packing
    the mix's short stft requests — the chaos gate for both features
    (the mix's stft lengths sit under the ragged cap, so the packed
    dispatch path really runs).  The history axis (obs v6) is armed
    alongside: the whole campaign journals to a fresh pack directory
    and ticks the incident engine on a tight cadence, so the body can
    gate postmortem reconstruction purely from the on-disk journal
    after the replicas are gone."""
    from veles.simd_tpu_torch.serve import server as serve_server

    journal_pack = tempfile.mkdtemp(prefix="veles-chaos-journal-")
    armed = {serve_server.CONTINUOUS_ENV: "1",
             serve_server.RAGGED_ENV: "1",
             obs_journal.JOURNAL_DIR_ENV: journal_pack,
             # fast incident cadence so open (2 firing ticks) and
             # close (5 quiet ticks) both land inside a smoke run
             obs_incidents.TICK_MS_ENV: "50"}
    prior = {k: os.environ.get(k) for k in armed}

    def _restore():
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    os.environ.update(armed)
    # the process-wide incident engine may carry another epoch's state
    # (an earlier campaign or test in this process): a stale CLOSED
    # replica_down incident would satisfy the campaign's close-wait
    # instantly — before its own incident closes into the armed
    # journal — and leftover streaks skew the hysteresis.  The fresh
    # pack's incident story starts from a clean ledger.
    obs_incidents.reset()
    try:
        return _replica_campaign_body(args, _restore, journal_pack)
    finally:
        _restore()


def _replica_campaign_body(args, restore_features=lambda: None,
                           journal_pack=None) -> tuple:
    """The 3-phase replica-kill campaign over a 3-replica group behind
    the front router: (1) kill one replica abruptly — no drain —
    MID-TRAFFIC (its queued work must fail over, deadlines carried);
    (2) drain another gracefully mid-traffic (answered, then removed)
    while the router-level ``/healthz`` answers throughout; (3) COLD
    RESTART the killed replica (``ReplicaGroup.restart`` — the
    preemption-recovery moment the zero-warmup artifact subsystem
    serves) and assert its first request lands within budget of a
    survivor's steady state.  The fleet axis (obs v5) is gated
    alongside: the kill must become visible through ``obs.signals()``
    within bounded collector ticks, a failed-over request must stitch
    into one cross-replica fleet trace with the original deadline
    carried, campaign goodput must be a sane fraction, and the
    tracing-overhead budget must hold with the collector armed.
    Returns ``(invariants, rows, evidence)``."""
    from veles.simd_tpu_torch.serve import cluster

    rng = np.random.RandomState(args.seed)
    # max_wait large enough that the mid-traffic kill catches queued
    # work (the failover path must actually fire), max_batch above the
    # wave size so batches wait rather than dispatch instantly
    group = cluster.ReplicaGroup(3, max_batch=32, max_wait_ms=150.0,
                                 workers=args.workers,
                                 heartbeat_ms=40.0, obs_port=0,
                                 # a tight collector cadence so the
                                 # kill-visibility gate below measures
                                 # ticks, not seconds
                                 fleet_tick_ms=25.0,
                                 # --spawn subprocess runs the SAME
                                 # campaign over the RPC data plane:
                                 # the abrupt kill is then a real
                                 # child SIGKILL mid-traffic, and the
                                 # failover/carried-deadline/journal
                                 # invariants gate the wire
                                 spawn=args.spawn)
    router = cluster.FrontRouter(group)
    scrapes: dict = {}
    phase_reports: dict = {}

    # -- fleet-signal kill visibility (obs v5) ----------------------
    # the autoscaler contract in action: after the abrupt kill, r0
    # must read non-healthy in obs.signals() within a bounded number
    # of collector ticks.  The mid_hook stamps the kill, a watcher
    # thread polls the signals facade (the SAME read path an
    # autoscaler would use — not the group's internals) until the
    # state flips.
    kill_vis = {"t_kill": None, "t_visible": None}
    watcher: list = []

    def _watch_kill_visibility():
        deadline = faults.monotonic() + 60 * group.fleet_tick_s + 5.0
        while faults.monotonic() < deadline:
            sig = obs.signals()
            if sig.health.get("r0") not in (None, "healthy"):
                kill_vis["t_visible"] = faults.monotonic()
                return
            threading.Event().wait(group.fleet_tick_s / 5.0)

    def _kill_r0():
        kill_vis["t_kill"] = faults.monotonic()
        group.kill("r0")
        w = threading.Thread(target=_watch_kill_visibility,
                             daemon=True)
        w.start()
        watcher.append(w)
    with group:
        # -- warmup: pay the traffic mix's first calls (kernel build,
        # plans, graph captures) so the kill wave measures routing
        warm = loadgen.run_load(
            router, loadgen.build_schedule(
                rng, 8, rate_hz=0.0, deadline_ms=args.deadline_ms),
            verify=0, rng=rng, result_timeout=args.result_timeout)
        scrapes["baseline"] = loadgen.scrape_endpoint(group.obs_port)
        # wait until every replica has beaten at least once
        deadline = faults.monotonic() + 2.0
        while faults.monotonic() < deadline and not all(
                r.last_beat is not None for r in group.replicas):
            threading.Event().wait(0.02)
        beats_seen = all(r.last_beat is not None
                         for r in group.replicas)

        # -- phase 1: abrupt kill, no drain, mid-traffic ------------
        kill_tickets: list = []
        t0 = time.perf_counter()
        rep_kill = loadgen.run_load(
            router, loadgen.build_schedule(
                rng, args.requests, rate_hz=0.0,
                deadline_ms=args.deadline_ms),
            verify=args.verify, rng=rng,
            result_timeout=args.result_timeout,
            mid_hook=_kill_r0, ticket_sink=kill_tickets)
        rep_kill["phase_wall_s"] = time.perf_counter() - t0
        rep_kill["throughput_rps"] = (
            (rep_kill["ok"] + rep_kill["degraded"])
            / rep_kill["phase_wall_s"]
            if rep_kill["phase_wall_s"] > 0 else 0.0)
        phase_reports["replica_kill"] = rep_kill
        scrapes["after_kill"] = loadgen.scrape_endpoint(
            group.obs_port)
        answered_after_kill = dict(
            router.stats()["answered_by_replica"])
        if watcher:
            watcher[0].join(timeout=60 * group.fleet_tick_s + 10.0)
        fleet_lag_s = (
            kill_vis["t_visible"] - kill_vis["t_kill"]
            if kill_vis["t_visible"] is not None
            and kill_vis["t_kill"] is not None else None)
        # fish ONE failed-over ticket out of the kill wave and stitch
        # its cross-replica story into a single fleet trace
        stitched = None
        for t in kill_tickets:
            if getattr(t, "failovers", 0) \
                    and getattr(t, "prior_traces", None):
                stitched = obs.stitch_fleet_trace(t)
                break

        # -- phase 2: graceful drain, mid-traffic -------------------
        t0 = time.perf_counter()
        rep_drain = loadgen.run_load(
            router, loadgen.build_schedule(
                rng, args.requests, rate_hz=0.0,
                deadline_ms=args.deadline_ms),
            verify=args.verify, rng=rng,
            result_timeout=args.result_timeout,
            mid_hook=lambda: group.drain("r1"))
        rep_drain["phase_wall_s"] = time.perf_counter() - t0
        rep_drain["throughput_rps"] = (
            (rep_drain["ok"] + rep_drain["degraded"])
            / rep_drain["phase_wall_s"]
            if rep_drain["phase_wall_s"] > 0 else 0.0)
        phase_reports["replica_drain"] = rep_drain
        scrapes["after_drain"] = loadgen.scrape_endpoint(
            group.obs_port)
        rstats = router.stats()
        answered_final = dict(rstats["answered_by_replica"])
        group_stats = group.stats()

        # -- phase 3: cold replica restart --------------------------
        # the zero-warmup story at replica scale: revive the killed
        # replica (Server.start preloads the warm artifact pack when
        # VELES_SIMD_ARTIFACTS is armed) and clock its FIRST request
        # against a survivor's steady-state single-request latency.
        # Honesty note: thread-mode replicas share the process's
        # kernel library and plan caches, so what this gate holds to
        # budget is the restart PLUMBING (lifecycle, prober rejoin,
        # preload hook, first-request dispatch path) — the cold-start
        # number itself is tools/cold_start_torch.py's subprocess
        # measurement, where the caches are genuinely empty
        survivor = group.replica("r2")
        probe_req = lambda: serve.Request(  # noqa: E731 — tiny local
            "sosfilt", rng.randn(512).astype(np.float32),
            {"sos": loadgen._sos()}, tenant="restart-probe")
        t0 = time.perf_counter()
        _replica_submit(survivor, probe_req()).result(
            timeout=args.result_timeout)
        lat_survivor = time.perf_counter() - t0
        restarted = group.restart("r0")
        t0 = time.perf_counter()
        restart_ticket = _replica_submit(restarted, probe_req())
        restart_ticket.result(timeout=args.result_timeout)
        lat_restart = time.perf_counter() - t0
        restart_status = restart_ticket.status

        # -- history axis (obs v6): breaker cycle + incident close --
        # one deterministic breaker cycle through the REAL Breaker
        # event seam (open -> half_open -> closed) so the journal
        # pack holds a complete breaker story to reconstruct — the
        # replica mix is healthy traffic, so no breaker trips
        # naturally in this campaign
        jbr = breaker.Breaker("serve.chaos", key="journal_cycle",
                              window=4, threshold=0.5, min_events=2,
                              probe_every=1)
        jbr.failure()
        jbr.failure()           # failure_rate -> open
        jbr.admit()             # probe cadence -> half_open
        jbr.success()           # probe_success -> closed
        # revive the drained replica too: with the whole fleet
        # healthy again the replica_down incident the kill opened can
        # CLOSE through the engine's quiet-period hysteresis while
        # the journal is still armed
        group.restart("r1")
        incident_deadline = faults.monotonic() + 30.0
        incident_closed_live = False
        while faults.monotonic() < incident_deadline:
            isnap = obs.incidents_snapshot()
            if any(i["rule"] == "replica_down"
                   and i["state"] == "closed"
                   for i in isnap.get("incidents", ())):
                incident_closed_live = True
                break
            threading.Event().wait(0.05)

        # -- fleet tracing overhead (collector armed) ---------------
        # the <5% request-axis overhead budget, re-measured while the
        # fleet collector sweeps the (still-started) group in the
        # background — the v5 axis must not buy its time series with
        # request latency.  Same A/B interleave as loadgen's row,
        # renamed so bench_regress tracks it as its own series (it
        # still matches the existing "tracing overhead" 5% noise
        # entry by substring).
        # the overhead row must measure the SAME flag configuration
        # as loadgen's gated "tracing overhead" series — the traffic
        # phases above ran with continuous batching + ragged packing
        # armed; disarm back to the caller's flags before measuring
        # (idempotent: the wrapper's finally restores again)
        restore_features()
        ov_args = argparse.Namespace(
            overhead_requests=(80 if args.smoke else 300),
            workers=args.workers)
        fleet_overhead = loadgen.overhead_row(ov_args, rng)
        fleet_overhead["metric"] = "fleet tracing overhead"
        fleet_overhead.setdefault("telemetry", {})[
            "collector_armed"] = True
        # -- journal-armed overhead (obs v6) ------------------------
        # same A/B interleave, toggling the durable journal instead
        # of the request axis: appending every decision to disk must
        # not buy history with request latency (loose in-campaign
        # floor here; the tight 5% gate is bench_regress's, via the
        # "journal overhead" noise entry)
        journal_overhead = loadgen.journal_overhead_row(ov_args, rng)

        # goodput counters live with the DISPATCHER: in-process that
        # is this process's obs counters; over the RPC data plane each
        # child owns its own, so sum them off the live children's
        # /metrics before the group stops (r0/r1 were restarted —
        # their reborn counters still make the fraction sane)
        child_rows = None
        if group.spawn != "thread":
            import urllib.request
            child_rows = {"useful": 0.0, "dispatched": 0.0}
            for r in group.replicas:
                if r.port is None:
                    continue
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{r.port}/metrics",
                            timeout=10) as resp:
                        text = resp.read().decode("utf-8")
                except Exception:  # noqa: BLE001 — partial sum ok
                    continue
                for line in text.splitlines():
                    if line.startswith(
                            "veles_simd_serve_useful_rows_total"):
                        child_rows["useful"] += float(
                            line.rsplit(None, 1)[1])
                    elif line.startswith(
                            "veles_simd_serve_dispatched_rows_total"):
                        child_rows["dispatched"] += float(
                            line.rsplit(None, 1)[1])

    total = _merge_router([warm, rep_kill, rep_drain])
    answered = total["ok"] + total["degraded"]
    drain_delta_survivors = (
        sum(answered_final.get(r, 0) for r in ("r1", "r2"))
        - sum(answered_after_kill.get(r, 0) for r in ("r1", "r2")))
    healthz_200 = {
        label: s["routes"].get("/healthz", "").startswith("200")
        for label, s in scrapes.items()}
    lifecycle = [
        (e["decision"], e.get("replica"))
        for e in _decisions("replica_lifecycle")]
    # -- postmortem reconstruction (obs v6) -------------------------
    # the group is stopped and (in subprocess mode) its replicas are
    # DEAD — everything below must come back from the on-disk journal
    # pack ALONE, through the same reader tools/obs_query.py uses.
    # In-memory obs state is deliberately not consulted.
    j_records, j_skipped = obs_journal.read_pack(journal_pack) \
        if journal_pack else ([], 0)
    j_files = [os.path.basename(p)
               for p in obs_journal.discover(journal_pack)] \
        if journal_pack else []
    j_decisions = [r for r in j_records if r.get("kind") == "decision"]
    j_lifecycle = [
        (r.get("decision"), (r.get("data") or {}).get("replica"))
        for r in j_decisions if r.get("op") == "replica_lifecycle"]
    j_breaker_edges = [
        r.get("decision") for r in j_decisions
        if r.get("op") == "breaker_transition"]
    j_incidents = obs_query.incidents_from(j_records)
    j_replica_down = [i for i in j_incidents
                      if i["rule"] == "replica_down"]
    # the restart budget: the revived replica's first request must
    # land within a generous multiple of the survivor's single-request
    # latency (plus an absolute floor for host-scheduling jitter —
    # both probes pay the same batcher max_wait).  In subprocess mode
    # a restart that rebuilt its kernels under traffic would blow
    # through this
    # by seconds; in the thread-mode campaign it bounds the restart
    # plumbing (see the phase-3 note above).
    restart_budget_s = max(0.5, 25.0 * lat_survivor)
    if args.spawn != "thread":
        # a restarted CHILD is a genuinely cold process: it creates
        # its CUDA context and loads the kernel library before its
        # ready line, and its first request pays first-call plans (no
        # shared caches, no warm pack armed here), so the budget
        # bounds "restart + first call under traffic", not restart
        # plumbing
        restart_budget_s = max(restart_budget_s, 30.0)
    # fleet goodput: useful rows / dispatched rows across the whole
    # campaign, straight from the _finish_batch counters — a sane
    # value is a fraction in (0, 1] (pow2 padding means < 1 whenever
    # any batch padded; == 1 when every row was useful)
    useful_rows = _counter_total("serve_useful_rows")
    dispatched_rows = _counter_total("serve_dispatched_rows")
    if child_rows is not None:
        useful_rows += child_rows["useful"]
        dispatched_rows += child_rows["dispatched"]
    campaign_goodput = (useful_rows / dispatched_rows
                        if dispatched_rows else None)
    fleet_lag_ticks = (fleet_lag_s / group.fleet_tick_s
                       if fleet_lag_s is not None else None)
    stitch_meta = (stitched or {}).get("otherData", {})
    stitch_events = (stitched or {}).get("traceEvents", [])
    # both replicas' edges visible: every attempt track carries at
    # least one lifecycle instant event, and ≥2 distinct replicas
    # appear on the attempt list
    stitch_tids = {e.get("tid") for e in stitch_events
                   if e.get("ph") == "i"
                   and e.get("name") != "failover_hop"}
    stitch_dls = [d for d in stitch_meta.get("deadlines_ms", ())
                  if d is not None]
    invariants = {
        "zero_lost": total["lost"] == 0,
        "zero_double_answered": (
            total["double_answered"] == 0
            and _counter_total("router_dedup") == 0),
        "zero_untyped_errors": total["errors"] == 0,
        "parity_clean": total["parity_failures"] == 0,
        # the kill actually orphaned queued work and the router
        # re-routed every bit of it onto survivors
        "failover_observed": total["failovers"] >= 1,
        # every re-submission carried the ORIGINAL deadline's
        # remaining budget — never a fresh stamp
        "failover_deadlines_carried": (
            total["failover_deadline_checked"] >= 1
            and total["failover_deadline_violations"] == 0),
        # the killed replica's requests all reached a terminal edge
        # before re-routing — no orphaned causal chains
        "killed_replica_traces_terminal": (
            total["prior_trace_checked"] >= 1
            and total["prior_trace_orphans"] == 0),
        # the dead replica answers nothing after its kill; the
        # survivors absorb the whole drain-phase wave
        "killed_replica_frozen": (
            answered_final.get("r0", 0)
            == answered_after_kill.get("r0", 0)),
        "survivors_absorb_traffic": (
            drain_delta_survivors
            == rep_drain["ok"] + rep_drain["degraded"]
            and rep_drain["ok"] + rep_drain["degraded"] >= 1),
        # graceful drain loses nothing and leaves exactly one
        # survivor taking traffic
        "drain_graceful": (group_stats["alive"] == 1
                           and ("drain", "r1") in lifecycle
                           and ("dead", "r1") in lifecycle),
        "kill_recorded": ("kill", "r0") in lifecycle,
        # the cold-restart phase: the revived replica answered its
        # first request OK, within budget of the survivor's steady
        # state, and the lifecycle recorded the restart
        "restart_recorded": ("restart", "r0") in lifecycle,
        "restart_answered": restart_status in ("ok", "degraded"),
        "restart_within_budget": lat_restart <= restart_budget_s,
        "heartbeats_observed": beats_seen,
        # the router-level aggregation endpoint answered all three
        # routes — 200 on /healthz — before, between, and after the
        # failures (one replica always remained healthy)
        "group_healthz_live": all(
            s["ok"] == 3 and s["failed"] == 0
            for s in scrapes.values()),
        "group_healthz_200": all(healthz_200.values()),
        # the request axis stays complete across the group
        "zero_orphaned_traces": (total["trace_checked"] > 0
                                 and total["trace_orphans"] == 0),
        "trace_phases_sum_to_total": total["trace_phase_err"] == 0,
        "answers_accounted": (
            answered + total["shed"] + total["deadline_miss"]
            + total["closed"] + total["errors"]
            == total["requests"]),
        # -- fleet axis (obs v5) --------------------------------
        # the kill became visible through obs.signals() — the
        # autoscaler read path, not group internals — within a
        # bounded number of collector ticks (generous 60-tick CI
        # bound; typically 1-2 ticks of 25 ms)
        "fleet_kill_visible": (
            fleet_lag_ticks is not None and fleet_lag_ticks <= 60.0),
        # one failed-over request stitched into ONE fleet trace:
        # ≥2 attempts on ≥2 distinct replicas, every attempt track
        # carrying lifecycle edges
        "fleet_trace_stitched": (
            stitched is not None
            and stitch_meta.get("attempts", 0) >= 2
            and len(set(stitch_meta.get("replicas", ()))) >= 2
            and stitch_tids >= set(
                range(1, stitch_meta.get("attempts", 0) + 1))),
        # the stitched per-attempt deadline stamps only ever shrink —
        # the carried-deadline proof, readable off the fleet trace
        "fleet_trace_deadline_carried": (
            len(stitch_dls) >= 2
            and all(later <= earlier + 1e-6 for earlier, later
                    in zip(stitch_dls, stitch_dls[1:]))),
        # goodput is a sane fraction: some rows dispatched, useful
        # never exceeds dispatched
        "fleet_goodput_sane": (
            campaign_goodput is not None
            and 0.0 < campaign_goodput <= 1.0),
        # the request axis stays affordable with the collector
        # sweeping (loose in-campaign floor; the tight 5% gate is
        # bench_regress's, via the "tracing overhead" noise entry).
        # 0.70 not 0.80: under a full `make tests` run the throughput
        # ratio has measured as low as 0.74 from suite CPU contention
        # alone — the floor guards against a collapse, not noise
        "fleet_tracing_overhead_ok": (
            fleet_overhead["value"] is not None
            and fleet_overhead["value"] >= 0.70),
        # -- history axis (obs v6) ------------------------------
        # every parseable journal line recovered, no torn lines in
        # a cleanly-flushed pack, and at least one file per writer
        "journal_pack_readable": (
            len(j_files) >= 1 and j_skipped == 0
            and len(j_records) >= 1),
        # the kill/drain/restart story reconstructed purely from
        # disk — including BOTH revivals — matching what the live
        # decision log saw
        "journal_lifecycle_recovered": (
            ("kill", "r0") in j_lifecycle
            and ("drain", "r1") in j_lifecycle
            and ("dead", "r1") in j_lifecycle
            and ("restart", "r0") in j_lifecycle
            and ("restart", "r1") in j_lifecycle),
        # the scripted breaker cycle came back whole from disk:
        # open, half_open and re-closed edges all journaled
        "journal_breaker_cycle_recovered": (
            {"open", "half_open", "closed"}
            <= set(j_breaker_edges)),
        # the kill window's replica_down incident was OPENED by the
        # engine's hysteresis and CLOSED after the revived fleet's
        # quiet period — both edges reconstructed from disk alone
        "journal_incident_reconstructed": any(
            i["open"] is not None and i["close"] is not None
            for i in j_replica_down),
        # the same closure was visible live through /incidents
        # before the group stopped (diagnosis aid: separates an
        # engine problem from a journaling problem)
        "incident_closed_live": incident_closed_live,
        # journaling every decision stays affordable (loose floor;
        # the 5% gate is bench_regress's "journal overhead" entry).
        # 0.70 not 0.80: the A/B ratio measures 0.97 standalone but
        # dips to ~0.79 under full-suite CPU contention — like
        # fleet_tracing_overhead, this floor guards collapse, not
        # scheduler noise
        "journal_overhead_ok": (
            journal_overhead["value"] is not None
            and journal_overhead["value"] >= 0.70),
    }

    rows = [
        {"metric": "replica campaign answered",
         "value": float(answered), "unit": "req",
         "vs_baseline": None},
        {"metric": "replica failover throughput",
         "value": round(rep_kill["throughput_rps"], 2),
         "unit": "req/s", "vs_baseline": None,
         # measured while a replica dies mid-wave: fault-carrying,
         # DEGRADED-not-gated on a dip
         "chaos_phase": "replica_kill"},
        {"metric": "replica drain throughput",
         "value": round(rep_drain["throughput_rps"], 2),
         "unit": "req/s", "vs_baseline": None,
         "chaos_phase": "replica_drain"},
        {"metric": "replica restart first request",
         "value": round(1.0 / lat_restart, 3) if lat_restart else 0.0,
         "unit": "1/s", "vs_baseline": None,
         # one order statistic measured right after an abrupt kill +
         # restart: fault-carrying by construction
         "chaos_phase": "replica_restart",
         "telemetry": {"restart_s": round(lat_restart, 4),
                       "survivor_s": round(lat_survivor, 4),
                       "budget_s": round(restart_budget_s, 4)}},
    ]
    snap = obs.snapshot()
    counters = {}
    for c in snap["counters"]:
        if c["name"].startswith(("router_", "replica_", "serve_")):
            counters[c["name"]] = counters.get(c["name"], 0) \
                + c["value"]
    rows.append({
        "metric": "replica failovers",
        "value": float(total["failovers"]), "unit": "requests",
        "vs_baseline": None, "chaos_phase": "replica_kill",
        "telemetry": {"counters": counters},
    })
    if fleet_lag_s:
        rows.append({
            # higher-is-better form (1/lag) so the gate's floor logic
            # applies; one kill-to-visible wall-clock sample on the
            # collector cadence
            "metric": "fleet signal lag",
            "value": round(1.0 / fleet_lag_s, 3), "unit": "1/s",
            "vs_baseline": None, "chaos_phase": "replica_kill",
            "telemetry": {"lag_s": round(fleet_lag_s, 4),
                          "lag_ticks": round(fleet_lag_ticks, 2),
                          "tick_s": group.fleet_tick_s}})
    if campaign_goodput is not None:
        rows.append({
            "metric": "replica campaign goodput",
            "value": round(campaign_goodput, 4),
            "unit": "useful/dispatched rows", "vs_baseline": None,
            "telemetry": {"useful_rows": useful_rows,
                          "dispatched_rows": dispatched_rows}})
    rows.append(fleet_overhead)
    rows.append(journal_overhead)
    # --spawn subprocess writes its own bench series (the suffix keeps
    # substring-matched noise entries like "replica failover" applying
    # to both) and every row records the transport it measured; the
    # overhead rows stay unsuffixed — they A/B a fresh in-process
    # server regardless of campaign spawn
    suffix = "" if args.spawn == "thread" else f" {args.spawn}"
    for row in rows:
        if suffix and "overhead" not in row["metric"]:
            row["metric"] += suffix
        row["spawn"] = args.spawn
    evidence = {
        "replica_invariants": invariants,
        "spawn": args.spawn,
        "restart": {"first_request_s": lat_restart,
                    "survivor_s": lat_survivor,
                    "budget_s": restart_budget_s,
                    "status": restart_status},
        "phase_reports": {k: {kk: vv for kk, vv in v.items()
                              if not isinstance(vv, np.ndarray)}
                          for k, v in phase_reports.items()},
        "router": {k: rstats[k] for k in
                   ("policy", "max_failovers", "placed_by_replica",
                    "answered_by_replica", "failovers",
                    "placement_failures")},
        "answered_after_kill": answered_after_kill,
        "answered_final": answered_final,
        "replica_lifecycle_events":
            _decisions("replica_lifecycle"),
        "router_failover_events": _decisions("router_failover"),
        "scrapes": scrapes,
        "group": group_stats,
        "fleet": {
            "tick_s": group.fleet_tick_s,
            "kill_visible_lag_s": fleet_lag_s,
            "kill_visible_lag_ticks": fleet_lag_ticks,
            "goodput": campaign_goodput,
            "stitched_trace": stitch_meta,
        },
        "journal": {
            "pack": journal_pack,
            "files": j_files,
            "records": len(j_records),
            "skipped": j_skipped,
            "lifecycle": j_lifecycle,
            "breaker_edges": j_breaker_edges,
            "incidents": [
                {"id": i["id"], "rule": i["rule"],
                 "opened": i["open"] is not None,
                 "closed": i["close"] is not None}
                for i in j_incidents],
        },
    }
    return invariants, rows, evidence


# -- the control-axis campaign (obs v7): --scale ----------------------------

class _ShimReplica:
    def __init__(self, rid):
        self.rid = rid


class _ShimGroup:
    """A group-shaped stub for the SYNTHETIC scaler segments (the
    flap-storm and the deterministic incident chain): real verbs are
    recorded, no servers are born.  The live-ramp segment uses a real
    ``ReplicaGroup`` — this shim only exists so the synthetic engines
    can act without disturbing it."""

    def __init__(self, n=1):
        self.rids = [f"s{i}" for i in range(n)]
        self.calls = []

    def alive(self) -> int:
        return len(self.rids)

    def live_replicas(self) -> list:
        return [_ShimReplica(r) for r in self.rids]

    def spawn_replica(self):
        rid = f"s{len(self.calls) + len(self.rids)}"
        self.rids.append(rid)
        self.calls.append(("spawn", rid))
        return _ShimReplica(rid)

    def retire(self, rid, reason="scaler"):
        self.rids.remove(rid)
        self.calls.append(("retire", rid))

    def restart(self, rid):
        self.calls.append(("restart", rid))
        return _ShimReplica(rid)


def _synth_sig(t, *, burn=0.0, bvel=0.0, depth=0.0, flaps=0,
               goodput=1.0, health=None, incidents=()):
    """A FleetSignals-shaped bundle with a scripted clock — the same
    duck type ``ScalerEngine.tick`` and ``IncidentEngine.tick`` read,
    so the synthetic segments drive REAL engines deterministically."""
    return argparse.Namespace(
        at_s=t,
        slo_burn={"carol": burn} if burn else {},
        slo_burn_velocity={"carol": bvel} if bvel else {},
        queue_depth={}, queue_depth_total=depth,
        breaker_flaps={"chaos": flaps} if flaps else {},
        goodput_overall=goodput, health=dict(health or {}),
        incidents=list(incidents))


# the scale campaign's control cadence and peak.  The JAX tool ticks
# its scaler every 30 ms over a 25 ms collector, tuned to its CPU
# clock, where the --peak-requests burst holds a backlog for seconds.
# The port serves that burst in 42-187 ms on the CPU, so at 30/25 ms
# the backlog often drained before the 2-tick up hysteresis saw it
# (no scale_up, the campaign red in 1 run of 3), and at 5/5 ms still
# in 1 run of 10.  So the port's loop ticks at 5 ms, and its peak
# holds PEAK_HOLD_S of the calibrated 1-replica rate where that is
# more than --peak-requests, up to PEAK_CAP: past the admission bound
# (64 a tenant, three tenants) a burst sheds, and a shed attempt burns
# its tenant's SLO (the scaler then holds max replicas to the end).  At
# --seed 0 no tenant draws more than 55 requests of a peak of up to
# PEAK_CAP, smoke or not.
SCALE_TICK_MS = 5.0
FLEET_TICK_MS = 5.0
PEAK_HOLD_S = 0.5
PEAK_CAP = 144


def run_scale_campaign(args) -> tuple:
    """Arm the durable journal + a fast incident cadence around the
    control-axis campaign body, exactly like the replica campaign: the
    whole run journals to a fresh pack so the decision sequence can be
    gated purely from disk after every replica is gone."""
    journal_pack = tempfile.mkdtemp(prefix="veles-chaos-scale-")
    armed = {obs_journal.JOURNAL_DIR_ENV: journal_pack,
             obs_incidents.TICK_MS_ENV: "50"}
    prior = {k: os.environ.get(k) for k in armed}

    def _restore():
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    os.environ.update(armed)
    # a stale incident ledger from an earlier campaign/test in this
    # process would pollute the pack's incident -> action chain
    obs_incidents.reset()
    try:
        return _scale_campaign_body(args, journal_pack)
    finally:
        _restore()


def _scale_campaign_body(args, journal_pack=None) -> tuple:
    """The obs v7 proof, four segments:

    1. **diurnal ramp** — low -> ~10x peak -> low over a LIVE armed
       group (``scaler=True``): the queue-backlog rule must spawn at
       least one warm replica under the peak, the sustained-idle rule
       must retire back to ``min`` after, p99 + SLO hit rate stay in
       budget, zero lost/double-answered across the scale events, and
       replica-seconds land within a factor of the oracle-optimal
       schedule (self-calibrated from measured 1-replica capacity);
    2. **flap-storm** — a synthetic oscillating signal (burn + breaker
       flaps flipping every tick) over a REAL engine: hysteresis must
       produce ZERO actions — only typed no-ops;
    3. **deterministic incident chain** — a real ``IncidentEngine``
       opens an ``slo_burn`` incident, a real ``ScalerEngine`` acts on
       it (the decision event carries the incident id), the signals
       recover, the incident closes — all journaled;
    4. **offline reconstruction** — the pack alone (``obs_journal`` +
       ``tools/obs_query``) must recover every live decision, the
       scale_up/scale_down story, and render the postmortem's
       incident -> action -> effect chain with signal deltas.

    Returns ``(invariants, rows, evidence)``."""
    import urllib.request

    from veles.simd_tpu_torch.serve import cluster
    from veles.simd_tpu_torch.serve import scaler as serve_scaler

    rng = np.random.RandomState(args.seed)
    # generous per-tenant SLOs (the loadgen idiom): the gate is that
    # the accounting runs and scaling KEEPS the hit rate ~1.0 through
    # the ramp, not that a CPU smoke hits production latencies
    for tenant in loadgen.DEFAULT_TENANTS:
        obs.slo(tenant, target_ms=args.deadline_ms, hit_rate=0.99)

    scale_max = args.scale_max
    # control config tuned to the port's clock: SCALE_TICK_MS ticks
    # over a FLEET_TICK_MS collector, 2-tick up hysteresis, a 12-tick
    # sustained-idle window, cooldown between every action.
    # depth_high is the deterministic trigger — the peak burst lands
    # as one backlog far above it, while the paced low phases never
    # accumulate depth.
    group = cluster.ReplicaGroup(
        1, max_batch=8, max_wait_ms=4.0, workers=args.workers,
        heartbeat_ms=40.0, obs_port=0, fleet_tick_ms=FLEET_TICK_MS,
        scaler=True, scaler_tick_ms=SCALE_TICK_MS,
        scaler_kwargs=dict(
            min_replicas=1, max_replicas=scale_max,
            cooldown_s=0.35, up_ticks=2, down_ticks=12,
            depth_high=6.0, idle_depth=1.0))
    router = cluster.FrontRouter(group)
    phase_reports: dict = {}

    # replica-seconds sampler: integrate alive-count over the ramp
    samples: list = []
    sampler_stop = threading.Event()

    def _sample():
        while not sampler_stop.wait(0.02):
            samples.append((time.monotonic(), group.alive()))

    def _settle_to_min(deadline_s):
        """Wait for the idle rule to retire back to min (best effort:
        the gates below assert the counts, not this wait)."""
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline and group.alive() > 1:
            threading.Event().wait(0.05)

    with group:
        # -- warmup: pay the mix's first calls off the clock --------
        warm = loadgen.run_load(
            router, loadgen.build_schedule(
                rng, 6, rate_hz=0.0, deadline_ms=args.deadline_ms),
            verify=0, rng=rng, result_timeout=args.result_timeout)
        phase_reports["warm"] = warm
        # -- calibrate 1-replica capacity for the oracle ------------
        t0 = time.perf_counter()
        calib = loadgen.run_load(
            router, loadgen.build_schedule(
                rng, args.low_requests, rate_hz=0.0,
                deadline_ms=args.deadline_ms),
            verify=0, rng=rng, result_timeout=args.result_timeout)
        calib_wall = max(time.perf_counter() - t0, 1e-6)
        rate1 = max((calib["ok"] + calib["degraded"]) / calib_wall,
                    1e-6)
        phase_reports["calib"] = calib
        _settle_to_min(8.0)
        peak_requests = max(args.peak_requests, min(
            PEAK_CAP, int(np.ceil(rate1 * PEAK_HOLD_S))))

        # -- the diurnal ramp ---------------------------------------
        sampler = threading.Thread(target=_sample, daemon=True)
        t_ramp0 = time.monotonic()
        sampler.start()
        phase_meta = []
        t0 = time.perf_counter()
        low1 = loadgen.run_load(
            router, loadgen.build_schedule(
                rng, args.low_requests, rate_hz=args.low_rate,
                deadline_ms=args.deadline_ms),
            verify=args.verify, rng=rng,
            result_timeout=args.result_timeout)
        phase_meta.append(("low1", args.low_requests,
                           max(time.perf_counter() - t0, 1e-6)))
        phase_reports["scale_low1"] = low1
        # peak: ~10x the low offered rate, submitted unpaced — the
        # whole burst lands as queue backlog, the deterministic
        # scale-up trigger on a CPU box that is never latency-bound
        t_peak_wall = time.time()
        t0 = time.perf_counter()
        peak = loadgen.run_load(
            router, loadgen.build_schedule(
                rng, peak_requests, rate_hz=0.0,
                deadline_ms=args.deadline_ms),
            verify=args.verify, rng=rng,
            result_timeout=args.result_timeout)
        peak_wall = max(time.perf_counter() - t0, 1e-6)
        phase_meta.append(("peak", peak_requests, peak_wall))
        phase_reports["scale_peak"] = peak
        t0 = time.perf_counter()
        low2 = loadgen.run_load(
            router, loadgen.build_schedule(
                rng, args.low_requests, rate_hz=args.low_rate,
                deadline_ms=args.deadline_ms),
            verify=args.verify, rng=rng,
            result_timeout=args.result_timeout)
        phase_meta.append(("low2", args.low_requests,
                           max(time.perf_counter() - t0, 1e-6)))
        phase_reports["scale_low2"] = low2
        # ramp down: the sustained-idle window must retire the extra
        # replicas back to min while the journal is still armed
        _settle_to_min(10.0)
        t_ramp1 = time.monotonic()
        sampler_stop.set()
        sampler.join(timeout=2.0)

        # -- live surfaces while armed ------------------------------
        live_snap = obs.scaler_snapshot()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{group.obs_port}/scaler",
                timeout=10) as r:
            route_snap = json.loads(r.read().decode("utf-8"))
        scaler_summary = group.stats()["scaler"]
        alive_end = group.alive()
        slo_snap = obs.slo_snapshot()
        live_actions = dict(serve_scaler.snapshot()["actions"])

    # -- segment 2: flap-storm over a real engine (zero thrash) -----
    storm_shim = _ShimGroup(2)
    storm = serve_scaler.ScalerEngine(
        storm_shim, min_replicas=1, max_replicas=scale_max,
        cooldown_s=0.2, up_ticks=2, down_ticks=100)
    for i in range(40):
        hot = bool(i % 2)
        storm.tick(_synth_sig(
            2000.0 + 0.05 * i, burn=5.0 if hot else 0.0,
            flaps=12 if hot else 0, depth=0.0,
            goodput=0.3 if hot else 1.0))
    storm_snap = storm.snapshot()

    # -- segment 3: deterministic incident -> action -> effect ------
    ieng = obs_incidents.IncidentEngine(open_ticks=2, close_ticks=2,
                                        burn=1.0)
    # ids are inc-<pid>-<seq> per ENGINE: offset this engine's seq so
    # its ids can never collide with whatever the process engine
    # opened during the ramp (both live in the same journal pack)
    ieng._seq = 9000
    base = 3000.0
    ieng.tick(_synth_sig(base, burn=4.0))
    opened = ieng.tick(_synth_sig(base + 0.05, burn=4.0))
    det_id = opened[0].id if opened else None
    open_incs = [{"rule": i.rule, "id": i.id} for i in opened]
    det_shim = _ShimGroup(1)
    det_eng = serve_scaler.ScalerEngine(
        det_shim, min_replicas=1, max_replicas=3,
        cooldown_s=0.1, up_ticks=2, down_ticks=400)
    det_eng.tick(_synth_sig(base + 0.10, burn=4.0,
                            incidents=open_incs))
    det_act = det_eng.tick(_synth_sig(base + 0.15, burn=4.0,
                                      incidents=open_incs))
    # the spawn lands, the burn falls: the effect window's "after"
    det_eng.tick(_synth_sig(base + 0.20, burn=0.3))
    det_eng.tick(_synth_sig(base + 0.25, burn=0.1))
    ieng.tick(_synth_sig(base + 0.30))
    closed = ieng.tick(_synth_sig(base + 0.35))

    # -- segment 4: offline reconstruction from the pack alone ------
    j_records, j_skipped = obs_journal.read_pack(journal_pack) \
        if journal_pack else ([], 0)
    j_files = [os.path.basename(p)
               for p in obs_journal.discover(journal_pack)] \
        if journal_pack else []
    j_scaler = [r for r in j_records
                if r.get("kind") == "decision"
                and r.get("op") == "scaler"]
    j_actions = [r for r in j_scaler
                 if r.get("decision") not in (None, "noop")]
    j_action_kinds = {r.get("decision") for r in j_actions}
    j_noop_reasons = {(r.get("data") or {}).get("reason")
                      for r in j_scaler
                      if r.get("decision") == "noop"}
    j_incidents = obs_query.incidents_from(j_records)
    det_rec = next((i for i in j_incidents if i["id"] == det_id),
                   None)
    linked = obs_query.scaler_actions(j_records, det_id) \
        if det_id else []
    pm_text = ""
    effect = []
    if det_rec is not None and det_rec["open"] is not None:
        pm_text = obs_query.postmortem(j_records, det_rec)
        t_close = (det_rec["close"] or {}).get(
            "t_wall", float("inf"))
        effect = obs_query.scaler_effect(j_records, linked, t_close)
    effect_map = {k: (b, a) for k, b, a in effect}

    # -- the numbers ------------------------------------------------
    total = _merge_router(
        [warm, calib, low1, peak, low2])
    answered = total["ok"] + total["degraded"]
    # replica-seconds across the ramp window vs the oracle schedule:
    # per phase, the replicas a clairvoyant controller would hold at
    # the measured 1-replica capacity — a smoke-level sanity bound
    # (factor --oracle-factor) whose real job is catching a scaler
    # that pins max replicas forever
    measured_rs = 0.0
    prev_t, prev_alive = t_ramp0, 1
    for t, alive in samples:
        measured_rs += (t - prev_t) * prev_alive
        prev_t, prev_alive = t, alive
    measured_rs += max(t_ramp1 - prev_t, 0.0) * prev_alive
    window_s = max(t_ramp1 - t_ramp0, 1e-6)
    oracle_rs = 0.0
    for _name, n_req, wall in phase_meta:
        offered = n_req / wall
        need = min(max(1, int(np.ceil(offered / rate1))), scale_max)
        oracle_rs += need * wall
    oracle_rs += max(window_s - sum(w for _, _, w in phase_meta),
                     0.0) * 1.0   # settle tail: oracle holds min
    rs_budget = args.oracle_factor * oracle_rs
    # decision lag: peak start -> the first scale_up the LIVE engine
    # committed after it, read back from the journal (the in-memory
    # decision tail is bounded and the ramp outlives it).  Live
    # replicas are r<N>; the synthetic segments' shim rids are s<N>,
    # so the filter can't match a scripted action.
    lag_s = None
    for r in j_actions:
        data = r.get("data") or {}
        if (r.get("decision") == "scale_up"
                and str(data.get("replica", "")).startswith("r")
                and r.get("t_wall", 0.0) >= t_peak_wall):
            lag_s = r["t_wall"] - t_peak_wall
            break
    peak_p99 = peak.get("wait_p99_s") or 0.0
    hit_rates = [t["hit_rate_observed"]
                 for t in slo_snap.get("accounts", {}).values()
                 if isinstance(t, dict)
                 and t.get("hit_rate_observed") is not None]
    hit_rate_min = min(hit_rates) if hit_rates else None
    alive_seen = [a for _, a in samples] or [1]

    invariants = {
        # the request path stayed whole across every scale event
        "zero_lost": total["lost"] == 0,
        "zero_double_answered": (
            total["double_answered"] == 0
            and _counter_total("router_dedup") == 0),
        "zero_untyped_errors": total["errors"] == 0,
        "parity_clean": total["parity_failures"] == 0,
        "answers_accounted": (
            answered + total["shed"] + total["deadline_miss"]
            + total["closed"] + total["errors"]
            == total["requests"]),
        # the controller actually controlled: up under the peak, back
        # down after, never outside [min, max], settled at min
        "scaled_up": live_actions.get("scale_up", 0) >= 1,
        "scaled_down": live_actions.get("scale_down", 0) >= 1,
        "bounds_respected": (min(alive_seen) >= 1
                             and max(alive_seen) <= scale_max),
        "settled_to_min": alive_end == 1,
        # latency + SLO stayed in budget THROUGH the ramp
        "p99_within_budget": peak_p99 <= args.p99_budget_s,
        "slo_hit_rate_held": (hit_rate_min is not None
                              and hit_rate_min >= 0.95),
        # efficiency: replica-seconds within a factor of the oracle
        "replica_seconds_bounded": measured_rs <= rs_budget,
        # the live control surfaces served while armed
        "scaler_route_live": (
            route_snap.get("schema") == serve_scaler.SCHEMA
            and route_snap.get("armed") is True
            and route_snap.get("ticks", 0) > 0),
        "scaler_snapshot_live": (
            live_snap.get("armed") is True
            and live_snap.get("ticks", 0) > 0
            and scaler_summary is not None
            and scaler_summary["ticks"] > 0),
        # segment 2: the flap-storm produced ZERO actions — only
        # typed no-ops — through the same hysteresis that let the
        # real ramp act
        "flap_storm_no_thrash": (
            storm_snap["ticks"] == 40
            and not storm_snap["actions"]
            and not storm_shim.calls
            and set(storm_snap["noops"])
            <= set(serve_scaler.NOOP_REASONS)),
        # segment 3 happened as scripted: open -> linked action ->
        # close, entirely through real engines
        "incident_chain_scripted": (
            det_id is not None and bool(closed)
            and det_act.get("action") == "scale_up"
            and det_act.get("incident_id") == det_id),
        # segment 4: the pack alone recovers every live decision and
        # the whole scale story
        "journal_pack_readable": (
            len(j_files) >= 1 and j_skipped == 0
            and len(j_records) >= 1),
        "journal_every_tick_recovered": (
            scaler_summary["ticks"] > 0
            and len(j_scaler) >= scaler_summary["ticks"]),
        "journal_scale_story_recovered": (
            {"scale_up", "scale_down"} <= j_action_kinds),
        "journal_noops_typed": (
            j_noop_reasons
            and j_noop_reasons <= set(serve_scaler.NOOP_REASONS)),
        # the postmortem renders the causal incident -> action ->
        # effect chain offline, and the effect window shows the burn
        # actually falling across the action
        "postmortem_chain_rendered": (
            det_rec is not None and det_rec["close"] is not None
            and len(linked) == 1
            and "scaler actions linked" in pm_text
            and "effect window" in pm_text),
        "postmortem_effect_moved": (
            "burn_max" in effect_map
            and effect_map["burn_max"][0] is not None
            and effect_map["burn_max"][1] is not None
            and effect_map["burn_max"][1]
            < effect_map["burn_max"][0]),
    }

    rows = [
        {"metric": "scale campaign answered",
         "value": float(answered), "unit": "req",
         "vs_baseline": None},
        {"metric": "scale p99 under ramp",
         # higher-is-better form (1/p99) so the gate's floor logic
         # applies; measured across the unpaced ~10x peak burst —
         # deliberately overloaded, DEGRADED-not-gated on a dip
         "value": round(1.0 / peak_p99, 3) if peak_p99 else 0.0,
         "unit": "1/s", "vs_baseline": None,
         "chaos_phase": "scale_peak",
         "telemetry": {"p99_s": round(peak_p99, 4),
                       "budget_s": args.p99_budget_s,
                       "peak_requests": peak_requests,
                       "peak_wall_s": round(peak_wall, 3)}},
        {"metric": "scale replica-seconds vs oracle",
         "value": round(oracle_rs / measured_rs, 3)
         if measured_rs else 0.0,
         "unit": "oracle/measured", "vs_baseline": None,
         "chaos_phase": "scale_ramp",
         "telemetry": {"measured_rs": round(measured_rs, 3),
                       "oracle_rs": round(oracle_rs, 3),
                       "rate1_rps": round(rate1, 2),
                       "factor_budget": args.oracle_factor,
                       "window_s": round(window_s, 3)}},
        {"metric": "scale slo hit rate",
         "value": (round(hit_rate_min, 4)
                   if hit_rate_min is not None else 0.0),
         "unit": "fraction", "vs_baseline": None},
    ]
    if lag_s is not None and lag_s > 0:
        rows.append({
            # higher-is-better (1/lag): peak start -> first committed
            # scale_up, on the SCALE_TICK_MS control cadence
            "metric": "scale decision lag",
            "value": round(1.0 / lag_s, 3), "unit": "1/s",
            "vs_baseline": None, "chaos_phase": "scale_peak",
            "telemetry": {"lag_s": round(lag_s, 4),
                          "tick_s": SCALE_TICK_MS / 1e3}})
    for row in rows:
        # the scaler-armed ramp group is thread-mode; the stamp keeps
        # SCALE rows self-describing next to the REPLICA families
        row["spawn"] = group.spawn
    evidence = {
        "scale_invariants": invariants,
        "phase_reports": {k: {kk: vv for kk, vv in v.items()
                              if not isinstance(vv, np.ndarray)}
                          for k, v in phase_reports.items()},
        "scaler": {"live": live_snap, "route": route_snap,
                   "summary": scaler_summary,
                   "storm": {k: storm_snap[k]
                             for k in ("ticks", "actions", "noops")},
                   "deterministic_action": det_act},
        "ramp": {"samples": len(samples),
                 "alive_min": min(alive_seen),
                 "alive_max": max(alive_seen),
                 "measured_replica_s": measured_rs,
                 "oracle_replica_s": oracle_rs,
                 "rate1_rps": rate1,
                 "decision_lag_s": lag_s,
                 "phases": [{"name": n, "requests": r,
                             "wall_s": round(w, 3)}
                            for n, r, w in phase_meta]},
        "slo": slo_snap,
        "journal": {
            "pack": journal_pack,
            "files": j_files,
            "records": len(j_records),
            "skipped": j_skipped,
            "scaler_decisions": len(j_scaler),
            "scaler_actions": sorted(j_action_kinds),
            "noop_reasons": sorted(r for r in j_noop_reasons if r),
            "incidents": [
                {"id": i["id"], "rule": i["rule"],
                 "opened": i["open"] is not None,
                 "closed": i["close"] is not None}
                for i in j_incidents],
            "postmortem": pm_text,
        },
    }
    return invariants, rows, evidence


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX tool's flags, ``--smoke`` applied and the details file
    named."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=48,
                    help="mixed-traffic requests per phase slice")
    ap.add_argument("--steady", type=int, default=12,
                    help="poisoned-class requests in the steady "
                         "(breaker-open) segment")
    ap.add_argument("--recovery-calls", type=int, default=8)
    ap.add_argument("--mesh-loss-calls", type=int, default=4)
    ap.add_argument("--mesh-devices", type=int, default=8)
    ap.add_argument("--overloads", type=int, default=6,
                    help="injected admission overloads in phase 2")
    ap.add_argument("--deadline-ms", type=float, default=30000.0,
                    help="end-to-end deadline stamped on every "
                         "request (generous: only real stalls miss)")
    ap.add_argument("--max-miss-frac", type=float, default=0.25,
                    help="deadline misses allowed, as a fraction of "
                         "total requests")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--verify", type=int, default=8)
    ap.add_argument("--result-timeout", type=float, default=300.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--details", default=None,
                    help="write BENCH_DETAILS-format rows + evidence "
                         "here (default CHAOS_DETAILS_torch.json, or "
                         "REPLICA_DETAILS_torch.json with --replicas)")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-long campaign (the CI gate)")
    ap.add_argument("--replicas", action="store_true",
                    help="run the 3-phase REPLICATED campaign "
                         "instead: kill one "
                         "replica abruptly mid-traffic, drain "
                         "another gracefully, gate group-wide "
                         "zero-lost/failover/healthz invariants")
    ap.add_argument("--spawn", choices=("thread", "subprocess"),
                    default="thread",
                    help="[--replicas] replica isolation: subprocess "
                         "runs the campaign over the RPC data plane "
                         "— the abrupt "
                         "kill is a real child SIGKILL mid-traffic")
    ap.add_argument("--scale", action="store_true",
                    help="run the CONTROL-AXIS campaign instead: "
                         "a ~10x diurnal ramp "
                         "over a scaler-armed group, gating p99/SLO "
                         "through the scale events, replica-seconds "
                         "vs oracle, flap-storm zero-thrash, and "
                         "the decision sequence recovered from the "
                         "journal pack alone")
    ap.add_argument("--peak-requests", type=int, default=96,
                    help="[--scale] unpaced requests in the peak "
                         "burst (the ~10x overload); more where "
                         "PEAK_HOLD_S of the calibrated rate is "
                         "more, up to PEAK_CAP")
    ap.add_argument("--low-requests", type=int, default=10,
                    help="[--scale] requests per paced low phase")
    ap.add_argument("--low-rate", type=float, default=12.0,
                    help="[--scale] offered req/s in the low phases")
    ap.add_argument("--scale-max", type=int, default=3,
                    help="[--scale] scaler max_replicas bound")
    ap.add_argument("--oracle-factor", type=float, default=4.0,
                    help="[--scale] replica-seconds budget as a "
                         "multiple of the oracle schedule")
    ap.add_argument("--p99-budget-s", type=float, default=25.0,
                    help="[--scale] queue-wait p99 budget across "
                         "the peak burst")
    args = ap.parse_args(argv)
    if args.details is None:
        args.details = (
            ("REPLICA_RPC_DETAILS_torch.json" if args.spawn != "thread"
             else "REPLICA_DETAILS_torch.json") if args.replicas
            else "SCALE_DETAILS_torch.json" if args.scale
            else "CHAOS_DETAILS_torch.json")
    if args.smoke:
        args.requests = min(args.requests, 24)
        args.steady = min(args.steady, 8)
        args.verify = min(args.verify, 4)
        args.peak_requests = min(args.peak_requests, 72)
        args.low_requests = min(args.low_requests, 8)
    return args


def campaign(args) -> tuple:
    """Run the campaign ``args`` names (:func:`parse_args`) on a fresh
    telemetry, breaker and fault state; returns ``(invariants, rows,
    evidence)``.  ``chip_smoke.py`` calls it in-process on the card."""
    obs.enable()
    obs.reset()
    breaker.reset()
    faults.reset_fault_history()
    if args.replicas:
        return run_replica_campaign(args)
    if args.scale:
        return run_scale_campaign(args)
    # a tight half-open cadence keeps the recovery phase's counting
    # argument exact: a closed-at-end breaker within the scripted
    # number of calls (restored after the campaign)
    prev_cadence = os.environ.get(breaker.BREAKER_PROBE_EVERY_ENV)
    os.environ[breaker.BREAKER_PROBE_EVERY_ENV] = "2"
    try:
        return run_campaign(args)
    finally:
        if prev_cadence is None:
            os.environ.pop(breaker.BREAKER_PROBE_EVERY_ENV, None)
        else:
            os.environ[breaker.BREAKER_PROBE_EVERY_ENV] = prev_cadence


def main(argv=None) -> int:
    args = parse_args(argv)
    from veles.simd_tpu_torch.utils.platform import select_device

    # the card, or the CPU when VELES_SIMD_PLATFORM=cpu asks for it
    # (rc 2 when no card answers); the sharded phase's mesh is
    # --mesh-devices shards of that device
    select_device()
    invariants, rows, evidence = campaign(args)

    print(json.dumps({"invariants": invariants,
                      "rows": rows}, indent=2, default=str))
    if args.details:
        with open(args.details, "w") as f:
            json.dump(rows + [evidence], f, indent=2, default=str)
        print(f"chaos: wrote {args.details}", file=sys.stderr)
    failed = sorted(k for k, ok in invariants.items() if not ok)
    if failed:
        print(f"chaos: FAILED invariants: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print("chaos: campaign green — all invariants hold",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
