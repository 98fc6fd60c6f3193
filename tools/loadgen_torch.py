#!/usr/bin/env python3
"""Load generator for the port's serving layer (``tools/loadgen.py``'s
twin over ``veles.simd_tpu_torch``).

Drives :class:`veles.simd_tpu_torch.serve.Server` (or a
``FrontRouter`` over a ``ReplicaGroup``) with Poisson (optionally
bursty) arrivals over the JAX tool's mixed op/shape/tenant traffic
matrix and accounts for every request: answered-ok, answered-degraded,
shed (typed Overloaded), errored, LOST (never answered — always a bug)
and double-answered (the ticket layer raises and counts; always a
bug).  A seeded schedule draws exactly what the JAX tool's draws, so
one seed is the same traffic through either package.

With telemetry on it also gates the request axis: every completed
ticket must carry a complete causal trace whose terminal status
matches the ticket, whose events are monotonic and whose phase
latencies sum to its total within :data:`TRACE_TOL_S`; a degraded
ticket must carry a ``degraded`` edge.  Each run with the scrape
endpoint armed hits ``/metrics``, ``/healthz`` and
``/debug/requests`` on the live server.

Modes, as the JAX tool's:

* the default run (``--smoke`` for a seconds-long one, rc 1 on any
  lost or double-answered request, parity or trace failure), with the
  pipeline-invocation streams (``--pipeline-streams``) and, with
  ``--details``, ``SERVE_DETAILS_torch.json`` rows (:func:`bench_rows`,
  the tracing-overhead and journal-overhead A/B rows) for
  ``tools/bench_regress.py``;
* ``--saturation`` — the goodput-at-saturation A/B (continuous
  batching and ragged packing off, then on), rc 1 unless the padding
  waste recovers :data:`RECOVERY_MIN` x with p99 held;
* ``--rpc-overhead`` — the same closed-loop traffic through a
  2-replica thread group and an identical subprocess group served
  over the RPC data plane;
* ``--replicas N [--spawn subprocess]`` — any run through a routed
  group.

It runs on the card (``VELES_SIMD_PLATFORM=cpu`` asks for the CPU;
without a card and without that request it exits 2).  A served
``stft`` batch of 64 or more frames at hop 128 is one K4 launch.

Usage::

    python3 tools/loadgen_torch.py --smoke
    python3 tools/loadgen_torch.py --requests 400 --rate 800 \\
        --burst-every 50 --burst-size 20 --details SERVE_DETAILS_torch.json
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))

from veles.simd_tpu_torch import obs  # noqa: E402
from veles.simd_tpu_torch import serve  # noqa: E402

# the traffic matrix: (op, params factory, signal lengths) — short
# mixed signals, the dispatch-bound regime serving exists for.  Length
# spread inside one op lands in 2-3 pow2 buckets, so the run exercises
# bucketing, not just batching.
_SOS = None


def _sos():
    global _SOS
    if _SOS is None:
        from veles.simd_tpu_torch.ops import iir

        _SOS = iir.butterworth(4, 0.25, "lowpass")
    return _SOS


def _mix():
    return [
        ("sosfilt", lambda: {"sos": _sos()}, (384, 500, 777, 1024)),
        ("lfilter", lambda: {"b": [0.2, 0.3, 0.1],
                             "a": [1.0, -0.4, 0.1]}, (256, 640)),
        ("resample_poly", lambda: {"up": 3, "down": 2}, (300, 512)),
        ("stft", lambda: {"frame_length": 128, "hop": 64},
         (512, 1000)),
    ]


DEFAULT_TENANTS = ("alice", "bob", "carol")

# phase latencies must sum to the trace total within this (in
# practice the phases are derived from the same event stamps, so the
# sum is exact and any slack here is pure safety)
TRACE_TOL_S = 1e-3

# the trace-completeness accounting categories (merged across phase
# reports by tools/chaos.py like the request categories)
TRACE_KEYS = ("trace_checked", "trace_orphans", "trace_phase_err",
              "trace_degraded_missing_edge")


def trace_failures(ticket) -> dict:
    """Request-axis completeness check for one COMPLETED ticket:
    ``trace_orphans`` (no trace, no terminal edge, or a terminal
    status disagreeing with the ticket — the causal chain never
    closed), ``trace_phase_err`` (phases do not sum to the total
    within :data:`TRACE_TOL_S`, or event times are non-monotonic),
    and ``trace_degraded_missing_edge`` (a degraded answer without a
    ``degraded`` edge).  All zero when telemetry is off (the shared
    null trace has nothing to check)."""
    out = dict.fromkeys(TRACE_KEYS, 0)
    tr = getattr(ticket, "trace", None)
    if tr is None or tr.rid < 0:
        return out      # telemetry off: no request axis to gate
    out["trace_checked"] = 1
    phases = tr.phases()
    if tr.status != ticket.status or not phases:
        out["trace_orphans"] = 1
        return out
    drift = abs(phases["queue_wait_s"] + phases["batch_wait_s"]
                + phases["device_s"] - phases["total_s"])
    stamps = [e["t_s"] for e in tr.events()]
    if drift > TRACE_TOL_S or stamps != sorted(stamps):
        out["trace_phase_err"] = 1
    if ticket.status == "degraded" and not any(
            e["event"] == "degraded" for e in tr.events()):
        out["trace_degraded_missing_edge"] = 1
    return out


def _account_traces(report: dict, tickets) -> None:
    """Fold per-ticket trace checks into ``report`` (completed
    tickets only — a LOST ticket is already its own failure)."""
    for k in TRACE_KEYS:
        report.setdefault(k, 0)
    for t in tickets:
        if not t.done():
            continue
        for k, v in trace_failures(t).items():
            report[k] += v


def scrape_endpoint(port: int | None) -> dict:
    """Hit the live scrape endpoint once (all three routes) and
    report per-route success — the serves-under-load proof every
    loadgen run performs while the server is hot."""
    import urllib.error
    import urllib.request

    out = {"port": port, "ok": 0, "failed": 0, "routes": {}}
    if port is None:
        return out
    for path in ("/metrics", "/healthz", "/debug/requests"):
        url = f"http://127.0.0.1:{port}{path}"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                status, body = r.status, r.read()
        except urllib.error.HTTPError as e:
            # a non-2xx answer IS an answer: /healthz returns 503
            # while the health machine is DEGRADED — exactly when the
            # chaos campaign scrapes — and urlopen surfaces that as
            # HTTPError, not as a response
            status, body = e.code, e.read()
        except Exception as e:  # noqa: BLE001 — reported, gated below
            out["routes"][path] = f"error: {e!r}"
            out["failed"] += 1
            continue
        good = status in (200, 503) and bool(body)
        out["routes"][path] = f"{status} ({len(body)} bytes)"
        out["ok" if good else "failed"] += 1
    return out

# the pipeline-invocation traffic leg: a small compiled chain served
# as a first-class unit (op "pipeline:<name>"), each stream threading
# its carried state through consecutive invocations
PIPELINE_NAME = "loadline"
PIPELINE_BLOCK = 256


def build_pipeline(name: str = PIPELINE_NAME,
                   block: int = PIPELINE_BLOCK):
    """A small compiled pipeline for the serving legs: IIR conditioning
    into a causal FIR — two carried states (zi + halo), cheap enough
    for the CPU smoke."""
    from veles.simd_tpu_torch import pipeline as pl
    from veles.simd_tpu_torch.ops import iir

    sos = iir.butterworth(4, 0.2, "lowpass")
    rng = np.random.RandomState(7)
    h = rng.randn(17).astype(np.float32) / 4.0
    chain = pl.Pipeline([pl.sosfilt(sos, name="condition"),
                         pl.fir(h, name="shape")], name=name)
    return chain.compile(block)


def pipeline_spec(name: str = PIPELINE_NAME,
                  block: int = PIPELINE_BLOCK) -> dict:
    """The declarative twin of :func:`build_pipeline` — the same
    deterministic chain as a ``pipeline_from_spec`` dict, the form
    that crosses a process boundary (``ReplicaGroup(...,
    pipeline_specs=[...])`` hands it to subprocess children).  Built
    from the same seeds, so the local compiled chain stays a valid
    parity oracle for answers a child served."""
    from veles.simd_tpu_torch.ops import iir

    sos = np.asarray(iir.butterworth(4, 0.2, "lowpass"))
    rng = np.random.RandomState(7)
    h = rng.randn(17).astype(np.float32) / 4.0
    return {"name": name, "block": block,
            "stages": [{"stage": "sosfilt", "name": "condition",
                        "sos": sos.tolist()},
                       {"stage": "fir", "name": "shape",
                        "h": h.tolist()}]}


def run_pipeline_streams(server, op: str, compiled, rng, *,
                         streams: int = 2, blocks: int = 4,
                         deadline_ms: float | None = None,
                         result_timeout: float = 120.0,
                         verify: bool = True) -> dict:
    """Drive ``streams`` independent pipeline streams through the
    server, ``blocks`` invocations each, threading every answer's
    carried state into the stream's next invocation (the
    pipeline-serving contract).  Same accounting categories as
    :func:`run_load`; ``verify`` parity-checks each surviving stream's
    concatenated output against the compiled chain's one-shot oracle
    (state threading through the SERVER must be exact — degraded
    blocks included)."""
    nb = compiled.block_len
    report = {"requests": 0, "ok": 0, "degraded": 0, "shed": 0,
              "closed": 0, "errors": 0, "lost": 0, "deadline_miss": 0,
              "parity_failures": 0, "double_answered": 0}
    sigs = {i: rng.randn(blocks * nb).astype(np.float32)
            for i in range(streams)}
    states = {i: None for i in range(streams)}
    outs: dict = {i: [] for i in range(streams)}
    alive = set(range(streams))
    all_tickets = []
    for b in range(blocks):
        tickets = {}
        for i in sorted(alive):
            tickets[i] = server.submit(
                op=op, x=sigs[i][b * nb:(b + 1) * nb],
                params={"state": states[i]}, tenant=f"pstream{i}",
                deadline_ms=deadline_ms)
        report["requests"] += len(tickets)
        all_tickets.extend(tickets.values())
        for i, t in tickets.items():
            try:
                value = t.result(timeout=result_timeout)
            except TimeoutError:
                report["lost"] += 1
                alive.discard(i)
                continue
            except serve.Overloaded:
                report["shed"] += 1
                alive.discard(i)
                continue
            except serve.DeadlineExceeded:
                report["deadline_miss"] += 1
                alive.discard(i)
                continue
            except serve.ServerClosed:
                report["closed"] += 1
                alive.discard(i)
                continue
            except Exception:  # noqa: BLE001 — typed per-request
                report["errors"] += 1
                alive.discard(i)
                continue
            y, new_state = value
            outs[i].append(y)
            states[i] = new_state
            report["degraded" if t.degraded else "ok"] += 1
    if verify:
        for i in sorted(alive):
            done = len(outs[i])
            if not done:
                continue
            got = compiled.assemble(outs[i])
            want = compiled.oracle(sigs[i][: done * nb])
            scale = float(np.max(np.abs(want))) or 1.0
            if float(np.max(np.abs(got - want)) / scale) > 2e-3:
                report["parity_failures"] += 1
    _account_traces(report, all_tickets)
    report["double_answered"] = obs.counter_value(
        "serve_double_answer") if obs.enabled() else 0
    return report


def build_schedule(rng, n_requests: int, rate_hz: float,
                   burst_every: int = 0, burst_size: int = 0,
                   tenants=DEFAULT_TENANTS,
                   deadline_ms: float | None = None) -> list:
    """``[(gap_seconds, Request), ...]`` — exponential inter-arrival
    gaps at ``rate_hz`` (0 = no pacing, submit as fast as possible),
    with a ``burst_size`` zero-gap burst every ``burst_every``-th
    arrival (the overload trigger).  ``deadline_ms`` stamps every
    request with an end-to-end deadline (None = server default)."""
    mix = _mix()
    schedule = []
    for i in range(n_requests):
        op, params, lengths = mix[rng.randint(len(mix))]
        n = int(lengths[rng.randint(len(lengths))])
        x = rng.randn(n).astype(np.float32)
        req = serve.Request(op, x, params(),
                            tenant=tenants[rng.randint(len(tenants))],
                            deadline_ms=deadline_ms)
        gap = float(rng.exponential(1.0 / rate_hz)) if rate_hz > 0 \
            else 0.0
        if burst_every and burst_size and i and i % burst_every == 0:
            gap = 0.0
        schedule.append((gap, req))
        if burst_every and burst_size and i and i % burst_every == 0:
            for _ in range(burst_size):
                op2, params2, lengths2 = mix[rng.randint(len(mix))]
                n2 = int(lengths2[rng.randint(len(lengths2))])
                schedule.append((0.0, serve.Request(
                    op2, rng.randn(n2).astype(np.float32), params2(),
                    tenant=tenants[rng.randint(len(tenants))],
                    deadline_ms=deadline_ms)))
    return schedule


def build_ramp_schedule(rng, phases, tenants=DEFAULT_TENANTS,
                        deadline_ms: float | None = None) -> list:
    """A multi-phase (diurnal) schedule: ``phases`` is
    ``[(duration_s, rate_hz), ...]`` and each phase contributes
    ``duration_s * rate_hz`` arrivals with exponential inter-arrival
    gaps at its own rate — ``[(10, 5), (10, 50), (10, 5)]`` is the
    ~10x ramp-up-and-back the autoscale chaos campaign drives while
    the group resizes itself.  Same request mix, tenants, and
    ``(gap_seconds, Request)`` contract as :func:`build_schedule`."""
    schedule = []
    for duration_s, rate_hz in phases:
        n = max(1, int(round(float(duration_s) * float(rate_hz))))
        schedule.extend(build_schedule(
            rng, n, float(rate_hz), tenants=tenants,
            deadline_ms=deadline_ms))
    return schedule


def _oracle_answer(req: serve.Request):
    from veles.simd_tpu_torch.serve.server import _oracle_call

    xs = np.asarray(req.x, np.float32)[None, :]
    return np.asarray(_oracle_call(req.op, xs, _canonical(req)))[0]


def _canonical(req: serve.Request) -> dict:
    from veles.simd_tpu_torch.serve.server import _OPS

    validate, _ = _OPS[req.op]
    params, _ = validate(req.params, int(np.shape(req.x)[0]))
    return params


def run_load(server, schedule, *, block: bool = False,
             block_timeout: float | None = 1.0,
             result_timeout: float = 120.0,
             verify: int = 0, rng=None,
             mid_hook=None, mid_hook_after: int | None = None,
             ticket_sink: list | None = None) -> dict:
    """Submit ``schedule`` against ``server``, wait for every ticket,
    and return the accounting report (see module docstring for the
    categories).  ``verify=k`` parity-checks ``k`` randomly sampled
    answered requests against the NumPy oracle (DEGRADED answers ARE
    the oracle, so they must match exactly-ish too).  ``server`` is
    anything with the submit/ticket contract — a ``serve.Server`` or
    a ``serve.cluster.FrontRouter``.  ``mid_hook`` is called once,
    MID-TRAFFIC, after ``mid_hook_after`` submissions (default:
    halfway) — the replicated chaos campaign's replica kill/drain
    trigger, fired while work is genuinely queued.  ``ticket_sink``
    (a caller-owned list) collects every settled ticket — how the
    chaos campaign fishes a failed-over ``RouterTicket`` out of the
    traffic for ``obs.stitch_fleet_trace``."""
    t0 = time.perf_counter()
    if mid_hook is not None and mid_hook_after is None:
        mid_hook_after = len(schedule) // 2
    pairs = []
    for i, (gap, req) in enumerate(schedule):
        if gap > 0:
            time.sleep(gap)
        if mid_hook is not None and i == mid_hook_after:
            mid_hook()
        pairs.append((req, server.submit(req, block=block,
                                         timeout=block_timeout)))
    if mid_hook is not None and mid_hook_after >= len(schedule):
        mid_hook()
    submitted_s = time.perf_counter() - t0
    report = {"requests": len(pairs), "ok": 0, "degraded": 0,
              "shed": 0, "closed": 0, "errors": 0, "lost": 0,
              "deadline_miss": 0,
              "double_answered": 0, "parity_failures": 0,
              "submit_wall_s": submitted_s}
    answered = []
    waits = []
    tenant_submitted: dict = {}
    tenant_answered: dict = {}
    for req, ticket in pairs:
        tenant_submitted[req.tenant] = \
            tenant_submitted.get(req.tenant, 0) + 1
        try:
            value = ticket.result(timeout=result_timeout)
        except TimeoutError:
            report["lost"] += 1
            continue
        except serve.Overloaded:
            report["shed"] += 1
            continue
        except serve.DeadlineExceeded:
            report["deadline_miss"] += 1
            continue
        except serve.ServerClosed:
            report["closed"] += 1
            continue
        except Exception:  # noqa: BLE001 — typed per-request error
            report["errors"] += 1
            continue
        report["degraded" if ticket.degraded else "ok"] += 1
        tenant_answered[req.tenant] = \
            tenant_answered.get(req.tenant, 0) + 1
        rid = getattr(ticket, "replica", None)
        if rid is not None:     # routed traffic: per-replica tallies
            by_rep = report.setdefault("replica_answered", {})
            by_rep[rid] = by_rep.get(rid, 0) + 1
            if getattr(ticket, "failovers", 0):
                report["failovers"] = report.get("failovers", 0) \
                    + ticket.failovers
                # the carried-deadline proof: every re-submission's
                # stamp must be the ORIGINAL deadline's remaining
                # budget — the per-attempt stamps may only shrink
                dls = [d for d in getattr(ticket, "deadlines_ms", ())
                       if d is not None]
                if len(dls) >= 2:
                    report["failover_deadline_checked"] = \
                        report.get("failover_deadline_checked", 0) + 1
                    if any(later > earlier + 1e-6 for earlier, later
                           in zip(dls, dls[1:])):
                        report["failover_deadline_violations"] = \
                            report.get("failover_deadline_violations",
                                       0) + 1
                # the dead replica's tickets all reached a terminal
                # edge before the failover re-route (no orphaned
                # causal chains on a killed replica)
                for tr in getattr(ticket, "prior_traces", ()):
                    if tr is None or tr.rid < 0:
                        continue
                    report["prior_trace_checked"] = \
                        report.get("prior_trace_checked", 0) + 1
                    if tr.status is None:
                        report["prior_trace_orphans"] = \
                            report.get("prior_trace_orphans", 0) + 1
        answered.append((req, value))
        if ticket.wait_s is not None:
            waits.append(ticket.wait_s)
    report["wall_s"] = time.perf_counter() - t0
    if ticket_sink is not None:
        ticket_sink.extend(t for _, t in pairs)
    _account_traces(report, [t for _, t in pairs])
    # per-tenant fairness under overload: the max/min ANSWERED RATIO
    # (answered[t] / submitted[t] — raw counts would read random
    # arrival imbalance as unfairness) across tenants.  max/min is
    # the human form (1.0 = perfectly fair, a starved tenant pushes
    # it toward infinity, reported None when one tenant got nothing);
    # min/max in [0, 1] is the bench-gate form — higher is better,
    # so the regression gate's floor logic applies unchanged.
    report["tenant_submitted"] = dict(sorted(tenant_submitted.items()))
    report["tenant_answered"] = dict(sorted(tenant_answered.items()))
    if len(tenant_submitted) > 1:
        ratios = [tenant_answered.get(t, 0) / n
                  for t, n in tenant_submitted.items() if n]
        lo, hi = min(ratios), max(ratios)
        report["fairness_max_min"] = (hi / lo if lo else None)
        report["fairness_min_max"] = (lo / hi if hi else 0.0)
    report["double_answered"] = obs.counter_value(
        "serve_double_answer") if obs.enabled() else 0
    if waits:
        ws = np.sort(np.asarray(waits))
        report["wait_p50_s"] = float(ws[int(0.50 * (len(ws) - 1))])
        report["wait_p99_s"] = float(ws[int(0.99 * (len(ws) - 1))])
        report["wait_max_s"] = float(ws[-1])
    done = report["ok"] + report["degraded"]
    report["throughput_rps"] = (done / report["wall_s"]
                                if report["wall_s"] > 0 else 0.0)
    if verify and answered:
        rng = rng or np.random.RandomState(0)
        idx = rng.choice(len(answered), min(verify, len(answered)),
                         replace=False)
        for i in idx:
            req, got = answered[int(i)]
            want = _oracle_answer(req)
            scale = float(np.max(np.abs(want))) or 1.0
            err = float(np.max(np.abs(np.asarray(got) - want))
                        / scale)
            if err > 2e-3:
                report["parity_failures"] += 1
    return report


def bench_rows(report: dict) -> list:
    """SERVE_DETAILS_torch.json rows for ``tools/bench_regress.py`` — both
    higher-is-better (the gate's floor logic assumes throughput rows),
    so p99 latency is emitted as its inverse."""
    rows = [{
        "metric": "serve throughput",
        "value": round(report["throughput_rps"], 2),
        "unit": "req/s",
        "vs_baseline": None,
    }]
    if report.get("wait_p99_s"):
        rows.append({
            "metric": "serve p99 inverse latency",
            "value": round(1.0 / report["wait_p99_s"], 2),
            "unit": "1/s",
            "vs_baseline": None,
        })
    if report.get("fairness_min_max") is not None:
        rows.append({
            "metric": "serve tenant fairness",
            "value": round(report["fairness_min_max"], 4),
            "unit": "min/max answered ratio",
            "vs_baseline": None,
        })
    answered = report.get("ok", 0) + report.get("degraded", 0)
    misses = report.get("deadline_miss", 0)
    if answered + misses:
        rows.append({
            "metric": "serve deadline hit rate",
            "value": round(answered / (answered + misses), 4),
            "unit": "fraction",
            "vs_baseline": None,
        })
    if obs.enabled():
        snap = obs.snapshot()
        # serve goodput: useful rows ÷ dispatched rows, straight from
        # the _finish_batch counters — the fraction of device row-work
        # that served a request instead of pow2 padding (the
        # padding-waste baseline, a gated bench row)
        useful = sum(c["value"] for c in snap["counters"]
                     if c["name"] == "serve_useful_rows")
        dispatched = sum(c["value"] for c in snap["counters"]
                         if c["name"] == "serve_dispatched_rows")
        if dispatched:
            rows.append({
                "metric": "serve goodput",
                "value": round(useful / dispatched, 4),
                "unit": "useful/dispatched rows",
                "vs_baseline": None,
                "telemetry": {"useful_rows": useful,
                              "dispatched_rows": dispatched},
            })
        rows.append({"metric": "serve batches",
                     "value": float(sum(
                         c["value"] for c in snap["counters"]
                         if c["name"] == "serve_batches")),
                     "unit": "batches", "vs_baseline": None,
                     "telemetry": {"counters": {
                         c["name"]: c["value"]
                         for c in snap["counters"]
                         if c["name"].startswith(("serve_", "fault_",
                                                  "breaker_",
                                                  "mesh_"))}}})
    return rows


# the saturation campaign's stft geometry: one param class, so with
# ragged packing ON every stft request lands in ONE shape class and
# co-packs; lengths are heavy-tailed (Pareto) so pow2 bucket padding
# is the dominant waste the campaign measures
SATURATION_FRAME = 128
SATURATION_HOP = 64
SATURATION_MAX_LEN = 2800

# the in-run acceptance bars of --saturation (the bench trajectory
# gates the finer-grained per-row noise via bench_regress): the
# after-side must recover at least 2x of the before-side's measured
# padding waste, and its p99 must stay within this slack of the
# before-side's (an order statistic on a shared CPU host needs slack;
# the "goodput p99" history row tracks the trajectory)
RECOVERY_MIN = 2.0
P99_SLACK = 2.0


def saturation_schedule(rng, n_requests: int,
                        tenants=DEFAULT_TENANTS) -> list:
    """The mixed-shape saturation campaign's traffic: every gap is 0
    (arrivals pinned above capacity — the queue is never empty, so
    batching/packing, not arrival luck, decides goodput), stft-heavy
    (75%) with heavy-tailed Pareto lengths in ONE param class (the
    ragged-packable regime), the rest sosfilt at a near-bucket-full
    length (IIR state threads along the row, so sosfilt can never
    pack — keeping its own padding small isolates the measurement to
    the waste the features CAN recover, while its rows still exercise
    continuous refill)."""
    schedule = []
    for _ in range(n_requests):
        tenant = tenants[rng.randint(len(tenants))]
        if rng.rand() < 0.75:
            n = int(SATURATION_FRAME * (1.0 + rng.pareto(1.5)))
            n = max(SATURATION_FRAME, min(n, SATURATION_MAX_LEN))
            req = serve.Request(
                "stft", rng.randn(n).astype(np.float32),
                {"frame_length": SATURATION_FRAME,
                 "hop": SATURATION_HOP}, tenant=tenant)
        else:
            req = serve.Request(
                "sosfilt", rng.randn(1000).astype(np.float32),
                {"sos": _sos()}, tenant=tenant)
        schedule.append((0.0, req))
    return schedule


def _sum_counters(snap: dict) -> dict:
    """Counter totals by name (summed across label sets)."""
    totals: dict = {}
    for c in snap["counters"]:
        totals[c["name"]] = totals.get(c["name"], 0) + c["value"]
    return totals


def _class_goodput(snap: dict) -> dict:
    """Per shape class (``op|bucket``) useful vs dispatched sample
    totals — the scoreboard's per-class axis.  Classes re-bucket
    between the A/B sides (packing folds short stft classes into one
    ``stft|ragged`` class), which is itself part of the story."""
    by: dict = {}
    for c in snap["counters"]:
        if c["name"] not in ("serve_useful_samples",
                             "serve_dispatched_samples"):
            continue
        lab = c.get("labels") or {}
        key = "%s|%s" % (lab.get("op", "?"), lab.get("bucket", "?"))
        d = by.setdefault(key, {"useful_samples": 0,
                                "dispatched_samples": 0})
        d["useful_samples" if c["name"] == "serve_useful_samples"
          else "dispatched_samples"] += c["value"]
    for d in by.values():
        d["sample_goodput"] = (
            round(d["useful_samples"] / d["dispatched_samples"], 4)
            if d["dispatched_samples"] else None)
    return by


def saturation_campaign(args, rng) -> tuple:
    """The goodput-at-saturation A/B: the SAME heavy-tailed schedule
    (same seed) served twice at saturation — ``before`` with
    continuous batching + ragged packing OFF (the padding-waste
    baseline), ``after`` with both ON — measuring useful-samples ÷
    dispatched-samples from the serve counters.  Each side warms its
    compile classes with one identical pre-pass, then measures from a
    clean registry, so first-call costs (kernel builds, cuFFT plans)
    land in neither side's p99.
    Returns ``(report, rows, failed)``; ``failed`` trips on the
    accounting gates (lost/double/parity/trace), a padding-waste
    recovery below :data:`RECOVERY_MIN`, or an after-side p99 beyond
    :data:`P99_SLACK` of the before-side."""
    from veles.simd_tpu_torch.serve import server as _srvmod

    report: dict = {"mode": "saturation",
                    "requests": int(args.requests)}
    sides: dict = {}
    saved = {env: os.environ.get(env)
             for env in (_srvmod.CONTINUOUS_ENV, _srvmod.RAGGED_ENV)}
    try:
        for side, flag in (("before", "0"), ("after", "1")):
            os.environ[_srvmod.CONTINUOUS_ENV] = flag
            os.environ[_srvmod.RAGGED_ENV] = flag
            warm = saturation_schedule(
                np.random.RandomState(args.seed), args.requests)
            sched = saturation_schedule(
                np.random.RandomState(args.seed), args.requests)
            depth = max(args.queue_depth or 0,
                        args.requests + 64)
            # wide row class by default: the more requests a dispatch
            # carries, the more short segments co-pack per row and the
            # thinner the packed plan's last-row slack (both sides run
            # the same ceiling, so the A/B stays apples-to-apples)
            mb = args.max_batch or 32
            # a slightly longer collection window than the serve
            # default: at saturation it lets every batch actually
            # reach the row class, which stabilizes BOTH sides'
            # batch compositions run-to-run (the A/B's variance
            # lives in racy partial batches hitting pow2 row pads)
            mw = 5.0 if args.max_wait_ms is None else args.max_wait_ms
            srv = serve.Server(max_batch=mb,
                               max_wait_ms=mw,
                               queue_depth=depth,
                               tenant_depth=max(args.tenant_depth
                                                or 0, depth),
                               workers=args.workers, obs_port=-1)
            with srv:
                run_load(srv, warm, verify=0)
                obs.reset()
                rep = run_load(srv, sched, verify=args.verify,
                               rng=rng)
                snap = obs.snapshot()
                counters = _sum_counters(snap)
                by_class = _class_goodput(snap)
            useful = counters.get("serve_useful_samples", 0)
            dispatched = counters.get("serve_dispatched_samples", 0)
            u_rows = counters.get("serve_useful_rows", 0)
            d_rows = counters.get("serve_dispatched_rows", 0)
            sides[side] = {
                "continuous": flag == "1", "ragged": flag == "1",
                "sample_goodput": (useful / dispatched
                                   if dispatched else None),
                "useful_samples": useful,
                "dispatched_samples": dispatched,
                "row_goodput": (u_rows / d_rows if d_rows else None),
                "refilled_rows": counters.get("serve_refilled_rows",
                                              0),
                "by_class": by_class,
                "p99_s": rep.get("wait_p99_s"),
                "report": rep,
            }
    finally:
        for env, val in saved.items():
            if val is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = val
    report.update(sides)
    before, after = sides["before"], sides["after"]
    waste_b = (1.0 - before["sample_goodput"]
               if before["sample_goodput"] is not None else None)
    waste_a = (1.0 - after["sample_goodput"]
               if after["sample_goodput"] is not None else None)
    recovery = (waste_b / waste_a
                if waste_b and waste_a and waste_a > 0 else None)
    report["padding_waste_before"] = waste_b
    report["padding_waste_after"] = waste_a
    report["waste_recovery_x"] = recovery
    def _cls_waste(side_classes, key):
        d = side_classes.get(key)
        if not d or d.get("sample_goodput") is None:
            return None
        return round(1.0 - d["sample_goodput"], 4)

    classes = sorted(set(before["by_class"]) | set(after["by_class"]))
    evidence = {"waste_before": (round(waste_b, 4)
                                 if waste_b is not None else None),
                "waste_after": (round(waste_a, 4)
                                if waste_a is not None else None),
                "refilled_rows": after["refilled_rows"],
                "useful_samples": after["useful_samples"],
                "dispatched_samples": after["dispatched_samples"],
                # per shape class: a class absent on one side re-
                # bucketed (ragged folds the short stft pow2 classes
                # into stft|ragged) — None on that side, by design
                "by_class": {k: {"waste_before":
                                 _cls_waste(before["by_class"], k),
                                 "waste_after":
                                 _cls_waste(after["by_class"], k)}
                             for k in classes}}
    rows = [{
        "metric": "goodput saturation",
        "value": (round(after["sample_goodput"], 4)
                  if after["sample_goodput"] is not None else None),
        "unit": "useful/dispatched samples",
        "vs_baseline": (round(before["sample_goodput"], 4)
                        if before["sample_goodput"] is not None
                        else None),
        "recovered": evidence,
    }, {
        "metric": "goodput recovery",
        "value": (round(recovery, 2) if recovery is not None
                  else None),
        "unit": "x padding waste recovered",
        "vs_baseline": RECOVERY_MIN,
        "recovered": evidence,
    }]
    if after["p99_s"]:
        rows.append({
            "metric": "goodput p99 inverse latency",
            "value": round(1.0 / after["p99_s"], 2),
            "unit": "1/s",
            "vs_baseline": (round(1.0 / before["p99_s"], 2)
                            if before["p99_s"] else None),
        })
    bad_side = any(
        s["report"]["lost"] or s["report"]["double_answered"]
        or s["report"]["parity_failures"]
        or s["report"]["trace_orphans"]
        or s["report"]["trace_phase_err"]
        or s["report"]["trace_degraded_missing_edge"]
        for s in sides.values())
    recovery_failed = recovery is None or recovery < RECOVERY_MIN
    p99_failed = bool(before["p99_s"] and after["p99_s"]
                      and after["p99_s"]
                      > before["p99_s"] * P99_SLACK)
    report["gates"] = {"accounting": not bad_side,
                       "recovery": not recovery_failed,
                       "p99": not p99_failed}
    return report, rows, bad_side or recovery_failed or p99_failed


def _overhead_schedule(n: int, rng) -> list:
    """A SINGLE shape class (sosfilt @ 512), so the probe warms
    exactly one handle: the mixed-traffic matrix's random row-padding
    classes pay their first-call costs lazily mid-measurement, which
    would drown a <5% per-request effect in warmup asymmetry."""
    return [(0.0, serve.Request("sosfilt",
                                rng.randn(512).astype(np.float32),
                                {"sos": _sos()}, tenant="bench"))
            for _ in range(n)]


# rounds of the overhead rows' interleave: each round runs the armed
# arm, the disarmed arm and a second disarmed arm (the A/A arm), in an
# order rotated round by round so slow host drift falls on every arm
OVERHEAD_ROUNDS = 10


def _ab_rounds(burst, set_mode, rounds: int = OVERHEAD_ROUNDS) -> dict:
    """The overhead rows' A/B in one process, with an A/A arm.

    ``burst(arm)`` runs one burst and returns ``(answered, wall_s)``;
    ``set_mode(armed)`` switches the measured feature.  Each round runs
    three arms — ``on`` (armed), ``off`` and ``off2`` (both disarmed)
    — in a rotated order, so slow drift falls on every arm.

    ``ratio`` is the MEDIAN over rounds of each round's ``on/off``
    ratio of requests per CPU second of this process
    (``time.process_time``): what the feature costs the host, which
    other processes' load does not move.  The same ratio on wall time
    (``wall_ratio``) is what a caller waits, and moves with the host:
    under six CPU-bound processes on eight cores the wall A/A arm read
    0.88 and the wall A/B 0.66 in one run, where the CPU-time ratio
    holds.  ``aa_ratio`` and ``aa_wall_ratio`` are the ``off2/off``
    medians, the measurement's own noise.  The pooled rates are kept
    for the telemetry."""
    arms = ("on", "off", "off2")
    pooled = {a: [0, 0.0] for a in arms}
    ratios = {"ab": [], "aa": [], "ab_wall": [], "aa_wall": []}
    for r in range(rounds):
        cpu_rate, wall_rate = {}, {}
        for arm in arms[r % 3:] + arms[:r % 3]:
            set_mode(arm == "on")
            c0 = time.process_time()
            done, wall = burst(arm)
            cpu = time.process_time() - c0
            pooled[arm][0] += done
            pooled[arm][1] += wall
            cpu_rate[arm] = done / cpu if cpu > 0 else None
            wall_rate[arm] = done / wall if wall > 0 else None
        for key, rate in (("", cpu_rate), ("_wall", wall_rate)):
            if rate["on"] and rate["off"]:
                ratios["ab" + key].append(rate["on"] / rate["off"])
            if rate["off2"] and rate["off"]:
                ratios["aa" + key].append(rate["off2"] / rate["off"])
    med = {k: (float(np.median(v)) if v else None)
           for k, v in ratios.items()}
    rates = {a: (n / w if w > 0 else None)
             for a, (n, w) in pooled.items()}
    return {"ratio": med["ab"], "aa_ratio": med["aa"],
            "wall_ratio": med["ab_wall"], "aa_wall_ratio": med["aa_wall"],
            "rates": rates, "rounds": rounds}


def _ab_telemetry(ab: dict) -> dict:
    return {k: (round(ab[k], 4) if ab[k] is not None else None)
            for k in ("aa_ratio", "wall_ratio", "aa_wall_ratio")}


def overhead_row(args, rng) -> dict:
    """The tracing-overhead bench row: one warmed shape class at
    ``max_batch=1`` (every request its own batch — the dispatch-bound
    regime where per-request tracing cost is largest, i.e. the honest
    worst case) through ONE live server, telemetry enabled
    throughout, alternating bursts with the REQUEST AXIS armed vs
    disarmed (``obs.configure(request_axis=...)`` — exactly the
    request axis's cost: trace minting, lifecycle edges, terminal
    accounting, SLO updates, exemplar retention; the scrape endpoint
    stays armed on both sides, idle listeners are free).  The fine
    interleave (:func:`_ab_rounds`: rotated rounds with an A/A arm,
    the median of the rounds' ratios) cancels host drift that
    run-sized A/B pairs cannot (wall-clock throughput on a shared
    host swings 2x in seconds).  Value = traced/untraced requests per
    CPU second (1.0 = the request axis is free), the wall-time ratio
    and the A/A arm's in the telemetry; ``bench_regress`` gates the
    row at 5% noise
    (``DEFAULT_NOISE``) — the request axis's overhead budget."""
    n = int(args.overhead_requests)
    m = max(10, n // 5)
    try:
        obs.enable()
        srv = serve.Server(max_batch=1, max_wait_ms=0.5,
                           workers=args.workers,
                           queue_depth=max(1024, m),
                           tenant_depth=max(1024, m), obs_port=0)
        with srv:
            def burst(_arm):
                rep = run_load(srv, _overhead_schedule(m, rng),
                               verify=0)
                return rep["ok"] + rep["degraded"], rep["wall_s"]

            def set_mode(armed):
                obs.configure(request_axis=armed)

            # warm BOTH modes: the first bursts pay the handle's first
            # call, the one-time per-(op, route) resource record,
            # and allocate the first span/histogram classes — all
            # one-offs, none of them the steady-state cost this row
            # budgets
            for warm in (False, True):
                set_mode(warm)
                burst(warm)
            # fence the collector out of the bursts: late in a long
            # process (a chaos campaign, a full test run) the heap
            # carries hundreds of MB of live caches, and one gen-2
            # sweep landing inside a ~tens-of-ms burst skews that
            # mode's wall time far more than the <5% effect being
            # measured — collect now, then keep automatic collection
            # off for the measured window
            import gc
            gc.collect()
            gc.disable()
            try:
                ab = _ab_rounds(burst, set_mode)
            finally:
                gc.enable()
            scrape_endpoint(srv.obs_port)
    finally:
        obs.configure(request_axis=True)
    ratio, rates = ab["ratio"], ab["rates"]
    return {"metric": "serve tracing overhead",
            "value": round(ratio, 4) if ratio is not None else None,
            "unit": "traced/untraced requests a CPU second",
            "vs_baseline": None,
            "telemetry": {
                "traced_rps": (round(rates["on"], 1)
                               if rates["on"] else None),
                "untraced_rps": (round(rates["off"], 1)
                                 if rates["off"] else None),
                **_ab_telemetry(ab),
                "rounds": ab["rounds"], "burst_requests": m,
            }}


def journal_overhead_row(args, rng) -> dict:
    """The journal-overhead bench row: the same fine A/B
    interleave as :func:`overhead_row` (:func:`_ab_rounds`) — one
    warmed shape class at ``max_batch=1``, telemetry AND the request
    axis armed on both sides — but the toggled variable is the durable
    event journal (``obs.configure(journal_dir=...)`` to a throwaway
    pack vs disarmed).  Healthy steady-state traffic emits no decision
    events (the journal is an EVENT journal, not a request log), so
    each timed burst also drives one ``obs.record_decision`` per
    request through the real funnel — the worst-case event rate the
    history axis budgets (a breaker/fault/lifecycle edge for every
    request).  The armed side pays the journal's full cost for each:
    stamping, JSON encoding, the locked line-atomic append + flush.
    Value = armed/disarmed requests per CPU second (1.0 = history is
    free), the wall-time ratio and the A/A arm's in the telemetry;
    ``bench_regress`` gates the row
    at 5% noise via its "journal overhead" entry — the same contract
    as the tracing-overhead row."""
    n = int(args.overhead_requests)
    m = max(10, n // 5)
    pack = tempfile.mkdtemp(prefix="veles-journal-ab-")
    journal_stats = {}

    def burst(arm):
        t0 = time.perf_counter()
        rep = run_load(srv, _overhead_schedule(m, rng), verify=0)
        for i in range(m):
            obs.record_decision("journal_probe", "tick", seq=i)
        wall = time.perf_counter() - t0
        if arm == "on":     # the armed journal's own account
            journal_stats.update(obs.journal_stats() or {})
        return rep["ok"] + rep["degraded"], wall

    def set_mode(armed):
        obs.configure(journal_dir=pack if armed else "")

    try:
        obs.enable()
        srv = serve.Server(max_batch=1, max_wait_ms=0.5,
                           workers=args.workers,
                           queue_depth=max(1024, m),
                           tenant_depth=max(1024, m), obs_port=0)
        with srv:
            # warm both modes (the handle's first call, first segment
            # open)
            for warm in (False, True):
                set_mode(warm)
                burst(warm)
            import gc
            gc.collect()
            gc.disable()       # same collector fence as overhead_row
            try:
                ab = _ab_rounds(burst, set_mode)
            finally:
                gc.enable()
    finally:
        obs.configure(journal_dir="")
        shutil.rmtree(pack, ignore_errors=True)
    ratio, rates = ab["ratio"], ab["rates"]
    telemetry = {
        "armed_rps": (round(rates["on"], 1)
                      if rates["on"] else None),
        "disarmed_rps": (round(rates["off"], 1)
                         if rates["off"] else None),
        **_ab_telemetry(ab),
        "rounds": ab["rounds"], "burst_requests": m,
    }
    if journal_stats:
        telemetry["journal_records"] = journal_stats.get("records")
        telemetry["journal_dropped"] = journal_stats.get("dropped")
    return {"metric": "journal overhead",
            "value": round(ratio, 4) if ratio is not None else None,
            "unit": "armed/disarmed requests a CPU second",
            "vs_baseline": None,
            "telemetry": telemetry}


# the rpc-overhead campaign's in-run acceptance bar: the p50 latency
# the wire ADDS over an identical in-process group must stay inside
# this budget (overridable with --rpc-p50-budget-ms).  Generous for a
# loopback hop on purpose: a shared CPU CI host pays scheduler noise
# on both sides, and the budget guards against a broken data plane
# (seconds — a stalled pool, per-request reconnects), not against
# microseconds of framing; the gated bench rows track the fine
# trajectory via bench_regress.
RPC_P50_BUDGET_MS = 75.0
# client-side in-flight window of the throughput phase: deep enough
# that RTT overlaps device time across the pool (the perf headline),
# shallow enough that neither side's admission queue sheds
RPC_WINDOW = 32


def _closed_loop(router, schedule, window: int,
                 timeout: float = 120.0) -> dict:
    """Drive ``schedule`` closed-loop with at most ``window`` requests
    in flight: submit a window, stamp each ticket's CLIENT-OBSERVED
    latency (submit -> result, transport included — ``wait_s`` is the
    server's own clock and would hide the wire), then the next.
    ``window=1`` is the sequential latency probe; a deep window is
    the throughput phase.  Returns wall time, completed count, and
    the client latency list; any non-ok answer is a counted
    failure (this is a clean-path probe — sheds or errors mean the
    probe itself is mis-sized)."""
    lat = []
    failed = 0
    done = 0
    t0 = time.perf_counter()
    for start in range(0, len(schedule), window):
        chunk = schedule[start:start + window]
        pairs = [(time.perf_counter(), router.submit(req))
                 for _, req in chunk]
        for ts, tk in pairs:
            try:
                tk.result(timeout=timeout)
            except Exception:  # noqa: BLE001 — counted, gates the row
                failed += 1
                continue
            lat.append(time.perf_counter() - ts)
            done += 1
    return {"wall_s": time.perf_counter() - t0, "completed": done,
            "failed": failed, "latencies_s": lat}


def rpc_campaign(args, rng) -> tuple:
    """The RPC-overhead A/B (``--rpc-overhead``): the same
    single-shape-class traffic served closed-loop through a
    2-replica ``FrontRouter`` twice — ``spawn="thread"`` (in-process
    submits, the baseline) and ``spawn="subprocess"`` (every request
    over the pooled-keep-alive RPC data plane) — measuring what the
    wire costs.  Two phases per side, after a warm pass that pays the
    first-call costs: a windowed throughput phase (RTT must overlap
    device time across the connection pool) and a sequential
    client-timed latency probe (the per-request added cost, transport
    included).  Returns ``(report, rows, failed)``: the ``rpc
    overhead`` row is the subprocess/thread throughput ratio and the
    ``rpc added p50`` row the inverse added-p50 (both
    higher-is-better for ``bench_regress``'s floor logic); ``failed``
    trips when any request fails on either side or the added p50
    blows the :data:`RPC_P50_BUDGET_MS` budget."""
    n = int(args.requests)
    probes = 80
    sides: dict = {}
    for spawn in ("thread", "subprocess"):
        group = serve.ReplicaGroup(
            2, spawn=spawn, max_batch=args.max_batch or 8,
            max_wait_ms=args.max_wait_ms, workers=args.workers,
            obs_port=-1)
        router = serve.FrontRouter(group)
        with group:
            # warm: compile the probe's one handle on every replica
            _closed_loop(router,
                         _overhead_schedule(4 * RPC_WINDOW, rng),
                         RPC_WINDOW)
            thr = _closed_loop(router, _overhead_schedule(n, rng),
                               RPC_WINDOW)
            seq = _closed_loop(router,
                               _overhead_schedule(probes, rng), 1)
        ls = np.sort(np.asarray(seq["latencies_s"] or [0.0]))
        sides[spawn] = {
            "spawn": spawn,
            "throughput_rps": (thr["completed"] / thr["wall_s"]
                               if thr["wall_s"] > 0 else 0.0),
            "p50_s": float(ls[len(ls) // 2]),
            "completed": thr["completed"] + seq["completed"],
            "failed": thr["failed"] + seq["failed"],
        }
    thread, sub = sides["thread"], sides["subprocess"]
    ratio = (sub["throughput_rps"] / thread["throughput_rps"]
             if thread["throughput_rps"] else None)
    added_ms = max(0.0, (sub["p50_s"] - thread["p50_s"]) * 1e3)
    budget_ms = float(args.rpc_p50_budget_ms)
    report = {"mode": "rpc_overhead", "requests": n,
              "window": RPC_WINDOW, "sides": sides,
              "throughput_ratio": ratio,
              "added_p50_ms": round(added_ms, 3),
              "p50_budget_ms": budget_ms}
    telemetry = {
        "thread_rps": round(thread["throughput_rps"], 1),
        "subprocess_rps": round(sub["throughput_rps"], 1),
        "thread_p50_ms": round(thread["p50_s"] * 1e3, 3),
        "subprocess_p50_ms": round(sub["p50_s"] * 1e3, 3),
        "added_p50_ms": round(added_ms, 3),
        "window": RPC_WINDOW, "requests": n, "spawn": "a/b",
    }
    rows = [{
        "metric": "rpc overhead",
        "value": round(ratio, 4) if ratio is not None else None,
        "unit": "subprocess/thread throughput",
        "vs_baseline": None,
        "telemetry": telemetry,
    }, {
        # inverse added-p50 so higher is better (same convention as
        # the p99 rows); the 0.05 ms floor keeps a same-or-faster
        # subprocess side from minting an unrepeatable huge value
        "metric": "rpc added p50",
        "value": round(1.0 / max(added_ms, 0.05), 4),
        "unit": "1/ms",
        "vs_baseline": None,
        "telemetry": telemetry,
    }]
    probe_failed = any(s["failed"] for s in sides.values())
    budget_failed = added_ms > budget_ms
    report["gates"] = {"clean": not probe_failed,
                       "p50_budget": not budget_failed}
    return report, rows, probe_failed or budget_failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=300)
    ap.add_argument("--rate", type=float, default=500.0,
                    help="Poisson arrival rate, Hz (0 = flat out)")
    ap.add_argument("--burst-every", type=int, default=40)
    ap.add_argument("--burst-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=None)
    ap.add_argument("--queue-depth", type=int, default=None)
    ap.add_argument("--tenant-depth", type=int, default=None)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="end-to-end deadline stamped on every "
                         "request (default: server default)")
    ap.add_argument("--block", action="store_true",
                    help="backpressure submits instead of shedding")
    ap.add_argument("--verify", type=int, default=16,
                    help="oracle parity sample size (0 = off)")
    ap.add_argument("--details", default=None,
                    help="write bench rows here "
                         "(SERVE_DETAILS_torch.json)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run, gate on lost/double/parity")
    ap.add_argument("--saturation", action="store_true",
                    help="goodput-at-saturation A/B campaign: the "
                         "same heavy-tailed mixed-shape schedule "
                         "served with continuous batching + ragged "
                         "packing off (padding-waste baseline) then "
                         "on; writes GOODPUT_DETAILS_torch rows; rc=1 "
                         "unless the padding-waste recovery reaches "
                         f"{RECOVERY_MIN}x with p99 held")
    ap.add_argument("--pipeline-streams", type=int, default=None,
                    help="pipeline-invocation streams to serve "
                         "(default: 2 in --smoke, else 0)")
    ap.add_argument("--pipeline-blocks", type=int, default=4,
                    help="invocations per pipeline stream")
    ap.add_argument("--obs-port", type=int, default=0,
                    help="scrape-endpoint port (0 = ephemeral, -1 = "
                         "disarmed)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a FrontRouter over N "
                         "replicas (1 = single server; "
                         "0 = $VELES_SIMD_REPLICAS, default 2; "
                         "per-replica answered counts land in the "
                         "report)")
    ap.add_argument("--spawn", choices=("thread", "subprocess"),
                    default="thread",
                    help="replica spawn mode for --replicas runs: "
                         "in-process servers, or child processes "
                         "served over the RPC data plane")
    ap.add_argument("--rpc-overhead", action="store_true",
                    help="RPC-overhead A/B campaign: the same "
                         "closed-loop traffic through an in-process "
                         "group then an identical subprocess group; "
                         "writes RPC_DETAILS_torch rows; rc=1 on any "
                         "failed request or an added p50 over the "
                         "budget")
    ap.add_argument("--rpc-p50-budget-ms", type=float,
                    default=RPC_P50_BUDGET_MS,
                    help="--rpc-overhead hard gate: max p50 latency "
                         "the wire may add over in-process")
    ap.add_argument("--overhead-requests", type=int, default=600,
                    help="requests per side of the tracing-overhead "
                         "probe in --details mode (0 = skip)")
    args = ap.parse_args(argv)

    from veles.simd_tpu_torch.utils.platform import select_device

    select_device()
    obs.enable()
    obs.reset()
    if args.saturation:
        rng = np.random.RandomState(args.seed)
        report, rows, failed = saturation_campaign(args, rng)
        print(json.dumps(report, indent=2, default=str))
        details = args.details or "GOODPUT_DETAILS_torch.json"
        with open(details, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"loadgen: wrote {details}", file=sys.stderr)
        if failed:
            print(f"loadgen: saturation gates FAILED "
                  f"{report['gates']}", file=sys.stderr)
            return 1
        return 0
    if args.rpc_overhead:
        rng = np.random.RandomState(args.seed)
        report, rows, failed = rpc_campaign(args, rng)
        print(json.dumps(report, indent=2, default=str))
        details = args.details or "RPC_DETAILS_torch.json"
        with open(details, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"loadgen: wrote {details}", file=sys.stderr)
        if failed:
            print(f"loadgen: rpc gates FAILED {report['gates']}",
                  file=sys.stderr)
            return 1
        return 0
    if args.smoke:
        args.requests = min(args.requests, 80)
        args.rate = 0.0
    rng = np.random.RandomState(args.seed)
    schedule = build_schedule(rng, args.requests, args.rate,
                              args.burst_every, args.burst_size,
                              deadline_ms=args.deadline_ms)
    pipeline_streams = args.pipeline_streams
    if pipeline_streams is None:
        pipeline_streams = 2 if args.smoke and args.replicas == 1 \
            else 0
    group = None
    if args.replicas != 1:
        # the replica-group front: N servers behind the breaker-aware
        # router, ONE aggregation scrape endpoint (--replicas 0
        # defers to $VELES_SIMD_REPLICAS); the pipeline leg registers
        # on every replica through the group — declaratively
        # (pipeline_specs) for subprocess replicas, whose children
        # rebuild and register the chain before taking traffic
        specs = ([pipeline_spec()]
                 if args.spawn == "subprocess" and pipeline_streams
                 else None)
        group = serve.ReplicaGroup(args.replicas
                                   if args.replicas > 1 else None,
                                   spawn=args.spawn,
                                   max_batch=args.max_batch,
                                   max_wait_ms=args.max_wait_ms,
                                   queue_depth=args.queue_depth,
                                   tenant_depth=args.tenant_depth,
                                   workers=args.workers,
                                   obs_port=args.obs_port,
                                   pipeline_specs=specs)
        server = serve.FrontRouter(group)
    else:
        server = serve.Server(max_batch=args.max_batch,
                              max_wait_ms=args.max_wait_ms,
                              queue_depth=args.queue_depth,
                              tenant_depth=args.tenant_depth,
                              workers=args.workers,
                              obs_port=args.obs_port)
    # per-tenant SLOs so the burn-rate gauges export under load (a
    # generous latency target: the gate is that the accounting runs,
    # not that a CPU smoke hits production latencies)
    for tenant in DEFAULT_TENANTS:
        obs.slo(tenant, target_ms=30000.0, hit_rate=0.99)
    with (group if group is not None else server):
        report = run_load(server, schedule, block=args.block,
                          verify=args.verify, rng=rng)
        if group is not None:
            rstats = server.stats()
            report["router"] = {
                k: rstats[k]
                for k in ("policy", "placed_by_replica",
                          "answered_by_replica", "failovers",
                          "placement_failures")}
        # the endpoint must serve while the server is hot — one hit
        # of all three routes per run
        report["scrape"] = scrape_endpoint(server.obs_port)
        if pipeline_streams > 0:
            compiled = build_pipeline()
            if group is not None and args.spawn == "subprocess":
                # the children already registered the declarative
                # twin of this chain at start; the local compile is
                # the parity oracle
                op = f"pipeline:{PIPELINE_NAME}"
            elif group is not None:
                op = group.register_pipeline(PIPELINE_NAME, compiled)
            else:
                op = server.register_pipeline(PIPELINE_NAME,
                                              compiled)
            prep = run_pipeline_streams(
                server, op, compiled, rng,
                streams=pipeline_streams,
                blocks=args.pipeline_blocks,
                deadline_ms=args.deadline_ms)
            report["pipeline"] = prep
            # the global accounting gates cover the pipeline leg too
            for k in ("lost", "parity_failures", "trace_orphans",
                      "trace_phase_err",
                      "trace_degraded_missing_edge"):
                report[k] += prep[k]
            report["double_answered"] = max(report["double_answered"],
                                            prep["double_answered"])
        report["health"] = server.stats()["health"]
        report["slo"] = obs.slo_snapshot()
    report["dispatch_quantiles"] = obs.quantiles(
        "span.serve.dispatch", phase="steady")
    rows = None
    if args.details:
        rows = bench_rows(report)
        if args.overhead_requests > 0:
            rows.append(overhead_row(args, rng))
            rows.append(journal_overhead_row(args, rng))
    print(json.dumps(report, indent=2, default=str))
    if args.details:
        with open(args.details, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"loadgen: wrote {args.details}", file=sys.stderr)
    bad = (report["lost"] or report["double_answered"]
           or report["parity_failures"] or report["trace_orphans"]
           or report["trace_phase_err"]
           or report["trace_degraded_missing_edge"]
           or report["scrape"]["failed"])
    if bad:
        print(f"loadgen: FAILED accounting (lost={report['lost']} "
              f"double={report['double_answered']} "
              f"parity={report['parity_failures']} "
              f"trace_orphans={report['trace_orphans']} "
              f"trace_phase_err={report['trace_phase_err']} "
              f"degraded_missing_edge="
              f"{report['trace_degraded_missing_edge']} "
              f"scrape_failed={report['scrape']['failed']})",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
