"""Request-axis tracing: one causal story per served request.

The port of ``veles.simd_tpu.obs.requests``, copied with its names,
bounds, environment knobs and accounting.  A request is submitted on
one thread, waits in a batcher bucket, is dispatched by a worker, may
retry or degrade inside the fault policy, and is answered (or shed, or
expired); spans are thread-local and cannot follow it.  This module is
the request axis:

* **:class:`RequestTrace`** — one per ``Server.submit`` (plain ops and
  pipeline invocations alike): a process-monotonic id, the tenant/op/
  shape-class identity, the end-to-end deadline, and a causally-ordered
  event list every lifecycle edge appends to — ``admitted`` (queue and
  tenant depth at entry), ``bucketed``, ``batch_formed`` (batch id,
  co-batched count, padding rows), ``dispatched`` (route + breaker
  state), ``retried``, ``degraded``, and exactly one terminal event
  (``answered`` / ``shed`` / ``expired`` / ``closed`` / ``error``).
  The trace object travels ON the pending-request record across
  threads, so the chain is causal by construction, not by correlation.
* **phase decomposition** — :meth:`RequestTrace.phases` splits the
  total into ``queue_wait`` (mint -> batch formed), ``batch_wait``
  (batch formed -> dispatched), and ``device`` (dispatched ->
  terminal), derived from the SAME event timestamps so the three
  always sum to the total exactly.  On the card the server copies a
  batch's answer to the host before it completes the tickets, so
  ``device`` holds the device time and the copy, not only the launch.
  Phases land in bounded per-(op, tenant) histograms
  (``request.total`` / ``request.queue_wait`` / ...; tenant label
  cardinality is capped — overflow tenants fold into ``_other``).
* **survivorship-bias-free latency** — EVERY terminal outcome lands in
  ``serve.request_latency{op, status}``: shed, expired, and
  breaker-shed requests show up in the latency distribution beside
  the answered ones.
* **exemplar retention** — the slowest trace per op and every degraded
  trace (bounded ring) are kept as FULL traces; the flight recorder
  embeds them in crash / SLO-breach bundles, and the live endpoint
  (:mod:`veles.simd_tpu_torch.obs.http`) serves them at
  ``/debug/requests``.
* **per-tenant SLO accounting** — :meth:`RequestTracer.set_slo` (the
  ``obs.slo(...)`` facade) registers a target latency and deadline-hit
  rate per tenant (env defaults: ``$VELES_SIMD_SLO_MS`` /
  ``$VELES_SIMD_SLO_HIT_RATE``); every terminal trace updates the
  tenant's account, exports ``slo_hit_rate`` / ``slo_burn_rate``
  gauges (burn = miss rate over error budget; >1 means the budget is
  burning faster than the target allows), and the first crossing into
  burn records an ``slo``/``breach`` decision event and arms a
  flight-recorder bundle with the exemplars attached.

Cost discipline, same contract as spans: with telemetry off the facade
returns the shared :data:`NULL_REQUEST` after one flag check and every
edge is a no-op; with telemetry on an edge is one lock + list append,
and only the terminal edge touches histograms.  Standard library only:
no torch, no NumPy.
"""

from __future__ import annotations

import collections
import os
import threading
import time

__all__ = [
    "RequestTrace", "RequestTracer", "NULL_REQUEST",
    "TERMINAL_STATUSES", "DEFAULT_MAX_TRACES", "DEFAULT_MAX_EXEMPLARS",
    "DEFAULT_MAX_TENANTS", "DEFAULT_SLO_HIT_RATE", "SLO_MS_ENV",
    "SLO_HIT_RATE_ENV", "MAX_TRACES_ENV",
]

# retained completed traces (the /debug/requests ring) and exemplars
# (slowest-per-op + degraded ring); both runtime-configurable
DEFAULT_MAX_TRACES = 256
DEFAULT_MAX_EXEMPLARS = 64
# distinct tenant label values admitted into histogram/gauge labels
# before folding into "_other" — the cardinality bound that lets the
# per-(op, tenant) histograms stay O(ops x tenants) in a multi-tenant
# service without trusting tenant ids to be few
DEFAULT_MAX_TENANTS = 32

SLO_MS_ENV = "VELES_SIMD_SLO_MS"
SLO_HIT_RATE_ENV = "VELES_SIMD_SLO_HIT_RATE"
MAX_TRACES_ENV = "VELES_SIMD_OBS_MAX_TRACES"

# the default deadline-hit / latency-hit rate target when an SLO names
# no rate: three nines is the classic serving starting point, and the
# matching error budget (1e-2) keeps burn rates readable
DEFAULT_SLO_HIT_RATE = 0.99

# ticket status -> terminal event name; "ok"/"degraded" both ANSWER the
# caller (degraded answers are the oracle's — still answers)
TERMINAL_STATUSES = {
    "ok": "answered",
    "degraded": "answered",
    "shed": "shed",
    "expired": "expired",
    "closed": "closed",
    "error": "error",
}

# SLO breach detection waits for a minimum sample so one slow warmup
# request cannot "breach" a fresh tenant
_SLO_MIN_REQUESTS = 20


def _env_float(name: str, default):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        return default
    return value if value > 0 else default


def env_slo_defaults() -> tuple:
    """``(target_ms_or_None, hit_rate)`` from the environment — the SLO
    applied to tenants nobody registered explicitly
    (``$VELES_SIMD_SLO_MS`` unset = no default SLO)."""
    return (_env_float(SLO_MS_ENV, None),
            min(_env_float(SLO_HIT_RATE_ENV, DEFAULT_SLO_HIT_RATE),
                0.999999))


class _NullRequestTrace:
    """Shared no-op trace returned while telemetry is off — every edge
    is one attribute lookup on a singleton, the advertised disabled
    cost."""

    __slots__ = ()
    rid = -1
    op = tenant = shape_class = status = None

    def event(self, name: str, **fields) -> None:
        pass

    def finish(self, status: str, **fields) -> None:
        pass

    def absorb_remote(self, events, replica=None) -> None:
        pass

    def events(self) -> list:
        return []

    def phases(self) -> dict:
        return {}

    def __repr__(self):
        # stable (no memory address): this singleton's repr lands in
        # generated docs, which are committed and freshness-gated
        return "NULL_REQUEST"


NULL_REQUEST = _NullRequestTrace()


class RequestTrace:
    """One request's causal record (minted by
    :meth:`RequestTracer.start`, carried on the server's pending
    record across threads; not constructed directly).

    ``rid`` is process-monotonic; event timestamps are seconds since
    the mint on the shared monotonic clock, so cross-thread edges stay
    causally ordered and phase arithmetic needs no clock translation.
    """

    __slots__ = ("rid", "op", "tenant", "shape_class", "deadline_s",
                 "status", "total_s", "_t0", "_events", "_lock",
                 "_tracer")

    def __init__(self, tracer, rid: int, op: str, tenant: str,
                 shape_class, deadline_s):
        self._tracer = tracer
        self.rid = rid
        self.op = str(op)
        self.tenant = str(tenant)
        self.shape_class = shape_class
        self.deadline_s = deadline_s
        self.status = None
        self.total_s = None
        self._t0 = time.perf_counter()
        self._events: list = []
        self._lock = threading.Lock()

    # -- edges ---------------------------------------------------------------

    def event(self, name: str, **fields) -> None:
        """Append one lifecycle edge (no-op once terminal — a late
        edge must not corrupt a finished trace's phase arithmetic)."""
        t = time.perf_counter() - self._t0
        with self._lock:
            if self.status is not None:
                return
            self._events.append({"event": str(name),
                                 "t_s": t, **fields})

    def finish(self, status: str, **fields) -> None:
        """Record the terminal edge exactly once (idempotent: the
        first caller wins) and hand the completed trace to the tracer
        for histograms, SLO accounting, and exemplar retention."""
        terminal = TERMINAL_STATUSES.get(str(status), "error")
        t = time.perf_counter() - self._t0
        with self._lock:
            if self.status is not None:
                return
            self.status = str(status)
            self.total_s = t
            self._events.append({"event": terminal, "t_s": t,
                                 "status": str(status), **fields})
        self._tracer._finished(self)

    def absorb_remote(self, events, replica=None) -> None:
        """Splice another process's trace events into this chain (the
        RPC client calls this with the replica-side events its reply
        carried, BEFORE completing the ticket).  Remote terminal
        edges are dropped — this trace closes through its own
        :meth:`finish`, exactly once — and lifecycle edges keep their
        names (``batch_formed``/``dispatched`` stay real phase
        anchors) plus a ``replica`` tag marking the process boundary.

        Remote stamps are re-anchored so the LAST absorbed edge lands
        at the splice instant on this trace's clock: monotonic clocks
        do not cross process boundaries, but the whole remote chain
        finished before the reply arrived, so ordering (and the
        phases-sum-to-total invariant) holds by construction.  No-op
        once terminal or for an empty event list."""
        terminal_names = set(TERMINAL_STATUSES.values())
        remote = [dict(e) for e in events
                  if isinstance(e, dict)
                  and e.get("event") not in terminal_names
                  and isinstance(e.get("t_s"), (int, float))]
        if not remote:
            return
        now = time.perf_counter() - self._t0
        offset = now - max(e["t_s"] for e in remote)
        with self._lock:
            if self.status is not None:
                return
            for e in remote:
                e["t_s"] = max(0.0, offset + float(e["t_s"]))
                if replica is not None:
                    e.setdefault("replica", replica)
                self._events.append(e)

    # -- reads ---------------------------------------------------------------

    def events(self) -> list:
        """Causally-ordered copy of the recorded edges."""
        with self._lock:
            return [dict(e) for e in self._events]

    def _event_time(self, name: str):
        for e in self._events:
            if e["event"] == name:
                return e["t_s"]
        return None

    def phases(self) -> dict:
        """The request's phase decomposition, from the event stamps:
        ``queue_wait`` (mint -> batch formed), ``batch_wait`` (batch
        formed -> dispatched), ``device`` (dispatched -> terminal),
        and ``total``.  A phase whose edges never happened (a shed
        request never batches) collapses onto the next known anchor,
        so the three phases ALWAYS sum to the total exactly — the
        completeness invariant loadgen and the chaos campaign gate.
        Empty until terminal."""
        with self._lock:
            if self.status is None:
                return {}
            total = self.total_s
            t_bf = self._event_time("batch_formed")
            t_disp = self._event_time("dispatched")
        if t_disp is None:
            t_disp = total
        if t_bf is None:
            t_bf = t_disp
        return {"queue_wait_s": t_bf,
                "batch_wait_s": t_disp - t_bf,
                "device_s": total - t_disp,
                "total_s": total}

    def to_dict(self) -> dict:
        """JSON-native snapshot of the whole trace (the
        ``/debug/requests`` and flight-bundle form)."""
        with self._lock:
            events = [dict(e) for e in self._events]
            status = self.status
            total = self.total_s
        return {"rid": self.rid, "op": self.op, "tenant": self.tenant,
                "shape_class": self.shape_class,
                "deadline_s": self.deadline_s, "status": status,
                "total_s": total, "events": events,
                "phases": self.phases()}


class RequestTracer:
    """Mint + retention + accounting behind one lock (the storage
    layer of the request axis; the :mod:`veles.simd_tpu_torch.obs`
    facade owns the singleton and the enabled gate).

    ``registry`` is the shared :class:`~veles.simd_tpu_torch.obs.\
registry.MetricsRegistry` the terminal edges feed; ``decision`` is a
    ``record_decision``-compatible callable for SLO breach events;
    ``on_breach`` (optional) is called once per tenant breach
    crossing — the facade wires the flight recorder's budgeted
    auto-capture there."""

    def __init__(self, registry, decision=None, on_breach=None,
                 max_traces: int | None = None,
                 max_exemplars: int = DEFAULT_MAX_EXEMPLARS,
                 max_tenants: int = DEFAULT_MAX_TENANTS):
        if max_traces is None:
            max_traces = int(_env_float(MAX_TRACES_ENV,
                                        DEFAULT_MAX_TRACES))
        if max_traces < 1 or max_exemplars < 1 or max_tenants < 1:
            raise ValueError("request-trace bounds must be >= 1")
        self._registry = registry
        self._decision = decision
        self.on_breach = on_breach
        self._lock = threading.Lock()
        self._next_rid = 0
        self._started = 0
        self._finished_count = 0
        self._by_status: dict = {}
        self._recent = collections.deque(maxlen=int(max_traces))
        self._slowest: dict = {}            # op -> completed trace
        self._degraded = collections.deque(maxlen=int(max_exemplars))
        self._max_tenants = int(max_tenants)
        self._tenant_labels: set = set()
        # tenant -> {"target_ms", "hit_rate"} (explicit registrations;
        # env defaults fill unregistered tenants lazily)
        self._slo: dict = {}
        # tenant -> {"requests", "good", "deadline_misses", "breached"}
        self._accounts: dict = {}

    # -- mint + finish -------------------------------------------------------

    def start(self, op: str, tenant: str = "default", *,
              shape_class=None, deadline_s=None) -> RequestTrace:
        """Mint one trace with the next process-monotonic id."""
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._started += 1
        return RequestTrace(self, rid, op, tenant, shape_class,
                            deadline_s)

    def _tenant_label(self, tenant: str) -> str:
        """``tenant``, or ``"_other"`` past the cardinality bound."""
        with self._lock:
            if tenant in self._tenant_labels:
                return tenant
            if len(self._tenant_labels) < self._max_tenants:
                self._tenant_labels.add(tenant)
                return tenant
        return "_other"

    def _finished(self, trace: RequestTrace) -> None:
        """Terminal-edge accounting (called exactly once per trace by
        :meth:`RequestTrace.finish`)."""
        status = trace.status
        tlabel = self._tenant_label(trace.tenant)
        phases = trace.phases()
        # EVERY terminal outcome lands in the latency histogram with a
        # status label — shed and expired requests included, so the
        # tail the server refused is visible in the same distribution
        # as the tail it served (the survivorship-bias fix)
        self._registry.observe("serve.request_latency", trace.total_s,
                               op=trace.op, status=status)
        self._registry.count("serve_completed", op=trace.op,
                             status=status)
        if status == "expired":
            self._registry.count("serve_deadline_miss", op=trace.op,
                                 tenant=tlabel)
        for name in ("queue_wait", "batch_wait", "device", "total"):
            self._registry.observe("request." + name,
                                   phases[name + "_s"],
                                   op=trace.op, tenant=tlabel)
        degraded = status == "degraded"
        with self._lock:
            self._finished_count += 1
            self._by_status[status] = self._by_status.get(status, 0) + 1
            self._recent.append(trace)
            slow = self._slowest.get(trace.op)
            if slow is None or (trace.total_s or 0.0) \
                    > (slow.total_s or 0.0):
                self._slowest[trace.op] = trace
            if degraded:
                self._degraded.append(trace)
        self._slo_account(trace, tlabel)

    # -- SLO accounting ------------------------------------------------------

    def set_slo(self, tenant: str, target_ms: float,
                hit_rate: float = DEFAULT_SLO_HIT_RATE) -> dict:
        """Register ``tenant``'s SLO: answers within ``target_ms``
        (end-to-end, shed/expired count as misses) at ``hit_rate``.
        Returns the stored JSON-native target."""
        target_ms = float(target_ms)
        hit_rate = float(hit_rate)
        if target_ms <= 0:
            raise ValueError("target_ms must be positive")
        if not 0 < hit_rate < 1:
            raise ValueError("hit_rate must be in (0, 1)")
        slo = {"target_ms": target_ms, "hit_rate": hit_rate}
        with self._lock:
            self._slo[str(tenant)] = slo
            # a registered tenant always earns its own label — the
            # cardinality cap bounds UNregistered tenant churn, not
            # operator-declared SLOs
            self._tenant_labels.add(str(tenant))
        self._registry.gauge("slo_target_ms", target_ms,
                             tenant=str(tenant))
        return dict(slo)

    def _slo_for(self, tenant: str) -> dict | None:
        with self._lock:
            slo = self._slo.get(tenant)
        if slo is not None:
            return slo
        target_ms, hit_rate = env_slo_defaults()
        if target_ms is None:
            return None
        return {"target_ms": target_ms, "hit_rate": hit_rate}

    def _slo_account(self, trace: RequestTrace, tlabel: str) -> None:
        slo = self._slo_for(trace.tenant)
        if slo is None:
            return
        good = (trace.status in ("ok", "degraded")
                and trace.total_s * 1e3 <= slo["target_ms"])
        with self._lock:
            # accounts are keyed by the FOLDED label, so per-user
            # tenant churn under an env-default SLO stays bounded at
            # max_tenants + 1 entries ("_other" aggregates the
            # overflow) instead of growing with process lifetime
            acct = self._accounts.setdefault(
                tlabel, {"requests": 0, "good": 0,
                         "deadline_misses": 0, "breached": False})
            acct["requests"] += 1
            if good:
                acct["good"] += 1
            if trace.status == "expired":
                acct["deadline_misses"] += 1
            n, g = acct["requests"], acct["good"]
            observed = g / n
            budget = 1.0 - slo["hit_rate"]
            burn = (1.0 - observed) / budget if budget > 0 else 0.0
            breached = n >= _SLO_MIN_REQUESTS and burn > 1.0
            # crossing detection is a single read-modify-write under
            # THE lock: concurrent terminal traces must elect exactly
            # one winner per crossing (one breach event, one budgeted
            # flight bundle — not one per racing worker)
            crossed = breached != acct["breached"]
            acct["breached"] = breached
        self._registry.gauge("slo_hit_rate", observed, tenant=tlabel)
        self._registry.gauge("slo_burn_rate", burn, tenant=tlabel)
        if not (crossed and breached):
            return
        self._registry.count("slo_breach", tenant=tlabel)
        if self._decision is not None:
            self._decision("slo", "breach", tenant=tlabel,
                           target_ms=slo["target_ms"],
                           hit_rate_target=slo["hit_rate"],
                           observed=round(observed, 6),
                           burn_rate=round(burn, 3), requests=n)
        if self.on_breach is not None:
            try:    # budgeted flight-recorder capture; never raises
                self.on_breach(trace.tenant, burn)
            except Exception:  # noqa: BLE001
                pass

    # -- reads ---------------------------------------------------------------

    def slo_snapshot(self) -> dict:
        """Per-tenant SLO state: targets + live accounts + burn."""
        with self._lock:
            targets = {t: dict(s) for t, s in self._slo.items()}
            accounts = {t: dict(a) for t, a in self._accounts.items()}
        env_ms, env_rate = env_slo_defaults()
        out = {"targets": targets, "accounts": {},
               "env_default": ({"target_ms": env_ms,
                                "hit_rate": env_rate}
                               if env_ms is not None else None)}
        for tenant, acct in sorted(accounts.items()):
            slo = targets.get(tenant) or self._slo_for(tenant)
            n, g = acct["requests"], acct["good"]
            observed = g / n if n else None
            burn = None
            if slo is not None and observed is not None:
                budget = 1.0 - slo["hit_rate"]
                burn = round((1.0 - observed) / budget, 4) \
                    if budget > 0 else 0.0
            out["accounts"][tenant] = {
                **acct,
                "hit_rate_observed": (round(observed, 6)
                                      if observed is not None
                                      else None),
                "burn_rate": burn,
            }
        return out

    def summary(self) -> dict:
        """Compact JSON-native tally (embedded in ``obs.snapshot()``):
        counts only — full traces travel via :meth:`traces_snapshot`
        so a metrics snapshot stays small."""
        with self._lock:
            return {"started": self._started,
                    "finished": self._finished_count,
                    "open": self._started - self._finished_count,
                    "by_status": dict(sorted(self._by_status.items())),
                    "retained": len(self._recent),
                    "exemplar_slowest": len(self._slowest),
                    "exemplar_degraded": len(self._degraded)}

    def traces_snapshot(self, recent: int = 50) -> dict:
        """Full traces for the live endpoint and flight bundles: the
        last ``recent`` completed traces plus both exemplar families."""
        with self._lock:
            tail = list(self._recent)[-int(recent):]
            slowest = dict(self._slowest)
            degraded = list(self._degraded)
        return {
            "summary": self.summary(),
            "recent": [t.to_dict() for t in tail],
            "slowest_by_op": {op: t.to_dict()
                              for op, t in sorted(slowest.items())},
            "degraded": [t.to_dict() for t in degraded],
            "slo": self.slo_snapshot(),
        }

    def configure(self, max_traces: int | None = None,
                  max_exemplars: int | None = None) -> None:
        """Re-bound the retention rings (history is kept up to the new
        bound)."""
        with self._lock:
            if max_traces is not None:
                if int(max_traces) < 1:
                    raise ValueError("max_traces must be >= 1")
                self._recent = collections.deque(
                    self._recent, maxlen=int(max_traces))
            if max_exemplars is not None:
                if int(max_exemplars) < 1:
                    raise ValueError("max_exemplars must be >= 1")
                self._degraded = collections.deque(
                    self._degraded, maxlen=int(max_exemplars))

    def reset(self) -> None:
        """Clear retention, accounts, and tallies (ids keep rising —
        a reset must not mint duplicate rids)."""
        with self._lock:
            self._started = 0
            self._finished_count = 0
            self._by_status.clear()
            self._recent.clear()
            self._slowest.clear()
            self._degraded.clear()
            self._tenant_labels.clear()
            self._slo.clear()
            self._accounts.clear()
