"""veles.simd_tpu_torch.obs — runtime telemetry: *what was decided*.

The port's counterpart of ``veles.simd_tpu.obs``: the counters,
timing histograms, bounded decision-event log and host-side spans that
the dispatch layer reports into, over copies of the JAX package's
framework-free storage modules (:mod:`.registry`, :mod:`.events`,
:mod:`.spans`, :mod:`.lru`, :mod:`.atomic`, :mod:`.export`,
:mod:`.journal`), plus

* the resource axis (:mod:`.resources`): :func:`instrumented_jit`
  records each instrumented call's FLOPs, bytes and device peak per
  ``(op, route)`` (:func:`resources`), and every memoized cache
  registers with :func:`register_cache` (:func:`caches`);
* compile tracking (:mod:`.compile`): the kernel library's ``nvcc``
  builds and cache hits, and the pipelines' CUDA-graph captures, as the
  JAX package's ``compile.*`` counters;
* the history axis (:mod:`.journal`): with ``$VELES_SIMD_JOURNAL_DIR``
  set, every decision event is also appended to a durable JSONL
  journal, telemetry on or off;
* the request axis (:mod:`.requests`): every ``serve.Server.submit``
  mints a :func:`request_trace` carried across threads on the pending
  record; lifecycle edges build a causal chain whose phase
  decomposition (queue wait / batch wait / device) lands in bounded
  per-(op, tenant) histograms, with slowest-per-op and degraded
  exemplars retained and per-tenant SLO accounting (:func:`slo`);
* a live scrape endpoint (:mod:`.http`): ``/metrics``, ``/healthz``
  and ``/debug/requests`` over the standard library's ``http.server``,
  armed by ``serve.Server.start``;
* the crash flight recorder (:mod:`.flightrec`), armed by the fault
  policy on retry exhaustion, by an exception escaping a top-level
  span and by a tenant's first SLO breach;
* the fleet axis (:mod:`.timeseries`): bounded per-(replica, series)
  sample rings fed by the ``serve.cluster.ReplicaGroup`` collector
  (:func:`fleet_record`), read back as the typed :func:`signals`
  bundle (the autoscaler's input, ``/signals`` on the endpoint), and
  :func:`stitch_fleet_trace` / ``save_trace(path, fleet=ticket)`` for
  a failed-over request's cross-replica trace;
* the incident engine (:mod:`.incidents`): typed open→closed incidents
  over the signals (:func:`incidents_snapshot`, ``/incidents``), and
  the control axis's state (:func:`scaler_snapshot`, ``/scaler``).

Contract with the compute layer: ops modules touch telemetry only
through :func:`record_decision`, :func:`count`, :func:`gauge`,
:func:`span`, :func:`instrumented_jit` and :func:`register_cache`, and
only at the Python dispatch layer.  Off by default; enable with
``VELES_SIMD_TELEMETRY=1`` or :func:`enable`.  While disabled every
helper is one flag check.

Span capture (the port's own facade names, not in the JAX package's
``__all__``): :func:`start_capture` arms a mode in which :func:`span`
and :func:`count` record into the span store and, with telemetry off,
nothing else of telemetry runs (no decision, histogram, resource
record, request trace or profiler bridge); with telemetry on, spans
record as they always do.  A count taken inside a span while a capture
is armed adds its increment to that span's attributes under its name,
so that the span's record carries it; ``start_capture(counts=)``
limits this to the counts named.
:func:`stop_capture` disarms it and :func:`captured` reads the store
back (``obs.spans.Capture``: ``CaptureRecord`` rows oldest first and
the drop count).  The store is sized, and emptied, by
``configure(max_spans=)`` alone.  A span record holds its name, the raw
``time.perf_counter_ns`` stamps of its start and end, its parent's
name, its attributes and the call id shared by everything inside one
outermost span (a count outside every span belongs to no call and is
dropped).
The store is the one :func:`enable`'s spans use: a preallocated ring
that counts what it overwrites.  The spans and counts the dispatch
layer places, by layer: ``convolve.dispatch``,
``wavelet_transform.dispatch`` and ``stft.dispatch`` (a call's top
span), ``fault.attempt`` (each attempt of ``runtime.faults.guarded``,
attribute ``site``), ``routing.select`` (a route choice, attribute
``family``), ``convolve.os_route``, ``wavelet_apply.dispatch`` and
``stft.route`` (a route's own host work and launch; ``stft.route``
carries ``scratch_bytes``, the bytes of the device intermediates its
route writes besides the output) and the count
``wavelet_extend_bytes`` (the bytes ``ops.wavelet``'s boundary
extension writes on the device).

Usage::

    from veles.simd_tpu_torch import obs
    obs.enable()
    convolve(x, h)              # decisions recorded as they run
    print(obs.report())         # counters, span histograms, events
    obs.resources()             # per-(op, route) FLOPs/bytes/peak
    obs.save_trace("trace.json")   # open in Perfetto
"""

from __future__ import annotations

import os
import sys
import time

from veles.simd_tpu_torch.obs import compile as _compile
from veles.simd_tpu_torch.obs import export as _export
from veles.simd_tpu_torch.obs import flightrec as _flightrec
from veles.simd_tpu_torch.obs import incidents as _incidents
from veles.simd_tpu_torch.obs import journal as _journal
from veles.simd_tpu_torch.obs import requests as _requests_mod
from veles.simd_tpu_torch.obs import spans as _spans_mod
from veles.simd_tpu_torch.obs import timeseries as _timeseries
from veles.simd_tpu_torch.obs.atomic import (
    atomic_write_text as _atomic_write)
from veles.simd_tpu_torch.obs.events import EventLog
from veles.simd_tpu_torch.obs.lru import LRUSet
from veles.simd_tpu_torch.obs.registry import MetricsRegistry
from veles.simd_tpu_torch.obs.requests import RequestTrace, RequestTracer
from veles.simd_tpu_torch.obs.resources import (InstrumentedJit,
                                                instrumented_jit,
                                                register_cache)
from veles.simd_tpu_torch.obs.spans import SpanTracer
from veles.simd_tpu_torch.obs.timeseries import (FleetSeries,
                                                 FleetSignals,
                                                 stitch_fleet_trace)

# the facade function resources() shadows the submodule attribute
_resources = sys.modules["veles.simd_tpu_torch.obs.resources"]

__all__ = [
    "enable", "disable", "enabled", "configure",
    "count", "gauge", "observe", "record_decision", "span",
    "counter_value", "quantiles", "events", "snapshot", "reset",
    "to_json", "to_prometheus", "report", "save", "load",
    "save_trace", "trace_events",
    "request_trace", "slo", "slo_snapshot", "request_snapshot",
    "request_summary",
    "signals", "fleet_record", "fleet_series", "stitch_fleet_trace",
    "journal_stats", "journal_cursor", "journal_tail",
    "incidents_snapshot", "scaler_snapshot",
    "install_compile_listeners",
    "instrumented_jit", "resources", "caches", "register_cache",
    "dump_debug_bundle",
    "MetricsRegistry", "EventLog", "SpanTracer", "InstrumentedJit",
    "RequestTrace", "RequestTracer", "LRUSet",
    "FleetSeries", "FleetSignals",
]

_registry = MetricsRegistry()
_fleet = _timeseries.FleetSeries()
_events = EventLog()
_spans = SpanTracer(_registry.observe)
_spans.on_crash = _flightrec.maybe_record_crash


def _requests_decision(op: str, decision: str, **fields) -> None:
    """Decision sink for the request tracer (SLO breach events), bound
    to the current event log through the module global, so
    ``configure(max_events=...)`` swaps are honored."""
    if _journal.armed():
        _journal.emit_decision(op, decision, fields)
    _events.record(op, decision, **fields)
    _registry.count("decisions", op=op, decision=decision)


def _requests_breach(tenant: str, burn: float) -> None:
    """Flight-recorder arm for SLO breaches: one budgeted bundle per
    crossing, with the request exemplars embedded."""
    _flightrec.maybe_record(f"slo_breach:{tenant}", None)


_requests = RequestTracer(_registry, decision=_requests_decision,
                          on_breach=_requests_breach)
# request tracing armed while telemetry is on?  configure(
# request_axis=False) disarms the tracer alone
_request_axis = True
_enabled = os.environ.get("VELES_SIMD_TELEMETRY",
                          "0").strip().lower() in ("1", "true", "yes",
                                                   "on")
# a capture armed (start_capture) and the counts it folds into spans
# (None: every count); telemetry on or a capture armed, the one flag
# span() and count() check
_capturing = False
_capture_counts = None
_live = _enabled
if _enabled:
    _resources.set_active(True)
    _compile.install()


def enabled() -> bool:
    """Is telemetry currently recording?"""
    return _enabled


def enable(compile_listeners: bool = True) -> None:
    """Turn telemetry on (idempotent); ``compile_listeners`` also routes
    the port's compile events into the registry (:mod:`.compile`)."""
    global _enabled, _live
    _enabled = _live = True
    _resources.set_active(True)
    if compile_listeners:
        _compile.install()


def disable() -> None:
    """Stop recording.  Existing metrics/events are kept."""
    global _enabled, _live
    _enabled = False
    _live = _capturing
    _resources.set_active(False)


def start_capture(counts=None) -> None:
    """Arm span capture (module docstring) over the span store as it
    stands; size and empty it first with ``configure(max_spans=)``.
    ``counts`` names the counts folded into their spans (None: every
    count), so that a reader pays only for the counts it reads."""
    global _capturing, _capture_counts, _live
    _capture_counts = None if counts is None else frozenset(counts)
    _capturing = _live = True


def stop_capture() -> None:
    """Disarm span capture; the records stay for :func:`captured`."""
    global _capturing, _live
    _capturing = False
    _live = _enabled


def captured() -> _spans_mod.Capture:
    """The span store's records, oldest first, and its drop count."""
    return _spans.captured()


def configure(max_events: int | None = None,
              max_spans: int | None = None,
              flight_dir: str | None = None,
              max_traces: int | None = None,
              max_exemplars: int | None = None,
              request_axis: bool | None = None,
              journal_dir: str | None = None) -> None:
    """Adjust telemetry limits (the JAX signature).  ``max_events``
    replaces the decision log with a fresh bound (history is cleared);
    ``max_spans`` does the same for the span trace buffer;
    ``flight_dir`` overrides ``$VELES_SIMD_FLIGHT_DIR`` as the
    crash-bundle destination and ``journal_dir``
    ``$VELES_SIMD_JOURNAL_DIR`` as the journal pack (``""`` restores
    the environment lookup).  ``max_traces`` / ``max_exemplars``
    re-bound the request-axis retention rings (:mod:`.requests`; the
    trace default also reads ``$VELES_SIMD_OBS_MAX_TRACES``).
    ``request_axis=False`` disarms request tracing (every
    :func:`request_trace` returns the shared null trace) while
    counters, gauges and spans keep recording; the terminal request
    metrics (``serve.request_latency{op, status}``,
    ``serve_completed``, ``serve_deadline_miss``) ride the trace's
    terminal edge, so disarming the axis pauses them too."""
    global _events, _spans, _request_axis
    if max_events is not None:
        _events = EventLog(max_events)
    if max_spans is not None:
        _spans = SpanTracer(_registry.observe, max_spans)
        _spans.on_crash = _flightrec.maybe_record_crash
    if flight_dir is not None:
        _flightrec.configure_flight_dir(flight_dir or None)
    if max_traces is not None or max_exemplars is not None:
        _requests.configure(max_traces=max_traces,
                            max_exemplars=max_exemplars)
    if request_axis is not None:
        _request_axis = bool(request_axis)
    if journal_dir is not None:
        _journal.configure_dir(journal_dir or None)


def install_compile_listeners() -> bool:
    """Route the port's compile events into the registry (normally done
    by :func:`enable`).  Returns True on first installation."""
    return _compile.install()


def compile_event(event: str) -> None:
    """One of the port's compile events (``obs.compile.EVENT_COUNTERS``),
    counted once the compile listeners are installed.  With
    :func:`compile_timer`, the port's own facade names (not in the JAX
    package's ``__all__``): the compile sites of ``ops/`` and
    ``pipeline/`` announce themselves through them."""
    _compile.record_event(event)


def compile_timer(event: str):
    """``with obs.compile_timer(event) as t:`` times a compile (the
    nvcc build, a graph capture) and records it as the duration
    ``event`` (``obs.compile.DURATION_METRICS``); ``t.seconds`` holds
    the time after the block."""
    return _compile.timed(event)


def count(name: str, n: int = 1, **labels) -> None:
    """Increment counter ``name`` (no-op while disabled); while a
    capture is armed, also add ``n`` to the attribute ``name`` of the
    span open on this thread."""
    if not _live:
        return
    if _capturing and (_capture_counts is None
                       or name in _capture_counts):
        _spans.count_in_span(name, n)
    if _enabled:
        _registry.count(name, n, **labels)


def gauge(name: str, value: float, **labels) -> None:
    """Set gauge ``name`` to ``value`` (no-op while disabled)."""
    if not _enabled:
        return
    _registry.gauge(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    """Record one timing-histogram sample (no-op while disabled)."""
    if not _enabled:
        return
    _registry.observe(name, value, **labels)


def span(name: str, **attrs):
    """Time a host-side dispatch scope (context manager); the shared
    no-op context while telemetry and capture are off, a store-only
    span while only capture is armed."""
    if not _live:
        return _spans_mod.NULL_SPAN
    if _enabled:
        return _spans.span(name, **attrs)
    return _spans.capture_span(name, attrs)


def request_trace(op: str, tenant: str = "default", *,
                  shape_class=None, deadline_s=None):
    """Mint one request-axis trace (:class:`~veles.simd_tpu_torch.obs.\
requests.RequestTrace`): the serving layer calls this per
    ``Server.submit`` and carries the trace on the pending record
    across threads; every lifecycle edge appends via
    ``trace.event(...)`` and exactly one terminal ``trace.finish
    (status)`` records the phase histograms, the
    ``serve.request_latency{op, status}`` sample, SLO accounting and
    exemplar retention.  While telemetry is off (or the request axis
    alone is disarmed, ``configure(request_axis=False)``) this returns
    the shared ``NULL_REQUEST`` after one flag check."""
    if not _enabled or not _request_axis:
        return _requests_mod.NULL_REQUEST
    return _requests.start(op, tenant, shape_class=shape_class,
                           deadline_s=deadline_s)


def slo(tenant: str, target_ms: float,
        hit_rate: float = _requests_mod.DEFAULT_SLO_HIT_RATE) -> dict:
    """Register ``tenant``'s SLO: answered within ``target_ms``
    end-to-end at ``hit_rate`` (shed/expired/errored requests are
    misses).  Terminal request traces update the tenant's account and
    export ``slo_hit_rate`` / ``slo_burn_rate`` gauges; the first
    crossing into burn > 1 records an ``slo``/``breach`` decision
    event and arms a flight-recorder bundle.  Unregistered tenants
    fall back to ``$VELES_SIMD_SLO_MS`` / ``$VELES_SIMD_SLO_HIT_RATE``
    when set."""
    return _requests.set_slo(tenant, target_ms, hit_rate)


def slo_snapshot() -> dict:
    """Per-tenant SLO state: registered targets, live accounts
    (requests/good/deadline misses), observed hit rate, burn rate."""
    return _requests.slo_snapshot()


def request_summary() -> dict:
    """Compact request-axis tally (started/finished/open, per-status
    counts, retention sizes), the form embedded in :func:`snapshot`."""
    return _requests.summary()


def request_snapshot(recent: int = 50) -> dict:
    """The full request axis for the live endpoint and flight bundles:
    the last ``recent`` completed traces, slowest-per-op and degraded
    exemplars (full causal event chains), and the SLO accounts."""
    return _requests.traces_snapshot(recent)


def record_decision(op: str, decision: str, **fields) -> None:
    """Log one dispatch decision (no-op while disabled) and bump the
    ``decisions{op, decision}`` counter.  With the journal armed
    (``$VELES_SIMD_JOURNAL_DIR`` / ``configure(journal_dir=...)``) the
    event is also appended to it, telemetry on or off."""
    if _journal.armed():
        _journal.emit_decision(op, decision, fields)
    if not _enabled:
        return
    _events.record(op, decision, **fields)
    _registry.count("decisions", op=op, decision=decision)


def counter_value(name: str, **labels) -> int:
    """Current value of one counter (0 if never incremented)."""
    return _registry.counter_value(name, **labels)


def quantiles(name: str, qs=(0.5, 0.95, 0.99), **labels):
    """Quantile estimates for one live histogram, or None if it has
    never been observed: ``{"p50": s, "p95": s, "p99": s}`` with
    Prometheus ``histogram_quantile`` semantics (upper bucket bound,
    :func:`veles.simd_tpu_torch.obs.export.histogram_quantile`).
    ``labels`` must match the recorded label set exactly (a span
    histogram carries ``phase="warmup"|"steady"``)."""
    want = {str(k): str(v) for k, v in labels.items()}
    for h in _registry.snapshot()["histograms"]:
        if h["name"] == name and h["labels"] == want:
            return _export.histogram_quantiles(h, qs)
    return None


def events() -> list:
    """Oldest-first copy of the retained decision events."""
    return _events.events()


def snapshot() -> dict:
    """One JSON-native dict: counters, gauges, histograms (including
    the ``span.*`` latency distributions), events, drop counts, cache
    stats (:func:`caches`), the request-axis summary and SLO accounts,
    the fleet store, the journal's stats, the incident engine, the
    scaler and the enabled flag."""
    snap = _registry.snapshot()
    snap["events"] = _events.events()
    snap["events_dropped"] = _events.dropped
    snap["spans_dropped"] = _spans.dropped
    snap["resources"] = _resources.resources_snapshot()
    snap["caches"] = caches()
    snap["requests"] = _requests.summary()
    snap["slo"] = _requests.slo_snapshot()
    snap["fleet"] = _fleet.snapshot()
    snap["journal"] = _journal.stats()
    snap["incidents"] = _incidents.snapshot()
    snap["scaler"] = scaler_snapshot()
    snap["enabled"] = _enabled
    return snap


def to_prometheus(snap: dict | None = None) -> str:
    """A snapshot in the Prometheus text format
    (:func:`veles.simd_tpu_torch.obs.export.to_prometheus`)."""
    return _export.to_prometheus(snapshot() if snap is None else snap)


def report(snap: dict | None = None, max_events: int = 20) -> str:
    """Human-readable table of a snapshot (newest events last)."""
    snap = snapshot() if snap is None else snap
    lines = ["== veles.simd_tpu_torch telemetry =="]
    if snap["counters"]:
        lines += ["", "counters:"]
        for c in snap["counters"]:
            labels = ",".join(f"{k}={v}" for k, v in c["labels"].items())
            lines.append(f"  {c['name']}{{{labels}}} {c['value']}")
    if snap["histograms"]:
        lines += ["", "histograms (seconds):"]
        for h in snap["histograms"]:
            labels = ",".join(f"{k}={v}" for k, v in h["labels"].items())
            mean = h["sum"] / h["count"] if h["count"] else 0.0
            lines.append(f"  {h['name']}{{{labels}}} n={h['count']} "
                         f"mean={mean:.3e}")
    evs = snap["events"]
    if evs:
        lines += ["", f"decision events (last {min(max_events, len(evs))}"
                  f" of {len(evs)} retained, {snap['events_dropped']} "
                  "dropped):"]
        for e in evs[-max_events:]:
            extras = ", ".join(
                f"{k}={v}" for k, v in e.items()
                if k not in ("seq", "op", "decision") and v is not None)
            lines.append(f"  #{e['seq']:<6d} {e['op']:<24s} -> "
                         f"{e['decision']:<18s} {extras}")
    if len(lines) == 1:
        lines.append("(no telemetry recorded)")
    return "\n".join(lines)


def resources() -> list:
    """Per-``(op, route)`` records of :func:`instrumented_jit`: FLOPs,
    bytes, arithmetic intensity, the attainable share of the fp32
    roofline, argument/output bytes and the device peak (see
    :mod:`veles.simd_tpu_torch.obs.resources`)."""
    return _resources.resources_snapshot()


def caches() -> dict:
    """``{name: stats}`` for every registered cache, JSON-native
    (:func:`register_cache`)."""
    return _resources.caches_snapshot()


def fleet_series() -> _timeseries.FleetSeries:
    """The live fleet store: bounded per-(replica, series) sample
    rings.  The :class:`veles.simd_tpu_torch.serve.cluster.ReplicaGroup`
    collector thread writes it via :func:`fleet_record`; read it through
    :func:`signals` (the typed contract) or this handle (tests,
    tooling)."""
    return _fleet


def fleet_record(replica: str, series: str, value: float,
                 t_s: float) -> None:
    """Record one fleet-axis sample (no-op while disabled) — the
    collector's write funnel: ``(replica, series)`` names the ring,
    ``t_s`` is the sweep's shared monotonic stamp."""
    if not _enabled:
        return
    _fleet.record(replica, series, value, t_s)


def signals() -> _timeseries.FleetSignals:
    """One consistent read of the fleet axis: the typed
    :class:`~veles.simd_tpu_torch.obs.timeseries.FleetSignals` bundle
    (slo burn and velocity, queue depths, breaker open/flap counts,
    goodput per shape class, per-replica health/staleness, the open
    incidents, journal health and the scaler's summary) — the
    autoscaler's input contract, also served as ``/signals`` on the
    scrape endpoint.  Built from the fleet store, the metrics registry
    and the SLO accounts; cheap enough to poll on the collector
    cadence."""
    now = time.monotonic()
    return _timeseries.FleetSignals.from_sources(
        _fleet, _registry.snapshot(), _requests.slo_snapshot(),
        now=now, incidents=_incidents.open_incidents(),
        journal=_journal.stats(now), scaler=_scaler_summary())


def journal_stats() -> dict:
    """History-axis health: armed flag, pack dir, record/drop/rotation
    counts and ``lag_s`` since the last durable record."""
    return _journal.stats()


def journal_cursor() -> dict | None:
    """Where the durable journal is now (file/offset/record count;
    None while disarmed)."""
    return _journal.cursor()


def journal_tail(n: int = _journal.TAIL_KEEP) -> list:
    """The last ``n`` journal records from the in-memory tail (empty
    while disarmed)."""
    return _journal.tail(n)


def incidents_snapshot() -> dict:
    """The incident engine's JSON-native state — the ``/incidents``
    route body (:mod:`veles.simd_tpu_torch.obs.incidents`): schema
    stamp, tick count, open/closed tallies and the typed incident
    records."""
    return _incidents.snapshot()


# mirrored from veles.simd_tpu_torch.serve.scaler.SCHEMA: obs imports
# no serve module, so the disarmed /scaler shell stamps this literal
_SCALER_SCHEMA = "veles-simd-scaler-v1"


def _scaler_module():
    """The serve-layer scaler module if something already imported it
    — obs never imports serve, so the control axis is read through
    ``sys.modules`` or not at all."""
    return sys.modules.get("veles.simd_tpu_torch.serve.scaler")


def scaler_snapshot() -> dict:
    """The control axis — the ``/scaler`` route body: the registered
    :class:`veles.simd_tpu_torch.serve.scaler.ScalerEngine`'s
    schema-stamped state (tick count, streaks, cooldown, bounds, recent
    decisions), or the disarmed shell when no scaler runs here."""
    mod = _scaler_module()
    if mod is not None:
        try:
            return mod.snapshot()
        except Exception:  # noqa: BLE001 — a wedged engine must not
            pass  # take down the scrape endpoint
    return {"schema": _SCALER_SCHEMA, "armed": False, "running": False,
            "ticks": 0, "actions": {}, "noops": {},
            "last_action": None, "decisions": []}


def _scaler_summary() -> dict:
    """The compact control-axis summary embedded in :func:`signals`."""
    mod = _scaler_module()
    if mod is not None:
        try:
            return mod.summary()
        except Exception:  # noqa: BLE001
            pass
    return {"armed": False, "running": False, "ticks": 0,
            "actions": {}, "last_action": None}


def dump_debug_bundle(path: str | None = None,
                      reason: str = "explicit",
                      exc: BaseException | None = None) -> str:
    """Atomically write a flight-recorder debug bundle now; returns the
    written path (see :mod:`veles.simd_tpu_torch.obs.flightrec`)."""
    return _flightrec.dump_debug_bundle(path, reason, exc)


def reset() -> None:
    """Clear all metrics, events, spans, request traces and resource
    records; the enabled flag is untouched (request ids keep rising, a
    reset never mints duplicate rids)."""
    _registry.reset()
    _events.reset()
    _spans.reset()
    _resources.reset()
    _requests.reset()
    _fleet.reset()


def to_json(snap: dict | None = None, indent: int | None = 2) -> str:
    return _export.to_json(snapshot() if snap is None else snap, indent)


def save(path: str, snap: dict | None = None) -> str:
    """Atomically write a JSON snapshot to ``path`` (read back with
    :func:`load`); returns ``path``."""
    return _atomic_write(path, to_json(snap if snap is not None
                                       else snapshot()))


def load(path: str) -> dict:
    """Read a snapshot written by :func:`save`."""
    with open(path) as f:
        return _export.from_json(f.read())


def save_trace(path: str, fleet=None) -> str:
    """Atomically write Chrome trace-event JSON, loadable in Perfetto or
    ``chrome://tracing``; returns ``path``.  Default: the retained
    spans (one complete "X" event per span, per-thread tracks, the
    warmup/steady phase and the span's attributes under ``args``).
    With ``fleet=`` (a failed-over
    :class:`~veles.simd_tpu_torch.serve.cluster.RouterTicket`, or a
    dict already stitched by :func:`stitch_fleet_trace`): the
    cross-replica fleet trace instead, every attempt on its own track
    with the failover hops and carried deadlines."""
    if fleet is not None:
        stitched = fleet if isinstance(fleet, dict) \
            else _timeseries.stitch_fleet_trace(fleet)
        return _atomic_write(
            path, _export.to_json(stitched, indent=None))
    return _atomic_write(
        path, _export.to_json(_spans.to_chrome_trace(), indent=None))


def trace_events() -> list:
    """The retained spans as Chrome trace events (the ``traceEvents``
    list :func:`save_trace` writes)."""
    return _spans.to_chrome_trace()["traceEvents"]
