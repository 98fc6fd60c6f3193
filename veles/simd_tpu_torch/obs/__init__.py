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
* the crash flight recorder (:mod:`.flightrec`), armed by the fault
  policy on retry exhaustion and by an exception escaping a top-level
  span.

The request, fleet, incident and HTTP axes are not ported yet (ROADMAP
Queue 1 items 5 and 6).

Contract with the compute layer: ops modules touch telemetry only
through :func:`record_decision`, :func:`count`, :func:`gauge`,
:func:`span`, :func:`instrumented_jit` and :func:`register_cache`, and
only at the Python dispatch layer.  Off by default; enable with
``VELES_SIMD_TELEMETRY=1`` or :func:`enable`.  While disabled every
helper is one flag check.

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

from veles.simd_tpu_torch.obs import compile as _compile
from veles.simd_tpu_torch.obs import export as _export
from veles.simd_tpu_torch.obs import flightrec as _flightrec
from veles.simd_tpu_torch.obs import journal as _journal
from veles.simd_tpu_torch.obs import spans as _spans_mod
from veles.simd_tpu_torch.obs.atomic import (
    atomic_write_text as _atomic_write)
from veles.simd_tpu_torch.obs.events import EventLog
from veles.simd_tpu_torch.obs.lru import LRUSet
from veles.simd_tpu_torch.obs.registry import MetricsRegistry
from veles.simd_tpu_torch.obs.resources import (InstrumentedJit,
                                                instrumented_jit,
                                                register_cache)
from veles.simd_tpu_torch.obs.spans import SpanTracer

# the facade function resources() shadows the submodule attribute
_resources = sys.modules["veles.simd_tpu_torch.obs.resources"]

__all__ = [
    "enable", "disable", "enabled", "configure",
    "count", "gauge", "observe", "record_decision", "span",
    "counter_value", "events", "snapshot", "reset",
    "to_json", "to_prometheus", "report", "save", "load",
    "save_trace", "trace_events",
    "journal_stats", "journal_cursor", "journal_tail",
    "install_compile_listeners",
    "instrumented_jit", "resources", "caches", "register_cache",
    "dump_debug_bundle",
    "MetricsRegistry", "EventLog", "SpanTracer", "InstrumentedJit",
    "LRUSet",
]

_registry = MetricsRegistry()
_events = EventLog()
_spans = SpanTracer(_registry.observe)
_spans.on_crash = _flightrec.maybe_record_crash
_enabled = os.environ.get("VELES_SIMD_TELEMETRY",
                          "0").strip().lower() in ("1", "true", "yes",
                                                   "on")
if _enabled:
    _resources.set_active(True)
    _compile.install()

# where the not-yet-ported request axis is queued
_REQUEST_AXIS = ("the request axis (max_traces, max_exemplars, "
                 "request_axis) is not ported yet: ROADMAP Queue 1 "
                 "item 5")
_FLEET_AXIS = ("the fleet trace (save_trace(fleet=...)) is not ported "
               "yet: ROADMAP Queue 1 item 6")


def enabled() -> bool:
    """Is telemetry currently recording?"""
    return _enabled


def enable(compile_listeners: bool = True) -> None:
    """Turn telemetry on (idempotent); ``compile_listeners`` also routes
    the port's compile events into the registry (:mod:`.compile`)."""
    global _enabled
    _enabled = True
    _resources.set_active(True)
    if compile_listeners:
        _compile.install()


def disable() -> None:
    """Stop recording.  Existing metrics/events are kept."""
    global _enabled
    _enabled = False
    _resources.set_active(False)


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
    the environment lookup).  ``max_traces``, ``max_exemplars`` and
    ``request_axis`` belong to the request axis, which is not ported
    yet: they raise ``NotImplementedError``."""
    global _events, _spans
    if (max_traces is not None or max_exemplars is not None
            or request_axis is not None):
        raise NotImplementedError(_REQUEST_AXIS)
    if max_events is not None:
        _events = EventLog(max_events)
    if max_spans is not None:
        _spans = SpanTracer(_registry.observe, max_spans)
        _spans.on_crash = _flightrec.maybe_record_crash
    if flight_dir is not None:
        _flightrec.configure_flight_dir(flight_dir or None)
    if journal_dir is not None:
        _journal.configure_dir(journal_dir or None)


def install_compile_listeners() -> bool:
    """Route the port's compile events into the registry (normally done
    by :func:`enable`).  Returns True on first installation."""
    return _compile.install()


def count(name: str, n: int = 1, **labels) -> None:
    """Increment counter ``name`` (no-op while disabled)."""
    if not _enabled:
        return
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
    no-op context while telemetry is off."""
    if not _enabled:
        return _spans_mod.NULL_SPAN
    return _spans.span(name, **attrs)


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


def events() -> list:
    """Oldest-first copy of the retained decision events."""
    return _events.events()


def snapshot() -> dict:
    """One JSON-native dict: counters, gauges, histograms (including
    the ``span.*`` latency distributions), events, drop counts, cache
    stats (:func:`caches`) and the enabled flag."""
    snap = _registry.snapshot()
    snap["events"] = _events.events()
    snap["events_dropped"] = _events.dropped
    snap["spans_dropped"] = _spans.dropped
    snap["resources"] = _resources.resources_snapshot()
    snap["caches"] = caches()
    snap["journal"] = _journal.stats()
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


def dump_debug_bundle(path: str | None = None,
                      reason: str = "explicit",
                      exc: BaseException | None = None) -> str:
    """Atomically write a flight-recorder debug bundle now; returns the
    written path (see :mod:`veles.simd_tpu_torch.obs.flightrec`)."""
    return _flightrec.dump_debug_bundle(path, reason, exc)


def reset() -> None:
    """Clear all metrics, events, spans and resource records; the
    enabled flag is untouched."""
    _registry.reset()
    _events.reset()
    _spans.reset()
    _resources.reset()


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
    """Atomically write the retained spans as Chrome trace-event JSON
    (one complete "X" event per span, per-thread tracks, the warmup/
    steady phase and the span's attributes under ``args``), loadable in
    Perfetto or ``chrome://tracing``; returns ``path``.  ``fleet=``
    (the JAX package's stitched fleet trace) is not ported yet and
    raises ``NotImplementedError``."""
    if fleet is not None:
        raise NotImplementedError(_FLEET_AXIS)
    return _atomic_write(
        path, _export.to_json(_spans.to_chrome_trace(), indent=None))


def trace_events() -> list:
    """The retained spans as Chrome trace events (the ``traceEvents``
    list :func:`save_trace` writes)."""
    return _spans.to_chrome_trace()["traceEvents"]
