"""veles.simd_tpu_torch.obs — runtime telemetry: *what was decided*.

The port's slim counterpart of ``veles.simd_tpu.obs``: the counters,
timing histograms, bounded decision-event log and host-side spans that
the dispatch layer reports into, over copies of the JAX package's
framework-free storage modules (:mod:`.registry`, :mod:`.events`,
:mod:`.spans`, :mod:`.lru`, :mod:`.atomic`, :mod:`.export`), the
cache introspection of its resource axis (:func:`register_cache`,
:func:`caches`) and the crash flight recorder (:mod:`.flightrec`,
which the fault policy arms on retry exhaustion).  The rest of the
resource axis and the compile, request, journal, time-series,
incident and HTTP axes are not ported yet.

Contract with the compute layer: ops modules touch telemetry only
through :func:`record_decision`, :func:`count`, :func:`gauge` and
:func:`span`, and only at the Python dispatch layer.  Off by default;
enable with ``VELES_SIMD_TELEMETRY=1`` or :func:`enable`.  While
disabled every helper is one flag check.

Usage::

    from veles.simd_tpu_torch import obs
    obs.enable()
    convolve(x, h)              # decisions recorded as they run
    print(obs.report())         # counters, span histograms, events
"""

from __future__ import annotations

import os
import threading

from veles.simd_tpu_torch.obs import export as _export
from veles.simd_tpu_torch.obs import spans as _spans_mod
from veles.simd_tpu_torch.obs.events import EventLog
from veles.simd_tpu_torch.obs.lru import LRUSet
from veles.simd_tpu_torch.obs.registry import MetricsRegistry
from veles.simd_tpu_torch.obs.spans import SpanTracer

__all__ = [
    "enable", "disable", "enabled", "count", "gauge", "record_decision",
    "span", "counter_value", "events", "snapshot", "report",
    "to_prometheus", "reset",
    "register_cache", "caches",
    "MetricsRegistry", "EventLog", "SpanTracer", "LRUSet",
]

_registry = MetricsRegistry()
_events = EventLog()
_spans = SpanTracer(_registry.observe)
_enabled = os.environ.get("VELES_SIMD_TELEMETRY",
                          "0").strip().lower() in ("1", "true", "yes",
                                                   "on")


def enabled() -> bool:
    """Is telemetry currently recording?"""
    return _enabled


def enable() -> None:
    """Turn telemetry on (idempotent)."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop recording.  Existing metrics/events are kept."""
    global _enabled
    _enabled = False


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


def span(name: str, **attrs):
    """Time a host-side dispatch scope (context manager); the shared
    no-op context while telemetry is off."""
    if not _enabled:
        return _spans_mod.NULL_SPAN
    return _spans.span(name, **attrs)


def record_decision(op: str, decision: str, **fields) -> None:
    """Log one dispatch decision (no-op while disabled) and bump the
    ``decisions{op, decision}`` counter."""
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
    snap["caches"] = caches()
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


_cache_lock = threading.Lock()
_cache_providers: dict = {}


def _jsonify(value):
    """Deep-convert ``value`` to JSON-native structures (tuples become
    lists, dict keys strings, other leaves their ``repr``)."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): _jsonify(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        seq = sorted(value, key=repr) if isinstance(
            value, (set, frozenset)) else value
        return [_jsonify(v) for v in seq]
    return repr(value)


def register_cache(name: str, provider) -> None:
    """Register (or replace) a cache snapshot provider: a zero-arg
    callable returning ``{size, capacity, hits, misses, evictions}``
    (extra keys ride along), so :func:`caches` is the one place to see
    every memoized cache of the library."""
    with _cache_lock:
        _cache_providers[str(name)] = provider


def caches() -> dict:
    """``{name: stats}`` for every registered cache, JSON-native.  A
    provider that raises reports its error instead of failing the
    snapshot; a ``maxsize`` key also shows as ``capacity``."""
    with _cache_lock:
        providers = dict(_cache_providers)
    out = {}
    for name, provider in sorted(providers.items()):
        try:
            stats = dict(provider())
        except Exception as e:  # noqa: BLE001
            stats = {"error": repr(e)}
        if "capacity" not in stats and "maxsize" in stats:
            stats["capacity"] = stats["maxsize"]
        out[name] = _jsonify(stats)
    return out


def reset() -> None:
    """Clear all metrics, events and spans; the enabled flag is
    untouched."""
    _registry.reset()
    _events.reset()
    _spans.reset()
