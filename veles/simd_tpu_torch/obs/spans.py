"""Host-side dispatch spans: the *time axis* of obs.

Copied from ``veles.simd_tpu.obs.spans``, with ``torch.profiler``'s
``record_function`` in place of ``jax.profiler.TraceAnnotation``.  A
span brackets one region of Python dispatch code::

    with obs.span("convolve.dispatch", algo="overlap_save"):
        ... pick a route, launch the kernels ...

and on exit:

* feeds the registry's ``span.<name>`` latency histogram, tagged
  ``phase="warmup"`` for the first completion per (name, attrs) class
  (where a kernel's first-use build lands) and ``phase="steady"``
  afterwards;
* lands in a bounded ring (``max_spans``, overflow counted) exported as
  Chrome trace-event JSON (``obs.save_trace(path)``) that loads
  directly in Perfetto / ``chrome://tracing``;
* while a :func:`veles.simd_tpu_torch.utils.profiler.trace` capture is
  live (:func:`set_xla_trace_active`; the name is the JAX package's),
  also opens a ``torch.profiler.record_function`` of the same name, so
  the dispatch names appear in the profiler's timeline;
* when an exception escapes a top-level span, calls the tracer's
  ``on_crash`` hook (the flight recorder's, armed by the obs facade).

The clock is the host's: CUDA launches are asynchronous, so a span
around a launch measures the enqueue, not the kernel — device time
comes from :mod:`veles.simd_tpu_torch.utils.benchmark`.

Attributes travel only into the trace event's ``args`` — never into
histogram labels — so a caller can tag spans with shapes or routes
without blowing up metric cardinality.

Cost discipline: telemetry OFF, ``obs.span(...)`` is one module-global
check returning a shared no-op context manager; telemetry ON, two
``perf_counter_ns`` reads plus one locked append and one locked
histogram update per span.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time

__all__ = [
    "Span", "SpanTracer", "NULL_SPAN", "DEFAULT_MAX_SPANS",
    "set_xla_trace_active", "xla_trace_active",
]

DEFAULT_MAX_SPANS = 32768

# armed by utils.profiler.trace (and tests); checked per span enter
_XLA_TRACE_ACTIVE = False


def set_xla_trace_active(active: bool) -> None:
    """Arm/disarm the ``torch.profiler.record_function`` bridge.  While
    armed, every enabled span also opens a ``record_function`` scope so
    the span names show up in the profiler's timeline;
    ``utils.profiler.trace`` arms it for the duration of a capture.
    (The name is the JAX package's, whose bridge is XLA's.)"""
    global _XLA_TRACE_ACTIVE
    _XLA_TRACE_ACTIVE = bool(active)


def xla_trace_active() -> bool:
    """Is the ``record_function`` bridge currently armed?"""
    return _XLA_TRACE_ACTIVE


class _NullSpan:
    """Shared do-nothing context manager returned while telemetry is
    off — the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return "NULL_SPAN"


NULL_SPAN = _NullSpan()


class Span:
    """One live span (context manager).  Created by
    :meth:`SpanTracer.span`; not constructed directly."""

    __slots__ = ("_tracer", "name", "attrs", "_start_ns", "_ann",
                 "_parent")

    def __init__(self, tracer: "SpanTracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._start_ns = 0
        self._ann = None
        self._parent = None

    def __enter__(self):
        stack = self._tracer._stack()
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        if _XLA_TRACE_ACTIVE and "torch" in sys.modules:
            try:  # best-effort: a failed bridge must not fail dispatch
                import torch

                self._ann = torch.profiler.record_function(self.name)
                self._ann.__enter__()
            except Exception:  # noqa: BLE001
                self._ann = None
        # the clock read is LAST so bridge setup never inflates the span
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end_ns = time.perf_counter_ns()
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:  # noqa: BLE001
                pass
            self._ann = None
        stack = self._tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        self._tracer._finish(self.name, self._start_ns, end_ns,
                             threading.get_ident(), self._parent,
                             self.attrs)
        if exc_type is not None and self._parent is None:
            # an exception escaping a TOP-LEVEL dispatch span is the
            # flight recorder's trigger (obs/flightrec.py); the hook is
            # best-effort and must never mask the unwinding exception
            hook = self._tracer.on_crash
            if hook is not None:
                try:
                    hook(exc_type, exc)
                except Exception:  # noqa: BLE001
                    pass
        return False


class SpanTracer:
    """Span storage + histogram feed behind one lock.

    ``observe`` is a ``registry.observe``-compatible callable; each
    completed span calls ``observe("span." + name, seconds,
    phase=...)``.  Completed spans are retained in a bounded ring
    (``max_spans``; overflow counted in :attr:`dropped`) as raw tuples,
    rendered to Chrome trace events on export.
    """

    def __init__(self, observe, max_spans: int = DEFAULT_MAX_SPANS):
        max_spans = int(max_spans)
        if max_spans < 1:
            raise ValueError("max_spans must be >= 1")
        self.max_spans = max_spans
        self._observe = observe
        self._lock = threading.Lock()
        # (name, start_ns, dur_ns, tid, phase, parent, attrs)
        self._spans = collections.deque(maxlen=max_spans)
        self._dropped = 0
        self._warmed: set[tuple] = set()
        self._tls = threading.local()
        self._epoch_ns = time.perf_counter_ns()
        # called as on_crash(exc_type, exc) when an exception escapes a
        # top-level span; armed by the obs facade with the flight
        # recorder's hook (None = one attribute check per crash)
        self.on_crash = None

    def span(self, name: str, **attrs) -> Span:
        return Span(self, str(name), attrs)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _finish(self, name, start_ns, end_ns, tid, parent, attrs):
        dur_ns = max(0, end_ns - start_ns)
        # warmup is per (name, attrs) class: a different route through
        # the same span builds its own kernels and deserves its own
        # warmup mark, not a mislabel into steady-state
        warm_key = (name, tuple(sorted(
            (k, str(v)) for k, v in attrs.items())))
        with self._lock:
            if warm_key in self._warmed:
                phase = "steady"
            else:
                self._warmed.add(warm_key)
                phase = "warmup"
            if len(self._spans) == self.max_spans:
                self._dropped += 1
            self._spans.append((name, start_ns, dur_ns, tid, phase,
                                parent, attrs))
        # registry has its own lock; never observe under ours
        self._observe("span." + name, dur_ns * 1e-9, phase=phase)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def reset(self) -> None:
        """Clear retained spans, the drop count, and the warmup
        marks."""
        with self._lock:
            self._spans.clear()
            self._dropped = 0
            self._warmed.clear()

    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (the ``traceEvents`` object form):
        complete ("X") events with microsecond ``ts`` relative to the
        tracer's epoch, sorted so ``ts`` is monotonic."""
        with self._lock:
            records = sorted(self._spans, key=lambda r: r[1])
            dropped = self._dropped
        pid = os.getpid()
        events = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "veles.simd_tpu_torch host dispatch"},
        }]
        for name, start_ns, dur_ns, tid, phase, parent, attrs in records:
            # "phase"/"parent" are reserved arg keys
            args = {k: v for k, v in attrs.items()
                    if k not in ("phase", "parent")}
            args["phase"] = phase
            if parent is not None:
                args["parent"] = parent
            events.append({
                "name": name, "cat": "dispatch", "ph": "X",
                "ts": (start_ns - self._epoch_ns) / 1e3,
                "dur": dur_ns / 1e3,
                "pid": pid, "tid": tid, "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"spans_dropped": dropped}}
