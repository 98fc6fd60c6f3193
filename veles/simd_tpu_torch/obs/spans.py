"""Nested, thread-local host-side spans — the *time axis* of obs.

Copied from ``veles.simd_tpu.obs.spans`` without its
``jax.profiler.TraceAnnotation`` bridge and its crash hook (the port
has no flight recorder yet).  A span brackets one region of Python
dispatch code::

    with obs.span("convolve.dispatch", algo="overlap_save"):
        ... pick a route, launch the kernels ...

and, while telemetry is enabled, each completed span

* feeds one sample into the registry's log-spaced timing histogram
  ``span.<name>`` — labeled ``phase="warmup"`` for the FIRST completion
  of each distinct ``(name, attrs)`` combination in the process (where
  a kernel's first-use build lands) and ``phase="steady"`` afterwards;
* appends one record to a bounded ring buffer exportable as Chrome
  trace-event JSON that loads directly in Perfetto /
  ``chrome://tracing``.

The clock is the host's: CUDA launches are asynchronous, so a span
around a launch measures the enqueue, not the kernel — device time
comes from :mod:`veles.simd_tpu_torch.utils.benchmark`.

Keyword attributes (``algo=...``) travel ONLY into the trace-event
``args`` — never into histogram labels — so per-call geometry cannot
explode metric cardinality.

Cost discipline: telemetry OFF, ``obs.span(...)`` is one module-global
check returning a shared no-op context manager; telemetry ON, two
``perf_counter_ns`` reads plus one locked append and one locked
histogram update per span.
"""

from __future__ import annotations

import collections
import os
import threading
import time

__all__ = ["Span", "SpanTracer", "NULL_SPAN", "DEFAULT_MAX_SPANS"]

DEFAULT_MAX_SPANS = 32768


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

    __slots__ = ("_tracer", "name", "attrs", "_start_ns", "_parent")

    def __init__(self, tracer: "SpanTracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._start_ns = 0
        self._parent = None

    def __enter__(self):
        stack = self._tracer._stack()
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end_ns = time.perf_counter_ns()
        stack = self._tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        self._tracer._finish(self.name, self._start_ns, end_ns,
                             threading.get_ident(), self._parent,
                             self.attrs)
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
