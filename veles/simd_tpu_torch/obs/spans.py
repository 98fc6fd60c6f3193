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

Every completed span lands as one record in the tracer's single store:
a preallocated ring of ``max_spans`` slots, each record numbered in
order, the oldest overwritten once the ring is full (overflow counted
in :attr:`SpanTracer.dropped`).  A record keeps the raw
``perf_counter_ns`` stamps, the parent span's name and a *call id*: the
number drawn when the outermost span open on the thread opened, shared
by every span nested inside it, so one dispatch call's spans group
without the clock.  A record is one tuple
of atomic fields, its attributes held beside it: a tuple that holds a
dict stays tracked by the cyclic garbage collector for good, and a
million of them make each full collection walk the whole ring.

**Capture** (the facade's ``obs.start_capture``) records spans through
:meth:`SpanTracer.capture_span`, with telemetry off and nothing else of
telemetry: no histogram, no warm-up class, no lock, no bridge, no crash
hook; a count taken inside a span while it is armed adds its increment
to that span's attributes (:meth:`SpanTracer.count_in_span`), so the
span's one record carries it.  :meth:`SpanTracer.captured` reads the
store back as :class:`CaptureRecord` rows oldest first, with the drop
count.

Cost discipline: telemetry and capture OFF, ``obs.span(...)`` is one
module-global check returning a shared no-op context manager; capture
alone, two ``perf_counter_ns`` reads, a thread-local stack push and
pop and one slot write per span; telemetry ON, that plus one locked
warm-up lookup and one histogram update per span.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from typing import NamedTuple

__all__ = [
    "Span", "SpanTracer", "NULL_SPAN", "DEFAULT_MAX_SPANS",
    "set_xla_trace_active", "xla_trace_active",
]

DEFAULT_MAX_SPANS = 32768

_clock = time.perf_counter_ns

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


class CaptureRecord(NamedTuple):
    """One span of the store, as :meth:`SpanTracer.captured` returns
    it: its raw ``perf_counter_ns`` ``start_ns`` and ``end_ns``, the
    name of the span open around it on its thread (``parent``, None at
    the top), the call id of the outermost one (``call``), its
    attributes with the counts folded into them (``attrs``), the
    thread's ident (``tid``), its place in the order of records
    (``seq``) and, for a telemetry span, its ``phase`` (None for a
    captured one)."""

    seq: int
    name: str
    start_ns: int
    end_ns: int
    parent: str | None
    call: int
    attrs: dict
    tid: int
    phase: str | None


class Capture(NamedTuple):
    """The store read back: its records oldest first, and how many
    records the ring overwrote before they were read."""

    records: list
    dropped: int


class _Thread:
    """One thread's open spans: their frames ``(name, attrs, parent,
    call, start_ns)``, innermost last, and the thread's ident.  It is
    also the context manager :meth:`SpanTracer.capture_span` hands out,
    one per thread, set to open the next captured span: opening one
    allocates only its frame."""

    __slots__ = ("tracer", "stack", "tid", "name", "attrs")

    def __init__(self, tracer: "SpanTracer"):
        self.tracer = tracer
        self.stack = []
        self.tid = threading.get_ident()

    def push(self, name: str, attrs: dict) -> tuple:
        """Open a frame for ``name``, child of the innermost open one or
        the first of a new call, its clock read last."""
        stack = self.stack
        if stack:
            top = stack[-1]
            frame = (name, attrs, top[0], top[3], _clock())
        else:
            frame = (name, attrs, None, next(self.tracer._calls),
                     _clock())
        stack.append(frame)
        return frame

    # push() and SpanTracer._write, inlined: they are a captured span's
    # whole cost
    def __enter__(self):
        stack = self.stack
        if stack:
            top = stack[-1]
            stack.append((self.name, self.attrs, top[0], top[3], _clock()))
        else:
            stack.append((self.name, self.attrs, None,
                          next(self.tracer._calls), _clock()))
        return self

    def __exit__(self, exc_type, exc, tb):
        end_ns = _clock()
        name, attrs, parent, call, start_ns = self.stack.pop()
        tracer = self.tracer
        seq = next(tracer._seq)
        i = seq % tracer.max_spans
        tracer._ring[i] = (seq, name, start_ns, end_ns, parent, call,
                           self.tid, None)
        tracer._attrs[i] = attrs
        tracer._written = seq + 1
        return False


class Span:
    """One live telemetry span (context manager).  Created by
    :meth:`SpanTracer.span`; not constructed directly."""

    __slots__ = ("_tracer", "name", "attrs", "_ann", "_frame", "_thread")

    def __init__(self, tracer: "SpanTracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._ann = None

    def __enter__(self):
        self._thread = self._tracer._thread()
        if _XLA_TRACE_ACTIVE and "torch" in sys.modules:
            try:  # best-effort: a failed bridge must not fail dispatch
                import torch

                self._ann = torch.profiler.record_function(self.name)
                self._ann.__enter__()
            except Exception:  # noqa: BLE001
                self._ann = None
        # the frame's clock read is LAST so bridge setup never inflates
        # the span
        self._frame = self._thread.push(self.name, self.attrs)
        return self

    def __exit__(self, exc_type, exc, tb):
        end_ns = _clock()
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:  # noqa: BLE001
                pass
            self._ann = None
        stack = self._thread.stack
        if stack and stack[-1] is self._frame:
            stack.pop()
        name, attrs, parent, call, start_ns = self._frame
        self._tracer._finish(name, start_ns, end_ns, self._thread.tid,
                             parent, attrs, call)
        if exc_type is not None and parent is None:
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
    """Span storage + histogram feed.

    ``observe`` is a ``registry.observe``-compatible callable; each
    completed span of :meth:`span` calls ``observe("span." + name,
    seconds, phase=...)``.  Completed spans are retained in a
    preallocated ring (``max_spans``; overflow counted in
    :attr:`dropped`), rendered to Chrome trace events on export; the
    capture mode's spans (:meth:`capture_span`) go into the same ring.
    Slots and call ids are drawn from ``itertools.count`` (one step
    under the interpreter lock) and a record is two slot stores, so
    recording takes no lock.
    """

    def __init__(self, observe, max_spans: int = DEFAULT_MAX_SPANS):
        max_spans = int(max_spans)
        if max_spans < 1:
            raise ValueError("max_spans must be >= 1")
        self.max_spans = max_spans
        self._observe = observe
        self._lock = threading.Lock()
        self._warmed: set[tuple] = set()
        self._tls = threading.local()
        self._calls = itertools.count(1)
        self._epoch_ns = time.perf_counter_ns()
        self._clear()
        # called as on_crash(exc_type, exc) when an exception escapes a
        # top-level span; armed by the obs facade with the flight
        # recorder's hook (None = one attribute check per crash)
        self.on_crash = None

    def _clear(self) -> None:
        # a record's fields but its attributes, (seq, name, start_ns,
        # end_ns, parent, call, tid, phase), and its attributes
        self._ring = [None] * self.max_spans
        self._attrs = [None] * self.max_spans
        self._seq = itertools.count()
        self._written = 0           # records written so far

    def span(self, name: str, **attrs) -> Span:
        return Span(self, str(name), attrs)

    def capture_span(self, name: str, attrs: dict) -> _Thread:
        """A span that leaves its record in the store and nothing else
        (no histogram, warm-up class, profiler bridge or crash hook):
        this thread's one capture context, set to open ``name`` when it
        is entered, which has to follow at once."""
        try:
            thread = self._tls.thread
        except AttributeError:
            thread = self._thread()
        thread.name = name
        thread.attrs = attrs
        return thread

    def count_in_span(self, name: str, n) -> None:
        """Add ``n`` to attribute ``name`` of the span open on this
        thread, so that its record carries the count with its stamps and
        call id.  A count outside every span belongs to no call and is
        dropped."""
        try:
            stack = self._tls.thread.stack
        except AttributeError:
            return          # no span was ever open on this thread
        if stack:
            attrs = stack[-1][1]
            attrs[name] = attrs.get(name, 0) + n

    def _thread(self) -> _Thread:
        thread = getattr(self._tls, "thread", None)
        if thread is None:
            thread = self._tls.thread = _Thread(self)
        return thread

    def _write(self, name, start_ns, end_ns, parent, call, attrs, tid,
               phase) -> None:
        seq = next(self._seq)
        i = seq % self.max_spans
        self._ring[i] = (seq, name, start_ns, end_ns, parent, call, tid,
                         phase)
        self._attrs[i] = attrs
        self._written = seq + 1

    def _finish(self, name, start_ns, end_ns, tid, parent, attrs, call):
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
        self._write(name, start_ns, end_ns, parent, call, attrs, tid,
                    phase)
        # registry has its own lock; never observe under ours
        self._observe("span." + name, max(0, end_ns - start_ns) * 1e-9,
                      phase=phase)

    def _records(self) -> list:
        """The ring's records in :class:`CaptureRecord`'s field order,
        oldest first."""
        recs = [r[:6] + (a,) + r[6:]
                for r, a in zip(self._ring, self._attrs) if r is not None]
        recs.sort(key=lambda r: r[0])
        return recs

    def captured(self) -> Capture:
        """Every record of the store as :class:`CaptureRecord` rows,
        oldest first, and how many were overwritten."""
        return Capture([CaptureRecord._make(r) for r in self._records()],
                       self.dropped)

    @property
    def dropped(self) -> int:
        """Records overwritten before they were read (exact once the
        threads writing records are quiet)."""
        return max(0, self._written - self.max_spans)

    def reset(self) -> None:
        """Clear retained spans, the drop count, and the warmup
        marks."""
        self._clear()
        with self._lock:
            self._warmed.clear()

    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (the ``traceEvents`` object form):
        complete ("X") events with microsecond ``ts`` relative to the
        tracer's epoch, sorted so ``ts`` is monotonic."""
        records = sorted(self._records(), key=lambda r: r[2])
        pid = os.getpid()
        events = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "veles.simd_tpu_torch host dispatch"},
        }]
        for (_seq, name, start_ns, end_ns, parent, _call, attrs, tid,
             phase) in records:
            # "phase"/"parent" are reserved arg keys
            args = {k: v for k, v in attrs.items()
                    if k not in ("phase", "parent")}
            if phase is not None:       # None: a captured span
                args["phase"] = phase
            if parent is not None:
                args["parent"] = parent
            events.append({
                "name": name, "cat": "dispatch", "ph": "X",
                "ts": (start_ns - self._epoch_ns) / 1e3,
                "dur": max(0, end_ns - start_ns) / 1e3,
                "pid": pid, "tid": tid, "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"spans_dropped": self.dropped}}
