"""Bounded structured event log for dispatch decisions.

Every *algorithm decision* the framework makes at its Python dispatch
layer — which convolution algorithm a handle selected, which framing
path an STFT took, which kernel a wavelet step routed to, what geometry
a sharded op used — is appended here as one small dict.  The log is a
ring buffer: a long-running service can leave telemetry on forever and
the log stays O(``max_events``); overwritten entries are counted in
``dropped`` so exports can say how much history scrolled away.

Copied from ``veles.simd_tpu.obs.events``.  Like
:mod:`veles.simd_tpu_torch.obs.registry`, this module is torch-free
and numpy-free on purpose.
"""

from __future__ import annotations

import collections
import threading

__all__ = ["EventLog", "DEFAULT_MAX_EVENTS"]

DEFAULT_MAX_EVENTS = 4096


class EventLog:
    """Thread-safe bounded log of decision events."""

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS):
        max_events = int(max_events)
        if max_events < 1:
            raise ValueError("max_events must be >= 1")
        self.max_events = max_events
        self._lock = threading.Lock()
        self._events = collections.deque(maxlen=max_events)
        self._seq = 0
        self._dropped = 0

    def record(self, op: str, decision: str, **fields) -> None:
        """Append one decision event.

        ``fields`` must be JSON-native scalars (str/int/float/bool/None);
        values are kept as passed — the exporters serialize them as-is.
        """
        with self._lock:
            if len(self._events) == self.max_events:
                self._dropped += 1
            self._events.append(
                {"seq": self._seq, "op": str(op),
                 "decision": str(decision), **fields})
            self._seq += 1

    def events(self) -> list:
        """Oldest-first copy of the retained events."""
        with self._lock:
            return [dict(e) for e in self._events]

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._seq = 0
            self._dropped = 0
