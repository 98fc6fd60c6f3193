"""The program's own spans and counts in a traced window, on the
benchmark's host clock.

The program records spans at its layer boundaries
(``veles.simd_tpu_torch.obs``'s capture mode): a span's name, its raw
``time.perf_counter_ns`` start and end, its parent's name, its
attributes (the counts taken inside it among them) and a call id
shared by everything inside one outermost span.  That is the clock
of the harness's window stamps (``harness.closed_loop``), which
``harness.host_to_device`` maps onto CUPTI's, so the spans need no
clock of their own.

Importing this module arms the capture, with room for a whole window
(:data:`CAPTURE_RECORDS`).  The harness loads per-layer readers, and so
this module, only for a ``--trace 1`` run, before the operands and the
warm-up: an untraced run never arms it.

:func:`calls` reads the records once a window has closed: those that
lie inside ``[first call's start, last call's end]``, grouped by call
id.  It gives None, and so every reader built on it, where the program
has no capture (a checkout from before it), where the store overwrote
a record, or where the window does not hold exactly one top-level span
per call, each inside the harness's span of its call.
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np

# a 20-s window holds up to ~35,000 calls of 4-7 records each
CAPTURE_RECORDS = 1 << 20

# the counts a reader reads: the only ones folded into their spans
COUNTS = ("wavelet_extend_bytes",)

# the spans that cover a route's own host work: the kernel wrapper's
# allocations and lookups and the C launch, or a library route's torch
# ops, the DWT's boundary extension included
RUNNERS = ("convolve.os_route", "wavelet_apply.dispatch")


def arm():
    """The program's ``obs`` with its capture armed over an emptied
    store of :data:`CAPTURE_RECORDS` slots, folding only the counts a
    reader reads into their spans, or None where the program has no
    capture."""
    try:
        from veles.simd_tpu_torch import obs
    except ImportError:
        return None
    if not hasattr(obs, "start_capture"):
        return None
    obs.configure(max_spans=CAPTURE_RECORDS)
    obs.start_capture(counts=COUNTS)
    return obs


_OBS = arm()


@dataclasses.dataclass
class Call:
    """One call's records: its top-level span and every span inside
    it."""

    top: object
    spans: list

    def summed(self, names) -> int:
        """Nanoseconds of the spans named in ``names``, leaving out one
        nested in another of them."""
        return sum(s.end_ns - s.start_ns for s in self.spans
                   if s.name in names and s.parent not in names)


def group(records, window, dropped: int = 0) -> list[Call] | None:
    """The window's calls from capture records, in order, or None where
    the records cannot be read as one top-level span per call."""
    if dropped:
        return None
    lo, hi = int(window.a[0]), int(window.c[-1])
    by_call: dict[int, Call] = {}
    rest = []
    for rec in records:
        if rec.start_ns < lo or rec.end_ns > hi:
            continue
        if rec.parent is None:
            if rec.call in by_call:
                return None
            by_call[rec.call] = Call(rec, [])
        else:
            rest.append(rec)
    calls = sorted(by_call.values(), key=lambda c: c.top.start_ns)
    if len(calls) != window.calls:
        return None
    starts = np.array([c.top.start_ns for c in calls], np.int64)
    ends = np.array([c.top.end_ns for c in calls], np.int64)
    if np.any(starts < window.a) or np.any(ends > window.b):
        return None
    for rec in rest:
        call = by_call.get(rec.call)
        if call is None:
            return None
        call.spans.append(rec)
    return calls


_LAST: list = [None, None]      # the window last read, its calls


def calls(r) -> list[Call] | None:
    """The calls of the readings' window (read once a window)."""
    if _OBS is None:
        return None
    if _LAST[0] is not r.window:
        cap = _OBS.captured()
        _LAST[:] = [r.window, group(cap.records, r.window, cap.dropped)]
    return _LAST[1]


def median_us(values) -> float | None:
    values = list(values)
    return statistics.median(values) / 1e3 if values else None
