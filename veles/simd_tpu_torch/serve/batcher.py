"""Deadline batcher: shape-class buckets, max_batch/max_wait coalescing.

The port of ``veles.simd_tpu.serve.batcher``, unchanged in policy:
queued requests are grouped by **shape class** — the (op, params,
:func:`bucket_length`) triple that keys one handle in
:mod:`veles.simd_tpu_torch.ops.batched` — and a group is dispatched
when EITHER

* it holds ``max_batch`` requests (the batch is full — waiting longer
  buys nothing), OR
* its oldest request has waited ``max_wait`` seconds (the latency
  deadline — waiting longer costs p99).

Items may additionally carry an **end-to-end request deadline**
(``deadline`` attribute, a :func:`faults.monotonic` stamp; None = no
deadline): an item whose deadline passed while queued is *expired
stale work* — dispatching it would waste device time answering a
caller who already gave up.  :meth:`next_batch` sheds expired items
to the ``on_expired`` callback (the server answers them with a typed
``DeadlineExceeded``) *before* forming a batch, re-evaluating bucket
readiness afterwards — an expired head neither dispatches stale work
nor wedges its bucket, and the condition wait wakes at the earliest
head deadline (request or batching) so expiry is noticed promptly.

Workers may additionally **refill** a just-formed batch's free row
slots from the same shape class's queue (:meth:`take_refill`) — the
continuous-batching path: a request taken this way dispatches
immediately on a batch that was leaving anyway instead of zero-padding
riding in its place.  :meth:`depth_for` exposes the per-class queue
depth (open-batch occupancy) that the cluster's padding-aware
placement score reads.

``close()`` makes every queued request immediately ready (drain), and
:meth:`next_batch` returns None only when the batcher is closed AND
empty — the worker-loop exit condition, so no request can be left
behind in a bucket.

Signals inside a class are zero-padded to the class's pow-of-two
bucket length (:func:`veles.simd_tpu_torch.runtime.routing.
pow2_bucket`) — exactly the boundary padding the ops already apply
implicitly, so the sliced-back outputs are the unpadded answers — which
keeps the live set of batched handles (and captured shapes)
logarithmic in the length spread instead of linear in distinct
lengths.

All deadline arithmetic reads
:func:`veles.simd_tpu_torch.runtime.faults.monotonic` (the serve lint
rule bans raw ``time.*`` here); waits park on one condition variable, so an
idle batcher costs nothing.
"""

from __future__ import annotations

import collections
import os
import threading

from veles.simd_tpu_torch.runtime import faults, routing

__all__ = [
    "Batcher", "bucket_length",
    "MAX_BATCH_ENV", "MAX_WAIT_ENV",
    "DEFAULT_MAX_BATCH", "DEFAULT_MAX_WAIT_MS", "env_policy",
]

MAX_BATCH_ENV = "VELES_SIMD_SERVE_MAX_BATCH"
MAX_WAIT_ENV = "VELES_SIMD_SERVE_MAX_WAIT_MS"

# max_batch 8 fills a handle-LRU geometry without starving mixed
# traffic; 2 ms max_wait trades ~one dispatch round trip of added
# latency for up-to-8x fewer dispatches.  Both env-tunable.
DEFAULT_MAX_BATCH = 8
DEFAULT_MAX_WAIT_MS = 2.0

# minimum condition wait: a sub-ms residual deadline must not spin
_MIN_WAIT_S = 0.0005


def _env_pos(name: str, default, cast):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = cast(raw)
    except ValueError:
        return default
    return value if value > 0 else default


def env_policy() -> tuple:
    """``(max_batch, max_wait_s)`` from the environment
    (``$VELES_SIMD_SERVE_MAX_BATCH`` / ``_MAX_WAIT_MS``), falling back
    to the defaults."""
    return (_env_pos(MAX_BATCH_ENV, DEFAULT_MAX_BATCH, int),
            _env_pos(MAX_WAIT_ENV, DEFAULT_MAX_WAIT_MS, float) / 1e3)


def bucket_length(n: int) -> int:
    """The padded signal length of ``n``'s shape class (next power of
    two — the same classing the autotune cache uses, so a serve bucket
    and a tune-cache geometry class coincide)."""
    return routing.pow2_bucket(int(n))


class Batcher:
    """Bucketed FIFO queues + the deadline policy behind one condition.

    Items are opaque to the batcher except for two attributes:
    ``enq``, the :func:`faults.monotonic` enqueue stamp the batching
    deadline is measured from, and (optionally) ``deadline``, the
    request's absolute end-to-end deadline on the same clock (None =
    none) — the server's pending-request record carries both.
    ``on_expired`` receives lists of expired items as
    :meth:`next_batch` sheds them (called with the batcher lock held;
    it must answer tickets/release admission, never call back into
    the batcher).
    """

    def __init__(self, max_batch: int | None = None,
                 max_wait_s: float | None = None,
                 on_expired=None):
        env_b, env_w = env_policy()
        self.max_batch = int(max_batch) if max_batch else env_b
        self.max_wait_s = (float(max_wait_s) if max_wait_s is not None
                           else env_w)
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_wait_s < 0:
            raise ValueError("max_wait_s must be >= 0")
        self._on_expired = on_expired
        self._cond = threading.Condition()
        self._buckets: "collections.OrderedDict[object, collections.deque]" \
            = collections.OrderedDict()
        self._closed = False
        # any queued item carrying a request deadline?  Deadline-free
        # traffic must not pay the expiry sweep per wakeup.
        self._deadlines_queued = 0

    # -- producer side -----------------------------------------------------

    def put(self, key, item) -> None:
        """Queue ``item`` under shape-class ``key``; wakes a worker.
        Raises RuntimeError once closed (the server translates that
        into a typed shutdown answer).  NB for trace-minded callers:
        any request-trace edge for the enqueue must be recorded
        BEFORE calling this — once the item is queued a worker may
        form its batch concurrently, and a post-put edge would race
        the worker's ``batch_formed`` edge out of causal order."""
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            q = self._buckets.get(key)
            if q is None:
                q = self._buckets[key] = collections.deque()
            q.append(item)
            if getattr(item, "deadline", None) is not None:
                self._deadlines_queued += 1
            self._cond.notify()

    def close(self) -> None:
        """Stop accepting; every queued request becomes immediately
        ready (drain) and workers unblock."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- worker side -------------------------------------------------------

    @staticmethod
    def _expired(item, now: float) -> bool:
        dl = getattr(item, "deadline", None)
        return dl is not None and now >= dl

    def _shed_expired(self, now: float) -> list:
        """Pop every already-expired item (head-of-line AND mid-bucket
        — a batch must never carry stale work) under the lock; empty
        buckets vanish so readiness re-evaluates cleanly."""
        expired = []
        for key in list(self._buckets):
            q = self._buckets[key]
            live = collections.deque()
            for it in q:
                (expired if self._expired(it, now)
                 else live).append(it)
            if len(live) != len(q):
                if live:
                    self._buckets[key] = live
                else:
                    del self._buckets[key]
        self._deadlines_queued -= len(expired)
        return expired

    def _ready_key(self, now: float):
        """The ready bucket with the oldest head (fairness), or None.
        Ready = full, past its head's deadline, or draining."""
        best, best_enq = None, None
        for key, q in self._buckets.items():
            head_enq = q[0].enq
            ready = (self._closed or len(q) >= self.max_batch
                     or now - head_enq >= self.max_wait_s)
            if ready and (best is None or head_enq < best_enq):
                best, best_enq = key, head_enq
        return best

    def _next_deadline(self, now: float) -> float | None:
        """Seconds until the earliest deadline — a head's batching
        wait, or ANY queued item's request deadline (a mid-bucket
        request can expire before every head's wait, and its typed
        answer must not stall until the next put); None = no queued
        work, wait for a put."""
        soonest = None
        for q in self._buckets.values():
            remaining = q[0].enq + self.max_wait_s - now
            if self._deadlines_queued:
                for it in q:
                    dl = getattr(it, "deadline", None)
                    if dl is not None:
                        remaining = min(remaining, dl - now)
            if soonest is None or remaining < soonest:
                soonest = remaining
        return soonest

    def next_batch(self):
        """Block until one shape class is ready; returns ``(key,
        [items...])`` (FIFO within the class, at most ``max_batch``),
        or None when closed and fully drained.  Expired items are shed
        to ``on_expired`` first — never returned in a batch."""
        with self._cond:
            while True:
                now = faults.monotonic()
                if self._deadlines_queued:
                    expired = self._shed_expired(now)
                    if expired and self._on_expired is not None:
                        self._on_expired(expired)
                key = self._ready_key(now)
                if key is not None:
                    q = self._buckets[key]
                    take = min(self.max_batch, len(q))
                    batch = [q.popleft() for _ in range(take)]
                    if not q:
                        del self._buckets[key]
                    self._deadlines_queued -= sum(
                        1 for it in batch
                        if getattr(it, "deadline", None) is not None)
                    return key, batch
                if self._closed and not self._buckets:
                    return None
                wait = self._next_deadline(now)
                if wait is not None:
                    wait = max(wait, _MIN_WAIT_S)
                self._cond.wait(wait)

    def take_refill(self, key, limit: int, now: float | None = None) -> list:
        """Continuous-batching refill: pop up to ``limit`` queued items
        of shape class ``key`` *right now*, without waiting for the
        class to become ready.  A worker that just formed a batch whose
        row count sits below its pow-of-two row class calls this to
        fill the otherwise-zero-padded row slots — the refilled
        requests ride a dispatch that was happening anyway, so they
        skip their remaining batching wait entirely (the Orca-style
        slot-refill trick applied at dispatch grain).

        Expired items encountered while refilling are shed to
        ``on_expired`` exactly as :meth:`next_batch` would shed them
        (with the lock held) — a refill must never smuggle stale work
        onto the device.  Returns the taken items in FIFO order
        (possibly empty)."""
        if limit <= 0:
            return []
        with self._cond:
            q = self._buckets.get(key)
            if not q:
                return []
            if now is None:
                now = faults.monotonic()
            taken, expired = [], []
            while q and len(taken) < limit:
                it = q.popleft()
                (expired if self._expired(it, now) else taken).append(it)
            if not q:
                del self._buckets[key]
            self._deadlines_queued -= sum(
                1 for it in taken + expired
                if getattr(it, "deadline", None) is not None)
            if expired and self._on_expired is not None:
                self._on_expired(expired)
            return taken

    # -- introspection -----------------------------------------------------

    def depth_for(self, key) -> int:
        """Requests currently queued under one shape class — the
        **open-batch occupancy** the cluster's padding-aware placement
        reads: a nonzero depth means a dispatch here would complete a
        forming batch rather than open a fresh one."""
        with self._cond:
            q = self._buckets.get(key)
            return len(q) if q else 0

    def pending(self) -> int:
        """Requests currently queued across every shape class."""
        with self._cond:
            return sum(len(q) for q in self._buckets.values())

    def snapshot(self) -> dict:
        """JSON-native view: policy knobs + per-class queue lengths."""
        with self._cond:
            return {"max_batch": self.max_batch,
                    "max_wait_s": self.max_wait_s,
                    "closed": self._closed,
                    "pending": sum(len(q)
                                   for q in self._buckets.values()),
                    "classes": {repr(k): len(q)
                                for k, q in self._buckets.items()}}
