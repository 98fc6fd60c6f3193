"""The serving loop: heterogeneous requests -> batched guarded dispatch.

The port of ``veles.simd_tpu.serve.server``, path for path.
:class:`Server` is the request path in front of the op families — the
composition of every robustness layer the runtime already has, plus
the one loop none of them provided:

* **shape-class bucketing** — a request's ``(op, params,
  pow2-bucketed length)`` picks a bucket; signals are zero-padded to
  the bucket length (the ops' own implicit boundary padding, so the
  sliced-back outputs are exact) and batches are row-padded to a power
  of two, so the whole traffic mix shares a logarithmic set of
  handles in the :mod:`veles.simd_tpu_torch.ops.batched` LRU;
* **deadline batching** — :class:`~veles.simd_tpu_torch.serve.\
batcher.Batcher` dispatches a bucket when it is full (``max_batch``)
  or its oldest request has waited ``max_wait`` (whichever fires
  first);
* **continuous batching** — an under-full batch tops its pow2 row
  class up from its own queue at dispatch time
  (``VELES_SIMD_SERVE_CONTINUOUS``, default on): refilled requests
  ride row slots that were dispatching as zero padding anyway,
  tagged ``refilled`` on their ``batch_formed`` trace edge;
* **ragged segment packing** — with ``VELES_SIMD_SERVE_RAGGED`` on,
  stft requests classify into one sample-axis-packed "ragged" class
  per (op, params): variable lengths co-pack into shared rows
  (:mod:`veles.simd_tpu_torch.ops.segments`) behind a
  ``segments.dispatch`` breaker whose fallback is per-segment salvage
  — one poisoned segment degrades its own ticket, never co-packed
  neighbors;
* **end-to-end request deadlines** — ``submit(deadline_ms=...)``
  stamps an absolute monotonic deadline at admission (default from
  ``VELES_SIMD_SERVE_DEADLINE_MS``; 0/unset = none); a request whose
  deadline passes while queued is shed *before* dispatch with a typed
  :class:`DeadlineExceeded` (``status="expired"`` — stale work never
  reaches the device), and a dispatched batch's remaining budget
  flows into :func:`faults.guarded` so the transient-retry loop is
  clipped to what the requests can still use;
* **per-class circuit breakers** — every shape class dispatches
  through its own :class:`veles.simd_tpu_torch.runtime.breaker.
  Breaker` (key: the batch's shape-class triple): a class that keeps
  exhausting its retries goes straight to the oracle while sibling
  classes dispatch normally;
* **admission control + backpressure** —
  :class:`~veles.simd_tpu_torch.serve.admission.AdmissionController`
  bounds global and per-tenant queue depth; over-limit submits get a
  typed :class:`~veles.simd_tpu_torch.serve.admission.Overloaded`
  *immediately* (``submit(block=True, timeout=...)`` opts into
  backpressure instead);
* **guarded dispatch + health machine** — every device batch runs
  under :func:`veles.simd_tpu_torch.runtime.faults.guarded` at the
  ``serve.dispatch`` site; retry exhaustion trips the
  :class:`~veles.simd_tpu_torch.serve.health.HealthMonitor` into
  DEGRADED — batches are answered by the NumPy oracle, every
  ``probe_every``-th batch probes the device with a zero-retry budget,
  and the first probe that lands flips back to HEALTHY;
* **observability** — ``serve.dispatch`` spans, ``serve.batch_fill``
  and ``serve.deadline_slack`` histograms, queue-depth and goodput
  gauges, shed/degrade/probe counters, all in ``obs.to_prometheus()``;
* **the request axis** — every submit mints an ``obs.request_trace``
  carried on the ticket across threads (admitted -> bucketed ->
  batch-formed -> dispatched -> retried/degraded -> exactly one
  terminal edge, closed by ``Ticket._complete`` for every outcome),
  and ``start()`` arms the live scrape endpoint (``/metrics`` +
  ``/healthz`` + ``/debug/requests``) via ``$VELES_SIMD_OBS_PORT`` or
  ``obs_port=`` (0 = ephemeral).

What the card changes:

* **one copy back per batch** — the server always dispatches a host
  batch (NumPy rows); the device path answers with one tensor on the
  card, which comes to the host whole, with one copy, before the
  tickets complete, so a trace's ``device`` phase holds the device
  time, not the time of an asynchronous launch.  The oracle answers
  in NumPy.  Because the dispatched batch is host data
  (``faults.on_card`` is false), the oracle fallback stays legal: a
  degraded answer equals ``simd=False``, flagged ``degraded``;
* **graph capture is exclusive** — a pipeline row class captures its
  CUDA graph at its first batch, and a capture fails when another
  thread of the process allocates or copies synchronously on the card
  meanwhile.  So a worker about to capture waits until every worker
  of every server in the process has left its device section, and
  holds them out until the capture is done (one :class:`_CaptureGate`
  a process); replays of a captured class and every plain batch share
  the card freely.  Work on the card from outside the servers is the
  caller's to keep off a first pipeline batch;
* **the warm pack is the kernel library** — with the artifact store
  armed (``VELES_SIMD_ARTIFACTS=on|readonly``,
  :mod:`veles.simd_tpu_torch.runtime.artifacts`), :meth:`Server.start`
  preloads it before any worker runs: the packed nvcc-built library is
  placed under the build root, so the first request's kernel loads it
  without an nvcc build.  Best effort, as in the JAX package: a stale
  or torn pack counts and places nothing, a failed preload counts
  ``artifact_preload_error``, and the server starts cold either way;
  ``stats()["artifact_preload"]`` is the report (None when the store
  is off), in a replica of ``serve.cluster`` too.

Usage::

    from veles.simd_tpu_torch import serve

    with serve.Server(max_batch=8, max_wait_ms=2.0) as srv:
        t = srv.submit(serve.Request("sosfilt", x, {"sos": sos},
                                     tenant="alice"))
        y = t.result(timeout=5.0)       # raises Overloaded if shed

Supported ops (``SUPPORTED_OPS``): ``resample_poly`` (params
``up``/``down``), ``sosfilt`` (``sos``), ``lfilter`` (``b``/``a``),
``stft`` (``frame_length``/``hop``).  Each answers with the same
numerics as its single-call twin, as NumPy; DEGRADED-mode answers are
the NumPy oracle's (flagged ``degraded`` on the ticket).  An ``stft``
batch with at least two hops a frame, on rows of at least 64 frames, is
one launch of the fused STFT kernel.

**Pipelines are first-class tenants too**: a compiled pipeline
(:mod:`veles.simd_tpu_torch.pipeline`) registered via
:meth:`Server.register_pipeline` serves under op
``"pipeline:<name>"`` — each request is one *pipeline invocation*
(one block plus the stream's carried state in ``params["state"]``;
the ticket's value is ``(out, new_state)``, NumPy, threaded by the
caller into the next invocation).  Dispatch is one fused step (one
graph replay on the card) per batch through the pipeline's own
per-class breaker at ``pipeline.dispatch``, degrading to the
stage-by-stage oracle twin with exact state continuity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading

import numpy as np

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.obs import http as obs_http
from veles.simd_tpu_torch.ops import batched
from veles.simd_tpu_torch.ops import iir as _iir
from veles.simd_tpu_torch.ops import resample as _rs
from veles.simd_tpu_torch.ops import segments as _segments
from veles.simd_tpu_torch.ops import spectral as _sp
from veles.simd_tpu_torch.runtime import artifacts as _artifacts
from veles.simd_tpu_torch.runtime import breaker as _breaker
from veles.simd_tpu_torch.runtime import faults
from veles.simd_tpu_torch.serve.admission import (AdmissionController,
                                                  Overloaded)
from veles.simd_tpu_torch.serve.batcher import Batcher, bucket_length
from veles.simd_tpu_torch.serve.health import (DEFAULT_PROBE_EVERY,
                                               HealthMonitor)
from veles.simd_tpu_torch.utils import platform as _platform

__all__ = ["Request", "Ticket", "Server", "ServerClosed",
           "DeadlineExceeded", "SUPPORTED_OPS", "DEFAULT_WORKERS",
           "DEADLINE_ENV", "env_deadline_ms", "classify_request",
           "CONTINUOUS_ENV", "RAGGED_ENV", "RAGGED_MAX_ENV",
           "continuous_enabled", "ragged_enabled", "ragged_max"]

# two workers overlap one batch's host-side padding/slicing with the
# previous batch's device wait without oversubscribing dispatch
DEFAULT_WORKERS = 2

DEADLINE_ENV = "VELES_SIMD_SERVE_DEADLINE_MS"

# continuous batching (Orca-style slot refill at dispatch grain): a
# worker that just formed an under-full batch tops its pow2 row class
# up from the same shape class's queue, so requests ride padding slots
# that were dispatching anyway.  Default ON; set =0/off to disable.
CONTINUOUS_ENV = "VELES_SIMD_SERVE_CONTINUOUS"

# ragged segment packing (ops/segments.py): stft requests classify
# into one per-(op, params) "ragged" shape class and co-pack along the
# sample axis instead of zero-padding each to its pow2 bucket.
# Default OFF (opt-in; flips the stft shape classing).
RAGGED_ENV = "VELES_SIMD_SERVE_RAGGED"

# requests longer than this many samples keep their plain pow2 bucket
# even with ragged on: the packed width is the pow2 bucket of the
# LARGEST co-packed stride, and a packed plan's tail row quantizes to
# that width — one heavy-tail request in an under-full batch can cost
# more slack than its own plain bucket would have (measured: letting
# 2800-sample requests co-pack at width 4096 LOWERED saturation
# goodput 0.84 -> 0.78).  2048 keeps the width a mid-size batch of
# short segments reliably backfills.
RAGGED_MAX_ENV = "VELES_SIMD_SERVE_RAGGED_MAX"
DEFAULT_RAGGED_MAX = 2048

# the artifact-store switch start() reads (runtime/artifacts.py)
ARTIFACTS_ENV = _artifacts.ARTIFACTS_ENV


def _env_flag(name: str, default: bool) -> bool:
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    return raw not in ("0", "off", "false", "no")


def continuous_enabled() -> bool:
    """Is continuous batching (dispatch-time slot refill) on?
    (``$VELES_SIMD_SERVE_CONTINUOUS``; default on)."""
    return _env_flag(CONTINUOUS_ENV, True)


def ragged_enabled() -> bool:
    """Is ragged segment packing for stft on?
    (``$VELES_SIMD_SERVE_RAGGED``; default off)."""
    return _env_flag(RAGGED_ENV, False)


def ragged_max() -> int:
    """Longest request (samples) that still co-packs into the ragged
    class (``$VELES_SIMD_SERVE_RAGGED_MAX``; default 1024, malformed
    or non-positive values fall back)."""
    raw = os.environ.get(RAGGED_MAX_ENV, "").strip()
    if raw:
        try:
            v = int(raw)
        except ValueError:
            return DEFAULT_RAGGED_MAX
        if v > 0:
            return v
    return DEFAULT_RAGGED_MAX


def env_deadline_ms() -> float | None:
    """The default end-to-end request deadline in milliseconds
    (``$VELES_SIMD_SERVE_DEADLINE_MS``; unset/0/negative = no
    deadline)."""
    raw = os.environ.get(DEADLINE_ENV, "").strip()
    if not raw:
        return None
    try:
        value = float(raw)
    except ValueError:
        return None
    return value if value > 0 else None


class ServerClosed(RuntimeError):
    """The server stopped before this request could be answered (or a
    submit raced :meth:`Server.stop`)."""


class DeadlineExceeded(RuntimeError):
    """Typed answer for a request whose end-to-end deadline passed
    while it was queued (``status="expired"``): the work was shed
    BEFORE dispatch — a caller who already gave up must not cost
    device time.  Never raised for dispatched requests: once a batch
    is in flight its remaining budget clips the retry loop instead
    (:func:`veles.simd_tpu_torch.runtime.faults.guarded` ``budget_s``)."""


@dataclasses.dataclass
class Request:
    """One unit of traffic: op name + 1-D float signal + op params +
    tenant id (the admission-control identity) + optional end-to-end
    deadline in milliseconds (None = the ``VELES_SIMD_SERVE_DEADLINE_MS``
    default; the deadline is stamped absolute at admission)."""

    op: str
    x: object
    params: dict = dataclasses.field(default_factory=dict)
    tenant: str = "default"
    deadline_ms: float | None = None


class Ticket:
    """The caller's handle on one submitted request.

    Completed exactly once by the server (a second completion attempt
    raises and bumps ``serve_double_answer`` — the concurrency suite's
    invariant).  ``status`` is one of ``pending`` / ``ok`` /
    ``degraded`` (oracle-served while DEGRADED or behind an open
    breaker) / ``shed`` (typed :class:`Overloaded`) / ``expired``
    (typed :class:`DeadlineExceeded` — the end-to-end deadline passed
    before dispatch) / ``closed`` / ``error``.
    """

    __slots__ = ("op", "tenant", "status", "wait_s", "trace",
                 "_event", "_value", "_error", "_lock", "_cbs")

    def __init__(self, op: str, tenant: str):
        self.op = op
        self.tenant = tenant
        self.status = "pending"
        self.wait_s = None
        # the request-axis trace (obs.request_trace; the shared no-op
        # while telemetry is off) — attached at submit, carried across
        # threads with the ticket, finished HERE so every terminal
        # outcome closes its causal chain through one funnel
        self.trace = None
        self._event = threading.Event()
        self._value = None
        self._error = None
        self._lock = threading.Lock()
        self._cbs: list = []

    def _complete(self, *, value=None, error=None, status="ok",
                  wait_s=None) -> None:
        with self._lock:
            if self.status != "pending":
                obs.count("serve_double_answer", op=self.op)
                raise RuntimeError(
                    f"ticket for {self.op!r} completed twice "
                    f"(was {self.status!r}, second {status!r})")
            self._value = value
            self._error = error
            self.status = status
            self.wait_s = wait_s
            cbs, self._cbs = self._cbs, []
        # terminal edge outside the ticket lock (the tracer takes its
        # own locks) but BEFORE the wakeup: a waiter that observes a
        # done ticket must observe a closed trace — ONE funnel for
        # every status, so a ticket can never answer without closing
        # its causal chain (the completeness invariant loadgen and the
        # chaos campaign gate)
        if self.trace is not None:
            self.trace.finish(status)
        self._event.set()
        # completion hooks AFTER the wakeup, outside every lock: the
        # front router's failover path re-submits from here, and a
        # re-submission must never run under this ticket's lock (or
        # before a blocked waiter could observe the terminal status)
        for cb in cbs:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — observers never raise
                obs.count("serve_callback_error", op=self.op)

    def add_done_callback(self, cb) -> None:
        """Run ``cb(ticket)`` once the ticket is terminal (any
        status).  Fires immediately — on the calling thread — when the
        ticket is already done; otherwise on the completing thread,
        after waiters are woken.  The front router's failover hook."""
        with self._lock:
            if self.status == "pending":
                self._cbs.append(cb)
                return
        # already terminal — but _complete may still be between its
        # lock release and trace.finish/_event.set on the completing
        # thread; wait for the event so the callback (like any waiter)
        # observes a closed trace
        self._event.wait()
        cb(self)

    def done(self) -> bool:
        """Answered (any status but ``pending``)?"""
        return self._event.is_set()

    @property
    def degraded(self) -> bool:
        """Was the answer served by the oracle in DEGRADED mode?"""
        return self.status == "degraded"

    def result(self, timeout: float | None = None):
        """Block for the answer.  Returns the output array (``ok`` /
        ``degraded``); raises the typed error for ``shed`` /
        ``closed`` / ``error``; raises TimeoutError if unanswered
        within ``timeout``."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.op!r} unanswered after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value


class _Pending:
    """One queued request inside the server (batcher item: ``enq`` is
    the batching-deadline stamp, ``deadline`` the absolute end-to-end
    request deadline or None; ``released`` guards the admission slot
    against double release when a batch fails midway)."""

    __slots__ = ("ticket", "x", "n", "params", "enq", "deadline",
                 "released", "refilled")

    def __init__(self, ticket, x, n, params, enq, deadline=None):
        self.ticket = ticket
        self.x = x
        self.n = n
        self.params = params
        self.enq = enq
        self.deadline = deadline
        self.released = False
        # taken by the continuous-batching refill (dispatch-time slot
        # fill) rather than by batch formation — tagged on the
        # batch_formed trace edge so phase accounting can tell a
        # refilled row from a founding one
        self.refilled = False


# ---------------------------------------------------------------------------
# op adapters: validation, shape-class keys, output slicing
# ---------------------------------------------------------------------------


def _validate_resample(params: dict, n: int) -> tuple:
    up, down = int(params.get("up", 1)), int(params.get("down", 1))
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got {up}, {down}")
    return {"up": up, "down": down}, (up, down)


def _slice_resample(row, n: int, params: dict):
    return row[: _rs.resample_length(n, params["up"], params["down"])]


def _validate_sosfilt(params: dict, n: int) -> tuple:
    sos = _iir._check_sos(params.get("sos"))
    key = tuple(tuple(float(v) for v in r) for r in np.asarray(sos))
    return {"sos": np.asarray(sos)}, key


def _validate_lfilter(params: dict, n: int) -> tuple:
    b, a = _iir._normalize_ba(params.get("b"), params.get("a"))
    bk = tuple(float(v) for v in b)
    ak = tuple(float(v) for v in a)
    return {"b": np.asarray(b), "a": np.asarray(a)}, (bk, ak)


def _slice_rows(row, n: int, params: dict):
    return row[:n]


def _validate_stft(params: dict, n: int) -> tuple:
    fl = int(params.get("frame_length", 0))
    hop = int(params.get("hop", max(1, fl // 2)))
    _sp._check_stft_args(n, fl, hop)
    return {"frame_length": fl, "hop": hop}, (fl, hop)


def _slice_stft(row, n: int, params: dict):
    return row[: _sp.frame_count(n, params["frame_length"],
                                 params["hop"])]


# op -> (validate(params, n) -> (canonical_params, param_key),
#        slice(out_row, n, params) -> unpadded answer)
_OPS = {
    "resample_poly": (_validate_resample, _slice_resample),
    "sosfilt": (_validate_sosfilt, _slice_rows),
    "lfilter": (_validate_lfilter, _slice_rows),
    "stft": (_validate_stft, _slice_stft),
}

SUPPORTED_OPS = tuple(sorted(_OPS))


def classify_request(op: str, x, params: dict):
    """Shared shape-class derivation — the ONE home of the ``(op,
    param-key, bucket)`` triple that keys a batch's compiled handle
    AND its circuit breaker, used by :meth:`Server.submit` and by the
    front router's placement scoring (which must read exactly the key
    the replica's dispatch will breaker on, or per-class
    deprioritization silently stops matching).  Returns ``(xarr, n,
    canonical_params, key)``; ``canonical_params`` is None for
    pipeline ops (the server builds the state-carrying params
    itself, and a pipeline invocation's block length IS its class —
    no pad-to-bucket).  Malformed requests raise ValueError."""
    xarr = np.asarray(x, np.float32)
    if xarr.ndim != 1 or xarr.shape[0] == 0:
        raise ValueError(
            f"requests carry one 1-D signal, got shape "
            f"{xarr.shape}")
    n = int(xarr.shape[0])
    if op.startswith("pipeline:"):
        return xarr, n, None, (op, (), n)
    if op not in _OPS:
        raise ValueError(
            f"unsupported op {op!r} "
            f"(supported: {', '.join(SUPPORTED_OPS)})")
    validate, _ = _OPS[op]
    cparams, param_key = validate(params, n)
    if op == "stft" and ragged_enabled() and n <= ragged_max():
        # one sample-axis-packed class per (op, params): variable
        # SHORT lengths co-pack into shared rows (ops/segments.py)
        # instead of each padding to its own pow2 bucket, so the
        # bucket slot of the key is the literal class tag "ragged";
        # longer requests fall through to plain bucket classing
        return xarr, n, cparams, (op, param_key, "ragged")
    return xarr, n, cparams, (op, param_key, bucket_length(n))


def _device_call(op: str, xs, params: dict, donate: bool):
    """The device dispatch for one padded host batch — always invoked
    inside a ``faults.guarded`` thunk (lint-enforced), so transient
    faults ride the retry/degrade policy.  Returns one tensor on the
    configured device (an ``stft`` batch the fused kernel admits is
    one launch of it)."""
    if op == "resample_poly":
        return batched.batched_resample_poly(
            xs, params["up"], params["down"], simd=True, donate=donate)
    if op == "sosfilt":
        return batched.batched_sosfilt(params["sos"], xs, simd=True,
                                       donate=donate)
    if op == "lfilter":
        return batched.batched_lfilter(params["b"], params["a"], xs,
                                       simd=True, donate=donate)
    if op == "stft":
        return batched.batched_stft(xs, params["frame_length"],
                                    params["hop"], simd=True)
    raise ValueError(f"unsupported op {op!r}")


def _oracle_call(op: str, xs, params: dict):
    """The NumPy oracle twin of :func:`_device_call` (``simd=False``)
    — the DEGRADED-mode answer path; cannot fault."""
    if op == "resample_poly":
        return batched.batched_resample_poly(
            xs, params["up"], params["down"], simd=False)
    if op == "sosfilt":
        return batched.batched_sosfilt(params["sos"], xs, simd=False)
    if op == "lfilter":
        return batched.batched_lfilter(params["b"], params["a"], xs,
                                       simd=False)
    if op == "stft":
        return batched.batched_stft(xs, params["frame_length"],
                                    params["hop"], simd=False)
    raise ValueError(f"unsupported op {op!r}")


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


class _CaptureGate:
    """Keeps a CUDA-graph capture exclusive of the process's other
    serving device work.  ``torch.cuda.graph`` captures in ``global``
    mode: a ``cudaMalloc`` or a synchronous copy on any thread of the
    process while it captures fails, and the capture with it.  So
    there is one gate a process (:data:`_GATE`), held by every
    :class:`Server` in it: the replicas of a thread-mode
    ``serve.cluster.ReplicaGroup`` share one compiled pipeline, and
    one replica's capture must not meet another's copy back.  Every
    device section (a plain or ragged batch through its copy back, a
    pipeline batch whose class is captured) holds the gate
    :meth:`shared`; a pipeline batch that will capture holds it
    :meth:`exclusive`, which waits for the shared holders to leave and
    keeps new ones out until the capture is done.  A waiting capture
    bars new shared holders, so busy servers cannot starve it."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0
        self._capturing = False

    @contextlib.contextmanager
    def shared(self):
        with self._cond:
            while self._capturing:
                self._cond.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cond:
                self._shared -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cond:
            while self._capturing:
                self._cond.wait()
            self._capturing = True
            while self._shared:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._capturing = False
                self._cond.notify_all()


# the process's one capture gate (global capture mode spans threads)
_GATE = _CaptureGate()


class Server:
    """Deadline-batched, admission-controlled, fault-tolerant serving
    loop over the batched op families (module docstring has the full
    story).  Use as a context manager, or :meth:`start` /
    :meth:`stop` explicitly."""

    def __init__(self, *, max_batch: int | None = None,
                 max_wait_ms: float | None = None,
                 queue_depth: int | None = None,
                 tenant_depth: int | None = None,
                 workers: int = DEFAULT_WORKERS,
                 probe_every: int = DEFAULT_PROBE_EVERY,
                 donate: bool = False,
                 obs_port: int | None = None,
                 name: str | None = None):
        # ``name`` is the replica identity (serve/cluster.py): a named
        # server's breakers are keyed (name, *shape-class) so N
        # in-process replicas keep INDEPENDENT per-class breakers in
        # the shared registry — the front router's per-replica
        # deprioritization signal.  Unnamed (single-server) keys are
        # unchanged.
        self.name = None if name is None else str(name)
        max_wait_s = (None if max_wait_ms is None
                      else float(max_wait_ms) / 1e3)
        self._batcher = Batcher(max_batch, max_wait_s,
                                on_expired=self._expire_items)
        self._admission = AdmissionController(queue_depth,
                                              tenant_depth)
        self._health = HealthMonitor(probe_every, name=self.name)
        self.workers = int(workers)
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        self.donate = bool(donate)
        # the live scrape endpoint (obs/http.py): obs_port= here
        # (0 = ephemeral — the test idiom; negative = explicitly
        # disarmed even when the env var is set), or None to defer to
        # $VELES_SIMD_OBS_PORT at start() (unset = disarmed);
        # .obs_port holds the bound port
        self._obs_port_arg = obs_port
        self._endpoint = None
        self._gate = _GATE
        self._pipelines: dict = {}
        self._threads: list = []
        self._stats_lock = threading.Lock()
        self._batch_seq = 0
        self._stats = {"submitted": 0, "completed": 0, "shed": 0,
                       "degraded_answers": 0, "errors": 0,
                       "expired": 0, "breaker_shed": 0,
                       "batches": 0, "batched_requests": 0,
                       "useful_rows": 0, "dispatched_rows": 0,
                       "refilled_rows": 0,
                       "useful_samples": 0, "dispatched_samples": 0}
        # cumulative (useful, dispatched) row tallies per (op, shape
        # class) — the goodput denominators behind the serve.goodput /
        # serve.padding_waste gauges (obs v5, ROADMAP item 3's
        # padding-waste baseline)
        self._goodput: dict = {}
        # the sample-axis twin: (useful, dispatched) SAMPLE tallies
        # per (op, shape class) — rows miss the waste *inside* a row
        # (a 513-sample request in a 1024 bucket is half padding), so
        # the goodput bench family gates on samples, not rows
        self._goodput_samples: dict = {}
        self._started = False
        self._stopped = False
        # the warm-pack preload report: set by start() (or
        # _warm_pack()) when the artifact store is armed, else None
        self._preload = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Server":
        """Spawn the worker pool and (when armed via ``obs_port=`` or
        ``$VELES_SIMD_OBS_PORT``; a negative ``obs_port=`` disarms
        even with the env var set) the live scrape endpoint
        (idempotent).  With ``$VELES_SIMD_ARTIFACTS`` arming the
        artifact store, the warm pack is preloaded (:meth:`_warm_pack`)
        before any worker runs."""
        if self._stopped:
            raise ServerClosed("server already stopped")
        if self._started:
            return self
        # the endpoint arms FIRST, before anything else starts: a bind
        # failure (port in use) must raise out of a server with no
        # workers running and _started still False — never a
        # half-started server the idempotence guard would then treat
        # as fully started
        if self._obs_port_arg is not None and self._obs_port_arg < 0:
            self._endpoint = None       # explicit disarm beats env
        else:
            self._endpoint = obs_http.start(self._obs_port_arg,
                                            health=self.stats,
                                            submit=self._rpc_submit)
        self._started = True
        self._warm_pack()
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"veles-serve-worker-{i}")
            t.start()
            self._threads.append(t)
        if self._endpoint is not None:
            obs.record_decision("serve_obs_endpoint", "armed",
                                port=self._endpoint.port)
        # lifecycle edge — journaled when the history axis is armed,
        # so a subprocess replica's own journal file opens with its
        # birth (and obs_query can bracket its story)
        obs.record_decision("serve_lifecycle", "start",
                            workers=self.workers,
                            max_batch=self.max_batch,
                            obs_port=self.obs_port,
                            **({"replica": self.name}
                               if self.name else {}))
        # same label shape as the health machine's trip/recover
        # updates: a named replica's gauge series must be the one its
        # degrade flips, or a dashboard watching it never sees the
        # transition
        obs.gauge("serve_healthy", 1.0,
                  **({"replica": self.name} if self.name else {}))
        return self

    def _warm_pack(self) -> dict | None:
        """Preload the armed artifact store's warm pack once
        (:func:`~veles.simd_tpu_torch.runtime.artifacts.preload`: the
        packed kernel library placed under the build root, so its first
        load runs no nvcc); returns the report, None while the store is
        off.  :meth:`start` calls it; a subprocess replica calls it
        before it loads the library.  Best effort: a failed preload
        counts ``artifact_preload_error`` and the server starts
        cold."""
        if self._preload is None and _artifacts.artifacts_mode() != "off":
            try:
                self._preload = _artifacts.preload()
            except Exception:  # noqa: BLE001 — never block startup
                obs.count("artifact_preload_error")
        return self._preload

    @property
    def obs_port(self) -> int | None:
        """The scrape endpoint's bound port (None while disarmed)."""
        return self._endpoint.port if self._endpoint else None

    def _rpc_submit(self, body: bytes) -> tuple:
        """The endpoint's ``POST /submit`` handler: one npy-framed
        request body in, ``(http_code, response_bytes)`` out — the RPC
        data plane (:func:`veles.simd_tpu_torch.serve.rpc.serve_submit`
        owns the wire contract; imported lazily, the rpc module imports
        this one)."""
        from veles.simd_tpu_torch.serve import rpc

        return rpc.serve_submit(self, body)

    def stop(self, drain: bool = True) -> None:
        """Close the intake and join the workers.  ``drain=True``
        (default) answers everything already queued first;
        ``drain=False`` fails queued requests with
        :class:`ServerClosed` — *answered typed, never abandoned*:
        every ticket still completes (closing its request trace with a
        terminal edge, so ``zero_orphaned_traces`` holds outside chaos
        campaigns too) and its admission slot is released."""
        self._stopped = True
        if not drain:
            # workers see _abandoned and complete without dispatching
            self._abandoned = True
        self._batcher.close()
        for t in self._threads:
            t.join()
        self._threads = []
        # the abandonment sweep: anything STILL queued after the
        # workers exit (a server stopped before start(), or a worker
        # that died mid-outage) must close its causal chain — a queued
        # ticket the stop path forgets is a lost request and an
        # orphaned trace, the exact invariants the accounting gates
        while True:
            got = self._batcher.next_batch()
            if got is None:
                break
            for p in got[1]:
                if not p.ticket.done():
                    p.ticket._complete(
                        error=ServerClosed(
                            "server stopped before dispatch"),
                        status="closed")
                self._release(p)
        if self._endpoint is not None:
            self._endpoint.stop()
            self._endpoint = None
        # the matching lifecycle edge: a drained stop and an abrupt
        # one read differently in a postmortem
        obs.record_decision("serve_lifecycle", "stop",
                            drain=bool(drain),
                            **({"replica": self.name}
                               if self.name else {}))

    _abandoned = False

    def register_pipeline(self, name: str, compiled) -> str:
        """Register a compiled pipeline
        (:class:`veles.simd_tpu_torch.pipeline.CompiledPipeline`) as a
        servable unit; returns its op string ``"pipeline:<name>"``.
        Requests under that op carry one ``compiled.block_len``-sample
        block plus the stream's carried state (``params["state"]``,
        None for a fresh stream) and are answered with ``(out,
        new_state)``."""
        from veles.simd_tpu_torch.pipeline import CompiledPipeline

        if not isinstance(compiled, CompiledPipeline):
            raise TypeError("register_pipeline needs a "
                            "CompiledPipeline (Pipeline.compile(...))")
        name = str(name)
        if not name or ":" in name:
            raise ValueError(f"bad pipeline name {name!r}")
        self._pipelines[name] = compiled
        obs.record_decision("serve_pipeline", "registered",
                            pipeline=name,
                            block=compiled.block_len)
        return f"pipeline:{name}"

    def pipeline(self, name: str):
        """The registered compiled pipeline, or KeyError."""
        return self._pipelines[name]

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop(drain=exc_type is None)
        return False

    # -- intake ------------------------------------------------------------

    def submit(self, request: Request | None = None, *,
               op: str | None = None, x=None, params: dict | None = None,
               tenant: str = "default", block: bool = False,
               timeout: float | None = None,
               deadline_ms: float | None = None) -> Ticket:
        """Queue one request; returns its :class:`Ticket`.

        Admission rejections complete the ticket immediately with a
        typed :class:`Overloaded` (``status="shed"``) — pass
        ``block=True`` (+ ``timeout``) for backpressure instead of
        shedding.  ``deadline_ms`` (or ``request.deadline_ms``, or the
        ``VELES_SIMD_SERVE_DEADLINE_MS`` default) stamps an absolute
        end-to-end deadline at admission: the request is answered
        within it or shed with a typed :class:`DeadlineExceeded`
        before dispatch.  Malformed requests raise ValueError
        synchronously (a caller bug, not traffic)."""
        if request is None:
            request = Request(op=op, x=x, params=params or {},
                              tenant=tenant, deadline_ms=deadline_ms)
        elif deadline_ms is not None:
            request = dataclasses.replace(request,
                                          deadline_ms=deadline_ms)
        pipe = None
        if request.op.startswith("pipeline:"):
            pipe = self._pipelines.get(request.op.split(":", 1)[1])
            if pipe is None:
                raise ValueError(
                    f"unregistered pipeline op {request.op!r} "
                    f"(registered: "
                    f"{sorted(self._pipelines) or 'none'})")
        xarr, n, cparams, key = classify_request(
            request.op, request.x, request.params)
        if pipe is not None:
            if n != pipe.block_len:
                raise ValueError(
                    f"pipeline {request.op!r} invocations carry "
                    f"exactly one {pipe.block_len}-sample block, "
                    f"got {n}")
            # the stream's carried state rides the params (None =
            # fresh stream); validated NOW so a malformed state fails
            # its own caller synchronously, never a co-batched stream
            state = request.params.get("state")
            if state is not None:
                pipe.check_state(state)
            cparams = {"state": state}
        if self._stopped:
            raise ServerClosed("server is stopped")
        ticket = Ticket(request.op, request.tenant)
        dl_ms = request.deadline_ms
        if dl_ms is None:
            dl_ms = env_deadline_ms()
        has_deadline = dl_ms is not None and dl_ms > 0
        nb = key[2]
        # the request axis: minted BEFORE admission so a shed request
        # still closes a causal chain; carried across threads on the
        # ticket, finished by Ticket._complete whatever the outcome
        ticket.trace = obs.request_trace(
            request.op, tenant=request.tenant, shape_class=nb,
            deadline_s=(float(dl_ms) / 1e3 if has_deadline else None))
        try:
            depth, tenant_depth = self._admission.admit(
                request.tenant, block=block, timeout=timeout)
        except Overloaded as e:
            with self._stats_lock:
                self._stats["shed"] += 1
            ticket._complete(error=e, status="shed")
            return ticket
        ticket.trace.event("admitted", depth=depth,
                           tenant_depth=tenant_depth)
        now = faults.monotonic()
        deadline = now + float(dl_ms) / 1e3 if has_deadline else None
        pend = _Pending(ticket, xarr, n, cparams, now,
                        deadline=deadline)
        # the bucketed edge is recorded BEFORE the put: the moment the
        # item is in the batcher a worker may form the batch, and its
        # batch_formed edge must never precede this one (the traces'
        # causal-order invariant)
        ticket.trace.event("bucketed", bucket=nb)
        try:
            self._batcher.put(key, pend)
        except RuntimeError:
            # raced stop(): hand the slot back and answer typed
            self._admission.release(request.tenant)
            ticket._complete(error=ServerClosed("server is stopped"),
                             status="closed")
            return ticket
        with self._stats_lock:
            self._stats["submitted"] += 1
        obs.count("serve_submitted", op=request.op,
                  tenant=request.tenant)
        return ticket

    # -- the worker loop ---------------------------------------------------

    def _worker(self) -> None:
        while True:
            got = self._batcher.next_batch()
            if got is None:
                return
            key, batch = got
            try:
                self._run_batch(key, batch)
            except Exception as e:  # noqa: BLE001 — never lose a batch
                # a non-transient dispatch bug must answer every
                # ticket (typed), release admission, and keep the
                # worker alive for the next batch
                obs.count("serve_batch_error", op=key[0])
                errored = 0
                for p in batch:
                    if not p.ticket.done():
                        p.ticket._complete(error=e, status="error")
                        errored += 1
                    self._release(p)
                # rows answered before the exception already counted
                # themselves as completed; only the ones THIS handler
                # failed are errors — submitted/completed/errors must
                # reconcile with ticket outcomes
                with self._stats_lock:
                    self._stats["errors"] += errored

    def _release(self, pend: _Pending) -> None:
        """Free ``pend``'s admission slot exactly once."""
        if not pend.released:
            pend.released = True
            self._admission.release(pend.ticket.tenant)

    def _expire_items(self, items) -> None:
        """Answer expired requests with a typed
        :class:`DeadlineExceeded` (the batcher's ``on_expired`` path
        and the pre-dispatch sweep) — stale work never dispatches."""
        now = faults.monotonic()
        for p in items:
            if p.ticket.done():
                continue
            late_ms = (now - p.deadline) * 1e3 \
                if p.deadline is not None else 0.0
            # the terminal trace edge (and the serve_deadline_miss /
            # serve_completed counters) flow through Ticket._complete
            # -> trace.finish — the request-trace API owns terminal
            # accounting (tools/lint.py request-trace rule)
            p.ticket._complete(
                error=DeadlineExceeded(
                    f"DEADLINE_EXCEEDED: request {p.ticket.op!r} "
                    f"missed its end-to-end deadline by "
                    f"{late_ms:.1f} ms before dispatch"),
                status="expired")
            self._release(p)
            with self._stats_lock:
                self._stats["expired"] += 1

    def _run_batch(self, key, batch) -> None:
        op, _, nb = key
        if self._abandoned:
            for p in batch:
                p.ticket._complete(
                    error=ServerClosed("server stopped before "
                                       "dispatch"),
                    status="closed")
                self._release(p)
            return
        # last line of defense against stale work: anything that
        # expired between the batcher's shed sweep and here is
        # answered typed, never dispatched — and the survivors'
        # remaining budget clips the guarded retry loop below
        now = faults.monotonic()
        expired = [p for p in batch
                   if p.deadline is not None and now >= p.deadline]
        if expired:
            self._expire_items(expired)
            batch = [p for p in batch
                     if p.deadline is None or now < p.deadline]
            if not batch:
                return
        batch = self._refill(key, batch, now)
        budget_s = None
        for p in batch:
            if p.deadline is not None:
                slack = p.deadline - now
                obs.observe("serve.deadline_slack", slack, op=op)
                if budget_s is None or slack < budget_s:
                    budget_s = slack
        if op.startswith("pipeline:"):
            self._run_pipeline_batch(op, batch, nb, budget_s)
            return
        if nb == "ragged":
            self._run_ragged_batch(op, key, batch, budget_s)
            return
        rows = len(batch)
        # row-pad to the power-of-two class so occupancy churn shares
        # compiled handles instead of minting one per batch size
        rpad = bucket_length(rows)
        self._note_batch_formed(batch, rpad)
        xs = np.zeros((rpad, nb), np.float32)
        for i, p in enumerate(batch):
            xs[i, :p.n] = p.x
        params = batch[0].params
        with self._gate.shared():
            with obs.span("serve.dispatch", op=op, rows=rpad, n=nb):
                ys, degraded = self._dispatch(
                    op, key, xs, params, budget_s,
                    traces=[p.ticket.trace for p in batch])
            # the whole batch comes to the host in one copy (the device
            # path's answer is one tensor on the card), before any
            # ticket completes: the traces' device phase ends here
            ys = _platform.to_host(ys)
        _, slicer = _OPS[op]
        self._finish_batch(
            op, batch,
            lambda i, p: slicer(ys[i], p.n, p.params), degraded,
            rpad=rpad, nb=nb)

    def _refill(self, key, batch, now: float):
        """Continuous batching: top an under-full batch up from its
        own shape class's queue at dispatch time.  The batch is
        row-padded to its pow2 class anyway — every slot below
        ``bucket_length(rows)`` was about to dispatch as a zero row,
        so a queued same-class request riding it costs nothing and
        skips its remaining batching wait (an Orca-style slot refill
        at fused-dispatch grain: the op families dispatch whole
        batches, so the refill point is batch formation, not
        mid-flight row completion).  Refilled rows keep their own
        trace chain — ``batch_formed`` tags them ``refilled`` and
        they share the batch's ``dispatched``/terminal edges, so
        phases still sum."""
        if not continuous_enabled():
            return batch
        op, _, nb = key
        free = min(bucket_length(len(batch)),
                   self._batcher.max_batch) - len(batch)
        if free <= 0:
            return batch
        taken = self._batcher.take_refill(key, free, now)
        if not taken:
            return batch
        for p in taken:
            p.refilled = True
        obs.count("serve_refilled_rows", len(taken), op=op, bucket=nb)
        with self._stats_lock:
            self._stats["refilled_rows"] += len(taken)
        return batch + taken

    def _note_batch_formed(self, batch, rpad: int,
                           rows_used: int | None = None) -> None:
        """The ``batch_formed`` trace edge for every co-batched
        request: shared batch id, co-batched count, and the padding
        rows the pow2 row class added.  ``rows_used`` overrides the
        used-row count when it differs from the request count (the
        ragged path packs several requests per row).  A row taken by
        the continuous-batching refill carries ``refilled=True`` —
        its edge is its own (phase sums stay exact), the tag is how
        the trace tells a slot-refilled row from a founding one."""
        with self._stats_lock:
            bid = self._batch_seq
            self._batch_seq += 1
        rows = len(batch)
        used = rows if rows_used is None else rows_used
        for p in batch:
            p.ticket.trace.event("batch_formed", batch=bid,
                                 co_batched=rows,
                                 padding_rows=rpad - used,
                                 **({"refilled": True} if p.refilled
                                    else {}))

    def _finish_batch(self, op: str, batch, value_for,
                      degraded, *, rpad: int | None = None,
                      nb=None, useful_rows: int | None = None,
                      useful_samples: int | None = None,
                      dispatched_samples: int | None = None) -> None:
        """Complete every ticket + the shared batch accounting — ONE
        home for the plain-op, pipeline, and ragged batch paths.
        ``value_for(i, pending)`` builds row ``i``'s answer; it is
        called per-row, not bulk-at-the-end, so a value-build failure
        midway leaves the tally matching the tickets actually
        answered (the worker's handler counts the rest as errors).
        ``degraded`` is a bool for whole-batch fates or a per-request
        flag sequence (the ragged path's per-segment fault isolation:
        one poisoned segment degrades its own ticket only).  ``rpad``
        (the pow2-padded row count actually dispatched) and ``nb``
        (the shape class) feed the goodput accounting: the
        ``serve_padding_rows`` / ``serve_useful_rows`` /
        ``serve_dispatched_rows`` counters and the cumulative
        ``serve.goodput`` / ``serve.padding_waste`` gauges per (op,
        shape class) — plus the SAMPLE-axis twins
        (``serve_useful_samples`` / ``serve_dispatched_samples``,
        ``serve.sample_goodput`` / ``serve.sample_waste``), which see
        the waste *inside* a row that row counts miss (bucket padding
        along the signal axis — what ragged packing recovers).
        ``useful_samples``/``dispatched_samples`` override the
        derived fixed-bucket arithmetic for packed dispatches.  These
        are metric-axis writes, NOT request-axis ones — they keep
        recording under ``configure(request_axis=False)``, so padding
        waste stays visible with tracing load-shed."""
        now = faults.monotonic()
        rows = len(batch)
        flags = (list(degraded)
                 if isinstance(degraded, (list, tuple))
                 else [bool(degraded)] * rows)
        for i, p in enumerate(batch):
            wait = now - p.enq
            # the serve.request_latency{op, status} sample and the
            # serve_completed counter flow through Ticket._complete ->
            # trace.finish — one terminal-accounting home, every
            # status included (the survivorship-bias fix)
            p.ticket._complete(
                value=value_for(i, p),
                status="degraded" if flags[i] else "ok", wait_s=wait)
            self._release(p)
            with self._stats_lock:
                self._stats["completed"] += 1
                if flags[i]:
                    self._stats["degraded_answers"] += 1
        obs.observe("serve.batch_fill",
                    rows / self._batcher.max_batch, op=op)
        obs.count("serve_batches", op=op)
        with self._stats_lock:
            self._stats["batches"] += 1
            self._stats["batched_requests"] += rows
        if rpad is not None and rpad > 0:
            # the shape-class label is ``bucket`` (the pow2 class the
            # request length padded to) — NOT ``n``, which collides
            # with obs.count's increment parameter.  ``useful_rows``
            # overrides the request count when requests and rows
            # differ (the ragged path packs several requests per row;
            # its row efficiency is used-rows over pow2-padded rows)
            ur = rows if useful_rows is None else useful_rows
            obs.count("serve_padding_rows", rpad - ur,
                      op=op, bucket=nb)
            obs.count("serve_useful_rows", ur, op=op, bucket=nb)
            obs.count("serve_dispatched_rows", rpad, op=op, bucket=nb)
            with self._stats_lock:
                tally = self._goodput.setdefault((op, nb), [0, 0])
                tally[0] += ur
                tally[1] += rpad
                goodput = tally[0] / tally[1]
                self._stats["useful_rows"] += ur
                self._stats["dispatched_rows"] += rpad
            obs.gauge("serve.goodput", goodput, op=op, bucket=nb)
            obs.gauge("serve.padding_waste", 1.0 - goodput,
                      op=op, bucket=nb)
            if useful_samples is None and isinstance(nb, int):
                # fixed-bucket dispatch: every row is nb samples wide,
                # the useful part is each request's true length
                useful_samples = sum(p.n for p in batch)
                dispatched_samples = rpad * nb
            if useful_samples is not None and dispatched_samples:
                obs.count("serve_useful_samples", useful_samples,
                          op=op, bucket=nb)
                obs.count("serve_dispatched_samples",
                          dispatched_samples, op=op, bucket=nb)
                with self._stats_lock:
                    st = self._goodput_samples.setdefault(
                        (op, nb), [0, 0])
                    st[0] += useful_samples
                    st[1] += dispatched_samples
                    sample_goodput = st[0] / st[1]
                    self._stats["useful_samples"] += useful_samples
                    self._stats["dispatched_samples"] += \
                        dispatched_samples
                obs.gauge("serve.sample_goodput", sample_goodput,
                          op=op, bucket=nb)
                obs.gauge("serve.sample_waste", 1.0 - sample_goodput,
                          op=op, bucket=nb)

    def _run_pipeline_batch(self, op: str, batch, nb: int,
                            budget_s: float | None) -> None:
        """One batch of PIPELINE invocations: stack blocks + carried
        states into one fused step dispatch through the pipeline's
        own per-class breaker (``pipeline.dispatch``), then hand each
        stream back its ``(out, new_state)``.  Rides the same
        admission/deadline machinery as plain ops; degradation is the
        stage-by-stage oracle twin, so a degraded block keeps the
        stream's state exact."""
        compiled = self._pipelines[op.split(":", 1)[1]]
        rows = len(batch)
        rpad = bucket_length(rows)
        self._note_batch_formed(batch, rpad)
        xs = np.zeros((rpad, nb), np.float32)
        for i, p in enumerate(batch):
            xs[i] = p.x
        states = compiled.batch_states(
            [p.params.get("state") for p in batch], rpad)
        traces = [p.ticket.trace for p in batch]
        for tr in traces:
            tr.event("dispatched", route="pipeline",
                     breaker="composed")
        # a row class's first batch on the card captures its graph:
        # exclusive of every other device section of this server
        gate = (self._gate.exclusive() if compiled.captures(xs.shape)
                else self._gate.shared())
        with gate:
            with obs.span("serve.dispatch", op=op, rows=rpad, n=nb):
                out, new_state, degraded = compiled.serve_step(
                    xs, states, budget_s=budget_s,
                    on_fault=self._batch_fault_hook(traces))
            # one copy back per output and state leaf, not per row
            outs = compiled.out_rows(out, rows)
            state_rows = compiled.state_rows(new_state, rows)
        if degraded:
            obs.count("serve_degraded_batch", op=op)
            for tr in traces:
                # belt and braces: the on_fault hook records the
                # guarded degrade; a degraded batch whose edge was
                # somehow skipped must still carry one (the chaos
                # invariant: every degraded ticket has a degrade edge)
                if not any(e["event"] == "degraded"
                           for e in tr.events()):
                    tr.event("degraded", to="oracle",
                             reason="pipeline")
        self._finish_batch(
            op, batch, lambda i, p: (outs[i], state_rows[i]),
            degraded, rpad=rpad, nb=nb)

    def _run_ragged_batch(self, op: str, key, batch,
                          budget_s: float | None) -> None:
        """One batch of a RAGGED shape class (``VELES_SIMD_SERVE_RAGGED``
        — stft today): variable-length requests co-pack along the
        sample axis into shared rows (:mod:`veles.simd_tpu_torch.ops.
        segments`) instead of each zero-padding to its own pow2
        bucket, so the dispatched-sample denominator shrinks to the
        packed plan's footprint.  Fault policy lives INSIDE the packed
        dispatch: ``segments.dispatch`` carries this replica's
        shape-class breaker (``breaker_key`` — NOT ``serve.dispatch``,
        the packed fallback is per-segment salvage rather than a
        whole-batch oracle), and one poisoned segment degrades only
        its own ticket.  The global health machine is still honored:
        a DEGRADED server answers ragged batches from the per-segment
        oracle too, and ragged probes feed the same trip/recover
        edges."""
        rows = len(batch)
        params = batch[0].params
        fl, hop = params["frame_length"], params["hop"]
        traces = [p.ticket.trace for p in batch]
        segs = [p.x for p in batch]
        # the packed plan is deterministic — recompute it here for the
        # goodput denominators (EXACT rows the plan needs times the
        # common packed width: packing's whole point is a truthful
        # dispatched footprint, so no pow2 row padding here)
        strides = [_segments.stft_stride(p.n, hop) for p in batch]
        width, packed_rows, _ = _segments.plan_pack(strides)
        rpad = packed_rows
        self._note_batch_formed(batch, rpad, rows_used=packed_rows)
        probe = False
        if self._health.degraded:
            probe = self._health.note_degraded_batch()
            if not probe:
                obs.count("serve_degraded_batch", op=op)
                for tr in traces:
                    tr.event("dispatched", route="oracle",
                             breaker="bypassed", health="degraded")
                    tr.event("degraded", to="oracle",
                             reason="health_degraded")
                outs, _ = _segments.packed_stft(segs, fl, hop,
                                                simd=False)
                self._finish_batch(
                    op, batch, lambda i, p: outs[i], True,
                    rpad=rpad, nb="ragged", useful_rows=packed_rows,
                    useful_samples=sum(p.n for p in batch),
                    dispatched_samples=rpad * width)
                return
        for tr in traces:
            tr.event("dispatched", route="ragged",
                     breaker="segments", probe=probe)
        # packed_stft answers host rows (one copy of the packed batch)
        with self._gate.shared(), \
                obs.span("serve.dispatch", op=op, rows=rpad, n=width,
                         route="ragged"):
            outs, flags = _segments.packed_stft(
                segs, fl, hop, simd=True,
                key=self.breaker_key(key), budget_s=budget_s,
                on_fault=self._batch_fault_hook(traces))
        if any(flags):
            obs.count("serve_degraded_batch", op=op)
        if probe:
            # mirror _dispatch's probe outcome wiring so a ragged-only
            # server still recovers (or re-trips) its health machine
            if any(flags):
                self._health.trip("serve.dispatch")
            else:
                self._health.recover("serve.dispatch")
        self._finish_batch(
            op, batch, lambda i, p: outs[i], flags,
            rpad=rpad, nb="ragged", useful_rows=packed_rows,
            useful_samples=sum(p.n for p in batch),
            dispatched_samples=rpad * width)

    @staticmethod
    def _batch_fault_hook(traces):
        """The ``faults.guarded`` fault observer for one batch: every
        retry/degrade of the shared dispatch is an edge on EVERY
        co-batched request's trace (the fate of a batch is the fate of
        each request riding it)."""
        def on_fault(action: str, kind: str, attempt: int) -> None:
            for tr in traces:
                if action == "retry":
                    tr.event("retried", kind=kind, attempt=attempt)
                else:
                    tr.event("degraded", to="oracle", reason=kind)
        return on_fault

    def _dispatch(self, op: str, key, xs, params: dict,
                  budget_s: float | None = None,
                  traces=()) -> tuple:
        """One batch through the health machine + the shape class's
        circuit breaker + the fault policy; returns ``(outputs,
        degraded)``.  ``traces`` are the co-batched requests' traces:
        the chosen route + breaker state land as each one's
        ``dispatched`` edge, and retry/degrade outcomes append through
        :meth:`_batch_fault_hook`.

        The breaker (keyed by the batch's shape class) composes
        *under* the health machine: an open breaker answers ITS class
        via the oracle without touching global health — one poisoned
        class must not drag healthy siblings onto the oracle — and
        only a fresh failure on a closed breaker trips the global
        DEGRADED mode.  Breaker probe failures reopen the breaker
        silently (the class was already known-bad)."""
        probe = False
        if self._health.degraded:
            probe = self._health.note_degraded_batch()
            if not probe:
                obs.count("serve_degraded_batch", op=op)
                for tr in traces:
                    tr.event("dispatched", route="oracle",
                             breaker="bypassed", health="degraded")
                    tr.event("degraded", to="oracle",
                             reason="health_degraded")
                return _oracle_call(op, xs, params), True
        br = _breaker.breaker_for("serve.dispatch",
                                  self.breaker_key(key))
        # a health-machine probe batch outranks the breaker's
        # short-circuit (a one-class server would otherwise stay
        # DEGRADED until the breaker's own cadence probed)
        verdict = br.admit(force_probe=probe)
        if verdict == _breaker.OPEN:
            obs.count("serve_breaker_shed", op=op)
            obs.count("serve_degraded_batch", op=op)
            with self._stats_lock:
                self._stats["breaker_shed"] += 1
            for tr in traces:
                tr.event("dispatched", route="oracle", breaker="open")
                tr.event("degraded", to="oracle",
                         reason="breaker_open")
            return _oracle_call(op, xs, params), True
        for tr in traces:
            tr.event("dispatched", route="device", breaker=verdict,
                     probe=probe)
        box = {"tripped": False}
        donate = self.donate

        def thunk():
            return _device_call(op, xs, params, donate)

        def fallback():
            box["tripped"] = True
            if verdict == _breaker.CLOSED:
                self._health.trip("serve.dispatch")
            obs.count("serve_degraded_batch", op=op)
            return _oracle_call(op, xs, params)

        zero_retry = probe or verdict != _breaker.CLOSED
        ys = faults.guarded("serve.dispatch", thunk,
                            fallback=fallback, fallback_name="oracle",
                            retries=(0 if zero_retry else None),
                            budget_s=budget_s, breaker=br,
                            subsite=op,
                            on_fault=self._batch_fault_hook(traces))
        if not box["tripped"] and probe:
            self._health.recover("serve.dispatch")
        return ys, box["tripped"]

    # -- introspection -----------------------------------------------------

    def breaker_key(self, key) -> tuple:
        """The registry key of this server's breaker for shape class
        ``key``: the class triple itself, prefixed with the server's
        replica ``name`` when one was given — N named in-process
        replicas share the process-global breaker registry, so the
        name is what keeps their per-class breakers independent (and
        lets the front router read ONE replica's state)."""
        return key if self.name is None else (self.name,) + tuple(key)

    def depth(self) -> int:
        """Requests currently admitted (queued or in flight) — the
        front router's least-loaded placement signal."""
        return self._admission.depth()

    def open_occupancy(self, key) -> int:
        """Requests currently queued in shape class ``key``'s bucket
        — the front router's padding-aware placement signal: a
        replica with a forming batch of this class completes it (the
        new request rides a padding slot), one without opens a fresh
        batch that will pad.  Reads the batcher's per-class queue
        depth; 0 when no batch of this class is forming."""
        return self._batcher.depth_for(key)

    def occupancy(self) -> int:
        """Total rows queued in forming batches across every shape
        class (the fleet collector's per-replica ``occupancy``
        series)."""
        return self._batcher.pending()

    @property
    def max_batch(self) -> int:
        """The batcher's row-class ceiling (scales the router's
        occupancy score term)."""
        return self._batcher.max_batch

    def counts(self) -> dict:
        """Cheap copy of the raw request tallies (one lock, no
        registry walk) — the fleet collector's per-tick read; the
        full story lives in :meth:`stats`."""
        with self._stats_lock:
            return dict(self._stats)

    def goodput(self) -> dict:
        """Cumulative batch-occupancy efficiency per (op, shape
        class): ``{"op|class": {"useful_rows", "dispatched_rows",
        "goodput"}}`` plus an ``"overall"`` roll-up (None goodput =
        no batch dispatched yet).  Useful rows are real request rows;
        dispatched rows include the pow2 row padding — the gap IS
        ROADMAP item 3's padding waste, measured."""
        with self._stats_lock:
            per = {
                f"{op}|{nb}": {"useful_rows": u, "dispatched_rows": d,
                               "goodput": (u / d) if d else None}
                for (op, nb), (u, d) in sorted(
                    self._goodput.items(), key=lambda kv: (
                        kv[0][0], str(kv[0][1])))}
            for (op, nb), (u, d) in self._goodput_samples.items():
                entry = per.setdefault(f"{op}|{nb}", {})
                entry["useful_samples"] = u
                entry["dispatched_samples"] = d
                entry["sample_goodput"] = (u / d) if d else None
            useful = self._stats["useful_rows"]
            dispatched = self._stats["dispatched_rows"]
            su = self._stats["useful_samples"]
            sd = self._stats["dispatched_samples"]
        per["overall"] = {
            "useful_rows": useful, "dispatched_rows": dispatched,
            "goodput": (useful / dispatched) if dispatched else None,
            "useful_samples": su, "dispatched_samples": sd,
            "sample_goodput": (su / sd) if sd else None}
        return per

    @property
    def health(self) -> str:
        """Current health state (``healthy`` / ``degraded``)."""
        return self._health.state

    def stats(self) -> dict:
        """JSON-native snapshot: request tallies, admission depths,
        batcher state, health machine, the per-shape-class circuit
        breakers, the request-axis summary + per-tenant SLO accounts,
        and (telemetry on) the steady-state p50/p95/p99 of the
        ``serve.dispatch`` span.  Also the ``/healthz`` body of the
        live scrape endpoint (obs/http.py answers 503 from the
        ``health.state`` field while DEGRADED)."""
        with self._stats_lock:
            counts = dict(self._stats)
        return {
            "counts": counts,
            "admission": self._admission.snapshot(),
            "batcher": self._batcher.snapshot(),
            "health": self._health.snapshot(),
            "breakers": [b for b in _breaker.snapshot()
                         if b["site"] in ("serve.dispatch",
                                          "pipeline.dispatch")],
            "pipelines": sorted(self._pipelines),
            "requests": obs.request_summary(),
            "slo": obs.slo_snapshot(),
            "goodput": self.goodput(),
            "artifact_preload": self._preload,
            "obs_port": self.obs_port,
            "dispatch_quantiles": obs.quantiles(
                "span.serve.dispatch", phase="steady"),
        }
