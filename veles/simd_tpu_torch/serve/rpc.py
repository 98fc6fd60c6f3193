"""RPC data plane: request submission over a subprocess replica's wire.

The port of ``veles.simd_tpu.serve.rpc``, frame for frame: a
``spawn="subprocess"`` replica's obs endpoint serves a ``POST /submit``
route with the full request surface (plain ops, pipeline invocations,
deadlines, tenants, params), and the
:class:`~veles.simd_tpu_torch.serve.cluster.FrontRouter` places
requests on it through a pooled persistent-connection client, through
the same ``_submit_to_replica`` funnel as thread replicas.  A frame is
a wire contract: the port's frames are byte-identical to the JAX
package's, and either package decodes the other's.  The port's answers
are host NumPy already (one copy back per batch), so an ``(out,
state)`` pipeline answer frames as it does in the JAX package.

Design rules, in order of importance:

* **semantics are bit-identical to in-process.**  The typed error
  surface crosses the wire losslessly — the mapping table
  (:data:`ERROR_KINDS`, pinned both directions by tests):

  ==============  ==========================================  =======
  wire ``kind``   Python type                                 status
  ==============  ==========================================  =======
  ``overloaded``  :class:`~veles.simd_tpu_torch.serve.admission.
                  Overloaded` (``tenant``/``scope`` carried;
                  ``scope="cluster"`` round-trips as
                  :class:`~veles.simd_tpu_torch.serve.cluster.
                  NoReplicaAvailable`)                        ``shed``
  ``deadline``    :class:`~veles.simd_tpu_torch.serve.server.
                  DeadlineExceeded`                        ``expired``
  ``closed``      :class:`~veles.simd_tpu_torch.serve.server.
                  ServerClosed`                             ``closed``
  ``bad_request`` :class:`ValueError` (a caller bug, never
                  traffic)                                   ``error``
  ``error``       :class:`RuntimeError`                      ``error``
  ==============  ==========================================  =======

  so the router's failover/shed handling cannot tell a remote terminal
  from a local one.  A transport failure (connection reset, refused,
  timed out, garbage reply) is a ``closed`` ticket — exactly what an
  in-process replica dying under a queued request produces, so the
  failover hook re-routes it — unless the request's own deadline
  already passed, in which case it is ``expired`` (a caller who gave
  up must read ``DEADLINE_EXCEEDED``, not a transport story).
* **deadlines are re-stamped as remaining budget.**  The router
  resolves one absolute deadline per request; every wire submission
  carries the *remaining* milliseconds at send time (the same
  arithmetic ``_submit_to_replica`` applies to thread replicas), and
  the child re-anchors it on its own clock — monotonic clocks don't
  cross process boundaries, remaining budgets do.
* **arrays ride binary npy framing, never base64-JSON.**  A frame is
  ``VSRPC1`` + a 4-byte big-endian header length + a JSON header + the
  concatenated npy blobs it references; signals, params arrays, and
  answer payloads (including pipeline ``(out, state)`` trees) are
  ``np.save``-serialized — bytes-exact dtype/shape round-trips at
  memcpy cost (:func:`pack_frame` / :func:`unpack_frame`).
* **perf is the headline.**  :class:`RpcClient` keeps
  ``$VELES_SIMD_RPC_CONNS`` (default 4) persistent keep-alive
  connections per replica, each owned by a dedicated sender thread, so
  submissions overlap in flight (RTT hides under device time) and no
  request pays TCP setup.
* **a malformed or truncated body answers typed, never hangs.**  The
  server side wraps every parse in one funnel that degrades to a
  ``bad_request`` response; the client side maps an unparseable reply
  to a ``closed`` ticket (ops are pure — re-execution on a survivor is
  safe, and router dedup keeps double answers impossible).

Trace edges: the client stamps ``rpc_submit`` / ``rpc_sent`` /
``rpc_transport_error`` on the local request trace, and the response
carries the CHILD's trace events, absorbed via
:meth:`~veles.simd_tpu_torch.obs.requests.RequestTrace.absorb_remote` with
their replica identity — ``obs.stitch_fleet_trace`` renders one story
across the process boundary.

Knobs: ``$VELES_SIMD_RPC_CONNS`` (pooled connections = max in-flight
per replica; default 4), ``$VELES_SIMD_RPC_TIMEOUT_MS`` (transport
timeout + the no-deadline response wait bound; default 30000).
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import queue
import struct
import threading

import numpy as np

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.runtime import faults
from veles.simd_tpu_torch.serve.admission import Overloaded
from veles.simd_tpu_torch.serve.server import (DeadlineExceeded, Request,
                                         ServerClosed, Ticket,
                                         classify_request,
                                         env_deadline_ms)

__all__ = [
    "RpcClient", "RpcTicket", "serve_submit",
    "pack_frame", "unpack_frame", "pack_request", "unpack_request",
    "pack_response", "unpack_response", "encode_error", "decode_error",
    "MAGIC", "WIRE_SCHEMA", "ERROR_KINDS", "CONTENT_TYPE",
    "RPC_CONNS_ENV", "RPC_TIMEOUT_ENV", "DEFAULT_RPC_CONNS",
    "DEFAULT_RPC_TIMEOUT_MS", "env_conns", "env_timeout_s",
]

MAGIC = b"VSRPC1"
WIRE_SCHEMA = "veles-simd-rpc-v1"
CONTENT_TYPE = "application/x-veles-rpc"

RPC_CONNS_ENV = "VELES_SIMD_RPC_CONNS"
RPC_TIMEOUT_ENV = "VELES_SIMD_RPC_TIMEOUT_MS"

# 4 in-flight submissions per replica overlap RTT with device time at
# loadgen's concurrency without minting a thread per request
DEFAULT_RPC_CONNS = 4
DEFAULT_RPC_TIMEOUT_MS = 30000.0

# the server-side response wait extends this far past the request's
# own deadline: the replica expires overdue work itself (typed), the
# margin only covers the expiry sweep + response packing
RESPONSE_MARGIN_S = 5.0

# wire kind <-> Python type (the table the tests pin both directions);
# decode_error / encode_error are the implementation
ERROR_KINDS = ("overloaded", "deadline", "closed", "bad_request",
               "error")

# one JSON header is bounded by construction (arrays ride blobs); a
# bigger one is a corrupt frame, not a bigger request
_MAX_HEADER = 1 << 24


def env_conns() -> int:
    """Pooled connections per replica from ``$VELES_SIMD_RPC_CONNS``
    (default 4; malformed / non-positive falls back)."""
    raw = os.environ.get(RPC_CONNS_ENV, "").strip()
    if raw:
        try:
            v = int(raw)
        except ValueError:
            return DEFAULT_RPC_CONNS
        if v >= 1:
            return v
    return DEFAULT_RPC_CONNS


def env_timeout_s() -> float:
    """Transport timeout in seconds from
    ``$VELES_SIMD_RPC_TIMEOUT_MS`` (default 30 s; malformed /
    non-positive falls back)."""
    raw = os.environ.get(RPC_TIMEOUT_ENV, "").strip()
    if raw:
        try:
            v = float(raw)
        except ValueError:
            return DEFAULT_RPC_TIMEOUT_MS / 1e3
        if v > 0:
            return v / 1e3
    return DEFAULT_RPC_TIMEOUT_MS / 1e3


# ---------------------------------------------------------------------------
# wire codec: npy-framed trees
# ---------------------------------------------------------------------------


def _encode_tree(node, blobs: list):
    """JSON-able form of one payload tree; every ndarray (and numpy
    scalar) becomes an indexed npy blob — bytes-exact, never
    base64-JSON.  Reserved ``__``-prefixed dict keys and non-string
    keys escape through ``__map__``.  Unsupported types raise
    ValueError (a caller bug)."""
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if isinstance(node, np.ndarray):
        buf = io.BytesIO()
        np.save(buf, node, allow_pickle=False)
        blobs.append(buf.getvalue())
        return {"__blob__": len(blobs) - 1}
    if isinstance(node, np.generic):
        buf = io.BytesIO()
        np.save(buf, np.asarray(node), allow_pickle=False)
        blobs.append(buf.getvalue())
        return {"__scalar__": len(blobs) - 1}
    if isinstance(node, tuple):
        return {"__tuple__": [_encode_tree(v, blobs) for v in node]}
    if isinstance(node, list):
        return [_encode_tree(v, blobs) for v in node]
    if isinstance(node, dict):
        if all(isinstance(k, str) and not k.startswith("__")
               for k in node):
            return {k: _encode_tree(v, blobs)
                    for k, v in node.items()}
        return {"__map__": [[_encode_tree(k, blobs),
                             _encode_tree(v, blobs)]
                            for k, v in node.items()]}
    raise ValueError(
        f"rpc wire cannot encode {type(node).__name__} values")


def _decode_tree(node, blobs: list):
    """Inverse of :func:`_encode_tree` over already-deserialized
    blobs."""
    if isinstance(node, dict):
        if "__blob__" in node:
            return blobs[int(node["__blob__"])]
        if "__scalar__" in node:
            return blobs[int(node["__scalar__"])][()]
        if "__tuple__" in node:
            return tuple(_decode_tree(v, blobs)
                         for v in node["__tuple__"])
        if "__map__" in node:
            return {_decode_tree(k, blobs): _decode_tree(v, blobs)
                    for k, v in node["__map__"]}
        return {k: _decode_tree(v, blobs) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode_tree(v, blobs) for v in node]
    return node


def pack_frame(header: dict, blobs: list) -> bytes:
    """One wire frame: ``MAGIC`` + 4-byte big-endian JSON-header
    length + header + concatenated npy blobs (sizes in
    ``header["blobs"]``)."""
    header = dict(header)
    header["schema"] = WIRE_SCHEMA
    header["blobs"] = [len(b) for b in blobs]
    hj = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return b"".join([MAGIC, struct.pack(">I", len(hj)), hj] + blobs)


def unpack_frame(data: bytes) -> tuple:
    """``(header, blob_arrays)`` from one frame.  EVERY malformation —
    wrong magic, truncated header or blobs, non-JSON, schema drift, a
    blob npy can't parse — raises ValueError: the one exception type
    both ends translate into a typed answer, never a hang."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise ValueError("rpc frame must be bytes")
    data = bytes(data)
    if len(data) < len(MAGIC) + 4:
        raise ValueError(
            f"rpc frame truncated ({len(data)} bytes)")
    if data[:len(MAGIC)] != MAGIC:
        raise ValueError("rpc frame has wrong magic")
    (hlen,) = struct.unpack(
        ">I", data[len(MAGIC):len(MAGIC) + 4])
    if hlen > _MAX_HEADER:
        raise ValueError(f"rpc header length {hlen} out of bounds")
    off = len(MAGIC) + 4
    if len(data) < off + hlen:
        raise ValueError("rpc frame truncated inside header")
    try:
        header = json.loads(data[off:off + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"rpc header is not JSON: {e}") from e
    if not isinstance(header, dict):
        raise ValueError("rpc header must be a JSON object")
    if header.get("schema") != WIRE_SCHEMA:
        raise ValueError(
            f"rpc schema mismatch: got {header.get('schema')!r}, "
            f"want {WIRE_SCHEMA!r}")
    off += hlen
    sizes = header.get("blobs") or []
    blobs = []
    for size in sizes:
        size = int(size)
        if len(data) < off + size:
            raise ValueError("rpc frame truncated inside blobs")
        try:
            blobs.append(np.load(io.BytesIO(data[off:off + size]),
                                 allow_pickle=False))
        except Exception as e:  # noqa: BLE001 — any npy rot = ValueError
            raise ValueError(f"rpc blob unparseable: {e}") from e
        off += size
    if off != len(data):
        raise ValueError(
            f"rpc frame has {len(data) - off} trailing bytes")
    return header, blobs


def pack_request(op: str, x, params: dict, *,
                 tenant: str = "default",
                 deadline_ms: float | None = None,
                 block: bool = False,
                 timeout: float | None = None) -> bytes:
    """One ``POST /submit`` body.  ``deadline_ms`` is the REMAINING
    budget at send time (the receiver re-anchors it on its own
    clock)."""
    blobs: list = []
    header = {
        "kind": "request",
        "op": str(op),
        "tenant": str(tenant),
        "deadline_ms": (float(deadline_ms)
                        if deadline_ms is not None else None),
        "block": bool(block),
        "timeout": float(timeout) if timeout is not None else None,
        "x": _encode_tree(np.asarray(x), blobs),
        "params": _encode_tree(dict(params or {}), blobs),
    }
    return pack_frame(header, blobs)


def unpack_request(data: bytes) -> dict:
    """Decoded request fields (``op``/``x``/``params``/``tenant``/
    ``deadline_ms``/``block``/``timeout``); ValueError on any
    malformation."""
    header, blobs = unpack_frame(data)
    if header.get("kind") != "request":
        raise ValueError(
            f"expected a request frame, got {header.get('kind')!r}")
    if not isinstance(header.get("op"), str):
        raise ValueError("rpc request has no op")
    params = _decode_tree(header.get("params"), blobs)
    if params is None:
        params = {}
    if not isinstance(params, dict):
        raise ValueError("rpc request params must decode to a dict")
    return {
        "op": header["op"],
        "tenant": str(header.get("tenant") or "default"),
        "deadline_ms": header.get("deadline_ms"),
        "block": bool(header.get("block")),
        "timeout": header.get("timeout"),
        "x": _decode_tree(header.get("x"), blobs),
        "params": params,
    }


def pack_response(*, status: str, value=None, error: dict | None = None,
                  wait_s: float | None = None, events=(),
                  replica: str | None = None) -> bytes:
    """One ``/submit`` response body: the ticket outcome (status +
    value tree or encoded error), the replica identity, and the
    child-side trace events for cross-process stitching."""
    blobs: list = []
    header = {
        "kind": "response",
        "status": str(status),
        "wait_s": float(wait_s) if wait_s is not None else None,
        "replica": replica,
        "error": error,
        "events": list(events),
        "value": _encode_tree(value, blobs),
    }
    return pack_frame(header, blobs)


def unpack_response(data: bytes) -> dict:
    """Decoded response fields; ValueError on any malformation (the
    client maps it to a ``closed`` ticket — failover-safe)."""
    header, blobs = unpack_frame(data)
    if header.get("kind") != "response":
        raise ValueError(
            f"expected a response frame, got {header.get('kind')!r}")
    status = header.get("status")
    if not isinstance(status, str) or not status:
        raise ValueError("rpc response has no status")
    events = header.get("events")
    return {
        "status": status,
        "wait_s": header.get("wait_s"),
        "replica": header.get("replica"),
        "error": header.get("error"),
        "events": events if isinstance(events, list) else [],
        "value": _decode_tree(header.get("value"), blobs),
    }


# ---------------------------------------------------------------------------
# typed-error mapping (lossless across the HTTP boundary)
# ---------------------------------------------------------------------------


def encode_error(exc: BaseException) -> dict:
    """Wire form of one typed serving error (the :data:`ERROR_KINDS`
    table).  Subclass order matters: the typed serve errors are
    RuntimeError subclasses, so they classify before the catch-all."""
    if isinstance(exc, Overloaded):
        return {"kind": "overloaded", "message": str(exc),
                "tenant": getattr(exc, "tenant", "default"),
                "scope": getattr(exc, "scope", "global")}
    if isinstance(exc, DeadlineExceeded):
        return {"kind": "deadline", "message": str(exc)}
    if isinstance(exc, ServerClosed):
        return {"kind": "closed", "message": str(exc)}
    if isinstance(exc, ValueError):
        return {"kind": "bad_request", "message": str(exc)}
    return {"kind": "error", "message": f"{type(exc).__name__}: {exc}"}


def decode_error(info: dict) -> Exception:
    """The Python twin of one wire error dict — inverse of
    :func:`encode_error`, so shed/expired/closed semantics survive the
    boundary bit-identically.  Unknown kinds decode as RuntimeError
    (forward compatibility beats a parse crash)."""
    if not isinstance(info, dict):
        return RuntimeError(f"malformed rpc error payload: {info!r}")
    kind = info.get("kind")
    message = str(info.get("message") or "rpc error")
    if kind == "overloaded":
        tenant = str(info.get("tenant") or "default")
        if info.get("scope") == "cluster":
            # router-scope exhaustion round-trips as its own type
            from veles.simd_tpu_torch.serve.cluster import \
                NoReplicaAvailable
            return NoReplicaAvailable(message, tenant=tenant)
        return Overloaded(message, tenant=tenant,
                          scope=str(info.get("scope") or "global"))
    if kind == "deadline":
        return DeadlineExceeded(message)
    if kind == "closed":
        return ServerClosed(message)
    if kind == "bad_request":
        return ValueError(message)
    return RuntimeError(message)


# ---------------------------------------------------------------------------
# server side: the POST /submit body
# ---------------------------------------------------------------------------


def serve_submit(server, body: bytes) -> tuple:
    """Answer one ``POST /submit`` body against ``server`` (a live
    :class:`~veles.simd_tpu_torch.serve.server.Server`); returns ``(http_
    code, response_bytes)``.  EVERY outcome is a packed response —
    malformed bodies answer ``bad_request`` (HTTP 400), typed serving
    errors ride the payload under HTTP 200, and the response wait is
    bounded (deadline + margin, else the rpc timeout) so a wedged
    ticket can never pin the handler thread forever."""
    try:
        req = unpack_request(body)
    except ValueError as e:
        return 400, pack_response(
            status="error",
            error={"kind": "bad_request",
                   "message": f"malformed rpc request: {e}"},
            replica=getattr(server, "name", None))
    name = getattr(server, "name", None)
    deadline_ms = req["deadline_ms"]
    try:
        ticket = server.submit(
            Request(op=req["op"], x=req["x"], params=req["params"],
                    tenant=req["tenant"], deadline_ms=deadline_ms),
            block=req["block"], timeout=req["timeout"])
    except ValueError as e:
        return 200, pack_response(status="error",
                                  error=encode_error(e),
                                  replica=name)
    except ServerClosed as e:
        return 200, pack_response(status="closed",
                                  error=encode_error(e),
                                  replica=name)
    done = threading.Event()
    ticket.add_done_callback(lambda _t: done.set())
    bound = env_timeout_s()
    if deadline_ms is not None and deadline_ms > 0:
        bound = float(deadline_ms) / 1e3 + RESPONSE_MARGIN_S
    if not done.wait(bound):
        # the ticket may still answer later (server-side accounting is
        # its own); THIS exchange answers typed — the client fails the
        # request over rather than hanging a connection slot
        obs.count("rpc_response_timeout", op=req["op"])
        return 200, pack_response(
            status="error",
            error={"kind": "error",
                   "message": f"replica did not answer within "
                              f"{bound:.1f}s"},
            replica=name)
    events = ticket.trace.events() if ticket.trace is not None else []
    error = (encode_error(ticket._error)
             if ticket._error is not None else None)
    return 200, pack_response(status=ticket.status,
                              value=ticket._value,
                              error=error, wait_s=ticket.wait_s,
                              events=events, replica=name)


# ---------------------------------------------------------------------------
# client side: the router's pooled persistent-connection submitter
# ---------------------------------------------------------------------------


class RpcTicket(Ticket):
    """A :class:`~veles.simd_tpu_torch.serve.server.Ticket` completed by the
    RPC client instead of a local worker — same contract (result /
    done / status / trace / add_done_callback / exactly-once), so the
    front router's failover hook cannot tell the difference.
    ``remote`` is the answering replica's id once terminal."""

    __slots__ = ("remote",)

    def __init__(self, op: str, tenant: str):
        super().__init__(op, tenant)
        self.remote = None


class RpcClient:
    """Pooled persistent-connection submitter for ONE subprocess
    replica's ``POST /submit`` route.

    ``conns`` dedicated sender threads each own one keep-alive
    ``http.client.HTTPConnection`` (rebuilt transparently after a
    transport error), so up to ``conns`` submissions are in flight
    concurrently and none pays TCP setup.  :meth:`submit` mirrors
    :meth:`~veles.simd_tpu_torch.serve.server.Server.submit` — synchronous
    ValueError for malformed requests, a ServerClosed raise once
    closed, a ticket for everything else — and every ticket resolves
    typed: transport failures answer ``closed`` (or ``expired`` when
    the request's own deadline already passed), garbage replies answer
    ``closed``, remote outcomes map through :func:`decode_error`.

    This class is the ONLY place serve-layer code speaks raw HTTP
    request submission (tools/lint.py rpc-funnel rule)."""

    def __init__(self, host: str, port: int, *,
                 replica: str | None = None,
                 conns: int | None = None,
                 timeout_s: float | None = None):
        self.host = str(host)
        self.port = int(port)
        self.replica = replica
        self.conns = int(conns) if conns else env_conns()
        if self.conns < 1:
            raise ValueError("conns must be >= 1")
        self.timeout_s = (float(timeout_s) if timeout_s
                          else env_timeout_s())
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._closed = False
        self._in_flight = 0
        self._stats = {"submitted": 0, "completed": 0, "sends": 0,
                       "reused": 0, "transport_errors": 0,
                       "bad_replies": 0}
        self._conn_slots: list = [None] * self.conns
        self._workers: list = []
        for i in range(self.conns):
            t = threading.Thread(
                target=self._worker, args=(i,), daemon=True,
                name=f"veles-rpc-{self.replica or self.port}-{i}")
            t.start()
            self._workers.append(t)

    # -- intake ------------------------------------------------------------

    def submit(self, request: Request | None = None, *,
               op: str | None = None, x=None,
               params: dict | None = None, tenant: str = "default",
               block: bool = False, timeout: float | None = None,
               deadline_ms: float | None = None) -> RpcTicket:
        """Queue one request onto the replica's wire; returns its
        :class:`RpcTicket`.  Same call shape and synchronous-error
        contract as :meth:`Server.submit` (malformed requests raise
        ValueError here, before any bytes move; a closed client raises
        ServerClosed — the router's placement-failure path).  One
        remote-only difference: pipeline registration is the CHILD's
        (an unregistered pipeline answers a ``bad_request`` ticket
        instead of raising here — the client cannot see the child's
        registry without a round trip)."""
        if request is None:
            request = Request(op=op, x=x, params=params or {},
                              tenant=tenant, deadline_ms=deadline_ms)
        elif deadline_ms is not None:
            request = dataclasses.replace(request,
                                          deadline_ms=deadline_ms)
        xarr, _n, _cparams, key = classify_request(
            request.op, request.x, request.params)
        dl_ms = request.deadline_ms
        if dl_ms is None:
            dl_ms = env_deadline_ms()
        has_deadline = dl_ms is not None and dl_ms > 0
        ticket = RpcTicket(request.op, request.tenant)
        ticket.trace = obs.request_trace(
            request.op, tenant=request.tenant, shape_class=key[2],
            deadline_s=(float(dl_ms) / 1e3 if has_deadline else None))
        body = pack_request(
            request.op, xarr, request.params, tenant=request.tenant,
            deadline_ms=(float(dl_ms) if has_deadline else None),
            block=block, timeout=timeout)
        abs_deadline = (faults.monotonic() + float(dl_ms) / 1e3
                        if has_deadline else None)
        with self._lock:
            if self._closed:
                raise ServerClosed(
                    f"rpc client for replica "
                    f"{self.replica or self.host} is closed")
            self._stats["submitted"] += 1
            self._in_flight += 1
            # the put rides the same lock as the closed check: every
            # enqueued ticket happens-before close()'s sentinels, so a
            # sender always processes it (typed), never strands it
            self._q.put((ticket, body, abs_deadline))
        ticket.trace.event("rpc_submit", replica=self.replica,
                           deadline_ms=(float(dl_ms)
                                        if has_deadline else None))
        return ticket

    # -- the sender loop ---------------------------------------------------

    def _worker(self, slot: int) -> None:
        while True:
            item = self._q.get()
            if item is None:
                conn = self._conn_slots[slot]
                self._conn_slots[slot] = None
                if conn is not None:
                    try:
                        conn.close()
                    except Exception:  # noqa: BLE001 — teardown
                        pass
                return
            try:
                self._roundtrip(slot, item)
            except Exception as e:  # noqa: BLE001 — never lose a ticket
                if not item[0].done():
                    self._finish(item[0], status="error",
                                 error=RuntimeError(
                                     f"rpc client internal error: "
                                     f"{e!r}"))

    def _finish(self, ticket: RpcTicket, *, value=None, error=None,
                status="ok", wait_s=None) -> None:
        """Complete one ticket exactly once + the in-flight
        accounting (every roundtrip outcome funnels through here)."""
        with self._lock:
            self._in_flight -= 1
            self._stats["completed"] += 1
        ticket.remote = self.replica
        ticket._complete(value=value, error=error, status=status,
                         wait_s=wait_s)

    def _transport_failed(self, slot: int, ticket: RpcTicket,
                          abs_deadline, exc, *,
                          bad_reply: bool = False) -> None:
        """One transport-layer failure: drop the poisoned connection,
        count it, answer typed — ``expired`` when the request's own
        deadline already passed (the caller gave up; the transport
        story is noise), ``closed`` otherwise (the failover signal)."""
        conn = self._conn_slots[slot]
        self._conn_slots[slot] = None
        if conn is not None:
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — already broken
                pass
        with self._lock:
            self._stats["transport_errors"] += 1
            if bad_reply:
                self._stats["bad_replies"] += 1
        obs.count("rpc_transport_error",
                  replica=self.replica or "unknown",
                  kind="bad_reply" if bad_reply else "io")
        ticket.trace.event("rpc_transport_error",
                           replica=self.replica,
                           error=repr(exc)[:200])
        if abs_deadline is not None \
                and faults.monotonic() >= abs_deadline:
            self._finish(
                ticket, status="expired",
                error=DeadlineExceeded(
                    f"DEADLINE_EXCEEDED: rpc request "
                    f"{ticket.op!r} missed its end-to-end deadline "
                    f"in flight to replica {self.replica}"))
        else:
            self._finish(
                ticket, status="closed",
                error=ServerClosed(
                    f"rpc transport to replica {self.replica} "
                    f"failed: {exc!r:.200}"))

    def _roundtrip(self, slot: int, item) -> None:
        import http.client
        import socket

        ticket, body, abs_deadline = item
        with self._lock:
            closed = self._closed
        if closed:
            self._finish(ticket, status="closed",
                         error=ServerClosed(
                             f"rpc client for replica {self.replica} "
                             f"closed before dispatch"))
            return
        if abs_deadline is not None \
                and faults.monotonic() >= abs_deadline:
            self._finish(
                ticket, status="expired",
                error=DeadlineExceeded(
                    f"DEADLINE_EXCEEDED: rpc request {ticket.op!r} "
                    f"missed its end-to-end deadline before "
                    f"dispatch to replica {self.replica}"))
            return
        conn = self._conn_slots[slot]
        reused = conn is not None
        try:
            if conn is None:
                conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout_s)
                # http.client writes headers and body as separate
                # segments; without TCP_NODELAY that is a Nagle +
                # delayed-ACK stall (~40ms) per exchange
                conn.connect()
                conn.sock.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
                self._conn_slots[slot] = conn
            ticket.trace.event("rpc_sent", replica=self.replica,
                               reused=reused)
            conn.request("POST", "/submit", body=body,
                         headers={"Content-Type": CONTENT_TYPE})
            resp = conn.getresponse()
            data = resp.read()
        except Exception as e:  # noqa: BLE001 — any io rot = typed
            self._transport_failed(slot, ticket, abs_deadline, e)
            return
        with self._lock:
            self._stats["sends"] += 1
            if reused:
                self._stats["reused"] += 1
        try:
            payload = unpack_response(data)
        except ValueError as e:
            # a truncated/garbage reply left the connection state
            # unknowable — drop it with the same typed closed/expired
            # answer a reset would get (re-execution is safe: ops are
            # pure, router dedup forbids double answers)
            self._transport_failed(slot, ticket, abs_deadline, e,
                                   bad_reply=True)
            return
        events = payload["events"]
        if events:
            ticket.trace.absorb_remote(
                events, replica=payload.get("replica")
                or self.replica)
        status = payload["status"]
        error = (decode_error(payload["error"])
                 if payload.get("error") is not None else None)
        if status in ("ok", "degraded"):
            self._finish(ticket, value=payload["value"],
                         status=status, wait_s=payload.get("wait_s"))
            return
        if error is None:
            error = RuntimeError(
                f"rpc response carried status {status!r} with no "
                f"error payload")
        self._finish(ticket, status=status, error=error,
                     wait_s=payload.get("wait_s"))

    # -- lifecycle + introspection -----------------------------------------

    def close(self) -> None:
        """Stop intake and the sender pool.  Queued-but-unsent
        requests answer ``closed`` (the senders drain them under the
        closed flag before eating their sentinels); in-flight
        exchanges resolve through their own transport errors once the
        peer dies.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for _ in self._workers:
                self._q.put(None)
        # unblock senders parked inside a response read: closing the
        # socket under them turns the park into a transport error,
        # which answers their ticket typed
        for conn in list(self._conn_slots):
            if conn is not None:
                try:
                    conn.close()
                except Exception:  # noqa: BLE001 — teardown
                    pass
        for t in self._workers:
            t.join(timeout=5.0)
        self._workers = []

    def in_flight(self) -> int:
        """Requests submitted but not yet completed — the router's
        depth signal for a subprocess replica (the in-process twin is
        :meth:`Server.depth`)."""
        with self._lock:
            return self._in_flight

    def stats(self) -> dict:
        """JSON-native client health: in-flight, submissions,
        connection-reuse ratio, transport errors — the per-replica RPC
        block the fleet collector exports (``rpc_in_flight`` /
        ``rpc_reuse_ratio`` / ``rpc_transport_errors`` series)."""
        with self._lock:
            counts = dict(self._stats)
            in_flight = self._in_flight
        sends = counts["sends"]
        return {
            "replica": self.replica,
            "host": self.host,
            "port": self.port,
            "conns": self.conns,
            "in_flight": in_flight,
            "reuse_ratio": ((counts["reused"] / sends)
                            if sends else None),
            **counts,
        }

    def __repr__(self):
        return (f"RpcClient({self.host}:{self.port}, "
                f"replica={self.replica!r}, conns={self.conns})")
