"""Live scrape endpoint: the obs layer, served over stdlib HTTP.

The port of ``veles.simd_tpu.obs.http``, route for route: read-only
routes plus the RPC data plane's one write route, on a daemon-threaded
standard-library ``http.server`` (no new dependencies):

* ``GET /metrics`` — ``obs.to_prometheus()`` verbatim (counters,
  gauges incl. the per-tenant ``slo_*`` family, histograms incl.
  ``serve.request_latency{op, status}`` and the ``request.*`` phase
  family, resources, caches) — point a Prometheus scraper at it;
* ``GET /healthz`` — JSON: endpoint liveness plus whatever the owning
  process registered as its health provider (the serving layer wires
  ``Server.stats()`` in: health machine state, breaker registry,
  admission depths, batcher classes).  Status 200 while the provider
  reports ``healthy`` (or no provider is registered), 503 once it
  reports ``degraded`` — load balancers can act on the code alone;
* ``GET /debug/requests`` — JSON: the request axis
  (:mod:`veles.simd_tpu_torch.obs.requests`): recent completed
  traces, slowest-per-op and degraded exemplars, and the per-tenant
  SLO accounts;
* ``GET /signals`` — JSON: the typed ``obs.signals()`` bundle of the
  fleet axis (:mod:`veles.simd_tpu_torch.obs.timeseries`) with the
  raw windowed series tails; meaningful on a ``ReplicaGroup``'s
  aggregation endpoint (its collector feeds the store), an empty fleet
  on a lone server;
* ``GET /incidents`` — JSON: the incident engine's typed open→closed
  records (:mod:`veles.simd_tpu_torch.obs.incidents`);
* ``GET /scaler`` — JSON: the control axis (``obs.scaler_snapshot()``),
  or the disarmed shell when no scaler runs here;
* ``POST /submit`` — armed only when the owning process registered a
  submit handler (the serving layer binds
  :func:`veles.simd_tpu_torch.serve.rpc.serve_submit`): an npy-framed
  request in, an npy-framed response out — the RPC data plane a
  ``spawn="subprocess"`` replica serves router traffic over.  The
  endpoint speaks HTTP/1.1, so the router's pooled connections persist.

The JSON routes are schema-stamped (``veles-simd-signals-v4``,
``veles-simd-requests-v1``, ``veles-simd-incidents-v1``,
``veles-simd-scaler-v1``), the JAX endpoint's stamps.

Arming: :meth:`veles.simd_tpu_torch.serve.Server.start` reads
``$VELES_SIMD_OBS_PORT`` (or its ``obs_port=`` argument; port 0 binds
an ephemeral port — the test idiom) and owns the endpoint's lifetime;
any other process can call :func:`start` directly.  The endpoint binds
localhost only — it serves operators on the host, not the internet.
"""

from __future__ import annotations

import http.server
import json
import os
import threading

__all__ = ["ObsEndpoint", "EndpointUnavailable", "start", "env_port",
           "OBS_PORT_ENV", "BIND_HOST", "REQUESTS_SCHEMA"]

OBS_PORT_ENV = "VELES_SIMD_OBS_PORT"
BIND_HOST = "127.0.0.1"
# the /debug/requests contract version (the /signals and /incidents
# stamps live with their producers: timeseries.SIGNALS_SCHEMA,
# incidents.SCHEMA) — dashboards check these instead of guessing
REQUESTS_SCHEMA = "veles-simd-requests-v1"

_ROUTES = ["/metrics", "/healthz", "/debug/requests", "/signals",
           "/incidents", "/scaler"]


def env_port() -> int | None:
    """The scrape-endpoint port from ``$VELES_SIMD_OBS_PORT`` (unset /
    empty / malformed / negative = None = endpoint disarmed; 0 = bind
    an ephemeral port)."""
    raw = os.environ.get(OBS_PORT_ENV, "").strip()
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        return None
    return port if port >= 0 else None


class EndpointUnavailable(OSError):
    """The scrape endpoint could not bind its port — typed and
    actionable, raised OUT of :meth:`veles.simd_tpu_torch.serve.Server.
    start` (and :class:`ObsEndpoint`) instead of dying later in the
    serving thread.  An :class:`OSError` subclass, so callers that
    handled the raw bind error keep working.  The usual cause is
    another process (or another server in this one) already holding
    the port: use port 0 (ephemeral) per endpoint.  ``port`` carries
    the refused port number."""

    def __init__(self, message: str, *, port: int | None = None):
        super().__init__(message)
        self.port = port


class _Handler(http.server.BaseHTTPRequestHandler):
    """The read-only routes plus the one write route (``POST
    /submit``, armed only when the owner registered a submit handler).
    Every handler is exception-proofed into a 500 — a scrape must
    never kill the serving process, and a half-written response must
    never wedge the scraper."""

    # HTTP/1.1 so the RPC data plane's pooled connections persist
    # (HTTP/1.0 closes after every exchange); every response below
    # sends Content-Length, which keep-alive requires
    protocol_version = "HTTP/1.1"

    # headers and body leave as separate writes; without TCP_NODELAY
    # that is a Nagle + delayed-ACK stall (~40ms) on every exchange
    disable_nagle_algorithm = True

    # the endpoint belongs to telemetry; its access log does not get
    # to spam the serving process's stderr
    def log_message(self, fmt, *args):  # noqa: A003
        pass

    def _send_bytes(self, code: int, data: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send(self, code: int, body: str, ctype: str) -> None:
        self._send_bytes(code, body.encode("utf-8"), ctype)

    def _send_json(self, code: int, body) -> None:
        self._send(code, json.dumps(body, indent=2, default=str),
                   "application/json")

    def _guarded(self, route) -> None:
        try:
            route(self.path.split("?", 1)[0])
        except BrokenPipeError:
            pass        # client hung up mid-response: its problem
        except Exception as e:  # noqa: BLE001 — a request never kills
            try:
                self._send_json(500, {"error": repr(e)})
            except Exception:  # noqa: BLE001
                pass

    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        self._guarded(self._post)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        self._guarded(self._get)

    def _post(self, path: str) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length > 0 else b""
        submit = self.server.owner.submit_handler
        if path != "/submit" or submit is None:
            self._send_json(404, {"error": "unknown path",
                                  "routes": (["/submit"] if submit
                                             is not None else [])})
            return
        code, payload = submit(body)
        self._send_bytes(int(code), payload, "application/octet-stream")

    def _get(self, path: str) -> None:
        if path == "/metrics":
            from veles.simd_tpu_torch import obs

            self._send(200, obs.to_prometheus(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            body, code = self.server.owner.healthz()
            self._send_json(code, body)
        elif path == "/debug/requests":
            from veles.simd_tpu_torch import obs

            body = {"schema": REQUESTS_SCHEMA}
            body.update(obs.request_snapshot())
            self._send_json(200, body)
        elif path == "/signals":
            from veles.simd_tpu_torch import obs

            self._send_json(200, obs.signals().to_dict())
        elif path == "/incidents":
            from veles.simd_tpu_torch import obs

            self._send_json(200, obs.incidents_snapshot())
        elif path == "/scaler":
            from veles.simd_tpu_torch import obs

            self._send_json(200, obs.scaler_snapshot())
        else:
            self._send_json(404, {"error": "unknown path",
                                  "routes": _ROUTES})


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True
    # restarting a serving process on the same port must not wait out
    # TIME_WAIT
    allow_reuse_address = True


class ObsEndpoint:
    """One armed scrape endpoint: the bound port, the serving daemon
    thread, and :meth:`stop`.  ``health`` is an optional zero-arg
    callable returning a JSON-native dict for ``/healthz`` (the
    serving layer passes its ``stats``).  ``submit`` is an optional
    ``(body_bytes) -> (http_code, response_bytes)`` callable arming the
    ``POST /submit`` RPC route (the serving layer passes
    ``serve.rpc.serve_submit`` bound to its server; None leaves the
    endpoint read-only)."""

    def __init__(self, port: int, health=None, submit=None):
        self._health = health
        self.submit_handler = submit
        try:
            self._httpd = _Server((BIND_HOST, int(port)), _Handler)
        except OSError as e:
            # EADDRINUSE and friends: surface a typed, actionable
            # error at arm time (Server.start) — never an opaque
            # OSError out of a server that half-started
            raise EndpointUnavailable(
                f"obs scrape endpoint could not bind "
                f"{BIND_HOST}:{int(port)} ({e.strerror or e}) — the "
                f"port is likely held by another process or server; "
                f"use obs_port=0 for an ephemeral port, pick a free "
                f"one, or disarm with a negative obs_port / unset "
                f"${OBS_PORT_ENV}", port=int(port)) from e
        self._httpd.owner = self
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"veles-obs-http-{self.port}")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{BIND_HOST}:{self.port}"

    def healthz(self) -> tuple:
        """``(body, http_code)`` for ``/healthz``: 503 once the health
        provider reports a degraded state, 200 otherwise."""
        body = {"endpoint": "ok", "port": self.port}
        code = 200
        if self._health is not None:
            try:
                provided = self._health()
            except Exception as e:  # noqa: BLE001 — report, not crash
                return ({**body, "provider_error": repr(e)}, 500)
            body.update(provided if isinstance(provided, dict)
                        else {"health": provided})
            state = body.get("health")
            if isinstance(state, dict):
                state = state.get("state")
            if state == "degraded":
                code = 503
        return body, code

    def stop(self) -> None:
        """Shut the listener down and join the serving thread."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __repr__(self):
        return f"ObsEndpoint(port={self.port})"


def start(port: int | None = None, health=None,
          submit=None) -> ObsEndpoint | None:
    """Arm the endpoint on ``port`` (None = ``$VELES_SIMD_OBS_PORT``;
    still None = disarmed, returns None; 0 = ephemeral).  ``submit``
    arms the ``POST /submit`` RPC route (see :class:`ObsEndpoint`).
    Returns the live :class:`ObsEndpoint` —
    the caller owns :meth:`stop`."""
    if port is None:
        port = env_port()
    if port is None:
        return None
    return ObsEndpoint(int(port), health=health, submit=submit)
