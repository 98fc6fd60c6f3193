"""Replica-group serving: N servers behind a breaker-aware front router.

The port of ``veles.simd_tpu.serve.cluster``.  One
:class:`~veles.simd_tpu_torch.serve.server.Server` is one health
machine, one admission bound, one ceiling — and on the card one
server's host loop cannot keep the device busy.  This module is the
layer that removes the ceiling: a :class:`ReplicaGroup` managing N
server replicas, and a :class:`FrontRouter` placing each submitted
request on one of them, built so the *service* survives losing a
whole replica the way a single server survives losing a device:

* **placement** — :meth:`FrontRouter.submit` scores every live
  replica for the request's shape class and places on the cheapest:
  admitted queue depth (:meth:`Server.depth`) is the base load signal,
  a DEGRADED health machine adds a large penalty, and an OPEN circuit
  breaker *for that shape class* (the replica-keyed
  ``serve.dispatch`` breaker) adds a class-local penalty — an open
  breaker or degraded replica is **deprioritized per shape class, not
  blacklisted globally** (its other classes, and last-resort traffic,
  still flow).  Padding-aware placement subtracts an **occupancy
  bonus** (``$VELES_SIMD_ROUTER_OCCUPANCY_WEIGHT``) for a replica
  whose batcher already holds a forming batch of the request's shape
  class — the request completes that batch instead of opening one
  that will pad.  ``VELES_SIMD_ROUTER_POLICY=round_robin`` swaps the
  scoring for a rotation (the A/B control);
* **failover** — every backend ticket carries a completion hook: a
  replica that dies with the request queued (``status="closed"``) or
  sheds it (``status="shed"``) triggers re-submission onto a
  surviving replica with the *original* end-to-end deadline carried
  over (the absolute deadline is stamped once at router admission;
  every re-submission gets the remaining budget, never a fresh one)
  and a shared failover budget (``max_failovers`` across ALL
  attempts, not per replica).  The router ticket is deduped by its
  router rid — it completes exactly once, so the group-wide
  zero-double-answer accounting holds even if a late duplicate
  completion ever raced (counted ``router_dedup``, never surfaced);
* **draining** — :meth:`ReplicaGroup.drain` is graceful removal:
  intake stops (the router skips DRAINING replicas), in-flight and
  queued work is answered by the replica itself, and only then is the
  replica DEAD — zero lost requests by construction.
  :meth:`ReplicaGroup.kill` is the abrupt form (no drain): queued
  work is answered ``closed`` and *re-routed by the failover hook*
  onto survivors;
* **heartbeats** — the group heartbeats every replica on a fixed
  cadence (``VELES_SIMD_HEARTBEAT_MS``); ``miss_limit`` consecutive
  missed beats mark the replica wedged and auto-drain it without
  operator action (``replica_lifecycle``/``wedged`` decision event).
  The ``cluster.heartbeat@<rid>`` injection site makes a wedge
  deterministic on CPU CI (``VELES_SIMD_FAULT_PLAN``);
* **aggregation endpoint** — :meth:`ReplicaGroup.start` arms ONE
  router-level scrape endpoint (``obs_port=`` / ``$VELES_SIMD_OBS_PORT``;
  per-replica endpoints stay disarmed in thread mode): ``/healthz``
  answers 200 while at least one replica is up and healthy, 503 once
  none is — the load-balancer contract, live through kills and drains
  (the replicated chaos campaign gates exactly that);
* **fleet collector — the obs v5 feed** — a collector thread sweeps
  the group every ``$VELES_SIMD_FLEET_TICK_MS`` (default 100 ms):
  in-process replicas are sampled directly (depth / health /
  completed counts / open breakers), subprocess replicas are scraped
  over their existing ``/metrics`` endpoints (a failed scrape is a
  counted ``fleet_scrape_stale``, never a crash), and every sample
  lands in the bounded fleet store
  (:mod:`veles.simd_tpu_torch.obs.timeseries`, window
  ``$VELES_SIMD_FLEET_WINDOW``).  ``obs.signals()`` reads the typed
  bundle back out; the aggregation endpoint serves it as
  ``/signals``.  ``_collect_fleet_sample`` is THE cross-replica
  metrics funnel (lint-enforced): serve/cluster code never scrapes
  registries ad hoc;
* **autoscaler — the control axis** — when armed (``scaler=True`` /
  ``$VELES_SIMD_SCALER``), the group starts a
  :class:`~veles.simd_tpu_torch.serve.scaler.ScalerEngine` alongside
  the collector: it reads ``obs.signals()`` on its own cadence and
  acts back through the group's verbs — :meth:`spawn_replica` under
  rising SLO burn or queue velocity, :meth:`retire` of the
  least-loaded replica after a sustained idle window,
  :meth:`restart` of down/stale replicas — every tick a journaled
  ``scaler`` decision event.

**Spawn modes.** ``spawn="thread"`` (default) runs replicas as
in-process servers, which share the process's CUDA context, kernel
library and compiled pipelines; their graph captures are kept
exclusive of each other's device work by the process's one capture
gate (``serve/server.py``).  ``spawn="subprocess"`` runs each replica
as a child process (``_replica_main``, one CUDA context each) that
arms its own ``/healthz`` +
``/metrics`` + ``POST /submit`` endpoint and reports its port; the
group heartbeats it over HTTP, and the :class:`FrontRouter` places
requests on it over the RPC data plane
(:mod:`veles.simd_tpu_torch.serve.rpc`): each subprocess replica carries a
pooled persistent-connection :class:`~veles.simd_tpu_torch.serve.rpc.
RpcClient`, requests cross the wire in binary npy framing with the
remaining deadline budget re-stamped per attempt, and the typed
errors (``Overloaded`` / ``DeadlineExceeded`` / ``ServerClosed`` /
shed) map losslessly back — so failover, shed, and carried-deadline
semantics are identical to the in-process path and both spawn modes
flow through the same ``_submit_to_replica`` funnel.  Pipelines
cross the process boundary declaratively: pass ``pipeline_specs=``
(:func:`veles.simd_tpu_torch.pipeline.pipeline_from_spec` specs) to
the group and each child rebuilds, compiles, and registers them before
reporting ready.

What the card changes for a child: the port's device is a process
setting (``utils.config``), which a child does not inherit, so the
parent forwards ``Config.device`` on the child's command line — a
child told ``cuda`` where no card is fails to start, and
:meth:`ReplicaGroup.start` raises (there is no quiet CPU child).  The
parent forwards the kernel library's build directory too
(``ops.cuda_kernels.set_build_root``), and a ``cuda`` child loads the
library its parent built and creates its CUDA context before it
reports ready, so the first request a failover lands there meets a
loaded library, not an ``nvcc`` build inside the spawn timeout.  With
the artifact store armed (``$VELES_SIMD_ARTIFACTS``, inherited from
the parent's environment) a child preloads the warm pack before it
loads the library — the packed library is placed under its build
root, so even a fresh build root runs no nvcc — and its ready line
carries the ``artifact_preload`` report, as a thread replica's
``Server.start`` preloads.  A child that cannot start reports a typed
error line instead of its port, and the parent raises
``RuntimeError``.

Usage::

    from veles.simd_tpu_torch.serve import cluster

    with cluster.ReplicaGroup(3, max_batch=8, obs_port=0) as group:
        router = cluster.FrontRouter(group)
        t = router.submit(op="sosfilt", x=x, params={"sos": sos})
        y = t.result(timeout=5.0)
        group.kill("r0")        # abrupt: queued work fails over
        group.drain("r1")       # graceful: answered, then removed

On the card, chip_smoke's ``fleet`` phase runs the JAX package's
replica campaign (``tools/chaos.py --replicas``) in both spawn modes:
one replica killed without drain and one drained gracefully
mid-traffic, gated on zero lost / zero double-answered requests,
carried failover deadlines, a stitched fleet trace and a live group
``/healthz`` throughout.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.obs import export as obs_export
from veles.simd_tpu_torch.obs import http as obs_http
from veles.simd_tpu_torch.obs import incidents as obs_incidents
from veles.simd_tpu_torch.obs import journal as obs_journal
from veles.simd_tpu_torch.obs import timeseries as _timeseries
from veles.simd_tpu_torch.ops import cuda_kernels as _ck
from veles.simd_tpu_torch.runtime import breaker as _breaker
from veles.simd_tpu_torch.runtime import faults
from veles.simd_tpu_torch.serve import rpc as _rpc
from veles.simd_tpu_torch.serve import scaler as _scaler
from veles.simd_tpu_torch.serve.admission import Overloaded
from veles.simd_tpu_torch.serve.server import (DeadlineExceeded,
                                               Request, Server,
                                               ServerClosed,
                                               classify_request,
                                               env_deadline_ms)
from veles.simd_tpu_torch.utils.config import get_config, set_config

__all__ = [
    "Replica", "ReplicaGroup", "FrontRouter", "RouterTicket",
    "NoReplicaAvailable", "UP", "DRAINING", "DEAD", "RESTARTING",
    "REPLICAS_ENV", "ROUTER_POLICY_ENV", "HEARTBEAT_MS_ENV",
    "OCCUPANCY_WEIGHT_ENV",
    "DEFAULT_REPLICAS", "DEFAULT_HEARTBEAT_MS", "DEFAULT_MISS_LIMIT",
    "DEFAULT_OCCUPANCY_WEIGHT",
    "ROUTER_POLICIES", "env_replicas", "env_router_policy",
    "env_heartbeat_s", "env_occupancy_weight",
]

REPLICAS_ENV = "VELES_SIMD_REPLICAS"
ROUTER_POLICY_ENV = "VELES_SIMD_ROUTER_POLICY"
HEARTBEAT_MS_ENV = "VELES_SIMD_HEARTBEAT_MS"
OCCUPANCY_WEIGHT_ENV = "VELES_SIMD_ROUTER_OCCUPANCY_WEIGHT"

# two replicas is the smallest group with a failover story; the env
# default exists for tooling (loadgen --replicas 0 -> env -> 2)
DEFAULT_REPLICAS = 2
# 100 ms heartbeats notice a wedged replica in ~miss_limit/10 s while
# costing ~10 lock-cheap pings/s per replica
DEFAULT_HEARTBEAT_MS = 100.0
DEFAULT_MISS_LIMIT = 3

LEAST_LOADED = "least_loaded"
ROUND_ROBIN = "round_robin"
ROUTER_POLICIES = (LEAST_LOADED, ROUND_ROBIN)

# replica lifecycle states
UP = "up"
DRAINING = "draining"
DEAD = "dead"
# transient restart() guard state: not placeable, not re-restartable
RESTARTING = "restarting"

# scoring: depth is O(queue); the penalties must dominate any sane
# queue depth so a healthy replica always outranks a degraded one for
# the class, while a lone degraded survivor still takes traffic
# (deprioritized, not blacklisted)
BREAKER_OPEN_PENALTY = 1e3
DEGRADED_PENALTY = 1e6

# padding-aware placement: a replica with a FORMING batch of the
# request's shape class gets a bonus (the request completes that
# batch — riding a padding slot — instead of opening a fresh one
# that will pad).  The term is bounded strictly below 1 request of
# depth so it only breaks near-ties, never outranks real load.
DEFAULT_OCCUPANCY_WEIGHT = 0.5


def env_replicas() -> int:
    """Group size from ``$VELES_SIMD_REPLICAS`` (default 2)."""
    raw = os.environ.get(REPLICAS_ENV, "").strip()
    if not raw:
        return DEFAULT_REPLICAS
    try:
        value = int(raw)
    except ValueError:
        return DEFAULT_REPLICAS
    return value if value >= 1 else DEFAULT_REPLICAS


def env_router_policy() -> str:
    """Placement policy from ``$VELES_SIMD_ROUTER_POLICY``
    (``least_loaded`` default / ``round_robin``)."""
    raw = os.environ.get(ROUTER_POLICY_ENV, "").strip().lower()
    return raw if raw in ROUTER_POLICIES else LEAST_LOADED


def env_heartbeat_s() -> float:
    """Heartbeat interval in seconds from ``$VELES_SIMD_HEARTBEAT_MS``
    (default 100 ms)."""
    raw = os.environ.get(HEARTBEAT_MS_ENV, "").strip()
    if not raw:
        return DEFAULT_HEARTBEAT_MS / 1e3
    try:
        value = float(raw)
    except ValueError:
        return DEFAULT_HEARTBEAT_MS / 1e3
    return (value if value > 0 else DEFAULT_HEARTBEAT_MS) / 1e3


def env_occupancy_weight() -> float:
    """Occupancy-bonus weight for the padding-aware placement term
    from ``$VELES_SIMD_ROUTER_OCCUPANCY_WEIGHT`` (default 0.5;
    0 disables the term; negative / malformed falls back)."""
    raw = os.environ.get(OCCUPANCY_WEIGHT_ENV, "").strip()
    if not raw:
        return DEFAULT_OCCUPANCY_WEIGHT
    try:
        value = float(raw)
    except ValueError:
        return DEFAULT_OCCUPANCY_WEIGHT
    return value if value >= 0 else DEFAULT_OCCUPANCY_WEIGHT


class NoReplicaAvailable(Overloaded):
    """Typed router rejection: no live replica could take the request
    (none up, or the failover budget died with the last candidate).
    An :class:`~veles.simd_tpu_torch.serve.admission.Overloaded` subclass —
    group exhaustion is admission exhaustion at cluster scope, and
    every consumer that already handles typed sheds handles this."""

    def __init__(self, message: str, *, tenant: str = "default"):
        super().__init__(message, tenant=tenant, scope="cluster")


# the directory holding the ``veles`` package: a child imports the port
# from the same checkout as its parent, whatever its working directory
_PACKAGE_ROOT = str(Path(__file__).resolve().parents[3])


def _call_with_timeout(fn, timeout_s: float):
    """Run ``fn()`` under the fault engine's dispatch watchdog
    (:func:`faults._call_with_deadline` — ONE home for the
    abandoned-daemon-thread containment), translating its typed
    :class:`faults.FaultTimeout` into the stdlib TimeoutError the
    spawn-handshake caller classifies on.  Used for the one-shot
    subprocess port handshake; steady-state heartbeats run on
    persistent prober threads instead (no per-call thread churn)."""
    try:
        return faults._call_with_deadline(fn, timeout_s,
                                          "cluster.spawn")
    except faults.FaultTimeout as e:
        raise TimeoutError(str(e)) from e


class Replica:
    """One managed server replica: identity (``rid``), lifecycle
    state, heartbeat bookkeeping, and the spawn-mode-specific start /
    ping / stop plumbing.  Thread mode holds a live in-process
    :class:`Server` (named ``rid``, so its breakers/health are
    replica-keyed); subprocess mode holds a child process, the port
    of its ``/healthz``+``/metrics``+``/submit`` endpoint, and the
    pooled :class:`~veles.simd_tpu_torch.serve.rpc.RpcClient` the router
    places requests through.  ``pipeline_specs`` (declarative
    :func:`~veles.simd_tpu_torch.pipeline.pipeline_from_spec` dicts) are
    forwarded to a subprocess child, which registers the compiled
    chains before reporting ready."""

    def __init__(self, rid: str, *, spawn: str = "thread",
                 server_kwargs: dict | None = None,
                 pipeline_specs: list | None = None):
        self.rid = str(rid)
        self.spawn = spawn
        self.state = UP
        self.misses = 0
        self.last_beat = None
        # birth stamp: the fleet collector exports age as the
        # per-replica ``birth_age_s`` series (scaler/dashboard input)
        self.born = faults.monotonic()
        # last health state a ping observed ("healthy"/"degraded";
        # None = never pinged) — the subprocess aggregation signal,
        # since the group cannot read a child's health machine
        # in-process
        self.last_health = None
        self.server: Server | None = None
        self.proc = None
        self.port = None
        # subprocess mode: seconds from the child's spawn to its ready
        # line (torch import, CUDA context, kernel library, pipelines)
        self.ready_s = None
        # subprocess mode: the child's warm-pack preload report from its
        # ready line (None while the artifact store is off)
        self.artifact_preload = None
        self._launched = None
        # the RPC data plane handle (subprocess mode only): armed in
        # start() once the child reports its port, closed after the
        # child is gone so in-flight answers drain first
        self.rpc: _rpc.RpcClient | None = None
        self._pipeline_specs = [dict(s) for s in
                                (pipeline_specs or [])]
        self._kwargs = dict(server_kwargs or {})
        if spawn == "thread":
            # per-replica endpoints stay disarmed: the group owns ONE
            # aggregation endpoint (N in-process replicas arming N
            # ports from one env var is the EndpointUnavailable story)
            self._kwargs.setdefault("obs_port", -1)
            self.server = Server(name=self.rid, **self._kwargs)
        elif spawn != "subprocess":
            raise ValueError(
                f"spawn must be 'thread' or 'subprocess', got "
                f"{spawn!r}")

    # -- lifecycle ---------------------------------------------------------

    def start(self, spawn_timeout_s: float = 60.0) -> None:
        self._launch()
        self._await_ready(spawn_timeout_s)

    def _launch(self) -> None:
        """Start the thread replica's server, or spawn the child
        process; a child is ready once :meth:`_await_ready` read its
        port (so a group launches its children together, and their
        torch imports and CUDA contexts overlap)."""
        if self.spawn == "thread":
            self.server.start()
            return
        port_arg = int(self._kwargs.get("obs_port") or 0)
        if port_arg < 0:
            raise ValueError(
                "subprocess replicas need a scrape endpoint (their "
                "/healthz IS the heartbeat surface) — obs_port must "
                "be >= 0 (0 = ephemeral), not disarmed")
        # -c instead of -m: the serve package imports this module at
        # init, and runpy warns on re-executing an already-imported
        # submodule in the child
        cmd = [sys.executable, "-c",
               "import sys; "
               "from veles.simd_tpu_torch.serve.cluster import "
               "_replica_main; "
               "sys.exit(_replica_main(sys.argv[1:]))",
               "--obs-port", str(port_arg),
               # the child stamps this identity into its own journal
               # file (it inherits $VELES_SIMD_JOURNAL_DIR and writes
               # journal-<childpid>-*.jsonl in the shared pack), so
               # obs_query can attribute its records after it is dead
               "--name", self.rid,
               # the device is a process setting a child does not
               # inherit; the build root lets a cuda child load the
               # library its parent built instead of running nvcc
               "--device", get_config().device,
               "--build-root", _ck.set_build_root()]
        # forward the server policy knobs the child's Server takes —
        # a subprocess replica must run the operator's batching/worker
        # policy, not silent defaults
        for flag, key in (("--max-batch", "max_batch"),
                          ("--max-wait-ms", "max_wait_ms"),
                          ("--workers", "workers")):
            value = self._kwargs.get(key)
            if value is not None:
                cmd += [flag, str(value)]
        # pipelines cross the process boundary declaratively: the
        # child rebuilds + registers each spec before reporting ready,
        # so the router never places pipeline traffic on a replica
        # that would answer "unregistered pipeline"
        for spec in self._pipeline_specs:
            cmd += ["--pipeline-spec", json.dumps(spec)]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_PACKAGE_ROOT] + [p for p in (env.get("PYTHONPATH") or
                                           "").split(os.pathsep) if p])
        self._launched = faults.monotonic()
        self.proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, env=env)

    def _await_ready(self, spawn_timeout_s: float = 60.0) -> None:
        """Read a launched child's ready line (a no-op in thread mode):
        its port arms the RPC client, a typed error line raises."""
        if self.spawn == "thread":
            return
        # the child prints one JSON line with its bound endpoint port
        # once its server is up (or one with a typed startup error);
        # anything else on stdout is skipped.
        # Each readline runs under the remaining-deadline watchdog —
        # a child that wedges before reporting (and never closes
        # stdout) must raise, not hang group.start() forever.
        deadline = self._launched + spawn_timeout_s
        while True:
            remaining = deadline - faults.monotonic()
            if remaining <= 0:
                self.proc.kill()
                raise TimeoutError(
                    f"replica {self.rid} subprocess did not report "
                    f"its endpoint port within {spawn_timeout_s}s")
            try:
                line = _call_with_timeout(self.proc.stdout.readline,
                                          remaining)
            except TimeoutError:
                self.proc.kill()
                raise TimeoutError(
                    f"replica {self.rid} subprocess did not report "
                    f"its endpoint port within {spawn_timeout_s}s")
            if not line:
                raise RuntimeError(
                    f"replica {self.rid} subprocess exited before "
                    f"reporting its endpoint port "
                    f"(rc={self.proc.poll()})")
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            if isinstance(msg, dict) and msg.get("error"):
                self.proc.wait()
                raise RuntimeError(f"replica {self.rid} subprocess "
                                   f"failed to start: {msg['error']}")
            if isinstance(msg, dict) \
                    and msg.get("port") is not None:
                self.ready_s = faults.monotonic() - self._launched
                self.port = int(msg["port"])
                self.artifact_preload = msg.get("artifact_preload")
                # arm the data plane: pooled keep-alive connections
                # into the child's POST /submit route
                self.rpc = _rpc.RpcClient(obs_http.BIND_HOST,
                                          self.port,
                                          replica=self.rid)
                return

    def ping(self) -> dict:
        """One heartbeat: the ``cluster.heartbeat@<rid>`` injection
        site fires first (deterministic wedge simulation), then the
        replica's health surface is read — in-process stats in thread
        mode, ``GET /healthz`` in subprocess mode (200 *and* 503 are
        beats: a degraded replica is alive).  Any exception is a
        missed beat."""
        faults.inject(f"cluster.heartbeat@{self.rid}")
        if self.spawn == "thread":
            self.last_health = self.server.health
            return {"state": self.last_health,
                    "depth": self.server.depth()}
        import urllib.error
        import urllib.request

        url = f"http://{obs_http.BIND_HOST}:{self.port}/healthz"
        code = 200
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                body = r.read()
        except urllib.error.HTTPError as e:
            if e.code != 503:
                raise
            code, body = e.code, e.read()   # degraded but alive
        parsed = json.loads(body)
        health = parsed.get("health")
        if isinstance(health, dict):
            health = health.get("state")
        self.last_health = ("degraded" if code == 503
                            else health or "healthy")
        return parsed

    def kill(self) -> None:
        """Abrupt stop: no drain — queued work answers ``closed`` (and
        the front router's failover hook re-routes it)."""
        if self.spawn == "thread":
            self.server.stop(drain=False)
        elif self.proc is not None:
            self.proc.kill()
            self.proc.wait()
            if self.rpc is not None:
                # after the child is gone: every in-flight RPC hits a
                # dead socket and answers typed "closed" — the
                # failover hook re-routes exactly as in thread mode
                self.rpc.close()

    def drain_stop(self) -> None:
        """Graceful stop: queued and in-flight work is answered by
        this replica before it exits."""
        if self.spawn == "thread":
            self.server.stop(drain=True)
        elif self.proc is not None:
            try:        # closing stdin asks the child to drain + exit
                self.proc.stdin.close()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.terminate()
                self.proc.wait()
            if self.rpc is not None:
                # the child drained before exiting, so its answers
                # are already on the wire; close() lets the sender
                # threads finish them, then typed-closes stragglers
                self.rpc.close()

    def snapshot(self) -> dict:
        """JSON-native view for the group's aggregation endpoint."""
        info = {"rid": self.rid, "state": self.state,
                "spawn": self.spawn, "misses": self.misses,
                "last_beat": self.last_beat}
        if self.spawn == "thread" and self.state != DEAD:
            info["health"] = self.server.health
            info["depth"] = self.server.depth()
            info["counts"] = self.server.stats()["counts"]
        elif self.spawn == "subprocess":
            # the last ping's observation, not a live read: an
            # unresponsive child keeps its last-known state until the
            # heartbeat machinery drains it
            info["health"] = self.last_health or "healthy"
            info["port"] = self.port
            info["ready_s"] = self.ready_s
            if self.proc is not None:
                info["returncode"] = self.proc.poll()
            if self.rpc is not None:
                # the data-plane health block obs_dash --fleet reads:
                # in-flight, connection-reuse ratio, transport errors
                info["rpc"] = self.rpc.stats()
        return info


class ReplicaGroup:
    """N managed replicas + the heartbeat loop + the aggregation
    endpoint (module docstring has the full story).  ``replicas`` is a
    count (default ``$VELES_SIMD_REPLICAS``); remaining keyword
    arguments are passed to every replica's :class:`Server` in thread
    mode.  Use as a context manager, or :meth:`start`/:meth:`stop`."""

    def __init__(self, replicas: int | None = None, *,
                 spawn: str = "thread",
                 heartbeat_ms: float | None = None,
                 miss_limit: int = DEFAULT_MISS_LIMIT,
                 obs_port: int | None = None,
                 fleet_tick_ms: float | None = None,
                 scaler: bool | None = None,
                 scaler_tick_ms: float | None = None,
                 scaler_kwargs: dict | None = None,
                 pipeline_specs: list | None = None,
                 **server_kwargs):
        n = int(replicas) if replicas else env_replicas()
        if n < 1:
            raise ValueError("a replica group needs >= 1 replica")
        self.spawn = spawn
        self.heartbeat_s = (float(heartbeat_ms) / 1e3
                            if heartbeat_ms else env_heartbeat_s())
        self.miss_limit = int(miss_limit)
        if self.miss_limit < 1:
            raise ValueError("miss_limit must be >= 1")
        self._server_kwargs = dict(server_kwargs)
        # pipelines registered through the GROUP, replayed onto a
        # restarted replica (a fresh Server has no registrations —
        # without the replay, the router would place pipeline traffic
        # onto a replica that answers "unregistered pipeline")
        self._group_pipelines: dict = {}
        # declarative pipeline specs (pipeline_from_spec dicts): the
        # ONE pipeline spelling that survives a process boundary —
        # thread mode compiles + registers them at start(); subprocess
        # children rebuild them from their command line
        self._pipeline_specs = [dict(s) for s in
                                (pipeline_specs or [])]
        self.replicas = [
            Replica(f"r{i}", spawn=spawn,
                    server_kwargs=server_kwargs,
                    pipeline_specs=self._pipeline_specs)
            for i in range(n)]
        self._by_rid = {r.rid: r for r in self.replicas}
        self._lock = threading.Lock()
        self._obs_port_arg = obs_port
        self._endpoint = None
        self._hb_stop = threading.Event()
        self._hb_thread = None
        self._probers: list = []
        # fleet collector (obs v5): cadence from fleet_tick_ms= or
        # $VELES_SIMD_FLEET_TICK_MS; the thread starts in start()
        self.fleet_tick_s = (float(fleet_tick_ms) / 1e3
                             if fleet_tick_ms
                             else _timeseries.env_tick_s())
        self._collector_thread = None
        self._started = False
        self._incidents_hold = False
        # control axis (obs v7): the SLO-driven autoscaler, OFF by
        # default (an idle test group must not get scale-down-drained
        # under the test's feet) — armed by scaler=True or a truthy
        # $VELES_SIMD_SCALER; started/stopped with the group
        self._scaler_armed = (bool(scaler) if scaler is not None
                              else _scaler.armed_by_env())
        self._scaler_tick_s = (float(scaler_tick_ms) / 1e3
                               if scaler_tick_ms else None)
        self._scaler_kwargs = dict(scaler_kwargs or {})
        self._scaler_engine = None
        # spawn_replica() mints r<next>: never reuse a live/dead rid
        self._next_rid = n
        self._sweeps = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReplicaGroup":
        """Start every replica, the heartbeat loop, and (when armed)
        the router-level aggregation endpoint (idempotent)."""
        if self._started:
            return self
        # the endpoint arms first — same contract as Server.start: a
        # bind failure (EndpointUnavailable) leaves nothing running
        if self._obs_port_arg is not None and self._obs_port_arg < 0:
            self._endpoint = None
        else:
            self._endpoint = obs_http.start(self._obs_port_arg,
                                            health=self.stats)
        try:
            # children launch together and are awaited in turn: their
            # torch imports and CUDA contexts overlap
            for r in self.replicas:
                r._launch()
            for r in self.replicas:
                r._await_ready()
        except BaseException:
            for r in self.replicas:
                try:
                    r.kill()
                except Exception:  # noqa: BLE001 — best-effort unwind
                    pass
            if self._endpoint is not None:
                self._endpoint.stop()
                self._endpoint = None
            raise
        self._started = True
        if self.spawn == "thread" and self._pipeline_specs:
            # subprocess children registered their specs before
            # reporting ready; thread replicas compile + register the
            # same specs here, so both spawn modes answer the same
            # pipeline surface
            from veles.simd_tpu_torch import pipeline as _pl

            for spec in self._pipeline_specs:
                self.register_pipeline(spec["name"],
                                       _pl.pipeline_from_spec(spec))
        for r in self.replicas:
            t = threading.Thread(target=self._probe_replica,
                                 args=(r,), daemon=True,
                                 name=f"veles-replica-probe-{r.rid}")
            t.start()
            self._probers.append(t)
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name="veles-replica-heartbeat")
        self._hb_thread.start()
        self._collector_thread = threading.Thread(
            target=self._collector_loop, daemon=True,
            name="veles-fleet-collector")
        self._collector_thread.start()
        # the incident engine rides the collector: it ticks over
        # obs.signals() (which the collector feeds) and serves
        # /incidents on this group's aggregation endpoint; open/close
        # edges flow through record_decision — the journal funnel.
        # Starts are reference-counted, so this group only holds (and
        # later releases) its own share of the process-wide ticker.
        obs_incidents.start()
        self._incidents_hold = True
        # the control axis rides the same feed: the scaler ticks over
        # obs.signals() and acts back through THIS group's verbs; its
        # engine registers module-level so /scaler and
        # obs.scaler_snapshot() serve it
        if self._scaler_armed:
            self._scaler_engine = _scaler.ScalerEngine(
                self, **self._scaler_kwargs)
            _scaler._register(self._scaler_engine)
            self._scaler_engine.start(self._scaler_tick_s)
        obs.gauge("replica_alive", float(self.alive()))
        obs.record_decision("replica_lifecycle", "group_start",
                            replicas=len(self.replicas),
                            spawn=self.spawn)
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the heartbeat loop and every live replica (drained or
        abruptly), then the aggregation endpoint."""
        # the scaler stops FIRST: no verb may fire into a group that
        # is tearing down
        if self._scaler_engine is not None:
            self._scaler_engine.stop()
            _scaler._unregister(self._scaler_engine)
            self._scaler_engine = None
        if self._incidents_hold:
            self._incidents_hold = False
            obs_incidents.stop()
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
            self._hb_thread = None
        if self._collector_thread is not None:
            self._collector_thread.join(timeout=5.0)
            self._collector_thread = None
        for t in self._probers:
            # a prober wedged inside a replica's ping cannot be
            # joined — it is daemon-contained, not waited on
            t.join(timeout=1.0)
        self._probers = []
        for r in self.replicas:
            with self._lock:
                if r.state == DEAD:
                    continue
                r.state = DEAD
            if drain:
                r.drain_stop()
            else:
                r.kill()
        obs.gauge("replica_alive", 0.0)
        if self._endpoint is not None:
            self._endpoint.stop()
            self._endpoint = None

    def __enter__(self) -> "ReplicaGroup":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop(drain=exc_type is None)
        return False

    # -- membership --------------------------------------------------------

    def replica(self, rid: str) -> Replica:
        """The replica named ``rid`` (KeyError otherwise)."""
        return self._by_rid[rid]

    def alive(self) -> int:
        """Replicas currently accepting placements (state UP)."""
        with self._lock:
            return sum(1 for r in self.replicas if r.state == UP)

    def live_replicas(self) -> list:
        """The placeable replicas (state UP), in id order."""
        with self._lock:
            return [r for r in self.replicas if r.state == UP]

    def kill(self, rid: str) -> None:
        """Abrupt removal, no drain: the replica is un-placeable
        immediately, its queued-but-unanswered work answers ``closed``
        and is re-routed by the router's failover hook.  The scripted
        campaign's mid-traffic kill."""
        r = self._by_rid[rid]
        with self._lock:
            if r.state == DEAD:
                return
            r.state = DEAD
        obs.record_decision("replica_lifecycle", "kill", replica=rid)
        obs.count("replica_killed", replica=rid)
        r.kill()
        obs.gauge("replica_alive", float(self.alive()))

    def drain(self, rid: str, reason: str = "operator") -> None:
        """Graceful removal: stop intake (the router skips DRAINING
        replicas), answer everything queued and in flight, then mark
        DEAD.  Subsequent traffic redistributes to the survivors."""
        r = self._by_rid[rid]
        with self._lock:
            if r.state != UP:
                return
            r.state = DRAINING
        obs.record_decision("replica_lifecycle", "drain", replica=rid,
                            reason=reason)
        obs.count("replica_drained", replica=rid)
        r.drain_stop()
        with self._lock:
            r.state = DEAD
        obs.record_decision("replica_lifecycle", "dead", replica=rid,
                            reason=reason)
        obs.gauge("replica_alive", float(self.alive()))

    def restart(self, rid: str) -> Replica:
        """Cold-restart a DEAD replica under the same id: a FRESH
        :class:`Replica` (new Server / new subprocess, the group's
        original server kwargs) replaces the dead record, starts —
        which preloads the warm artifact pack when the store is armed
        (``Server.start``) — and rejoins heartbeating and placement.
        This is the autoscaling/preemption-recovery moment the
        zero-warmup subsystem exists for, and the chaos campaign's
        cold-replica-restart phase gates exactly this path: the
        restarted replica's FIRST request must land within budget of
        the survivors' steady state.  Restarting a live replica is a
        ValueError (kill or drain it first)."""
        with self._lock:
            old = self._by_rid[rid]
            if old.state != DEAD:
                # also closes the concurrent-restart race: the first
                # caller flips the record to RESTARTING under this
                # lock, so a second restart() of the same rid raises
                # instead of starting a twin Server nothing would
                # ever stop
                raise ValueError(
                    f"replica {rid!r} is {old.state!r}, not dead — "
                    "kill() or drain() it before restart()")
            old.state = RESTARTING
        try:
            fresh = Replica(rid, spawn=self.spawn,
                            server_kwargs=self._server_kwargs,
                            pipeline_specs=self._pipeline_specs)
            fresh.start()
            if self.spawn == "thread":
                # a fresh Server has no pipeline registrations —
                # replay the group's so pipeline traffic placed here
                # keeps answering
                for name, compiled in self._group_pipelines.items():
                    fresh.server.register_pipeline(name, compiled)
        except BaseException:
            with self._lock:
                old.state = DEAD     # a failed restart stays dead
            raise
        # treat the successful start as the first beat: the staleness
        # monitor otherwise judges last_beat=None against the GROUP
        # start time and would wedge-drain a replica restarted any
        # real interval later, before its prober's first ping lands
        fresh.last_beat = faults.monotonic()
        with self._lock:
            self._by_rid[rid] = fresh
            self.replicas = [fresh if r.rid == rid else r
                             for r in self.replicas]
        if self._started:
            t = threading.Thread(target=self._probe_replica,
                                 args=(fresh,), daemon=True,
                                 name=f"veles-replica-probe-{rid}")
            t.start()
            self._probers.append(t)
        obs.record_decision("replica_lifecycle", "restart",
                            replica=rid)
        obs.count("replica_restarted", replica=rid)
        obs.gauge("replica_alive", float(self.alive()))
        return fresh

    def spawn_replica(self) -> Replica:
        """Grow the group by one: a FRESH replica under a never-used
        id (``r<next>``) starts — preloading the warm artifact pack
        when the store is armed, the ~23%-of-cold birth the scaler's
        scale-up counts on — gets the group's pipeline registrations
        replayed, and joins heartbeating and placement.  The scaler's
        scale-up verb; also an operator verb in its own right."""
        if not self._started:
            raise ValueError(
                "spawn_replica() needs a started group (the probers "
                "and collector it joins only run after start())")
        with self._lock:
            rid = f"r{self._next_rid}"
            self._next_rid += 1
        fresh = Replica(rid, spawn=self.spawn,
                        server_kwargs=self._server_kwargs,
                        pipeline_specs=self._pipeline_specs)
        fresh.start()
        if self.spawn == "thread":
            for name, compiled in self._group_pipelines.items():
                fresh.server.register_pipeline(name, compiled)
        # the successful start is the first beat (same staleness
        # rationale as restart())
        fresh.last_beat = faults.monotonic()
        with self._lock:
            self.replicas = self.replicas + [fresh]
            self._by_rid[rid] = fresh
        t = threading.Thread(target=self._probe_replica,
                             args=(fresh,), daemon=True,
                             name=f"veles-replica-probe-{rid}")
        t.start()
        self._probers.append(t)
        obs.record_decision("replica_lifecycle", "spawn",
                            replica=rid)
        obs.count("replica_spawned", replica=rid)
        obs.gauge("replica_alive", float(self.alive()))
        return fresh

    def retire(self, rid: str, reason: str = "scale_down") -> None:
        """Shrink the group by one: gracefully :meth:`drain` ``rid``
        (zero lost by construction), then REMOVE it from membership —
        unlike a plain drain, the record does not linger as a DEAD
        replica, so the fleet collector stops sampling it (and
        forgets its series) and the incident engine's ``replica_down``
        rule does not fire forever on an intentional scale-down.  The
        scaler's scale-down verb."""
        self.drain(rid, reason=reason)
        with self._lock:
            self._by_rid.pop(rid, None)
            self.replicas = [x for x in self.replicas
                             if x.rid != rid]
        obs.record_decision("replica_lifecycle", "retire",
                            replica=rid, reason=reason)
        obs.count("replica_retired", replica=rid)
        obs.gauge("replica_alive", float(self.alive()))

    def register_pipeline(self, name: str, compiled) -> str:
        """Register a compiled pipeline on EVERY thread-mode replica
        (the group twin of :meth:`Server.register_pipeline`); returns
        the op string.  Recorded group-side too, so a replica revived
        by :meth:`restart` gets the same registrations replayed."""
        if self.spawn != "thread":
            raise ValueError(
                "a compiled pipeline cannot cross a process boundary "
                "— pass pipeline_specs= (declarative "
                "pipeline_from_spec dicts) to the group instead; "
                "subprocess replicas rebuild and register them "
                "before taking traffic")
        op = None
        for r in self.replicas:
            op = r.server.register_pipeline(name, compiled)
        self._group_pipelines[str(name)] = compiled
        return op

    # -- heartbeats --------------------------------------------------------
    #
    # One PERSISTENT prober thread per replica (no per-ping watchdog
    # threads — a 100 ms cadence over N replicas would otherwise mint
    # 10*N threads/s steady-state): the prober pings on the cadence,
    # stamping last_beat / counting misses; a ping that RAISES (the
    # injected-wedge form) counts a miss immediately, and a ping that
    # BLOCKS wedges only its own prober — the monitor loop notices
    # the stale last_beat and triggers the same auto-drain, so a
    # truly wedged replica is contained by exactly one abandoned
    # thread, never an accumulating pile.

    def _mark_wedged(self, r: Replica, reason: str) -> None:
        obs.record_decision("replica_lifecycle", "wedged",
                            replica=r.rid, misses=r.misses,
                            error=reason[:200])
        # auto-drain off-thread: state flips to DRAINING inside
        # drain() immediately (intake stops), while a truly wedged
        # stop can block only its own daemon thread
        threading.Thread(target=self.drain, args=(r.rid, "wedged"),
                         daemon=True,
                         name=f"veles-replica-drain-{r.rid}").start()

    def _probe_replica(self, r: Replica) -> None:
        while r.state == UP and not self._hb_stop.is_set():
            try:
                r.ping()
            except Exception as e:  # noqa: BLE001 — any = miss
                r.misses += 1
                obs.count("replica_heartbeat_miss", replica=r.rid)
                if r.misses >= self.miss_limit and r.state == UP:
                    self._mark_wedged(r, str(e))
                    return
            else:
                r.misses = 0
                r.last_beat = faults.monotonic()
            self._hb_stop.wait(self.heartbeat_s)

    def _heartbeat_loop(self) -> None:
        """The staleness monitor: a prober whose ping BLOCKS can't
        count its own misses — this loop watches last_beat age and
        drains a replica whose beats stopped arriving.  The floor is
        seconds-scale on purpose: a CPU-bound XLA compile holds the
        GIL long enough to starve a perfectly healthy prober for
        hundreds of milliseconds, and a starved prober must never
        read as a wedged replica (a ping that RAISES is the fast
        path — the prober counts those misses itself on the
        heartbeat cadence)."""
        stale_s = max(self.miss_limit * self.heartbeat_s, 5.0)
        started = faults.monotonic()
        while not self._hb_stop.wait(self.heartbeat_s):
            now = faults.monotonic()
            for r in self.replicas:
                if r.state != UP:
                    continue
                ref = r.last_beat if r.last_beat is not None \
                    else started
                if now - ref > stale_s:
                    r.misses = max(r.misses, self.miss_limit)
                    obs.count("replica_heartbeat_miss",
                              replica=r.rid)
                    self._mark_wedged(
                        r, f"no heartbeat for {now - ref:.2f}s "
                           f"(stale after {stale_s:.2f}s)")

    # -- fleet collector (obs v5) ------------------------------------------
    #
    # One daemon thread sweeping the whole group on the fleet tick:
    # strictly additive telemetry — a sweep never mutates replica
    # state, never blocks intake, and never raises out of its loop.
    # Thread-mode replicas are sampled in-process (lock-cheap depth /
    # health / count reads); subprocess replicas are scraped over
    # their own /metrics endpoints, where a dead or wedged child is a
    # COUNTED fleet_scrape_stale and a widening staleness_s in the
    # signals, never an exception (the child's liveness verdict
    # belongs to the heartbeat machinery, not the collector).

    def _collector_loop(self) -> None:
        while not self._hb_stop.wait(self.fleet_tick_s):
            try:
                self._collect_fleet_sample()
            except Exception:  # noqa: BLE001 — sampling never kills
                obs.count("fleet_collector_error")

    def _collect_fleet_sample(self) -> None:
        """THE cross-replica metrics funnel (lint-enforced —
        tools/lint.py fleet funnel rule): the only place serve/cluster
        code may read another replica's metrics (in-process reads,
        ``/metrics`` scrapes, registry walks).  Everything it learns
        lands in the fleet store via ``obs.fleet_record``; consumers
        read it back through the typed ``obs.signals()`` facade."""
        now = faults.monotonic()
        store = obs.fleet_series()
        store.tick_s = self.fleet_tick_s
        breakers = None
        total_depth = 0.0
        with self._lock:
            # membership can move under the sweep now (spawn_replica
            # / retire): sample a consistent snapshot
            replicas = list(self.replicas)
        for r in replicas:
            obs.fleet_record(r.rid, "up",
                             1.0 if r.state == UP else 0.0, t_s=now)
            born = getattr(r, "born", None)
            if born is not None:
                obs.fleet_record(r.rid, "birth_age_s",
                                 max(0.0, now - born), t_s=now)
            if r.state != UP:
                continue
            if r.spawn == "thread":
                depth = float(r.server.depth())
                counts = r.server.counts()
                obs.fleet_record(r.rid, "depth", depth, t_s=now)
                # open-batch occupancy: rows queued in forming
                # batches — the padding-aware placement signal,
                # exported so dashboards/autoscalers see where
                # batches are forming across the fleet
                obs.fleet_record(r.rid, "occupancy",
                                 float(r.server.occupancy()),
                                 t_s=now)
                obs.fleet_record(
                    r.rid, "healthy",
                    1.0 if r.server.health == "healthy" else 0.0,
                    t_s=now)
                obs.fleet_record(r.rid, "completed",
                                 float(counts["completed"]), t_s=now)
                obs.fleet_record(r.rid, "shed",
                                 float(counts["shed"]), t_s=now)
                total_depth += depth
                if breakers is None:    # one registry walk per sweep
                    breakers = _breaker.snapshot()
                opens = sum(
                    1 for b in breakers
                    if b["site"] in ("serve.dispatch",
                                     "pipeline.dispatch")
                    and b["state"] == _breaker.OPEN
                    and b["key"].startswith(f"('{r.rid}'"))
                obs.fleet_record(r.rid, "breaker_open",
                                 float(opens), t_s=now)
            else:
                import urllib.request

                rpc = getattr(r, "rpc", None)
                if rpc is not None:
                    # the data plane's own health, sampled from the
                    # parent-side client (no scrape needed): what
                    # obs_dash --fleet shows next to scrape staleness
                    rstats = rpc.stats()
                    obs.fleet_record(r.rid, "rpc_in_flight",
                                     float(rstats["in_flight"]),
                                     t_s=now)
                    obs.fleet_record(
                        r.rid, "rpc_reuse_ratio",
                        float(rstats["reuse_ratio"] or 0.0),
                        t_s=now)
                    obs.fleet_record(
                        r.rid, "rpc_transport_errors",
                        float(rstats["transport_errors"]), t_s=now)
                url = (f"http://{obs_http.BIND_HOST}:{r.port}"
                       f"/metrics")
                try:
                    with urllib.request.urlopen(
                            url, timeout=max(1.0,
                                             2 * self.fleet_tick_s)
                            ) as resp:
                        text = resp.read().decode("utf-8")
                    parsed = obs_export.parse_prometheus(text)
                except Exception:  # noqa: BLE001 — counted staleness
                    obs.count("fleet_scrape_stale", replica=r.rid)
                    continue
                completed = sum(
                    v for (name, _), v in parsed.items()
                    if name == "veles_simd_serve_completed_total")
                obs.fleet_record(r.rid, "completed", completed,
                                 t_s=now)
                obs.fleet_record(r.rid, "scraped_series",
                                 float(len(parsed)), t_s=now)
                obs.fleet_record(
                    r.rid, "healthy",
                    0.0 if r.last_health == "degraded" else 1.0,
                    t_s=now)
        obs.fleet_record("_fleet", "queue_depth_total", total_depth,
                         t_s=now)
        # replica-count series (scaler + dashboard input): how many
        # members sit in each lifecycle bucket right now
        obs.fleet_record("_fleet", "replica_count_up", float(
            sum(1 for r in replicas if r.state == UP)), t_s=now)
        obs.fleet_record("_fleet", "replica_count_draining", float(
            sum(1 for r in replicas if r.state == DRAINING)), t_s=now)
        obs.fleet_record("_fleet", "replica_count_down", float(
            sum(1 for r in replicas
                if r.state in (DEAD, RESTARTING))), t_s=now)
        for tenant, acct in sorted(
                (obs.slo_snapshot().get("accounts") or {}).items()):
            burn = acct.get("burn_rate")
            if burn is not None:
                obs.fleet_record("_fleet", f"slo_burn:{tenant}",
                                 float(burn), t_s=now)
        # a retired replica leaves membership — drop its rings, or
        # its aging samples read as a "stale" replica forever
        known = {r.rid for r in replicas} | {"_fleet"}
        for ghost in store.replicas():
            if ghost not in known:
                store.forget(ghost)
        store.tick()
        # the group owner reclaims journal segments from dead pids
        # (killed subprocess replicas, previous campaign epochs):
        # rotation's own-pid pruning never touches them, so the pack
        # would otherwise outgrow its total-disk budget forever.
        # Every ~64 sweeps (~6 s at the default tick) is plenty.
        self._sweeps += 1
        if self._sweeps % 64 == 0 and obs_journal.armed():
            live = [r.proc.pid for r in replicas
                    if r.proc is not None and r.proc.poll() is None]
            pruned = obs_journal.prune_foreign(live_pids=live)
            if pruned:
                obs.count("journal_pruned_foreign", pruned)

    # -- introspection -----------------------------------------------------

    @property
    def obs_port(self) -> int | None:
        """The aggregation endpoint's bound port (None = disarmed)."""
        return self._endpoint.port if self._endpoint else None

    def stats(self) -> dict:
        """JSON-native aggregate: per-replica snapshots plus the
        group ``health`` block the scrape endpoint's ``/healthz``
        answers from — ``healthy`` while at least one replica is up
        and healthy (503 only once the whole group is gone), so the
        router-level endpoint stays live through single-replica kills
        and drains."""
        snaps = [r.snapshot() for r in self.replicas]
        up_healthy = sum(
            1 for s in snaps
            if s["state"] == UP and s.get("health", "healthy")
            != "degraded")
        eng = self._scaler_engine
        return {
            "replicas": snaps,
            "alive": self.alive(),
            "spawn": self.spawn,
            "heartbeat_s": self.heartbeat_s,
            "miss_limit": self.miss_limit,
            "health": {"state": "healthy" if up_healthy
                       else "degraded",
                       "up_healthy": up_healthy},
            "obs_port": self.obs_port,
            "scaler": eng.summary() if eng is not None else None,
        }


class RouterTicket:
    """The caller's handle on one routed request — the
    :class:`~veles.simd_tpu_torch.serve.server.Ticket` contract (``result``
    / ``done`` / ``status`` / ``degraded`` / ``trace`` / ``wait_s``),
    completed exactly once by the router whatever the backend story
    (dedup by router rid: a late duplicate completion is counted
    ``router_dedup`` and dropped, so group-wide zero-double-answer
    accounting holds).  ``replica`` is the replica that answered,
    ``failovers`` how many re-submissions it took, ``prior_traces``
    the terminal traces of the attempts that died under the request
    (the killed-replica evidence the chaos campaign gates), and
    ``deadlines_ms`` the deadline stamped on each attempt — the
    carried-deadline proof: entries only ever shrink."""

    __slots__ = ("rid", "op", "tenant", "status", "wait_s", "trace",
                 "replica", "failovers", "prior_traces",
                 "deadlines_ms", "attempt_replicas", "_event",
                 "_value", "_error", "_lock")

    def __init__(self, rid: int, op: str, tenant: str):
        self.rid = rid
        self.op = op
        self.tenant = tenant
        self.status = "pending"
        self.wait_s = None
        self.trace = None
        self.replica = None
        self.failovers = 0
        self.prior_traces: list = []
        self.deadlines_ms: list = []
        # the replica each attempt was placed on, in attempt order —
        # what lets obs.stitch_fleet_trace name every track of the
        # stitched fleet trace
        self.attempt_replicas: list = []
        self._event = threading.Event()
        self._value = None
        self._error = None
        self._lock = threading.Lock()

    def _complete(self, *, value=None, error=None, status="ok",
                  wait_s=None, trace=None, replica=None) -> bool:
        with self._lock:
            if self.status != "pending":
                obs.count("router_dedup", op=self.op)
                return False
            self._value = value
            self._error = error
            self.status = status
            self.wait_s = wait_s
            if trace is not None:
                self.trace = trace
            if self.trace is not None \
                    and getattr(self.trace, "status", None) \
                    not in (None, status):
                # a dead-end completion (router-side expiry, group
                # exhaustion) whose retained trace closed under a
                # DIFFERENT status: the trace belongs to a failed
                # attempt, not this answer — retain it as evidence,
                # never as the ticket's own chain (a status-mismatched
                # trace would read as an orphan to the completeness
                # gates).  Identity-guarded: the failover path may
                # have filed this same attempt already.
                if all(tr is not self.trace
                       for tr in self.prior_traces):
                    self.prior_traces.append(self.trace)
                self.trace = None
            self.replica = replica
        self._event.set()
        return True

    def done(self) -> bool:
        """Answered (any status but ``pending``)?"""
        return self._event.is_set()

    @property
    def degraded(self) -> bool:
        """Was the answer served by a replica's oracle path?"""
        return self.status == "degraded"

    def result(self, timeout: float | None = None):
        """Block for the answer; same contract as
        :meth:`veles.simd_tpu_torch.serve.server.Ticket.result`."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"routed request {self.op!r} unanswered after "
                f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._value


class FrontRouter:
    """Breaker-aware placement + failover over a
    :class:`ReplicaGroup` — thread-mode replicas through in-process
    submits, subprocess replicas through their pooled
    :class:`~veles.simd_tpu_torch.serve.rpc.RpcClient` data plane, both
    through the same ``_submit_to_replica`` funnel so the failover /
    shed / carried-deadline semantics are identical (module
    docstring has the full story).

    ``policy`` is ``least_loaded`` (default;
    ``$VELES_SIMD_ROUTER_POLICY``) or ``round_robin``;
    ``max_failovers`` is the shared re-submission budget per request
    (default: one attempt per additional replica)."""

    def __init__(self, group: ReplicaGroup, *,
                 policy: str | None = None,
                 max_failovers: int | None = None,
                 occupancy_weight: float | None = None):
        self.group = group
        self.policy = policy or env_router_policy()
        if self.policy not in ROUTER_POLICIES:
            raise ValueError(
                f"unknown router policy {self.policy!r} "
                f"(known: {', '.join(ROUTER_POLICIES)})")
        self.max_failovers = (
            int(max_failovers) if max_failovers is not None
            else max(1, len(group.replicas) - 1))
        self.occupancy_weight = (
            float(occupancy_weight) if occupancy_weight is not None
            else env_occupancy_weight())
        self._lock = threading.Lock()
        self._rids = itertools.count()
        self._rr = itertools.count()
        self._placed: dict = {}
        self._answered: dict = {}
        self._failovers = 0
        self._placement_failures = 0

    # -- scoring -----------------------------------------------------------

    def score(self, replica: Replica, key) -> float:
        """Placement cost of ``replica`` for shape class ``key``:
        admitted depth, plus the DEGRADED-health penalty, plus the
        open-breaker penalty when THIS class's breaker on THIS
        replica is open (per shape class — an open sosfilt breaker
        does not deprioritize the replica's stft traffic), minus the
        padding-aware **occupancy bonus**: a replica whose batcher
        already holds a forming batch of this class scores lower (the
        new request completes that batch, riding a row slot that
        would otherwise dispatch as zero padding).  The bonus is
        ``occupancy_weight * min(occ, max_batch-1)/max_batch`` —
        bounded strictly below one queued request at the default
        weight, so occupancy breaks near-ties but never outranks real
        load (or either penalty).

        A SUBPROCESS replica scores on what the parent can see
        without a round trip: the RPC client's in-flight count is
        the depth signal (requests submitted, not yet answered —
        the same O(queue) magnitude), and the last heartbeat's
        health observation stands in for the health machine.  Its
        breaker and batch-occupancy terms live in the child and are
        not scored — depth dominates placement in practice, and a
        child's dispatch failures still surface as shed/degraded
        answers the failover hook acts on."""
        if replica.spawn != "thread":
            s = (float(replica.rpc.in_flight())
                 if replica.rpc is not None else 0.0)
            if replica.last_health == "degraded":
                s += DEGRADED_PENALTY
            return s
        server = replica.server
        s = float(server.depth())
        if server.health == "degraded":
            s += DEGRADED_PENALTY
        # ragged classes carry their breaker on the packed-dispatch
        # site (the per-segment salvage lives inside it); plain
        # classes on the serve dispatch — score must read the breaker
        # the dispatch will actually consult
        site = ("segments.dispatch"
                if isinstance(key, tuple) and key
                and key[-1] == "ragged" else "serve.dispatch")
        br = _breaker.lookup(site, server.breaker_key(key))
        if br is not None and br.state == _breaker.OPEN:
            s += BREAKER_OPEN_PENALTY
        if self.occupancy_weight:
            occ = server.open_occupancy(key)
            if occ > 0:
                mb = max(1, server.max_batch)
                s -= self.occupancy_weight * min(occ, mb - 1) / mb
        return s

    def _pick(self, key, exclude) -> Replica | None:
        alive = self.group.live_replicas()
        if not alive:
            return None
        fresh = [r for r in alive if r.rid not in exclude]
        # every survivor already tried: the failover budget (not the
        # exclusion set) is the retry bound — re-trying a survivor
        # beats failing a placeable request
        candidates = fresh or alive
        if self.policy == ROUND_ROBIN:
            return candidates[next(self._rr) % len(candidates)]
        return min(candidates, key=lambda r: (self.score(r, key),
                                              r.rid))

    # -- intake ------------------------------------------------------------

    def submit(self, request: Request | None = None, *,
               op: str | None = None, x=None,
               params: dict | None = None, tenant: str = "default",
               block: bool = False, timeout: float | None = None,
               deadline_ms: float | None = None) -> RouterTicket:
        """Place one request on the group; returns its
        :class:`RouterTicket`.  Same call shape as
        :meth:`Server.submit`.  The end-to-end deadline (argument,
        request field, or the ``VELES_SIMD_SERVE_DEADLINE_MS``
        default) is resolved ONCE here to an absolute stamp; every
        placement and failover re-submission carries the remaining
        budget of that one deadline."""
        if request is None:
            request = Request(op=op, x=x, params=params or {},
                              tenant=tenant)
        key = self._shape_class(request)
        dl_ms = deadline_ms
        if dl_ms is None:
            dl_ms = request.deadline_ms
        if dl_ms is None:
            dl_ms = env_deadline_ms()
        has_deadline = dl_ms is not None and dl_ms > 0
        ticket = RouterTicket(next(self._rids), request.op,
                              request.tenant)
        ctx = {
            "deadline": (faults.monotonic() + float(dl_ms) / 1e3
                         if has_deadline else None),
            "attempts": 0,
            "tried": set(),
            "block": block,
            "timeout": timeout,
        }
        self._place(ticket, request, key, ctx)
        return ticket

    def _shape_class(self, request: Request) -> tuple:
        """The request's shape-class triple — derived by the SAME
        helper the replica's submit uses (:func:`veles.simd_tpu_torch.
        serve.server.classify_request`), so scoring reads exactly the
        breaker the dispatch will consult.  Validation errors raise
        synchronously, exactly like a direct submit."""
        return classify_request(request.op, request.x,
                                request.params)[3]

    # -- placement + failover ----------------------------------------------

    def _place(self, ticket: RouterTicket, request: Request, key,
               ctx) -> None:
        """Place (or re-place) one request: pick a survivor, submit
        through the guarded funnel, arm the failover hook.  Placement
        failure (a replica racing death) retries the next candidate;
        group exhaustion answers typed."""
        # bounded by construction: each pass either returns or burns
        # one placement-failure credit (a replica can only race death
        # once per request, but the explicit bound keeps a bookkeeping
        # bug from ever spinning here)
        credits = len(self.group.replicas) + self.max_failovers + 1
        while True:
            credits -= 1
            if ticket.done():
                return
            if credits < 0:
                ticket._complete(
                    error=NoReplicaAvailable(
                        f"RESOURCE_EXHAUSTED: placement retries "
                        f"exhausted for {request.op!r}",
                        tenant=request.tenant),
                    status="shed" if ticket.trace is None
                    else "closed")
                return
            if ctx["deadline"] is not None \
                    and faults.monotonic() >= ctx["deadline"]:
                ticket._complete(
                    error=DeadlineExceeded(
                        f"DEADLINE_EXCEEDED: routed request "
                        f"{request.op!r} exhausted its end-to-end "
                        f"deadline before a replica answered"),
                    status="expired")
                return
            target = self._pick(key, ctx["tried"])
            if target is None:
                ticket._complete(
                    error=NoReplicaAvailable(
                        f"RESOURCE_EXHAUSTED: no live replica for "
                        f"{request.op!r} "
                        f"(group alive={self.group.alive()})",
                        tenant=request.tenant),
                    status="shed" if ticket.trace is None
                    else "closed")
                return
            try:
                backend = self._submit_to_replica(target, request,
                                                  ctx)
            except ServerClosed:
                # raced a kill/drain between pick and submit: typed
                # placement failure, try the next survivor
                ctx["tried"].add(target.rid)
                with self._lock:
                    self._placement_failures += 1
                obs.count("router_placement_failure",
                          replica=target.rid)
                continue
            with self._lock:
                self._placed[target.rid] = \
                    self._placed.get(target.rid, 0) + 1
            obs.count("router_placed", replica=target.rid,
                      policy=self.policy)
            ticket.attempt_replicas.append(target.rid)
            ticket.trace = backend.trace
            backend.add_done_callback(
                lambda t, r=target: self._on_backend(
                    ticket, request, key, ctx, r, t))
            return

    def _submit_to_replica(self, replica: Replica, request: Request,
                           ctx):
        """THE guarded dispatch funnel: the only call site allowed to
        submit into a replica (lint-enforced — tools/lint.py cluster
        router rule), so every placement path shares the
        carried-deadline arithmetic and the typed placement-failure
        handling around it."""
        remaining_ms = None
        if ctx["deadline"] is not None:
            remaining_ms = max(
                0.001, (ctx["deadline"] - faults.monotonic()) * 1e3)
        ctx.setdefault("stamps", []).append(remaining_ms)
        if replica.spawn == "thread":
            return replica.server.submit(
                request, block=ctx["block"], timeout=ctx["timeout"],
                deadline_ms=remaining_ms)
        if replica.rpc is None:
            # racing the replica's own start/stop window: typed
            # placement failure, same as submitting into a closed
            # server — the caller tries the next survivor
            raise ServerClosed(
                f"replica {replica.rid} has no armed RPC data plane")
        return replica.rpc.submit(
            request, block=ctx["block"], timeout=ctx["timeout"],
            deadline_ms=remaining_ms)

    def _on_backend(self, ticket: RouterTicket, request: Request,
                    key, ctx, replica: Replica, backend) -> None:
        """One backend ticket went terminal: answer the router
        ticket, or fail the request over to a survivor."""
        status = backend.status
        if status in ("ok", "degraded"):
            if ticket._complete(
                    value=backend._value, status=status,
                    wait_s=backend.wait_s, trace=backend.trace,
                    replica=replica.rid):
                with self._lock:
                    self._answered[replica.rid] = \
                        self._answered.get(replica.rid, 0) + 1
            return
        if status == "expired":
            # the request's OWN deadline — failing over cannot help
            ticket._complete(error=backend._error, status="expired",
                             trace=backend.trace,
                             replica=replica.rid)
            return
        if status in ("closed", "shed") \
                and ctx["attempts"] < self.max_failovers:
            # the replica died under the request (closed) or shed it
            # (overload): re-route onto a survivor, original deadline
            # and the SHARED failover budget carried over
            ctx["attempts"] += 1
            ctx["tried"].add(replica.rid)
            ticket.failovers = ctx["attempts"]
            ticket.prior_traces.append(backend.trace)
            ticket.deadlines_ms = list(ctx.get("stamps", []))
            with self._lock:
                self._failovers += 1
            obs.count("router_failover", replica=replica.rid,
                      reason=status)
            obs.record_decision("router_failover", status,
                                replica=replica.rid,
                                request_op=request.op,
                                attempt=ctx["attempts"])
            self._place(ticket, request, key, ctx)
            ticket.deadlines_ms = list(ctx.get("stamps", []))
            return
        # terminal without recourse: propagate the typed error
        ticket._complete(error=backend._error, status=status,
                         trace=backend.trace, replica=replica.rid)

    # -- introspection -----------------------------------------------------

    @property
    def obs_port(self) -> int | None:
        """The group aggregation endpoint's port (scrape target)."""
        return self.group.obs_port

    def stats(self) -> dict:
        """JSON-native router view: per-replica placement/answer
        tallies, failover/dedup/placement-failure counts, and the
        group aggregate (so a router handle quacks like a server for
        health-minded consumers)."""
        with self._lock:
            placed = dict(sorted(self._placed.items()))
            answered = dict(sorted(self._answered.items()))
            failovers = self._failovers
            placement_failures = self._placement_failures
        group = self.group.stats()
        return {
            "policy": self.policy,
            "max_failovers": self.max_failovers,
            "placed_by_replica": placed,
            "answered_by_replica": answered,
            "failovers": failovers,
            "placement_failures": placement_failures,
            "group": group,
            "health": group["health"],
        }


# ---------------------------------------------------------------------------
# subprocess replica entry point (the spawn="subprocess" child's body)
# ---------------------------------------------------------------------------


def _child_ready(device: str) -> None:
    """Make a child ready for its first request on ``device``: on the
    card, create the CUDA context and load the kernel library (built by
    the parent, found under the forwarded build root, or placed there
    by the warm pack's preload), so a failover's first request here
    meets a loaded library.  Raises where ``cuda`` is asked and no card
    is present."""
    if device != "cuda":
        return
    import torch

    from veles.simd_tpu_torch.utils import platform as _platform

    _platform.device()          # raises without a card
    torch.zeros(1, device="cuda")
    _ck.load_library()


def _replica_main(argv=None) -> int:
    """Run ONE replica server in this process: arm its scrape
    endpoint, report the bound port as a JSON line on stdout, serve
    until stdin closes (the parent's graceful-drain signal), then
    drain and exit.  A start that fails reports ``{"error": ...,
    "kind": ...}`` on stdout instead and exits 1.  The
    ``spawn='subprocess'`` child body."""
    import argparse

    ap = argparse.ArgumentParser(description=_replica_main.__doc__)
    ap.add_argument("--obs-port", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=None)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--name", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--build-root", default=None,
                    help="the kernel library's build directory "
                         "(ops.cuda_kernels.set_build_root)")
    ap.add_argument("--pipeline-spec", action="append", default=[],
                    help="declarative pipeline_from_spec JSON; "
                         "repeatable — each is compiled and "
                         "registered before the replica reports "
                         "ready")
    args = ap.parse_args(argv)
    set_config(device=args.device)
    if args.build_root:
        _ck.set_build_root(args.build_root)
    obs.enable()
    # history axis: every record this process journals carries its
    # replica identity (the pack is shared; the pid alone names the
    # file, the replica names the story)
    obs_journal.set_replica(args.name or f"pid-{os.getpid()}")
    kwargs = {}
    if args.workers:
        kwargs["workers"] = args.workers
    srv = Server(max_batch=args.max_batch,
                 max_wait_ms=args.max_wait_ms,
                 obs_port=args.obs_port, **kwargs)
    try:
        # the warm pack goes under the build root before the library's
        # first load, so that load finds it built (no nvcc)
        srv._warm_pack()
        _child_ready(args.device)
        if args.pipeline_spec:
            from veles.simd_tpu_torch import pipeline as _pl

            # registration precedes start(): by the time the port is
            # on stdout (and the router starts placing), every
            # pipeline the group promised answers here
            for raw in args.pipeline_spec:
                spec = json.loads(raw)
                srv.register_pipeline(spec["name"],
                                      _pl.pipeline_from_spec(spec))
        srv.start()
    except Exception as e:  # noqa: BLE001 — reported typed, then exit
        print(json.dumps({"error": f"{type(e).__name__}: {e}",
                          "kind": type(e).__name__}), flush=True)
        return 1
    ready = {"port": srv.obs_port, "pid": os.getpid(),
             "device": args.device}
    if srv._preload is not None:
        ready["artifact_preload"] = srv._preload
    print(json.dumps(ready), flush=True)
    try:
        sys.stdin.read()        # parked until the parent lets go
    except Exception:  # noqa: BLE001 — any stdin failure = shutdown
        pass
    srv.stop(drain=True)
    return 0


if __name__ == "__main__":      # pragma: no cover — subprocess body
    sys.exit(_replica_main())
