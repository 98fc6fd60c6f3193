"""veles.simd_tpu_torch.serve — the request path in front of the ops.

The port of ``veles.simd_tpu.serve``'s core: every op of the library is
a one-shot call, which at short-signal sizes is dispatch-bound; the
throughput form of heterogeneous traffic is *coalesced* dispatch.  This
package is the serving loop that coalesces and keeps answering when the
traffic or the card misbehaves:

* :class:`~veles.simd_tpu_torch.serve.server.Server` — submit
  :class:`~veles.simd_tpu_torch.serve.server.Request`\\ s
  (op + signal + params + tenant), get
  :class:`~veles.simd_tpu_torch.serve.server.Ticket`\\ s; requests are
  bucketed by shape class, zero-padded to power-of-two buckets and
  dispatched as batches through :mod:`veles.simd_tpu_torch.ops.batched`
  (one copy of each batch back to the host);
* :mod:`~veles.simd_tpu_torch.serve.batcher` — the dynamic-batching
  policy: a bucket dispatches when full (``max_batch``) or when its
  oldest request hits the latency deadline (``max_wait``);
* :mod:`~veles.simd_tpu_torch.serve.admission` — bounded
  global/per-tenant queue depth; over-limit submits are answered
  *immediately* with a typed
  :class:`~veles.simd_tpu_torch.serve.admission.Overloaded`, or block
  with a deadline when the caller opts into backpressure;
* :mod:`~veles.simd_tpu_torch.serve.health` — the HEALTHY/DEGRADED
  state machine over :func:`veles.simd_tpu_torch.runtime.faults.
  guarded` dispatch: transient device faults retry, persistent ones
  degrade the server to the NumPy oracle while zero-retry probes hunt
  for recovery;
* **end-to-end deadlines + per-class breakers** —
  ``submit(deadline_ms=...)`` (default ``VELES_SIMD_SERVE_DEADLINE_MS``)
  bounds a request's total time in the system, and each shape class
  dispatches through its own circuit breaker
  (:mod:`veles.simd_tpu_torch.runtime.breaker`).

* :mod:`~veles.simd_tpu_torch.serve.cluster` — the replica layer:
  :class:`~veles.simd_tpu_torch.serve.cluster.ReplicaGroup` (N servers
  as threads of this process or as child processes, heartbeats, kill,
  drain, restart, spawn, retire, the fleet collector) behind a
  breaker-aware :class:`~veles.simd_tpu_torch.serve.cluster.
  FrontRouter` (placement, failover with the deadline carried, dedup);
* :mod:`~veles.simd_tpu_torch.serve.rpc` — the RPC data plane a
  subprocess replica serves on ``POST /submit`` (npy frames
  byte-identical to the JAX package's, pooled keep-alive connections,
  the typed errors carried both ways);
* :mod:`~veles.simd_tpu_torch.serve.scaler` — the SLO-driven autoscaler
  over ``obs.signals()`` that acts only through the group's verbs.

The artifact store's warm pack (``runtime/artifacts.py``: the packed
kernel library) is preloaded by ``Server.start`` when
``$VELES_SIMD_ARTIFACTS`` arms the store, in every replica, and by a
subprocess replica before it loads the library.

Knobs (constructor args override the environment):
``VELES_SIMD_SERVE_MAX_BATCH``, ``VELES_SIMD_SERVE_MAX_WAIT_MS``,
``VELES_SIMD_SERVE_QUEUE_DEPTH``, ``VELES_SIMD_SERVE_TENANT_DEPTH``,
``VELES_SIMD_SERVE_DEADLINE_MS``, ``VELES_SIMD_SERVE_CONTINUOUS``,
``VELES_SIMD_SERVE_RAGGED`` / ``_RAGGED_MAX``, plus the breaker knobs
(``VELES_SIMD_BREAKER_*``).  Chaos: ``VELES_SIMD_FAULT_PLAN`` sites
``serve.dispatch`` (device_lost/timeout -> retry/degrade;
``serve.dispatch@<op>`` poisons one op's classes) and
``serve.admission`` (overload -> deterministic shed).
"""

from veles.simd_tpu_torch.serve.admission import (DEFAULT_QUEUE_DEPTH,
                                                  DEFAULT_TENANT_DEPTH,
                                                  QUEUE_DEPTH_ENV,
                                                  TENANT_DEPTH_ENV,
                                                  AdmissionController,
                                                  Overloaded)
from veles.simd_tpu_torch.serve.batcher import (DEFAULT_MAX_BATCH,
                                                DEFAULT_MAX_WAIT_MS,
                                                MAX_BATCH_ENV,
                                                MAX_WAIT_ENV, Batcher,
                                                bucket_length)
from veles.simd_tpu_torch.serve.health import (DEGRADED, HEALTHY,
                                               HealthMonitor)
from veles.simd_tpu_torch.serve.cluster import (HEARTBEAT_MS_ENV,
                                                REPLICAS_ENV,
                                                ROUTER_POLICY_ENV,
                                                FrontRouter,
                                                NoReplicaAvailable,
                                                ReplicaGroup,
                                                RouterTicket)
from veles.simd_tpu_torch.serve.rpc import (RPC_CONNS_ENV,
                                            RPC_TIMEOUT_ENV, RpcClient,
                                            RpcTicket)
from veles.simd_tpu_torch.serve.scaler import ARM_ENV as SCALER_ARM_ENV
from veles.simd_tpu_torch.serve.scaler import \
    TICK_MS_ENV as SCALER_TICK_MS_ENV
from veles.simd_tpu_torch.serve.scaler import ScalerEngine
from veles.simd_tpu_torch.serve.server import (DEADLINE_ENV,
                                               SUPPORTED_OPS,
                                               DeadlineExceeded, Request,
                                               Server, ServerClosed,
                                               Ticket, env_deadline_ms)

__all__ = [
    "Server", "Request", "Ticket", "ServerClosed", "Overloaded",
    "DeadlineExceeded", "AdmissionController", "Batcher",
    "HealthMonitor", "bucket_length", "env_deadline_ms",
    "SUPPORTED_OPS", "HEALTHY", "DEGRADED",
    "ReplicaGroup", "FrontRouter", "RouterTicket",
    "NoReplicaAvailable", "ScalerEngine",
    "RpcClient", "RpcTicket",
    "RPC_CONNS_ENV", "RPC_TIMEOUT_ENV",
    "SCALER_ARM_ENV", "SCALER_TICK_MS_ENV",
    "MAX_BATCH_ENV", "MAX_WAIT_ENV", "QUEUE_DEPTH_ENV",
    "TENANT_DEPTH_ENV", "DEADLINE_ENV", "REPLICAS_ENV",
    "ROUTER_POLICY_ENV", "HEARTBEAT_MS_ENV",
    "DEFAULT_MAX_BATCH", "DEFAULT_MAX_WAIT_MS",
    "DEFAULT_QUEUE_DEPTH", "DEFAULT_TENANT_DEPTH",
]
