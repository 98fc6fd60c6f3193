"""Admission control: bounded queues, typed shed, backpressure.

The port of ``veles.simd_tpu.serve.admission``, unchanged.

The overload failure mode this prevents is the classic one: a server
that accepts every request queues them, every queued request times out,
and by the time the device frees up the whole backlog is garbage.  The
controller bounds queue depth **globally** (protects the device) and
**per tenant** (one chatty tenant cannot starve the rest), and an
over-limit request is answered *immediately* with a typed
:class:`Overloaded` — it is never queued to rot.

Two admission modes, picked per :meth:`AdmissionController.admit` call:

* **fail-fast** (``block=False``, the default) — full queue raises
  :class:`Overloaded` now; the caller (or its load balancer) retries
  elsewhere;
* **block-with-deadline** (``block=True, timeout=s``) — the submitting
  thread parks on the controller's condition until a slot frees or the
  deadline passes (then :class:`Overloaded`).  This is the
  backpressure path: a producer pool slows to the server's drain rate
  instead of shedding.

Every shed is counted (``serve_shed`` by tenant and scope) and current
depths are exported as ``serve_queue_depth`` / ``serve_tenant_depth``
gauges.  The ``serve.admission`` injection site (kind ``overload``,
via ``VELES_SIMD_FAULT_PLAN``) forces the shed path deterministically
on CPU CI — no queue racing needed.

Deadlines read :func:`veles.simd_tpu_torch.runtime.faults.monotonic`
— the serve lint rule bans raw ``time.*`` in this package.
"""

from __future__ import annotations

import os
import threading

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.runtime import faults

__all__ = [
    "Overloaded", "AdmissionController",
    "QUEUE_DEPTH_ENV", "TENANT_DEPTH_ENV",
    "DEFAULT_QUEUE_DEPTH", "DEFAULT_TENANT_DEPTH", "env_depths",
]

QUEUE_DEPTH_ENV = "VELES_SIMD_SERVE_QUEUE_DEPTH"
TENANT_DEPTH_ENV = "VELES_SIMD_SERVE_TENANT_DEPTH"

# global bound: ~32 max-size batches of backlog before shedding beats
# queueing; per-tenant bound: a quarter of that, so no single tenant
# can own the queue.  Both env-tunable per deployment.
DEFAULT_QUEUE_DEPTH = 256
DEFAULT_TENANT_DEPTH = 64


def _env_pos_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        return default
    return value if value > 0 else default


def env_depths() -> tuple:
    """``(queue_depth, tenant_depth)`` from the environment
    (``$VELES_SIMD_SERVE_QUEUE_DEPTH`` / ``_TENANT_DEPTH``), falling
    back to the defaults."""
    return (_env_pos_int(QUEUE_DEPTH_ENV, DEFAULT_QUEUE_DEPTH),
            _env_pos_int(TENANT_DEPTH_ENV, DEFAULT_TENANT_DEPTH))


class Overloaded(RuntimeError):
    """Typed admission rejection — the request was NEVER queued.

    ``tenant`` is the requesting tenant; ``scope`` says which bound
    fired: ``"global"`` (total queue depth), ``"tenant"`` (per-tenant
    depth), ``"deadline"`` (block-with-deadline expired), or
    ``"injected"`` (a planned ``serve.admission:overload`` fault).
    The message satisfies :func:`veles.simd_tpu_torch.runtime.faults.
    is_overload`, so callers can classify without isinstance checks
    across process boundaries."""

    def __init__(self, message: str, *, tenant: str = "default",
                 scope: str = "global"):
        super().__init__(message)
        self.tenant = tenant
        self.scope = scope


class AdmissionController:
    """Bounded global + per-tenant admission behind one condition.

    :meth:`admit` reserves a queue slot (or raises
    :class:`Overloaded`); :meth:`release` frees it when the request is
    answered.  The pair brackets a request's whole queued lifetime, so
    ``depth`` counts requests *in the system*, not just in a bucket
    queue.
    """

    def __init__(self, max_depth: int | None = None,
                 max_tenant_depth: int | None = None):
        env_q, env_t = env_depths()
        self.max_depth = int(max_depth) if max_depth else env_q
        self.max_tenant_depth = (int(max_tenant_depth)
                                 if max_tenant_depth else env_t)
        if self.max_depth < 1 or self.max_tenant_depth < 1:
            raise ValueError("admission depths must be >= 1")
        self._cond = threading.Condition()
        self._depths: dict[str, int] = {}
        self._total = 0
        self._shed = 0

    # -- admission ---------------------------------------------------------

    def _shed_now(self, tenant: str, scope: str,
                  message: str) -> Overloaded:
        with self._cond:
            self._shed += 1
        obs.count("serve_shed", tenant=tenant, scope=scope)
        obs.record_decision("serve_admission", "shed", tenant=tenant,
                            scope=scope, depth=self._total,
                            limit=self.max_depth)
        return Overloaded(message, tenant=tenant, scope=scope)

    def _try_reserve(self, tenant: str) -> str | None:
        """Reserve under the condition lock; returns None on success
        or the scope name of the bound that refused."""
        if self._total >= self.max_depth:
            return "global"
        if self._depths.get(tenant, 0) >= self.max_tenant_depth:
            return "tenant"
        self._total += 1
        self._depths[tenant] = self._depths.get(tenant, 0) + 1
        obs.gauge("serve_queue_depth", self._total)
        obs.gauge("serve_tenant_depth", self._depths[tenant],
                  tenant=tenant)
        return None

    def admit(self, tenant: str = "default", *, block: bool = False,
              timeout: float | None = None) -> tuple:
        """Reserve one queue slot for ``tenant``; returns the depths
        at entry — ``(global_depth, tenant_depth)`` INCLUDING this
        request — which the server stamps into the request trace's
        ``admitted`` edge (the queue pressure a request walked into).

        Raises :class:`Overloaded` immediately when a bound is hit and
        ``block`` is False; with ``block=True`` waits up to ``timeout``
        seconds (None = wait indefinitely) for capacity before raising
        with ``scope="deadline"``.  The ``serve.admission`` injection
        site fires first, so a planned ``overload`` fault sheds
        deterministically regardless of real depth."""
        try:
            faults.inject("serve.admission")
        except faults.InjectedFault as e:
            if not faults.is_overload(e):
                raise
            raise self._shed_now(
                tenant, "injected",
                f"RESOURCE_EXHAUSTED: admission queue full (injected "
                f"plan, tenant {tenant!r})") from e
        deadline = None
        if block and timeout is not None:
            deadline = faults.monotonic() + float(timeout)
        with self._cond:
            while True:
                refused = self._try_reserve(tenant)
                if refused is None:
                    return self._total, self._depths.get(tenant, 0)
                if not block:
                    break
                remaining = None
                if deadline is not None:
                    remaining = deadline - faults.monotonic()
                    if remaining <= 0:
                        refused = "deadline"
                        break
                self._cond.wait(remaining)
        raise self._shed_now(
            tenant, refused,
            f"RESOURCE_EXHAUSTED: admission queue full ({refused} "
            f"bound, tenant {tenant!r}, depth {self._total}/"
            f"{self.max_depth})")

    def release(self, tenant: str = "default") -> None:
        """Free the slot :meth:`admit` reserved (called once per
        answered request, shed requests excluded — they never held
        one).  Wakes blocked :meth:`admit` callers."""
        with self._cond:
            self._total = max(0, self._total - 1)
            left = max(0, self._depths.get(tenant, 1) - 1)
            if left:
                self._depths[tenant] = left
            else:
                self._depths.pop(tenant, None)
            obs.gauge("serve_queue_depth", self._total)
            obs.gauge("serve_tenant_depth", left, tenant=tenant)
            self._cond.notify_all()

    # -- introspection -----------------------------------------------------

    def depth(self, tenant: str | None = None) -> int:
        """Current queued depth — global, or one tenant's."""
        with self._cond:
            if tenant is None:
                return self._total
            return self._depths.get(tenant, 0)

    def snapshot(self) -> dict:
        """JSON-native view: total/limit, per-tenant depths, sheds."""
        with self._cond:
            return {"depth": self._total, "max_depth": self.max_depth,
                    "max_tenant_depth": self.max_tenant_depth,
                    "tenants": dict(self._depths), "shed": self._shed}
