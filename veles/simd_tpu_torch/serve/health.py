"""Serve health state machine: HEALTHY <-> DEGRADED, probed recovery.

The port of ``veles.simd_tpu.serve.health``, unchanged.

The per-call fault policy (:func:`veles.simd_tpu_torch.runtime.faults.
guarded`) answers one dispatch; this machine answers the *next
thousand*.  When a batch exhausts its transient-fault retries the
device is presumed gone, and paying the full retry ladder on every
subsequent batch would multiply the outage's latency damage.  So the
server trips to **DEGRADED**: batches are answered by the NumPy oracle
immediately (correct output beats no output — the same degradation
``guarded`` applies per call, promoted to a mode), and every
``probe_every``-th batch is sent to the device anyway with a zero-retry
budget.  The first probe that completes flips the server back to
**HEALTHY**.

Transitions are the observable events the obs layer keeps (*every
transition is a decision event*):

* trip — ``serve_health``/``degrade`` decision (first trip only; repeat
  faults while already degraded just count), ``serve_degraded`` counter,
  ``serve_healthy`` gauge -> 0;
* recover — ``serve_health``/``recover`` decision, ``serve_recovered``
  counter, gauge -> 1.

Probe cadence is *batch-counted*, not wall-clock: deterministic under
the fault-injection plan on CPU CI, and naturally load-proportional in
production (an idle degraded server probes on its next batch, a busy
one every few).
"""

from __future__ import annotations

import threading

from veles.simd_tpu_torch import obs

__all__ = ["HEALTHY", "DEGRADED", "HealthMonitor",
           "DEFAULT_PROBE_EVERY"]

HEALTHY = "healthy"
DEGRADED = "degraded"

# probe on every 4th degraded batch: a recovered device is noticed
# within ~3 oracle-served batches while a dead one only eats one
# zero-retry probe per 4
DEFAULT_PROBE_EVERY = 4


class HealthMonitor:
    """The two-state machine behind one lock; shared by the server's
    worker pool (trips and recoveries from any worker serialize
    here)."""

    def __init__(self, probe_every: int = DEFAULT_PROBE_EVERY,
                 name: str | None = None):
        # ``name`` is the owning replica's identity (serve/cluster.py):
        # with N health machines in one process, transition decision
        # events must say WHOSE device died
        self.name = None if name is None else str(name)
        self.probe_every = int(probe_every)
        if self.probe_every < 1:
            raise ValueError("probe_every must be >= 1")
        self._lock = threading.Lock()
        self._state = HEALTHY
        self._degraded_batches = 0
        self._trips = 0
        self._recoveries = 0
        self._probes = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._state == DEGRADED

    def trip(self, site: str, error=None) -> bool:
        """A dispatch exhausted its retries: enter (or stay in)
        DEGRADED.  Returns True on the HEALTHY->DEGRADED transition
        (which is the only occurrence that records a decision
        event)."""
        with self._lock:
            self._trips += 1
            transition = self._state != DEGRADED
            self._state = DEGRADED
            if transition:
                self._degraded_batches = 0
        if transition:
            obs.count("serve_degraded", site=site)
            obs.gauge("serve_healthy", 0.0,
                      **({"replica": self.name} if self.name else {}))
            obs.record_decision(
                "serve_health", "degrade", site=site,
                replica=self.name,
                error=(str(error)[:200] if error is not None
                       else None))
        return transition

    def note_degraded_batch(self) -> bool:
        """Count one batch served while DEGRADED; True when THIS batch
        should probe the device (every ``probe_every``-th)."""
        with self._lock:
            if self._state != DEGRADED:
                return False
            self._degraded_batches += 1
            probe = self._degraded_batches % self.probe_every == 0
            if probe:
                self._probes += 1
        if probe:
            obs.count("serve_probe")
        return probe

    def recover(self, site: str) -> bool:
        """A probe completed on the device: back to HEALTHY.  Returns
        True on the actual transition."""
        with self._lock:
            if self._state != DEGRADED:
                return False
            self._state = HEALTHY
            self._recoveries += 1
        obs.count("serve_recovered", site=site)
        obs.gauge("serve_healthy", 1.0,
                  **({"replica": self.name} if self.name else {}))
        obs.record_decision("serve_health", "recover", site=site,
                            replica=self.name)
        return True

    def snapshot(self) -> dict:
        """JSON-native view: state + transition/probe tallies (also
        the ``health`` block of the live ``/healthz`` scrape route —
        ``obs/http.py`` answers 503 from the ``state`` field while
        DEGRADED, so a load balancer needs no JSON parsing).
        ``degraded_batches`` counts batches served since the LAST
        trip — the current outage's oracle-served tally."""
        with self._lock:
            return {"state": self._state, "trips": self._trips,
                    "recoveries": self._recoveries,
                    "probes": self._probes,
                    "degraded_batches": self._degraded_batches,
                    "probe_every": self.probe_every}
