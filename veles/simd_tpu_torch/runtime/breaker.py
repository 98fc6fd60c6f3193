"""Per-class circuit breakers: closed -> open -> half-open dispatch gates.

Copied from ``veles.simd_tpu.runtime.breaker`` (framework-free) and
bound to :mod:`veles.simd_tpu_torch.obs`: the same states, knobs,
defaults, counters, gauge, decision events and ``obs.caches()`` entry.

The fault-policy engine (:mod:`veles.simd_tpu_torch.runtime.faults`)
answers one failing dispatch with bounded retry and a graceful degrade;
what it cannot answer is the *persistently* failing bucket — a shape
class whose route keeps dying burns its full retry budget on every
call, multiplying the outage's latency damage by the retry ladder.
This module is the per-class middle layer — the classic circuit
breaker, keyed by ``(site, shape-class)``:

* **closed** — dispatches flow normally; each guarded outcome lands in
  a sliding window of the last ``window`` results, and when the window
  holds at least ``min_events`` outcomes with a failure rate at or
  above ``threshold`` the breaker opens;
* **open** — dispatch goes *straight* to the caller's fallback (the
  NumPy oracle of the ``ops/`` dispatch sites) without paying the
  retry ladder; every ``probe_every``-th short-circuited call is
  promoted to a **half-open** trial instead;
* **half-open** — the trial dispatches with a zero-retry budget; a
  success closes the breaker (window cleared), a failure reopens it.

Cadence is *call-counted*, not wall-clock: reproducible under the
fault-injection plan on the CPU, and naturally load-proportional in
production.

Every transition is a ``breaker_transition`` decision event and the
current state is a ``breaker_state`` gauge (``veles_simd_breaker_state``
in the Prometheus export, 0 = closed, 0.5 = half-open, 1 = open);
short-circuits, opens, and probes are ``breaker_*`` counters.  The
live registry is in ``obs.caches()`` under ``runtime.breakers``, and
:func:`snapshot` gives the per-breaker JSON view.

Consulted by :func:`veles.simd_tpu_torch.runtime.faults.
breaker_guarded` at the guarded ``ops/`` dispatch sites
(``convolve.dispatch``, ``convolve2d.dispatch``, ``stft.dispatch``,
``istft.dispatch``, ``segments.dispatch``).  Typed overload sheds never
reach a breaker — a shed is a policy outcome, not a fault
(``faults.guarded`` re-raises them before any accounting).

Knobs: ``VELES_SIMD_BREAKER_WINDOW`` (sliding-window size, default 8),
``VELES_SIMD_BREAKER_THRESHOLD`` (failure rate that opens, default
0.5), ``VELES_SIMD_BREAKER_MIN_EVENTS`` (outcomes before the rate
means anything, default 2), ``VELES_SIMD_BREAKER_PROBE_EVERY`` (every
Nth short-circuit probes, default 4).
"""

from __future__ import annotations

import collections
import os
import threading

from veles.simd_tpu_torch import obs

__all__ = [
    "CLOSED", "OPEN", "HALF_OPEN", "Breaker",
    "breaker_for", "lookup", "snapshot", "reset",
    "BREAKER_WINDOW_ENV", "BREAKER_THRESHOLD_ENV",
    "BREAKER_MIN_EVENTS_ENV", "BREAKER_PROBE_EVERY_ENV",
    "DEFAULT_WINDOW", "DEFAULT_THRESHOLD", "DEFAULT_MIN_EVENTS",
    "DEFAULT_PROBE_EVERY", "env_policy",
]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

BREAKER_WINDOW_ENV = "VELES_SIMD_BREAKER_WINDOW"
BREAKER_THRESHOLD_ENV = "VELES_SIMD_BREAKER_THRESHOLD"
BREAKER_MIN_EVENTS_ENV = "VELES_SIMD_BREAKER_MIN_EVENTS"
BREAKER_PROBE_EVERY_ENV = "VELES_SIMD_BREAKER_PROBE_EVERY"

# window 8 / threshold 0.5 / min_events 2: two consecutive retry
# exhaustions on a class open its breaker (one could be a blip; by the
# second the retry ladder has already been paid twice), and a healthy
# class needs sustained failures, not one, to trip.  probe_every 4: a
# recovered class is noticed within ~3 short-circuited calls while a
# dead one only eats one zero-retry probe per 4.
DEFAULT_WINDOW = 8
DEFAULT_THRESHOLD = 0.5
DEFAULT_MIN_EVENTS = 2
DEFAULT_PROBE_EVERY = 4

_STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 0.5, OPEN: 1.0}


def _env_number(name: str, default, cast, minimum):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = cast(raw)
    except ValueError:
        return default
    return value if value >= minimum else default


def env_policy() -> tuple:
    """``(window, threshold, min_events, probe_every)`` from the
    environment, falling back to the defaults."""
    return (_env_number(BREAKER_WINDOW_ENV, DEFAULT_WINDOW, int, 1),
            _env_number(BREAKER_THRESHOLD_ENV, DEFAULT_THRESHOLD,
                        float, 0.0),
            _env_number(BREAKER_MIN_EVENTS_ENV, DEFAULT_MIN_EVENTS,
                        int, 1),
            _env_number(BREAKER_PROBE_EVERY_ENV, DEFAULT_PROBE_EVERY,
                        int, 1))


class Breaker:
    """One ``(site, key)`` circuit breaker behind one lock.

    The caller's contract is three calls: :meth:`admit` before the
    dispatch (``"closed"`` — dispatch normally; ``"probe"`` — dispatch
    with a zero-retry budget; ``"open"`` — skip the device and answer
    via the fallback), then exactly one of :meth:`success` /
    :meth:`failure` for outcomes that reached the device.
    Short-circuited calls record no outcome — an open breaker's
    window only moves through its probes, so recovery is judged on
    live evidence, not on the fallback's reliability.
    """

    __slots__ = ("site", "key", "window_size", "threshold",
                 "min_events", "probe_every", "_lock", "_state",
                 "_window", "_shorted", "_opens", "_probes",
                 "_failures", "_successes")

    def __init__(self, site: str, key=None, *,
                 window: int | None = None,
                 threshold: float | None = None,
                 min_events: int | None = None,
                 probe_every: int | None = None):
        env_w, env_t, env_m, env_p = env_policy()
        self.site = site
        self.key = key
        self.window_size = int(window) if window else env_w
        self.threshold = (float(threshold) if threshold is not None
                          else env_t)
        self.min_events = int(min_events) if min_events else env_m
        self.probe_every = int(probe_every) if probe_every else env_p
        if self.window_size < 1 or self.min_events < 1 \
                or self.probe_every < 1:
            raise ValueError("breaker window/min_events/probe_every "
                             "must be >= 1")
        self._lock = threading.Lock()
        self._state = CLOSED
        self._window: collections.deque = collections.deque(
            maxlen=self.window_size)
        self._shorted = 0       # short-circuited calls while not closed
        self._opens = 0
        self._probes = 0
        self._failures = 0
        self._successes = 0

    # -- labels / events ---------------------------------------------------

    def _key_label(self) -> str:
        return repr(self.key) if self.key is not None else ""

    def _transition(self, new_state: str, reason: str) -> None:
        """Record one state transition (caller holds the lock)."""
        old = self._state
        self._state = new_state
        obs.gauge("breaker_state", _STATE_GAUGE[new_state],
                  site=self.site, key=self._key_label())
        # lifetime opens/probes ride every transition: a postmortem
        # counting breaker *cycles* needs the cumulative context each
        # edge was recorded against, not just the edge itself
        obs.record_decision(
            "breaker_transition", new_state, site=self.site,
            key=self._key_label(), previous=old, reason=reason,
            failures=sum(1 for ok in self._window if not ok),
            window=len(self._window),
            opens=self._opens, probes=self._probes)

    # -- the caller contract -----------------------------------------------

    def admit(self, force_probe: bool = False) -> str:
        """Gate one dispatch: ``"closed"`` / ``"probe"`` / ``"open"``.

        While not closed, every ``probe_every``-th call is promoted to
        a half-open trial (state -> HALF_OPEN on the first promotion);
        the rest short-circuit.  The cadence keeps counting in
        HALF_OPEN too, so a trial whose outcome never lands (a
        non-fault exception propagated past the caller) cannot wedge
        the breaker — the next cadence tick simply re-arms a trial.
        ``force_probe=True`` promotes a not-closed admit to a trial
        regardless of the cadence (a caller's own health probe
        outranks the short-circuit), with the probe — not a
        short-circuit — counted and the HALF_OPEN transition
        recorded.  A closed breaker answers without its lock (one
        attribute read; a call racing a transition dispatches as if it
        had come a moment earlier).
        """
        if self._state == CLOSED:
            return CLOSED
        with self._lock:
            if self._state == CLOSED:
                return CLOSED
            self._shorted += 1
            if force_probe or self._shorted % self.probe_every == 0:
                self._probes += 1
                if self._state == OPEN:
                    self._transition(
                        HALF_OPEN, "health_probe" if force_probe
                        else "probe_cadence")
                obs.count("breaker_probe", site=self.site,
                          key=self._key_label())
                return "probe"
            obs.count("breaker_short_circuit", site=self.site,
                      key=self._key_label())
            return OPEN

    def success(self) -> None:
        """A dispatch (or half-open trial) completed on the device."""
        with self._lock:
            self._successes += 1
            if self._state != CLOSED:
                self._window.clear()
                self._shorted = 0
                self._transition(CLOSED, "probe_success")
                return
            self._window.append(True)

    def failure(self) -> None:
        """A dispatch exhausted its transient-fault retries.  Typed
        overload sheds must never land here (``faults.guarded``
        re-raises them before any breaker accounting)."""
        with self._lock:
            self._failures += 1
            if self._state == HALF_OPEN:
                self._transition(OPEN, "probe_failure")
                obs.count("breaker_reopen", site=self.site,
                          key=self._key_label())
                return
            if self._state == OPEN:
                return
            self._window.append(False)
            fails = sum(1 for ok in self._window if not ok)
            if (len(self._window) >= self.min_events
                    and fails / len(self._window) >= self.threshold):
                self._opens += 1
                self._shorted = 0
                self._transition(OPEN, "failure_rate")
                obs.count("breaker_open", site=self.site,
                          key=self._key_label())

    # -- introspection -----------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def info(self) -> dict:
        """JSON-native view: state, window occupancy, tallies."""
        with self._lock:
            fails = sum(1 for ok in self._window if not ok)
            return {"site": self.site, "key": self._key_label(),
                    "state": self._state,
                    "window": len(self._window),
                    "window_size": self.window_size,
                    "window_failures": fails,
                    "threshold": self.threshold,
                    "min_events": self.min_events,
                    "probe_every": self.probe_every,
                    "opens": self._opens, "probes": self._probes,
                    "failures": self._failures,
                    "successes": self._successes,
                    "short_circuited": self._shorted}


# ---------------------------------------------------------------------------
# the process-wide registry (obs.caches()-introspectable)
# ---------------------------------------------------------------------------

_registry_lock = threading.Lock()
_REGISTRY: dict[tuple, Breaker] = {}


def breaker_for(site: str, key=None) -> Breaker:
    """The breaker for ``(site, key)``, minted on first use (policy
    knobs read from the environment at mint time); a minted breaker
    is found without the registry's lock."""
    rkey = (site, key)
    br = _REGISTRY.get(rkey)
    if br is not None:
        return br
    with _registry_lock:
        br = _REGISTRY.get(rkey)
        if br is None:
            br = _REGISTRY[rkey] = Breaker(site, key)
        return br


def lookup(site: str, key=None) -> Breaker | None:
    """The breaker for ``(site, key)`` if one was ever minted."""
    with _registry_lock:
        return _REGISTRY.get((site, key))


def snapshot() -> list:
    """JSON-native view of every live breaker (site order)."""
    with _registry_lock:
        breakers = list(_REGISTRY.values())
    return sorted((b.info() for b in breakers),
                  key=lambda i: (i["site"], i["key"]))


def reset() -> None:
    """Drop every breaker (tests; a fresh registry per scenario)."""
    with _registry_lock:
        _REGISTRY.clear()


def _registry_info() -> dict:
    """The ``obs.caches()`` provider: registry occupancy + the
    per-state census (how many breakers are open right now)."""
    snap = snapshot()
    states: dict[str, int] = {}
    for b in snap:
        states[b["state"]] = states.get(b["state"], 0) + 1
    return {"size": len(snap), "states": states}


obs.register_cache("runtime.breakers", _registry_info)
