"""Incident engine (obs v6): typed open→closed incidents over signals.

The port of ``veles.simd_tpu.obs.incidents``, copied (it imports no
JAX, and the port never loads the JAX package).  The fleet axis
(:mod:`veles.simd_tpu_torch.obs.timeseries`) answers "what do the
signals say *now*"; this module answers "when did they cross a line,
and when did they come back".  An :class:`IncidentEngine` ticks
over ``obs.signals()`` — on the router process, the
:class:`~veles.simd_tpu_torch.serve.cluster.ReplicaGroup` collector
arms it — and evaluates five rules per tick:

=================== ========================================================
rule                fires while
=================== ========================================================
``slo_burn``        any tenant's burn rate > ``$VELES_SIMD_INCIDENT_BURN``
``breaker_flap``    any replica's windowed breaker flap count >=
                    ``$VELES_SIMD_INCIDENT_FLAPS``
``goodput_collapse`` fleet goodput < ``$VELES_SIMD_INCIDENT_GOODPUT``
``replica_down``    any replica's health reads ``down`` or ``stale``
``queue_runaway``   total queue depth rising faster than
                    ``$VELES_SIMD_INCIDENT_QUEUE_VELOCITY`` rows/s
                    (velocity over the engine's own recent-tick window)
=================== ========================================================

Per-rule hysteresis keeps flaps from storming: a rule must fire for
``$VELES_SIMD_INCIDENT_OPEN_TICKS`` *consecutive* ticks to open, at
most one incident per rule is open at a time, and an open incident
closes only after ``$VELES_SIMD_INCIDENT_CLOSE_TICKS`` consecutive
quiet ticks (any re-fire resets the quiet counter) — a flap storm
opens exactly one incident and holds it open until the storm truly
ends.

Opening an incident snapshots the journal cursor
(:func:`veles.simd_tpu_torch.obs.journal.cursor`), arms a budgeted
flight bundle (``flightrec.maybe_record("incident:<rule>")``), and emits an
``incident``/``open`` decision through ``obs.record_decision`` — which
is ALSO the journal funnel, so the incident's open and close edges are
durable and ``tools/obs_query.py --postmortem`` can reconstruct them
from disk alone.  Incidents are served read-only on the ``/incidents``
route and summarized inside ``obs.signals()``.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = [
    "SCHEMA", "Incident", "IncidentEngine", "RULES",
    "engine", "start", "stop", "reset", "snapshot", "open_incidents",
    "OPEN_TICKS_ENV", "CLOSE_TICKS_ENV", "TICK_MS_ENV",
    "BURN_ENV", "FLAPS_ENV", "GOODPUT_ENV", "QUEUE_VELOCITY_ENV",
    "DEFAULT_OPEN_TICKS", "DEFAULT_CLOSE_TICKS", "DEFAULT_TICK_MS",
]

SCHEMA = "veles-simd-incidents-v1"

OPEN_TICKS_ENV = "VELES_SIMD_INCIDENT_OPEN_TICKS"
CLOSE_TICKS_ENV = "VELES_SIMD_INCIDENT_CLOSE_TICKS"
TICK_MS_ENV = "VELES_SIMD_INCIDENT_TICK_MS"
BURN_ENV = "VELES_SIMD_INCIDENT_BURN"
FLAPS_ENV = "VELES_SIMD_INCIDENT_FLAPS"
GOODPUT_ENV = "VELES_SIMD_INCIDENT_GOODPUT"
QUEUE_VELOCITY_ENV = "VELES_SIMD_INCIDENT_QUEUE_VELOCITY"

# two consecutive firing ticks to open: one anomalous scrape is noise,
# two in a row is a condition
DEFAULT_OPEN_TICKS = 2
# five consecutive quiet ticks to close: long enough that a breaker
# half-open probe bouncing once doesn't close-and-reopen the incident
DEFAULT_CLOSE_TICKS = 5
# engine cadence; a few collector ticks per engine tick is plenty —
# incidents are minutes-scale objects, not per-request ones
DEFAULT_TICK_MS = 250.0
DEFAULT_BURN = 1.0
DEFAULT_FLAPS = 4
DEFAULT_GOODPUT = 0.5
DEFAULT_QUEUE_VELOCITY = 50.0
# engine-held history of queue_depth_total used for the runaway
# velocity (the signals bundle carries depth, not its derivative)
_QUEUE_HISTORY = 16
MAX_INCIDENTS = 64

RULES = ("slo_burn", "breaker_flap", "goodput_collapse",
         "replica_down", "queue_runaway")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        return default
    return value if value > 0 else default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        return default
    return value if value > 0 else default


class Incident:
    """One typed open→closed incident: the rule that fired, the
    trigger detail at open, the journal cursor and flight bundle
    snapshotted at open, and (once closed) the close reason."""

    __slots__ = ("id", "rule", "state", "trigger", "last_detail",
                 "opened_t_wall", "opened_t_mono", "closed_t_wall",
                 "closed_t_mono", "close_reason", "ticks_firing",
                 "journal_cursor", "bundle")

    def __init__(self, iid: str, rule: str, trigger: dict,
                 journal_cursor: dict | None, bundle: str | None):
        self.id = iid
        self.rule = rule
        self.state = "open"
        self.trigger = trigger
        self.last_detail = trigger
        self.opened_t_wall = time.time()
        self.opened_t_mono = time.monotonic()
        self.closed_t_wall: float | None = None
        self.closed_t_mono: float | None = None
        self.close_reason: str | None = None
        self.ticks_firing = 1
        self.journal_cursor = journal_cursor
        self.bundle = bundle

    def to_dict(self) -> dict:
        return {name: getattr(self, name) for name in self.__slots__}

    def __repr__(self):
        return (f"Incident({self.id}, rule={self.rule}, "
                f"state={self.state})")


class IncidentEngine:
    """Per-rule hysteresis over a signals stream.  Drive it with
    :meth:`tick` (any object shaped like
    :class:`~veles.simd_tpu_torch.obs.timeseries.FleetSignals` —
    tests pass fakes) or let :meth:`start` tick ``obs.signals()`` on a daemon
    thread.  All thresholds resolve from the environment at
    construction so a chaos campaign (or a test) can pin them."""

    def __init__(self, open_ticks: int | None = None,
                 close_ticks: int | None = None,
                 burn: float | None = None,
                 flaps: int | None = None,
                 goodput: float | None = None,
                 queue_velocity: float | None = None):
        self.open_ticks = int(open_ticks) if open_ticks is not None \
            else _env_int(OPEN_TICKS_ENV, DEFAULT_OPEN_TICKS)
        self.close_ticks = int(close_ticks) if close_ticks is not None \
            else _env_int(CLOSE_TICKS_ENV, DEFAULT_CLOSE_TICKS)
        self.burn = burn if burn is not None \
            else _env_float(BURN_ENV, DEFAULT_BURN)
        self.flaps = int(flaps) if flaps is not None \
            else _env_int(FLAPS_ENV, DEFAULT_FLAPS)
        self.goodput = goodput if goodput is not None \
            else _env_float(GOODPUT_ENV, DEFAULT_GOODPUT)
        self.queue_velocity = queue_velocity \
            if queue_velocity is not None \
            else _env_float(QUEUE_VELOCITY_ENV, DEFAULT_QUEUE_VELOCITY)
        self._lock = threading.Lock()
        self._streak = {r: 0 for r in RULES}    # consecutive firing
        self._quiet = {r: 0 for r in RULES}     # consecutive quiet
        self._open: dict = {}                   # rule -> Incident
        self._closed: list = []
        self._queue_hist: list = []             # [(at_s, depth_total)]
        self._seq = 0
        self.ticks = 0
        self._thread = None
        self._stop = threading.Event()

    # -- rules (each returns a trigger-detail dict, or None) ---------------

    def _rule_slo_burn(self, sig) -> dict | None:
        worst = None
        for tenant, b in (getattr(sig, "slo_burn", None) or {}).items():
            if b is not None and b > self.burn \
                    and (worst is None or b > worst[1]):
                worst = (tenant, b)
        if worst is None:
            return None
        return {"tenant": worst[0], "burn": worst[1],
                "threshold": self.burn}

    def _rule_breaker_flap(self, sig) -> dict | None:
        hot = {r: f for r, f
               in (getattr(sig, "breaker_flaps", None) or {}).items()
               if f >= self.flaps}
        if not hot:
            return None
        return {"replicas": hot, "threshold": self.flaps}

    def _rule_goodput_collapse(self, sig) -> dict | None:
        overall = getattr(sig, "goodput_overall", None)
        if overall is None or overall >= self.goodput:
            return None
        return {"goodput": overall, "threshold": self.goodput}

    def _rule_replica_down(self, sig) -> dict | None:
        bad = {r: h for r, h
               in (getattr(sig, "health", None) or {}).items()
               if h in ("down", "stale")}
        if not bad:
            return None
        return {"replicas": bad}

    def _rule_queue_runaway(self, sig) -> dict | None:
        at_s = getattr(sig, "at_s", None)
        depth = getattr(sig, "queue_depth_total", None)
        if at_s is None or depth is None:
            return None
        hist = self._queue_hist
        hist.append((float(at_s), float(depth)))
        if len(hist) > _QUEUE_HISTORY:
            del hist[0]
        if len(hist) < 2:
            return None
        dt = hist[-1][0] - hist[0][0]
        if dt <= 0:
            return None
        velocity = (hist[-1][1] - hist[0][1]) / dt
        if velocity < self.queue_velocity:
            return None
        return {"velocity": velocity, "depth": depth,
                "threshold": self.queue_velocity}

    # -- the tick ----------------------------------------------------------

    def tick(self, sig) -> list:
        """Evaluate every rule against one signals read; returns the
        incidents whose state changed this tick (opened or closed)."""
        checks = {
            "slo_burn": self._rule_slo_burn,
            "breaker_flap": self._rule_breaker_flap,
            "goodput_collapse": self._rule_goodput_collapse,
            "replica_down": self._rule_replica_down,
            "queue_runaway": self._rule_queue_runaway,
        }
        changed = []        # [(incident, edge, emit-detail)]
        with self._lock:
            self.ticks += 1
            for rule in RULES:
                try:
                    detail = checks[rule](sig)
                except Exception:  # noqa: BLE001 — a malformed signal
                    detail = None  # never kills the engine
                open_inc = self._open.get(rule)
                if detail is not None:
                    self._streak[rule] += 1
                    self._quiet[rule] = 0
                    if open_inc is not None:
                        open_inc.ticks_firing += 1
                        open_inc.last_detail = detail
                    elif self._streak[rule] >= self.open_ticks:
                        inc = self._open_incident(rule, detail)
                        changed.append((inc, "open", detail))
                else:
                    self._streak[rule] = 0
                    if open_inc is not None:
                        self._quiet[rule] += 1
                        if self._quiet[rule] >= self.close_ticks:
                            inc = self._close_incident(rule)
                            changed.append(
                                (inc, "close",
                                 {"reason": inc.close_reason,
                                  "open_s": inc.closed_t_mono
                                  - inc.opened_t_mono}))
        # Evidence capture and edge emission run OUTSIDE the engine
        # lock: maybe_record's bundle embeds obs.snapshot(), which
        # reads this engine back through incidents.snapshot() (holding
        # the lock here would deadlock on the first open), and both
        # the bundle and the journal append touch disk — a stalled
        # write must never block concurrent signals()/snapshot()
        # readers on the lock.
        for inc, edge, detail in changed:
            if edge == "open":
                self._capture_evidence(inc)
            self._emit(inc, edge, detail)
        return [inc for inc, _, _ in changed]

    def _open_incident(self, rule: str, detail: dict) -> Incident:
        """Mint the open incident — lock held, state mutation only;
        evidence capture happens lock-free in :meth:`tick`."""
        self._seq += 1
        iid = "inc-%d-%d" % (os.getpid(), self._seq)
        inc = Incident(iid, rule, detail, None, None)
        self._open[rule] = inc
        return inc

    def _close_incident(self, rule: str) -> Incident:
        inc = self._open.pop(rule)
        inc.state = "closed"
        inc.closed_t_wall = time.time()
        inc.closed_t_mono = time.monotonic()
        inc.close_reason = "quiet_period"
        self._quiet[rule] = 0
        self._closed.append(inc)
        if len(self._closed) > MAX_INCIDENTS:
            del self._closed[0]
        return inc

    @staticmethod
    def _capture_evidence(inc: Incident) -> None:
        """Snapshot the journal cursor and arm a budgeted flight
        bundle for a just-opened incident.  Must be called WITHOUT
        the engine lock — the bundle embeds obs.snapshot(), which
        reads this engine back."""
        try:
            from veles.simd_tpu_torch.obs import flightrec, journal

            inc.journal_cursor = journal.cursor()
            inc.bundle = flightrec.maybe_record(
                f"incident:{inc.rule}", None)
        except Exception:  # noqa: BLE001 — evidence capture is best
            pass           # effort; the incident itself must open

    @staticmethod
    def _emit(inc: Incident, edge: str, detail: dict) -> None:
        """One ``incident``/``open|close`` decision event per edge —
        ``obs.record_decision`` is the journal funnel, so the edge is
        durable when the journal is armed.  Called without the engine
        lock (the journal append is a disk write)."""
        try:
            from veles.simd_tpu_torch import obs

            obs.record_decision("incident", edge, id=inc.id,
                                rule=inc.rule, **detail)
        except Exception:  # noqa: BLE001
            pass

    # -- reads -------------------------------------------------------------

    def open_incidents(self) -> list:
        with self._lock:
            return [self._open[r] for r in RULES if r in self._open]

    def open_snapshots(self) -> list:
        """Open incidents as dicts, built while holding the lock so a
        reader never sees a half-mutated incident."""
        with self._lock:
            return [self._open[r].to_dict() for r in RULES
                    if r in self._open]

    def incidents(self) -> list:
        """Closed then open, oldest first."""
        with self._lock:
            return list(self._closed) + [self._open[r] for r in RULES
                                         if r in self._open]

    def snapshot(self) -> dict:
        """JSON-native form — the ``/incidents`` route body.  The
        dicts are built while holding the lock: the ticker mutates
        state/closed_* in place, and a lock-free ``to_dict`` could
        serve ``state='closed'`` with ``closed_t_wall`` still None."""
        with self._lock:
            ticks = self.ticks
            items = [i.to_dict() for i in
                     list(self._closed) + [self._open[r] for r in RULES
                                           if r in self._open]]
        return {"schema": SCHEMA, "ticks": ticks,
                "open": sum(1 for i in items if i["state"] == "open"),
                "closed": sum(1 for i in items
                              if i["state"] == "closed"),
                "incidents": items}

    # -- the ticker thread -------------------------------------------------

    def start(self, interval_s: float | None = None) -> None:
        """Tick ``obs.signals()`` on a daemon thread (idempotent).
        Cadence: ``interval_s`` else ``$VELES_SIMD_INCIDENT_TICK_MS``
        (default 250 ms)."""
        if self._thread is not None and self._thread.is_alive():
            return
        if interval_s is None:
            interval_s = _env_float(TICK_MS_ENV, DEFAULT_TICK_MS) / 1e3
        self._stop.clear()

        def _run():
            from veles.simd_tpu_torch import obs

            while not self._stop.wait(interval_s):
                try:
                    self.tick(obs.signals())
                except Exception:  # noqa: BLE001 — the engine outlives
                    pass           # any one bad read

        self._thread = threading.Thread(
            target=_run, daemon=True, name="veles-obs-incidents")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def reset(self) -> None:
        with self._lock:
            self._streak = {r: 0 for r in RULES}
            self._quiet = {r: 0 for r in RULES}
            self._open.clear()
            self._closed.clear()
            self._queue_hist.clear()
            self.ticks = 0


# -- the process engine (what /incidents and signals() read) -----------------

_engine: IncidentEngine | None = None
_engine_lock = threading.Lock()
_starters = 0   # live start() holds; stop() halts the ticker at zero


def engine() -> IncidentEngine:
    """The process-wide engine (created on first use)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = IncidentEngine()
        return _engine


def start(interval_s: float | None = None) -> IncidentEngine:
    """Arm the process engine's ticker (the ReplicaGroup collector
    calls this on start); returns the engine.  Starts are reference-
    counted: every ``start()`` must be paired with one ``stop()``,
    and the ticker only halts when the last starter releases — two
    ReplicaGroups in one process can't silence each other."""
    global _starters
    with _engine_lock:
        _starters += 1
    e = engine()
    e.start(interval_s)
    return e


def stop() -> None:
    """Release one ``start()`` hold; the process ticker stops only
    when the last holder releases (open incidents are kept)."""
    global _starters
    with _engine_lock:
        if _starters > 0:
            _starters -= 1
        if _starters > 0:
            return
        e = _engine
    if e is not None:
        e.stop()


def reset() -> None:
    """Clear the process engine's incident ledger and rule state
    (streaks, quiet counters, open and closed incidents) without
    touching the ticker or its start() holders.  A new journal epoch
    — a chaos campaign arming a fresh pack — calls this so the pack's
    incident story starts clean instead of inheriting another epoch's
    closed incidents and half-built streaks."""
    e = _engine
    if e is not None:
        e.reset()


def open_incidents() -> list:
    """Open incidents as dicts (empty when no engine ever ran) — the
    summary embedded in ``obs.signals()``."""
    e = _engine
    if e is None:
        return []
    return e.open_snapshots()


def snapshot() -> dict:
    """The ``/incidents`` body (an empty, schema-stamped shell when no
    engine ever ran)."""
    e = _engine
    if e is None:
        return {"schema": SCHEMA, "ticks": 0, "open": 0, "closed": 0,
                "incidents": []}
    return e.snapshot()


def _reset_for_tests() -> None:
    global _engine, _starters
    with _engine_lock:
        _starters = 0
        if _engine is not None:
            _engine.stop()
            _engine = None
