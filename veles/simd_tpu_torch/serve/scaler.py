"""The control axis: an SLO-driven autoscaler whose every decision is
explained, journaled, and reconstructable offline.

The port of ``veles.simd_tpu.serve.scaler``, rule for rule (it imports
no JAX; copied, since the port never loads the JAX package).  The
open-loop parts of elastic autoscaling — per-tenant SLO burn gauges,
the :class:`~veles.simd_tpu_torch.serve.cluster.ReplicaGroup` verbs
(spawn/retire/restart, wedge detection) — all exist; this module is
the controller that closes the loop.  A replica it spawns starts
warm in the port when the artifact store is armed (its preload places
the packed kernel library), and a subprocess child loads the kernel
library its parent built, so no replica it spawns runs nvcc:

* **reads only the typed signals contract** — every input comes from
  :func:`veles.simd_tpu_torch.obs.signals` (SLO burn + burn velocity, queue
  depth + velocity, breaker flaps, replica health incl. stale/down,
  goodput, replica counts).  No ``/metrics`` scraping, no reaching
  into ``Server`` internals (``tools/lint.py`` enforces both);
* **acts only through ReplicaGroup verbs** —
  :meth:`~veles.simd_tpu_torch.serve.cluster.ReplicaGroup.\
spawn_replica` under rising burn or queue velocity,
  :meth:`~veles.simd_tpu_torch.serve.cluster.ReplicaGroup.retire` of the
  least-loaded replica after a sustained idle window, and
  :meth:`~veles.simd_tpu_torch.serve.cluster.ReplicaGroup.restart` of
  wedged/down replicas;
* **every tick emits a ``scaler`` decision event** carrying the full
  input vector, the rule that fired, the action taken (or a *typed*
  no-op reason: ``cooldown`` / ``at_bound`` / ``hysteresis_pending``
  / ``replace_pending`` / ``idle``), and the triggering incident id
  when one is open — durable through the journal (obs v6), served on
  the ``/scaler`` route and inside ``/signals`` +
  :func:`veles.simd_tpu_torch.obs.snapshot`, and reconstructable by
  ``tools/obs_query.py --postmortem`` as a causal
  **incident -> action -> effect** chain from a journal pack with no
  live process.

Stability is hysteresis, cooldown, and bounds — the same open/close
tick-counter discipline as the incident engine
(:mod:`veles.simd_tpu_torch.obs.incidents`), so breaker flap-storms and
single-tick spikes produce *zero* actions:

=============  ==========================================  ===========
action         fires when (consecutive ticks)               guard
=============  ==========================================  ===========
``replace``    a replica reads ``down``/``stale`` in        cooldown
               ``sig.health`` for ``up_ticks`` ticks
``scale_up``   max tenant burn > ``burn`` OR burn           cooldown,
               velocity > ``burn_velocity`` OR queue        ``max``
               velocity > ``queue_velocity`` OR per-        bound
               replica depth > ``depth_high``, for
               ``up_ticks`` ticks
``scale_down`` total depth <= ``idle_depth`` AND burn       cooldown,
               quiet, for ``down_ticks`` ticks (the         ``min``
               sustained idle window)                       bound
=============  ==========================================  ===========

Knobs (constructor args override the environment):
``VELES_SIMD_SCALER`` (arm the loop when the group starts),
``VELES_SIMD_SCALER_TICK_MS``, ``VELES_SIMD_SCALER_MIN`` /
``_MAX`` (replica bounds), ``_COOLDOWN_MS`` (after every action),
``_UP_TICKS`` / ``_DOWN_TICKS`` (hysteresis), ``_BURN``,
``_BURN_VELOCITY``, ``_QUEUE_VELOCITY``, ``_DEPTH_HIGH``,
``_IDLE_DEPTH`` (rule thresholds).

chip_smoke's ``fleet`` phase drives it on the card: a short traffic
ramp over a live group, with at least one ``scale_up`` and one
``scale_down`` decision and nothing lost.
"""

from __future__ import annotations

import os
import threading
from collections import deque

from veles.simd_tpu_torch import obs

__all__ = [
    "SCHEMA", "ACTIONS", "NOOP_REASONS", "ScalerEngine",
    "ARM_ENV", "TICK_MS_ENV", "MIN_ENV", "MAX_ENV", "COOLDOWN_MS_ENV",
    "UP_TICKS_ENV", "DOWN_TICKS_ENV", "BURN_ENV", "BURN_VELOCITY_ENV",
    "QUEUE_VELOCITY_ENV", "DEPTH_HIGH_ENV", "IDLE_DEPTH_ENV",
    "DEFAULT_TICK_MS", "DEFAULT_MIN", "DEFAULT_MAX",
    "DEFAULT_COOLDOWN_MS", "DEFAULT_UP_TICKS", "DEFAULT_DOWN_TICKS",
    "DEFAULT_BURN", "DEFAULT_BURN_VELOCITY", "DEFAULT_QUEUE_VELOCITY",
    "DEFAULT_DEPTH_HIGH", "DEFAULT_IDLE_DEPTH",
    "engine", "snapshot", "armed",
]

SCHEMA = "veles-simd-scaler-v1"

ARM_ENV = "VELES_SIMD_SCALER"
TICK_MS_ENV = "VELES_SIMD_SCALER_TICK_MS"
MIN_ENV = "VELES_SIMD_SCALER_MIN"
MAX_ENV = "VELES_SIMD_SCALER_MAX"
COOLDOWN_MS_ENV = "VELES_SIMD_SCALER_COOLDOWN_MS"
UP_TICKS_ENV = "VELES_SIMD_SCALER_UP_TICKS"
DOWN_TICKS_ENV = "VELES_SIMD_SCALER_DOWN_TICKS"
BURN_ENV = "VELES_SIMD_SCALER_BURN"
BURN_VELOCITY_ENV = "VELES_SIMD_SCALER_BURN_VELOCITY"
QUEUE_VELOCITY_ENV = "VELES_SIMD_SCALER_QUEUE_VELOCITY"
DEPTH_HIGH_ENV = "VELES_SIMD_SCALER_DEPTH_HIGH"
IDLE_DEPTH_ENV = "VELES_SIMD_SCALER_IDLE_DEPTH"

DEFAULT_TICK_MS = 100.0      # control cadence: fast enough to catch a
#                              ramp, slow enough to stay off the floor
DEFAULT_MIN = 1              # never drain the last replica
DEFAULT_MAX = 8              # spawn ceiling (CI boxes are small)
DEFAULT_COOLDOWN_MS = 2000.0  # settle time after EVERY action: one
#                               spawn must be absorbed by the signals
#                               before the next decision can fire
DEFAULT_UP_TICKS = 2         # consecutive firing ticks to act (up /
DEFAULT_DOWN_TICKS = 50      # replace vs the sustained idle window)
DEFAULT_BURN = 1.0           # SLO burn > 1.0 = eating error budget
DEFAULT_BURN_VELOCITY = 0.5  # burn rising >0.5/s with burn already
#                              warm = act before the budget is gone
DEFAULT_QUEUE_VELOCITY = 25.0  # queued requests/s growth
DEFAULT_DEPTH_HIGH = 8.0     # sustained per-replica backlog
DEFAULT_IDLE_DEPTH = 1.0     # total depth at/below this = idle

ACTIONS = ("replace", "scale_up", "scale_down")
NOOP_REASONS = ("idle", "hysteresis_pending", "cooldown", "at_bound",
                "replace_pending", "replace_failed", "spawn_failed",
                "retire_failed")

# which OPEN incident rule a firing scaler rule is causally linked to
# (the decision event carries that incident's id, and the postmortem
# renders the incident -> action -> effect chain from it)
_INCIDENT_AFFINITY = {
    "replica_down": ("replica_down",),
    "slo_burn": ("slo_burn",),
    "burn_velocity": ("slo_burn",),
    "queue_velocity": ("queue_runaway", "slo_burn"),
    "queue_depth": ("queue_runaway", "slo_burn"),
}

_QUEUE_HISTORY = 16   # (t, depth) pairs kept for the velocity slope
MAX_DECISIONS = 128   # bounded in-memory decision tail for /scaler


def _env_float(name: str, fallback: float) -> float:
    """Env override, falling back on missing/malformed/non-positive."""
    raw = os.environ.get(name)
    if raw is None:
        return fallback
    try:
        v = float(raw)
    except ValueError:
        return fallback
    return v if v > 0 else fallback


def _env_int(name: str, fallback: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return fallback
    try:
        v = int(raw)
    except ValueError:
        return fallback
    return v if v > 0 else fallback


def _rid_seq(rid) -> int:
    """The spawn-order ordinal behind an ``r<N>`` rid (unparseable
    rids sort oldest, so they win scale-down ties last)."""
    try:
        return int(str(rid).lstrip("r"))
    except ValueError:
        return -1


def armed_by_env() -> bool:
    """True when ``VELES_SIMD_SCALER`` is set truthy — the opt-in that
    lets :class:`~veles.simd_tpu_torch.serve.cluster.ReplicaGroup` start the
    control loop (off by default: an idle test group must not get
    scale-down-drained under the test's feet)."""
    raw = os.environ.get(ARM_ENV, "")
    return raw.strip().lower() in ("1", "true", "yes", "on")


class ScalerEngine:
    """Hysteresis-driven control loop over one
    :class:`~veles.simd_tpu_torch.serve.cluster.ReplicaGroup`.

    Construction wires the group and resolves every threshold
    (argument wins over environment over default); :meth:`tick`
    consumes one :class:`~veles.simd_tpu_torch.obs.timeseries.FleetSignals`
    and emits exactly one ``scaler`` decision event.  The clock is the
    signal's own ``at_s`` stamp, so tests drive hysteresis and
    cooldown with a fake clock and zero sleeps.

    Lock discipline (the PR-18 incident-engine lesson): the decision
    is *computed* under ``self._lock``, but group verbs run and the
    decision event is emitted OUTSIDE it — a verb takes the group
    lock and the journal touches disk; neither may ever block a
    concurrent ``snapshot()`` reader.
    """

    def __init__(self, group, *, min_replicas=None, max_replicas=None,
                 cooldown_s=None, up_ticks=None, down_ticks=None,
                 burn=None, burn_velocity=None, queue_velocity=None,
                 depth_high=None, idle_depth=None):
        self.group = group
        self.min_replicas = (min_replicas if min_replicas is not None
                             else _env_int(MIN_ENV, DEFAULT_MIN))
        self.max_replicas = (max_replicas if max_replicas is not None
                             else _env_int(MAX_ENV, DEFAULT_MAX))
        self.cooldown_s = (cooldown_s if cooldown_s is not None
                           else _env_float(COOLDOWN_MS_ENV,
                                           DEFAULT_COOLDOWN_MS) / 1e3)
        self.up_ticks = (up_ticks if up_ticks is not None
                         else _env_int(UP_TICKS_ENV, DEFAULT_UP_TICKS))
        self.down_ticks = (down_ticks if down_ticks is not None
                           else _env_int(DOWN_TICKS_ENV,
                                         DEFAULT_DOWN_TICKS))
        self.burn = (burn if burn is not None
                     else _env_float(BURN_ENV, DEFAULT_BURN))
        self.burn_velocity = (
            burn_velocity if burn_velocity is not None
            else _env_float(BURN_VELOCITY_ENV, DEFAULT_BURN_VELOCITY))
        self.queue_velocity = (
            queue_velocity if queue_velocity is not None
            else _env_float(QUEUE_VELOCITY_ENV,
                            DEFAULT_QUEUE_VELOCITY))
        self.depth_high = (depth_high if depth_high is not None
                           else _env_float(DEPTH_HIGH_ENV,
                                           DEFAULT_DEPTH_HIGH))
        self.idle_depth = (idle_depth if idle_depth is not None
                           else _env_float(IDLE_DEPTH_ENV,
                                           DEFAULT_IDLE_DEPTH))
        self.ticks = 0
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread = None
        self._streak = {a: 0 for a in ACTIONS}
        self._streak_since = {a: None for a in ACTIONS}
        self._cooldown_until = None   # sig.at_s clock
        self._last_t = None
        self._last_action = None
        self._actions = {}            # action -> count
        self._noops = {}              # reason -> count
        self._queue_hist = deque(maxlen=_QUEUE_HISTORY)
        self._retired = set()         # rids THIS engine scaled down —
        #                               replace must not resurrect them
        self._decisions = deque(maxlen=MAX_DECISIONS)

    # -- rules (each returns a firing-detail dict or None) ------------

    def _rule_replace(self, sig) -> dict | None:
        bad = sorted(r for r, h in (sig.health or {}).items()
                     if h in ("down", "stale")
                     and r not in self._retired)
        if not bad:
            return None
        return {"rule": "replica_down", "replica": bad[0],
                "unhealthy": bad}

    def _rule_scale_up(self, sig, alive, qvel) -> dict | None:
        burn = max((sig.slo_burn or {}).values(), default=0.0)
        if burn > self.burn:
            return {"rule": "slo_burn", "burn": burn}
        bvel = max((sig.slo_burn_velocity or {}).values(), default=0.0)
        if bvel > self.burn_velocity and burn > 0.25 * self.burn:
            return {"rule": "burn_velocity", "burn": burn,
                    "burn_velocity": bvel}
        if qvel is not None and qvel > self.queue_velocity:
            return {"rule": "queue_velocity", "queue_velocity": qvel}
        depth = sig.queue_depth_total or 0
        if depth / max(1, alive) > self.depth_high:
            return {"rule": "queue_depth", "depth_per_replica":
                    depth / max(1, alive)}
        return None

    def _rule_scale_down(self, sig) -> dict | None:
        burn = max((sig.slo_burn or {}).values(), default=0.0)
        depth = sig.queue_depth_total or 0
        if depth <= self.idle_depth and burn < 0.5 * self.burn:
            return {"rule": "idle", "depth": depth, "burn": burn}
        return None

    # -- the tick ------------------------------------------------------

    def _queue_velocity_locked(self, now, depth) -> float | None:
        self._queue_hist.append((now, float(depth or 0)))
        if len(self._queue_hist) < 2:
            return None
        t0, d0 = self._queue_hist[0]
        t1, d1 = self._queue_hist[-1]
        return (d1 - d0) / (t1 - t0) if t1 > t0 else None

    def _decide_locked(self, sig) -> dict:
        now = float(getattr(sig, "at_s", 0.0) or 0.0)
        self.ticks += 1
        self._last_t = now
        alive = self.group.alive()
        qvel = self._queue_velocity_locked(now, sig.queue_depth_total)
        inputs = {
            "burn_max": max((sig.slo_burn or {}).values(),
                            default=0.0),
            "burn_velocity_max": max(
                (sig.slo_burn_velocity or {}).values(), default=0.0),
            "queue_depth_total": sig.queue_depth_total,
            "queue_velocity": qvel,
            "breaker_flaps_max": max(
                (sig.breaker_flaps or {}).values(), default=0),
            "goodput": sig.goodput_overall,
            "alive": alive, "min": self.min_replicas,
            "max": self.max_replicas,
            "unhealthy": sorted(
                r for r, h in (sig.health or {}).items()
                if h in ("down", "stale")),
        }
        fired = {
            "replace": self._rule_replace(sig),
            "scale_up": self._rule_scale_up(sig, alive, qvel),
            "scale_down": self._rule_scale_down(sig),
        }
        plan = {"t": now, "action": None, "rule": None,
                "reason": "idle", "replica": None, "inputs": inputs,
                "incident_id": None, "pending_s": None}
        # priority: replace a dead replica before growing, grow before
        # shrinking; only the winning action's streak keeps building
        winner = next((a for a in ACTIONS if fired[a]), None)
        for a in ACTIONS:
            if a != winner:
                self._streak[a] = 0
                self._streak_since[a] = None
        if winner is None:
            return plan
        detail = fired[winner]
        self._streak[winner] += 1
        if self._streak_since[winner] is None:
            self._streak_since[winner] = now
        plan["rule"] = detail["rule"]
        plan["replica"] = detail.get("replica")
        plan["detail"] = detail
        plan["streak"] = self._streak[winner]
        plan["pending_s"] = now - self._streak_since[winner]
        plan["incident_id"] = self._linked_incident(sig,
                                                    detail["rule"])
        need = (self.down_ticks if winner == "scale_down"
                else self.up_ticks)
        if self._streak[winner] < need:
            plan["reason"] = "hysteresis_pending"
            return plan
        if (self._cooldown_until is not None
                and now < self._cooldown_until):
            plan["reason"] = "cooldown"
            plan["cooldown_remaining_s"] = self._cooldown_until - now
            return plan
        if winner == "scale_up" and alive >= self.max_replicas:
            plan["reason"] = "at_bound"
            plan["bound"] = "max"
            return plan
        if winner == "scale_down" and alive <= self.min_replicas:
            plan["reason"] = "at_bound"
            plan["bound"] = "min"
            return plan
        if winner == "scale_down":
            plan["replica"] = self._least_loaded(sig)
            if plan["replica"] is None:
                plan["reason"] = "at_bound"
                plan["bound"] = "min"
                return plan
        plan["action"] = winner
        plan["reason"] = detail["rule"]
        return plan

    def _least_loaded(self, sig) -> str | None:
        """The scale-down victim: the live replica with the smallest
        observed queue depth (ties break to the highest rid, so the
        most recently spawned goes first)."""
        live = [r.rid for r in self.group.live_replicas()]
        if len(live) <= self.min_replicas:
            return None
        depth = sig.queue_depth or {}
        return min(live, key=lambda r: (depth.get(r, 0.0),
                                        -_rid_seq(r))) if live else None

    @staticmethod
    def _linked_incident(sig, rule) -> str | None:
        affinity = _INCIDENT_AFFINITY.get(rule, ())
        open_inc = getattr(sig, "incidents", None) or ()
        for want in affinity:
            for inc in open_inc:
                if (inc or {}).get("rule") == want:
                    return inc.get("id")
        return None

    def _execute(self, plan) -> None:
        """Run the planned group verb OUTSIDE the engine lock; demote
        the plan to a typed no-op when the verb can't land yet."""
        action = plan["action"]
        if action is None:
            return
        try:
            if action == "replace":
                # restart() raises ValueError until the heartbeat /
                # drain machinery has actually flipped the replica to
                # DEAD — a typed "not yet", not a failure
                self.group.restart(plan["replica"])
            elif action == "scale_up":
                plan["replica"] = self.group.spawn_replica().rid
            elif action == "scale_down":
                rid = plan["replica"]
                with self._lock:
                    self._retired.add(rid)
                self.group.retire(rid, reason="scaler")
        except ValueError:
            plan["action"] = None
            plan["reason"] = "replace_pending"
        except Exception as exc:  # verb blew up: record, don't die
            plan["action"] = None
            plan["reason"] = {"replace": "replace_failed",
                              "scale_up": "spawn_failed",
                              "scale_down": "retire_failed"}[action]
            plan["error"] = repr(exc)

    def tick(self, sig) -> dict:
        """One control decision from one signals bundle.  Returns the
        decision record (also appended to the bounded tail, counted,
        and emitted as a ``scaler`` decision event)."""
        with self._lock:
            plan = self._decide_locked(sig)
        self._execute(plan)
        with self._lock:
            if plan["action"] is not None:
                self._cooldown_until = plan["t"] + self.cooldown_s
                self._streak[plan["action"]] = 0
                self._streak_since[plan["action"]] = None
                self._last_action = {
                    "action": plan["action"], "rule": plan["rule"],
                    "replica": plan["replica"], "t": plan["t"],
                    "incident_id": plan["incident_id"]}
                self._actions[plan["action"]] = \
                    self._actions.get(plan["action"], 0) + 1
            else:
                self._noops[plan["reason"]] = \
                    self._noops.get(plan["reason"], 0) + 1
            record = {k: plan.get(k) for k in
                      ("t", "action", "rule", "reason", "replica",
                       "incident_id", "pending_s", "streak")}
            record["inputs"] = plan["inputs"]
            if "error" in plan:
                record["error"] = plan["error"]
            self._decisions.append(record)
        self._emit(record)
        return record

    @staticmethod
    def _emit(record) -> None:
        """Decision event + counters, outside the lock (the journal
        tap inside ``record_decision`` touches disk)."""
        try:
            fields = {"rule": record["rule"],
                      "reason": record["reason"],
                      "inputs": record["inputs"]}
            for k in ("replica", "incident_id", "pending_s", "error"):
                if record.get(k) is not None:
                    fields[k] = record[k]
            obs.record_decision("scaler",
                                record["action"] or "noop", **fields)
            if record["action"] is not None:
                obs.count("scaler_action", action=record["action"],
                          rule=record["rule"] or "")
        except Exception:
            pass  # observing the scaler must never break the scaler

    # -- lifecycle -----------------------------------------------------

    def start(self, interval_s=None) -> None:
        """Spawn the daemon ticker: every ``interval_s`` (default
        ``VELES_SIMD_SCALER_TICK_MS``) read ``obs.signals()`` and
        :meth:`tick` on it."""
        if interval_s is None:
            interval_s = _env_float(TICK_MS_ENV, DEFAULT_TICK_MS) / 1e3
        with self._lock:
            if self._thread is not None:
                return
            self._stop_evt = threading.Event()
            self._thread = threading.Thread(
                target=self._run, args=(float(interval_s),),
                name="veles-serve-scaler", daemon=True)
        self._thread.start()

    def _run(self, interval_s: float) -> None:
        while not self._stop_evt.wait(interval_s):
            try:
                self.tick(obs.signals())
            except Exception:
                try:
                    obs.count("scaler_tick_error")
                except Exception:
                    pass

    def stop(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
        self._stop_evt.set()
        if t is not None:
            t.join(timeout=5.0)

    def snapshot(self) -> dict:
        """Schema-stamped live state for the ``/scaler`` route and
        ``obs.scaler_snapshot()`` — config, per-action/no-op counts,
        streaks, cooldown, and the bounded decision tail."""
        with self._lock:
            cooldown_remaining = 0.0
            if (self._cooldown_until is not None
                    and self._last_t is not None):
                cooldown_remaining = max(
                    0.0, self._cooldown_until - self._last_t)
            return {
                "schema": SCHEMA,
                "armed": True,
                "running": self._thread is not None,
                "ticks": self.ticks,
                "replicas": {"min": self.min_replicas,
                             "max": self.max_replicas,
                             "alive": self.group.alive()},
                "config": {
                    "cooldown_s": self.cooldown_s,
                    "up_ticks": self.up_ticks,
                    "down_ticks": self.down_ticks,
                    "burn": self.burn,
                    "burn_velocity": self.burn_velocity,
                    "queue_velocity": self.queue_velocity,
                    "depth_high": self.depth_high,
                    "idle_depth": self.idle_depth,
                },
                "cooldown_remaining_s": cooldown_remaining,
                "streaks": dict(self._streak),
                "actions": dict(self._actions),
                "noops": dict(self._noops),
                "last_action": (dict(self._last_action)
                                if self._last_action else None),
                "retired": sorted(self._retired),
                "decisions": [dict(d) for d in self._decisions],
            }

    def summary(self) -> dict:
        """The compact form embedded in ``FleetSignals.scaler`` —
        enough for dashboards and the incident engine's context
        without the full decision tail."""
        with self._lock:
            return {
                "armed": True,
                "running": self._thread is not None,
                "ticks": self.ticks,
                "actions": dict(self._actions),
                "last_action": (dict(self._last_action)
                                if self._last_action else None),
            }


# ---------------------------------------------------------------------------
# module-level registry: the live engine the /scaler route serves
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_engine: ScalerEngine | None = None


def _register(eng: ScalerEngine) -> None:
    """Last started wins — like the obs endpoint, one live control
    loop per process is the served one."""
    global _engine
    with _lock:
        _engine = eng


def _unregister(eng: ScalerEngine) -> None:
    global _engine
    with _lock:
        if _engine is eng:
            _engine = None


def engine() -> ScalerEngine | None:
    with _lock:
        return _engine


def armed() -> bool:
    with _lock:
        return _engine is not None


def snapshot() -> dict:
    """The ``/scaler`` body: the live engine's snapshot, or the
    schema-stamped disarmed shell."""
    with _lock:
        eng = _engine
    if eng is None:
        return {"schema": SCHEMA, "armed": False, "running": False,
                "ticks": 0, "actions": {}, "noops": {},
                "last_action": None, "decisions": []}
    return eng.snapshot()


def summary() -> dict:
    with _lock:
        eng = _engine
    if eng is None:
        return {"armed": False, "running": False, "ticks": 0,
                "actions": {}, "last_action": None}
    return eng.summary()


def _reset_for_tests() -> None:
    global _engine
    with _lock:
        eng, _engine = _engine, None
    if eng is not None:
        eng.stop()
