"""The fleet axis: bounded time series and typed fleet signals.

The port of ``veles.simd_tpu.obs.timeseries``, line for line: it
imports neither JAX nor torch, and is copied rather than imported so
the port never loads the JAX package.  A bounded per-``(replica,
series)`` ring of periodic metric samples (:class:`FleetSeries`) with
windowed derivatives (:func:`rate`, :func:`delta`, :func:`ewma`) and
flap counting (:func:`flaps`), fed by the collector thread
:class:`veles.simd_tpu_torch.serve.cluster.ReplicaGroup` runs while
started (cadence ``$VELES_SIMD_FLEET_TICK_MS``, ring bound
``$VELES_SIMD_FLEET_WINDOW``).  In-process replicas are sampled
directly (depth / health / completed counts / open breakers);
subprocess replicas are scraped over their ``/metrics`` endpoints — a
failed scrape is *counted staleness*, never a crash.

On top of the store sit two fleet-level products:

* :class:`FleetSignals` — the typed, windowed signal bundle
  (``obs.signals()``): per-tenant SLO burn **and its velocity**, queue
  depths, breaker open/flap counts, goodput per shape class, and
  per-replica health/staleness — the input contract of the autoscaler
  (:mod:`veles.simd_tpu_torch.serve.scaler`), served as ``/signals``
  on the router aggregation endpoint;
* :func:`stitch_fleet_trace` — cross-replica trace stitching: a
  failed-over :class:`~veles.simd_tpu_torch.serve.cluster.RouterTicket`
  carries the dead replicas' terminal traces in ``prior_traces``;
  stitching merges them with the surviving replica's trace into ONE
  Perfetto-loadable fleet trace (one track per attempt, failover hops
  marked, the carried deadline stamped per attempt) — written by
  ``obs.save_trace(path, fleet=ticket)``.

Everything here is plain Python under one lock — no numpy, no torch —
so the fleet axis stays importable (and cheap) in processes without a
card.
"""

from __future__ import annotations

import collections
import os
import threading

__all__ = [
    "FleetSeries", "FleetSignals", "stitch_fleet_trace",
    "rate", "delta", "ewma", "flaps",
    "FLEET_TICK_MS_ENV", "FLEET_WINDOW_ENV",
    "DEFAULT_TICK_MS", "DEFAULT_WINDOW", "SIGNALS_SCHEMA",
    "env_tick_s", "env_window",
]

# the /signals contract version: bumped whenever FleetSignals gains,
# loses, or re-types a field, so dashboards can detect drift instead
# of mis-parsing (obs v6 added incidents + journal; obs v7 added
# replica_count + birth_age_s + scaler)
SIGNALS_SCHEMA = "veles-simd-signals-v4"

FLEET_TICK_MS_ENV = "VELES_SIMD_FLEET_TICK_MS"
FLEET_WINDOW_ENV = "VELES_SIMD_FLEET_WINDOW"

# 100 ms ticks match the heartbeat default: the collector rides the
# same "notice a dead replica in ~hundreds of ms" budget while costing
# a handful of lock-cheap reads per replica per tick
DEFAULT_TICK_MS = 100.0
# 120 samples x 100 ms = a 12 s sliding window — long enough for burn
# velocity and flap counting, small enough that N replicas x a dozen
# series stays a few thousand floats
DEFAULT_WINDOW = 120

# a replica whose newest sample is older than this many ticks reads
# as "stale" in the signals (the collector kept sweeping but this
# replica stopped yielding samples)
STALE_TICKS = 3.0


def env_tick_s() -> float:
    """Collector cadence in seconds from ``$VELES_SIMD_FLEET_TICK_MS``
    (default 100 ms; non-positive / malformed falls back)."""
    raw = os.environ.get(FLEET_TICK_MS_ENV, "").strip()
    if not raw:
        return DEFAULT_TICK_MS / 1e3
    try:
        value = float(raw)
    except ValueError:
        return DEFAULT_TICK_MS / 1e3
    return (value if value > 0 else DEFAULT_TICK_MS) / 1e3


def env_window() -> int:
    """Ring bound (samples per series) from
    ``$VELES_SIMD_FLEET_WINDOW`` (default 120)."""
    raw = os.environ.get(FLEET_WINDOW_ENV, "").strip()
    if not raw:
        return DEFAULT_WINDOW
    try:
        value = int(raw)
    except ValueError:
        return DEFAULT_WINDOW
    return value if value >= 2 else DEFAULT_WINDOW


# -- windowed derivatives (pure functions over [(t_s, value), ...]) ----------

def delta(samples) -> float | None:
    """Last value minus first value over the window (None if fewer
    than two samples)."""
    if len(samples) < 2:
        return None
    return samples[-1][1] - samples[0][1]


def rate(samples) -> float | None:
    """Windowed derivative in value-units per second: ``delta /
    elapsed`` across the window (None without two time-separated
    samples).  For cumulative counters this is the classic
    Prometheus-style ``rate()``."""
    if len(samples) < 2:
        return None
    dt = samples[-1][0] - samples[0][0]
    if dt <= 0:
        return None
    return (samples[-1][1] - samples[0][1]) / dt


def ewma(samples, alpha: float = 0.3) -> float | None:
    """Exponentially-weighted moving average of the windowed values
    (None on an empty window).  ``alpha`` is the new-sample weight."""
    if not samples:
        return None
    acc = samples[0][1]
    for _, v in samples[1:]:
        acc = alpha * v + (1.0 - alpha) * acc
    return acc


def flaps(samples, eps: float = 1e-9) -> int:
    """How many times the series CHANGED value across the window —
    the flap count for state-like series (breaker open counts,
    up/down health bits).  A series that went 0→1→0 flapped twice."""
    n = 0
    for i in range(1, len(samples)):
        if abs(samples[i][1] - samples[i - 1][1]) > eps:
            n += 1
    return n


class FleetSeries:
    """Bounded per-``(replica, series)`` sample rings behind one lock.

    The collector calls :meth:`record` with a shared monotonic
    timestamp per sweep and :meth:`tick` once per sweep; readers get
    JSON-native copies (:meth:`samples`, :meth:`snapshot`) or windowed
    derivatives (:meth:`rate` / :meth:`delta` / :meth:`ewma` /
    :meth:`flaps`).  ``tick_s`` is stamped by whoever drives the
    sweeps so staleness can be expressed in collector ticks."""

    def __init__(self, window: int | None = None):
        self.window = int(window) if window else env_window()
        if self.window < 2:
            raise ValueError("fleet window must be >= 2 samples")
        self.tick_s: float | None = None
        self.ticks = 0
        self._lock = threading.Lock()
        self._rings: dict = {}      # (replica, series) -> deque[(t, v)]

    # -- writes ------------------------------------------------------------

    def record(self, replica: str, series: str, value: float,
               t_s: float) -> None:
        key = (str(replica), str(series))
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = collections.deque(
                    maxlen=self.window)
            ring.append((float(t_s), float(value)))

    def tick(self) -> None:
        """Count one completed collector sweep."""
        with self._lock:
            self.ticks += 1

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()
            self.ticks = 0

    def forget(self, replica: str) -> int:
        """Drop every ring belonging to ``replica`` (returns how many
        were dropped).  The collector calls this for replicas that
        left group membership (``ReplicaGroup.retire``) — without it,
        a retired replica's aging samples would read as a "stale"
        replica in the signals forever."""
        replica = str(replica)
        with self._lock:
            doomed = [k for k in self._rings if k[0] == replica]
            for k in doomed:
                del self._rings[k]
            return len(doomed)

    # -- reads -------------------------------------------------------------

    def samples(self, replica: str, series: str) -> list:
        """Oldest-first ``[(t_s, value), ...]`` copy of one ring."""
        with self._lock:
            ring = self._rings.get((str(replica), str(series)))
            return list(ring) if ring else []

    def value(self, replica: str, series: str) -> float | None:
        """The newest value of one series (None if never recorded)."""
        s = self.samples(replica, series)
        return s[-1][1] if s else None

    def rate(self, replica: str, series: str) -> float | None:
        return rate(self.samples(replica, series))

    def delta(self, replica: str, series: str) -> float | None:
        return delta(self.samples(replica, series))

    def ewma(self, replica: str, series: str,
             alpha: float = 0.3) -> float | None:
        return ewma(self.samples(replica, series), alpha)

    def flaps(self, replica: str, series: str) -> int:
        return flaps(self.samples(replica, series))

    def replicas(self) -> list:
        """Replica names with at least one recorded series (sorted)."""
        with self._lock:
            return sorted({r for r, _ in self._rings})

    def names(self, replica: str) -> list:
        """Series recorded for ``replica`` (sorted)."""
        replica = str(replica)
        with self._lock:
            return sorted(s for r, s in self._rings if r == replica)

    def staleness_s(self, replica: str, now: float) -> float | None:
        """Seconds since ``replica``'s newest sample across ALL its
        series (None if it never produced one) — the "this replica
        stopped yielding" signal."""
        replica = str(replica)
        newest = None
        with self._lock:
            for (r, _), ring in self._rings.items():
                if r == replica and ring:
                    t = ring[-1][0]
                    if newest is None or t > newest:
                        newest = t
        return None if newest is None else max(0.0, now - newest)

    def snapshot(self) -> dict:
        """JSON-native copy: ``{"window", "ticks", "tick_s",
        "series": {replica: {series: [[t_s, value], ...]}}}``."""
        with self._lock:
            series: dict = {}
            for (r, s), ring in sorted(self._rings.items()):
                series.setdefault(r, {})[s] = [list(tv) for tv in ring]
            return {"window": self.window, "ticks": self.ticks,
                    "tick_s": self.tick_s, "series": series}


class FleetSignals:
    """The typed fleet-signal bundle — ``obs.signals()``'s return
    value, and the documented input contract for the autoscaling
    controller (GUIDE, "The fleet axis").  One instance is one
    consistent read of the fleet store + registry + SLO accounts:

    ===================== ==================================================
    field                 meaning
    ===================== ==================================================
    ``at_s``              monotonic stamp of this read
    ``ticks``             completed collector sweeps so far
    ``tick_s``            collector cadence (None = collector never armed)
    ``window``            ring bound (samples per series)
    ``slo_burn``          {tenant: current burn rate}
    ``slo_burn_velocity`` {tenant: d(burn)/dt over the window, 1/s}
    ``queue_depth``       {replica: newest admitted depth}
    ``queue_depth_total`` summed fleet queue depth
    ``occupancy``         {replica: rows queued in forming batches}
    ``breaker_open``      {replica: newest open-breaker count}
    ``breaker_flaps``     {replica: open-count changes over the window}
    ``goodput``           {"op|class": useful/dispatched rows gauge}
    ``goodput_overall``   fleet useful/dispatched rows (None = no batches)
    ``padding_waste``     1 - goodput_overall (None = no batches)
    ``health``            {replica: healthy|degraded|down|stale|unknown}
    ``staleness_s``       {replica: age of its newest sample}
    ``scrape_stale``      {replica: failed-scrape count (subprocess mode)}
    ``replica_count``     {"up"/"draining"/"down": group membership now}
    ``birth_age_s``       {replica: seconds since its Replica was born}
    ``rpc``               {replica: {in_flight, reuse_ratio,
                          transport_errors}} — the RPC data plane's
                          health per subprocess replica (empty for
                          thread-mode groups)
    ``incidents``         open incidents (obs v6 incident engine)
    ``journal``           journal health: armed/records/dropped/lag_s
    ``scaler``            control-axis summary (obs v7): armed/ticks/
                          actions/last_action
    ===================== ==================================================
    """

    __slots__ = ("at_s", "ticks", "tick_s", "window", "slo_burn",
                 "slo_burn_velocity", "queue_depth",
                 "queue_depth_total", "occupancy", "breaker_open",
                 "breaker_flaps", "goodput", "goodput_overall",
                 "padding_waste", "health", "staleness_s",
                 "scrape_stale", "replica_count", "birth_age_s",
                 "rpc", "incidents", "journal", "scaler", "series")

    def __init__(self, **kw):
        missing = [n for n in self.__slots__ if n not in kw]
        if missing:
            raise TypeError(f"missing signal fields: {missing}")
        for name in self.__slots__:
            setattr(self, name, kw.pop(name))
        if kw:
            raise TypeError(f"unknown signal fields: {sorted(kw)}")

    @classmethod
    def from_sources(cls, fleet: FleetSeries, registry_snapshot: dict,
                     slo_snapshot: dict, now: float,
                     incidents: list | None = None,
                     journal: dict | None = None,
                     scaler: dict | None = None) -> "FleetSignals":
        """Assemble one consistent bundle from the live sources: the
        fleet store (windowed series), a registry snapshot (goodput
        gauges + scrape-staleness counters), and the SLO accounts
        (current burn; velocity comes from the store's windowed
        ``slo_burn:<tenant>`` series).  ``incidents`` / ``journal`` /
        ``scaler`` are the history and control axes' contributions
        (``obs.signals()`` passes the open-incident list, journal
        health, and the scaler summary; callers wiring the sources by
        hand may omit them)."""
        burn: dict = {}
        for tenant, acct in sorted(
                (slo_snapshot.get("accounts") or {}).items()):
            if acct.get("burn_rate") is not None:
                burn[tenant] = acct["burn_rate"]
        velocity = {}
        for series in fleet.names("_fleet"):
            if series.startswith("slo_burn:"):
                v = fleet.rate("_fleet", series)
                if v is not None:
                    velocity[series.split(":", 1)[1]] = v
        replicas = [r for r in fleet.replicas() if r != "_fleet"]
        depth = {}
        occupancy = {}
        b_open = {}
        b_flaps = {}
        health = {}
        stale = {}
        ages = {}
        tick_s = fleet.tick_s
        stale_after = (STALE_TICKS * tick_s) if tick_s else None
        rpc = {}
        for r in replicas:
            d = fleet.value(r, "depth")
            if d is not None:
                depth[r] = d
            inflight = fleet.value(r, "rpc_in_flight")
            if inflight is not None:
                rpc[r] = {
                    "in_flight": int(inflight),
                    "reuse_ratio": fleet.value(r, "rpc_reuse_ratio"),
                    "transport_errors": int(
                        fleet.value(r, "rpc_transport_errors")
                        or 0),
                }
            occ = fleet.value(r, "occupancy")
            if occ is not None:
                occupancy[r] = occ
            bo = fleet.value(r, "breaker_open")
            if bo is not None:
                b_open[r] = int(bo)
                b_flaps[r] = fleet.flaps(r, "breaker_open")
            age = fleet.staleness_s(r, now)
            if age is not None:
                stale[r] = age
            born = fleet.value(r, "birth_age_s")
            if born is not None:
                ages[r] = born
            up = fleet.value(r, "up")
            healthy = fleet.value(r, "healthy")
            if up is None and healthy is None:
                health[r] = "unknown"
            elif up is not None and up < 0.5:
                health[r] = "down"
            elif stale_after is not None and age is not None \
                    and age > stale_after:
                health[r] = "stale"
            elif healthy is not None and healthy < 0.5:
                health[r] = "degraded"
            else:
                health[r] = "healthy"
        goodput = {}
        for g in registry_snapshot.get("gauges", []):
            if g["name"] == "serve.goodput":
                lbl = g.get("labels") or {}
                key = "|".join(str(lbl[k]) for k in sorted(lbl))
                goodput[key or "all"] = g["value"]
        useful = dispatched = 0
        scrape_stale = {}
        for c in registry_snapshot.get("counters", []):
            if c["name"] == "serve_useful_rows":
                useful += c["value"]
            elif c["name"] == "serve_dispatched_rows":
                dispatched += c["value"]
            elif c["name"] == "fleet_scrape_stale":
                rid = (c.get("labels") or {}).get("replica", "?")
                scrape_stale[rid] = scrape_stale.get(rid, 0) \
                    + c["value"]
        overall = (useful / dispatched) if dispatched else None
        # group membership: the collector's replica_count_* series
        # when present (a started ReplicaGroup), else derived from
        # the per-replica health map (hand-wired stores, tests)
        counts = {}
        for state in ("up", "draining", "down"):
            v = fleet.value("_fleet", f"replica_count_{state}")
            if v is not None:
                counts[state] = int(v)
        if not counts:
            counts = {
                "up": sum(1 for h in health.values()
                          if h not in ("down", "unknown")),
                "draining": 0,
                "down": sum(1 for h in health.values()
                            if h == "down"),
            }
        return cls(
            at_s=now, ticks=fleet.ticks, tick_s=tick_s,
            window=fleet.window, slo_burn=burn,
            slo_burn_velocity=velocity, queue_depth=depth,
            queue_depth_total=sum(depth.values()),
            occupancy=occupancy,
            breaker_open=b_open, breaker_flaps=b_flaps,
            goodput=goodput, goodput_overall=overall,
            padding_waste=(None if overall is None
                           else 1.0 - overall),
            health=health, staleness_s=stale,
            scrape_stale=scrape_stale,
            replica_count=counts, birth_age_s=ages, rpc=rpc,
            incidents=list(incidents or []),
            journal=dict(journal or {"armed": False}),
            scaler=dict(scaler or {"armed": False}),
            series=fleet.snapshot()["series"])

    def to_dict(self) -> dict:
        """JSON-native form — the ``/signals`` route body (includes
        the raw windowed ``series`` tails so dashboards can sparkline
        without keeping client-side history), stamped with
        :data:`SIGNALS_SCHEMA` so consumers can detect contract
        drift."""
        body = {"schema": SIGNALS_SCHEMA}
        body.update((name, getattr(self, name))
                    for name in self.__slots__)
        return body

    def __repr__(self):
        return ("FleetSignals(replicas=%d, ticks=%d, burn=%s, "
                "goodput=%s)" % (len(self.health), self.ticks,
                                 self.slo_burn, self.goodput_overall))


# -- cross-replica trace stitching -------------------------------------------

def stitch_fleet_trace(ticket) -> dict:
    """Merge a failed-over router ticket's request traces into ONE
    Chrome-trace JSON dict: the dead replicas' terminal traces
    (``ticket.prior_traces``) plus the surviving replica's trace, one
    track (tid) per attempt, every lifecycle edge as an instant
    event, an explicit ``failover_hop`` marker at each dead attempt's
    terminal edge, and the per-attempt deadline stamps
    (``deadlines_ms`` — the carried-deadline proof: entries only ever
    shrink) under ``otherData``.  Attempts are aligned on the shared
    process-monotonic clock their traces were minted on, so the
    failover timeline reads true in Perfetto.  Write it with
    ``obs.save_trace(path, fleet=ticket)``."""
    prior = [t for t in (getattr(ticket, "prior_traces", None) or [])
             if t is not None]
    final = getattr(ticket, "trace", None)
    attempts = prior + ([final] if final is not None else [])
    names = list(getattr(ticket, "attempt_replicas", None) or [])
    deadlines = list(getattr(ticket, "deadlines_ms", None) or [])
    pid = os.getpid()
    events = [{"name": "process_name", "ph": "M", "pid": pid,
               "tid": 0,
               "args": {"name": "veles.simd_tpu_torch fleet "
                                f"request {getattr(ticket, 'rid', '?')}"}}]
    mints = [getattr(tr, "_t0", None) for tr in attempts]
    known = [m for m in mints if m is not None]
    base = min(known) if known else 0.0
    for i, tr in enumerate(attempts):
        tid = i + 1
        off_s = (mints[i] - base) if mints[i] is not None else 0.0
        replica = names[i] if i < len(names) else (
            getattr(ticket, "replica", None) if tr is final else None)
        status = getattr(tr, "status", None)
        evs = tr.events() if hasattr(tr, "events") else []
        t_last = max([e.get("t_s", 0.0) for e in evs] or [0.0])
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid,
                       "args": {"name": f"attempt {i} @ "
                                        f"{replica or '?'} "
                                        f"({status or 'open'})"}})
        events.append({
            "name": f"{getattr(tr, 'op', None) or getattr(ticket, 'op', '?')}"
                    f" attempt {i}",
            "cat": "fleet", "ph": "X", "ts": off_s * 1e6,
            "dur": max(t_last, 1e-9) * 1e6, "pid": pid, "tid": tid,
            "args": {"replica": replica, "status": status,
                     "rid": getattr(tr, "rid", None),
                     "deadline_s": getattr(tr, "deadline_s", None),
                     "deadline_ms": (deadlines[i]
                                     if i < len(deadlines) else None),
                     "attempt": i}})
        for e in evs:
            events.append({
                "name": e.get("event", "?"), "cat": "fleet",
                "ph": "i", "s": "t",
                "ts": (off_s + e.get("t_s", 0.0)) * 1e6,
                "pid": pid, "tid": tid,
                "args": {k: v for k, v in e.items()
                         if k not in ("event", "t_s")}})
        if i < len(attempts) - 1:
            events.append({
                "name": "failover_hop", "cat": "fleet", "ph": "i",
                "s": "p", "ts": (off_s + t_last) * 1e6, "pid": pid,
                "tid": tid,
                "args": {"from_attempt": i, "to_attempt": i + 1,
                         "from_replica": replica,
                         "to_replica": (names[i + 1]
                                        if i + 1 < len(names)
                                        else None)}})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "fleet": True,
            "rid": getattr(ticket, "rid", None),
            "op": getattr(ticket, "op", None),
            "status": getattr(ticket, "status", None),
            "failovers": getattr(ticket, "failovers", 0),
            "attempts": len(attempts),
            "replicas": names,
            "deadlines_ms": deadlines,
        },
    }
