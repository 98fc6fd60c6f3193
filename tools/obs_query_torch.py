#!/usr/bin/env python3
"""Offline fleet reconstruction over a journal pack of the port
(``tools/obs_query.py``'s twin over ``veles.simd_tpu_torch``).

The durable journal (:mod:`veles.simd_tpu_torch.obs.journal`) is only
worth its disk if the history can be *read back* after the replicas that
wrote it are dead.  This tool is that reader: point it at a pack
directory (``$VELES_SIMD_JOURNAL_DIR``) and it merges every
``journal-<pid>-<seg>.jsonl`` file — one per process, subprocess
replicas included — into one wall-clock-ordered fleet timeline, then:

* **timeline** (default) — human-readable, one line per record, with
  per-record provenance (pid/replica) and the decision payload;
* ``--summary`` — record counts per kind/op/replica, file inventory,
  torn/corrupt line counts (recovered-past, never fatal);
* ``--trace OUT.json`` — Chrome trace-event JSON: one track per
  process, every journal record an instant event, every reconstructed
  incident an explicit open→close span — same conventions as the
  request-axis fleet stitcher
  (:func:`veles.simd_tpu_torch.obs.timeseries.stitch_fleet_trace`),
  loads directly in Perfetto;
* ``--postmortem [ID|all]`` — renders each incident's story purely
  from on-disk records: the trigger detail at open, every breaker
  transition / replica lifecycle edge / fault-policy step that landed
  while it was open, the close reason — and, since obs v7, the
  control axis: scaler decisions that carried this incident's id are
  rendered as an action timeline plus the signal deltas across the
  effect window, so a scale-up that closed an ``slo_burn`` incident
  reads as one causal incident → action → effect story.

Filters compose: ``--rid`` / ``--replica`` / ``--site`` / ``--op`` /
``--kind`` / ``--since`` / ``--until`` (wall-clock seconds) /
``--last`` (trailing window).  ``tools/chaos_torch.py --replicas`` and
``--scale`` gate on this module's functions — the kill/drain/restart/
breaker cycles and the incidents a campaign provoked must be
reconstructible from the pack alone, with every in-memory ring gone.

The output is the JAX tool's, line for line, and the packs of either
package read alike (``obs.journal.read_pack``); the trace's process
track names the port.  It reads files only: no device is touched.

Usage:  python3 tools/obs_query_torch.py PACK_DIR
        python3 tools/obs_query_torch.py PACK_DIR --summary
        python3 tools/obs_query_torch.py PACK_DIR --trace fleet.json
        python3 tools/obs_query_torch.py PACK_DIR --postmortem all
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

from veles.simd_tpu_torch.obs import journal  # noqa: E402

# record kinds a postmortem renders inside an incident's open window
ACTIVITY_OPS = ("breaker_transition", "replica_lifecycle",
                "fault_policy", "fault_phase", "router_failover",
                "serve_lifecycle", "slo")


# -- filtering ---------------------------------------------------------------

def filter_records(records: list, *, rid=None, replica=None, site=None,
                   op=None, kind=None, since=None, until=None,
                   last=None) -> list:
    """Apply the CLI's filters to a merged record list.  ``rid`` and
    ``site`` match the ``data`` payload; ``replica`` matches the
    writer's identity stamp OR the payload's subject (a router's
    ``kill r0`` record and r0's own records both answer
    ``--replica r0``); ``since``/``until`` bound ``t_wall``; ``last``
    keeps the trailing N seconds relative to the newest record."""
    if last is not None and records:
        newest = max(r.get("t_wall", 0.0) for r in records)
        since = max(since or 0.0, newest - float(last))
    out = []
    for r in records:
        data = r.get("data") or {}
        if rid is not None and str(data.get("rid")) != str(rid):
            continue
        if replica is not None \
                and str(r.get("replica")) != str(replica) \
                and str(data.get("replica")) != str(replica):
            continue
        if site is not None and str(data.get("site")) != str(site):
            continue
        if op is not None and str(r.get("op")) != str(op):
            continue
        if kind is not None and str(r.get("kind")) != str(kind):
            continue
        t = r.get("t_wall", 0.0)
        if since is not None and t < since:
            continue
        if until is not None and t > until:
            continue
        out.append(r)
    return out


# -- incident reconstruction -------------------------------------------------

def incidents_from(records: list) -> list:
    """Reconstruct incidents purely from journaled ``incident``
    open/close decision events, matched by id.  Returns
    ``[{"id", "rule", "open", "close"}, ...]`` oldest-open first;
    ``close`` is None for incidents still open when the journal
    stopped."""
    opened: dict = {}
    done = []
    for r in records:
        if r.get("kind") != "decision" or r.get("op") != "incident":
            continue
        data = r.get("data") or {}
        iid = data.get("id")
        if r.get("decision") == "open":
            opened[iid] = {"id": iid, "rule": data.get("rule"),
                           "open": r, "close": None}
        elif r.get("decision") == "close" and iid in opened:
            inc = opened.pop(iid)
            inc["close"] = r
            done.append(inc)
    return done + list(opened.values())


def scaler_actions(records: list, incident_id) -> list:
    """Journaled scaler *actions* (noop ticks excluded) whose decision
    event carried this incident's id — the control-axis half of the
    incident's story."""
    out = []
    for r in records:
        if r.get("kind") != "decision" or r.get("op") != "scaler":
            continue
        if r.get("decision") in (None, "noop"):
            continue
        if (r.get("data") or {}).get("incident_id") == incident_id:
            out.append(r)
    return out


# the input-vector keys whose before→after deltas summarize whether a
# scaling action actually MOVED the signals it fired on
EFFECT_KEYS = ("burn_max", "queue_depth_total", "queue_velocity",
               "alive", "goodput")


def scaler_effect(records: list, actions: list, t_end: float) -> list:
    """The effect window: the input vector the first linked action saw
    vs the last journaled scaler tick at/before the incident's close
    (every scaler decision event — noops included — carries the full
    inputs, so the journal alone answers "did it work?").  Returns
    ``[(key, before, after), ...]`` for :data:`EFFECT_KEYS`."""
    if not actions:
        return []
    before = (actions[0].get("data") or {}).get("inputs") or {}
    after = None
    for r in records:
        if r.get("kind") != "decision" or r.get("op") != "scaler":
            continue
        inputs = (r.get("data") or {}).get("inputs")
        if not inputs:
            continue
        if r.get("t_wall", 0.0) <= t_end \
                and r.get("t_wall", 0.0) >= actions[-1].get("t_wall",
                                                            0.0):
            after = inputs
    if after is None:
        after = (actions[-1].get("data") or {}).get("inputs") or {}
    return [(k, before.get(k), after.get(k)) for k in EFFECT_KEYS]


def postmortem(records: list, incident: dict) -> str:
    """One incident's story from the pack: trigger, the
    breaker/lifecycle/fault activity inside its open window, the
    linked scaler action timeline + effect-window signal deltas
    (obs v7), close reason."""
    o, c = incident["open"], incident["close"]
    t0 = o.get("t_wall", 0.0)
    t1 = c.get("t_wall") if c else max(
        (r.get("t_wall", t0) for r in records), default=t0)
    lines = ["=" * 64,
             f"incident {incident['id']}  rule={incident['rule']}",
             f"  opened  {_stamp(t0)}  by {o.get('replica') or 'router'}"
             f" (pid {o.get('pid')})"]
    trigger = {k: v for k, v in (o.get("data") or {}).items()
               if k not in ("id", "rule")}
    lines.append(f"  trigger {json.dumps(trigger, default=str)}")
    activity = [r for r in records
                if r.get("kind") == "decision"
                and r.get("op") in ACTIVITY_OPS
                and t0 <= r.get("t_wall", 0.0) <= t1]
    lines.append(f"  activity during ({len(activity)} records):")
    for r in activity:
        lines.append("    " + _record_line(r, base_wall=t0))
    acts = scaler_actions(records, incident["id"])
    if acts:
        lines.append(f"  scaler actions linked ({len(acts)}):")
        for r in acts:
            d = r.get("data") or {}
            lines.append(
                f"    +{r.get('t_wall', 0.0) - t0:7.3f}s  "
                f"{r.get('decision')}  rule={d.get('rule')}  "
                f"replica={d.get('replica')}")
        effect = scaler_effect(records, acts, t1)
        if effect:
            lines.append("  effect window (signals across the "
                         "action(s)):")
            for key, before, after in effect:
                lines.append(f"    {key:<20} "
                             f"{_num(before)} -> {_num(after)}")
    if c is not None:
        lines.append(f"  closed  {_stamp(t1)}  "
                     f"reason={(c.get('data') or {}).get('reason')}  "
                     f"open for {t1 - t0:.2f}s")
    else:
        lines.append("  still open when the journal ended")
    return "\n".join(lines)


def _num(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)


# -- Chrome-trace export -----------------------------------------------------

def fleet_timeline_trace(records: list) -> dict:
    """The merged pack as Chrome trace-event JSON — the offline
    counterpart of :func:`veles.simd_tpu_torch.obs.timeseries.
    stitch_fleet_trace`, same conventions (one track per participant,
    instant events with the payload under ``args``, ``displayTimeUnit``
    ms) so both load identically in Perfetto.  Tracks are one per
    writing process (pid/replica); reconstructed incidents get
    explicit open→close duration events on a dedicated track."""
    if not records:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"fleet": True, "records": 0}}
    base = min(r.get("t_wall", 0.0) for r in records)
    tracks: dict = {}
    events = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
               "args": {"name": "veles.simd_tpu_torch journal pack"}}]

    def _tid(r):
        key = (r.get("pid"), r.get("replica"))
        if key not in tracks:
            tracks[key] = len(tracks) + 1
            events.append({
                "name": "thread_name", "ph": "M", "pid": 0,
                "tid": tracks[key],
                "args": {"name": f"{key[1] or 'router'} "
                                 f"(pid {key[0]})"}})
        return tracks[key]

    for r in records:
        name = r.get("op") or r.get("kind", "?")
        if r.get("decision"):
            name = f"{name}/{r['decision']}"
        events.append({
            "name": name, "cat": r.get("kind", "journal"), "ph": "i",
            "s": "t", "ts": (r.get("t_wall", base) - base) * 1e6,
            "pid": 0, "tid": _tid(r),
            "args": {"seq": r.get("seq"), "pid": r.get("pid"),
                     "replica": r.get("replica"),
                     **(r.get("data") or {})}})
    inc_tid = len(tracks) + 1
    incidents = incidents_from(records)
    if incidents:
        events.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": inc_tid, "args": {"name": "incidents"}})
    newest = max(r.get("t_wall", base) for r in records)
    for inc in incidents:
        t0 = inc["open"].get("t_wall", base)
        t1 = inc["close"].get("t_wall", newest) if inc["close"] \
            else newest
        events.append({
            "name": f"incident {inc['rule']}", "cat": "incident",
            "ph": "X", "ts": (t0 - base) * 1e6,
            "dur": max(t1 - t0, 1e-9) * 1e6, "pid": 0, "tid": inc_tid,
            "args": {"id": inc["id"], "rule": inc["rule"],
                     "closed": inc["close"] is not None}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"fleet": True, "records": len(records),
                          "tracks": len(tracks),
                          "incidents": len(incidents)}}


# -- rendering ---------------------------------------------------------------

def _stamp(t_wall: float) -> str:
    return time.strftime("%H:%M:%S", time.localtime(t_wall)) \
        + ("%.3f" % (t_wall % 1.0))[1:]


def _record_line(r: dict, base_wall: float | None = None) -> str:
    who = r.get("replica") or "router"
    head = f"+{r.get('t_wall', 0.0) - base_wall:7.3f}s" \
        if base_wall is not None else _stamp(r.get("t_wall", 0.0))
    name = r.get("op") or r.get("kind", "?")
    if r.get("decision"):
        name = f"{name}/{r['decision']}"
    return (f"{head}  {who:<10} pid={r.get('pid')}  {name}  "
            f"{json.dumps(r.get('data') or {}, default=str)}")


def summary(records: list, skipped: int, directory: str) -> str:
    kinds: dict = {}
    ops: dict = {}
    replicas: dict = {}
    for r in records:
        kinds[r.get("kind", "?")] = kinds.get(r.get("kind", "?"), 0) + 1
        key = r.get("op") or "-"
        ops[key] = ops.get(key, 0) + 1
        who = r.get("replica") or f"pid-{r.get('pid')}"
        replicas[who] = replicas.get(who, 0) + 1
    files = journal.discover(directory)
    lines = [f"journal pack: {directory}",
             f"  files: {len(files)}   records: {len(records)}   "
             f"skipped (torn/corrupt): {skipped}"]
    if records:
        span = max(r.get("t_wall", 0.0) for r in records) \
            - min(r.get("t_wall", 0.0) for r in records)
        lines.append(f"  span: {span:.2f}s wall clock")
    for title, table in (("kinds", kinds), ("ops", ops),
                         ("writers", replicas)):
        lines.append(f"  {title}:")
        for k, n in sorted(table.items(), key=lambda kv: -kv[1]):
            lines.append(f"    {k:<24} {n}")
    return "\n".join(lines)


# -- entry point -------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="offline fleet reconstruction over a journal pack")
    ap.add_argument("dir", help="journal pack directory "
                                "($VELES_SIMD_JOURNAL_DIR)")
    ap.add_argument("--rid", default=None, help="filter: request id")
    ap.add_argument("--replica", default=None,
                    help="filter: replica identity")
    ap.add_argument("--site", default=None,
                    help="filter: dispatch/breaker site")
    ap.add_argument("--op", default=None, help="filter: decision op")
    ap.add_argument("--kind", default=None,
                    help="filter: record kind (decision, incident...)")
    ap.add_argument("--since", type=float, default=None,
                    help="filter: wall-clock seconds (unix)")
    ap.add_argument("--until", type=float, default=None)
    ap.add_argument("--last", type=float, default=None,
                    help="filter: trailing window in seconds")
    ap.add_argument("--limit", type=int, default=200,
                    help="timeline line cap (0 = unlimited)")
    ap.add_argument("--summary", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="raw merged records as JSON lines")
    ap.add_argument("--trace", metavar="OUT",
                    help="write Chrome trace-event JSON (Perfetto)")
    ap.add_argument("--postmortem", metavar="ID", nargs="?",
                    const="all", default=None,
                    help="render incident postmortems ('all' or one id)")
    args = ap.parse_args(argv)

    all_records, skipped = journal.read_pack(args.dir)
    records = filter_records(
        all_records, rid=args.rid, replica=args.replica,
        site=args.site, op=args.op, kind=args.kind, since=args.since,
        until=args.until, last=args.last)
    if not journal.discover(args.dir):
        print(f"no journal files in {args.dir}", file=sys.stderr)
        return 2

    if args.summary:
        print(summary(records, skipped, args.dir))
        return 0
    if args.json:
        for r in records:
            print(json.dumps(r, default=str))
        return 0
    if args.trace:
        from veles.simd_tpu_torch.obs import export
        from veles.simd_tpu_torch.obs.atomic import atomic_write_text

        atomic_write_text(args.trace, export.to_json(
            fleet_timeline_trace(records), indent=None))
        print(f"wrote {args.trace} "
              f"({len(records)} records) — open in Perfetto")
        return 0
    if args.postmortem is not None:
        incs = incidents_from(records)
        if args.postmortem != "all":
            incs = [i for i in incs if i["id"] == args.postmortem]
        if not incs:
            print("no matching incidents in the pack",
                  file=sys.stderr)
            return 1
        for inc in incs:
            # the postmortem window needs the unfiltered pack: the
            # activity during an incident is the point
            print(postmortem(all_records, inc))
        return 0

    if skipped:
        print(f"note: {skipped} torn/corrupt line(s) skipped "
              f"(recovered past them)", file=sys.stderr)
    shown = records if not args.limit else records[-args.limit:]
    if len(shown) < len(records):
        print(f"... {len(records) - len(shown)} earlier records "
              f"(raise --limit)", file=sys.stderr)
    for r in shown:
        print(_record_line(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
