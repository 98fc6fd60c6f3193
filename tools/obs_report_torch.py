#!/usr/bin/env python3
"""Pretty-print a saved telemetry snapshot of the port
(``tools/obs_report.py``'s twin over ``veles.simd_tpu_torch.obs``).

Reads a JSON snapshot — either one written by ``obs.save(path)`` or a
details file (``BENCH_DETAILS_torch.json`` from ``bench_torch.py``,
``CHAOS_DETAILS_torch.json`` and the other ``*_DETAILS_torch.json``
files of ``tools/chaos_torch.py`` and ``tools/loadgen_torch.py``,
whose entries embed a compact per-config telemetry dict) — and renders
the human table the live ``obs.report()`` call would print, followed
by a dispatch-latency section: per-op p50/p95/p99 from the ``span.*``
histograms, warmup (first call, incl. kernel build and first plans)
separated from steady-state, and a Serving section when the snapshot
carries ``serve_*`` metrics: queue/tenant depths, per-status outcome
tallies with shed and deadline-miss rates, per-(op, status)
request-latency quantiles, degraded-batch counts, latest breaker
states, and the request-axis + per-tenant SLO summaries (details mode
gets the per-config ``serve_*`` counter block), and a Fleet section
when the snapshot carries the fleet axis (the ``ReplicaGroup``
collector's per-replica windowed series — last value, delta, flap
count), a Control section when it carries the ``scaler`` block (the
autoscaler's action/no-op tallies and decision tail), and a
goodput-recovery scoreboard for details entries carrying
``recovered`` evidence (``GOODPUT_DETAILS_torch.json``: padding waste
before/after per shape class).  ``--prometheus`` converts a full
snapshot to the Prometheus text exposition format instead, so a file
captured on a card host can be pushed through a gateway later.

A snapshot renders as the JAX tool renders it, line for line; it reads
files only, no device is touched.

Usage:  python3 tools/obs_report_torch.py SNAPSHOT.json
        python3 tools/obs_report_torch.py --prometheus SNAPSHOT.json
        python3 tools/obs_report_torch.py BENCH_DETAILS_torch.json
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

from veles.simd_tpu_torch.obs import export  # noqa: E402


def _fmt_s(v) -> str:
    return "-" if v is None else "%.1e" % v


def _render_span_summary(spans, indent="  ") -> list:
    """Lines for a bench-style span summary dict
    (``{name: {phase: {count, total_s, p50_s, p95_s, p99_s}}}``)."""
    lines = []
    for name in sorted(spans):
        for phase in sorted(spans[name]):
            s = spans[name][phase]
            lines.append(
                "%s%-32s %-7s n=%-6d p50=%s p95=%s p99=%s total=%s"
                % (indent, name, phase, s.get("count", 0),
                   _fmt_s(s.get("p50_s")), _fmt_s(s.get("p95_s")),
                   _fmt_s(s.get("p99_s")), _fmt_s(s.get("total_s"))))
    return lines


def _latency_section(snap) -> str:
    """Per-op host-dispatch latency from a full snapshot's ``span.*``
    histograms: p50/p95/p99 seconds, warmup vs. steady-state."""
    spans = export.span_summary(snap)
    if not spans:
        return ""
    lines = ["", "dispatch latency (seconds; warmup = first call, "
             "incl. trace+compile):"]
    lines += _render_span_summary(spans)
    return "\n".join(lines) + "\n"


def _artifact_section(snap) -> str:
    """The AOT artifact store (zero-warmup cold start): path, mode,
    and hit/miss/stale/eviction traffic — rendered beside the tune
    cache whenever the store is bound or saw traffic."""
    caches = (snap.get("caches") or {})
    st = caches.get("artifact_store")
    if not isinstance(st, dict):
        return ""
    traffic = sum(int(st.get(k) or 0) for k in
                  ("hits", "misses", "stale", "load_errors", "stores",
                   "preloaded"))
    if st.get("path") is None and not traffic:
        return ""
    lines = ["", "artifact store (AOT warm pack):",
             "  path=%s  mode=%s  entries=%s/%s  runners=%s"
             % (st.get("path"), st.get("mode"), st.get("size"),
                st.get("capacity"), st.get("runners")),
             "  hits=%s misses=%s stale=%s load_errors=%s stores=%s "
             "evictions=%s preloaded=%s"
             % tuple(st.get(k, 0) for k in
                     ("hits", "misses", "stale", "load_errors",
                      "stores", "evictions", "preloaded"))]
    refused = {k: st[k] for k in ("write_refused", "save_refused",
                                  "export_unsupported")
               if st.get(k)}
    if refused:
        lines.append("  " + "  ".join("%s=%s" % kv
                                      for kv in sorted(
                                          refused.items())))
    return "\n".join(lines) + "\n"


def _serving_section(snap) -> str:
    """The serving layer's story (obs v4): depths, outcome tallies
    with shed/miss rates, per-(op, status) request-latency quantiles,
    breaker states, and the request-axis + per-tenant SLO summaries."""
    s = export.serving_summary(snap)
    if s is None:
        return ""
    lines = ["", "serving:"]
    if s["gauges"]:
        lines.append("  " + "  ".join(
            "%s=%g" % kv for kv in sorted(s["gauges"].items())
            if not kv[0].startswith("slo_")))
    outcome = "  ".join("%s=%d" % kv
                        for kv in sorted(s["by_status"].items()))
    lines.append("  submitted=%d  %s" % (s["submitted"], outcome))
    rate = "-" if s["shed_rate"] is None else \
        "%.1f%%" % (100 * s["shed_rate"])
    mrate = "-" if s["deadline_miss_rate"] is None else \
        "%.1f%%" % (100 * s["deadline_miss_rate"])
    lines.append("  shed=%d (%s)  deadline_misses=%d (%s)  "
                 "degraded_batches=%d  breaker_shed=%d"
                 % (s["shed"], rate, s["deadline_misses"], mrate,
                    s["degraded_batches"], s["breaker_shed"]))
    if s["latency"]:
        lines.append("  request latency by op/status (s):")
        for key, q in s["latency"].items():
            lines.append(
                "    %-28s n=%-6d p50=%s p95=%s p99=%s"
                % (key, q["count"], _fmt_s(q.get("p50")),
                   _fmt_s(q.get("p95")), _fmt_s(q.get("p99"))))
    if s["breaker_states"]:
        lines.append("  breaker states (latest transition):")
        for key, state in s["breaker_states"].items():
            lines.append("    %-48s %s" % (key, state))
    req = s.get("requests")
    if req:
        lines.append(
            "  request axis: started=%s finished=%s open=%s  %s"
            % (req.get("started"), req.get("finished"),
               req.get("open"),
               " ".join("%s=%s" % kv for kv in sorted(
                   (req.get("by_status") or {}).items()))))
    slo = s.get("slo") or {}
    for tenant, acct in sorted((slo.get("accounts") or {}).items()):
        lines.append(
            "  slo %-12s requests=%-6d hit_rate=%s burn=%s%s"
            % (tenant, acct.get("requests", 0),
               acct.get("hit_rate_observed"), acct.get("burn_rate"),
               "  BREACHED" if acct.get("breached") else ""))
    return "\n".join(lines) + "\n"


def _fleet_section(snap) -> str:
    """The fleet axis (obs v5): per-replica windowed series captured
    by the ``ReplicaGroup`` collector — last value, windowed delta,
    and flap count per (replica, series), plus the tick/window
    bookkeeping.  Rendered whenever the snapshot carries a non-empty
    ``fleet`` block (``obs.snapshot()`` embeds it; pre-v5 snapshots
    simply lack the key)."""
    fleet = snap.get("fleet")
    if not isinstance(fleet, dict) or not fleet.get("series"):
        return ""
    lines = ["", "fleet (windowed series, %s ticks @ %ss, window %s):"
             % (fleet.get("ticks"), fleet.get("tick_s"),
                fleet.get("window"))]
    for rid in sorted(fleet["series"]):
        for name in sorted(fleet["series"][rid]):
            samples = fleet["series"][rid][name] or []
            vals = [s[1] for s in samples]
            delta = vals[-1] - vals[0] if len(vals) >= 2 else None
            flaps = sum(1 for a, b in zip(vals, vals[1:])
                        if abs(b - a) > 1e-9)
            lines.append(
                "  %-10s %-24s last=%-10g n=%-5d delta=%s flaps=%d"
                % (rid, name, vals[-1] if vals else float("nan"),
                   len(vals),
                   "-" if delta is None else "%g" % delta, flaps))
    return "\n".join(lines) + "\n"


def _history_section(snap) -> str:
    """The history axis (obs v6): durable-journal health and the
    incident ledger.  Rendered whenever the snapshot carries a
    ``journal`` or ``incidents`` block (``obs.snapshot()`` embeds
    both; pre-v6 snapshots simply lack the keys)."""
    journal = snap.get("journal")
    incidents = snap.get("incidents")
    if not isinstance(journal, dict) \
            and not isinstance(incidents, dict):
        return ""
    lines = ["", "history (obs v6):"]
    if isinstance(journal, dict):
        if journal.get("armed"):
            lines.append(
                "  journal armed @ %s" % journal.get("dir"))
            lines.append(
                "    records=%s dropped=%s rotations=%s pruned=%s "
                "lag_s=%s" % (
                    journal.get("records"), journal.get("dropped"),
                    journal.get("rotations"), journal.get("pruned"),
                    round(journal["lag_s"], 3)
                    if isinstance(journal.get("lag_s"), float)
                    else journal.get("lag_s")))
        else:
            lines.append("  journal disarmed "
                         "($VELES_SIMD_JOURNAL_DIR unset)")
    if isinstance(incidents, dict):
        lines.append("  incidents: %s open / %s closed over %s ticks"
                     % (incidents.get("open"),
                        incidents.get("closed"),
                        incidents.get("ticks")))
        for inc in incidents.get("incidents") or []:
            lines.append(
                "    %-16s %-20s %-7s firing=%-4s close=%s" % (
                    inc.get("id"), inc.get("rule"),
                    inc.get("state"), inc.get("ticks_firing"),
                    inc.get("close_reason") or "-"))
    return "\n".join(lines) + "\n"


def _control_section(snap) -> str:
    """The control axis (obs v7): the autoscaler block
    ``obs.snapshot()`` embeds — armed/running state, bounds, action
    and typed-no-op tallies, the last committed action, and the tail
    of the decision ledger.  Pre-v7 snapshots simply lack the key."""
    scaler = snap.get("scaler")
    if not isinstance(scaler, dict):
        return ""
    lines = ["", "control (obs v7):"]
    if not scaler.get("armed"):
        lines.append("  scaler disarmed (ReplicaGroup(scaler=True) "
                     "or $VELES_SIMD_SCALER arms it)")
        return "\n".join(lines) + "\n"
    rep = scaler.get("replicas") or {}
    lines.append(
        "  scaler armed  running=%s  ticks=%s  alive=%s in "
        "[%s..%s]  cooldown_remaining=%ss" % (
            scaler.get("running"), scaler.get("ticks"),
            rep.get("alive"), rep.get("min"), rep.get("max"),
            scaler.get("cooldown_remaining_s")))
    acts = scaler.get("actions") or {}
    noops = scaler.get("noops") or {}
    if acts:
        lines.append("  actions: " + "  ".join(
            "%s=%s" % kv for kv in sorted(acts.items())))
    if noops:
        lines.append("  no-ops:  " + "  ".join(
            "%s=%s" % kv for kv in sorted(noops.items())))
    last = scaler.get("last_action")
    if last:
        lines.append(
            "  last action: %s rule=%s replica=%s incident=%s" % (
                last.get("action"), last.get("rule"),
                last.get("replica"), last.get("incident_id")))
    tail = scaler.get("decisions") or []
    if tail:
        lines.append("  decisions (last %d):" % min(len(tail), 8))
        for d in tail[-8:]:
            lines.append(
                "    t=%-12s %-10s rule=%-14s reason=%-18s "
                "replica=%s" % (
                    "%g" % (d.get("t") or 0.0),
                    d.get("action") or "-", d.get("rule") or "-",
                    d.get("reason"), d.get("replica") or "-"))
    return "\n".join(lines) + "\n"


def _bench_serving_lines(counters: dict, indent="  ") -> list:
    """The details-mode serving block: a per-config tally of
    the ``serve_*`` counters the telemetry dict embeds."""
    serve = {k: v for k, v in sorted(counters.items())
             if k.startswith(("serve_", "slo_"))}
    if not serve:
        return []
    lines = [indent + "serving counters:"]
    for k, v in serve.items():
        lines.append("%s  %-56s %8d" % (indent, k, v))
    return lines


def _recovered_lines(rec, indent="  ") -> list:
    """The goodput-recovery scoreboard for one bench entry carrying
    ``recovered`` evidence (the saturation A/B in
    ``GOODPUT_DETAILS_torch.json``): dispatched-footprint waste before vs
    after continuous batching + ragged packing, the refilled-row
    tally, and the per-shape-class waste table.  A class blank on one
    side re-bucketed (packing folds the short stft pow2 classes into
    ``stft|ragged``) — the fold IS the mechanism, so it renders
    as-is rather than being papered over."""
    if not isinstance(rec, dict):
        return []

    def pct(v):
        return "-" if v is None else "%.1f%%" % (100.0 * v)

    lines = ["%sgoodput recovery scoreboard:" % indent,
             "%s  padding waste %s -> %s  refilled_rows=%s  "
             "useful=%s dispatched=%s"
             % (indent, pct(rec.get("waste_before")),
                pct(rec.get("waste_after")),
                rec.get("refilled_rows"),
                rec.get("useful_samples"),
                rec.get("dispatched_samples"))]
    by = rec.get("by_class") or {}
    if by:
        lines.append("%s  waste by shape class (before -> after):"
                     % indent)
        for key in sorted(by):
            w = by[key]
            lines.append("%s    %-28s %8s -> %8s"
                         % (indent, key, pct(w.get("waste_before")),
                            pct(w.get("waste_after"))))
    return lines


def _roofline_lines(roof, indent="  ") -> list:
    """Measured vs analytical roofline % for one bench entry (the
    port's rows keep the JAX key ``xla_flops`` for the resource axis's
    least-work count)."""
    if not roof:
        return []
    lines = ["%sroofline: measured %.0f%% of the f32-%s bound "
             "(%.1f TFLOP/s eff)"
             % (indent, roof.get("pct_of_roofline", 0.0),
                roof.get("precision", "?").upper(),
                roof.get("tflops_effective", 0.0))]
    ana = roof.get("analytical_pct_of_roofline")
    if ana is not None:
        lines.append(
            "%sanalytical (%s, least-work flops=%.3g): %.0f%% — "
            "disagreement %.0f%%"
            % (indent, roof.get("analytical_route", "?"),
               roof.get("xla_flops", 0.0), ana,
               roof.get("disagreement_pct", 0.0)))
    return lines


def _render_bench_details(entries) -> str:
    """Details-file mode: one telemetry block per bench config."""
    lines = []
    for e in entries:
        if "metric" not in e and "telemetry" not in e:
            continue        # tail entry (skipped_stages bookkeeping)
        tel = e.get("telemetry")
        lines.append("=== %s ===" % e.get("metric", "(unnamed config)"))
        lines += _roofline_lines(e.get("roofline"))
        lines += _recovered_lines(e.get("recovered"))
        if tel is None:
            lines.append("  (no telemetry recorded)")
            continue
        lines.append("  compiles=%s cache_hits=%s cache_misses=%s "
                     "events_dropped=%s" % (
                         tel.get("compiles"), tel.get("cache_hits"),
                         tel.get("cache_misses"),
                         tel.get("events_dropped")))
        for k, v in sorted(tel.get("counters", {}).items()):
            lines.append("  %-60s %8d" % (k, v))
        lines += _bench_serving_lines(tel.get("counters", {}))
        for d in tel.get("decisions", []):
            extras = ", ".join(
                "%s=%s" % (k, v) for k, v in d.items()
                if k not in ("seq", "op", "decision"))
            lines.append("  decision: %-24s -> %-18s %s"
                         % (d.get("op"), d.get("decision"), extras))
        if tel.get("resources"):
            lines.append("  compiled-program resources:")
            lines += export.render_resources(tel["resources"],
                                             indent="    ")
        caches = tel.get("caches") or {}
        if any(isinstance(s, dict) and s.get("size")
               for s in caches.values()):
            lines.append("  compile caches:")
            lines += export.render_caches(caches, indent="    ")
        spans = tel.get("spans") or {}
        if spans:
            lines.append("  dispatch latency (s):")
            lines += _render_span_summary(spans, indent="    ")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    prometheus = "--prometheus" in argv
    argv = [a for a in argv if a != "--prometheus"]
    if len(argv) != 1:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    path = argv[0]
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, list):  # a details file
        if prometheus:
            print("--prometheus needs a full obs snapshot, not "
                  "a details file", file=sys.stderr)
            return 2
        sys.stdout.write(_render_bench_details(data))
        return 0
    if prometheus:
        sys.stdout.write(export.to_prometheus(data))
        return 0
    sys.stdout.write(export.report(data, max_events=50))
    sys.stdout.write(_latency_section(data))
    sys.stdout.write(_artifact_section(data))
    sys.stdout.write(_serving_section(data))
    sys.stdout.write(_fleet_section(data))
    sys.stdout.write(_history_section(data))
    sys.stdout.write(_control_section(data))
    return 0


if __name__ == "__main__":
    sys.exit(main())
