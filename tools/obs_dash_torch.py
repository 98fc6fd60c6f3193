#!/usr/bin/env python3
"""Live dashboard for a serving process's scrape endpoint of the port
(``tools/obs_dash.py``'s twin over ``veles.simd_tpu_torch``).

The terminal twin of ``tools/obs_report_torch.py``: where obs_report
renders a SAVED snapshot, this hits a LIVE endpoint
(:mod:`veles.simd_tpu_torch.obs.http`, armed via
``$VELES_SIMD_OBS_PORT`` or ``serve.Server(obs_port=...)``) and renders
one compact screen from its three routes:

* ``/healthz`` — health state (the HTTP code alone says
  healthy/degraded), breaker registry, admission depths, batcher
  classes;
* ``/metrics`` — the serving counters/gauges that matter at a glance
  (submitted/completed by status, sheds, deadline misses, queue
  depths, SLO burn rates), parsed from the Prometheus text;
* ``/debug/requests`` — the request axis: per-status tallies, the
  slowest-per-op exemplars with their phase decomposition, recent
  degraded traces.

``--fleet`` switches to the fleet axis: one screen rendered from
``/signals`` (the typed ``obs.signals()`` bundle the ``ReplicaGroup``
collector feeds) — per-replica health/staleness/queue-depth/breaker
rows, the RPC data plane's per-replica in-flight / connection-reuse /
transport-error block (subprocess groups), goodput by shape class,
SLO burn + velocity, and a unicode sparkline over the last-N windowed
samples of each per-replica series.  When the process runs an armed
autoscaler the frame adds the control axis from ``/scaler``: tick
count, alive vs bounds, cooldown, per-action/no-op tallies, and the
last few decisions.  Point it at the ROUTER's aggregation endpoint; a
lone server answers with an empty fleet.

One shot by default; ``--watch N`` redraws every N seconds until
interrupted (``--fleet`` included).  rc=1 when the endpoint is
unreachable — the dashboard doubles as a liveness probe in scripts.
A frame is the JAX tool's, line for line; the tool speaks HTTP only,
so it renders either package's endpoint and touches no device.

Usage::

    python3 tools/obs_dash_torch.py --port 9100
    python3 tools/obs_dash_torch.py --url http://127.0.0.1:9100 --watch 2
    python3 tools/obs_dash_torch.py --port 9100 --fleet --watch 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))

from veles.simd_tpu_torch.obs import export  # noqa: E402


def fetch(url: str, timeout: float = 10.0) -> tuple:
    """``(status_code, body_text)`` — HTTP errors are still answers
    (503 from /healthz means DEGRADED, not unreachable)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode("utf-8", "replace")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8", "replace")


def _fmt_s(v) -> str:
    return "-" if v is None else "%.1e" % v


def _metric_lines(prom: str) -> list:
    """The at-a-glance serving rows out of a /metrics scrape."""
    parsed = export.parse_prometheus(prom)
    rows = []
    for (name, labels), value in sorted(parsed.items()):
        short = name.replace(export.PROMETHEUS_PREFIX, "")
        if not short.startswith(("serve_submitted", "serve_completed",
                                 "serve_shed", "serve_deadline_miss",
                                 "serve_queue_depth",
                                 "serve_degraded_batch",
                                 "serve_refilled",
                                 "slo_burn_rate", "slo_hit_rate")):
            continue
        if short.endswith(("_bucket", "_sum", "_count")):
            continue
        lab = ",".join("%s=%s" % kv for kv in labels)
        rows.append("  %-52s %12g"
                    % (short + ("{%s}" % lab if lab else ""), value))
    return rows


def _compile_lines(prom: str) -> list:
    """Warm-vs-cold compile tallies out of a /metrics scrape: how many
    executables this process LOADED (artifact hits + persistent-cache
    hits) vs COMPILED cold (artifact misses/stale/load errors +
    backend compiles that missed the cache) — the zero-warmup
    subsystem's at-a-glance scoreboard."""
    parsed = export.parse_prometheus(prom)
    tally: dict = {}
    for (name, labels), value in parsed.items():
        short = name.replace(export.PROMETHEUS_PREFIX, "")
        if short.endswith("_total"):        # counter suffix
            short = short[:-len("_total")]
        if short.startswith("artifact_") or \
                short.startswith("compile_"):
            if short.endswith(("_bucket", "_sum", "_count")):
                continue
            tally[short] = tally.get(short, 0) + value
    if not tally:
        return []
    # NB: artifact_preload is NOT summed into warm — every preloaded
    # entry that later dispatches also counts an artifact_hit, and
    # double-counting would overstate warm coverage
    warm = (tally.get("artifact_hit", 0)
            + tally.get("compile_cache_hits", 0))
    cold = (tally.get("artifact_miss", 0)
            + tally.get("artifact_stale", 0)
            + tally.get("artifact_load_error", 0)
            + tally.get("compile_cache_misses", 0))
    lines = ["compiles (warm vs cold): loaded=%g cold=%g"
             % (warm, cold)]
    for k in sorted(tally):
        if k.startswith("artifact_") or k in (
                "compile_cache_hits", "compile_cache_misses",
                "compile_backend_compile"):
            lines.append("  %-52s %12g" % (k, tally[k]))
    return lines


def _goodput_lines(prom: str) -> list:
    """The live goodput-recovery scoreboard out of a /metrics scrape:
    per shape class, useful vs dispatched SAMPLES and the padding
    waste between them — the footprint continuous batching + ragged
    packing exist to recover (``serve_refilled_rows`` in the metrics
    block above tallies the refill half)."""
    parsed = export.parse_prometheus(prom)
    per: dict = {}
    for (name, labels), value in parsed.items():
        short = name.replace(export.PROMETHEUS_PREFIX, "")
        if short.endswith("_total"):        # counter suffix
            short = short[:-len("_total")]
        if short not in ("serve_useful_samples",
                         "serve_dispatched_samples"):
            continue
        lab = dict(labels)
        key = "%s|%s" % (lab.get("op", "?"), lab.get("bucket", "?"))
        d = per.setdefault(key, [0.0, 0.0])
        d[0 if short == "serve_useful_samples" else 1] += value
    if not per:
        return []
    lines = ["goodput by shape class (useful/dispatched samples):"]
    tot_u = tot_d = 0.0
    for key in sorted(per):
        u, d = per[key]
        tot_u += u
        tot_d += d
        gp = u / d if d else None
        lines.append(
            "  %-28s useful=%-10g dispatched=%-10g goodput=%-7s "
            "waste=%s" % (
                key, u, d,
                "-" if gp is None else "%.4f" % gp,
                "-" if gp is None else "%.1f%%" % (100 * (1 - gp))))
    if tot_d:
        lines.append("  %-28s goodput=%.4f waste=%.1f%%" % (
            "overall", tot_u / tot_d, 100 * (1 - tot_u / tot_d)))
    return lines


# eight levels is what a terminal cell resolves; the ramp is the
# conventional one every sparkline tool uses
_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values, width: int = 32) -> str:
    """The last ``width`` samples as a unicode sparkline.  Scaled to
    the rendered window's own min..max (a flat series renders as all-
    low, which reads correctly as 'nothing moving')."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK[0] * len(vals)
    return "".join(
        _SPARK[min(len(_SPARK) - 1,
                   int((v - lo) / span * len(_SPARK)))]
        for v in vals)


def render_fleet(base_url: str) -> tuple:
    """One fleet-axis frame from ``/signals``; ``(text, reachable)``."""
    lines = [f"== fleet dash @ {base_url} =="]
    try:
        code, body = fetch(base_url + "/signals")
    except Exception as e:  # noqa: BLE001 — unreachable is the answer
        return (f"{lines[0]}\nendpoint unreachable: {e!r}\n", False)
    if code != 200:
        lines.append(f"/signals answered HTTP {code}")
        return "\n".join(lines) + "\n", True
    try:
        sig = json.loads(body)
    except ValueError:
        return f"{lines[0]}\n  (unparseable /signals body)\n", True
    lines.append(
        "ticks=%s  tick=%.3gs  window=%s  queue_total=%s" % (
            sig.get("ticks"), sig.get("tick_s") or 0.0,
            sig.get("window"), sig.get("queue_depth_total")))
    burn = sig.get("slo_burn") or {}
    vel = sig.get("slo_burn_velocity") or {}
    for tenant in sorted(burn):
        lines.append("  slo burn %-20s %10.4g  velocity %s" % (
            tenant, burn[tenant], _fmt_s(vel.get(tenant))))
    health = sig.get("health") or {}
    stale = sig.get("staleness_s") or {}
    depth = sig.get("queue_depth") or {}
    b_open = sig.get("breaker_open") or {}
    b_flaps = sig.get("breaker_flaps") or {}
    scrape = sig.get("scrape_stale") or {}
    if health:
        lines.append("replicas:")
    for rid in sorted(health):
        lines.append(
            "  %-8s %-9s stale=%-8s depth=%-6s breaker_open=%-3s "
            "flaps=%-3s scrape_stale=%s" % (
                rid, health[rid], _fmt_s(stale.get(rid)),
                depth.get(rid, "-"), b_open.get(rid, 0),
                b_flaps.get(rid, 0), scrape.get(rid, 0)))
    rpc = sig.get("rpc") or {}
    if rpc:
        # the RPC data plane (subprocess groups): what the router's
        # pooled client sees per replica — alongside scrape staleness,
        # this is the "is the wire healthy" read
        lines.append("rpc data plane:")
        for rid in sorted(rpc):
            row = rpc[rid] or {}
            ratio = row.get("reuse_ratio")
            lines.append(
                "  %-8s in_flight=%-5s conn_reuse=%-8s "
                "transport_errors=%s" % (
                    rid, row.get("in_flight", "-"),
                    "-" if ratio is None else "%.2f" % ratio,
                    row.get("transport_errors", 0)))
    occ = sig.get("occupancy") or {}
    if occ:
        # the padding-aware placement signal: rows already queued in
        # a replica's forming batches — the router's occupancy bonus
        # steers same-class work here so batches fill instead of pad
        lines.append("open-batch occupancy (rows in forming "
                     "batches):")
        for rid in sorted(occ):
            lines.append("  %-8s %g" % (rid, occ[rid]))
    good = sig.get("goodput") or {}
    overall = sig.get("goodput_overall")
    if good or overall is not None:
        lines.append("goodput (useful rows / dispatched rows):")
        if overall is not None:
            waste = sig.get("padding_waste")
            lines.append("  %-40s %8.4f%s" % (
                "overall", overall,
                "" if waste is None
                else "  (padding waste %.1f%%)" % (100 * waste)))
        for key in sorted(good):
            lines.append("  %-40s %8.4f" % (key, good[key]))
    # -- the history axis (obs v6): open incidents + journal health --
    incidents = sig.get("incidents") or []
    if incidents:
        lines.append("open incidents:")
        for inc in incidents:
            lines.append(
                "  %-16s %-20s firing=%-4s opened %s" % (
                    inc.get("id"), inc.get("rule"),
                    inc.get("ticks_firing"),
                    _fmt_s(inc.get("opened_t_mono"))))
    journal = sig.get("journal") or {}
    if journal.get("armed"):
        lines.append(
            "journal: armed  records=%-8s dropped=%-4s "
            "rotations=%-3s lag=%s" % (
                journal.get("records"), journal.get("dropped"),
                journal.get("rotations"),
                _fmt_s(journal.get("lag_s"))))
    else:
        lines.append("journal: disarmed")
    # -- the control axis (obs v7): the autoscaler's own route ------
    # (a pre-v7 endpoint 404s here — render nothing rather than die)
    try:
        s_code, s_body = fetch(base_url + "/scaler")
        scaler = json.loads(s_body) if s_code == 200 else None
    except Exception:  # noqa: BLE001 — optional route
        scaler = None
    if scaler and scaler.get("armed"):
        rep = scaler.get("replicas") or {}
        lines.append(
            "scaler: armed  ticks=%-7s alive=%s [%s..%s]  "
            "cooldown=%ss" % (
                scaler.get("ticks"), rep.get("alive"),
                rep.get("min"), rep.get("max"),
                "%g" % scaler.get("cooldown_remaining_s", 0.0)))
        acts = scaler.get("actions") or {}
        noops = scaler.get("noops") or {}
        if acts or noops:
            lines.append("  actions " + " ".join(
                "%s=%s" % kv for kv in sorted(acts.items())) +
                "  noops " + " ".join(
                "%s=%s" % kv for kv in sorted(noops.items())))
        last = scaler.get("last_action")
        if last:
            lines.append(
                "  last action %-10s rule=%-14s replica=%-6s "
                "incident=%s" % (
                    last.get("action"), last.get("rule"),
                    last.get("replica"), last.get("incident_id")))
        for d in (scaler.get("decisions") or [])[-5:]:
            lines.append(
                "  tick %-10s %-10s rule=%-14s reason=%s" % (
                    "%g" % d.get("t", 0.0), d.get("action") or "-",
                    d.get("rule") or "-", d.get("reason")))
    elif scaler is not None:
        lines.append("scaler: disarmed")
    series = sig.get("series") or {}
    if series:
        lines.append("series (last-N window):")
    for rid in sorted(series):
        for name in sorted(series[rid]):
            samples = series[rid][name] or []
            vals = [s[1] for s in samples]
            lines.append("  %-8s %-16s %10s  %s" % (
                rid, name, "%g" % vals[-1] if vals else "-",
                sparkline(vals)))
    return "\n".join(lines) + "\n", True


def render(base_url: str) -> tuple:
    """One dashboard frame; returns ``(text, reachable)``."""
    lines = [f"== obs dash @ {base_url} =="]
    try:
        code, health = fetch(base_url + "/healthz")
    except Exception as e:  # noqa: BLE001 — unreachable is the answer
        return (f"{lines[0]}\nendpoint unreachable: {e!r}\n", False)
    state = "HEALTHY" if code == 200 else \
        ("DEGRADED" if code == 503 else f"HTTP {code}")
    lines.append(f"health: {state}")
    try:
        h = json.loads(health)
        counts = h.get("counts", {})
        if counts:
            lines.append("  " + "  ".join(
                "%s=%s" % kv for kv in sorted(counts.items())))
        for b in h.get("breakers", []):
            lines.append("  breaker %-44s %s"
                         % (b.get("key"), b.get("state")))
        adm = h.get("admission", {})
        if adm:
            lines.append("  queue %s/%s  tenants %s"
                         % (adm.get("depth"), adm.get("max_depth"),
                            adm.get("tenants")))
    except ValueError:
        lines.append("  (unparseable /healthz body)")
    # the server can die between fetches (that is what a liveness
    # probe is for): any later-route failure degrades to the same
    # graceful unreachable answer instead of a traceback
    try:
        _, prom = fetch(base_url + "/metrics")
        _, reqs = fetch(base_url + "/debug/requests")
    except Exception as e:  # noqa: BLE001 — unreachable is the answer
        lines.append(f"endpoint lost mid-scrape: {e!r}")
        return "\n".join(lines) + "\n", False
    rows = _metric_lines(prom)
    if rows:
        lines.append("metrics:")
        lines += rows
    lines += _compile_lines(prom)
    lines += _goodput_lines(prom)
    try:
        r = json.loads(reqs)
        summary = r.get("summary", {})
        lines.append("requests: " + "  ".join(
            "%s=%s" % kv for kv in sorted(summary.items())
            if kv[0] != "by_status"))
        for status, n in sorted(
                (summary.get("by_status") or {}).items()):
            lines.append(f"  {status}={n}")
        slowest = r.get("slowest_by_op", {})
        if slowest:
            lines.append("slowest by op (phases, s):")
            for op, tr in sorted(slowest.items()):
                p = tr.get("phases", {})
                lines.append(
                    "  %-16s rid=%-6s total=%s queue=%s batch=%s "
                    "device=%s" % (
                        op, tr.get("rid"), _fmt_s(p.get("total_s")),
                        _fmt_s(p.get("queue_wait_s")),
                        _fmt_s(p.get("batch_wait_s")),
                        _fmt_s(p.get("device_s"))))
        degraded = r.get("degraded", [])
        if degraded:
            lines.append(f"degraded exemplars ({len(degraded)}):")
            for tr in degraded[-5:]:
                lines.append(
                    "  rid=%-6s %-14s tenant=%-10s events=%s" % (
                        tr.get("rid"), tr.get("op"), tr.get("tenant"),
                        ">".join(e.get("event", "?")
                                 for e in tr.get("events", []))))
    except ValueError:
        lines.append("  (unparseable /debug/requests body)")
    return "\n".join(lines) + "\n", True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--url", default=None,
                    help="endpoint base url (overrides --port)")
    ap.add_argument("--port", type=int, default=None,
                    help="localhost port (default: "
                         "$VELES_SIMD_OBS_PORT)")
    ap.add_argument("--watch", type=float, default=0.0,
                    help="redraw every N seconds (0 = one shot)")
    ap.add_argument("--fleet", action="store_true",
                    help="render the fleet axis from /signals "
                         "(point at the router's aggregation "
                         "endpoint)")
    args = ap.parse_args(argv)
    base = args.url
    if base is None:
        port = args.port
        if port is None:
            from veles.simd_tpu_torch.obs import http as obs_http

            port = obs_http.env_port()
        if port is None:
            print("obs_dash: no endpoint (--url/--port/"
                  "$VELES_SIMD_OBS_PORT)", file=sys.stderr)
            return 2
        base = f"http://127.0.0.1:{port}"
    base = base.rstrip("/")
    frame = render_fleet if args.fleet else render
    while True:
        text, reachable = frame(base)
        sys.stdout.write(text)
        sys.stdout.flush()
        if not reachable:
            return 1
        if args.watch <= 0:
            return 0
        time.sleep(args.watch)
        sys.stdout.write("\n")


if __name__ == "__main__":
    sys.exit(main())
