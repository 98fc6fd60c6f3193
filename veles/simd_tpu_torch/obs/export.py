"""Exporters for telemetry snapshots: JSON, Prometheus text, human table.

Copied from ``veles.simd_tpu.obs.export`` (framework-free; the port
keeps its own copy so it never imports the JAX package).  All three
render the JSON-native snapshot dict produced by
:func:`veles.simd_tpu_torch.obs.snapshot` — exporters never touch live
registry state, so a snapshot taken under load serializes consistently.

* :func:`to_json` / :func:`from_json` — lossless round trip (the flight
  recorder's bundle format).
* :func:`to_prometheus` / :func:`parse_prometheus` — the Prometheus text
  exposition format (`metric{label="v"} value`), for scraping a serving
  process.  Counter samples get the conventional ``_total`` suffix;
  histograms emit ``_bucket``/``_sum``/``_count`` series; the names
  carry the JAX package's ``veles_simd_`` prefix, so one dashboard
  reads both packages.
* :func:`report` — a terminal table for humans.
"""

from __future__ import annotations

import json
import re

__all__ = ["to_json", "from_json", "to_prometheus", "parse_prometheus",
           "report", "flatten_counters", "histogram_quantile",
           "histogram_quantiles", "span_summary", "serving_summary",
           "render_resources", "render_caches", "PROMETHEUS_PREFIX"]

PROMETHEUS_PREFIX = "veles_simd_"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_UNESCAPE_RE = re.compile(r"\\(.)")
_LINE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _prom_name(name: str) -> str:
    return PROMETHEUS_PREFIX + _NAME_RE.sub("_", name)


def _escape_label_value(v) -> str:
    """Prometheus exposition escaping for label values: backslash
    FIRST (or the other escapes' backslashes double-escape), then
    quote and newline."""
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (_NAME_RE.sub("_", k), _escape_label_value(v))
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def to_json(snapshot: dict, indent: int | None = 2) -> str:
    """Serialize a snapshot losslessly (strict JSON, no NaN)."""
    return json.dumps(snapshot, indent=indent, allow_nan=False,
                      sort_keys=False)


def from_json(text: str) -> dict:
    """Inverse of :func:`to_json`."""
    return json.loads(text)


def to_prometheus(snapshot: dict) -> str:
    """Render counters/gauges/histograms in the Prometheus text format.

    Events are *not* exported here (Prometheus is for aggregates; the
    event log travels in the JSON snapshot).
    """
    lines = []
    for c in snapshot.get("counters", []):
        name = _prom_name(c["name"]) + "_total"
        lines.append("# TYPE %s counter" % name)
        lines.append("%s%s %d" % (name, _prom_labels(c["labels"]),
                                  c["value"]))
    for g in snapshot.get("gauges", []):
        name = _prom_name(g["name"])
        lines.append("# TYPE %s gauge" % name)
        lines.append("%s%s %s" % (name, _prom_labels(g["labels"]),
                                  repr(float(g["value"]))))
    for h in snapshot.get("histograms", []):
        name = _prom_name(h["name"])
        lines.append("# TYPE %s histogram" % name)
        acc = 0
        for le, cnt in h["buckets"].items():
            acc += cnt
            lines.append("%s_bucket%s %d" % (
                name, _prom_labels({**h["labels"], "le": le}), acc))
        lines.append("%s_sum%s %s" % (name, _prom_labels(h["labels"]),
                                      repr(float(h["sum"]))))
        lines.append("%s_count%s %d" % (name, _prom_labels(h["labels"]),
                                        h["count"]))
    for drop_key in ("events_dropped", "spans_dropped"):
        dv = snapshot.get(drop_key)
        if dv is not None:
            name = _prom_name(drop_key) + "_total"
            lines.append("# TYPE %s counter" % name)
            lines.append("%s %d" % (name, dv))
    lines += _prometheus_resources(snapshot.get("resources", []))
    lines += _prometheus_caches(snapshot.get("caches", {}))
    return "\n".join(lines) + "\n"


# per-(op, route) resource fields exported as gauges (the latest
# harvested geometry's numbers — Prometheus is for the current state,
# history lives in archived JSON snapshots)
_RESOURCE_GAUGES = ("flops", "bytes_accessed", "arith_intensity",
                    "attainable_pct_of_roofline", "peak_bytes",
                    "argument_bytes", "output_bytes", "temp_bytes",
                    "generated_code_bytes")
_CACHE_GAUGES = ("size", "capacity", "hits", "misses", "evictions")


def _prometheus_resources(entries) -> list:
    lines = []
    for field in _RESOURCE_GAUGES:
        rows = [(e, e.get(field)) for e in entries
                if isinstance(e.get(field), (int, float))]
        if not rows:
            continue
        name = _prom_name("resource." + field)
        lines.append("# TYPE %s gauge" % name)
        for e, v in rows:
            lines.append("%s%s %s" % (
                name, _prom_labels({"op": e["op"], "route": e["route"]}),
                repr(float(v))))
    return lines


def _prometheus_caches(caches: dict) -> list:
    lines = []
    for field in _CACHE_GAUGES:
        rows = [(n, s.get(field)) for n, s in sorted(caches.items())
                if isinstance(s, dict)
                and isinstance(s.get(field), (int, float))]
        if not rows:
            continue
        name = _prom_name("cache." + field)
        lines.append("# TYPE %s gauge" % name)
        for n, v in rows:
            lines.append("%s%s %s" % (name, _prom_labels({"cache": n}),
                                      repr(float(v))))
    return lines


def parse_prometheus(text: str) -> dict:
    """Parse Prometheus text back to ``{(name, ((k, v), ...)): float}``.

    Covers the subset :func:`to_prometheus` emits — enough for a
    round-trip test and to diff two scrapes.
    """
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if not m:
            raise ValueError("unparseable exposition line: %r" % line)
        # single left-to-right pass: chained str.replace would misread
        # the tail of an escaped backslash followed by 'n' as a newline
        labels = tuple(
            (k, _UNESCAPE_RE.sub(
                lambda esc: "\n" if esc.group(1) == "n"
                else esc.group(1), v))
            for k, v in _LABEL_RE.findall(m.group("labels") or ""))
        out[(m.group("name"), labels)] = float(m.group("value"))
    return out


def histogram_quantile(hist: dict, q: float) -> float | None:
    """Estimate the ``q``-quantile (0..1) of one snapshot histogram.

    Prometheus ``histogram_quantile`` semantics: find the bucket the
    target rank falls in and interpolate linearly between its bounds
    (the lower bound of the first bucket is 0).  A rank landing in the
    ``+Inf`` bucket returns the highest finite bound — the honest
    answer for a fixed-bucket histogram.  Returns None for an empty
    histogram.
    """
    total = hist.get("count", 0)
    if not total:
        return None
    target = q * total
    cum = 0
    prev_le = 0.0
    for le_str, cnt in hist["buckets"].items():
        finite = le_str != "+Inf"
        le = float(le_str) if finite else float("inf")
        if cum + cnt >= target and cnt:
            if not finite:
                return prev_le
            return prev_le + (le - prev_le) * (target - cum) / cnt
        cum += cnt
        if finite:
            prev_le = le
    return prev_le


def histogram_quantiles(hist: dict, qs=(0.5, 0.95, 0.99)) -> dict:
    """``{"p50": ..., "p95": ..., "p99": ...}`` for one snapshot
    histogram (None values for an empty one)."""
    return {"p%g" % (q * 100): histogram_quantile(hist, q) for q in qs}


def span_summary(snapshot: dict) -> dict:
    """Latency summary of the ``span.*`` histograms in a snapshot:
    ``{name: {phase: {count, total_s, p50_s, p95_s, p99_s}}}``, the
    JAX package's shape for the same summary."""
    out = {}
    for h in snapshot.get("histograms", []):
        if not h["name"].startswith("span."):
            continue
        qs = histogram_quantiles(h)
        phase = h["labels"].get("phase", "all")
        out.setdefault(h["name"][len("span."):], {})[phase] = {
            "count": h["count"], "total_s": h["sum"],
            "p50_s": qs["p50"], "p95_s": qs["p95"],
            "p99_s": qs["p99"],
        }
    return out


def serving_summary(snapshot: dict) -> dict | None:
    """The serving layer's story out of one snapshot: queue/tenant
    depth gauges, per-status completion tallies with shed and
    deadline-miss rates, per-(op, status) request-latency quantiles,
    degraded-batch and breaker-shed counts, the latest per-class
    breaker states (from the retained ``breaker_transition`` decision
    events), and the request-axis + SLO summaries when the snapshot
    carries them.
    Returns None when the snapshot holds no ``serve_*`` metrics."""
    counters: dict = {}
    for c in snapshot.get("counters", []):
        name = c["name"]
        if name.startswith(("serve_", "fault_", "breaker_", "slo_")):
            counters.setdefault(name, {"total": 0, "by_label": {}})
            counters[name]["total"] += c["value"]
            key = ",".join("%s=%s" % kv
                           for kv in sorted(c["labels"].items()))
            counters[name]["by_label"][key] = c["value"]
    if not any(n.startswith("serve_") for n in counters):
        return None
    gauges = {}
    for g in snapshot.get("gauges", []):
        if g["name"].startswith(("serve_", "slo_")):
            key = g["name"]
            if g["labels"]:
                key += "{" + ",".join(
                    "%s=%s" % kv
                    for kv in sorted(g["labels"].items())) + "}"
            gauges[key] = g["value"]
    latency = {}
    for h in snapshot.get("histograms", []):
        if h["name"] != "serve.request_latency":
            continue
        op = h["labels"].get("op", "?")
        status = h["labels"].get("status", "all")
        latency[(op, status)] = {"count": h["count"],
                                 **histogram_quantiles(h)}
    submitted = counters.get("serve_submitted", {}).get("total", 0)
    completed = counters.get("serve_completed", {"by_label": {}})
    by_status: dict = {}
    for key, v in completed["by_label"].items():
        for part in key.split(","):
            if part.startswith("status="):
                status = part.split("=", 1)[1]
                by_status[status] = by_status.get(status, 0) + v
    shed = counters.get("serve_shed", {}).get("total", 0)
    misses = counters.get("serve_deadline_miss", {}).get("total", 0)
    breakers = {}
    for e in snapshot.get("events", []):
        if e.get("op") == "breaker_transition":
            breakers[(e.get("site"), e.get("key"))] = e.get("decision")
    return {
        "gauges": gauges,
        "submitted": submitted,
        "by_status": dict(sorted(by_status.items())),
        "shed": shed,
        "shed_rate": shed / submitted if submitted else None,
        "deadline_misses": misses,
        "deadline_miss_rate": (misses / submitted
                               if submitted else None),
        "degraded_batches": counters.get(
            "serve_degraded_batch", {}).get("total", 0),
        "breaker_shed": counters.get(
            "serve_breaker_shed", {}).get("total", 0),
        "latency": {"%s/%s" % k: v
                    for k, v in sorted(latency.items())},
        "breaker_states": {"%s %s" % k: v
                           for k, v in sorted(breakers.items())},
        "requests": snapshot.get("requests"),
        "slo": snapshot.get("slo"),
    }


def flatten_counters(snapshot: dict) -> dict:
    """Counters as one flat ``{"name{k=v,...}": value}`` dict — the
    compact form :func:`report` tabulates."""
    flat = {}
    for c in snapshot.get("counters", []):
        key = c["name"]
        if c["labels"]:
            key += "{" + ",".join("%s=%s" % kv
                                  for kv in sorted(c["labels"].items())) \
                + "}"
        flat[key] = c["value"]
    return flat


def _fmt_qty(v) -> str:
    """Compact engineering format for FLOP/byte counts."""
    if v is None:
        return "-"
    v = float(v)
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"),
                          (1e3, "k")):
        if abs(v) >= scale:
            return "%.2f%s" % (v / scale, suffix)
    return "%g" % v


def render_resources(entries, indent="  ") -> list:
    """Lines for a snapshot's per-(op, route) resource entries — the
    shared renderer of :func:`report`."""
    lines = []
    for e in entries:
        ai = e.get("arith_intensity")
        pct = e.get("attainable_pct_of_roofline")
        lines.append(
            "%s%-28s flops=%-8s bytes=%-8s AI=%-7s%s" % (
                indent, "%s/%s" % (e.get("op"), e.get("route")),
                _fmt_qty(e.get("flops")),
                _fmt_qty(e.get("bytes_accessed")),
                "-" if ai is None else "%.1f" % ai,
                "" if pct is None
                else " roofline<=%.0f%%" % pct))
        mem = [(k, e.get(k)) for k in ("argument_bytes", "output_bytes",
                                       "temp_bytes",
                                       "generated_code_bytes")]
        if any(v is not None for _, v in mem):
            lines.append("%s  mem: %s peak=%s" % (
                indent,
                " ".join("%s=%s" % (k.replace("_bytes", ""),
                                    _fmt_qty(v)) for k, v in mem),
                _fmt_qty(e.get("peak_bytes"))))
    return lines


def render_caches(caches: dict, indent="  ") -> list:
    """Lines for a snapshot's unified cache view (shared renderer)."""
    lines = []
    for name, s in sorted(caches.items()):
        if not isinstance(s, dict):
            continue
        cap = s.get("capacity")
        lines.append(
            "%s%-28s size=%s%s hits=%s misses=%s evictions=%s" % (
                indent, name, s.get("size", "-"),
                "" if cap is None else "/%s" % cap,
                s.get("hits", "-"), s.get("misses", "-"),
                s.get("evictions", "-")))
    return lines


def report(snapshot: dict, max_events: int = 20) -> str:
    """Human-readable table of a snapshot (newest events last)."""
    lines = ["== veles.simd_tpu_torch telemetry =="]
    flat = flatten_counters(snapshot)
    if flat:
        lines.append("")
        lines.append("counters:")
        width = max(len(k) for k in flat)
        for k, v in sorted(flat.items()):
            lines.append("  %-*s %12d" % (width, k, v))
    if snapshot.get("gauges"):
        lines.append("")
        lines.append("gauges:")
        for g in snapshot["gauges"]:
            lines.append("  %s%s = %g" % (
                g["name"],
                _prom_labels(g["labels"]).replace('"', ""), g["value"]))
    if snapshot.get("spans_dropped"):
        lines.append("")
        lines.append("spans dropped (trace ring overflow): %d"
                     % snapshot["spans_dropped"])
    if snapshot.get("histograms"):
        lines.append("")
        lines.append("histograms (seconds):")
        for h in snapshot["histograms"]:
            mean = h["sum"] / h["count"] if h["count"] else 0.0
            qs = histogram_quantiles(h)
            lines.append(
                "  %-40s n=%-8d mean=%.3e p50=%.1e p95=%.1e "
                "p99=%.1e" % (
                    h["name"]
                    + _prom_labels(h["labels"]).replace('"', ""),
                    h["count"], mean, qs["p50"] or 0.0,
                    qs["p95"] or 0.0, qs["p99"] or 0.0))
    if snapshot.get("resources"):
        lines.append("")
        lines.append("compiled-program resources (latest geometry per "
                     "op/route; roofline<= is the attainable share "
                     "of the MXU bound at this arithmetic "
                     "intensity):")
        lines += render_resources(snapshot["resources"])
    caches = snapshot.get("caches") or {}
    if any(isinstance(s, dict) and s.get("size") for s in
           caches.values()):
        lines.append("")
        lines.append("compile caches:")
        lines += render_caches(caches)
    events = snapshot.get("events", [])
    if events:
        lines.append("")
        lines.append("decision events (last %d of %d retained, %d "
                     "dropped):" % (min(max_events, len(events)),
                                    len(events),
                                    snapshot.get("events_dropped", 0)))
        for e in events[-max_events:]:
            extras = ", ".join(
                "%s=%s" % (k, v) for k, v in e.items()
                if k not in ("seq", "op", "decision") and v is not None)
            lines.append("  #%-6d %-24s -> %-18s %s" % (
                e["seq"], e["op"], e["decision"], extras))
    if len(lines) == 1:
        lines.append("(empty)")
    return "\n".join(lines) + "\n"
