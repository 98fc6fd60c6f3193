"""Thread-safe metrics registry: counters, gauges, timing histograms.

The storage layer of :mod:`veles.simd_tpu_torch.obs`, copied from
``veles.simd_tpu.obs.registry``.  Everything here is plain-Python dict
arithmetic under one lock — deliberately no torch and no numpy, so the
module stays importable in environments without an accelerator
runtime, and a metric update never touches the device.

Metric identity is ``(name, labels)`` where labels are a small dict of
str->str (values are stringified on entry, Prometheus-style).  Histogram
buckets are fixed at construction — log-spaced seconds covering the
microsecond-dispatch to tens-of-seconds-compile range this library
observes — so merging and export never need to re-bucket.
"""

from __future__ import annotations

import threading

__all__ = ["MetricsRegistry", "DEFAULT_BUCKETS", "labels_key"]

# log-spaced seconds (half-decade steps): 1us dispatch .. 30s+
# remote-relay compiles.  Half-decade resolution keeps the p50/p95/p99
# estimates the exporters interpolate out of these buckets within ~3x
# of the true quantile — decade-wide buckets were too coarse for the
# microsecond dispatch spans that dominate this library's histograms.
DEFAULT_BUCKETS = (1e-6, 3e-6, 1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3,
                   1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0, 10.0, 30.0)


def labels_key(labels: dict) -> tuple:
    """Canonical hashable identity for a label set (sorted, stringified)."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Counters / gauges / histograms behind one lock.

    A single increment is one dict ``+=`` under the lock — the advertised
    per-call cost of enabled telemetry.  ``snapshot`` returns plain
    JSON-native structures (lists/dicts/ints/floats/strs) so exporters
    never reach into live state.
    """

    def __init__(self, buckets: tuple = DEFAULT_BUCKETS):
        self._lock = threading.Lock()
        self._buckets = tuple(float(b) for b in buckets)
        self._counters: dict[tuple, int] = {}
        self._gauges: dict[tuple, float] = {}
        # (name, labels) -> [per-bucket counts..., +Inf count, sum, count]
        self._hists: dict[tuple, list] = {}

    # -- writes ------------------------------------------------------------

    def count(self, name: str, n: int = 1, **labels) -> None:
        key = (str(name), labels_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + int(n)

    def gauge(self, name: str, value: float, **labels) -> None:
        key = (str(name), labels_key(labels))
        with self._lock:
            self._gauges[key] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one sample into the timing histogram ``name``."""
        value = float(value)
        key = (str(name), labels_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = [0] * (len(self._buckets) + 1) \
                    + [0.0, 0]
            for i, b in enumerate(self._buckets):
                if value <= b:
                    h[i] += 1
                    break
            else:
                h[len(self._buckets)] += 1      # +Inf bucket
            h[-2] += value
            h[-1] += 1

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # -- reads -------------------------------------------------------------

    def counter_value(self, name: str, **labels) -> int:
        with self._lock:
            return self._counters.get((str(name), labels_key(labels)), 0)

    def snapshot(self) -> dict:
        """JSON-native copy: ``{"counters": [...], "gauges": [...],
        "histograms": [...]}`` sorted by (name, labels) for stable
        round-trips."""
        with self._lock:
            counters = [
                {"name": n, "labels": dict(lk), "value": v}
                for (n, lk), v in sorted(self._counters.items())]
            gauges = [
                {"name": n, "labels": dict(lk), "value": v}
                for (n, lk), v in sorted(self._gauges.items())]
            hists = []
            for (n, lk), h in sorted(self._hists.items()):
                les = [repr(b) for b in self._buckets] + ["+Inf"]
                hists.append({
                    "name": n, "labels": dict(lk),
                    "buckets": {le: c for le, c in zip(les, h[:-2])},
                    "sum": h[-2], "count": h[-1]})
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}
