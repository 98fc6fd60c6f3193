"""Crash flight recorder: one atomic debug bundle when dispatch gives up.

The port of ``veles.simd_tpu.obs.flightrec``.  A signal service whose
dispatch keeps failing usually leaves nothing behind but a stack
trace — the decision events, counters and cache state that would
explain *why* are gone with the process.  This module freezes them to
disk as one JSON bundle:

* **on retry exhaustion** — the fault policy
  (:mod:`veles.simd_tpu_torch.runtime.faults`) calls
  :func:`maybe_record` when a guarded dispatch gives up, which writes a
  bundle if ``$VELES_SIMD_FLIGHT_DIR`` (or :func:`configure_flight_dir`)
  points somewhere.  Automatic capture is rate-limited
  (:data:`MAX_AUTO_BUNDLES` per process) so a fault storm cannot fill a
  disk, and the whole path is exception-proof — the recorder must
  never replace the original error with its own;
* **on crash** — when an exception escapes a *top-level* ``obs.span``
  (the dispatch layers are exactly the spans), the span exit hook calls
  :func:`maybe_record_crash` under the same budget;
* **on demand** — :func:`dump_debug_bundle` writes the same bundle any
  time.

The bundle carries the JAX package's schema and sections: reason and
exception, library config, platform (Python, torch, CUDA version, the
cards' names and ``nvidia-smi``'s name and power limit), environment
knobs, the telemetry snapshot (counters, gauges, histograms, decision
events, resources, cache stats), the span trace ring, the fault
history, the device-probe history (``utils.platform.probe_history``),
the journal's cursor, stats and tail, and the request axis (recent
causal chains, slowest and degraded exemplars, SLO accounts).  A
tenant's first SLO breach also arms a bundle (the request tracer calls
:func:`maybe_record`).  Writes go through the shared
atomic writer (:mod:`veles.simd_tpu_torch.obs.atomic`), so a bundle is
either complete or absent — never torn.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback

from veles.simd_tpu_torch.obs.atomic import atomic_write_text

__all__ = ["dump_debug_bundle", "maybe_record_crash", "maybe_record",
           "flight_dir", "configure_flight_dir",
           "auto_bundles_written",
           "SCHEMA", "MAX_AUTO_BUNDLES", "FLIGHT_DIR_ENV"]

SCHEMA = "veles-simd-flight-v1"
FLIGHT_DIR_ENV = "VELES_SIMD_FLIGHT_DIR"
# automatic bundles per process: enough to catch a repeating failure's
# first occurrences, bounded so a tight retry loop cannot turn the
# recorder into a disk-filling amplifier
MAX_AUTO_BUNDLES = 3

_lock = threading.Lock()
_configured_dir: str | None = None
_auto_bundles = 0
_seq = 0


def configure_flight_dir(path: str | None) -> None:
    """Runtime override of ``$VELES_SIMD_FLIGHT_DIR`` (None or ``""``
    restores the environment lookup)."""
    global _configured_dir
    with _lock:
        _configured_dir = str(path) if path else None


def flight_dir() -> str | None:
    """Where bundles go: the configured dir, else the env var, else
    None (automatic capture disarmed)."""
    with _lock:
        if _configured_dir is not None:
            return _configured_dir
    env = os.environ.get(FLIGHT_DIR_ENV, "").strip()
    return env or None


def auto_bundles_written() -> int:
    with _lock:
        return _auto_bundles


def _reset_auto_count() -> None:
    """Testing hook: re-arm the per-process automatic-capture budget."""
    global _auto_bundles
    with _lock:
        _auto_bundles = 0


def _platform_info() -> dict:
    info = {"python": sys.version.split()[0],
            "pid": os.getpid(),
            "argv": list(sys.argv)}
    torch = sys.modules.get("torch")
    if torch is None:
        info["torch"] = None
        return info
    info["torch"] = getattr(torch, "__version__", "unknown")
    info["cuda"] = torch.version.cuda
    try:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        info["devices"] = [torch.cuda.get_device_name(i)
                           for i in range(n)]
    except Exception as e:  # noqa: BLE001 — a lost card still dumps
        info["devices_error"] = repr(e)
    try:
        from veles.simd_tpu_torch.utils.platform import smi_line

        info["smi"] = smi_line()
    except Exception as e:  # noqa: BLE001
        info["smi_error"] = repr(e)
    return info


def _config_info() -> dict:
    try:
        import dataclasses

        from veles.simd_tpu_torch.utils.config import (get_backend,
                                                       get_config)

        return {"backend": get_backend().value,
                **dataclasses.asdict(get_config())}
    except Exception as e:  # noqa: BLE001
        return {"error": repr(e)}


def _env_info() -> dict:
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith("VELES_SIMD_")
            or k in ("CUDA_VISIBLE_DEVICES", "CUDA_LAUNCH_BLOCKING",
                     "CUDA_HOME")}


def _fault_info() -> list:
    """The fault-policy engine's retained fault records (injections,
    retries, demotions, exhaustions) — the history that explains a
    degraded run."""
    try:
        from veles.simd_tpu_torch.runtime import faults

        return faults.fault_history()
    except Exception:  # noqa: BLE001
        return []


def _probe_info() -> list:
    """Device-reachability probe history (utils/platform)."""
    try:
        from veles.simd_tpu_torch.utils import platform

        return platform.probe_history()
    except Exception:  # noqa: BLE001
        return []


def _journal_info() -> dict:
    """The durable journal's cursor, stats, and in-memory tail
    (:mod:`veles.simd_tpu_torch.obs.journal`) at bundle time."""
    try:
        from veles.simd_tpu_torch.obs import journal

        return {"cursor": journal.cursor(), "stats": journal.stats(),
                "tail": journal.tail()}
    except Exception as e:  # noqa: BLE001
        return {"error": repr(e)}


def build_bundle(reason: str, exc: BaseException | None = None) -> dict:
    """Assemble the bundle dict (separated from writing for tests and
    in-process consumers)."""
    from veles.simd_tpu_torch import obs

    bundle = {
        "schema": SCHEMA,
        "reason": str(reason),
        "written_unix": time.time(),
        "exception": None,
        "config": _config_info(),
        "platform": _platform_info(),
        "env": _env_info(),
        "snapshot": obs.snapshot(),
        "trace_events": obs.trace_events(),
        # the request axis: recent causal chains + slowest/degraded
        # exemplars + SLO accounts (obs/requests.py)
        "request_traces": obs.request_snapshot(),
        "fault_history": _fault_info(),
        "device_probes": _probe_info(),
        "journal": _journal_info(),
    }
    if exc is not None:
        bundle["exception"] = {
            "type": type(exc).__name__,
            "message": str(exc),
            "traceback": traceback.format_exception(
                type(exc), exc, exc.__traceback__),
        }
    return bundle


def dump_debug_bundle(path: str | None = None, reason: str = "explicit",
                      exc: BaseException | None = None) -> str:
    """Atomically write a debug bundle; returns the written path.

    ``path=None`` writes ``flight-<pid>-<seq>.json`` under
    :func:`flight_dir` (falling back to the current directory when no
    dir is configured — an explicit request always produces a file).
    """
    global _seq
    if path is None:
        base = flight_dir() or "."
        with _lock:
            _seq += 1
            n = _seq
        os.makedirs(base, exist_ok=True)
        path = os.path.join(base, "flight-%d-%d.json" % (os.getpid(), n))
    from veles.simd_tpu_torch.obs import export

    text = export.to_json(build_bundle(reason, exc))
    return atomic_write_text(path, text)


def maybe_record_crash(exc_type, exc) -> str | None:
    """Crash hook: write a bundle when armed and under the
    per-process budget; otherwise do nothing.  Never raises — the
    original exception is already unwinding and must win."""
    return maybe_record("span_crash", exc)


def maybe_record(reason: str, exc: BaseException | None) -> str | None:
    """Budgeted automatic capture: write a bundle when armed and under
    the shared :data:`MAX_AUTO_BUNDLES` budget; otherwise do nothing.
    Every automatic trigger goes through this one gate, so a service
    that keeps degrading still cannot turn the recorder into a
    disk-filling amplifier.  Never raises."""
    global _auto_bundles
    try:
        if flight_dir() is None:
            return None
        with _lock:
            if _auto_bundles >= MAX_AUTO_BUNDLES:
                return None
            _auto_bundles += 1      # reserve a slot (concurrent faults)
        try:
            return dump_debug_bundle(reason=reason, exc=exc)
        except Exception:  # noqa: BLE001
            # a failed WRITE (read-only dir, disk full) must not burn
            # budget: release the slot so the recorder stays armed for
            # when the filesystem recovers
            with _lock:
                _auto_bundles -= 1
            return None
    except Exception:  # noqa: BLE001
        return None
