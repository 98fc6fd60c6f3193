"""Routing engine: candidate tables, selection, measured autotuning.

The port's counterpart of ``veles.simd_tpu.runtime.routing``.  Each op
family declares a :func:`family` of :class:`Route` entries in priority
order; a route's predicate is the geometry gate where its constants
live, ``disable_env`` names a truthy environment variable that closes
the gate, ``fault_site`` is the injection-plan site whose armed state
opens it (:func:`veles.simd_tpu_torch.runtime.faults.armed`), and
``rejection_cache`` / ``rejection_key`` are the demote-and-remember
memory that closes it for a geometry the card refused.  Eligibility
follows the JAX engine's order of precedence: rejection memory first,
then an armed plan, then the env opt-out, then the predicate; static
selection is the first eligible route in table order.

**One selection call.**  Every dispatch site of ``ops/`` and
``parallel/`` gets its route from :meth:`Family.select`: it hands over
the call's exact geometry, its probe runners, its operand and its tune
class, and a forced ``route=`` goes through the same call, which
validates it.  :meth:`Family.static_select` serves the choices that are
static by contract (``convolve.select_algorithm``,
``convolve2d.select_algorithm2d``, the packing and sharded-transform
layouts, the ``wavelet.cascade`` choice), which the tune cache never
steers.  Test seams open kernel gates on the CPU through the device
terms the predicates read (``cuda_kernels.on_card``,
``cuda_kernels.should_route``) or an armed fault plan.

**Measured autotuning** — ``VELES_SIMD_AUTOTUNE=off|on|readonly``
(default ``off``, the static prior).  With ``on``, the first encounter
of a geometry class with two or more eligible candidates probes each
one through the runners its call site hands :meth:`Family.select` (the
same calls dispatch makes, forced), keeps the fastest, records an
``autotune`` decision event with each route's microseconds, and
persists the winner in the tune cache; ``readonly`` consults the cache
and never probes.  A tune key is the JAX package's, letter for letter
(:func:`tune_key_str`); only the kernel routes' names differ, as
:data:`SITE_NAMES` maps them (``pallas_fused`` → ``cuda_fused``).

**The tune cache** — ``VELES_SIMD_AUTOTUNE_CACHE=path``: the JAX
package's version-1 JSON, written atomically (``obs.atomic``), loaded
lazily, corrupt files, version mismatches and foreign device stamps
ignored but counted, registered in ``obs.caches()`` as
``autotune_cache``.  A pack either package wrote on the same device
kind reads in the other.

Where the port differs from the JAX engine, on purpose:

* **The device stamp follows the routed operand.**  :func:`device_kind`
  is ``torch.cuda.get_device_name`` of the operand's card, ``"cpu"``
  for a host tensor, and for anything else (NumPy, lists) the kind of
  ``Config.device``; a failed query answers ``"unknown"`` and is not
  cached.  The process tune cache belongs to the configured device's
  kind.  A call whose operand lies on a device of another kind (CPU
  tensors in a process configured for the card) routes by the static
  prior: it reads no winner, probes nothing and stores nothing, and
  counts ``autotune_device_skip``.  So a CPU timing never lands under
  an H100 stamp, nor an H100 winner steers a CPU call.
* **The probe timer** times the burst difference (2 calls, then 2 +
  ``VELES_SIMD_AUTOTUNE_ITERS`` calls; the marginal per call) with CUDA
  events on the operand's current stream for a card operand, and with
  the host clock for a host one.  A card probe that cannot synchronise
  raises; it never falls back to the host clock.
* **A marginal that does not resolve is no time.**  The JAX engine
  floors a non-positive burst difference at 1e-9 s, so a probe that
  noise drove to zero (a stalled short burst on a loaded host) stored
  0 µs and won.  Here a pair whose marginal is at or under the tune
  cache's resolution (:data:`PROBE_RESOLUTION_S`, the 0.1 µs it keeps)
  is measured again, up to :data:`PROBE_PAIRS` pairs; a candidate that
  never resolves makes the round inconclusive, as a card's transient
  failure does (``autotune_probe_unresolved``; nothing is stored).
* **No probe under capture**: while a CUDA graph is being captured on
  the current stream or under ``torch.compiler.is_compiling()``
  (the JAX engine's tracer check) the engine returns the static prior.
* **Probe failures follow the port's fault classes**
  (:mod:`~veles.simd_tpu_torch.runtime.faults`): a device loss
  (46/214/702) or timeout is retried and then makes the round
  inconclusive; a program fault (700/710/716/719),
  ``torch.cuda.OutOfMemoryError`` and ``KernelBuildError`` re-raise —
  skipping them would hide a broken kernel behind the other candidate.
  For an operand already on a card every other error re-raises too and
  nothing is remembered, as dispatch treats such operands
  (``faults.on_card``): the card's data never gives way to another
  route.  For host data a launch the card refuses (CUDA 1/9/701) skips
  the candidate and feeds its route's rejection cache, and any other
  error skips the candidate, as in the JAX engine.

Probes launch kernels, so the kernel wrappers' launch counters count
them; with the autotuner ``off`` nothing extra is launched.  The probe
timer is injectable (:func:`set_probe_timer`, :func:`probe_timer`) so
the measured path runs deterministically on the CPU.

:data:`SITE_NAMES` maps the JAX package's kernel-route fault sites to
the port's (``pallas`` → ``cuda``, as the route names map), so a JAX
chaos plan runs here through :func:`port_plan`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import threading
import time

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.obs.atomic import atomic_write_text as _atomic_write
from veles.simd_tpu_torch.runtime import faults

__all__ = [
    "Route", "Family", "family", "families", "get_family",
    "autotune_mode", "autotune_mode_override",
    "AUTOTUNE_ENV", "AUTOTUNE_CACHE_ENV",
    "AUTOTUNE_ITERS_ENV", "AUTOTUNE_MODES", "DEFAULT_PROBE_ITERS",
    "TUNE_CACHE_VERSION", "TUNE_CACHE_MAX_ENTRIES", "TuneCache",
    "tune_cache", "set_cache_path", "private_tune_cache",
    "tune_key_str", "pow2_bucket", "mesh_class", "device_kind",
    "env_truthy", "set_probe_timer", "probe_timer",
    "pipeline_tune_geom",
    "SITE_NAMES", "port_plan",
]

AUTOTUNE_ENV = "VELES_SIMD_AUTOTUNE"
AUTOTUNE_CACHE_ENV = "VELES_SIMD_AUTOTUNE_CACHE"
AUTOTUNE_ITERS_ENV = "VELES_SIMD_AUTOTUNE_ITERS"

AUTOTUNE_MODES = ("off", "on", "readonly")

# tune-cache schema version (the JAX package's): a pack written with
# another layout is ignored wholesale, and counted
TUNE_CACHE_VERSION = 1

# chained probe length per candidate, after one warm-up call; short on
# purpose — exploration is paid once per geometry class
DEFAULT_PROBE_ITERS = 8

# tune-cache entry bound: beyond it the entry with the OLDEST "unix"
# measurement stamp is evicted (not dict order: a save/reload cycle
# serializes sorted and would make eviction alphabetical)
TUNE_CACHE_MAX_ENTRIES = 1024

# how long a pack that cannot be judged yet (the local device kind is
# "unknown") waits before the next load attempt
LOAD_RETRY_S = 1.0

# JAX package fault site -> the port's site for the same route; the
# dispatch sites (convolve.dispatch, stft.dispatch, istft.dispatch,
# convolve2d.dispatch, segments.dispatch, segments.segment) keep their
# names
SITE_NAMES = {"convolve.os_pallas": "convolve.os_cuda",
              "convolve2d.direct_pallas": "convolve2d.direct_cuda",
              "spectral.stft_pallas": "spectral.stft_cuda"}


def port_plan(spec: str) -> str:
    """A JAX package fault plan (``site[@subsite]:kind[:count],...``,
    or a phase schedule of them) with its sites renamed by
    :data:`SITE_NAMES`."""
    def entry(e):
        site, sep, rest = e.strip().partition(":")
        base, at, sub = site.partition("@")
        return SITE_NAMES.get(base, base) + at + sub + sep + rest

    def body(b):
        return ",".join(entry(e) for e in b.split(",") if e.strip())

    phases = []
    for part in spec.split(";"):
        label, eq, rest = part.rpartition("=")
        phases.append(label + eq + body(rest))
    return ";".join(phases)


def _evict_oldest(entries: dict) -> None:
    """Drop entries beyond the bound, oldest measurement first
    (missing stamps — hand-authored packs — count as oldest)."""
    while len(entries) > TUNE_CACHE_MAX_ENTRIES:
        entries.pop(min(entries,
                        key=lambda k: entries[k].get("unix", 0.0)))


# ---------------------------------------------------------------------------
# the device an operand is routed on
# ---------------------------------------------------------------------------

# card index -> torch.cuda.get_device_name; a failed query is not kept
_device_names: dict = {}


def _routed_device(operand=None):
    """The ``torch.device`` a call computes on: a tensor's own, else
    ``Config.device`` (where NumPy operands go)."""
    import torch

    if isinstance(operand, torch.Tensor):
        return operand.device
    from veles.simd_tpu_torch.utils.config import get_config

    return torch.device(get_config().device)


def device_kind(operand=None) -> str:
    """The device kind a routing decision is measured on and stamped
    with: ``torch.cuda.get_device_name`` (e.g. ``NVIDIA H100 80GB
    HBM3``) when ``operand`` — or, for a non-tensor or None,
    ``Config.device`` — is a card, ``"cpu"`` for the host.  A failed
    card query returns ``"unknown"`` and is NOT cached: it may be
    transient, and pinning it would reject every stamped pack."""
    import torch

    dev = _routed_device(operand)
    if dev.type != "cuda":
        return dev.type
    try:
        if not torch.cuda.is_available():
            return "unknown"
        index = (dev.index if dev.index is not None
                 else torch.cuda.current_device())
        name = _device_names.get(index)
        if name is None:
            name = _device_names[index] = str(
                torch.cuda.get_device_name(index))
        return name
    except Exception:  # noqa: BLE001 — no runtime: still routable
        return "unknown"


class _ThreadState(threading.local):
    """Thread-local mode override, private cache and probe device: a
    supervised worker that is abandoned mid-run must never flip routing
    for the process.  The class defaults make reading an unset field a
    plain lookup; a bare ``threading.local`` raises and catches an
    ``AttributeError`` inside ``getattr``, about 0.5 us a read."""

    mode = None
    cache = None
    probe_device = None


_tls = _ThreadState()


def autotune_mode() -> str:
    """The active autotune mode (``$VELES_SIMD_AUTOTUNE``, or a
    thread-scoped :func:`autotune_mode_override`): ``off`` (static
    table order — the default), ``on`` (measure unseen geometry
    classes, persist winners) or ``readonly`` (consult the tune cache,
    never probe).  Unknown values read as ``off``."""
    override = _tls.mode
    if override is not None:
        return override     # validated by autotune_mode_override
    # every routed call asks: the unset default returns at once
    raw = faults.getenv(AUTOTUNE_ENV)
    if raw is None:
        return "off"
    raw = raw.strip().lower()
    return raw if raw in AUTOTUNE_MODES else "off"


@contextlib.contextmanager
def autotune_mode_override(mode: str):
    """Scoped, THREAD-LOCAL mode override: if the thread is abandoned
    before the scope exits, the override dies with it instead of
    leaking into the process environment."""
    if mode not in AUTOTUNE_MODES:
        raise ValueError(f"mode must be one of {AUTOTUNE_MODES}, "
                         f"got {mode!r}")
    prev = _tls.mode
    _tls.mode = mode
    try:
        yield
    finally:
        _tls.mode = prev


def _probe_iters() -> int:
    raw = (faults.getenv(AUTOTUNE_ITERS_ENV) or "").strip()
    try:
        n = int(raw) if raw else DEFAULT_PROBE_ITERS
    except ValueError:
        return DEFAULT_PROBE_ITERS
    return n if n >= 1 else DEFAULT_PROBE_ITERS


# ---------------------------------------------------------------------------
# probe timer (injectable — the CPU tests run a deterministic fake)
# ---------------------------------------------------------------------------

# the least marginal a probe records: the tune cache keeps tenths of a
# microsecond, so anything at or under this would store as 0 us
PROBE_RESOLUTION_S = 1e-7
# burst pairs a probe measures before it gives up on an unresolved
# marginal
PROBE_PAIRS = 3


class ProbeUnresolved(RuntimeError):
    """No burst pair of a probe resolved a marginal above
    :data:`PROBE_RESOLUTION_S`."""


def _burst_difference(burst) -> float:
    """Marginal seconds per call from two bursts of different lengths:
    the fixed cost of a burst (first launch, the final wait) cancels.
    A pair at or under :data:`PROBE_RESOLUTION_S` is measured again, up
    to :data:`PROBE_PAIRS` pairs; then :class:`ProbeUnresolved`."""
    lo = 2
    hi = lo + _probe_iters()
    seen = []
    for _ in range(PROBE_PAIRS):
        t_lo = burst(lo)
        t_hi = burst(hi)
        per_call = (t_hi - t_lo) / (hi - lo)
        if per_call > PROBE_RESOLUTION_S:
            return per_call
        seen.append(per_call)
    raise ProbeUnresolved(
        f"{PROBE_PAIRS} burst pairs ({lo} and {hi} calls) left no "
        f"marginal above {PROBE_RESOLUTION_S * 1e6:.1f} us: "
        + ", ".join(f"{t * 1e6:.3f} us" for t in seen))


def _cuda_probe(thunk, dev) -> float:
    """Seconds per call of ``thunk`` on card ``dev``: CUDA events on the
    current stream around each burst.  Every failure raises — a card
    probe never degrades to the host clock."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(f"probe of an operand on {dev}: no usable "
                           "CUDA runtime to time it with")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream()
        thunk()
        stream.synchronize()

        def burst(k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(k):
                thunk()
            end.record(stream)
            end.synchronize()
            return start.elapsed_time(end) * 1e-3

        return _burst_difference(burst)


def _host_probe(thunk, clock=time.perf_counter) -> float:
    """Seconds per call of ``thunk`` on the host clock (CPU tensors
    compute synchronously); ``clock`` is the clock read around each
    burst."""
    thunk()

    def burst(k):
        t0 = clock()
        for _ in range(k):
            thunk()
        return clock() - t0

    return _burst_difference(burst)


def _default_probe(thunk, route_name: str) -> float:
    """Seconds per dispatch of ``thunk`` (a zero-arg candidate runner):
    one warm-up call (kernel builds land here), then the burst
    difference — on CUDA events for an operand on a card, on the host
    clock otherwise (the device :meth:`Family.select` routes on)."""
    del route_name
    dev = _tls.probe_device
    if dev is not None and dev.type == "cuda":
        return _cuda_probe(thunk, dev)
    return _host_probe(thunk)


_probe_lock = threading.Lock()
_PROBE_TIMER = _default_probe


def set_probe_timer(fn=None) -> None:
    """Replace the probe timer (``fn(thunk, route_name) -> seconds``);
    ``None`` restores the default."""
    global _PROBE_TIMER
    with _probe_lock:
        _PROBE_TIMER = fn if fn is not None else _default_probe


@contextlib.contextmanager
def probe_timer(fn):
    """Scoped :func:`set_probe_timer` — the test-suite idiom."""
    with _probe_lock:
        prev = _PROBE_TIMER
    set_probe_timer(fn)
    try:
        yield
    finally:
        set_probe_timer(prev if prev is not _default_probe else None)


# ---------------------------------------------------------------------------
# the persistent tune cache
# ---------------------------------------------------------------------------

def pow2_bucket(v: int) -> int:
    """Geometry-class bucketing: the next power of two >= ``v``.
    Dimensions that vary per call (signal length, batch rows) are
    bucketed before they key the tune cache; dimensions the gates
    compare exactly (filter taps, frame/hop) stay exact."""
    v = int(v)
    if v <= 1:
        return v
    return 1 << (v - 1).bit_length()


def mesh_class(mesh, axis: str | None = None) -> str:
    """Canonical ``(mesh_shape, axis_names)`` token for a device mesh
    (duck-typed: anything with ``.shape`` as a name->size mapping),
    e.g. ``"dp2xsp4@sp"`` — the collective axis appended when given.
    Sharded families key and stamp their entries with it, so a winner
    measured on one topology never steers another."""
    body = "x".join(f"{k}{int(v)}" for k, v in dict(mesh.shape).items())
    return f"{body}@{axis}" if axis else body


def pipeline_tune_geom(geom: dict) -> dict:
    """Stamp a tune-class geometry as pipeline-compiled (``ctx=
    "pipeline"``): a winner measured for a standalone dispatch
    amortizes per-call overhead a fused pipeline step never pays."""
    return {"ctx": "pipeline", **dict(geom)}


def tune_key_str(fam: str, geom: dict) -> str:
    """Canonical geometry-class key: ``family|k=v,k=v`` over the sorted
    geometry fields — the JAX package's format."""
    body = ",".join(f"{k}={geom[k]}" for k in sorted(geom))
    return f"{fam}|{body}"


class TuneCache:
    """Version-stamped persistent map: geometry-class key -> measured
    winner (+ per-route timings and provenance).

    Disk format (JSON, atomically written; the JAX package's)::

        {"version": 1, "device": "NVIDIA H100 80GB HBM3",
         "entries": {"stft|frame_length=512,hop=128,...":
                     {"route": "cuda_fused",
                      "timings_us": {"cuda_fused": 41.0, ...},
                      "source": "measured", "unix": ...}, ...}}

    The cache serves the device kind of ``Config.device``
    (:func:`device_kind`, read at each use).  A corrupt
    file, a version mismatch, or a ``device`` stamp of another kind
    loads as EMPTY (counted in ``load_errors`` / ``version_mismatch`` /
    ``device_mismatch``); a missing stamp (a hand-authored pack) is
    accepted.  A save never overwrites a valid pack of another device
    kind or schema (``save_refused``).
    """

    def __init__(self, path: str | None = None):
        self._lock = threading.Lock()
        # serializes save()'s read-merge-write as a unit, so two stores
        # cannot land their writes in the opposite order
        self._save_lock = threading.Lock()
        self._path = path
        self._entries: dict[str, dict] = {}
        self._loaded = path is None
        self._stats = {"hits": 0, "misses": 0, "stores": 0,
                       "evictions": 0, "load_errors": 0,
                       "version_mismatch": 0, "device_mismatch": 0,
                       "persist_errors": 0, "save_refused": 0,
                       "mesh_mismatch": 0, "mesh_refused": 0}
        self._next_load_retry = 0.0

    @property
    def path(self) -> str | None:
        return self._path

    @property
    def device(self) -> str:
        """The device kind this cache serves and stamps its saves
        with."""
        return device_kind()

    def _read_file(self, path: str) -> "dict | str":
        """Validated entries from ``path``, or the rejection reason
        (``'missing'`` / ``'load_errors'`` / ``'version_mismatch'`` /
        ``'device_mismatch'`` — the stat counter to bump)."""
        try:
            with open(path) as f:
                data = json.load(f)
        except FileNotFoundError:
            return "missing"
        except Exception:  # noqa: BLE001 — a corrupt cache degrades
            return "load_errors"
        if not isinstance(data, dict) or \
                data.get("version") != TUNE_CACHE_VERSION:
            return "version_mismatch"
        stamp = data.get("device")
        if stamp is not None and stamp != self.device:
            return "device_mismatch"
        entries = data.get("entries")
        if not isinstance(entries, dict):
            return "load_errors"
        return {str(key): dict(entry)
                for key, entry in entries.items()
                if isinstance(entry, dict)
                and isinstance(entry.get("route"), str)}

    def _ensure_loaded_locked(self) -> None:
        if self._loaded:
            return
        if time.time() < self._next_load_retry:
            return
        loaded = self._read_file(self._path)
        if loaded == "device_mismatch" and self.device == "unknown":
            # the local device kind cannot be read yet: defer the load
            # (not counted — the terminal read does the counting) and
            # retry on an interval, never per touch
            self._next_load_retry = time.time() + LOAD_RETRY_S
            return
        self._loaded = True
        if isinstance(loaded, dict):
            self._entries.update(loaded)
        elif loaded != "missing":
            self._stats[loaded] += 1

    def lookup(self, fam: str, geom: dict,
               mesh: str | None = None) -> str | None:
        """The cached winner route for a geometry class, or None;
        counts a hit or a miss.  An entry stamped for another ``mesh``
        topology is counted as ``mesh_mismatch`` and served as a miss
        (an unstamped entry is accepted)."""
        key = tune_key_str(fam, geom)
        with self._lock:
            self._ensure_loaded_locked()
            entry = self._entries.get(key)
            if entry is None:
                self._stats["misses"] += 1
                return None
            stamp = entry.get("mesh")
            if mesh is not None and stamp is not None and stamp != mesh:
                self._stats["mesh_mismatch"] += 1
                self._stats["misses"] += 1
                return None
            self._stats["hits"] += 1
            return entry["route"]

    def entry(self, fam: str, geom: dict) -> dict | None:
        """Full cached record (route + timings + provenance), no
        hit/miss accounting."""
        key = tune_key_str(fam, geom)
        with self._lock:
            self._ensure_loaded_locked()
            entry = self._entries.get(key)
            return dict(entry) if entry is not None else None

    def store(self, fam: str, geom: dict, route: str,
              timings_us: dict | None = None,
              source: str = "measured",
              mesh: str | None = None) -> str:
        """Record a winner and write through to disk when a path is
        bound; returns the entry key.  A store that would replace an
        entry stamped for another ``mesh`` is refused and counted
        (``mesh_refused``)."""
        key = tune_key_str(fam, geom)
        entry = {"route": str(route), "source": str(source),
                 "unix": time.time()}
        if mesh is not None:
            entry["mesh"] = str(mesh)
        if timings_us:
            entry["timings_us"] = {str(k): (round(float(v), 1)
                                            if v is not None else None)
                                   for k, v in timings_us.items()}
        with self._lock:
            self._ensure_loaded_locked()
            existing = self._entries.get(key)
            if (existing is not None and mesh is not None
                    and existing.get("mesh") is not None
                    and existing["mesh"] != mesh):
                self._stats["mesh_refused"] += 1
                return key
            self._entries.pop(key, None)
            self._entries[key] = entry       # fresh "unix" = recency
            self._stats["stores"] += 1
            before = len(self._entries)
            _evict_oldest(self._entries)
            self._stats["evictions"] += before - len(self._entries)
        self.save()
        return key

    def save(self, path: str | None = None) -> str | None:
        """Atomically persist to ``path`` (default: the bound path;
        None with no bound path is a no-op).  The disk state is re-read
        and MERGED under this cache's entries first, so two writers
        sharing a path do not drop each other's winners.  A valid pack
        of another device kind or schema version is never overwritten
        (``save_refused``).  Persistence failures are counted, never
        raised."""
        path = path or self._path
        if path is None:
            return None
        with self._save_lock:
            with self._lock:
                self._ensure_loaded_locked()
                on_disk = self._read_file(path)
                if on_disk in ("version_mismatch", "device_mismatch"):
                    self._stats["save_refused"] += 1
                    return None
                merged = on_disk if isinstance(on_disk, dict) else {}
                merged.update(self._entries)
                _evict_oldest(merged)
                payload = {"version": TUNE_CACHE_VERSION,
                           "device": self.device,
                           "entries": merged}
            try:
                return _atomic_write(path,
                                     json.dumps(payload, indent=1,
                                                sort_keys=True))
            except Exception:  # noqa: BLE001
                with self._lock:
                    self._stats["persist_errors"] += 1
                return None

    def entries(self) -> dict:
        with self._lock:
            self._ensure_loaded_locked()
            return {k: dict(v) for k, v in self._entries.items()}

    def info(self) -> dict:
        """obs.caches() provider payload."""
        with self._lock:
            self._ensure_loaded_locked()
            return {"size": len(self._entries),
                    "capacity": TUNE_CACHE_MAX_ENTRIES,
                    "path": self._path, "version": TUNE_CACHE_VERSION,
                    "device": self.device,
                    "mode": autotune_mode(), **self._stats}


_cache_lock = threading.Lock()
_cache_override: str | None = None     # set_cache_path() programmatic
_cache_src: object = None              # (path, kind) of the singleton
_cache_obj: TuneCache | None = None
_NO_PATH = object()


def set_cache_path(path: str | None) -> None:
    """Programmatic tune-cache path override (None restores the
    ``$VELES_SIMD_AUTOTUNE_CACHE`` lookup).  The next
    :func:`tune_cache` call rebuilds the singleton."""
    global _cache_override, _cache_src, _cache_obj
    with _cache_lock:
        _cache_override = path
        _cache_src = _NO_PATH      # force a rebuild on the next lookup
        _cache_obj = None


def tune_cache() -> TuneCache:
    """The process tune cache, rebuilt when the bound path or the
    configured device's kind changes.  A thread-scoped
    :func:`private_tune_cache` takes precedence."""
    global _cache_src, _cache_obj
    private = _tls.cache
    if private is not None:
        return private
    path = _cache_override
    if path is None:
        path = (faults.getenv(AUTOTUNE_CACHE_ENV) or "").strip() or None
    src = (path, device_kind())
    with _cache_lock:
        if _cache_obj is None or src != _cache_src:
            _cache_src = src
            _cache_obj = TuneCache(path)
        return _cache_obj


@contextlib.contextmanager
def private_tune_cache(path: str | None = None):
    """Scoped, THREAD-LOCAL tune cache (default in-memory): inside the
    scope this thread's lookups and stores go to a private
    :class:`TuneCache` instead of the process one, so a measuring run
    neither reads nor writes the pack an operator bound.  Yields the
    private cache."""
    prev = _tls.cache
    cache = TuneCache(path)
    _tls.cache = cache
    try:
        yield cache
    finally:
        _tls.cache = prev


obs.register_cache("autotune_cache", lambda: tune_cache().info())


# ---------------------------------------------------------------------------
# routes and families
# ---------------------------------------------------------------------------

def _is_traced(operand) -> bool:
    """Is the call being captured rather than run — under
    ``torch.compiler.is_compiling()`` or while the current CUDA stream
    captures a graph?  A probe there would time the capture (and its
    synchronise would break it), so the engine refuses to probe."""
    del operand
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    compiler = getattr(torch, "compiler", None)
    if compiler is not None and compiler.is_compiling():
        return True
    return (torch.cuda.is_available() and torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def env_truthy(name: str) -> bool:
    """Is the escape-hatch env var ``name`` set truthy?"""
    return (faults.getenv(name) or "0").strip().lower() in (
        "1", "true", "yes", "on")


# The JAX package's names for the port's kernel routes and opt-out
# switches: code written for the JAX package runs unchanged, as
# :func:`port_plan` does for fault sites.
_JAX_ROUTE_NAMES = {"pallas_fused": "cuda_fused",
                    "direct_pallas": "direct_cuda",
                    "pallas": "cuda"}
_JAX_DISABLE_ENVS = {
    "VELES_SIMD_DISABLE_CUDA_OS": "VELES_SIMD_DISABLE_PALLAS_OS",
    "VELES_SIMD_DISABLE_CUDA2D": "VELES_SIMD_DISABLE_PALLAS2D",
    "VELES_SIMD_DISABLE_CUDA_WAVELET": "VELES_SIMD_DISABLE_PALLAS_WAVELET",
    "VELES_SIMD_DISABLE_STFT_CUDA": "VELES_SIMD_DISABLE_STFT_PALLAS",
}


def _disabled(env: str) -> bool:
    """Is the opt-out ``env`` set truthy, under its own name or the
    JAX package's?"""
    alias = _JAX_DISABLE_ENVS.get(env)
    return env_truthy(env) or (alias is not None and env_truthy(alias))


@dataclasses.dataclass(frozen=True)
class Route:
    """One candidate in a family's table.

    ``predicate(**geom) -> bool`` is the geometry gate (None =
    unconditionally eligible, the table's terminal fallback);
    ``disable_env`` names a truthy env var that closes the gate;
    ``fault_site`` is the injection-plan site whose armed state opens
    it, so the CPU really selects the doomed route;
    ``rejection_cache`` is a ZERO-ARG GETTER returning the bounded
    rejection set the demote-and-remember policy feeds (tests
    substitute plain sets through the owning module's global) and
    ``rejection_key(**geom)`` derives the remembered key;
    ``roofline`` carries the route's roofline tag (``{"kind": ...}``)
    for decision events and bench attribution; ``doc`` is one line for
    humans.
    """

    name: str
    predicate: object = None
    disable_env: str | None = None
    fault_site: str | None = None
    rejection_cache: object = None
    rejection_key: object = None
    roofline: dict | None = None
    doc: str = ""

    def rejected(self, geom: dict) -> bool:
        if self.rejection_cache is None or self.rejection_key is None:
            return False
        try:
            return self.rejection_key(**geom) in self.rejection_cache()
        except Exception:  # noqa: BLE001 — a bad key never blocks
            return False

    def gate(self, geom: dict) -> bool:
        """Env opt-out, then the predicate (no rejection memory, no
        armed plan): the pure geometry gate."""
        if self.disable_env and _disabled(self.disable_env):
            return False
        if self.predicate is None:
            return True
        return bool(self.predicate(**geom))

    def allowed(self, geom: dict) -> bool:
        """Full eligibility: rejection memory outranks everything (a
        demoted geometry skips the route without re-raising), an armed
        fault plan opens the gate, then env + predicate."""
        if self.rejection_cache is not None and self.rejected(geom):
            return False
        if self.fault_site and faults.armed(self.fault_site):
            return True
        return self.gate(geom)


class Family:
    """One op family's candidate table + selection policy; routes in
    PRIORITY order (static selection is the first eligible one).
    ``decision_op`` names its decision events (default
    ``"<name>_route"``)."""

    def __init__(self, name: str, routes, *, decision_op=None):
        self.name = str(name)
        self._routes: dict[str, Route] = {}
        for r in routes:
            if r.name in self._routes:
                raise ValueError(f"duplicate route {r.name!r} in "
                                 f"family {name!r}")
            self._routes[r.name] = r
        if not self._routes:
            raise ValueError(f"family {name!r} has no routes")
        self.decision_op = decision_op or f"{self.name}_route"
        self._last = tuple(self._routes)[-1]
        # the routes after the first unconditional one (the table's
        # terminal fallback): the static prior never reaches them, so
        # only the measured autotuner adds them to a caller's list
        names = tuple(self._routes)
        fallback = next((i for i, r in enumerate(self._routes.values())
                         if r.predicate is None), len(names))
        self._after_fallback = names[fallback + 1:]

    def names(self) -> tuple:
        return tuple(self._routes)

    def route(self, name: str) -> Route:
        """The route ``name`` (the port's name, or the JAX package's
        for the same route)."""
        route = self._routes.get(name) or self._routes.get(
            _JAX_ROUTE_NAMES.get(name, name))
        if route is None:
            raise ValueError(
                f"route must be one of {sorted(self._routes)}, "
                f"got {name!r}")
        return route

    def describe(self) -> dict:
        """JSON-native table summary (tools, docs, tests)."""
        return {"family": self.name,
                "routes": [{"name": r.name,
                            "disable_env": r.disable_env,
                            "fault_site": r.fault_site,
                            "has_rejection_cache":
                                r.rejection_cache is not None,
                            "doc": r.doc}
                           for r in self._routes.values()]}

    def eligible(self, **geom) -> list:
        """Eligible route names in table order, by full eligibility,
        the variants after the terminal fallback included: the list a
        caller narrows before it hands it to :meth:`select` (the
        streaming STFT leaves the kernel out).  Never empty: when
        every route refuses, the last route — the terminal fallback —
        is returned alone."""
        names = [n for n, r in self._routes.items() if r.allowed(geom)]
        return names or [tuple(self._routes)[-1]]

    def static_select(self, **geom) -> str:
        """First eligible route in table order — the cold-start prior
        and the autotune ``off`` behaviour.  Stops at the first route
        that allows the geometry: the gates after it (the
        ``*_bf16_comp`` variants behind the terminal fallback) are not
        evaluated."""
        return self._static(geom)

    def _static(self, geom: dict) -> str:
        for name, r in self._routes.items():
            if r.allowed(geom):
                return name
        return self._last

    def select(self, eligible=None, runners=None, probe_operand=None,
               tune_geom=None, mesh=None, route=None, **geom) -> str:
        """The route a call dispatches: the one query every dispatch
        site asks.

        ``geom`` is the call's exact geometry, which the predicates,
        the rejection keys and the armed-plan check read.  ``route``
        is a caller's forced route (the port's name or the JAX
        package's): it is validated through :meth:`route` — the one
        ``ValueError`` of every entry — and returned, with nothing
        else consulted.  ``eligible`` narrows the candidates to a
        priority-ordered list the caller built from :meth:`eligible`
        (None: the table's own eligibility).  ``runners`` maps route
        name -> zero-arg probe thunk (the call dispatch makes, forced),
        or is a zero-arg FACTORY of that dict, invoked only when the
        engine really probes.  ``probe_operand`` is a representative
        operand: its device picks the device kind (:func:`device_kind`)
        and the probe clock.  ``tune_geom`` is the geometry CLASS that
        keys the tune cache when it must differ from ``geom`` (exact
        dims in ``geom``, bucketed ones here), or a zero-arg factory of
        it, so the bucketing costs nothing while the autotuner is off.
        ``mesh`` is the topology stamp of sharded families.

        With the autotuner on (or ``readonly``), the table's allowed
        routes after its terminal fallback (the ``*_bf16_comp``
        variants) join a caller's ``eligible`` list, so they are
        candidates but never the prior.

        In order: a forced ``route`` -> it; ``off`` -> the static prior
        (:meth:`static_select`, or the head of ``eligible``); fewer
        than two candidates -> the static prior; an armed fault plan on
        any candidate -> the static prior (the plan must dispatch its
        doomed route); an operand on a device of another kind than the
        cache's -> the static prior; a cached winner still eligible ->
        it; a cached winner no longer eligible -> the static prior (the
        entry is kept); ``on`` with runners, outside a capture -> probe,
        persist and return the measured winner; else the static prior.
        """
        if route is not None:
            return self.route(route).name
        mode = autotune_mode()
        if eligible is None:
            if mode == "off":
                return self._static(geom)
            eligible = self.eligible(**geom)
        elif mode != "off":
            eligible = list(eligible) + [
                n for n in self._after_fallback
                if n not in eligible and self._routes[n].allowed(geom)]
        if not eligible:
            eligible = [tuple(self._routes)[-1]]
        static = eligible[0]
        if mode == "off" or len(eligible) < 2:
            return static
        for name in eligible:
            r = self._routes.get(name)
            if r is not None and r.fault_site \
                    and faults.armed(r.fault_site):
                return static
        cache = tune_cache()
        if device_kind(probe_operand) != cache.device:
            obs.count("autotune_device_skip", family=self.name)
            return static
        if tune_geom is None:
            tune_geom = geom
        elif callable(tune_geom):
            tune_geom = tune_geom()
        cached = cache.lookup(self.name, tune_geom, mesh=mesh)
        if cached is not None and cached in eligible:
            obs.count("autotune_cache_hit", family=self.name)
            return cached
        if cached is not None:
            # a winner whose route is not eligible now (demoted, env
            # opt-out) is neither dispatched nor overwritten by a probe
            # of the survivors: the ineligibility may be temporary
            obs.count("autotune_cache_stale", family=self.name)
            return static
        if mode != "on" or runners is None or _is_traced(probe_operand):
            return static
        if callable(runners):
            runners = runners()
        if not runners:
            return static
        return self._measure(eligible, runners, static, geom,
                             tune_geom, mesh=mesh,
                             device=_routed_device(probe_operand),
                             card=faults.on_card(probe_operand))

    def _probe_one(self, probe, thunk, name: str, geom: dict,
                   card: bool = False):
        """``(microseconds or None, transient_exhausted)`` of one
        candidate, by the port's fault classes (module docstring).
        ``card``: the routed operand already lies on a card, so every
        error but a transient one re-raises."""
        attempt = 0
        while True:
            try:
                return probe(thunk, name) * 1e6, False
            except ProbeUnresolved:
                # noise, not a time: the round stores nothing
                obs.count("autotune_probe_unresolved",
                          family=self.name, route=name)
                return None, True
            except Exception as e:  # noqa: BLE001 — classified below
                # a program fault, HBM exhaustion or a build failure
                # must surface, never hide behind the other candidate
                # (faults' own never-classified rule)
                if faults._never_classified(e):
                    raise
                transient = faults.is_transient(e)
                if transient and attempt < faults.fault_retries():
                    obs.count("autotune_probe_retry",
                              family=self.name, route=name)
                    time.sleep(faults.backoff_delay(attempt))
                    attempt += 1
                    continue
                if transient:
                    obs.count("autotune_probe_transient",
                              family=self.name, route=name)
                    return None, True
                obs.count("autotune_probe_error", family=self.name,
                          route=name)
                if card:
                    # the card's own data never gives way to another
                    # route, as in dispatch (faults.on_card): a refused
                    # launch or any other error surfaces, remembered
                    # nowhere
                    raise
                # host data: the candidate is skipped, and a refused
                # launch is remembered, so the route's gate refuses the
                # geometry from now on
                route = self._routes.get(name)
                if (route is not None and faults.is_mosaic_vmem_oom(e)
                        and route.rejection_cache is not None
                        and route.rejection_key is not None):
                    try:
                        route.rejection_cache().add(
                            route.rejection_key(**geom))
                    except Exception:  # noqa: BLE001
                        pass
                return None, False

    def _measure(self, eligible, runners, static: str, geom,
                 tune_geom=None, mesh=None, device=None,
                 card: bool = False) -> str:
        """Probe the eligible candidates, pick the winner, persist."""
        with _probe_lock:
            probe = _PROBE_TIMER
        timings_us: dict[str, float | None] = {}
        inconclusive = False
        prev = _tls.probe_device
        _tls.probe_device = device
        try:
            for name in eligible:
                thunk = runners.get(name)
                if thunk is None:
                    continue
                timings_us[name], inconclusive = self._probe_one(
                    probe, thunk, name, geom, card)
                if inconclusive:
                    # every result is discarded below: stop burning
                    # device time on an already-flaky device
                    break
        finally:
            _tls.probe_device = prev
        measured = {n: t for n, t in timings_us.items()
                    if t is not None}
        if not measured:
            return static
        if inconclusive:
            # nothing stored: the next encounter re-probes
            obs.count("autotune_inconclusive", family=self.name)
            return static
        winner = min(measured, key=measured.get)
        key = tune_cache().store(
            self.name, geom if tune_geom is None else tune_geom,
            winner, timings_us=timings_us, source="measured",
            mesh=mesh)
        obs.count("autotune_measured", family=self.name)
        obs.record_decision(
            "autotune", winner, family=self.name, key=key,
            static=static,
            timings=",".join(
                f"{n}={timings_us[n]:.1f}us"
                if timings_us[n] is not None else f"{n}=failed"
                for n in timings_us),
            probes=len(measured))
        return winner


_families_lock = threading.Lock()
_FAMILIES: dict[str, Family] = {}


def family(name: str, routes, *, decision_op=None) -> Family:
    """Declare (and register) one op family's candidate-route table.
    Re-declaring a name replaces the registration."""
    fam = Family(name, routes, decision_op=decision_op)
    with _families_lock:
        _FAMILIES[fam.name] = fam
    return fam


def families() -> dict:
    """Name -> :class:`Family` snapshot of every registered table."""
    with _families_lock:
        return dict(_FAMILIES)


def get_family(name: str) -> Family:
    with _families_lock:
        try:
            return _FAMILIES[name]
        except KeyError:
            raise ValueError(
                f"unknown route family {name!r} "
                f"(registered: {sorted(_FAMILIES)})") from None
