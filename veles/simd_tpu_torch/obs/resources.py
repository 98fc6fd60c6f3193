"""The *resource axis* of obs: what each instrumented call costs.

The port of ``veles.simd_tpu.obs.resources``.  Two pieces:

* :func:`instrumented_jit` — the JAX package's compile helper, kept
  under its name so that code written for the JAX package runs.  The
  port compiles nothing at call time (its kernels are built once, by
  ``nvcc``, and everything else is eager PyTorch), so the wrapper runs
  the wrapped callable as it is.  While telemetry is enabled, the first
  call per argument geometry also records one entry in the resource
  registry, keyed by ``(op, route)``:

  - FLOPs and bytes from the optional ``work=`` callable of the same
    arguments (the port's analytical counterpart of XLA's
    ``cost_analysis()``: the kernel wrappers of ``ops/cuda_kernels.py``
    pass ``utils.benchmark``'s ``conv_work`` and its kin);
  - the argument and output bytes of the call's tensors;
  - on the card, the peak: how far above its starting allocation the
    call took ``torch.cuda.max_memory_allocated``.  The process's peak
    counter is never reset (a caller may be tracking it), so the peak
    is known only when the call raised it, and is None otherwise;
  - arithmetic intensity and the attainable share of the H100's fp32
    roofline at that intensity (:func:`utils.benchmark.fp32_bound`).

  A call made inside another instrumented call, or inside a shard body
  of ``parallel._spmd``, records nothing — the counterpart of JAX's
  rule that a tracer skips the harvest (:mod:`..utils.trace`) — so the
  stages of a fused pipeline step never appear as entries of their own.
  With telemetry off a call costs one flag check.

* a **cache-introspection registry** — every memoized cache of the
  port (the device constant LRUs, the rejection sets, the pipeline
  graphs, this module's own analysis memo, ...) registers a snapshot
  provider under a name, and :func:`caches_snapshot` returns one
  ``{name: {size, capacity, hits, misses, evictions}}`` view.

Missing pieces record as ``None``, as in the JAX package: a CPU call
has no device peak, nor a card call that stayed under the process's
earlier peak, and a wrapper without ``work=`` no FLOPs.  No number
here is measured on or for a TPU.

NB: the facade function ``obs.resources()`` shadows this module as a
package attribute; reach the module itself through
``sys.modules["veles.simd_tpu_torch.obs.resources"]``.
"""

from __future__ import annotations

import functools
import itertools
import threading

from veles.simd_tpu_torch.obs.lru import LRUSet
from veles.simd_tpu_torch.utils.trace import TRACE_DEPTH

__all__ = [
    "InstrumentedJit", "instrumented_jit", "ResourceRegistry",
    "RESOURCES", "record_resources", "resources_snapshot",
    "register_cache", "caches_snapshot", "set_active", "active",
    "jsonify", "ANALYSIS_MEMO_MAXSIZE",
]

# toggled by obs.enable()/disable() (and the VELES_SIMD_TELEMETRY env
# default) so the disabled wrapper path is one module-global check
_ACTIVE = False

# geometries already recorded, keyed (wrapper token, signature).
# Bounded: an evicted geometry records once more if it returns.
ANALYSIS_MEMO_MAXSIZE = 1024


def set_active(on: bool) -> None:
    """Arm/disarm resource capture (wired to obs.enable/disable)."""
    global _ACTIVE
    _ACTIVE = bool(on)


def active() -> bool:
    return _ACTIVE


def jsonify(value):
    """Deep-convert ``value`` to JSON-native structures (tuples become
    lists, dict keys become strings, exotic leaves become ``repr``) so
    snapshots survive a JSON round trip *equal*, not merely similar."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): jsonify(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        seq = sorted(value, key=repr) if isinstance(
            value, (set, frozenset)) else value
        return [jsonify(v) for v in seq]
    return repr(value)


_ANALYZED = LRUSet(ANALYSIS_MEMO_MAXSIZE)

# monotonic wrapper ids keying the memo: two wrappers sharing (op,
# route) run different callables and must not collide
_INSTANCE_SEQ = itertools.count()


class ResourceRegistry:
    """Latest per-call analytics per ``(op, route)``: an entry is
    replaced wholesale on each record (the *latest* geometry's numbers)
    while ``analyses`` accumulates."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[tuple, dict] = {}

    def record(self, op: str, route: str, entry: dict) -> None:
        key = (str(op), str(route))
        with self._lock:
            prev = self._entries.get(key)
            entry["analyses"] = (prev["analyses"] + 1) if prev else 1
            self._entries[key] = entry

    def snapshot(self) -> list:
        """JSON-native list of entries sorted by (op, route)."""
        with self._lock:
            return [dict(e, op=op, route=route)
                    for (op, route), e in sorted(self._entries.items())]

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()

    def __repr__(self):
        return "ResourceRegistry()"


RESOURCES = ResourceRegistry()


def _roofline_attainable_pct(flops, bytes_accessed):
    """The % of the H100's fp32 peak attainable at this call's
    arithmetic intensity, ``min(peak, AI * BW) / peak``, from the
    port's own constants (:func:`veles.simd_tpu_torch.utils.benchmark.
    fp32_bound`); None when a count is missing or degenerate."""
    if not flops or not bytes_accessed:
        return None
    try:
        from veles.simd_tpu_torch.utils.benchmark import fp32_bound

        t_ops = fp32_bound(flops, 0.0)[0]
        t_all = fp32_bound(flops, bytes_accessed)[0]
    except Exception:  # noqa: BLE001 — analytics must never raise
        return None
    return 100.0 * t_ops / t_all


def record_resources(op: str, route: str, shapes: str, cost,
                     mem) -> None:
    """Fold one record into :data:`RESOURCES`.

    ``cost`` is a dict with ``flops``, ``bytes accessed`` and
    ``transcendentals`` (the JAX ``cost_analysis()`` keys) or None;
    ``mem`` a dict of ``argument_bytes``, ``output_bytes``,
    ``temp_bytes``, ``alias_bytes``, ``generated_code_bytes`` and
    ``peak_bytes`` or None.  Missing pieces record as None."""
    flops = bytes_accessed = None
    if cost:
        flops = cost.get("flops")
        bytes_accessed = cost.get("bytes accessed")
    mem = mem or {}
    RESOURCES.record(op, route, {
        "shapes": shapes,
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "arith_intensity": (flops / bytes_accessed
                            if flops and bytes_accessed else None),
        "attainable_pct_of_roofline": _roofline_attainable_pct(
            flops, bytes_accessed),
        "transcendentals": cost.get("transcendentals") if cost else None,
        "argument_bytes": mem.get("argument_bytes"),
        "output_bytes": mem.get("output_bytes"),
        "temp_bytes": mem.get("temp_bytes"),
        "alias_bytes": mem.get("alias_bytes"),
        "generated_code_bytes": mem.get("generated_code_bytes"),
        "peak_bytes": mem.get("peak_bytes"),
    })


def resources_snapshot() -> list:
    return RESOURCES.snapshot()


def reset() -> None:
    """Clear the recorded analytics and the analysis memo (obs.reset)."""
    RESOURCES.reset()
    _ANALYZED.reset()


# ---------------------------------------------------------------------------
# cache introspection
# ---------------------------------------------------------------------------

_cache_lock = threading.Lock()
_cache_providers: dict[str, object] = {}


def register_cache(name: str, provider) -> None:
    """Register (or replace) a cache snapshot provider: a zero-arg
    callable returning ``{size, capacity, hits, misses, evictions}``
    (extra keys ride along), so ``obs.caches()`` is the one place to
    see every memoized cache of the library."""
    with _cache_lock:
        _cache_providers[str(name)] = provider


def caches_snapshot() -> dict:
    """``{name: stats}`` for every registered cache, JSON-native.  A
    provider that raises reports its error instead of failing the
    snapshot; a ``maxsize`` key also shows as ``capacity``."""
    with _cache_lock:
        providers = dict(_cache_providers)
    out = {}
    for name, provider in sorted(providers.items()):
        try:
            stats = dict(provider())
        except Exception as e:  # noqa: BLE001
            stats = {"error": repr(e)}
        if "capacity" not in stats and "maxsize" in stats:
            stats["capacity"] = stats["maxsize"]
        out[name] = jsonify(stats)
    return out


register_cache("obs_analysis_memo", _ANALYZED.info)


# ---------------------------------------------------------------------------
# the instrumented call
# ---------------------------------------------------------------------------

def _leaves(tree, out):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            _leaves(t, out)
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            _leaves(tree[k], out)
    else:
        out.append(tree)
    return out


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _signature(args, kwargs):
    """Hashable geometry of a call: tensors and arrays by shape, dtype
    and device type, other leaves by value (the port builds nothing per
    value, so a scalar is geometry like a shape), None when a leaf is
    unhashable."""
    descr = []
    for leaf in _leaves((args, dict(kwargs)), []):
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is not None and dtype is not None:
            dev = getattr(leaf, "device", None)
            descr.append(("a", tuple(shape), _dtype_name(dtype),
                          getattr(dev, "type", "cpu")))
            continue
        try:
            hash(leaf)
        except TypeError:
            return None
        descr.append(("s", leaf))
    return tuple(descr)


def _shapes_str(key) -> str:
    """Compact human form of a signature for snapshots."""
    parts = []
    for d in key:
        if d[0] == "a":
            parts.append("%s[%s]" % (d[2], ",".join(str(s) for s in d[1])))
        else:
            parts.append(repr(d[1]))
    return " ".join(parts)


def _tensor_bytes(tree) -> int:
    return sum(int(t.nbytes) for t in _leaves(tree, [])
               if hasattr(t, "nbytes") and hasattr(t, "shape"))


def _card_device(args, kwargs):
    """The CUDA device of the call's first card tensor, or None."""
    for leaf in _leaves((args, dict(kwargs)), []):
        dev = getattr(leaf, "device", None)
        if getattr(dev, "type", None) == "cuda":
            return dev
    return None


class InstrumentedJit:
    """A callable plus first-call-per-geometry resource records.

    Transparent to execution: every call runs the wrapped callable with
    the same arguments.  ``op`` and ``route`` key the record; ``work``
    (optional) maps the call's arguments to ``(flops, bytes)``.
    """

    __slots__ = ("fn", "op", "route", "work", "_token", "__dict__")

    def __init__(self, fn, op=None, route=None, work=None,
                 artifact_key=None, **jit_kwargs):
        # artifact_key and the jit keywords (static_argnames,
        # donate_argnums, ...) are the JAX signature's: accepted so
        # that code written for it runs, and unused (nothing compiles)
        del artifact_key, jit_kwargs
        self.fn = fn
        self.op = str(op) if op is not None else getattr(
            fn, "__name__", "anonymous").lstrip("_")
        self.route = str(route) if route is not None else "default"
        self.work = work
        self._token = next(_INSTANCE_SEQ)
        try:
            functools.update_wrapper(self, fn)
        except Exception:  # noqa: BLE001 — builtins without __name__
            pass

    def __call__(self, *args, **kwargs):
        if not _ACTIVE:
            return self.fn(*args, **kwargs)
        if TRACE_DEPTH.get():
            return self.fn(*args, **kwargs)
        token = TRACE_DEPTH.set(1)
        try:
            key = _signature(args, kwargs)
            if key is None or _ANALYZED.check_and_add((self._token, key)):
                return self.fn(*args, **kwargs)
            return self._recorded_call(key, args, kwargs)
        finally:
            TRACE_DEPTH.reset(token)

    def _recorded_call(self, key, args, kwargs):
        """The first call of a geometry: run it, and record its work,
        its tensors' bytes and, on the card, its peak where it raised
        the process's."""
        dev = _card_device(args, kwargs)
        if dev is not None:
            import torch

            base = torch.cuda.memory_allocated(dev)
            high = torch.cuda.max_memory_allocated(dev)
        out = self.fn(*args, **kwargs)
        try:
            peak = None
            if dev is not None:
                # the process's high-water mark, never reset: it tells
                # this call's peak only where the call raised it
                after = torch.cuda.max_memory_allocated(dev)
                if after > high:
                    peak = after - base
            cost = None
            if self.work is not None:
                flops, nbytes = self.work(*args, **kwargs)
                cost = {"flops": float(flops),
                        "bytes accessed": float(nbytes)}
            record_resources(self.op, self.route, _shapes_str(key), cost, {
                "argument_bytes": _tensor_bytes((args, dict(kwargs))),
                "output_bytes": _tensor_bytes(out), "peak_bytes": peak})
        except Exception:  # noqa: BLE001 — analytics never break a call
            record_resources(self.op, self.route, _shapes_str(key), None,
                             None)
        return out

    def __repr__(self):
        return (f"InstrumentedJit({self.op!r}, route={self.route!r}, "
                f"fn={getattr(self.fn, '__name__', self.fn)!r})")


def instrumented_jit(fn=None, *, op=None, route=None, work=None,
                     artifact_key=None, **jit_kwargs):
    """The JAX package's compile site, kept as the port's instrumented
    call: usable as a bare decorator, a decorator factory or a direct
    call, with ``op=``/``route=`` labels that key the resource registry
    (defaults: the callable's name, route ``"default"``) and ``work=``,
    a callable of the same arguments returning ``(flops, bytes)``.  The
    JAX keywords (``artifact_key``, ``static_argnames``, ...) are
    accepted and unused: an eager torch callable compiles no program
    per geometry, so there is nothing for the artifact store to load
    before a call or export after it (``runtime.artifacts.
    export_and_store`` answers ``unsupported``); the port's one
    compiled program, the kernel library, is packed and preloaded
    whole."""
    if fn is None:
        def deco(f):
            return InstrumentedJit(f, op=op, route=route, work=work,
                                   artifact_key=artifact_key,
                                   **jit_kwargs)
        return deco
    return InstrumentedJit(fn, op=op, route=route, work=work,
                           artifact_key=artifact_key, **jit_kwargs)
