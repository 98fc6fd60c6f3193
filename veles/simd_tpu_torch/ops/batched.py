"""Batched-throughput layer: many short signals, one dispatch.

The port of ``veles.simd_tpu.ops.batched``.  The throughput form of a
short-signal workload is the batched one: stack the signals on a
leading axis and run one route call for the whole ``(batch, length)``
geometry.  The JAX package compiles one executable per geometry and
keeps it in an explicit LRU; PyTorch runs eagerly and has no
executable to cache, so here the handle is the route closure, built
once per geometry.  The key, the hit/miss/eviction stats, the
``batched_handle_cache`` counter and the per-build ``batched``
decision event are the JAX package's, so a shape-churning caller shows
up the same way in ``obs``.

All four entries are ported: :func:`batched_resample_poly`,
:func:`batched_sosfilt`, :func:`batched_lfilter` and
:func:`batched_stft`, each on the same core as its single-signal op.
The first three accept the JAX package's ``donate=`` and, as the JAX
package does off the TPU, donate nothing (their keys carry the JAX
package's empty donation): PyTorch frees an input when its last
reference goes.

Usage::

    from veles.simd_tpu_torch.ops import batched

    ys = batched.batched_resample_poly(xs, 160, 147)   # xs: [B, n]
    ys = batched.batched_sosfilt(sos, xs)              # one dispatch
    ys = batched.batched_lfilter(b, a, xs)
    spec = batched.batched_stft(xs, 512, 128)

The ``simd=`` flag works as everywhere else (falsy runs the NumPy
oracle twin, batched trivially).
"""

from __future__ import annotations

import collections
import functools
import math
import threading

import numpy as np
import torch

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.utils import benchmark as bm
from veles.simd_tpu_torch.utils.config import resolve_simd
from veles.simd_tpu_torch.utils.platform import as_f32

__all__ = [
    "BatchedHandle", "batched_resample_poly", "batched_sosfilt",
    "batched_lfilter", "batched_stft", "handle_cache_info",
    "clear_handle_cache", "BATCHED_CACHE_MAXSIZE",
]

# live handle bound: 64 distinct (op, batch, length, params)
# geometries cover a service's steady state while keeping eviction
# observable in tests
BATCHED_CACHE_MAXSIZE = 64

_cache: "collections.OrderedDict[tuple, BatchedHandle]" = \
    collections.OrderedDict()
_cache_lock = threading.Lock()
# per-key construction locks: concurrent misses on the SAME key build
# once; entries are dropped once the build finishes
_build_locks: dict = {}
_cache_stats = {"hits": 0, "misses": 0, "evictions": 0}
obs.register_cache("batched_handle_lru",
                   lambda: handle_cache_info())


class BatchedHandle:
    """One route closure pinned to a batched-op geometry.

    ``key`` is the full cache key (op name + batch rows + length +
    op-static parameters); ``fn`` the callable.  Handles are created by
    :func:`_get_handle` and shared — treat as immutable.
    """

    __slots__ = ("key", "fn")

    def __init__(self, key, fn):
        self.key = key
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)

    def __repr__(self):  # pragma: no cover - debugging nicety
        return f"BatchedHandle{self.key!r}"


def _get_handle(key, builder) -> BatchedHandle:
    """LRU lookup of the handle for ``key``; ``builder()`` makes the
    callable on a miss.  Hits/misses/evictions are counted under
    ``batched_handle_cache`` and a decision event is recorded per
    build.

    Construction is race-free: concurrent callers of the same key
    serialize on a per-key build lock (builds of DIFFERENT keys still
    overlap — the global map lock is never held across ``builder()``),
    exactly one thread builds, and the others return its handle as a
    hit.
    """
    with _cache_lock:
        handle = _cache.get(key)
        if handle is not None:
            _cache.move_to_end(key)
            _cache_stats["hits"] += 1
            obs.count("batched_handle_cache", op=key[0], event="hit")
            return handle
        build_lock = _build_locks.setdefault(key, threading.Lock())
    with build_lock:
        with _cache_lock:
            handle = _cache.get(key)
            if handle is not None:
                # another caller finished the build while we waited
                _cache.move_to_end(key)
                _cache_stats["hits"] += 1
                obs.count("batched_handle_cache", op=key[0],
                          event="hit")
                return handle
            _cache_stats["misses"] += 1
        try:
            fn = builder()
        except BaseException:
            # a failed build must not leave the key locked: the next
            # caller gets a fresh try
            with _cache_lock:
                _build_locks.pop(key, None)
            raise
        handle = BatchedHandle(key, fn)
        obs.count("batched_handle_cache", op=key[0], event="miss")
        obs.record_decision("batched", key[0], key=repr(key[1:]))
        with _cache_lock:
            _cache[key] = handle
            # drop the build-lock entry atomically with the insert, so
            # no fresh caller mints a new lock and builds again
            _build_locks.pop(key, None)
            while len(_cache) > BATCHED_CACHE_MAXSIZE:
                _cache.popitem(last=False)
                _cache_stats["evictions"] += 1
                obs.count("batched_handle_cache", op=key[0],
                          event="eviction")
    return handle


def handle_cache_info() -> dict:
    """Snapshot of the handle cache: size, capacity, hits/misses/
    evictions, and the resident keys oldest-first."""
    with _cache_lock:
        return {"size": len(_cache), "maxsize": BATCHED_CACHE_MAXSIZE,
                **_cache_stats, "keys": list(_cache)}


def clear_handle_cache() -> None:
    """Drop every cached handle and zero the stats."""
    with _cache_lock:
        _cache.clear()
        _build_locks.clear()
        for k in _cache_stats:
            _cache_stats[k] = 0


def _as_batch2d(x):
    """Validate a leading-batch-dim signal array; returns
    ``(batch_shape, n)``."""
    shape = tuple(np.shape(x))
    if len(shape) < 2:
        raise ValueError(
            f"batched ops take [..., batch, n] signals, got shape "
            f"{shape} — use the single-signal op for 1D input")
    n = shape[-1]
    if n == 0:
        raise ValueError("empty signal")
    if 0 in shape[:-1]:
        # a zero-row batch must fail loudly here, not deep in a route
        raise ValueError(
            f"empty batch (B=0): batched ops need at least one "
            f"signal, got shape {shape}")
    return shape[:-1], n


# donation never applies on this backend: the JAX package's
# ``_donate_argnums`` off the TPU, and the last field of its keys
_NO_DONATION = ()


# ---------------------------------------------------------------------------
# resample
# ---------------------------------------------------------------------------


def batched_resample_poly(x, up: int, down: int, taps=None, simd=None,
                          donate: bool = False):
    """Rational-rate resampling of a BATCH of equal-length signals in
    one dispatch: ``x[..., batch, n] -> [..., batch, ceil(n*up/down)]``.

    Same numerics and conventions as
    :func:`~veles.simd_tpu_torch.ops.resample.resample_poly` (the handle
    wraps the same polyphase core); the taps stay an operand, so
    switching filters builds no new handle — only a new ``(batch, n,
    up, down, len(taps))`` geometry does.  ``donate`` is accepted for
    the JAX package's signature and donates nothing (module note).
    """
    from veles.simd_tpu_torch.ops import resample as rs

    batch_shape, n = _as_batch2d(x)
    up, down, taps = rs._normalize_resample_args(n, up, down, taps)
    if not resolve_simd(simd, op="batched_resample_poly"):
        return rs.resample_poly_na(x, up, down, taps).astype(np.float32)
    if up == 1 and down == 1:
        return as_f32(x)
    out_len = rs.resample_length(n, up, down)
    rows = math.prod(batch_shape)
    key = ("resample_poly", rows, n, up, down, len(taps), _NO_DONATION)

    def build():
        # one instrumented handle a geometry, as the JAX package
        # compiles one: the ("batched_resample_poly", "batched") row;
        # the core it calls records nothing inside it
        def run(xb, taps_b):
            return rs._resample_conv(xb, taps_b, up, down, out_len)

        return obs.instrumented_jit(
            run, op="batched_resample_poly", route="batched",
            work=lambda xb, taps_b: rs._resample_conv_work(
                xb, taps_b, up, down, out_len))

    with obs.span("batched.resample_poly.dispatch"):
        handle = _get_handle(key, build)
        out = handle(as_f32(x).reshape(rows, n), taps)
    return out.reshape(tuple(batch_shape) + (out_len,))


# ---------------------------------------------------------------------------
# IIR cascades / transfer functions
# ---------------------------------------------------------------------------


def batched_sosfilt(sos, x, simd=None, donate: bool = False):
    """Second-order-section cascade over a BATCH of equal-length
    signals in one dispatch: ``x[..., batch, n] -> same shape``.

    Same doubling-scan numerics as
    :func:`~veles.simd_tpu_torch.ops.iir.sosfilt` (zero initial state —
    the streaming/zi form stays on the single-signal API).  The section
    coefficients parameterize the scan's transition powers, so the
    handle key includes them: one handle per (filter, batch, length).
    ``donate`` is accepted and donates nothing (module note).
    """
    from veles.simd_tpu_torch.ops import iir

    sos = iir._check_sos(sos)
    batch_shape, n = _as_batch2d(x)
    if not resolve_simd(simd, op="batched_sosfilt"):
        return iir.sosfilt_na(sos, x).astype(np.float32)
    sos_key = tuple(tuple(float(v) for v in row) for row in sos)
    rows = math.prod(batch_shape)
    key = ("sosfilt", rows, n, sos_key, _NO_DONATION)

    def build():
        sos_rows = np.asarray(sos_key, np.float64)

        def run(xb):
            return iir._sos_scan(xb, sos_rows)

        return obs.instrumented_jit(
            run, op="batched_sosfilt", route="batched",
            work=lambda xb: iir._sos_work(xb, sos_rows))

    with obs.span("batched.sosfilt.dispatch"):
        handle = _get_handle(key, build)
        out = handle(as_f32(x).reshape(rows, n))
    return out.reshape(tuple(batch_shape) + (n,))


def batched_lfilter(b, a, x, simd=None, donate: bool = False):
    """Direct-form transfer-function filter over a BATCH of
    equal-length signals in one dispatch (the batched form of
    :func:`~veles.simd_tpu_torch.ops.iir.lfilter`, same companion-matrix
    scan and order bound).  Coefficients key the handle, like
    :func:`batched_sosfilt`; ``donate`` is accepted and donates nothing
    (module note).
    """
    from veles.simd_tpu_torch.ops import iir

    b, a = iir._normalize_ba(b, a)
    p = len(a) - 1
    if p > iir._LFILTER_MAX_ORDER:
        raise ValueError(
            f"denominator order {p} > {iir._LFILTER_MAX_ORDER}: use "
            "batched_sosfilt (cascaded second-order sections) for "
            "high-order filters")
    batch_shape, n = _as_batch2d(x)
    if not resolve_simd(simd, op="batched_lfilter"):
        return iir.lfilter_na(b, a, x).astype(np.float32)
    if p == 0:
        a = np.concatenate([a, [0.0]])  # the JAX package's FIR key
    b_key = tuple(float(v) for v in b)
    a_key = tuple(float(v) for v in a)
    rows = math.prod(batch_shape)
    key = ("lfilter", rows, n, b_key, a_key, _NO_DONATION)

    def build():
        b_arr, a_arr = np.asarray(b_key), np.asarray(a_key)

        def run(xb):
            return iir._lfilter_torch(xb, b_arr, a_arr)

        return obs.instrumented_jit(
            run, op="batched_lfilter", route="batched",
            work=lambda xb: iir._lfilter_xla.work(xb, b_arr, a_arr))

    with obs.span("batched.lfilter.dispatch"):
        handle = _get_handle(key, build)
        out = handle(as_f32(x).reshape(rows, n))
    return out.reshape(tuple(batch_shape) + (n,))


# ---------------------------------------------------------------------------
# spectral
# ---------------------------------------------------------------------------


def batched_stft(x, frame_length: int, hop: int, window=None,
                 simd=None):
    """STFT of a BATCH of equal-length signals in one dispatch:
    ``x[..., batch, n] -> complex64 [..., batch, frames, bins]``.

    Same numerics and route family as
    :func:`~veles.simd_tpu_torch.ops.spectral.stft`: the route comes
    from the ``stft`` table under ``stft``'s tune class (the same
    selection ``stft`` makes, so a tune-cache winner steers both; this
    path consults the pack but never probes), and the ``rdft_matmul``
    (or its ``bf16_comp`` variant) / ``xla_fft`` routes run through
    the handle LRU keyed ``(rows, n, frame_length, hop, route)`` — the
    basis and the window are runtime operands, so switching windows
    builds nothing new, only a new geometry does.  A ``cuda_fused``
    selection delegates to ``spectral.stft``: the fused kernel is
    already one launch per batch.
    """
    from veles.simd_tpu_torch.ops import spectral as sp

    frame_length, hop = int(frame_length), int(hop)
    batch_shape, n = _as_batch2d(x)
    sp._check_stft_args(n, frame_length, hop)
    window = sp._resolve_window(window, frame_length)
    if not resolve_simd(simd, op="batched_stft"):
        return sp.stft_na(x, frame_length, hop,
                          window).astype(np.complex64)
    rows = math.prod(batch_shape)
    frames = sp.frame_count(n, frame_length, hop)
    route = sp._STFT_FAMILY.select(
        frame_length=frame_length, hop=hop, frames=frames,
        cuda=sp._operand_on_cuda(x), probe_operand=x,
        tune_geom=lambda: sp._stft_tune_class(frame_length, hop, frames,
                                              rows))
    if route == "cuda_fused":
        # the caller's operand, as the JAX package passes it: host data
        # keeps stft's oracle fallback
        return sp.stft(x, frame_length, hop, window=window, simd=True)
    xt = as_f32(x)
    bins = frame_length // 2 + 1
    key = ("stft", rows, n, frame_length, hop, route)

    # a pack winner may be the bf16_comp variant: the same basis
    # matmul at the compensated precision
    rdft = {"rdft_matmul": "highest",
            "rdft_matmul_bf16_comp": "bf16_comp"}.get(route)

    def build():
        # one instrumented handle a class, as the JAX package compiles
        # one: the ("batched_stft", route) row of obs.resources(); the
        # spectral core it calls records nothing inside it
        core = sp._stft_xla if rdft is None else sp._STFT_RDFT_CORES[rdft]
        return obs.instrumented_jit(
            functools.partial(core, frame_length=frame_length, hop=hop),
            op="batched_stft", route=route,
            work=lambda xb, operand: bm.stft_work(
                rows, n, frame_length, hop))

    with obs.span("batched.stft.dispatch"):
        handle = _get_handle(key, build)
        operand = (sp._device_basis(
            "rdft_fwd", frame_length, window,
            lambda: sp._rdft_basis(frame_length, window), xt.device)
            if rdft is not None
            else sp._device_window(window, xt.device))
        out = handle(xt.reshape(rows, n), operand)
    return out.reshape(tuple(batch_shape) + (frames, bins))
