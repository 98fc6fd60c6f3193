"""1D decimated (DWT) and stationary (SWT) wavelet filter banks, their
synthesis, and the separable 2D and wavelet-packet transforms.

The port of ``veles.simd_tpu.ops.wavelet`` (rebuild of the reference
library's ``src/wavelet.c`` and ``inc/simd/wavelet.h``), computed with
PyTorch on ``Config.device``.  The semantics are the JAX package's,
function for function:

* the QMF highpass from the lowpass table (``src/wavelet.c:187-209``);
* the DWT (``src/wavelet.c:271-324``): extend the signal on the right
  by ``order`` samples, then a 2-channel cross-correlation at stride 2,
  output length ``length/2``;
* the SWT at level ℓ (``src/wavelet.c:326-382``): the same with the
  taps dilated by 2^(ℓ-1), extension ``order·2^(ℓ-1)``, no decimation;
* the four boundary extensions periodic, mirror, constant and zero
  (``src/wavelet.c:248-269``); mirror repeats the last sample first.

Routes, JAX name → port name where they differ:

* ``wavelet`` (DWT and SWT steps): ``pallas`` → ``cuda``, the
  filter-bank kernel (``csrc/filter_bank.cu``) with two channels, at
  stride 2 or with dilation, for batched signals whose block fits the
  kernel's shared memory; ``xla_conv`` → ``conv1d`` with two output
  channels, cuDNN pinned to fp32.  ``VELES_SIMD_DISABLE_CUDA_WAVELET``
  closes the kernel route; under ``VELES_SIMD_AUTOTUNE`` the measured
  autotuner picks between the two per geometry class.
* ``wavelet.cascade`` (:func:`wavelet_transform`): ``fused_cascade``,
  the whole PERIODIC cascade in one launch of the cascade-bank kernel
  (``csrc/cascade_bank.cu``), which reads the signal's wrap and writes
  every level in natural order, so nothing is copied: the default
  wherever its shape gate admits the call (gate note at
  :func:`_fused_cascade_gate`), closed by
  ``VELES_SIMD_DISABLE_CUDA_WAVELET`` with the kernel route above; the
  JAX package keeps it opt-in (its ``VELES_SIMD_FORCE_FUSED_CASCADE``,
  which the port does not read); ``level_loop``, one ``wavelet`` step
  per level, everywhere else.

Spans and counts (``obs``, recorded while telemetry is on or a
capture is armed): ``wavelet_transform.dispatch`` over a transform's
run, either route (attribute ``route``), ``routing.select`` (family
``wavelet``) around each level's route choice and
``wavelet_apply.dispatch`` around each level's run;
``wavelet_extend_bytes`` counts the bytes of every boundary extension
made on the device (in a capture, on the level's
``wavelet_apply.dispatch``).

Synthesis is the transposed convolution (``conv_transpose1d``, cuDNN
pinned to fp32) with the periodic fold; the non-periodic inverses add
the JAX package's Woodbury boundary correction, precomputed in float64
NumPy and applied to the boundary samples only, in float64 on the
device.

Normalization note (as in the JAX package): the Daubechies table sums
to √2, the Symlet and Coiflet tables to 1, so those transforms scale
output energy by 1/2 per level; this is kept for parity.

All entry points accept leading batch dimensions.  Results are float32
tensors on the device; ``simd=False`` runs the NumPy oracle twins and
returns NumPy.
"""

from __future__ import annotations

import enum
import functools

import numpy as np
import torch
import torch.nn.functional as F

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.ops import cuda_kernels as _ck
from veles.simd_tpu_torch.ops.wavelet_coeffs import (
    WaveletType, qmf_highpass, scaling_coefficients, supported_orders,
    validate_order)
from veles.simd_tpu_torch.runtime import precision as prx
from veles.simd_tpu_torch.runtime import routing
from veles.simd_tpu_torch.utils import benchmark as _bm
from veles.simd_tpu_torch.utils.config import resolve_simd
from veles.simd_tpu_torch.utils.platform import as_f32, lead_rows

__all__ = [
    "WaveletType", "ExtensionType",
    "wavelet_apply", "wavelet_apply_na",
    "stationary_wavelet_apply", "stationary_wavelet_apply_na",
    "wavelet_transform", "stationary_wavelet_transform",
    "wavelet_packet_transform", "wavelet_packet_inverse_transform",
    "wavelet_packet_transform2d", "wavelet_packet_inverse_transform2d",
    "wavelet_reconstruct", "wavelet_reconstruct_na",
    "stationary_wavelet_reconstruct", "stationary_wavelet_reconstruct_na",
    "wavelet_inverse_transform", "stationary_wavelet_inverse_transform",
    "wavelet_apply2d", "wavelet_reconstruct2d",
    "stationary_wavelet_apply2d", "stationary_wavelet_reconstruct2d",
    "wavelet_transform2d", "wavelet_inverse_transform2d",
    "wavelet_prepare_array", "wavelet_allocate_destination",
    "wavelet_recycle_source", "wavelet_validate_order",
    "supported_orders", "ROUTE_NAMES",
]

# JAX package route name -> the port's name for the same route
ROUTE_NAMES = {"pallas": "cuda"}


class ExtensionType(enum.Enum):
    """``ExtensionType`` (``inc/simd/wavelet_types.h:44-53``)."""

    PERIODIC = "periodic"
    MIRROR = "mirror"
    CONSTANT = "constant"
    ZERO = "zero"


def _filters(type, order):
    lo = scaling_coefficients(type, order).astype(np.float32)
    hi = qmf_highpass(lo)
    return hi, lo


@functools.lru_cache(maxsize=64)
def _filter_tensor(type, order, device):
    """The ``[2, order]`` (hi, lo) taps on ``device``, copied there
    once per (type, order, device)."""
    return torch.as_tensor(np.stack(_filters(type, order)), device=device)


def _check_apply_args(type, order, length):
    if not validate_order(type, order):
        raise ValueError(
            f"unsupported {WaveletType(type).value} order {order} "
            f"(src/wavelet.c:167-185 contract)")
    if length < 2 or length % 2:
        raise ValueError(
            "signal length must be even and >= 2 "
            "(inc/simd/wavelet.h check_length contract)")


# --------------------------------------------------------------------------
# boundary extension
# --------------------------------------------------------------------------

def _extension_indices(ext, ext_len, length):
    """Index recipe for the right-extension of a length-``length``
    signal by ``ext_len`` samples (``src/wavelet.c:248-269``); None for
    ZERO."""
    ext = ExtensionType(ext)
    i = np.arange(ext_len)
    if ext is ExtensionType.PERIODIC:
        return i % length
    if ext is ExtensionType.MIRROR:
        return length - 1 - (i % length)
    if ext is ExtensionType.CONSTANT:
        return np.full(ext_len, length - 1)
    return None  # ZERO


def _extend(x, ext, ext_len):
    """``x`` extended on the right by ``ext_len`` samples (NumPy array
    or tensor in, the same kind out).  A tensor's extension is counted:
    ``wavelet_extend_bytes`` gets the bytes of the extended copy."""
    ext = ExtensionType(ext)
    length = x.shape[-1]
    if not isinstance(x, torch.Tensor):
        idx = _extension_indices(ext, ext_len, length)
        if idx is None:
            return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, ext_len)])
        return np.concatenate([x, np.take(x, idx, axis=-1)], axis=-1)
    out = _extend_tensor(x, ext, ext_len, length)
    obs.count("wavelet_extend_bytes", out.nbytes)
    return out


def _extend_tensor(x, ext, ext_len, length):
    if ext is ExtensionType.ZERO:
        return F.pad(x, (0, ext_len))
    if ext_len <= length:
        # slices, not a gather: no index array goes to the device
        if ext is ExtensionType.PERIODIC:
            tail = x[..., :ext_len]
        elif ext is ExtensionType.MIRROR:
            tail = x[..., length - ext_len:].flip(-1)
        else:
            tail = x[..., -1:].expand(*x.shape[:-1], ext_len)
    else:
        idx = torch.as_tensor(_extension_indices(ext, ext_len, length),
                              device=x.device)
        tail = x.index_select(-1, idx)
    return torch.cat([x, tail], -1)


# --------------------------------------------------------------------------
# the two DWT/SWT routes
# --------------------------------------------------------------------------

@obs.instrumented_jit(
    op="filter_bank",
    work=lambda x, type, order, ext, stride, dilation, out_len:
        _bm.filter_bank_work(lead_rows(x.shape), x.shape[-1], 2, order,
                             out_len))
def _filter_bank_conv(x, type, order, ext, stride, dilation, out_len):
    """Extend, then the 2-channel strided/dilated cross-correlation as
    one ``conv1d``.  DWT: stride 2, dilation 1; SWT: stride 1, dilation
    2^(level-1)."""
    taps = _filter_tensor(WaveletType(type), int(order), x.device)
    x_ext = _extend(x, ext, order * dilation)
    lhs = x_ext.reshape(-1, 1, x_ext.shape[-1])
    with prx.fp32_conv(x.device):
        out = F.conv1d(lhs, taps.reshape(2, 1, order), stride=stride,
                       dilation=dilation)
    out = out[..., :out_len].reshape(tuple(x.shape[:-1]) + (2, out_len))
    return out[..., 0, :], out[..., 1, :]


def _filter_bank_cuda(x, type, order, ext, stride, dilation, out_len):
    """DWT/SWT as the filter-bank kernel with two channels."""
    taps = _filter_tensor(WaveletType(type), int(order), x.device)
    x_ext = _extend(x, ext, order * dilation).contiguous()
    return _ck.filter_bank_cuda(x_ext, taps, stride, dilation, out_len)


# The wavelet candidate table (runtime/routing.py).  The filter-bank
# kernel reads each sample from device memory once where conv1d's
# lowering may stage it per tap; it needs enough batch rows to fill the
# card, and the block's input span at this stride and dilation has to
# fit shared memory (a deep SWT level — dilation 2^13 at order 16 —
# does not, and stays on conv1d).  The row term is the JAX package's
# static prior, not measured on the H100.
_WAVELET_DISABLE_ENV = "VELES_SIMD_DISABLE_CUDA_WAVELET"

_WAVELET_FAMILY = routing.family("wavelet", (
    routing.Route(
        "cuda",
        predicate=lambda rows, n, order, dilation, stride, cuda=False, **_:
            (_ck.should_route(rows, cuda)
             and _ck.fits_smem_fb(2, order, stride, dilation)),
        disable_env=_WAVELET_DISABLE_ENV,
        doc="filter-bank kernel, two channels (one read per sample; "
            "VELES_SIMD_DISABLE_CUDA_WAVELET opts out)"),
    routing.Route(
        "xla_conv",
        doc="2-channel strided/dilated conv1d, cuDNN pinned to fp32"),
))


def _wavelet_runners(src, type, order, ext, stride, dilation, out_len):
    """Route name -> zero-arg call, the one home of the candidate call
    expressions."""
    args = (src, WaveletType(type), int(order), ExtensionType(ext),
            stride, dilation, out_len)
    return {"cuda": lambda: _filter_bank_cuda(*args),
            "xla_conv": lambda: _filter_bank_conv(*args)}


def _step_route(src, order: int, dilation: int, stride: int, route,
                runners):
    """The route of one DWT/SWT step from the ``wavelet`` table: a
    forced ``route`` is validated and pinned (it re-raises on failure,
    never degrades); otherwise the engine selects inside the step's
    ``routing.select`` span — the static prior, or the measured/cached
    winner under ``VELES_SIMD_AUTOTUNE`` (``runners``: the callers'
    :func:`_wavelet_runners`, the thunks dispatch runs).  Returns
    ``(route, forced)``."""
    if route is not None:
        return _WAVELET_FAMILY.select(route=route), True
    with obs.span("routing.select", family="wavelet"):
        rows, n = lead_rows(src.shape), int(src.shape[-1])
        # rows and n pow2-bucketed, the filter design exact (the JAX key)
        return _WAVELET_FAMILY.select(
            rows=rows, n=n, order=order, dilation=dilation, stride=stride,
            cuda=src.is_cuda, runners=runners, probe_operand=src,
            tune_geom=lambda: {
                "rows": routing.pow2_bucket(rows),
                "n": routing.pow2_bucket(n), "order": order,
                "dilation": dilation, "stride": stride}), False


# --------------------------------------------------------------------------
# NumPy oracles (reference *_na semantics, src/wavelet.c:271-382)
# --------------------------------------------------------------------------

def _filter_bank_na(x, hi, lo, ext, stride, dilation, out_len):
    x = np.asarray(x, np.float32)
    order = hi.shape[-1]
    x_ext = _extend(x, ext, order * dilation)
    taps = np.arange(order) * dilation
    starts = np.arange(out_len) * stride
    idx = starts[:, None] + taps[None, :]                  # [out_len, order]
    windows = np.take(x_ext, idx, axis=-1)             # [..., out_len, order]
    reshi = np.einsum("...ij,j->...i", windows.astype(np.float64),
                      hi.astype(np.float64))
    reslo = np.einsum("...ij,j->...i", windows.astype(np.float64),
                      lo.astype(np.float64))
    return reshi.astype(np.float32), reslo.astype(np.float32)


def wavelet_apply_na(type, order, ext, src):
    """Scalar-oracle DWT (``wavelet_apply_na``, ``src/wavelet.c:271-324``).

    Returns ``(desthi, destlo)``, each of length ``length/2``.
    """
    src = np.asarray(src, np.float32)
    _check_apply_args(type, order, src.shape[-1])
    hi, lo = _filters(type, order)
    return _filter_bank_na(src, hi, lo, ExtensionType(ext), 2, 1,
                           src.shape[-1] // 2)


def stationary_wavelet_apply_na(type, order, level, ext, src):
    """Scalar-oracle SWT (``stationary_wavelet_apply_na``,
    ``src/wavelet.c:326-382``).  Returns ``(desthi, destlo)``, each of
    length ``length``."""
    src = np.asarray(src, np.float32)
    _check_apply_args(type, order, src.shape[-1])
    if level < 1:
        raise ValueError("level must be >= 1")
    hi, lo = _filters(type, order)
    return _filter_bank_na(src, hi, lo, ExtensionType(ext), 1,
                           1 << (level - 1), src.shape[-1])


# --------------------------------------------------------------------------
# public dispatching API
# --------------------------------------------------------------------------

def wavelet_apply(type, order, ext, src, simd=None, route=None):
    """Single DWT analysis step (``wavelet_apply``,
    ``inc/simd/wavelet.h:80-97``): returns ``(desthi, destlo)`` of length
    ``length/2`` each.

    ``route`` forces ``cuda`` (the filter-bank kernel) or ``xla_conv``
    (None auto-selects through the ``wavelet`` candidate table); a
    forced route re-raises on failure — it never silently degrades to
    the other implementation."""
    if not resolve_simd(simd, op="wavelet_apply"):
        return wavelet_apply_na(type, order, ext, src)
    src = as_f32(src).contiguous()
    _check_apply_args(type, order, src.shape[-1])
    runners = _wavelet_runners(src, type, order, ext, 2, 1,
                               src.shape[-1] // 2)
    chosen, forced = _step_route(src, int(order), 1, 2, route, runners)
    obs.record_decision(
        "wavelet_apply", chosen,
        family=WaveletType(type).value, order=int(order),
        ext=ExtensionType(ext).value, length=int(src.shape[-1]),
        forced=forced)
    with obs.span("wavelet_apply.dispatch", route=chosen):
        return runners[chosen]()


def stationary_wavelet_apply(type, order, level, ext, src, simd=None,
                             route=None):
    """Single SWT (à-trous) step at ``level`` ≥ 1
    (``stationary_wavelet_apply``, ``inc/simd/wavelet.h:119-139``):
    returns ``(desthi, destlo)`` of length ``length`` each.

    ``route`` forces ``cuda`` / ``xla_conv`` like :func:`wavelet_apply`
    (forced routes re-raise, never degrade)."""
    if not resolve_simd(simd, op="stationary_wavelet_apply"):
        return stationary_wavelet_apply_na(type, order, level, ext, src)
    src = as_f32(src).contiguous()
    _check_apply_args(type, order, src.shape[-1])
    if level < 1:
        raise ValueError("level must be >= 1")
    dilation = 1 << (level - 1)
    runners = _wavelet_runners(src, type, order, ext, 1, dilation,
                               src.shape[-1])
    chosen, forced = _step_route(src, int(order), dilation, 1, route,
                                 runners)
    obs.record_decision(
        "stationary_wavelet_apply", chosen,
        family=WaveletType(type).value, order=int(order),
        level=int(level), ext=ExtensionType(ext).value,
        length=int(src.shape[-1]), forced=forced)
    return runners[chosen]()


# -- fused multi-level cascade --------------------------------------------
#
# For the PERIODIC extension filtering commutes with the extension, so
# the whole L-level cascade collapses into L decimated FIR banks on the
# ORIGINAL signal with composed filters (the "algorithme a trous"
# identity):
#
#   hi_l = (h upsampled by 2^(l-1)) * L_{l-1},   L_l = (l ^ 2^(l-1)) * L_{l-1}
#
# Level l's stride-2^l output splits into 2^(L-l) output phases, each a
# stride-2^L bank over the input, so one pass of the cascade-bank kernel
# reads the input once for every level, copies no extension and makes
# one launch where the level loop makes L filter-bank passes and L
# extension copies.  The composed filters cost more multiply-adds than
# the level loop (level-l taps grow to (order-1)(2^l - 1) + 1), so the
# fused pass wins only where the card is bound by bytes.  On an NVIDIA
# H100 (tools/sweep_torch_fused_cascade.py) it took 1.3-20x less device
# time and 1.3-19x less chained time a call than the level loop in
# every group it admits up to the budget's top (daub22 at 3 levels,
# daub64 at 2), at 1 to 16,384 rows of 256 to 2^24 samples, up to 2^26
# a call: the kernel runs persistent over rows x output
# tiles, so how the samples split into rows does not matter to it.  So
# the gate's shape terms alone decide, at any row count, and the route
# is the port's default (the JAX package keeps it opt-in through
# VELES_SIMD_FORCE_FUSED_CASCADE, which the port does not read);
# VELES_SIMD_DISABLE_CUDA_WAVELET closes it with the filter-bank
# route.  Non-PERIODIC extensions do not commute with filtering (the
# cascade re-extends each computed lowpass), so they keep the level
# loop, as do 1 or more than 4 levels and CPU operands.

# multiply-add budget of the fused pass: 3 levels of daub8 is 176
# slots, sym16 at 3 levels 368
_FUSED_MAX_MACS = 512
_FUSED_MAX_LEVELS = 4


def _composed_cascade_filters(type, order, levels):
    """Per-level equivalent filters of the PERIODIC DWT cascade,
    float64 host-side: ``[g_hi_1 .. g_hi_L]`` and the final composed
    lowpass ``L_L`` (correlation orientation, matching the filter
    bank)."""
    hi, lo = _filters(type, order)
    h = hi.astype(np.float64)
    low = lo.astype(np.float64)

    def up(f, s):
        out = np.zeros((len(f) - 1) * s + 1)
        out[::s] = f
        return out

    gs, l_prev = [], np.array([1.0])
    for lvl in range(1, int(levels) + 1):
        gs.append(np.convolve(up(h, 1 << (lvl - 1)), l_prev))
        l_prev = np.convolve(up(low, 1 << (lvl - 1)), l_prev)
    return gs, l_prev


def _cascade_plan(gs, g_lo, levels):
    """``(plans, taps)`` for :func:`_ck.cascade_bank_cuda` and
    :func:`_ck.cascade_bank_periodic_cuda`, whose natural-order stores
    read the channels in this order: one channel per output phase r of
    each level l's highpass, for l = 1..L (phase r of ``hi_l`` is a
    bank over the 2^L input phases: sample ``2^l j + m`` lands on phase
    ``(2^l r + m) % 2^L`` at offset ``(2^l r + m) // 2^L``), then the
    final composed lowpass."""
    n_split = 1 << levels
    plans, taps = [], []
    for lvl, g in enumerate(gs, start=1):
        for r in range(1 << (levels - lvl)):
            base = (1 << lvl) * r
            plans.append(tuple(((base + m) % n_split,
                                (base + m) // n_split)
                               for m in range(len(g))))
            taps.append(np.asarray(g, np.float32))
    plans.append(tuple((m % n_split, m // n_split)
                       for m in range(len(g_lo))))
    taps.append(np.asarray(g_lo, np.float32))
    return tuple(plans), taps


@functools.lru_cache(maxsize=64)
def _cascade_plan_for(type, order, levels):
    """``(plans, taps, reach)`` of one (type, order, levels), built
    once; ``reach`` is the composed lowpass's last tap index."""
    gs, g_lo = _composed_cascade_filters(type, order, levels)
    return _cascade_plan(gs, g_lo, levels) + (len(g_lo) - 1,)


def _fused_cascade_gate(n, order, ext, levels, cuda=False, **_):
    levels = int(levels)
    if (ext != ExtensionType.PERIODIC.value
            or not 2 <= levels <= _FUSED_MAX_LEVELS):
        return False
    if n % (1 << levels):
        return False
    reach = (order - 1) * ((1 << levels) - 1)
    if reach >= n:       # composed filter wraps more than once
        return False
    n_macs = sum((1 << (levels - lvl))
                 * ((order - 1) * ((1 << lvl) - 1) + 1)
                 for lvl in range(1, levels + 1))
    n_macs += reach + 1
    if n_macs > _FUSED_MAX_MACS:
        return False
    # every slot's offset is at most reach // 2^L (the final lowpass's
    # last tap)
    return (_ck.on_card(cuda)
            and _ck.fits_smem_cb(1 << levels, reach >> levels,
                                 1 << levels))


# the cascade's own two-candidate table: the fused one-pass kernel
# wherever its gate admits the shape (the note above), the level loop
# the terminal fallback
_CASCADE_FAMILY = routing.family("wavelet.cascade", (
    routing.Route("fused_cascade", predicate=_fused_cascade_gate,
                  disable_env=_WAVELET_DISABLE_ENV,
                  doc="whole PERIODIC DWT cascade in one cascade-bank "
                      "pass where the gate admits the shape "
                      "(VELES_SIMD_DISABLE_CUDA_WAVELET opts out)"),
    routing.Route("level_loop",
                  doc="one wavelet step per level (every other shape)"),
))


def _fused_cascade(src, type, order, levels):
    """The whole PERIODIC DWT cascade in one cascade-bank launch (see
    the note above), which reads the wrap and writes each level in
    natural order: returns ``(hi_1, ..., hi_L, lo_L)``."""
    plans, taps, _ = _cascade_plan_for(WaveletType(type), int(order),
                                       int(levels))
    return _ck.cascade_bank_periodic_cuda(src, taps, plans, int(levels))


def wavelet_transform(type, order, ext, src, levels, simd=None):
    """Multi-level DWT cascade: repeatedly split the lowpass band.

    Returns ``[hi_1, hi_2, ..., hi_levels, lo_levels]`` like the usual
    pyramid.  A PERIODIC cascade of 2-4 levels on the card, of any
    row count and within the fused pass's multiply-add budget, runs as
    one launch of the cascade-bank kernel (gate note at
    :func:`_fused_cascade_gate`; ``VELES_SIMD_DISABLE_CUDA_WAVELET``
    closes it); every other call runs the level loop, one
    :func:`wavelet_apply` per level.  The fused pass composes each
    level's filters in float64, rounds them once and sums over the
    input in float32, so finite inputs give the level loop's bands
    within float32 rounding.  A NaN or Inf spreads further on the card,
    whatever the row count: the kernel reads the input in frames of
    ``2^levels`` samples and multiplies every sample of a frame it
    reads, zero taps included, so a non-finite sample poisons each
    output of level l whose support (samples ``2^l i`` to
    ``2^l i + (order - 1)(2^l - 1)``, periodic), widened to whole
    frames, holds it.  The level loop, and both routes' CPU versions,
    poison the outputs whose support holds it.
    (``VELES_SIMD_FORCE_FUSED_CASCADE``, the JAX package's opt-in, is
    not read.)
    """
    levels = int(levels)
    if not resolve_simd(simd, op="wavelet_transform"):
        return _level_loop(type, order, ext, src, levels, simd)
    src = as_f32(src).contiguous()
    _check_apply_args(type, order, src.shape[-1])
    # static by contract: the tune cache has never steered it
    route = _CASCADE_FAMILY.static_select(
        n=int(src.shape[-1]), order=int(order),
        ext=ExtensionType(ext).value, levels=levels, cuda=src.is_cuda)
    obs.record_decision(
        "wavelet_transform", route,
        family=WaveletType(type).value, order=int(order),
        levels=levels, ext=ExtensionType(ext).value,
        length=int(src.shape[-1]))
    # one span over the route's whole run, whichever route it is
    with obs.span("wavelet_transform.dispatch", route=route,
                  levels=levels):
        if route == "fused_cascade":
            return list(_fused_cascade(src, type, int(order), levels))
        return _level_loop(type, order, ext, src, levels, simd)


def _level_loop(type, order, ext, src, levels, simd):
    """The DWT cascade one :func:`wavelet_apply` a level."""
    coeffs = []
    cur = src
    for _ in range(levels):
        hi, lo = wavelet_apply(type, order, ext, cur, simd=simd)
        coeffs.append(hi)
        cur = lo
    coeffs.append(cur)
    return coeffs


def stationary_wavelet_transform(type, order, ext, src, levels, simd=None):
    """Multi-level SWT: level ℓ uses dilation 2^(ℓ-1) on the running
    lowpass (à-trous cascade).  Returns ``[hi_1, ..., hi_levels,
    lo_levels]``, all of the input length."""
    coeffs = []
    cur = src
    for lvl in range(1, int(levels) + 1):
        hi, lo = stationary_wavelet_apply(type, order, lvl, ext, cur,
                                          simd=simd)
        coeffs.append(hi)
        cur = lo
    coeffs.append(cur)
    return coeffs


# --------------------------------------------------------------------------
# synthesis (inverse transforms)
# --------------------------------------------------------------------------
#
# For the PERIODIC extension the analysis operator is a scaled
# orthogonal map: A = c·Q with c² = Σ lowpass², so A⁻¹ = Aᵀ/c².  The
# adjoint of {extend periodically, stride-s dilated *correlation*} is
# {upsample, dilated *convolution* with the same (unflipped) filters,
# fold the tail back periodically} — a transposed convolution.  The SWT
# is a 2× redundant frame: AᵀA = 2c²·I, hence the extra ½.


def _c2(lo_f) -> np.float32:
    """Filter energy Σ lowpass² — the analysis operator's scale²."""
    return np.float32(np.sum(np.asarray(lo_f, np.float64) ** 2))


def _synth_conv_na(hi_band, lo_band, fh, fl, lhs_dil, rhs_dil, out_len):
    """NumPy synthesis kernel: y = conv(up_{lhs_dil}(hi),
    dil_{rhs_dil}(fh)) + (same for lo), tail folded mod ``out_len``."""
    order = fh.shape[-1]
    batch_shape = hi_band.shape[:-1]
    m = hi_band.shape[-1]

    def up(a):
        if lhs_dil == 1:
            return a
        u = np.zeros(a.shape[:-1] + ((m - 1) * lhs_dil + 1,), np.float64)
        u[..., ::lhs_dil] = a
        return u

    def dil(f):
        if rhs_dil == 1:
            return f.astype(np.float64)
        u = np.zeros((order - 1) * rhs_dil + 1)
        u[::rhs_dil] = f
        return u

    hi2 = up(hi_band.astype(np.float64)).reshape(-1, (m - 1) * lhs_dil + 1)
    lo2 = up(lo_band.astype(np.float64)).reshape(hi2.shape)
    y = np.stack([np.convolve(h, dil(fh)) + np.convolve(lo, dil(fl))
                  for h, lo in zip(hi2, lo2)])
    out = y[:, :out_len].copy()
    t = out_len
    while t < y.shape[-1]:
        chunk = y[:, t:t + out_len]
        out[:, :chunk.shape[-1]] += chunk
        t += out_len
    return out.reshape(batch_shape + (out_len,))


def _synth_conv(hi_band, lo_band, type, order, lhs_dil, rhs_dil, out_len):
    """The device synthesis kernel: one ``conv_transpose1d`` (stride
    ``lhs_dil``, dilation ``rhs_dil``) over the stacked (hi, lo) bands,
    whose output is the full upsampled convolution, then the periodic
    fold of its tail onto the first ``out_len`` samples."""
    taps = _filter_tensor(WaveletType(type), int(order), hi_band.device)
    m = hi_band.shape[-1]
    batch_shape = tuple(hi_band.shape[:-1])
    lhs = torch.stack([hi_band, lo_band], -2).reshape(-1, 2, m)
    with prx.fp32_conv(lhs.device):
        y = F.conv_transpose1d(lhs, taps.reshape(2, 1, order),
                               stride=lhs_dil, dilation=rhs_dil)[:, 0]
    total = y.shape[-1]
    folds = -(-total // out_len)
    y = F.pad(y, (0, folds * out_len - total))
    y = y.reshape(-1, folds, out_len).sum(1)
    return y.reshape(batch_shape + (out_len,))


def _synth_work(hi_band, order, stride, n):
    """``(flops, bytes)`` of a synthesis of ``n`` samples a row from two
    bands at ``stride``: each output a multiply-add over ``2 * order /
    stride`` taps of the two bands, the bands and the taps read once
    and the float32 output written once."""
    rows = lead_rows(hi_band.shape)
    return (2.0 * rows * n * (2 * int(order) // stride),
            4.0 * (2 * hi_band.numel() + 2 * int(order) + rows * n))


# the instrumented synthesis cores, under the JAX package's names: the
# periodic DWT and SWT inverses, and the periodic adjoint the boundary
# correction of the other extensions starts from
@obs.instrumented_jit(work=lambda hi, lo, type, order: _synth_work(
    hi, order, 2, 2 * hi.shape[-1]))
def _dwt_synth(hi_band, lo_band, type, order):
    _, lo_f = _filters(type, order)
    out = _synth_conv(hi_band, lo_band, type, order, 2, 1,
                      2 * hi_band.shape[-1])
    return out / float(_c2(lo_f))


@obs.instrumented_jit(work=lambda hi, lo, type, order, level: _synth_work(
    hi, order, 1, hi.shape[-1]))
def _swt_synth(hi_band, lo_band, type, order, level):
    _, lo_f = _filters(type, order)
    out = _synth_conv(hi_band, lo_band, type, order, 1, 1 << (level - 1),
                      hi_band.shape[-1])
    return out / float(2 * _c2(lo_f))


@obs.instrumented_jit(
    work=lambda hi, lo, type, order, stride, dil, n: _synth_work(
        hi, order, stride, n))
def _synth_conv_jit(hi_band, lo_band, type, order, stride, dil, n):
    return _synth_conv(hi_band, lo_band, type, order, stride, dil, n)


def _check_synth_args(type, order, hi_band, lo_band):
    if not validate_order(type, order):
        raise ValueError(
            f"unsupported {WaveletType(type).value} order {order}")
    if tuple(hi_band.shape) != tuple(lo_band.shape):
        raise ValueError(
            f"band shapes differ: {tuple(hi_band.shape)} vs "
            f"{tuple(lo_band.shape)}")


# --------------------------------------------------------------------------
# non-periodic synthesis: Woodbury boundary correction
# --------------------------------------------------------------------------
#
# For MIRROR/CONSTANT/ZERO extensions the analysis operator A_ext
# differs from the periodic A_per only in the boundary rows whose window
# crosses the right edge, and every differing row has support in the
# first/last L samples (L = order·dilation).  Reconstruction is the
# normal-equations least-squares solve
#
#   x = G⁻¹·A_extᵀy,   G = A_extᵀA_ext = g·I + U·C·Uᵀ
#
# with g = c² (DWT) or 2c² (SWT), U = [s_k | d_k] the periodic boundary
# rows and the (ext − periodic) row differences, C = [[0,I],[I,I]] — so
# G⁻¹ applies by Woodbury as the periodic adjoint plus a compact
# boundary correction against a small precomputed system.  All U
# columns live on J = [0,L) ∪ [n−L,n); the precompute is float64 NumPy
# cached per (type, order, ext, n, level), and the device path applies
# it to the boundary samples only, as one float64 matmul on the device
# (a float32 solve would amplify rounding by cond(G) ≈ cond(A)²).
#
# Exactness (as in the JAX package): the SWT's A_ext is full-rank but
# not tight (cond ≈ 450 for daub8), so float32 coefficients give ~1e-4
# relative round-trip error at the boundary; the non-periodic DWT is
# rank-deficient (order/2 − 1 zero singular values), so its inverse is
# the least-squares reconstruction.


def _analysis_row_compact(f, start, dil, n, L, ext):
    """Analysis row (window at ``start``, taps dilated by ``dil``,
    extension ``ext``) restricted to J = [0,L) ∪ [n−L,n), as a length-2L
    float64 vector.  Caller guarantees the row's support lies in J."""
    v = np.zeros(2 * L)

    def jpos(col):
        if col < L:
            return col
        assert col >= n - L, "boundary-row support escaped J"
        return L + col - (n - L)

    ext = ExtensionType(ext)
    for j, fj in enumerate(np.asarray(f, np.float64)):
        col = start + j * dil
        if col < n:
            v[jpos(col)] += fj
            continue
        e = col - n                       # extension sample index (< L ≤ n)
        if ext is ExtensionType.PERIODIC:
            v[jpos(e)] += fj
        elif ext is ExtensionType.MIRROR:
            v[jpos(n - 1 - e)] += fj
        elif ext is ExtensionType.CONSTANT:
            v[jpos(n - 1)] += fj
        # ZERO contributes nothing
    return v


def _check_ext_synth_length(n, L, what):
    if n < 2 * L:
        raise ValueError(
            f"non-periodic {what} synthesis needs length >= {2 * L} "
            f"(2x the boundary support order*dilation={L}) — got {n}; "
            "use ext=PERIODIC for shorter signals")


@functools.lru_cache(maxsize=256)
def _synth_boundary_correction(type, order, ext, n, stride, level):
    """(D, P, Q, r_band) for the normal-equations Woodbury boundary
    correction; None when no analysis window crosses the edge.

    ``stride=2, level=1`` is the DWT (g = c²); ``stride=1`` the SWT at
    ``level`` (g = 2c²).  ``Q = (C⁻¹ + UᵀU/g)⁻¹`` — pinv when the
    non-periodic DWT's rank deficiency makes it singular."""
    hi_f, lo_f = _filters(type, order)
    c2 = float(np.sum(np.asarray(lo_f, np.float64) ** 2))
    g = c2 * (2.0 / stride)
    dil = 1 << (level - 1)
    L = order * dil
    n_out = n // stride
    # first window i whose span crosses the right edge
    i_min = max(0, -(-(n - (order - 1) * dil) // stride))
    rows = [(f, i) for f in (hi_f, lo_f) for i in range(i_min, n_out)]
    if not rows:
        return None
    r = len(rows)
    D = np.zeros((r, 2 * L))
    S = np.zeros((r, 2 * L))
    for k, (f, i) in enumerate(rows):
        per = _analysis_row_compact(f, i * stride, dil, n, L,
                                    ExtensionType.PERIODIC)
        D[k] = _analysis_row_compact(f, i * stride, dil, n, L, ext) - per
        S[k] = per
    P = np.concatenate([S, D], axis=0)            # 2r x 2L
    eye = np.eye(r)
    c_inv = np.block([[-eye, eye], [eye, np.zeros((r, r))]])
    mid = c_inv + (P @ P.T) / g
    Q = (np.linalg.inv(mid) if np.linalg.cond(mid) < 1e12
         else np.linalg.pinv(mid, rcond=1e-10))
    return D, P, Q, n_out - i_min


def _apply_boundary(x, corr_j, n, L):
    """x[J] -= corr_j, J = [0,L) ∪ [n−L,n) (NumPy, in place)."""
    x[..., :L] -= corr_j[..., :L]
    x[..., n - L:] -= corr_j[..., L:]
    return x


def _synth_ext(hi_band, lo_band, type, order, level, ext, stride):
    """Least-squares inverse of the ``ext``-extended analysis, all in
    float64 NumPy: the periodic adjoint plus the compact
    normal-equations boundary correction.  ``stride=2`` DWT (output
    length 2m), ``stride=1`` SWT at ``level``."""
    hi_f, lo_f = _filters(type, order)
    g = float(_c2(lo_f)) * 2.0 / stride
    dil = 1 << (int(level) - 1)
    n = hi_band.shape[-1] * stride
    L = order * dil
    _check_ext_synth_length(n, L, "DWT" if stride == 2 else "SWT")
    z = np.asarray(_synth_conv_na(hi_band, lo_band, hi_f, lo_f, stride,
                                  dil, n), np.float64)
    corr = _synth_boundary_correction(WaveletType(type), int(order),
                                      ExtensionType(ext), n, stride,
                                      int(level))
    if corr is None:
        return (z / g).astype(np.float32)
    D, P, Q, r_band = corr
    # A_extᵀy = A_perᵀy + Dᵀ·y_boundary (the differing rows' outputs)
    m_out = n // stride
    yb = np.concatenate([hi_band[..., m_out - r_band:],
                         lo_band[..., m_out - r_band:]], axis=-1)
    z = _apply_boundary(z, -(yb.astype(np.float64) @ D), n, L)
    zj = np.concatenate([z[..., :L], z[..., n - L:]], axis=-1)
    corr_j = ((zj @ P.T) @ Q.T) @ P / (g * g)
    x = z / g
    return _apply_boundary(x, corr_j, n, L).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _synth_boundary_zmap(type, order, n, stride, level):
    """(M_z, B): float64 matrix mapping the per-band boundary coefficient
    chunks (first B and last B of hi then lo → 4B values) to the
    periodic adjoint restricted to J = [0,L) ∪ [n−L,n).  G⁻¹ equals I/g
    off J, so only x[J] needs the higher precision."""
    hi_f, lo_f = _filters(type, order)
    dil = 1 << (level - 1)
    L = order * dil
    n_out = n // stride
    B = max(-(-L // stride), -(-(L + (order - 1) * dil) // stride))
    assert n_out >= 2 * B, "caller guarantees n >= 4L"
    chunk = list(range(B)) + list(range(n_out - B, n_out))
    M = np.zeros((2 * L, 4 * B))
    for b, f in enumerate((hi_f, lo_f)):
        f64 = np.asarray(f, np.float64)
        for c, i in enumerate(chunk):
            for j in range(order):
                t = (i * stride + j * dil) % n
                if t < L:
                    M[t, b * 2 * B + c] += f64[j]
                elif t >= n - L:
                    M[L + t - (n - L), b * 2 * B + c] += f64[j]
    return M, B


@functools.lru_cache(maxsize=256)
def _synth_boundary_map(type, order, ext, n, stride, level):
    """(K, B), float64: x over J from the boundary coefficient chunks of
    :func:`_synth_boundary_zmap` in one ``[4B, 2L]`` matrix — the
    periodic adjoint over J, the differing rows' outputs ``Dᵀ·y_b`` and
    the Woodbury correction ``(I/g − PᵀQᵀP/g²)``; None when no analysis
    window crosses the edge.  ``n >= 4L``."""
    corr = _synth_boundary_correction(type, order, ext, n, stride, level)
    if corr is None:
        return None
    D, P, Q, r_band = corr
    M_z, B = _synth_boundary_zmap(type, order, n, stride, level)
    _, lo_f = _filters(type, order)
    g = float(_c2(lo_f)) * 2.0 / stride
    z_map = M_z.T.copy()
    # y_b is the last r_band coefficients of each band's chunks
    z_map[2 * B - r_band:2 * B] += D[:r_band]
    z_map[4 * B - r_band:] += D[r_band:]
    solve = np.eye(z_map.shape[1]) / g - (P.T @ Q.T @ P) / (g * g)
    return z_map @ solve, B


@functools.lru_cache(maxsize=256)
def _synth_boundary_map_on(type, order, ext, n, stride, level, device):
    """:func:`_synth_boundary_map` with its matrix as a float64 tensor
    on ``device``, copied there once per key."""
    mapped = _synth_boundary_map(type, order, ext, n, stride, level)
    if mapped is None:
        return None
    return torch.as_tensor(mapped[0], device=device), mapped[1]


def _synth_ext_device(hi_band, lo_band, type, order, level, ext, stride):
    """Device-path non-periodic synthesis: the periodic adjoint in
    float32 (exact off the boundary set), then the boundary samples
    recomputed on the device in float64 by one matmul against the
    precomputed :func:`_synth_boundary_map`."""
    type, order, level = WaveletType(type), int(order), int(level)
    ext = ExtensionType(ext)
    hi_f, lo_f = _filters(type, order)
    g = float(_c2(lo_f)) * 2.0 / stride
    dil = 1 << (level - 1)
    n = hi_band.shape[-1] * stride
    L = order * dil
    _check_ext_synth_length(n, L, "DWT" if stride == 2 else "SWT")
    if n < 4 * L:
        # boundary windows overlap both ends: run the whole (small)
        # problem through the float64 host path
        return torch.as_tensor(
            _synth_ext(hi_band.cpu().numpy(), lo_band.cpu().numpy(), type,
                       order, level, ext, stride), device=hi_band.device)
    x = _synth_conv_jit(hi_band, lo_band, type, order, stride, dil, n) / g
    mapped = _synth_boundary_map_on(type, order, ext, n, stride, level,
                                    x.device)
    if mapped is None:
        return x
    k_map, B = mapped
    n_out = n // stride
    chunks = torch.cat([hi_band[..., :B], hi_band[..., n_out - B:],
                        lo_band[..., :B], lo_band[..., n_out - B:]], -1)
    x_j = (chunks.double() @ k_map).float()
    x[..., :L] = x_j[..., :L]
    x[..., n - L:] = x_j[..., L:]
    return x


def _synth_operands(type, order, desthi, destlo):
    desthi, destlo = as_f32(desthi), as_f32(destlo)
    if destlo.device != desthi.device:
        raise ValueError(f"bands on {desthi.device} and {destlo.device}")
    _check_synth_args(type, order, desthi, destlo)
    return desthi, destlo


def wavelet_reconstruct(type, order, desthi, destlo, simd=None,
                        ext=ExtensionType.PERIODIC):
    """Exact inverse of :func:`wavelet_apply`: ``(hi, lo)`` of length
    ``m`` each → signal of length ``2m``.

    ``ext`` must name the extension the *analysis* used — PERIODIC uses
    the scaled-orthogonal adjoint directly; MIRROR/CONSTANT/ZERO add the
    Woodbury boundary correction and require ``2m >= 2*order``; their
    result is the least-squares reconstruction (the non-periodic DWT is
    rank-deficient)."""
    if not resolve_simd(simd, op="wavelet"):
        return wavelet_reconstruct_na(type, order, desthi, destlo, ext=ext)
    desthi, destlo = _synth_operands(type, order, desthi, destlo)
    ext = ExtensionType(ext)
    if ext is ExtensionType.PERIODIC:
        return _dwt_synth(desthi, destlo, WaveletType(type), int(order))
    return _synth_ext_device(desthi, destlo, type, order, 1, ext, 2)


def wavelet_reconstruct_na(type, order, desthi, destlo,
                           ext=ExtensionType.PERIODIC):
    """NumPy oracle twin of :func:`wavelet_reconstruct`."""
    desthi = np.asarray(desthi, np.float32)
    destlo = np.asarray(destlo, np.float32)
    _check_synth_args(type, order, desthi, destlo)
    ext = ExtensionType(ext)
    if ext is not ExtensionType.PERIODIC:
        return _synth_ext(desthi, destlo, type, order, 1, ext, 2)
    hi_f, lo_f = _filters(type, order)
    out = _synth_conv_na(desthi, destlo, hi_f, lo_f, 2, 1,
                         2 * desthi.shape[-1])
    return (out / _c2(lo_f)).astype(np.float32)


def stationary_wavelet_reconstruct(type, order, level, desthi, destlo,
                                   simd=None,
                                   ext=ExtensionType.PERIODIC):
    """Exact inverse of :func:`stationary_wavelet_apply`: the SWT is a
    2× redundant frame, so synthesis is the adjoint over ``2c²`` —
    plus, for non-PERIODIC ``ext`` (which must match the analysis), the
    Woodbury boundary correction (needs
    ``length >= 2*order*2^(level-1)``)."""
    if not resolve_simd(simd, op="wavelet"):
        return stationary_wavelet_reconstruct_na(type, order, level,
                                                 desthi, destlo, ext=ext)
    desthi, destlo = _synth_operands(type, order, desthi, destlo)
    if level < 1:
        raise ValueError("level must be >= 1")
    ext = ExtensionType(ext)
    if ext is ExtensionType.PERIODIC:
        return _swt_synth(desthi, destlo, WaveletType(type), int(order),
                          int(level))
    return _synth_ext_device(desthi, destlo, type, order, level, ext, 1)


def stationary_wavelet_reconstruct_na(type, order, level, desthi, destlo,
                                      ext=ExtensionType.PERIODIC):
    """NumPy oracle twin of :func:`stationary_wavelet_reconstruct`."""
    desthi = np.asarray(desthi, np.float32)
    destlo = np.asarray(destlo, np.float32)
    _check_synth_args(type, order, desthi, destlo)
    if level < 1:
        raise ValueError("level must be >= 1")
    ext = ExtensionType(ext)
    if ext is not ExtensionType.PERIODIC:
        return _synth_ext(desthi, destlo, type, order, level, ext, 1)
    hi_f, lo_f = _filters(type, order)
    out = _synth_conv_na(desthi, destlo, hi_f, lo_f, 1, 1 << (level - 1),
                         desthi.shape[-1])
    return (out / (2 * _c2(lo_f))).astype(np.float32)


def wavelet_inverse_transform(type, order, coeffs, simd=None,
                              ext=ExtensionType.PERIODIC):
    """Invert :func:`wavelet_transform`: ``[hi_1, ..., hi_L, lo_L]`` →
    the original signal (``ext`` must match the analysis cascade)."""
    coeffs = list(coeffs)
    if len(coeffs) < 2:
        raise ValueError("need [hi_1, ..., hi_L, lo_L] with L >= 1")
    cur = coeffs[-1]
    for hi in reversed(coeffs[:-1]):
        cur = wavelet_reconstruct(type, order, hi, cur, simd=simd, ext=ext)
    return cur


def stationary_wavelet_inverse_transform(type, order, coeffs, simd=None,
                                         ext=ExtensionType.PERIODIC):
    """Invert :func:`stationary_wavelet_transform` (à-trous cascade;
    ``ext`` must match the analysis)."""
    coeffs = list(coeffs)
    if len(coeffs) < 2:
        raise ValueError("need [hi_1, ..., hi_L, lo_L] with L >= 1")
    cur = coeffs[-1]
    for lvl in range(len(coeffs) - 1, 0, -1):
        cur = stationary_wavelet_reconstruct(type, order, lvl,
                                             coeffs[lvl - 1], cur,
                                             simd=simd, ext=ext)
    return cur


# --------------------------------------------------------------------------
# wavelet packet transform
# --------------------------------------------------------------------------
#
# The full binary filter-bank tree: every band is split at every level,
# giving 2^levels uniform-bandwidth leaves.

def _backend(simd):
    """``(as_array, stack)`` of the backend ``simd`` resolves to."""
    if resolve_simd(simd, op="wavelet"):
        return as_f32, torch.stack
    return np.asarray, np.stack


def wavelet_packet_transform(type, order, ext, src, levels, simd=None):
    """Full wavelet-packet decomposition: ``2^levels`` leaf bands, each
    ``[..., n / 2^levels]``, in natural (filter-bank) order — leaf
    ``i``'s bit ``b`` (MSB = level 1) says whether the hi (0) or lo (1)
    branch was taken at level ``b+1``, so leaf 0 is the all-hi band.
    The two-level layout matches the reference's
    ``wavelet_recycle_source`` quartering: ``[hihi, hilo, lohi, lolo]``.
    """
    levels = int(levels)
    if levels < 1:
        raise ValueError("levels must be >= 1")
    asarray, stack_fn = _backend(simd)
    # one stacked dispatch per level (all bands at a level share a
    # length): a larger batch for the routing gate, fewer launches
    stack = asarray(src)[None]                       # [m=1, ..., n]
    for _ in range(levels):
        hi, lo = wavelet_apply(type, order, ext, stack, simd=simd)
        # interleave so band index doubles as 2i (hi) / 2i+1 (lo)
        stack = stack_fn([hi, lo], 1).reshape(
            (2 * stack.shape[0],) + tuple(hi.shape[1:]))
    return [stack[i] for i in range(stack.shape[0])]


def wavelet_packet_inverse_transform(type, order, coeffs, simd=None,
                                     ext=ExtensionType.PERIODIC):
    """Invert :func:`wavelet_packet_transform` (``ext`` must match the
    analysis; PERIODIC is exact, like :func:`wavelet_reconstruct`)."""
    bands = list(coeffs)
    n = len(bands)
    if n < 2 or n & (n - 1):
        raise ValueError(
            f"need 2^levels leaf bands, got {n}")
    asarray, stack_fn = _backend(simd)
    stack = stack_fn([asarray(b) for b in bands])    # [2m, ..., len]
    while stack.shape[0] > 1:
        pairs = stack.reshape((stack.shape[0] // 2, 2)
                              + tuple(stack.shape[1:]))
        stack = wavelet_reconstruct(type, order, pairs[:, 0], pairs[:, 1],
                                    simd=simd, ext=ext)
    return stack[0]


# --------------------------------------------------------------------------
# separable 2D transform
# --------------------------------------------------------------------------

def _apply_last(fn, x):
    """Run a last-axis transform along axis -2 by transposing around
    it."""
    return tuple(o.swapaxes(-1, -2) for o in fn(x.swapaxes(-1, -2)))


def _separable_apply2d(rows, src, simd, what):
    """Shared separable-2D analysis plumbing: one row pass, then ONE
    stacked column pass (twice the batch for the routing gate, half the
    dispatches).  Returns ``(ll, lh, hl, hh)``."""
    if np.ndim(src) < 2:
        raise ValueError(f"{what} needs [..., n0, n1]")
    asarray, stack_fn = _backend(simd)
    hi_r, lo_r = rows(asarray(src))                  # along n1
    bands, lows = _apply_last(rows, stack_fn([hi_r, lo_r]))
    hh, lh = bands[0], bands[1]
    hl, ll = lows[0], lows[1]
    return ll, lh, hl, hh


def _separable_reconstruct2d(synth, ll, lh, hl, hh, simd):
    """Shared separable-2D synthesis plumbing: one stacked column
    synthesis for both row bands, then the row synthesis."""
    asarray, stack_fn = _backend(simd)
    hi_b = stack_fn([asarray(hh), asarray(lh)]).swapaxes(-1, -2)
    lo_b = stack_fn([asarray(hl), asarray(ll)]).swapaxes(-1, -2)
    rec = synth(hi_b, lo_b).swapaxes(-1, -2)
    return synth(rec[0], rec[1])


def wavelet_apply2d(type, order, ext, src, simd=None):
    """Separable single-level 2D DWT of ``[..., n0, n1]``: rows then
    columns.  Returns ``(LL, LH, HL, HH)``, each ``[..., n0/2, n1/2]``
    (first letter = row band, second = column band; L = lowpass)."""
    return _separable_apply2d(
        lambda v: wavelet_apply(type, order, ext, v, simd=simd),
        src, simd, "wavelet_apply2d")


def wavelet_reconstruct2d(type, order, ll, lh, hl, hh, simd=None,
                          ext=ExtensionType.PERIODIC):
    """Exact inverse of :func:`wavelet_apply2d`: columns then rows, each
    the 1D synthesis (``ext`` must match the analysis)."""
    return _separable_reconstruct2d(
        lambda a, b: wavelet_reconstruct(type, order, a, b, simd=simd,
                                         ext=ext),
        ll, lh, hl, hh, simd)


def stationary_wavelet_apply2d(type, order, level, ext, src, simd=None):
    """Separable single-level 2D SWT (à-trous, undecimated) of
    ``[..., n0, n1]``: rows then columns at the same dilation.  Returns
    ``(LL, LH, HL, HH)``, each full ``[..., n0, n1]`` size."""
    return _separable_apply2d(
        lambda v: stationary_wavelet_apply(type, order, level, ext, v,
                                           simd=simd),
        src, simd, "stationary_wavelet_apply2d")


def stationary_wavelet_reconstruct2d(type, order, level, ll, lh, hl, hh,
                                     simd=None,
                                     ext=ExtensionType.PERIODIC):
    """Exact inverse of :func:`stationary_wavelet_apply2d`: columns then
    rows, each the 1D SWT synthesis."""
    return _separable_reconstruct2d(
        lambda a, b: stationary_wavelet_reconstruct(type, order, level,
                                                    a, b, simd=simd,
                                                    ext=ext),
        ll, lh, hl, hh, simd)


def wavelet_packet_transform2d(type, order, ext, src, levels, simd=None):
    """Full 2D wavelet-packet (quad-tree) decomposition: ``4^levels``
    leaves, each ``[..., n0/2^levels, n1/2^levels]``, in natural order —
    leaf index interleaves the per-level quad choice ``(ll, lh, hl,
    hh)`` = ``(0, 1, 2, 3)``, MSB pair = level 1, so leaf 0 is the
    all-LL band (LL-first, unlike the 1D hi-first order)."""
    levels = int(levels)
    if levels < 1:
        raise ValueError("levels must be >= 1")
    asarray, stack_fn = _backend(simd)
    stack = asarray(src)[None]                  # [m=1, ..., n0, n1]
    for _ in range(levels):
        quad = wavelet_apply2d(type, order, ext, stack, simd=simd)
        stack = stack_fn(quad, 1).reshape(
            (4 * stack.shape[0],) + tuple(quad[0].shape[1:]))
    return [stack[i] for i in range(stack.shape[0])]


def wavelet_packet_inverse_transform2d(type, order, coeffs, simd=None,
                                       ext=ExtensionType.PERIODIC):
    """Invert :func:`wavelet_packet_transform2d` (``ext`` must match the
    analysis; PERIODIC is exact)."""
    bands = list(coeffs)
    n = len(bands)
    levels = 0
    while 4 ** levels < n:
        levels += 1
    if n < 4 or 4 ** levels != n:
        raise ValueError(f"need 4^levels leaf bands, got {n}")
    asarray, stack_fn = _backend(simd)
    stack = stack_fn([asarray(b) for b in bands])
    while stack.shape[0] > 1:
        quads = stack.reshape((stack.shape[0] // 4, 4)
                              + tuple(stack.shape[1:]))
        stack = wavelet_reconstruct2d(
            type, order, quads[:, 0], quads[:, 1], quads[:, 2],
            quads[:, 3], simd=simd, ext=ext)
    return stack[0]


def wavelet_transform2d(type, order, ext, src, levels, simd=None):
    """Multi-level 2D DWT pyramid: recursively split the LL band.
    Returns ``[(lh_1, hl_1, hh_1), ..., (lh_L, hl_L, hh_L), ll_L]``."""
    coeffs = []
    cur = src
    for _ in range(int(levels)):
        ll, lh, hl, hh = wavelet_apply2d(type, order, ext, cur, simd=simd)
        coeffs.append((lh, hl, hh))
        cur = ll
    coeffs.append(cur)
    return coeffs


def wavelet_inverse_transform2d(type, order, coeffs, simd=None,
                                ext=ExtensionType.PERIODIC):
    """Invert :func:`wavelet_transform2d` (``ext`` must match the
    analysis cascade)."""
    coeffs = list(coeffs)
    if len(coeffs) < 2:
        raise ValueError("need [(lh_1, hl_1, hh_1), ..., ll_L] with L >= 1")
    cur = coeffs[-1]
    for lh, hl, hh in reversed(coeffs[:-1]):
        cur = wavelet_reconstruct2d(type, order, cur, lh, hl, hh,
                                    simd=simd, ext=ext)
    return cur


# --------------------------------------------------------------------------
# API shims for the reference's layout helpers
# --------------------------------------------------------------------------

def wavelet_validate_order(type, order):
    """``inc/simd/wavelet.h:40-44``."""
    return validate_order(type, order)


def wavelet_prepare_array(order, src, length=None):
    """``inc/simd/wavelet.h:55-68``: the reference builds aligned
    shifted copies for AVX; here it is a defensive copy, the
    reference's own no-SIMD behaviour (``src/wavelet.c:110-113``)."""
    src = np.asarray(src, np.float32)
    if length is not None and src.shape[-1] != int(length):
        raise ValueError("length does not match src")
    return src.copy()


def wavelet_allocate_destination(order, source_length):
    """``inc/simd/wavelet.h:69-80``: half-length zero buffer."""
    source_length = int(source_length)
    if source_length % 4:
        raise ValueError("sourceLength must be a multiple of 4 "
                         "(src/wavelet.c:126-127 contract)")
    return np.zeros(source_length // 2, np.float32)


def wavelet_recycle_source(order, src, length=None):
    """``inc/simd/wavelet.h:82-88``: split a scratch buffer into 4
    quarter views for the next cascade level (``src/wavelet.c:138-165``).
    Returns ``(desthihi, desthilo, destlohi, destlolo)`` or ``(None,)*4``
    when the length is not a positive multiple of 4."""
    src = np.asarray(src)
    n = src.shape[-1] if length is None else int(length)
    if n == 0 or n % 4:
        return (None, None, None, None)
    lq = n // 4
    return tuple(src[..., i * lq:(i + 1) * lq] for i in range(4))
