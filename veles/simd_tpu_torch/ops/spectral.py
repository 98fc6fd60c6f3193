"""Spectral analysis: STFT / ISTFT, spectrogram, Hilbert envelope, CWT,
PSD estimation, chirp-Z and Lomb-Scargle.

The port of ``veles.simd_tpu.ops.spectral``, computed with PyTorch on
``Config.device``; the semantics are the JAX package's, function for
function.

Routes, JAX name → port name where they differ:

* ``stft``: ``pallas_fused`` → ``cuda_fused``, the fused STFT kernel
  (``csrc/stft.cu``, :func:`~veles.simd_tpu_torch.ops.cuda_kernels.
  stft_cuda`): windowed real DFT as a shared-memory FFT per frame,
  the frames tensor never built; ``rdft_matmul``,
  the ``[frames, L] @ [L, 2*bins]`` basis matmul in fp32 (TF32 off);
  ``xla_fft``, ``torch.fft.rfft`` of the windowed frames (cuFFT on the
  card).  ``VELES_SIMD_DISABLE_STFT_CUDA`` closes the kernel route,
  ``VELES_SIMD_DISABLE_DFT_MATMUL`` the basis-matmul routes.
* ``istft``: ``rdft_matmul`` (inverse-basis matmul) and ``xla_fft``
  (``irfft``), each feeding one overlap-add (``F.fold``).
* ``hilbert``: ``matmul_dft`` (the dense circulant analytic-signal
  operator as two matmuls) and ``xla_fft``.
* ``morlet_cwt``: ``matmul_dft`` (positive-frequency DFT basis pair),
  ``ct_matmul`` (Cooley-Tukey factorized matmul DFT) and ``xla_fft``.

The route gates keep every term of the JAX tables as static priors,
none yet measured on the H100: the fused kernel serves hops that divide
the frame and are multiples of 128, at least two hops a frame and at
least 64 frames; the basis matmuls serve frames up to 4096 samples and
transforms up to 1024 samples.  The fused route needs its operand on a
CUDA card (``cuda_kernels.on_card``, the JAX package's
``pallas_available``).

Framing is ``Tensor.unfold`` (a view; the JAX package's reshape trick
was an XLA workaround) and overlap-add its adjoint ``F.fold``.  The
framing decision events keep the JAX names (``reshape_interleave`` /
``gather``, ``reshape_overlap_add`` / ``scatter``) as the geometry
class of the call.

Host-side constants (DFT bases, analytic multipliers, wavelet banks)
live in one bounded LRU (``utils.cache.ConstantCache``), their device
copies in a second, keyed by device too; both report through
``obs.caches()``.  Not ported: the
``*_bf16_comp`` precision routes, the fault and breaker wrapping (a
failed kernel launch raises; it never changes route), and the measured
autotuner.

All entry points accept leading batch dimensions.  Results are tensors
(complex64 spectra) on the device; ``simd=False`` runs the NumPy
float64 oracle twins (``*_na``) and returns NumPy as the JAX package
does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.ops import cuda_kernels as _ck
from veles.simd_tpu_torch.runtime import precision as prx
from veles.simd_tpu_torch.runtime import routing
from veles.simd_tpu_torch.utils.cache import ConstantCache
from veles.simd_tpu_torch.utils.config import resolve_simd
from veles.simd_tpu_torch.utils.platform import (as_c64, as_f32, device,
                                                 on_cuda)

__all__ = [
    "stft", "stft_na", "istft", "istft_na", "spectrogram",
    "spectrogram_na", "hilbert", "hilbert_na", "envelope", "envelope_na",
    "morlet_cwt", "morlet_cwt_na", "hann_window", "frame_count",
    "detrend", "detrend_na", "welch", "welch_na", "periodogram",
    "periodogram_na", "csd", "csd_na", "coherence", "coherence_na",
    "czt", "czt_na", "zoom_fft", "lombscargle",
    "lombscargle_na", "ct_factor", "ct_apply", "ct_basis_parts",
    "ct_basis_device", "dft_basis_parts", "twiddle_parts",
    "hermitian_extend",
    "stft_stream_carry", "select_stft_stream_route",
    "stft_stream_step", "stft_stream_oracle", "ROUTE_NAMES",
]

# JAX package route name -> the port's name for the same route
ROUTE_NAMES = {"pallas_fused": "cuda_fused"}


def _host(x, dtype=None):
    """``x`` as a NumPy array of ``dtype`` (None keeps its own; a
    tensor comes to the host first): the oracle twins' input rule."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


# ---------------------------------------------------------------------------
# host-side and device-side constant caches + route-selection constants
# ---------------------------------------------------------------------------

# matmul-DFT routing bound: the [L, 2*bins] basis holds about L^2
# floats (67 MB at L = 4096) and the per-frame multiply-adds grow as
# L^2 against the FFT's L log L; up to this frame length the dense
# product is the JAX package's static prior
AUTO_DFT_MATMUL_MAX_FRAME = 4096
# hilbert's circulant analytic-signal operator is a dense [n, n] pair —
# 8 MB at n = 1024; beyond that the FFT's O(n log n) wins outright
HILBERT_MATMUL_MAX_N = 1024
# same residency math for the CWT's positive-frequency basis pair
CWT_MATMUL_MAX_N = 1024
_DFT_MATMUL_ENV = "VELES_SIMD_DISABLE_DFT_MATMUL"


def dft_matmul_allowed() -> bool:
    """May implicit routing use the matmul-DFT routes (stft/istft
    ``rdft_matmul``, hilbert/cwt ``matmul_dft``)?  True unless
    ``VELES_SIMD_DISABLE_DFT_MATMUL`` is set truthy."""
    return not routing.env_truthy(_DFT_MATMUL_ENV)


# One bounded LRU holds every host-side constant: DFT bases keyed by
# (kind, geometry, window bytes), multipliers and banks by (kind,
# geometry).  64 entries cover a steady state while keeping eviction
# observable.
_host_cache = ConstantCache(64)
obs.register_cache("spectral_host_lru", _host_cache.info)


def _cached_host(key, build):
    """LRU lookup of a host-side constant; ``build()`` makes it on a
    miss."""
    return _host_cache.get(key, build)


# Device-resident twin: the host LRU dedupes the construction of a
# constant, this one its copy to the device (67 MB per stft at
# L = 4096).  A smaller bound, because entries pin device memory.
_device_cache = ConstantCache(16)
obs.register_cache("spectral_device_lru", _device_cache.info)


def _cached_device(key, dev, build_device):
    """LRU lookup of a constant on device ``dev`` (the device joins the
    key); ``build_device()`` copies it there on a miss."""
    return _device_cache.get(tuple(key) + (str(torch.device(dev)),),
                             build_device)


def _to_device(host, dev):
    return torch.as_tensor(np.ascontiguousarray(host), device=dev)


def _device_window(window, dev):
    """The float32 window on ``dev``, copied there once."""
    window = np.asarray(window, np.float32)
    return _cached_device(("window", len(window), window.tobytes()), dev,
                          lambda: _to_device(window, dev))


def hann_window(frame_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window.  Squared windows overlap-add to a constant
    for hop <= frame_length / 4; at hop = frame_length / 2 the envelope
    ripples but stays strictly positive, so the normalized overlap-add
    in :func:`istft` is still exact."""
    n = np.arange(frame_length)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / frame_length)).astype(dtype)


def frame_count(n: int, frame_length: int, hop: int) -> int:
    """Number of full frames a length-``n`` signal yields (no padding)."""
    if n < frame_length:
        return 0
    return 1 + (n - frame_length) // hop


def _check_stft_args(n, frame_length, hop):
    if frame_length <= 0 or hop <= 0:
        raise ValueError(f"frame_length and hop must be positive, got "
                         f"{frame_length} and {hop}")
    if hop > frame_length:
        raise ValueError(
            f"hop {hop} > frame_length {frame_length} drops samples "
            "(and makes ISTFT ill-posed)")
    if frame_count(n, frame_length, hop) == 0:
        raise ValueError(f"signal length {n} < frame_length {frame_length}")


def _frame_indices(n, frame_length, hop):
    frames = frame_count(n, frame_length, hop)
    return (np.arange(frames)[:, None] * hop
            + np.arange(frame_length)[None, :])


def _resolve_window(window, length: int, dtype=np.float32) -> np.ndarray:
    """Window argument -> ``length`` samples: None = periodic Hann,
    a :func:`waveforms.get_window` name or ``(name, param)`` tuple
    (scipy convention; NOTE get_window is symmetric where scipy's
    spectral default is periodic), or an explicit array."""
    if window is None:
        return hann_window(length, dtype)
    # only str/tuple are window SPECS (scipy's convention) — a numeric
    # list is window samples and falls through to the array path
    if isinstance(window, (str, tuple)):
        from veles.simd_tpu_torch.ops.waveforms import get_window

        return get_window(window, length).astype(dtype)
    window = _host(window, dtype)
    if window.shape != (length,):
        raise ValueError(f"window shape {window.shape} != ({length},)")
    return window


def _framing_r(frame_length: int, hop: int) -> int:
    """The JAX package's reshape-decomposition order ``r = frame_length
    // hop`` when that path applies (a dividing hop, r <= 16), else 0
    (gather).  Here it only names the geometry class in telemetry:
    :func:`_take_frames` is one ``unfold`` view either way."""
    r = frame_length // hop if frame_length % hop == 0 else 0
    return r if 1 <= r <= 16 else 0


def _framing_path(frame_length: int, hop: int) -> str:
    """Telemetry name for the framing decision, recorded per call by
    the public entry points."""
    return ("reshape_interleave" if _framing_r(frame_length, hop)
            else "gather")


def _take_frames(x, frame_length, hop):
    """``[..., n] -> [..., frames, frame_length]``: ``Tensor.unfold``,
    a strided view of ``x`` (nothing is copied until a consumer needs
    contiguous frames)."""
    return x.unfold(-1, int(frame_length), int(hop))


def _rdft_basis(frame_length: int, window) -> np.ndarray:
    """``[frame_length, 2*bins]`` real-DFT analysis basis with the
    window folded in: ``frames @ basis`` gives ``[Re X | Im X]``
    (``Re X[k] = sum_n w[n] f[n] cos(2 pi n k / L)``, ``Im X[k] =
    -sum_n w[n] f[n] sin(...)``).  LRU-cached per (frame_length,
    window)."""
    L = int(frame_length)
    window = np.asarray(window, np.float32)
    key = ("rdft_fwd", L, window.tobytes())

    def build():
        bins = L // 2 + 1
        n = np.arange(L)[:, None]
        k = np.arange(bins)[None, :]
        ang = 2.0 * np.pi * n * k / L
        w = np.asarray(window, np.float64)[:, None]
        return np.concatenate([w * np.cos(ang), -w * np.sin(ang)],
                              axis=1).astype(np.float32)

    return _cached_host(key, build)


def _rdft_inv_basis(frame_length: int, window) -> np.ndarray:
    """``[2*bins, frame_length]`` real-DFT synthesis basis with the
    window folded in: ``[Re X | Im X] @ inv_basis`` gives the
    window-multiplied time frame ``w[n] * (1/L) [X[0] + 2 sum_k (Re
    cos - Im sin) + X[Nyq] (-1)^n]`` — the irfft as one matmul,
    feeding the overlap-add."""
    L = int(frame_length)
    window = np.asarray(window, np.float32)
    key = ("rdft_inv", L, window.tobytes())

    def build():
        bins = L // 2 + 1
        alpha = np.full(bins, 2.0)
        alpha[0] = 1.0
        if L % 2 == 0:
            alpha[-1] = 1.0
        k = np.arange(bins)[:, None]
        n = np.arange(L)[None, :]
        ang = 2.0 * np.pi * k * n / L
        w = np.asarray(window, np.float64)[None, :]
        scale = (alpha / L)[:, None]
        return np.concatenate([scale * np.cos(ang) * w,
                               -scale * np.sin(ang) * w],
                              axis=0).astype(np.float32)

    return _cached_host(key, build)


def _device_basis(kind, length, window, build_host, dev):
    """Device-cached windowed basis: construction deduped by the host
    LRU (inside ``build_host``), the copy to ``dev`` here."""
    window = np.asarray(window, np.float32)
    key = (kind, int(length), window.tobytes())
    return _cached_device(key, dev, lambda: _to_device(build_host(), dev))


# ---------------------------------------------------------------------------
# Cooley-Tukey factorized matmul DFT (per-factor DFT bases + twiddles)
# ---------------------------------------------------------------------------


def ct_factor(n: int, max_factor: int | None = None,
              multiple: int = 1):
    """Balanced Cooley-Tukey split ``n = n1 * n2`` with both factors
    ``<= max_factor`` (default :data:`AUTO_DFT_MATMUL_MAX_FRAME`, the
    basis-residency bound) and both divisible by ``multiple``.  Returns
    ``(n1, n2)`` with ``n1 >= n2`` minimizing ``max(n1, n2)``, or
    ``None`` when no such factorization exists (prime ``n``, or ``n``
    too large for the factor bound)."""
    n = int(n)
    if max_factor is None:
        max_factor = AUTO_DFT_MATMUL_MAX_FRAME
    multiple = max(1, int(multiple))
    if n < 4:
        return None
    best = None
    d = 1
    while d * d <= n:
        if n % d == 0:
            for n2 in (d, n // d):
                n1 = n // n2
                if n1 < n2:
                    continue
                if n1 > max_factor or n2 < 2:
                    continue
                if n1 % multiple or n2 % multiple:
                    continue
                if best is None or n1 < best[0]:
                    best = (n1, n2)
        d += 1
    return best


def dft_basis_parts(n: int):
    """Host-cached ``(cos, sin)`` float32 ``[n, n]`` pair of the dense
    DFT basis angles ``2 pi j k / n`` — the forward basis is
    ``cos - i sin``, the inverse ``(cos + i sin) / n``."""
    n = int(n)

    def build():
        j = np.arange(n, dtype=np.float64)
        ang = 2.0 * np.pi * np.outer(j, j) / n
        return (np.cos(ang).astype(np.float32),
                np.sin(ang).astype(np.float32))

    return _cached_host(("dft_parts", n), build)


def twiddle_parts(n1: int, n2: int):
    """Host-cached ``(cos, sin)`` float32 ``[n2, n1]`` twiddle grid
    ``2 pi k2 n1_idx / (n1 n2)`` — the inter-stage factor of the
    ``n = n1 * n2`` Cooley-Tukey factorization."""
    n1, n2 = int(n1), int(n2)

    def build():
        ang = (2.0 * np.pi / (n1 * n2)
               * np.outer(np.arange(n2, dtype=np.float64),
                          np.arange(n1, dtype=np.float64)))
        return (np.cos(ang).astype(np.float32),
                np.sin(ang).astype(np.float32))

    return _cached_host(("twiddle", n1, n2), build)


def ct_basis_parts(n1: int, n2: int):
    """The 6-tuple of float32 constants one ``n = n1 * n2`` factorized
    DFT needs: ``(cos2, sin2, cos1, sin1, twc, tws)`` — stage bases
    ``[n2, n2]`` / ``[n1, n1]`` plus the ``[n2, n1]`` twiddle grid.
    Serves forward and inverse (:func:`ct_apply`)."""
    c2, s2 = dft_basis_parts(n2)
    c1, s1 = dft_basis_parts(n1)
    twc, tws = twiddle_parts(n1, n2)
    return c2, s2, c1, s1, twc, tws


def ct_basis_device(n1: int, n2: int, dev=None):
    """:func:`ct_basis_parts` on device ``dev`` (default the configured
    device), copied there once (host LRU for construction, device LRU
    for the copy)."""
    dev = device() if dev is None else torch.device(dev)
    return _cached_device(
        ("ct_basis", int(n1), int(n2)), dev,
        lambda: tuple(_to_device(a, dev) for a in ct_basis_parts(n1, n2)))


def _ct_stage(vre, vim, cos, sin, sign, spec):
    """One DFT stage as real fp32 matmuls: contract ``vre/vim`` with
    the ``cos + i * sign * sin`` basis along the axis named by the
    einsum ``spec``.  ``vim=None`` means real input (two matmuls
    instead of four)."""
    def e(a, b):
        return prx.p_einsum(spec, a, b)

    if vim is None:
        return e(vre, cos), sign * e(vre, sin)
    return (e(vre, cos) - sign * e(vim, sin),
            sign * e(vre, sin) + e(vim, cos))


def ct_apply(x, n1: int, n2: int, parts, inverse: bool = False):
    """Length-``n1*n2`` Cooley-Tukey DFT along the LAST axis as two
    dense matmul stages and a twiddle multiply.  ``x`` is a real or
    complex tensor; ``parts`` from :func:`ct_basis_device`.  Returns
    ``(re, im)`` float32 tensors."""
    c2, s2, c1, s1, twc, tws = parts
    n1, n2 = int(n1), int(n2)
    sign = 1.0 if inverse else -1.0
    if torch.is_complex(x):
        xre, xim = x.real, x.imag
    else:
        xre, xim = x, None
    if inverse:
        # inverse = the same pipeline with stage roles swapped (input
        # viewed [n1, n2], stage 1 over the n1 axis) and the twiddle
        # grid transposed; 1/n fold applied at the end
        ga, gb = n1, n2
        ca, sa, cb, sb = c1, s1, c2, s2
        twc_g, tws_g = twc.T, tws.T
    else:
        ga, gb = n2, n1
        ca, sa, cb, sb = c2, s2, c1, s1
        twc_g, tws_g = twc, tws
    lead = tuple(xre.shape[:-1])
    vre = xre.reshape(lead + (ga, gb))
    vim = xim.reshape(lead + (ga, gb)) if xim is not None else None
    # stage 1: length-ga DFT down the -2 axis
    yre, yim = _ct_stage(vre, vim, ca, sa, sign, "...gf,gh->...hf")
    # twiddle: elementwise [ga, gb] grid
    tre, tim = twc_g, sign * tws_g
    zre = yre * tre - yim * tim
    zim = yre * tim + yim * tre
    # stage 2: length-gb DFT along the last axis
    wre, wim = _ct_stage(zre, zim, cb, sb, sign, "...hf,fk->...hk")
    # natural order: out[k_b * ga + k_a] = w[k_a, k_b]
    wre = wre.transpose(-1, -2).reshape(lead + (ga * gb,))
    wim = wim.transpose(-1, -2).reshape(lead + (ga * gb,))
    if inverse:
        scale = float(np.float32(1.0 / (n1 * n2)))
        return wre * scale, wim * scale
    return wre, wim


def hermitian_extend(spec, n: int):
    """Full length-``n`` spectrum from the one-sided ``n//2 + 1`` bins
    of a real signal (``X[k] = conj(X[n-k])``)."""
    bins = n // 2 + 1
    tail = spec[..., 1:n - bins + 1].conj().flip(-1)
    return torch.cat([spec, tail], dim=-1)


# ---------------------------------------------------------------------------
# STFT
# ---------------------------------------------------------------------------


def _stft_xla(x, window, frame_length, hop):
    frames = _take_frames(x, frame_length, hop)
    return torch.fft.rfft(frames * window, dim=-1)


def _stft_rdft(x, basis, frame_length, hop):
    frames = _take_frames(x, frame_length, hop)
    out = prx.p_einsum("...fl,lb->...fb", frames, basis)
    bins = frame_length // 2 + 1
    return torch.complex(out[..., :bins], out[..., bins:])


# The spectral candidate-route tables (runtime/routing.py): priority
# order is the static selection order, and the predicates are the one
# home of the route constants.
_STFT_FAMILY = routing.family("stft", (
    routing.Route(
        "cuda_fused",
        predicate=lambda frame_length, hop, frames=0, cuda=False, **_: (
            _ck.on_card(cuda)
            and frame_length % hop == 0 and hop % 128 == 0
            and frame_length // hop >= 2
            and frames >= _ck.STFT_MIN_FRAMES
            and _ck.fits_smem_stft(frame_length, hop)),
        disable_env=_ck.STFT_DISABLE_ENV,
        doc="fused STFT kernel (csrc/stft.cu): a shared-memory FFT per "
            "frame over a span of frames staged once, the frames "
            "tensor never built"),
    routing.Route(
        "rdft_matmul",
        predicate=lambda frame_length, **_:
            frame_length <= AUTO_DFT_MATMUL_MAX_FRAME,
        disable_env=_DFT_MATMUL_ENV,
        doc="precomputed real-DFT basis matmul in fp32 (window folded "
            "in, basis LRU-cached per geometry)"),
    routing.Route(
        "xla_fft",
        doc="torch.fft.rfft of the windowed frames — the long-frame "
            "terminal fallback"),
))

_ISTFT_FAMILY = routing.family("istft", (
    routing.Route(
        "rdft_matmul",
        predicate=lambda frame_length, **_:
            frame_length <= AUTO_DFT_MATMUL_MAX_FRAME,
        disable_env=_DFT_MATMUL_ENV,
        doc="inverse-basis matmul feeding the shared overlap-add"),
    routing.Route("xla_fft", doc="torch.fft.irfft + overlap-add"),
))

_HILBERT_FAMILY = routing.family("hilbert", (
    routing.Route(
        "matmul_dft",
        predicate=lambda n, **_: n <= HILBERT_MATMUL_MAX_N,
        disable_env=_DFT_MATMUL_ENV,
        doc="dense circulant analytic-signal operator as two fp32 "
            "matmuls"),
    routing.Route("xla_fft", doc="fft -> multiplier -> ifft"),
))

_CWT_FAMILY = routing.family("morlet_cwt", (
    routing.Route(
        "matmul_dft",
        predicate=lambda n, **_: n <= CWT_MATMUL_MAX_N,
        disable_env=_DFT_MATMUL_ENV,
        doc="positive-frequency DFT basis pair as dense fp32 matmuls"),
    routing.Route(
        "ct_matmul",
        predicate=lambda n, **_: (n > CWT_MATMUL_MAX_N
                                  and ct_factor(n) is not None),
        disable_env=_DFT_MATMUL_ENV,
        doc="Cooley-Tukey factorized matmul DFT (two per-factor "
            "stages + twiddle), for transform sizes past the dense "
            "basis-residency cutoff"),
    routing.Route("xla_fft", doc="batched fft -> bank -> ifft"),
))


def _cuda_flag(cuda):
    """``cuda=None`` means the configured device is a present card."""
    return on_cuda() if cuda is None else bool(cuda)


def _use_matmul_dft(frame_length: int) -> bool:
    """Route a spectral transform through the precomputed real-DFT
    basis matmul — a thin delegate into the ``stft`` table, where the
    ``AUTO_DFT_MATMUL_MAX_FRAME`` bound and the
    ``VELES_SIMD_DISABLE_DFT_MATMUL`` opt-out live."""
    return _STFT_FAMILY.gate("rdft_matmul",
                             frame_length=int(frame_length))


def _use_cuda_stft(frame_length: int, hop: int, frames: int,
                   cuda=None) -> bool:
    """Route STFT through the fused kernel (:func:`~veles.
    simd_tpu_torch.ops.cuda_kernels.stft_cuda`): a thin delegate into
    the ``stft`` table (operand on a card, dividing 128-multiple hop,
    at least two hops a frame, enough frames, shared-memory admission,
    and the ``VELES_SIMD_DISABLE_STFT_CUDA`` opt-out)."""
    return _STFT_FAMILY.gate(
        "cuda_fused", frame_length=int(frame_length), hop=int(hop),
        frames=int(frames), cuda=_cuda_flag(cuda))


def _select_stft_route(frame_length: int, hop: int, frames: int,
                       cuda=None) -> str:
    """The static stft route decision, in table priority order (the
    one home: :func:`stft` and ``batched.batched_stft`` ask here).
    ``cuda`` says whether the operand lies on a card (None: the
    configured device)."""
    return _STFT_FAMILY.static_select(
        frame_length=int(frame_length), hop=int(hop),
        frames=int(frames), cuda=_cuda_flag(cuda))


def _stft_tune_class(frame_length: int, hop: int, frames: int,
                     rows: int) -> dict:
    """The stft geometry class shared by :func:`stft` and
    ``batched.batched_stft``: frames bucketed at the fused gate's
    threshold (the only frames-dependence any route has), rows
    pow2-bucketed."""
    return {"frame_length": int(frame_length), "hop": int(hop),
            "rows": routing.pow2_bucket(int(rows)),
            "frames_class": (_ck.STFT_MIN_FRAMES
                             if frames >= _ck.STFT_MIN_FRAMES else 0)}


def _stft_route_for(frame_length: int, hop: int, frames: int,
                    rows: int, cuda=None) -> str:
    """Engine-selected stft route (the static prior: the port has no
    tune cache yet) for the true frame count and the operand's
    device."""
    return _STFT_FAMILY.select(
        eligible=_STFT_FAMILY.eligible(
            frame_length=int(frame_length), hop=int(hop),
            frames=int(frames), cuda=_cuda_flag(cuda)),
        **_stft_tune_class(frame_length, hop, frames, rows))


def _run_stft_xla(x, window, frame_length, hop):
    return _stft_xla(x, _device_window(window, x.device), frame_length,
                     hop)


def _run_stft_rdft(x, window, frame_length, hop):
    basis = _device_basis("rdft_fwd", frame_length, window,
                          lambda: _rdft_basis(frame_length, window),
                          x.device)
    return _stft_rdft(x, basis, frame_length, hop)


def _run_stft_cuda(x, window, frame_length, hop):
    """The fused-kernel route.  A failed launch raises: there is no
    demotion to another route."""
    return _ck.stft_cuda(x.contiguous(), _device_window(window, x.device),
                         frame_length, hop)


_STFT_ROUTES = {"xla_fft": _run_stft_xla,
                "rdft_matmul": _run_stft_rdft,
                "cuda_fused": _run_stft_cuda}


# -- streaming STFT hooks (the pipeline compiler's state-export API) --------

def stft_stream_carry(frame_length: int, hop: int) -> int:
    """Input-history samples a streaming STFT carries between blocks:
    ``frame_length - hop`` (the inter-frame overlap).  Zero-seeded at
    stream start, so the stream computes the STFT of the zero-prefixed
    signal: streamed frame ``f`` equals one-shot frame
    ``f - (frame_length/hop - 1)`` once real samples fill the carry.
    Requires ``hop | frame_length`` and ``hop | block``."""
    frame_length, hop = int(frame_length), int(hop)
    _check_stft_args(frame_length, frame_length, hop)
    if frame_length % hop != 0:
        raise ValueError(
            f"streaming STFT needs hop {hop} dividing frame_length "
            f"{frame_length} (frame-aligned carry)")
    return frame_length - hop


def select_stft_stream_route(frame_length: int, hop: int, frames: int,
                             tune_geom: dict | None = None) -> str:
    """Route for the streaming STFT stage — the pipeline compiler's
    hook into the ``stft`` table.  Eligibility is restricted to
    ``rdft_matmul`` / ``xla_fft``: the fused kernel is excluded, as the
    JAX package excludes its own.  ``tune_geom`` is accepted for
    parity (the port has no tune cache)."""
    del tune_geom
    eligible = [name for name in _STFT_FAMILY.eligible(
        frame_length=int(frame_length), hop=int(hop),
        frames=int(frames)) if name != "cuda_fused"]
    return _STFT_FAMILY.select(eligible=eligible or ["xla_fft"])


def stft_stream_step(x_ext, frame_length: int, hop: int, window,
                     route: str):
    """One-block STFT step: ``x_ext[..., (L - hop) + block]`` (carry +
    new chunk) -> complex64 ``[..., block/hop, L//2 + 1]``, through the
    same route cores one-shot :func:`stft` dispatches."""
    x_ext = as_f32(x_ext)
    if route == "rdft_matmul":
        return _run_stft_rdft(x_ext, window, frame_length, hop)
    return _run_stft_xla(x_ext, window, frame_length, hop)


def stft_stream_oracle(x, frame_length: int, hop: int, window=None):
    """NumPy float64 one-shot oracle of the STREAMING frame grid (the
    zero-prefixed signal's STFT)."""
    x = _host(x, np.float64)
    carry = stft_stream_carry(frame_length, hop)
    pre = np.zeros(x.shape[:-1] + (carry,), np.float64)
    return stft_na(np.concatenate([pre, x], axis=-1), frame_length,
                   hop, window)


def stft(x, frame_length: int, hop: int, window=None, simd=None,
         route=None):
    """Short-time Fourier transform.

    ``x[..., n] -> complex64 [..., frames, frame_length // 2 + 1]`` with
    ``frames = 1 + (n - frame_length) // hop`` (no padding — trailing
    samples short of a full frame are dropped, symmetric with
    :func:`istft`).  ``window`` defaults to the periodic Hann window.

    ``route`` forces one of ``cuda_fused`` / ``rdft_matmul`` /
    ``xla_fft`` (None auto-selects via :func:`_stft_route_for`); the
    chosen route is recorded as a ``stft_route`` decision event.  A
    forced route raises on failure; it never degrades.
    """
    n = int(np.shape(x)[-1])
    _check_stft_args(n, frame_length, hop)
    window = _resolve_window(window, frame_length)
    if not resolve_simd(simd, op="stft"):
        return stft_na(x, frame_length, hop, window).astype(np.complex64)
    xt = as_f32(x)
    frames = frame_count(n, frame_length, hop)
    forced = route is not None
    if forced and route not in _STFT_ROUTES:
        raise ValueError(
            f"route must be one of {sorted(_STFT_ROUTES)}, "
            f"got {route!r}")
    if forced:
        chosen = route
    else:
        rows = int(np.prod(xt.shape[:-1])) if xt.ndim > 1 else 1
        chosen = _stft_route_for(frame_length, hop, frames, rows,
                                 cuda=xt.is_cuda)
    path = _framing_path(frame_length, hop)
    obs.record_decision(
        "stft_route", chosen, n=n, frame_length=int(frame_length),
        hop=int(hop), frames=int(frames), forced=forced)
    # the framing-path decision stays the LAST event (the telemetry
    # contract of the JAX package's test_obs.py)
    obs.record_decision(
        "stft", path, n=n, frame_length=int(frame_length),
        hop=int(hop))
    with obs.span("stft.dispatch", route=chosen, path=path):
        return _STFT_ROUTES[chosen](xt, window, int(frame_length),
                                    int(hop))


def stft_na(x, frame_length: int, hop: int, window=None):
    """NumPy float64 oracle twin of :func:`stft` (complex128 out)."""
    x = _host(x, np.float64)
    _check_stft_args(x.shape[-1], frame_length, hop)
    window = _resolve_window(window, frame_length, np.float64)
    idx = _frame_indices(x.shape[-1], frame_length, hop)
    frames = x[..., idx] * window
    return np.fft.rfft(frames, axis=-1)


# ---------------------------------------------------------------------------
# ISTFT and spectrogram
# ---------------------------------------------------------------------------


def _ola_envelope(n, frame_length, hop, window):
    """Sum of squared windows at each output sample (COLA envelope)."""
    idx = _frame_indices(n, frame_length, hop)
    env = np.zeros(n, np.float64)
    np.add.at(env, idx, (np.asarray(window, np.float64) ** 2)[None, :])
    return env


def _env_inv(n, frame_length, hop, window):
    """Pseudo-inverse of the COLA envelope (float64): zero where the
    window overlap vanishes, 1/env elsewhere.  The single definition the
    device ISTFT and the oracle share."""
    env = _ola_envelope(n, frame_length, hop, window)
    return np.where(env > 1e-8, 1.0 / np.maximum(env, 1e-8), 0.0)


def _overlap_add(frames, n, frame_length, hop):
    """``[..., F, frame_length] -> [..., n]`` overlap-add, the adjoint
    of :func:`_take_frames`: one ``F.fold`` (col2im), which sums the
    overlapping frames at each sample in frame order."""
    lead = tuple(frames.shape[:-2])
    cols = frames.reshape((-1,) + tuple(frames.shape[-2:]))
    out = F.fold(cols.transpose(1, 2), output_size=(1, int(n)),
                 kernel_size=(1, int(frame_length)),
                 stride=(1, int(hop)))
    return out.reshape(lead + (int(n),))


def _run_istft_xla(spec, window, env_inv, n, frame_length, hop):
    frames = (torch.fft.irfft(spec, frame_length, dim=-1)
              * _device_window(window, spec.device))
    return _overlap_add(frames, n, frame_length, hop) * env_inv


def _run_istft_rdft(spec, window, env_inv, n, frame_length, hop):
    inv_basis = _device_basis(
        "rdft_inv", frame_length, window,
        lambda: _rdft_inv_basis(frame_length, window), spec.device)
    parts = torch.cat([spec.real, spec.imag], dim=-1)
    frames = prx.p_einsum("...fb,bl->...fl", parts, inv_basis)
    return _overlap_add(frames, n, frame_length, hop) * env_inv


_ISTFT_ROUTES = {"xla_fft": _run_istft_xla,
                 "rdft_matmul": _run_istft_rdft}


def istft(spec, n: int, frame_length: int, hop: int, window=None,
          simd=None, route=None):
    """Inverse STFT by windowed overlap-add with COLA normalization.

    Reconstructs the length-``n`` signal from ``stft(x, ...)`` output.
    Exact (to f32 round-off) wherever the window-overlap envelope is
    nonzero; with the default Hann window and ``hop = frame_length /
    2**k`` that is every sample except the first/last ``frame_length -
    hop`` (where fewer windows overlap — there the least-squares
    estimate is still returned, normalized by the partial envelope).

    ``route`` forces ``rdft_matmul`` (inverse-basis matmul feeding the
    overlap-add) or ``xla_fft`` (None auto-selects; the chosen route is
    recorded as an ``istft_route`` decision event).
    """
    _check_stft_args(n, frame_length, hop)
    window = _resolve_window(window, frame_length)
    env_inv = _env_inv(n, frame_length, hop, window).astype(np.float32)
    frames = frame_count(n, frame_length, hop)
    shape = tuple(np.shape(spec))
    if shape[-2:] != (frames, frame_length // 2 + 1):
        raise ValueError(
            f"spec shape {shape[-2:]} inconsistent with n={n}, "
            f"frame_length={frame_length}, hop={hop} (expect "
            f"{(frames, frame_length // 2 + 1)})")
    if not resolve_simd(simd, op="istft"):
        return istft_na(spec, n, frame_length, hop,
                        window).astype(np.float32)
    spec_t = as_c64(spec)
    forced = route is not None
    if forced and route not in _ISTFT_ROUTES:
        raise ValueError(
            f"route must be one of {sorted(_ISTFT_ROUTES)}, "
            f"got {route!r}")
    if forced:
        chosen = route
    else:
        rows = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
        chosen = _ISTFT_FAMILY.select(
            frame_length=int(frame_length), hop=int(hop),
            rows=routing.pow2_bucket(rows))
    # the adjoint decomposition: framing gather <-> overlap-add
    # scatter, framing reshape <-> per-phase reshape adds
    path = ("scatter" if _framing_path(frame_length, hop) == "gather"
            else "reshape_overlap_add")
    obs.record_decision(
        "istft_route", chosen, n=int(n),
        frame_length=int(frame_length), hop=int(hop), forced=forced)
    # the overlap-add path decision stays the LAST event
    obs.record_decision(
        "istft", path, n=int(n), frame_length=int(frame_length),
        hop=int(hop))
    with obs.span("istft.dispatch", route=chosen, path=path):
        return _ISTFT_ROUTES[chosen](
            spec_t, window, _to_device(env_inv, spec_t.device), int(n),
            int(frame_length), int(hop))


def istft_na(spec, n: int, frame_length: int, hop: int, window=None):
    """NumPy float64 oracle twin of :func:`istft`."""
    _check_stft_args(n, frame_length, hop)
    window = _resolve_window(window, frame_length, np.float64)
    spec = _host(spec)
    frames = np.fft.irfft(spec, frame_length, axis=-1) * window
    idx = _frame_indices(n, frame_length, hop)
    out = np.zeros(spec.shape[:-2] + (n,), np.float64)
    # np.add.at over the leading batch dims one frame-row at a time
    for f in range(idx.shape[0]):
        out[..., idx[f]] += frames[..., f, :]
    return out * _env_inv(n, frame_length, hop, window)


def spectrogram(x, frame_length: int, hop: int, window=None, simd=None,
                route=None):
    """Power spectrogram ``|STFT|^2`` -> f32 [..., frames, bins].
    ``route`` passes through to :func:`stft`."""
    s = stft(x, frame_length, hop, window, simd=simd, route=route)
    if resolve_simd(simd, op="spectrogram"):
        return (s.real ** 2 + s.imag ** 2).to(torch.float32)
    return (np.abs(s) ** 2).astype(np.float32)


def spectrogram_na(x, frame_length: int, hop: int, window=None):
    s = stft_na(x, frame_length, hop, window)
    return np.abs(s) ** 2


# ---------------------------------------------------------------------------
# analytic signal
# ---------------------------------------------------------------------------


def _analytic_multiplier(n: int) -> np.ndarray:
    """Frequency-domain step for the analytic signal: keep DC (and
    Nyquist when n is even) at 1, double positive frequencies, zero the
    negatives.  Cached per length."""
    def build():
        h = np.zeros(n, np.float32)
        h[0] = 1.0
        if n % 2 == 0:
            h[n // 2] = 1.0
            h[1:n // 2] = 2.0
        else:
            h[1:(n + 1) // 2] = 2.0
        return h

    return _cached_host(("analytic_mult", int(n)), build)


def _hilbert_basis(n: int) -> np.ndarray:
    """``[2, n, n]`` real/imag circulant of the analytic-signal
    operator ``ifft(diag(mult) fft)``: row a, column b holds
    ``ifft(mult)[(b - a) mod n]``, so the whole transform is two dense
    ``[n, n]`` matmuls."""
    def build():
        m = np.fft.ifft(np.asarray(_analytic_multiplier(n), np.float64))
        idx = (np.arange(n)[None, :] - np.arange(n)[:, None]) % n
        circ = m[idx]
        return np.stack([circ.real, circ.imag]).astype(np.float32)

    return _cached_host(("hilbert_matmul", int(n)), build)


def _run_hilbert_matmul(x):
    n = int(x.shape[-1])
    basis = _cached_device(("hilbert_matmul", n), x.device,
                           lambda: _to_device(_hilbert_basis(n), x.device))
    re = prx.p_einsum("...n,nm->...m", x, basis[0])
    im = prx.p_einsum("...n,nm->...m", x, basis[1])
    return torch.complex(re, im)


def _run_hilbert_xla(x):
    n = int(x.shape[-1])
    mult = _cached_device(
        ("analytic_mult", n), x.device,
        lambda: _to_device(_analytic_multiplier(n), x.device))
    return torch.fft.ifft(torch.fft.fft(x, dim=-1) * mult, dim=-1)


_HILBERT_ROUTES = {"matmul_dft": _run_hilbert_matmul,
                   "xla_fft": _run_hilbert_xla}


def hilbert(x, simd=None, route=None):
    """Analytic signal ``x + i * H[x]`` (complex64 [..., n]).

    The imaginary part is the Hilbert transform; :func:`envelope` is its
    magnitude.  Frequency-domain construction (zero negative
    frequencies), the standard DFT definition.  Short signals
    (``n <= HILBERT_MATMUL_MAX_N``) route through the dense circulant
    operator (``matmul_dft``); ``route`` forces either path.
    """
    n = int(np.shape(x)[-1])
    if n == 0:
        raise ValueError("empty signal")
    if not resolve_simd(simd, op="hilbert"):
        return hilbert_na(x).astype(np.complex64)
    xt = as_f32(x)
    forced = route is not None
    if forced and route not in _HILBERT_ROUTES:
        raise ValueError(
            f"route must be one of {sorted(_HILBERT_ROUTES)}, "
            f"got {route!r}")
    if forced:
        chosen = route
    else:
        rows = int(np.prod(xt.shape[:-1])) if xt.ndim > 1 else 1
        chosen = _HILBERT_FAMILY.select(n=n,
                                        rows=routing.pow2_bucket(rows))
    obs.record_decision("hilbert_route", chosen, n=n, forced=forced)
    with obs.span("hilbert.dispatch", route=chosen):
        return _HILBERT_ROUTES[chosen](xt)


def hilbert_na(x):
    """NumPy float64 oracle twin of :func:`hilbert` (complex128)."""
    x = _host(x, np.float64)
    return np.fft.ifft(np.fft.fft(x, axis=-1)
                       * _analytic_multiplier(x.shape[-1]), axis=-1)


def envelope(x, simd=None):
    """Instantaneous amplitude ``|analytic(x)|`` (f32 [..., n]) — the
    classic matched-filter post-processing step."""
    a = hilbert(x, simd=simd)
    if resolve_simd(simd, op="envelope"):
        return a.abs().to(torch.float32)
    return np.abs(a).astype(np.float32)


def envelope_na(x):
    return np.abs(hilbert_na(x))


# ---------------------------------------------------------------------------
# continuous wavelet transform
# ---------------------------------------------------------------------------


def _morlet_hat(scales, n, w0):
    """Frequency response of the (analytic) Morlet wavelet at each scale:
    ``pi^-1/4 * exp(-(s*omega - w0)^2 / 2)`` for positive omega, with the
    L2 normalization ``sqrt(2 pi s / dt)`` (dt = 1).  Cached per
    (scales, n, w0)."""
    scales = np.asarray(scales, np.float64)
    key = ("morlet_hat", scales.tobytes(), int(n), float(w0))

    def build():
        omega = 2 * np.pi * np.fft.fftfreq(n)  # [n]
        s = scales[:, None]  # [S, 1]
        hat = (np.pi ** -0.25) * np.exp(-0.5 * (s * omega - w0) ** 2)
        hat *= (omega > 0)  # analytic: positive frequencies only
        hat *= np.sqrt(2 * np.pi * s)
        return hat  # [S, n] float64

    return _cached_host(key, build)


def _cwt_basis(n: int):
    """Positive-frequency DFT basis pair for the short-signal matmul
    CWT: ``fwd`` [n, 2K] maps x to ``[Re X | Im X]`` at the K strictly
    positive frequencies (the only ones the analytic Morlet bank keeps
    — ``_morlet_hat`` zeroes omega <= 0), ``ic``/``is_`` [K, n] are the
    cos/sin inverse-DFT factors with the 1/n fold.  Cached per n."""
    def build():
        kpos = np.arange(1, (n + 1) // 2)
        m = np.arange(n)
        ang = 2.0 * np.pi * m[:, None] * kpos[None, :] / n
        fwd = np.concatenate([np.cos(ang), -np.sin(ang)],
                             axis=1).astype(np.float32)
        angi = 2.0 * np.pi * kpos[:, None] * m[None, :] / n
        ic = (np.cos(angi) / n).astype(np.float32)
        is_ = (np.sin(angi) / n).astype(np.float32)
        return fwd, ic, is_

    return _cached_host(("cwt_matmul", int(n)), build)


def _run_cwt_matmul(x, hat):
    n = int(x.shape[-1])
    fwd, ic, is_ = _cached_device(
        ("cwt_matmul", n), x.device,
        lambda: tuple(_to_device(a, x.device) for a in _cwt_basis(n)))
    K = ic.shape[0]
    hat = _to_device(hat[:, 1:1 + K].astype(np.float32), x.device)
    xf = prx.p_einsum("...n,nk->...k", x, fwd)
    a = xf[..., None, :K] * hat          # [..., S, K] Re X * hat
    b = xf[..., None, K:] * hat          # [..., S, K] Im X * hat
    e = prx.p_einsum
    out_re = (e("...sk,km->...sm", a, ic)
              - e("...sk,km->...sm", b, is_))
    out_im = (e("...sk,km->...sm", a, is_)
              + e("...sk,km->...sm", b, ic))
    return torch.complex(out_re, out_im)


def _run_cwt_xla(x, hat):
    hat = _to_device(hat.astype(np.float32), x.device)
    spec = torch.fft.fft(x, dim=-1)
    return torch.fft.ifft(spec[..., None, :] * hat, dim=-1)


def _run_cwt_ct(x, hat):
    n = int(x.shape[-1])
    n1, n2 = ct_factor(n)
    parts = ct_basis_device(n1, n2, x.device)
    hat = _to_device(hat.astype(np.float32), x.device)
    fre, fim = ct_apply(x, n1, n2, parts)
    prod = torch.complex(fre, fim)[..., None, :] * hat   # hat real [S, n]
    re, im = ct_apply(prod, n1, n2, parts, inverse=True)
    return torch.complex(re, im)


_CWT_ROUTES = {"matmul_dft": _run_cwt_matmul,
               "ct_matmul": _run_cwt_ct,
               "xla_fft": _run_cwt_xla}


def morlet_cwt(x, scales, w0: float = 6.0, simd=None, route=None):
    """Continuous wavelet transform with the analytic Morlet wavelet.

    ``x[..., n] -> complex64 [..., scales, n]``.  ``scales`` are in
    samples (pseudo-frequency ≈ ``w0 / (2 pi s)`` cycles/sample).  The
    whole scale bank is one batched ``fft -> multiply -> ifft``; the
    ``[S, n]`` wavelet bank is a host-side constant.  Short signals
    (``n <= CWT_MATMUL_MAX_N``) route through the positive-frequency
    DFT basis pair as dense matmuls (``matmul_dft``); longer
    factorizable ``n`` ride the Cooley-Tukey factorized matmul DFT
    (``ct_matmul``); ``route`` forces any path.
    """
    scales = np.atleast_1d(np.asarray(scales, np.float64))
    if scales.ndim != 1 or len(scales) == 0 or np.any(scales <= 0):
        raise ValueError(f"scales must be a non-empty 1D positive array, "
                         f"got {scales!r}")
    n = int(np.shape(x)[-1])
    hat = _morlet_hat(scales, n, w0)
    if not resolve_simd(simd, op="morlet_cwt"):
        return morlet_cwt_na(x, scales, w0).astype(np.complex64)
    forced = route is not None
    if forced and route not in _CWT_ROUTES:
        raise ValueError(
            f"route must be one of {sorted(_CWT_ROUTES)}, "
            f"got {route!r}")
    if forced and route == "ct_matmul" and ct_factor(n) is None:
        raise ValueError(
            f"n={n} has no Cooley-Tukey split with both factors "
            f"<= {AUTO_DFT_MATMUL_MAX_FRAME}")
    xt = as_f32(x)
    chosen = route if forced else _CWT_FAMILY.select(
        n=n, scales=routing.pow2_bucket(len(scales)))
    obs.record_decision("morlet_cwt_route", chosen, n=n,
                        scales=len(scales), forced=forced)
    with obs.span("morlet_cwt.dispatch", route=chosen):
        return _CWT_ROUTES[chosen](xt, hat)


def morlet_cwt_na(x, scales, w0: float = 6.0):
    """NumPy float64 oracle twin of :func:`morlet_cwt` (complex128)."""
    x = _host(x, np.float64)
    scales = np.atleast_1d(np.asarray(scales, np.float64))
    hat = _morlet_hat(scales, x.shape[-1], w0)
    spec = np.fft.fft(x, axis=-1)
    return np.fft.ifft(spec[..., None, :] * hat, axis=-1)


# ---------------------------------------------------------------------------
# spectral estimation (periodogram / Welch / CSD / coherence)
# ---------------------------------------------------------------------------


def detrend(x, type: str = "linear", simd=None,  # noqa: A002
            axis: int = -1):
    """Remove a constant or least-squares linear trend along ``axis``
    (scipy's ``detrend``; default last axis).  The linear projection is
    a host-side closed form (2-column Vandermonde pseudo-inverse),
    applied as one fp32 matmul on the device."""
    if type not in ("linear", "constant"):
        raise ValueError(f"type must be 'linear' or 'constant', "
                         f"got {type!r}")
    use = resolve_simd(simd, op="detrend")
    ndim = x.ndim if isinstance(x, torch.Tensor) else np.ndim(x)
    if axis not in (-1, ndim - 1):
        if use:
            moved = torch.movedim(as_f32(x), axis, -1)
            return torch.movedim(detrend(moved, type, simd=simd), -1,
                                 axis)
        moved = np.moveaxis(_host(x, np.float64), axis, -1)
        return np.moveaxis(detrend(moved, type, simd=simd), -1, axis)
    n = int(np.shape(x)[-1])
    if not use:
        return detrend_na(x, type).astype(np.float32)
    xt = as_f32(x)
    if type == "constant":
        return xt - xt.mean(dim=-1, keepdim=True)
    # rank-2 LSQ fit: O(n) via the [2, n] pseudo-inverse, never the
    # [n, n] projector (a 1M-point signal would need 4 TB for it)
    a = np.c_[np.arange(n, dtype=np.float64), np.ones(n)]
    pinva = _to_device(np.linalg.pinv(a).astype(np.float32), xt.device)
    at = _to_device(a.astype(np.float32), xt.device)
    coef = prx.p_einsum("cn,...n->...c", pinva, xt)
    return xt - prx.p_einsum("nc,...c->...n", at, coef)


def detrend_na(x, type: str = "linear"):  # noqa: A002
    """NumPy float64 oracle twin of :func:`detrend`."""
    x = _host(x, np.float64)
    if type == "constant":
        return x - x.mean(axis=-1, keepdims=True)
    if type != "linear":
        raise ValueError(f"type must be 'linear' or 'constant', "
                         f"got {type!r}")
    n = x.shape[-1]
    a = np.c_[np.arange(n, dtype=np.float64), np.ones(n)]
    coef = np.einsum("ck,...k->...c", np.linalg.pinv(a), x)
    return x - np.einsum("nc,...c->...n", a, coef)


def _welch_args(n, nperseg, noverlap, window):
    nperseg = int(min(nperseg, n))
    if noverlap is None:
        noverlap = nperseg // 2
    noverlap = int(noverlap)
    if not 0 <= noverlap < nperseg:
        raise ValueError(f"noverlap {noverlap} must be in [0, nperseg "
                         f"= {nperseg})")
    window = _resolve_window(window, nperseg, np.float64)
    return nperseg, nperseg - noverlap, window


def _onesided_scale(nperseg, fs, window, scaling) -> np.ndarray:
    """Per-bin factor for a one-sided PSD of real input: the
    density/spectrum normalization times the doubling of every bin
    except DC (and Nyquist when ``nperseg`` is even)."""
    if scaling == "density":
        scale = 1.0 / (fs * np.sum(window ** 2))
    elif scaling == "spectrum":
        scale = 1.0 / np.sum(window) ** 2
    else:
        raise ValueError(f"scaling must be 'density' or 'spectrum', "
                         f"got {scaling!r}")
    mult = np.full(nperseg // 2 + 1, 2.0)
    mult[0] = 1.0
    if nperseg % 2 == 0:
        mult[-1] = 1.0
    return mult * scale


def _segment_ffts(x, y, fs, nperseg, noverlap, window, detrend_type,
                  scaling, simd):
    """Segment + detrend + window + rfft both inputs ONCE; returns
    ``(freqs, fx, fy, scale_mult)`` with ``fy is fx`` when ``y is x``
    and ``scale_mult`` the combined density/one-sided factor per bin."""
    n = np.shape(x)[-1]
    if np.shape(y)[-1] != n:
        raise ValueError("x and y lengths differ")
    nperseg, hop, window = _welch_args(n, nperseg, noverlap, window)
    freqs = np.fft.rfftfreq(nperseg, 1.0 / fs)
    scale_mult = _onesided_scale(nperseg, fs, window, scaling)

    if simd:
        def segments(v):
            segs = _take_frames(as_f32(v), nperseg, hop)
            if detrend_type is not None:
                segs = detrend(segs, detrend_type, simd=True)
            return segs * _device_window(window, segs.device)

        fx = torch.fft.rfft(segments(x), dim=-1)
        fy = fx if y is x else torch.fft.rfft(segments(y), dim=-1)
        return freqs, fx, fy, _to_device(scale_mult.astype(np.float32),
                                         fx.device)

    def segments_na(v):
        segs = v[..., _frame_indices(n, nperseg, hop)]
        if detrend_type is not None:
            segs = detrend_na(segs, detrend_type)
        return segs * window

    fx = np.fft.rfft(segments_na(_host(x, np.float64)), axis=-1)
    fy = fx if y is x else np.fft.rfft(
        segments_na(_host(y, np.float64)), axis=-1)
    return freqs, fx, fy, scale_mult


def _spectral_helper(x, y, fs, nperseg, noverlap, window, detrend_type,
                     scaling, simd):
    """Shared segment-average machinery for welch/csd (scipy's
    ``_spectral_helper`` shape, rebuilt on the framing view)."""
    freqs, fx, fy, scale_mult = _segment_ffts(
        x, y, fs, nperseg, noverlap, window, detrend_type, scaling, simd)
    if simd:
        if fy is fx:  # auto-spectrum: |fx|^2, skip the complex multiply
            return freqs, (fx.abs() ** 2).mean(dim=-2) * scale_mult
        return freqs, (fx.conj() * fy).mean(dim=-2) * scale_mult
    if fy is fx:
        return freqs, np.mean(np.abs(fx) ** 2, axis=-2) * scale_mult
    return freqs, np.mean(np.conj(fx) * fy, axis=-2) * scale_mult


def welch(x, fs: float = 1.0, nperseg: int = 256, noverlap=None,
          window=None, detrend_type: str = "constant",
          scaling: str = "density", simd=None):
    """Welch power-spectral-density estimate (scipy's ``welch``).

    Segment (Hann window, 50% overlap by default), detrend each
    segment, average one-sided periodograms.  Returns ``(freqs, Pxx)``
    with ``Pxx`` real f32 ``[..., min(nperseg, n) // 2 + 1]``
    (``nperseg`` is clamped to the signal length, scipy-style);
    ``freqs`` is a host-side float64 array.  The segment pipeline is
    the same framing view + batched rfft as :func:`stft`.
    """
    use = resolve_simd(simd, op="welch")
    f, p = _spectral_helper(x, x, float(fs), nperseg, noverlap, window,
                            detrend_type, scaling, use)
    if use:
        return f, p.to(torch.float32)
    return f, np.real(p).astype(np.float32)


def welch_na(x, fs: float = 1.0, nperseg: int = 256, noverlap=None,
             window=None, detrend_type: str = "constant",
             scaling: str = "density"):
    """NumPy float64 oracle twin of :func:`welch`."""
    f, p = _spectral_helper(x, x, float(fs), nperseg, noverlap, window,
                            detrend_type, scaling, False)
    return f, np.real(p)


def periodogram(x, fs: float = 1.0, window=None, scaling: str = "density",
                detrend_type: str = "constant", simd=None):
    """Single-segment PSD (scipy's ``periodogram``: boxcar window,
    constant detrend by default).  Pass ``detrend_type=None`` to keep
    the raw DC bin."""
    n = np.shape(x)[-1]
    window = (np.ones(n, np.float64) if window is None
              else _resolve_window(window, n, np.float64))
    use = resolve_simd(simd, op="periodogram")
    f, p = _spectral_helper(x, x, float(fs), n, 0, window, detrend_type,
                            scaling, use)
    if use:
        return f, p.to(torch.float32)
    return f, np.real(p).astype(np.float32)


def periodogram_na(x, fs: float = 1.0, window=None,
                   scaling: str = "density",
                   detrend_type: str = "constant"):
    n = np.shape(x)[-1]
    window = (np.ones(n, np.float64) if window is None
              else _resolve_window(window, n, np.float64))
    f, p = _spectral_helper(x, x, float(fs), n, 0, window, detrend_type,
                            scaling, False)
    return f, np.real(p)


def csd(x, y, fs: float = 1.0, nperseg: int = 256, noverlap=None,
        window=None, detrend_type: str = "constant",
        scaling: str = "density", simd=None):
    """Cross-spectral density ``Pxy`` (scipy's ``csd``): complex64
    ``[..., bins]``."""
    use = resolve_simd(simd, op="csd")
    f, p = _spectral_helper(x, y, float(fs), nperseg, noverlap, window,
                            detrend_type, scaling, use)
    if use:
        return f, p.to(torch.complex64)
    return f, p.astype(np.complex64)


def csd_na(x, y, fs: float = 1.0, nperseg: int = 256, noverlap=None,
           window=None, detrend_type: str = "constant",
           scaling: str = "density"):
    f, p = _spectral_helper(x, y, float(fs), nperseg, noverlap, window,
                            detrend_type, scaling, False)
    return f, p


def _coherence_impl(x, y, fs, nperseg, noverlap, window, simd):
    """Pxx/Pyy/Pxy from ONE segmentation+rfft of each input; the scale
    factors cancel in the ratio but are kept for clarity."""
    freqs, fx, fy, scale_mult = _segment_ffts(
        x, y, float(fs), nperseg, noverlap, window, "constant",
        "density", simd)
    if simd:
        pxx = (fx.abs() ** 2).mean(dim=-2) * scale_mult
        pyy = (fy.abs() ** 2).mean(dim=-2) * scale_mult
        pxy = (fx.conj() * fy).mean(dim=-2) * scale_mult
        return freqs, pxy.abs() ** 2 / (pxx * pyy)
    pxx = np.mean(np.abs(fx) ** 2, axis=-2) * scale_mult
    pyy = np.mean(np.abs(fy) ** 2, axis=-2) * scale_mult
    pxy = np.mean(np.conj(fx) * fy, axis=-2) * scale_mult
    return freqs, np.abs(pxy) ** 2 / (pxx * pyy)


def coherence(x, y, fs: float = 1.0, nperseg: int = 256, noverlap=None,
              window=None, simd=None):
    """Magnitude-squared coherence ``|Pxy|^2 / (Pxx Pyy)`` in [0, 1]
    (scipy's ``coherence``)."""
    use = resolve_simd(simd, op="coherence")
    f, coh = _coherence_impl(x, y, fs, nperseg, noverlap, window, use)
    if use:
        return f, coh.to(torch.float32)
    return f, coh.astype(np.float32)


def coherence_na(x, y, fs: float = 1.0, nperseg: int = 256,
                 noverlap=None, window=None):
    return _coherence_impl(x, y, fs, nperseg, noverlap, window, False)


# ---------------------------------------------------------------------------
# chirp-Z transform / zoom FFT (Bluestein)
# ---------------------------------------------------------------------------


def _czt_constants(n, m, w, a):
    """Host-side Bluestein chirp constants (complex128 -> complex64).

    ``X[k] = w^(k^2/2) * sum_n (x[n] a^-n w^(n^2/2)) w^(-(k-n)^2/2)`` —
    the quadratic-phase decomposition ``nk = (n^2 + k^2 - (k-n)^2)/2``
    turns the non-uniform DFT into ONE linear convolution of length
    ``n + m - 1``, which runs as a padded FFT multiply on the device.
    """
    w, a = complex(w), complex(a)
    nmax = max(n, m)
    k2 = np.arange(nmax, dtype=np.float64) ** 2 / 2.0
    # w^(j^2/2) for j in [-(n-1), m-1] (the convolution kernel support)
    j = np.arange(-(n - 1), m, dtype=np.float64)
    kern = w ** (-(j * j) / 2.0)
    pre = (a ** -np.arange(n, dtype=np.float64)) * w ** k2[:n]
    post = w ** k2[:m]
    nfft = 1 << int(np.ceil(np.log2(n + m - 1)))
    kern_f = np.fft.fft(kern, nfft)
    return (pre.astype(np.complex64), kern_f.astype(np.complex64),
            post.astype(np.complex64), nfft)


def czt(x, m=None, w=None, a=1.0, simd=None):
    """Chirp-Z transform (scipy's ``czt``): ``m`` samples of the
    z-transform along the spiral ``z = a * w^-k``.

    Defaults (``m = n``, ``w = exp(-2j pi / m)``, ``a = 1``) reproduce
    the DFT on arbitrary lengths.  Runs as Bluestein's algorithm — one
    linear convolution against a quadratic-phase chirp, with all chirp
    constants host-side.  Returns complex64 ``[..., m]``.
    """
    n = np.shape(x)[-1]
    if n < 1:
        raise ValueError("empty signal")
    m = int(m) if m is not None else n
    if m < 1:
        raise ValueError("m must be >= 1")
    if w is None:
        w = np.exp(-2j * np.pi / m)
    pre, kern_f, post, nfft = _czt_constants(n, m, w, a)
    if resolve_simd(simd, op="czt"):
        xt = as_c64(x)
        y = xt * _to_device(pre, xt.device)
        yf = torch.fft.fft(y, nfft, dim=-1)
        conv = torch.fft.ifft(yf * _to_device(kern_f, xt.device), dim=-1)
        return conv[..., n - 1: n - 1 + m] * _to_device(post, xt.device)
    # host fallback: the SAME Bluestein convolution in float64 numpy —
    # NOT the O(n*m) direct-sum oracle, which would materialize an
    # [m, n] matrix (33 GB for zoom_fft of a 1M-sample signal)
    xc = _host(x, np.complex128)
    wc, ac = complex(w), complex(a)
    nmax = np.arange(n, dtype=np.float64)
    pre64 = ac ** -nmax * wc ** (nmax * nmax / 2.0)
    j = np.arange(-(n - 1), m, dtype=np.float64)
    kern64 = np.fft.fft(wc ** (-(j * j) / 2.0), nfft)
    k = np.arange(m, dtype=np.float64)
    post64 = wc ** (k * k / 2.0)
    conv = np.fft.ifft(np.fft.fft(xc * pre64, nfft, axis=-1) * kern64,
                       axis=-1)
    return (conv[..., n - 1: n - 1 + m] * post64).astype(np.complex64)


def czt_na(x, m=None, w=None, a=1.0):
    """NumPy complex128 oracle twin of :func:`czt` — the DIRECT O(n m)
    z-transform sum, deliberately a different algorithm than Bluestein
    so the cross-validation is meaningful.  O(n*m) memory: intended for
    test-sized inputs, not the public fallback path."""
    x = _host(x, np.complex128)
    n = x.shape[-1]
    if n < 1:
        raise ValueError("empty signal")
    m = int(m) if m is not None else n
    if m < 1:
        raise ValueError("m must be >= 1")
    if w is None:
        w = np.exp(-2j * np.pi / m)
    w, a = complex(w), complex(a)
    k = np.arange(m)
    z = a * w ** -k                                   # [m] spiral points
    pows = z[..., :, None] ** -np.arange(n)[None, :]  # [m, n]
    return np.einsum("kn,...n->...k", pows, x)


def zoom_fft(x, fn, m=None, fs: float = 2.0, simd=None):
    """Zoomed DFT over a band (scipy's ``zoom_fft``): ``m`` uniformly
    spaced frequency samples spanning ``fn = [f1, f2]`` (or ``[0, fn]``)
    at sample rate ``fs`` — fine frequency resolution over a narrow band
    without computing (or padding to) a huge full-length FFT.

    Returns ``(freqs, X)``; ``freqs`` is host-side float64.
    """
    n = np.shape(x)[-1]
    f = np.ravel(np.asarray(fn, np.float64))
    if f.size == 1:
        f1, f2 = 0.0, float(f[0])
    elif f.size == 2:
        f1, f2 = float(f[0]), float(f[1])
    else:
        raise ValueError("fn must be a scalar or a (f1, f2) pair")
    if not 0.0 <= f1 < f2 <= fs / 2:
        raise ValueError(f"band [{f1}, {f2}] must satisfy "
                         f"0 <= f1 < f2 <= fs/2 = {fs / 2}")
    m = int(m) if m is not None else n
    # scipy's default endpoint=False convention: step (f2-f1)/m, f2
    # itself excluded (like np.fft.fftfreq's grid)
    step = (f2 - f1) / m
    freqs = f1 + np.arange(m) * step
    w = np.exp(-2j * np.pi * step / fs)
    a = np.exp(2j * np.pi * f1 / fs)
    return freqs, czt(x, m, w, a, simd=simd)


# ---------------------------------------------------------------------------
# Lomb-Scargle (unevenly-sampled periodogram)
# ---------------------------------------------------------------------------


def _check_lombscargle_args(t, x, freqs, weights=None):
    """Validation for the Lomb-Scargle paths: float64 views of (t, x,
    freqs, weights) or ValueError.  ``weights`` defaults to all-ones;
    zero weights exclude samples exactly."""
    t = _host(t, np.float64)
    x = _host(x, np.float64)
    freqs = _host(freqs, np.float64)
    if t.ndim != 1 or x.ndim != 1 or len(t) != len(x):
        raise ValueError("t and x must be 1D of equal length")
    if freqs.ndim != 1 or len(freqs) == 0:
        raise ValueError("freqs must be a non-empty 1D array")
    if np.any(freqs <= 0):
        raise ValueError("freqs must be positive (angular) frequencies")
    if weights is None:
        weights = np.ones_like(t)
    else:
        weights = _host(weights, np.float64)
        if weights.shape != t.shape:
            raise ValueError(
                f"weights shape {weights.shape} != t shape {t.shape}")
        if np.any(weights < 0):
            raise ValueError("weights must be non-negative")
        if not np.any(weights > 0):
            raise ValueError("at least one weight must be positive")
    return t, x, freqs, weights


def _lombscargle_torch(t, x, freqs, w):
    # [m, n] phase grids: the whole periodogram is a handful of
    # elementwise trig ops + reductions over the sample axis.  Every
    # sum carries the weights channel; w == 1 reproduces the textbook
    # formula, w == 0 removes a sample exactly.
    wt = freqs[:, None] * t[None, :]
    # Scargle's tau makes the estimate phase-invariant
    tau = torch.atan2(torch.sum(w * torch.sin(2 * wt), dim=-1),
                      torch.sum(w * torch.cos(2 * wt), dim=-1)) / 2.0
    arg = wt - tau[:, None]
    c, s = torch.cos(arg), torch.sin(arg)
    xc = torch.sum((w * x)[None, :] * c, dim=-1)
    xs = torch.sum((w * x)[None, :] * s, dim=-1)
    cc = torch.sum(w * c * c, dim=-1)
    ss = torch.sum(w * s * s, dim=-1)
    return 0.5 * (xc * xc / cc + xs * xs / ss)


def lombscargle(t, x, freqs, simd=None, weights=None):
    """Lomb-Scargle periodogram for UNEVENLY sampled data (scipy's
    ``lombscargle`` with its default normalization): power of the
    least-squares sinusoid fit at each angular frequency in ``freqs``.

    No FFT and no resampling: a dense ``[m, n]`` trig evaluation.
    ``t``/``freqs`` in reciprocal units (``freqs`` are ANGULAR
    frequencies, scipy convention).  ``weights`` (optional,
    non-negative, same shape as ``t``) scales every sample's
    contribution to all five Scargle sums; a zero weight excludes the
    sample exactly.
    """
    t, x_np, freqs, w_np = _check_lombscargle_args(t, x, freqs, weights)
    if not resolve_simd(simd, op="lombscargle"):
        return lombscargle_na(t, x_np, freqs, w_np).astype(np.float32)
    # center the time base in float64 BEFORE the f32 cast: Scargle's
    # tau makes the estimate exactly time-shift invariant, and raw
    # offset timestamps (e.g. Julian dates ~2.45e6) would otherwise
    # push the phase grid to values where f32 spacing exceeds a
    # radian.  Weighted mean so zero-weight padding can't shift it.
    t = t - (w_np @ t) / w_np.sum()
    dev = device()
    return _lombscargle_torch(*(_to_device(a.astype(np.float32), dev)
                                for a in (t, x_np, freqs, w_np)))


def lombscargle_na(t, x, freqs, weights=None):
    """NumPy float64 oracle twin (per-frequency loop, the textbook
    Scargle formula, optional weights channel)."""
    t = _host(t, np.float64)
    x = _host(x, np.float64)
    wts = (np.ones_like(t) if weights is None
           else _host(weights, np.float64))
    out = np.empty(len(freqs))
    for i, w in enumerate(_host(freqs, np.float64)):
        tau = np.arctan2(np.sum(wts * np.sin(2 * w * t)),
                         np.sum(wts * np.cos(2 * w * t))) / (2.0)
        arg = w * t - tau
        c, s = np.cos(arg), np.sin(arg)
        out[i] = 0.5 * (((wts * x) @ c) ** 2 / ((wts * c) @ c)
                        + ((wts * x) @ s) ** 2 / ((wts * s) @ s))
    return out
