"""Nonlinear & smoothing filters: median/rank, Savitzky-Golay, Wiener,
FIR design.

The port of ``veles.simd_tpu.ops.filters`` (the JAX package's addition
beyond the reference, whose filtering is linear convolution only),
computed with PyTorch on ``Config.device``:

* **Median/rank filtering** is Batcher's compare-exchange network over
  shifted slices (window area <= 32): the k window taps are k shifted
  views of the zero-padded signal or plane, sorted as a list of
  vectors by ~k log^2 k ``torch.minimum``/``maximum`` pairs.  NaNs keep
  ``torch.sort``'s order-last semantics (the JAX package's
  ``jnp.sort`` ones) through an inf substitution and a non-NaN count.
  Larger windows sort an ``unfold`` window matrix.
* **Savitzky-Golay** is an FIR correlation whose taps are a host-side
  least-squares solve, plus host-side polynomial edge fits for the
  scipy ``interp`` mode; the device work is one ``F.conv1d`` in full
  fp32 (``runtime.precision.fp32_conv``).
* **Wiener** is the local mean and variance over shifted slices (or
  the window matrix beyond 32 taps), in the locally demeaned form.
* **FIR design** (``firwin``, ``firwin2``, ``remez``, ``kaiserord``,
  ``kaiser_beta``, ``kaiser_atten``) and ``deconvolve`` are float64
  NumPy on the host, copied from the JAX package.

scipy.signal conventions throughout (``medfilt`` zero-padding,
``savgol_filter`` ``interp``/``constant``/``nearest`` modes, ``firwin``
``pass_zero`` semantics).  Oracle twins (``*_na``) are float64 NumPy
implementing the definitions directly.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.ops import waveforms as wf
from veles.simd_tpu_torch.runtime import precision as prx
from veles.simd_tpu_torch.utils import benchmark as bm
from veles.simd_tpu_torch.utils.config import resolve_simd
from veles.simd_tpu_torch.utils.platform import as_f32

__all__ = [
    "medfilt", "medfilt_na", "medfilt2d", "medfilt2d_na", "order_filter",
    "order_filter_na", "savgol_coeffs", "savgol_filter",
    "savgol_filter_na", "firwin", "firwin2", "remez", "wiener",
    "wiener_na", "deconvolve", "kaiserord", "kaiser_beta",
    "kaiser_atten",
]


# ---------------------------------------------------------------------------
# median / rank
# ---------------------------------------------------------------------------


def _check_kernel(kernel_size: int, what: str = "kernel_size") -> int:
    kernel_size = int(kernel_size)
    if kernel_size < 1 or kernel_size % 2 == 0:
        raise ValueError(f"{what} must be odd and positive, "
                         f"got {kernel_size}")
    return kernel_size


def _kernel_2d(kernel_size):
    if np.isscalar(kernel_size):
        k = _check_kernel(kernel_size)
        return k, k
    kh, kw = (_check_kernel(k) for k in kernel_size)
    return kh, kw


def _shifted_lanes_1d(x, k):
    """k shifted full-signal views of the zero-padded input (lane j at
    sample i is window element [i, j]); the rank and Wiener paths
    share them."""
    half = k // 2
    xpad = F.pad(x, (half, half))
    n = x.shape[-1]
    return [xpad[..., j:j + n] for j in range(k)]


def _window_view_1d_np(x, k):
    """Zero-padded sliding windows ``[..., n, k]`` (scipy medfilt pads
    with zeros on both sides)."""
    half = k // 2
    xpad = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(half, half)])
    idx = np.arange(x.shape[-1])[:, None] + np.arange(k)[None, :]
    return xpad[..., idx]


def _batcher_pairs(k: int):
    """Compare-exchange pairs of Batcher's odd-even mergesort network
    for ``k`` inputs (host-side, static).  ~k log^2 k pairs; sorts any
    input ascending when applied in order."""
    pairs = []

    def merge(lo, n, step):
        m = step * 2
        if m < n:
            merge(lo, n, m)
            merge(lo + step, n, m)
            for i in range(lo + step, lo + n - step, m):
                pairs.append((i, i + step))
        else:
            pairs.append((lo, lo + step))

    def sort(lo, n):
        if n > 1:
            m = n // 2
            sort(lo, m)
            sort(lo + m, n - m)
            merge(lo, n, 1)

    # Batcher's construction wants a power-of-2 width; pad virtually
    # and drop pairs touching the padding (+inf sentinels sort high
    # and never move, so the pruned network still sorts the real k)
    n2 = 1 << (k - 1).bit_length()
    sort(0, n2)
    return [(a, b) for a, b in pairs if a < k and b < k]


# the network's window-size cap, the JAX package's: beyond it the
# window matrix and one sort take over
_RANK_NETWORK_MAX_K = 32


def _apply_rank_network(lanes, rank):
    """Select the ``rank``-th smallest across a list of equal-shape
    vectors via Batcher compare-exchanges, with sort's NaN semantics
    (NaNs order last): NaNs are substituted with +inf for the network
    and the output is NaN exactly when the window has <= ``rank``
    non-NaN elements (what sort-then-index returns)."""
    masks = [torch.isnan(v) for v in lanes]
    lanes = [torch.where(m, np.inf, v) for m, v in zip(masks, lanes)]
    for a, b in _batcher_pairs(len(lanes)):
        lo = torch.minimum(lanes[a], lanes[b])
        hi = torch.maximum(lanes[a], lanes[b])
        lanes[a], lanes[b] = lo, hi
    n_nonnan = sum((~m).to(torch.int32) for m in masks)
    return torch.where(rank < n_nonnan, lanes[rank], np.nan)


def _window_work(ops):
    """``work=`` of a sliding-window core: ``ops(*sizes)`` operations
    an output sample, the signal read and the float32 output written
    once."""
    return lambda x, *sizes: bm.elementwise_work(ops(*sizes), 4, x)


# the instrumented cores, keyed by the JAX package's core names: a
# rank selection takes an operation a window tap; the Wiener filter's
# local mean and variance two, plus six for the scale
@obs.instrumented_jit(op="rank_filter_xla",
                      work=_window_work(lambda k, rank: k))
def _rank_filter(x, k, rank):
    if k > _RANK_NETWORK_MAX_K:
        win = F.pad(x, (k // 2, k // 2)).unfold(-1, k, 1)
        return torch.sort(win, dim=-1).values[..., rank]
    return _apply_rank_network(_shifted_lanes_1d(x, k), rank)


def order_filter(x, rank: int, kernel_size: int, simd=None):
    """Rank-order filter: the ``rank``-th smallest of each zero-padded
    length-``kernel_size`` window (``rank = k // 2`` is the median)."""
    k = _check_kernel(kernel_size)
    rank = int(rank)
    if not 0 <= rank < k:
        raise ValueError(f"rank {rank} outside [0, {k})")
    if resolve_simd(simd, op="filters"):
        return _rank_filter(as_f32(x), k, rank)
    return order_filter_na(x, rank, k).astype(np.float32)


def order_filter_na(x, rank: int, kernel_size: int):
    """NumPy float64 oracle twin of :func:`order_filter`."""
    k = _check_kernel(kernel_size)
    x = np.asarray(x, np.float64)
    win = _window_view_1d_np(x, k)
    return np.sort(win, axis=-1)[..., int(rank)]


def medfilt(x, kernel_size: int = 3, simd=None):
    """Median filter (scipy's ``medfilt``: zero-padded edges)."""
    k = _check_kernel(kernel_size)
    return order_filter(x, k // 2, k, simd=simd)


def medfilt_na(x, kernel_size: int = 3):
    k = _check_kernel(kernel_size)
    return order_filter_na(x, k // 2, k)


@obs.instrumented_jit(op="medfilt2d_xla",
                      work=_window_work(lambda kh, kw: kh * kw))
def _medfilt2d(img, kh, kw):
    k = kh * kw
    hh, hw = kh // 2, kw // 2
    p = F.pad(img, (hw, hw, hh, hh))
    if k > _RANK_NETWORK_MAX_K:
        win = p.unfold(-2, kh, 1).unfold(-2, kw, 1)   # [..., H, W, kh, kw]
        win = win.reshape(win.shape[:-2] + (k,))
        return torch.sort(win, dim=-1).values[..., k // 2]
    # kh*kw shifted full-plane slices through the Batcher network —
    # the 1D rank filter's trick on two shift axes
    h_count, w_count = img.shape[-2], img.shape[-1]
    lanes = [p[..., i:i + h_count, j:j + w_count]
             for i in range(kh) for j in range(kw)]
    return _apply_rank_network(lanes, k // 2)


def medfilt2d(img, kernel_size=3, simd=None):
    """2D median filter (scipy's ``medfilt2d``: zero-padded edges).

    ``kernel_size`` is an int or an ``(kh, kw)`` pair of odd ints.
    """
    kh, kw = _kernel_2d(kernel_size)
    if np.ndim(img) < 2:
        raise ValueError("medfilt2d needs [..., H, W]")
    if resolve_simd(simd, op="filters"):
        return _medfilt2d(as_f32(img), kh, kw)
    return medfilt2d_na(img, (kh, kw)).astype(np.float32)


def medfilt2d_na(img, kernel_size=3):
    kh, kw = _kernel_2d(kernel_size)
    img = np.asarray(img, np.float64)
    hh, hw = kh // 2, kw // 2
    p = np.pad(img, [(0, 0)] * (img.ndim - 2) + [(hh, hh), (hw, hw)])
    ri = np.arange(img.shape[-2])[:, None] + np.arange(kh)[None, :]
    ci = np.arange(img.shape[-1])[:, None] + np.arange(kw)[None, :]
    win = p[..., ri[:, None, :, None], ci[None, :, None, :]]
    win = win.reshape(win.shape[:-2] + (kh * kw,))
    return np.sort(win, axis=-1)[..., (kh * kw) // 2]


# ---------------------------------------------------------------------------
# Savitzky-Golay
# ---------------------------------------------------------------------------


def _savgol_corr_taps(window_length: int, polyorder: int,
                      deriv: int, delta: float) -> np.ndarray:
    """Correlation-oriented SG taps: ``taps @ x[t-half : t+half+1]``
    evaluates the deriv-th derivative of the LSQ polynomial at t."""
    window_length = _check_kernel(window_length, "window_length")
    polyorder = int(polyorder)
    deriv = int(deriv)
    if polyorder >= window_length:
        raise ValueError("polyorder must be < window_length")
    if deriv < 0:
        raise ValueError("deriv must be >= 0")
    if deriv > polyorder:
        return np.zeros(window_length)
    half = window_length // 2
    pos = np.arange(-half, half + 1, dtype=np.float64)
    # A[i, j] = pos_i^j; taps = row `deriv` of pinv, times d!/delta^d
    a_mat = pos[:, None] ** np.arange(polyorder + 1)[None, :]
    coeffs = np.linalg.pinv(a_mat)[deriv]
    return coeffs * math.factorial(deriv) / (float(delta) ** deriv)


def savgol_coeffs(window_length: int, polyorder: int,
                  deriv: int = 0, delta: float = 1.0) -> np.ndarray:
    """FIR taps of the Savitzky-Golay filter, float64 host-side —
    scipy's ``savgol_coeffs`` convention: oriented for ``np.convolve``
    (reversed relative to a correlation read of the window)."""
    return _savgol_corr_taps(window_length, polyorder, deriv,
                             delta)[::-1]


def _savgol_edge_mats(window_length, polyorder, deriv, delta):
    """mode='interp' edge fix-up as LINEAR MAPS, host-side float64:
    ``head = head_mat @ x[:w]`` and ``tail = tail_mat @ x[-w:]`` give
    the deriv-th derivative of the polynomial fitted to the first/last
    full window, evaluated at the edge positions.  The matrix form is
    what the sharded path (``parallel.sharded_savgol_filter``) applies
    on-device inside ``shard_map``."""
    half = window_length // 2
    pos = np.arange(window_length, dtype=np.float64)
    a_mat = pos[:, None] ** np.arange(polyorder + 1)[None, :]
    pinv = np.linalg.pinv(a_mat)

    def mat(at):
        m = np.zeros((len(at), window_length))
        for j in range(deriv, polyorder + 1):
            fac = math.factorial(j) / math.factorial(j - deriv)
            m += fac * (at[:, None] ** (j - deriv)) * pinv[j][None, :]
        return m / float(delta) ** deriv

    at = np.arange(half, dtype=np.float64)
    return mat(at), mat(at + (window_length - half))


def _savgol_edge_fits(x_np, window_length, polyorder, deriv, delta):
    """Polynomial edge values for mode='interp' (scipy semantics): the
    :func:`_savgol_edge_mats` maps applied to the end windows."""
    head_mat, tail_mat = _savgol_edge_mats(window_length, polyorder,
                                           deriv, delta)
    head = np.einsum("hw,...w->...h", head_mat,
                     x_np[..., :window_length])
    tail = np.einsum("hw,...w->...h", tail_mat,
                     x_np[..., -window_length:])
    return head, tail



def savgol_filter(x, window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, mode: str = "interp", simd=None):
    """Savitzky-Golay smoothing / differentiation (scipy conventions).

    ``mode='interp'`` (default) replaces each edge half-window with the
    evaluation of a polynomial fitted to the first/last full window;
    ``'constant'`` zero-pads; ``'nearest'`` edge-replicates.
    """
    window_length = _check_kernel(window_length, "window_length")
    n = np.shape(x)[-1]
    if mode == "interp" and window_length > n:
        raise ValueError(f"mode='interp' needs window_length "
                         f"{window_length} <= signal length {n}")
    if mode not in ("interp", "constant", "nearest"):
        raise ValueError(f"unknown mode {mode!r}")
    taps = _savgol_corr_taps(window_length, polyorder, deriv, delta)
    half = window_length // 2
    if not resolve_simd(simd, op="filters"):
        return savgol_filter_na(x, window_length, polyorder, deriv,
                                delta, mode).astype(np.float32)
    xt = as_f32(x)
    if mode == "nearest":
        xe = torch.cat([xt[..., :1].expand(*xt.shape[:-1], half), xt,
                        xt[..., -1:].expand(*xt.shape[:-1], half)],
                       dim=-1)
    else:
        xe = F.pad(xt, (half, half))
    t = torch.as_tensor(taps, dtype=torch.float32, device=xt.device)
    # conv1d is a correlation (no flip), as lax's conv is
    with prx.fp32_conv(xt.device):
        out = F.conv1d(xe.reshape(-1, 1, xe.shape[-1]), t.view(1, 1, -1))
    out = out.reshape(xt.shape[:-1] + (n,))
    if mode == "interp":
        # the fits read the first and last windows only: copy just
        # those to the host (their concatenation has the same ends)
        ends = torch.cat([xt[..., :window_length],
                          xt[..., -window_length:]], dim=-1)
        head, tail = _savgol_edge_fits(
            ends.cpu().numpy().astype(np.float64), window_length,
            polyorder, int(deriv), float(delta))
        out = torch.cat(
            [torch.as_tensor(head, dtype=torch.float32, device=xt.device),
             out[..., half:n - half],
             torch.as_tensor(tail, dtype=torch.float32, device=xt.device)],
            dim=-1)
    return out


def savgol_filter_na(x, window_length: int, polyorder: int,
                     deriv: int = 0, delta: float = 1.0,
                     mode: str = "interp"):
    """NumPy float64 oracle twin of :func:`savgol_filter`."""
    window_length = _check_kernel(window_length, "window_length")
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    taps = _savgol_corr_taps(window_length, polyorder, deriv, delta)
    half = window_length // 2
    if mode == "nearest":
        xe = np.concatenate(
            [np.repeat(x[..., :1], half, axis=-1), x,
             np.repeat(x[..., -1:], half, axis=-1)], axis=-1)
    elif mode in ("constant", "interp"):
        xe = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(half, half)])
    else:
        raise ValueError(f"unknown mode {mode!r}")
    # correlation with the taps
    out = np.empty_like(x)
    for t in range(n):
        out[..., t] = np.einsum("k,...k->...", taps,
                                xe[..., t:t + window_length])
    if mode == "interp":
        head, tail = _savgol_edge_fits(x, window_length, polyorder,
                                       int(deriv), float(delta))
        out[..., :half] = head
        out[..., n - half:] = tail
    return out



# ---------------------------------------------------------------------------
# FIR design (window method, all band types)
# ---------------------------------------------------------------------------


_FIRWIN_PASS_ZERO = {"lowpass": (True, 1), "bandstop": (True, 2),
                     "highpass": (False, 1), "bandpass": (False, 2)}



def _design_window(window, numtaps: int) -> np.ndarray:
    """Resolve a firwin/firwin2 ``window`` argument to taps-length
    float64 samples: a :func:`waveforms.get_window` name or
    ``(name, param)`` tuple (scipy convention), or an explicit array of
    ``numtaps`` samples."""
    # only str/tuple are window specs (scipy's convention) — a numeric
    # list is window samples and falls through to the array path
    if isinstance(window, (str, tuple)):
        return wf.get_window(window, numtaps)
    win = np.asarray(window, np.float64)
    if win.shape != (numtaps,):
        raise ValueError(f"window array must have shape ({numtaps},), "
                         f"got {win.shape}")
    return win


def kaiser_beta(a: float) -> float:
    """Kaiser's beta for ``a`` dB of stopband attenuation (scipy's
    ``kaiser_beta``; Kaiser 1974 empirical fit)."""
    a = float(a)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def kaiser_atten(numtaps: int, width: float) -> float:
    """Attenuation (dB) of a ``numtaps``-tap Kaiser FIR with transition
    width ``width`` (fraction of Nyquist) — scipy's ``kaiser_atten``."""
    return 2.285 * (int(numtaps) - 1) * np.pi * float(width) + 7.95


def kaiserord(ripple: float, width: float):
    """``(numtaps, beta)`` for a Kaiser-window FIR meeting ``ripple``
    dB of stopband attenuation with transition width ``width`` (fraction
    of Nyquist) — scipy's ``kaiserord``.  Feed the result to
    ``firwin(numtaps, cutoff, window=("kaiser", beta))``.
    """
    ripple = abs(float(ripple))
    if ripple < 8:
        raise ValueError(
            "ripple attenuation too small for the Kaiser formula "
            "(need >= 8 dB)")
    beta = kaiser_beta(ripple)
    numtaps = (ripple - 7.95) / (2.285 * np.pi * float(width)) + 1
    return int(np.ceil(numtaps)), beta


def firwin(numtaps: int, cutoff, pass_zero=True,
           window="hamming") -> np.ndarray:
    """Window-method linear-phase FIR design (scipy's ``firwin``).

    ``cutoff``: scalar or ``(low, high)`` as fractions of Nyquist.
    ``pass_zero``: True keeps DC (lowpass / bandstop), False rejects it
    (highpass / bandpass), or one of the scipy strings ``'lowpass'`` /
    ``'highpass'`` / ``'bandpass'`` / ``'bandstop'``.  A response that
    passes Nyquist needs odd ``numtaps`` (a Type II filter has a forced
    Nyquist zero).  ``window``: any :func:`waveforms.get_window` name,
    a ``("kaiser", beta)``-style tuple, or an explicit taps-length
    array (pair with :func:`kaiserord` for the classic attenuation-
    driven design).  Float64 host-side; unit passband gain.
    """
    numtaps = int(numtaps)
    if numtaps < 1:
        raise ValueError("numtaps must be >= 1")
    edges = np.atleast_1d(np.asarray(cutoff, np.float64))
    if np.any(edges <= 0.0) or np.any(edges >= 1.0):
        raise ValueError(f"cutoffs {edges} must be in (0, 1)")
    if np.any(np.diff(edges) <= 0):
        raise ValueError("cutoffs must be strictly increasing")
    if isinstance(pass_zero, str):
        if pass_zero not in _FIRWIN_PASS_ZERO:
            raise ValueError(f"pass_zero must be a bool or one of "
                             f"{sorted(_FIRWIN_PASS_ZERO)}, "
                             f"got {pass_zero!r}")
        pass_zero, want_edges = _FIRWIN_PASS_ZERO[pass_zero]
        if len(edges) != want_edges:
            raise ValueError(f"that band type takes {want_edges} "
                             f"cutoff(s), got {len(edges)}")
    else:
        pass_zero = bool(pass_zero)
    # the response passes Nyquist iff the LAST band is a passband
    passes_nyquist = pass_zero if len(edges) % 2 == 0 else not pass_zero
    if passes_nyquist and numtaps % 2 == 0:
        raise ValueError("a response that passes Nyquist needs odd "
                         "numtaps (Type II filters have a Nyquist zero)")
    m = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0
    win = _design_window(window, numtaps)

    def sinc_lp(fc):  # ideal lowpass impulse response at cutoff fc
        return fc * np.sinc(fc * m)

    # build from band edges: alternate bands starting at DC per pass_zero
    bands = np.concatenate([[0.0], edges, [1.0]])
    h = np.zeros(numtaps)
    keep = pass_zero
    for lo, hi in zip(bands[:-1], bands[1:]):
        if keep:
            h += sinc_lp(hi) - sinc_lp(lo)
        keep = not keep
    h *= win
    # normalize at scipy's scale frequency: DC when the first passband
    # touches DC, Nyquist when it touches Nyquist, else its center
    if pass_zero:
        h /= np.sum(h)
    else:
        left = edges[0]
        right = edges[1] if len(edges) > 1 else 1.0
        fc_mid = 1.0 if right == 1.0 else (left + right) / 2.0
        gain = np.abs(np.sum(h * np.exp(-1j * np.pi * fc_mid * m)))
        h /= gain
    return h



# ---------------------------------------------------------------------------
# Wiener (adaptive local-statistics) filter
# ---------------------------------------------------------------------------


def _wiener_scale(x, mean, var, noise, xp):
    # scipy: mean + (1 - noise/var)+ * (x - mean), var clipped below at
    # the noise floor (where the local variance is all noise, output
    # the local mean); xp is np or torch
    excess = xp.clip(var - noise, 0.0, None)
    denom = xp.clip(xp.maximum(var, noise), 1e-30, None)
    return mean + excess / denom * (x - mean)


@obs.instrumented_jit(op="wiener_xla",
                      work=_window_work(lambda k, noise: 2 * k + 6))
def _wiener(x, k, noise):
    # Local statistics in the locally demeaned form mean((x_w -
    # mean_w)^2), algebraically scipy's E[x^2] - mean^2 over the
    # zero-padded window, but with no catastrophic f32 cancellation
    # for DC-offset signals (the JAX package's formulation).
    if k <= _RANK_NETWORK_MAX_K:
        # k shifted full-signal slices (the medfilt trick): no
        # [..., n, k] window matrix through memory
        lanes = _shifted_lanes_1d(x, k)
        mean = sum(lanes) / k
        var = sum((ln - mean) ** 2 for ln in lanes) / k
    else:
        win = F.pad(x, (k // 2, k // 2)).unfold(-1, k, 1)
        mean = torch.mean(win, dim=-1)
        var = torch.mean((win - mean[..., None]) ** 2, dim=-1)
    if noise is None:
        noise = torch.mean(var, dim=-1, keepdim=True)
    else:
        noise = torch.as_tensor(noise, dtype=torch.float32,
                                device=x.device)
    return _wiener_scale(x, mean, var, noise, torch)


def wiener(x, mysize: int = 3, noise=None, simd=None):
    """Adaptive Wiener denoise (scipy's 1D ``wiener``): each sample is
    pulled toward its local mean by the fraction of the local variance
    the noise explains — flat regions are smoothed hard, busy regions
    are left alone.  ``noise`` defaults to the mean of the local
    variances (scipy's estimate)."""
    mysize = _check_kernel(mysize, "mysize")
    if resolve_simd(simd, op="filters"):
        return _wiener(as_f32(x), mysize, noise)
    return wiener_na(x, mysize, noise).astype(np.float32)


def wiener_na(x, mysize: int = 3, noise=None):
    """NumPy float64 oracle twin of :func:`wiener`."""
    mysize = _check_kernel(mysize, "mysize")
    x = np.asarray(x, np.float64)
    win = _window_view_1d_np(x, mysize)
    mean = np.mean(win, axis=-1)
    var = np.mean((win - mean[..., None]) ** 2, axis=-1)
    if noise is None:
        noise = np.mean(var, axis=-1, keepdims=True)
    return _wiener_scale(x, mean, var, noise, np)


def firwin2(numtaps: int, freq, gain, nfreqs=None,
            window="hamming") -> np.ndarray:
    """Frequency-sampling FIR design (scipy's ``firwin2`` for Type I/II
    filters): taps whose magnitude response linearly interpolates the
    ``(freq, gain)`` breakpoints (``freq`` ascending in [0, 1], Nyquist
    = 1).  ``window`` as in :func:`firwin` (name, ``(name, param)``
    tuple, array, or None for rectangular).  Float64 host-side.
    """
    numtaps = int(numtaps)
    if numtaps < 3:
        raise ValueError("numtaps must be >= 3")
    freq = np.asarray(freq, np.float64)
    gain = np.asarray(gain, np.float64)
    if freq.shape != gain.shape or freq.ndim != 1 or len(freq) < 2:
        raise ValueError("freq and gain must be equal-length 1D with "
                         ">= 2 points")
    if freq[0] != 0.0 or freq[-1] != 1.0:
        raise ValueError("freq must start at 0 and end at 1")
    if np.any(np.diff(freq) < 0):
        raise ValueError("freq must be nondecreasing")
    if numtaps % 2 == 0 and gain[-1] != 0.0:
        raise ValueError("even numtaps (Type II) forces zero gain at "
                         "Nyquist; set gain[-1] = 0")
    if nfreqs is None:
        nfreqs = 1 + (1 << int(np.ceil(np.log2(numtaps))))
    nfreqs = int(nfreqs)
    if nfreqs < numtaps:
        raise ValueError("nfreqs must be >= numtaps")
    # scipy's SYMMETRIC eps nudge: each duplicated breakpoint (brick
    # wall) moves eps*nfreqs to either side, so a grid point landing
    # exactly on the discontinuity samples the jump midpoint like scipy
    f = freq.copy()
    d = np.diff(f)
    if (d == 0).any():
        eps = np.finfo(np.float64).eps * nfreqs
        for k in np.nonzero(d == 0)[0]:
            f[k] -= eps
            f[k + 1] += eps
    grid = np.linspace(0.0, 1.0, nfreqs)
    mag = np.interp(grid, f, gain)
    # linear phase: delay (numtaps-1)/2, then one irfft
    shift = np.exp(-(numtaps - 1) / 2.0 * 1j * np.pi * grid)
    h = np.fft.irfft(mag * shift, 2 * (nfreqs - 1))[:numtaps]
    win = np.ones(numtaps) if window is None \
        else _design_window(window, numtaps)
    return h * win


def _bary_eval(x, xe, ye, gamma):
    """Second-form barycentric evaluation of the degree-(r-1)
    interpolant through nodes ``xe[:-1]`` with values ``ye[:-1]``
    (weights rescaled from the full-set ``gamma``).  The single
    evaluator behind both the exchange loop and the final tap
    sampling — they must interpolate the SAME polynomial."""
    n_ext = len(xe)
    num = np.zeros_like(x)
    den = np.zeros_like(x)
    exact = np.full(x.shape, -1, dtype=int)
    for j in range(n_ext - 1):
        dx = x - xe[j]
        hit = np.abs(dx) < 1e-14
        exact[hit] = j
        dx[hit] = 1.0
        w_j = gamma[j] * (xe[j] - xe[n_ext - 1])
        num += w_j / dx * ye[j]
        den += w_j / dx
    out = num / den
    known = exact >= 0
    out[known] = ye[exact[known]]
    return out


def _bary_weights(diff: np.ndarray) -> np.ndarray:
    """Barycentric weights ``1 / prod_k (x_j - x_k)`` from the
    zero-diagonal-filled difference matrix, computed in log space and
    normalized to unit max magnitude: products over 50+ node gaps
    under/overflow float64, and every use (the leveled-error ratio,
    the second-form interpolant) is scale-invariant."""
    logs = np.sum(np.log(np.abs(diff)), axis=1)
    signs = np.prod(np.sign(diff), axis=1)
    return signs * np.exp(-(logs - logs.min()))


def remez(numtaps: int, bands, desired, weight=None, fs: float = 1.0,
          grid_density: int = 16, maxiter: int = 50) -> np.ndarray:
    """Parks-McClellan optimal equiripple FIR design (scipy's ``remez``
    for ``type='bandpass'``, the multiband magnitude fit): linear-phase
    taps whose weighted Chebyshev error against the piecewise-constant
    ``desired`` response is minimax over the ``bands``.

    ``bands``: 2k monotonically increasing edges in [0, fs/2];
    ``desired``: k per-band target gains; ``weight``: k per-band error
    weights (default 1).  Host-side float64 (a few hundred scalars of
    exchange iteration — design-time work, like every ``*ord``/
    ``firwin`` routine here).  scipy's ``differentiator``/``hilbert``
    (antisymmetric) types are not offered.

    Implementation: the textbook Remez exchange on the cosine-domain
    barycentric Lagrange interpolant (McClellan-Parks-Rabiner):
    initialize ``r+1`` extremal frequencies uniformly over the dense
    band grid, solve for the leveled error ``delta``, re-pick the
    alternating local maxima of the weighted error, repeat until the
    extremals fix; taps come from sampling the interpolant at the DFT
    frequencies (inverse DFT of a real even spectrum).
    """
    numtaps = int(numtaps)
    if numtaps < 3:
        raise ValueError("numtaps must be >= 3")
    fs = float(fs)
    bands = np.asarray(bands, np.float64).ravel() / fs  # -> [0, 0.5]
    if bands.ndim != 1 or len(bands) < 2 or len(bands) % 2:
        raise ValueError("bands needs an even number of edges "
                         "(pairs of band boundaries)")
    if np.any(np.diff(bands) <= 0) or bands[0] < 0 or bands[-1] > 0.5:
        # STRICTLY increasing: touching bands (a brick wall) would put
        # duplicate nodes on the design grid and poison the barycentric
        # weights
        raise ValueError("band edges must strictly increase within "
                         "[0, fs/2] (no touching bands)")
    n_bands = len(bands) // 2
    desired = np.asarray(desired, np.float64).ravel()
    if len(desired) != n_bands:
        raise ValueError(f"need one desired gain per band "
                         f"({n_bands}), got {len(desired)}")
    if weight is None:
        weight = np.ones(n_bands)
    weight = np.asarray(weight, np.float64).ravel()
    if len(weight) != n_bands or np.any(weight <= 0):
        raise ValueError("need one positive weight per band")

    odd = numtaps % 2
    # half-length of the cosine series: H(f) = sum_k a_k cos(2 pi f k)
    # (type I); type II factors out cos(pi f) first
    r = (numtaps + 1) // 2 if odd else numtaps // 2
    if not odd and desired[-1] != 0 and bands[-1] == 0.5:
        raise ValueError("even numtaps (type II) forces zero gain at "
                         "Nyquist")

    # dense grid, uniform spacing across all bands (scipy's layout):
    # ~grid_density points per extremal; band edges always on-grid
    df = 0.5 / (grid_density * r)
    grid, des_g, wt_g, seg = [], [], [], []
    pos = 0
    for b in range(n_bands):
        lo, hi = bands[2 * b], bands[2 * b + 1]
        m = max(2, int(np.ceil((hi - lo) / df)) + 1)
        g = np.linspace(lo, hi, m)
        grid.append(g)
        des_g.append(np.full(m, desired[b]))
        wt_g.append(np.full(m, weight[b]))
        seg.append((pos, pos + m))
        pos += m
    grid = np.concatenate(grid)
    des_g = np.concatenate(des_g)
    wt_g = np.concatenate(wt_g)
    if not odd:
        # type II: H(f) = cos(pi f) P(f); fit P on the modified
        # target/weight (standard McClellan transformation)
        c = np.cos(np.pi * grid)
        keep = c > 1e-9          # exclude f = 0.5 where the factor dies
        grid, des_g, wt_g, c = (a[keep] for a in (grid, des_g, wt_g, c))
        des_g = des_g / c
        wt_g = wt_g * c
        kept = np.nonzero(keep)[0]
        remap = {old: new for new, old in enumerate(kept)}
        seg2 = []
        for s, e in seg:
            inside = [remap[i] for i in range(s, e) if i in remap]
            if inside:
                seg2.append((inside[0], inside[-1] + 1))
        seg = seg2
    n_grid = len(grid)
    n_ext = r + 1
    if n_grid < n_ext:
        raise ValueError("bands too narrow for this numtaps: the "
                         "design grid has fewer points than extremals")

    ext = np.round(np.linspace(0, n_grid - 1, n_ext)).astype(int)
    x_g = np.cos(2 * np.pi * grid)

    for _ in range(int(maxiter)):
        xe = x_g[ext]
        de = des_g[ext]
        we = wt_g[ext]
        # barycentric weights on the extremal cosines
        diff = xe[:, None] - xe[None, :]
        np.fill_diagonal(diff, 1.0)
        gamma = _bary_weights(diff)
        signs = (-1.0) ** np.arange(n_ext)
        delta = (gamma @ de) / (gamma @ (signs / we))
        # interpolate H through r of the extremals (drop the last; its
        # value is implied by the leveled error)
        ye = de - signs * delta / we
        h_g = _bary_eval(x_g, xe, ye, gamma)
        err = wt_g * (des_g - h_g)
        # new extremals: ONE candidate per sign-region per band (the
        # |err| argmax of each maximal same-sign run) — a plain
        # local-maximum test loses the tiny +-delta regions squeezed
        # between huge opposite-sign transition peaks, stalling the
        # exchange
        cand = []
        ae = np.abs(err)
        sg = np.sign(err)
        for s, e in seg:
            i = s
            while i < e:
                j = i + 1
                while j < e and sg[j] == sg[i]:
                    j += 1
                cand.append(i + int(np.argmax(ae[i:j])))
                i = j
        # enforce sign alternation: within runs of equal sign keep the
        # largest magnitude
        alt = []
        for i in cand:
            if alt and np.sign(err[i]) == np.sign(err[alt[-1]]):
                if abs(err[i]) > abs(err[alt[-1]]):
                    alt[-1] = i
            else:
                alt.append(i)
        if len(alt) < n_ext:
            # exchange degenerated (flat error) — accept convergence
            break
        # keep the n_ext consecutive candidates with the largest
        # smallest-magnitude member (drop from whichever end is weaker)
        while len(alt) > n_ext:
            if abs(err[alt[0]]) < abs(err[alt[-1]]):
                alt.pop(0)
            else:
                alt.pop()
        new_ext = np.asarray(alt)
        if np.array_equal(new_ext, ext):
            break
        ext = new_ext

    # final cosine-series values at the DFT frequencies via the same
    # barycentric interpolant, then an inverse real-even DFT for taps
    xe = x_g[ext]
    de = des_g[ext]
    we = wt_g[ext]
    diff = xe[:, None] - xe[None, :]
    np.fill_diagonal(diff, 1.0)
    gamma = _bary_weights(diff)
    signs = (-1.0) ** np.arange(n_ext)
    delta = (gamma @ de) / (gamma @ (signs / we))
    ye = de - signs * delta / we

    m = 1 << int(np.ceil(np.log2(8 * numtaps)))
    fgrid = np.arange(m // 2 + 1) / m            # [0, 0.5]
    h_s = _bary_eval(np.cos(2 * np.pi * fgrid), xe, ye, gamma)
    if not odd:
        h_s = h_s * np.cos(np.pi * fgrid)
        h_s[-1] = 0.0                            # the Nyquist zero
    # linear phase: delay (numtaps-1)/2, inverse rfft, center-crop
    shift = np.exp(-1j * np.pi * fgrid * (numtaps - 1) * 2 / 2)
    taps = np.fft.irfft(h_s * shift, m)[:numtaps]
    return taps


def deconvolve(signal, divisor):
    """Polynomial long division (scipy's ``deconvolve``): the
    ``(quotient, remainder)`` with ``signal = convolve(divisor,
    quotient) + remainder``.  An inherently sequential recurrence on
    tiny operands — float64 host-side by design (use :mod:`.iir`'s
    ``lfilter`` machinery for long-signal inverse filtering instead).
    """
    num = np.atleast_1d(np.asarray(signal, np.float64))
    den = np.atleast_1d(np.asarray(divisor, np.float64))
    if num.ndim != 1 or den.ndim != 1:
        raise ValueError("signal and divisor must be 1D")
    if den[0] == 0.0:
        raise ValueError("divisor[0] must be nonzero")
    if len(num) < len(den):
        # scipy convention: empty quotient (the zero polynomial)
        return np.zeros(0), num.copy()
    n_out = len(num) - len(den) + 1
    quot = np.zeros(n_out)
    rem = num.copy()
    for i in range(n_out):
        q = rem[i] / den[0]
        quot[i] = q
        rem[i:i + len(den)] -= q * den
    return quot, rem

