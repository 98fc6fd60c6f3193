"""Sample-rate conversion: polyphase rational resampling + Fourier method.

The port of ``veles.simd_tpu.ops.resample`` (the JAX package's addition
beyond the reference, whose filtering stops at same-rate FIR), computed
with PyTorch on ``Config.device``.

The core is **polyphase**.  Output ``i`` of an up/down conversion reads
sample ``c_i = i·down + c0`` of the full convolution of the zero-stuffed
signal with the taps ``h``, which is ``sum_l h[l·up + r] x[s - l]`` with
``c_i = s·up + r``: only the ``ceil(k/up)`` taps of phase ``r`` meet a
signal sample.  Outputs ``up/g`` apart (g = gcd(up, down)) share their
phase and step ``down/g`` input samples each, so every output phase is
a strided correlation of the signal itself with one sub-filter, and
runs of neighbouring phases, whose windows overlap, go into one
``F.conv1d`` call with one output channel each (fp32 pinned with
``runtime.precision.fp32_conv``).  A run is cut where its window would
pass twice the longest sub-filter, so a row costs at most
``2 · out_len · ceil(k/up)`` multiply-adds, and the zero-stuffed
signal (n·up samples) is never built.  The anti-aliasing FIR is a
host-side windowed-sinc constant; its per-run weights go to the device
once per filter.

Conventions (scipy.signal.resample_poly / resample): output length
``ceil(n * up / down)``, group delay compensated (centered odd-length
filter), DC gain exactly ``up``-compensated.  Oracle twins are float64
NumPy implementing the textbook definitions directly (explicit
zero-stuffing, full convolve, slice).  Results are float32 tensors on
the input's device; ``simd=False`` returns NumPy as the JAX package
does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.ops import iir as _iir
from veles.simd_tpu_torch.runtime import precision as prx
from veles.simd_tpu_torch.utils import benchmark as _bm
from veles.simd_tpu_torch.utils.cache import ConstantCache
from veles.simd_tpu_torch.utils.config import resolve_simd
from veles.simd_tpu_torch.utils.platform import as_f32

__all__ = [
    "design_lowpass", "resample_poly", "resample_poly_na", "upfirdn",
    "upfirdn_na", "upsample",
    "decimate", "resample_fourier", "resample_fourier_na",
    "resample_length",
    "resample_stream_plan", "resample_stream_step",
    "resample_stream_step_na", "resample_stream_oracle",
]

# the polyphase runs' float32 weights on the device, keyed by the taps,
# the rate, the grid offset and the device
_device_cache = ConstantCache(32)
obs.register_cache("resample_device_lru", _device_cache.info)


def design_lowpass(num_taps: int, cutoff: float) -> np.ndarray:
    """Windowed-sinc (Hamming) linear-phase lowpass FIR.

    ``cutoff`` in (0, 1] is the passband edge as a fraction of the
    Nyquist frequency.  Unit DC gain.  Host-side float64.
    """
    if num_taps < 1:
        raise ValueError(f"num_taps must be >= 1, got {num_taps}")
    if not 0.0 < cutoff <= 1.0:
        raise ValueError(f"cutoff must be in (0, 1], got {cutoff}")
    m = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * m)
    h *= np.hamming(num_taps)
    return h / h.sum()


def resample_length(n: int, up: int, down: int) -> int:
    """Output length of :func:`resample_poly`: ``ceil(n * up / down)``."""
    return -((-n * up) // down)


@functools.lru_cache(maxsize=64)
def _resample_taps(up: int, down: int, num_taps) -> np.ndarray:
    """Anti-aliasing filter for an up/down conversion: cutoff at the
    tighter of the two Nyquists, gain ``up`` (to restore amplitude after
    zero-stuffing), odd length (integer group delay).  Designed once
    per rate (0.2 ms of host time at 160/147) and returned read-only,
    as every caller shares it."""
    q = max(up, down)
    if num_taps is None:
        num_taps = 20 * q + 1  # 10 zero-crossings per side, scipy-like
    if num_taps % 2 == 0:
        num_taps += 1  # odd taps -> integer group delay, exact centering
    taps = up * design_lowpass(num_taps, 1.0 / q)
    taps.setflags(write=False)
    return taps


def _normalize_resample_args(n, up, down, taps):
    """Shared argument pipeline for the single-chip and sharded paths:
    gcd-reduce the rate, validate, resolve default taps.  Returns
    ``(up, down, taps_float64)`` (taps is None only for the 1/1 rate).
    """
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got {up}, {down}")
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if n == 0:
        raise ValueError("empty signal")
    if up == 1 and down == 1:
        return up, down, None
    if taps is None:
        taps = _resample_taps(up, down, None)
    taps = np.asarray(taps, np.float64)
    if taps.ndim != 1 or len(taps) % 2 == 0:
        raise ValueError(
            f"taps must be a 1D odd-length filter, got shape {taps.shape}")
    return up, down, taps


def _polyphase_runs(taps: np.ndarray, up: int, down: int, c0: int):
    """Host plan of the polyphase core: ``(P, step, runs)``.

    Output ``i0 + m·P`` (``P = up/g``) reads the signal at ``s_i0 +
    m·step - l`` (``step = down/g``) with sub-filter taps ``h[l·up +
    r_i0]``, where ``i0·down + c0 = s_i0·up + r_i0``.  ``runs`` holds,
    per run of consecutive phases, ``(base, weights)``: the window
    ``x[base + m·step + j]``, j < W, and the float32 weights
    ``[phases, W]`` that read it (zero where a phase has no tap).  A
    run is cut before its window passes ``2 ceil(k/up)`` samples.
    """
    k = len(taps)
    g = math.gcd(up, down)
    n_phase, step = up // g, down // g
    cap = 2 * -(-k // up)
    runs, members, lo, hi = [], [], None, None

    def close():
        base = 0 if lo is None else lo
        width = 1 if lo is None else hi - lo + 1
        w = np.zeros((len(members), width))
        for ch, (r, s) in enumerate(members):
            taps_r = taps[r::up]
            w[ch, s - base - np.arange(len(taps_r))] = taps_r
        runs.append((base, w.astype(np.float32)))

    for i0 in range(n_phase):
        r, s = divmod(i0 * down + c0, up)[::-1]
        n_taps = len(range(r, k, up))
        if n_taps:
            a = s - n_taps + 1
            if lo is not None and max(hi, s) - min(lo, a) + 1 > cap:
                close()
                members, lo, hi = [], None, None
            lo = a if lo is None else min(lo, a)
            hi = s if hi is None else max(hi, s)
        members.append((r, s))
    close()
    return n_phase, step, runs


def _resample_conv_work(x, taps, up, down, out_len, *_, **__):
    """``work=`` of the polyphase core: an output reads at most
    ``ceil(k / up)`` taps (a multiply-add each), the signal and the
    taps read once and the float32 outputs written once."""
    k, rows = len(taps), x.numel() // max(1, x.shape[-1])
    return (2.0 * rows * out_len * -(-k // up),
            4.0 * (x.numel() + k + rows * out_len))


@obs.instrumented_jit(work=_resample_conv_work)
def _resample_conv(x, taps, up, down, out_len, pad=None, runs=None):
    """The polyphase core: ``x[..., n]`` (a float32 tensor) through the
    up/down conversion with the host taps, ``[..., out_len]``.

    The JAX package's dilated, strided correlation, computed by phase
    (module note).  ``pad`` overrides its (left, right) dilated-domain
    padding — the streaming step (and the sharded path) use a negative
    left pad to crop a halo-extended block into global alignment; the
    left pad sets which full-convolution sample output 0 reads
    (``c0 = k - 1 - pad_left``), the right one how many outputs the
    padded span holds.  ``runs`` is the caller's own
    :func:`_device_runs` for this geometry (None reads the device LRU).
    """
    taps = np.asarray(taps, np.float64)
    k = taps.shape[0]
    batch, n = tuple(x.shape[:-1]), x.shape[-1]
    dilated = (n - 1) * up + 1
    if pad is None:
        pad_l = (k - 1) // 2  # group delay of the centered odd filter
        # right padding sized so the final stride window (output index
        # out_len - 1, offset (out_len-1)*down .. +k-1) stays in bounds
        pad = (pad_l, max(0, (out_len - 1) * down + k - pad_l - dilated))
    n_out = max(0, min(out_len,
                       (dilated + pad[0] + pad[1] - k) // down + 1))
    rows = math.prod(batch)
    if n_out == 0:
        return x.new_zeros(batch + (0,))
    c0 = k - 1 - pad[0]
    dev = x.device
    if runs is None:
        runs = _device_cache.get(
            ("runs", taps.tobytes(), up, down, c0, str(dev)),
            lambda: _device_runs(taps, up, down, c0, dev))
    n_phase, step, runs = runs
    m_out = -(-n_out // n_phase)
    spans = [(base, base + (m_out - 1) * step + w.shape[-1])
             for base, w in runs]
    left = max(0, -min(a for a, _ in spans))
    right = max(0, max(b for _, b in spans) - n)
    xp = x.reshape(rows, 1, n)
    if left or right:
        xp = F.pad(xp, (left, right))
    with prx.fp32_conv(dev):
        outs = [F.conv1d(xp[..., a + left:b + left], w, stride=step)
                for (a, b), (_, w) in zip(spans, runs)]
    y = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    # phase-major [rows, P, m] to output order
    y = y.transpose(1, 2).reshape(rows, m_out * n_phase)[:, :n_out]
    return y.reshape(batch + (n_out,))


def _device_runs(taps, up, down, c0, dev):
    n_phase, step, runs = _polyphase_runs(taps, up, down, c0)
    return n_phase, step, [(base, torch.as_tensor(w, device=dev)[:, None])
                           for base, w in runs]


def resample_poly(x, up: int, down: int, taps=None, simd=None):
    """Rational-rate resampling by ``up/down`` with polyphase filtering.

    ``x[..., n] -> [..., ceil(n * up / down)]``.  ``taps`` overrides the
    default windowed-sinc anti-aliasing filter (pass a host array with
    DC gain ``up`` and odd length for transparent substitution).

    Edge semantics: the signal is ZERO-EXTENDED beyond its support —
    output samples within half a filter length of either end see zeros
    outside the signal, so they roll off toward the edges (identical on
    the torch path and the oracle).  This matches
    ``scipy.signal.resample_poly``'s default zero-padding; the
    remaining difference from scipy is the anti-aliasing filter design
    (windowed-sinc Hamming here vs scipy's Kaiser), which shifts
    interior values by ~1e-3 — pass scipy's taps via ``taps=`` for
    exact scipy parity everywhere.
    """
    up, down, taps = _normalize_resample_args(np.shape(x)[-1], up, down,
                                              taps)
    if up == 1 and down == 1:
        return (as_f32(x) if resolve_simd(simd, op="resample")
                else np.asarray(x, np.float32))
    n = np.shape(x)[-1]
    out_len = resample_length(n, up, down)
    if resolve_simd(simd, op="resample"):
        with obs.span("resample_poly.dispatch", up=up, down=down):
            return _resample_conv(as_f32(x), taps, up, down, out_len)
    return resample_poly_na(x, up, down, taps).astype(np.float32)


def resample_poly_na(x, up: int, down: int, taps=None):
    """Float64 oracle twin: explicit zero-stuff, full convolve, stride."""
    up, down = int(up), int(down)
    g = math.gcd(up, down)
    up, down = up // g, down // g
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    if up == 1 and down == 1:
        return x.copy()
    if taps is None:
        taps = _resample_taps(up, down, None)
    taps = np.asarray(taps, np.float64)
    pad = (len(taps) - 1) // 2
    out_len = resample_length(n, up, down)
    full = _zero_stuff_convolve(x, taps, up)
    # centered: drop the group delay, then stride
    y = full[..., pad:][..., ::down]
    out = np.zeros(x.shape[:-1] + (out_len,), np.float64)
    m = min(out_len, y.shape[-1])
    out[..., :m] = y[..., :m]
    return out


def upfirdn(h, x, up: int = 1, down: int = 1, simd=None):
    """The raw polyphase primitive (scipy's ``upfirdn``): upsample by
    ``up`` (zero-stuffing), FIR filter with ``h``, downsample by
    ``down`` — WITHOUT :func:`resample_poly`'s group-delay centering
    or gcd reduction.  Output length ``ceil(((n-1)*up + len(h)) /
    down)`` (the full convolution span, strided), exactly scipy's.

    Runs on the same polyphase core as :func:`resample_poly` with the
    padding overridden to the uncentered full span.
    """
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got {up}, {down}")
    h = np.asarray(h, np.float64)
    if h.ndim != 1 or len(h) == 0:
        raise ValueError("h must be a non-empty 1D filter")
    n = np.shape(x)[-1]
    if n == 0:
        raise ValueError("empty signal")
    k = len(h)
    dilated = (n - 1) * up + 1
    out_len = -(-(dilated + k - 1) // down)
    if resolve_simd(simd, op="resample"):
        # full output span: left pad k-1 (conv start), right pad to
        # cover the last strided window
        pad = (k - 1, max(0, (out_len - 1) * down + k
                          - (k - 1) - dilated))
        with obs.span("upfirdn.dispatch", up=up, down=down):
            return _resample_conv(as_f32(x), h, up, down, out_len,
                                  pad=pad)
    return upfirdn_na(h, x, up, down).astype(np.float32)


def _zero_stuff_convolve(x, h, up: int):
    """Shared float64 oracle core: zero-stuff ``x`` by ``up`` and FULL
    convolve each row with ``h`` (both the centered resample oracle and
    the raw upfirdn oracle stride this)."""
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    stuffed = np.zeros(x.shape[:-1] + ((n - 1) * up + 1,), np.float64)
    stuffed[..., ::up] = x
    flat = stuffed.reshape(-1, stuffed.shape[-1])
    full = np.stack([np.convolve(row, h) for row in flat])
    return full.reshape(x.shape[:-1] + (full.shape[-1],))


def upfirdn_na(h, x, up: int = 1, down: int = 1):
    """Float64 oracle twin of :func:`upfirdn` (explicit zero-stuff,
    full convolve, stride)."""
    h = np.asarray(h, np.float64)
    return _zero_stuff_convolve(x, h, int(up))[..., ::int(down)]


# --------------------------------------------------------------------------
# streaming resample — the pipeline compiler's state-export hooks
# --------------------------------------------------------------------------

def resample_stream_plan(up: int, down: int, block: int,
                         taps=None) -> dict:
    """Host-side streaming plan for a rational resampler stage.

    The one-shot :func:`resample_poly` samples the zero-stuffed full
    convolution ``full`` on the centered grid ``full[pad + j*down]``
    (``pad = (taps - 1) // 2``).  Streaming in fixed ``block``-sample
    input chunks with an ``hist``-sample input-history carry
    (zero-seeded — one-shot's left zero pad), each chunk determines
    exactly ``out_block = block * up / down`` NEW grid samples, but
    the centered filter looks ``pad`` stuffed samples ahead, so the
    stream runs ``preroll = pad // down`` output samples EARLY: the
    emitted grid starts at ``full[pad - preroll*down]`` — the filter's
    left transient — and streamed output ``m`` equals one-shot output
    ``m - preroll`` from ``m = preroll`` on.  Returns the plan dict
    (``up/down/taps/hist/out_block/preroll/pad`` — ``pad`` is the
    dilated-domain (left, right) override for the shared
    :func:`resample_stream_step` conv, derived so the step's output
    window lands exactly on the emitted grid slice).

    Requires ``block * up % down == 0`` (a fixed-shape step needs a
    constant per-block emission) and a block at least as long as the
    carried history (the halo must be fully refreshed every step).
    """
    up, down, taps = _normalize_resample_args(int(block), up, down,
                                              taps)
    if up == 1 and down == 1:
        raise ValueError("1/1 rate needs no resample stage")
    block = int(block)
    if (block * up) % down != 0:
        raise ValueError(
            f"block {block} * up {up} must be divisible by down "
            f"{down} (fixed-shape streaming needs a constant "
            "per-block emission)")
    k = len(taps)
    pad_c = (k - 1) // 2
    hist = -(-(k - 1) // up)          # ceil: halo covers the filter
    if block < hist:
        raise ValueError(
            f"block {block} shorter than the {hist}-sample carry for "
            f"{k} taps (choose a larger block or shorter filter)")
    out_block = block * up // down
    preroll = pad_c // down
    # emitted grid within the halo-extended chunk's full convolution:
    # first sample at full_ext[r_start], stepping by down (constant
    # for every block — the halo shifts with the stream)
    r_start = pad_c + hist * up - preroll * down
    pad_l = k - 1 - r_start
    dilated_ext = (hist + block - 1) * up + 1
    pad_r = max(0, (out_block - 1) * down + k - pad_l - dilated_ext)
    return {"up": up, "down": down, "taps": taps, "hist": hist,
            "out_block": out_block, "preroll": preroll,
            "pad": (pad_l, pad_r)}


def _stream_runs(plan: dict, dev):
    """The device weights :func:`resample_stream_step` reads for
    ``plan``; a caller that holds them (the pipeline's stage) passes
    them as ``runs``."""
    taps = np.asarray(plan["taps"], np.float64)
    return _device_runs(taps, plan["up"], plan["down"],
                        len(taps) - 1 - plan["pad"][0], dev)


def resample_stream_step(x_ext, taps, plan: dict, runs=None):
    """One-block resample step: ``x_ext[..., hist + block]`` (carry +
    new chunk) -> ``[..., out_block]`` on the streaming grid of
    :func:`resample_stream_plan`.  Runs the same polyphase core as
    :func:`resample_poly` with the plan's padding; ``taps`` is the host
    array (``plan["taps"]``); ``runs`` is the caller's own
    :func:`_stream_runs` (None reads the device LRU)."""
    return _resample_conv(as_f32(x_ext), taps, plan["up"], plan["down"],
                          plan["out_block"], pad=plan["pad"], runs=runs)


def resample_stream_step_na(x_ext, plan: dict):
    """NumPy float64 oracle twin of :func:`resample_stream_step`
    (the pipeline's stage-by-stage degradation path): the same
    emitted-grid slice of the zero-stuffed full convolution, derived
    from the SAME plan — the grid math lives here, next to the pad
    derivation it mirrors, so the pair cannot drift apart."""
    x_ext = np.asarray(x_ext, np.float64)
    full = _zero_stuff_convolve(x_ext, plan["taps"], plan["up"])
    r_start = len(plan["taps"]) - 1 - plan["pad"][0]
    need = r_start + (plan["out_block"] - 1) * plan["down"] + 1
    if need > full.shape[-1]:
        wpad = ([(0, 0)] * (full.ndim - 1)
                + [(0, need - full.shape[-1])])
        full = np.pad(full, wpad)
    return full[..., r_start::plan["down"]][..., :plan["out_block"]]


def resample_stream_oracle(x, plan: dict):
    """NumPy float64 one-shot oracle of the STREAMING grid: what
    chunked :func:`resample_stream_step` calls emit over the whole
    signal, computed whole-signal (the pipeline parity reference and
    the stage-by-stage degradation path)."""
    x = np.asarray(x, np.float64)
    up, down = plan["up"], plan["down"]
    n = x.shape[-1]
    if (n * up) % down != 0:
        raise ValueError("signal length must be whole blocks")
    total = n * up // down
    k = len(plan["taps"])
    pad_c = (k - 1) // 2
    start = pad_c - plan["preroll"] * down
    full = _zero_stuff_convolve(x, plan["taps"], up)
    need = start + (total - 1) * down + 1
    if need > full.shape[-1]:
        wpad = [(0, 0)] * (full.ndim - 1) + [(0, need - full.shape[-1])]
        full = np.pad(full, wpad)
    return full[..., start::down][..., :total]


def upsample(x, factor: int, taps=None, simd=None):
    """Integer-rate interpolation: ``resample_poly(x, factor, 1)``."""
    return resample_poly(x, factor, 1, taps=taps, simd=simd)


def decimate(x, factor: int, taps=None, ftype: str = "fir",
             zero_phase: bool = True, simd=None):
    """Integer-rate anti-aliased decimation.

    ``ftype='fir'`` (default here): polyphase
    ``resample_poly(x, 1, factor)`` — one strided device conv
    (``zero_phase`` has no effect; the centered linear-phase FIR
    already has none).  ``ftype='iir'``: scipy ``decimate``'s default
    path — an order-8 Chebyshev-I (0.05 dB) lowpass at ``0.8/factor``
    Nyquist, applied zero-phase (``sosfiltfilt``) or causally
    (``sosfilt``), then sliced ``[..., ::factor]``.  NOTE scipy
    defaults to 'iir'; the default differs here because the polyphase
    form does the anti-aliasing work at the DECIMATED rate.
    """
    factor = int(factor)
    if ftype == "fir":
        return resample_poly(x, 1, factor, taps=taps, simd=simd)
    if ftype != "iir":
        raise ValueError(f"ftype must be 'fir' or 'iir', got {ftype!r}")
    if factor < 1:
        raise ValueError("factor must be >= 1")
    if taps is not None:
        raise ValueError("taps only applies to ftype='fir'")
    sos = _iir.cheby1(8, 0.05, 0.8 / factor)
    if zero_phase:
        y = _iir.sosfiltfilt(sos, x, simd=simd)
    else:
        y = _iir.sosfilt(sos, x, simd=simd)
    return y[..., ::factor]


@obs.instrumented_jit(
    op="resample_fourier_xla",
    work=lambda x, num: (
        x.numel() // max(1, x.shape[-1]) * (
            _bm.rfft_flops(x.shape[-1]) + _bm.rfft_flops(num)),
        4.0 * (x.numel() + x.numel() // max(1, x.shape[-1]) * num)))
def _resample_fourier_torch(x, num):
    n = x.shape[-1]
    spec = torch.fft.rfft(x, dim=-1)
    bins_in = n // 2 + 1
    bins_out = num // 2 + 1
    if num < n:
        kept = spec[..., :bins_out]
        # the output Nyquist bin folds the kept ±f_nyq pair: their joint
        # time contribution is 2*Re(X[num/2])*(-1)^t (X and conj(X))
        if num % 2 == 0:
            kept[..., -1] = 2 * kept[..., -1].real
    elif num == n:
        kept = spec
    else:
        kept = spec.new_zeros(spec.shape[:-1] + (bins_out,))
        kept[..., :bins_in] = spec
        # the input's even-n Nyquist bin becomes an interior bin whose
        # Hermitian partner is now explicit in the implied full
        # spectrum: split its (real) weight between the ±f pair
        if n % 2 == 0:
            kept[..., bins_in - 1] *= 0.5
    return torch.fft.irfft(kept, num, dim=-1) * (num / n)


def resample_fourier(x, num: int, simd=None):
    """Fourier-domain resampling to exactly ``num`` samples (the
    scipy.signal.resample method): truncate or zero-pad the spectrum
    (``torch.fft``).  Exact for signals bandlimited below the output
    Nyquist; assumes periodicity (use :func:`resample_poly` for
    streaming data)."""
    num = int(num)
    if num < 1:
        raise ValueError(f"num must be >= 1, got {num}")
    if np.shape(x)[-1] == 0:
        raise ValueError("empty signal")
    if resolve_simd(simd, op="resample"):
        return _resample_fourier_torch(as_f32(x), num)
    return resample_fourier_na(x, num).astype(np.float32)


def resample_fourier_na(x, num: int):
    """Float64 oracle twin of :func:`resample_fourier`."""
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    spec = np.fft.rfft(x, axis=-1)
    bins_in, bins_out = n // 2 + 1, num // 2 + 1
    if num < n:
        kept = spec[..., :bins_out].copy()
        if num % 2 == 0:  # fold the kept ±f_nyq pair (see the torch twin)
            kept[..., -1] = 2 * kept[..., -1].real
    elif num == n:
        kept = spec
    else:
        kept = np.zeros(spec.shape[:-1] + (bins_out,), np.complex128)
        kept[..., :bins_in] = spec
        if n % 2 == 0:  # old Nyquist becomes interior: split its weight
            kept[..., bins_in - 1] *= 0.5
    return np.fft.irfft(kept, num, axis=-1) * (num / n)
