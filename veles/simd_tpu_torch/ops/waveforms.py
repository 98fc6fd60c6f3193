"""Test-signal generation: chirps, rectangular/sawtooth waves, pulses,
maximum-length sequences and analysis windows.

The port of ``veles.simd_tpu.ops.waveforms`` (scipy.signal
conventions: ``chirp``, ``square``, ``sawtooth``, ``gausspulse``,
``unit_impulse``, ``max_len_seq``, ``get_window``).  The generators
are elementwise closed forms over a time array, computed in float32
with PyTorch on ``Config.device`` (a tensor argument stays on its own
device); phase accumulations are exact polynomial or log forms, not
cumulative sums, so long sweeps do not drift.  ``max_len_seq`` (a
sequential register by definition) and ``get_window`` are host-side
NumPy, as in the JAX package.  The ``_na`` twins compute the same
definitions in float64 NumPy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from veles.simd_tpu_torch.utils.config import resolve_simd
from veles.simd_tpu_torch.utils.platform import as_f32, device

__all__ = [
    "chirp", "chirp_na", "square", "square_na", "sawtooth",
    "sawtooth_na", "gausspulse", "gausspulse_na", "unit_impulse",
    "max_len_seq", "get_window",
]


def _chirp_phase(t, f0, t1, f1, method, xp):
    f0, t1, f1 = float(f0), float(t1), float(f1)
    if t1 <= 0:
        raise ValueError("t1 must be > 0")
    if method == "linear":
        beta = (f1 - f0) / t1
        return 2 * math.pi * (f0 * t + beta / 2 * t * t)
    if method == "quadratic":
        beta = (f1 - f0) / (t1 * t1)
        return 2 * math.pi * (f0 * t + beta * t ** 3 / 3)
    if method == "logarithmic":
        if f0 <= 0 or f1 <= 0:
            raise ValueError("logarithmic sweep needs f0, f1 > 0")
        if f0 == f1:
            return 2 * math.pi * f0 * t
        ratio = f1 / f0
        return (2 * math.pi * f0 * t1 / math.log(ratio)
                * (ratio ** (t / t1) - 1.0))
    if method == "hyperbolic":
        if f0 == 0 or f1 == 0:
            raise ValueError("hyperbolic sweep needs nonzero f0, f1")
        if f0 == f1:
            return 2 * math.pi * f0 * t
        # phase = 2*pi*f0*f1*t1/(f0-f1) * ln(((f0-f1)t + f1*t1)/(f1*t1))
        sing = -f1 * t1 / (f0 - f1)
        return (2 * math.pi * f0 * f1 * t1 / (f0 - f1)
                * xp.log(xp.abs(1.0 - t / sing)))
    raise ValueError(f"unknown chirp method {method!r}")


def chirp(t, f0, t1, f1, method: str = "linear", phi: float = 0.0,
          simd=None):
    """Frequency-swept cosine (scipy's ``chirp``): instantaneous
    frequency runs from ``f0`` at t=0 to ``f1`` at ``t1`` along a
    linear / quadratic / logarithmic / hyperbolic law.  ``phi`` is the
    initial phase in degrees (scipy convention)."""
    if resolve_simd(simd, op="waveforms"):
        tt = as_f32(t)
        phase = _chirp_phase(tt, f0, t1, f1, method, torch)
        return torch.cos(phase + math.radians(float(phi)))
    return chirp_na(t, f0, t1, f1, method, phi).astype(np.float32)


def chirp_na(t, f0, t1, f1, method: str = "linear", phi: float = 0.0):
    """NumPy float64 oracle twin of :func:`chirp`."""
    t = np.asarray(t, np.float64)
    phase = _chirp_phase(t, f0, t1, f1, method, np)
    return np.cos(phase + math.radians(float(phi)))


def _check_frac(value, name) -> float:
    value = float(value)
    if not 0.0 <= value <= 1.0:
        raise ValueError(f"{name} {value} must be in [0, 1]")
    return value


def _cycle_frac(t):
    """Fraction of the ``2*pi`` cycle (``np.mod`` semantics: the sign
    of the divisor, which ``torch.remainder`` shares)."""
    if isinstance(t, torch.Tensor):
        return torch.remainder(t, 2 * math.pi) / (2 * math.pi)
    return np.mod(t, 2 * math.pi) / (2 * math.pi)


def _square_core(t, duty):
    frac = _cycle_frac(t)
    if isinstance(t, torch.Tensor):
        return torch.where(frac < duty, 1.0, -1.0).to(torch.float32)
    return np.where(frac < duty, 1.0, -1.0)


def _sawtooth_core(t, width):
    frac = _cycle_frac(t)
    up = 2.0 * frac / max(width, 1e-30) - 1.0
    down = 1.0 - 2.0 * (frac - width) / max(1.0 - width, 1e-30)
    if isinstance(t, torch.Tensor):
        return torch.where(frac < width, up, down)
    return np.where(frac < width, up, down)


def square(t, duty: float = 0.5, simd=None):
    """Square wave of period ``2*pi`` over phase array ``t`` — +1 for
    the first ``duty`` fraction of each cycle, -1 after (scipy's
    ``square``)."""
    duty = _check_frac(duty, "duty")
    if resolve_simd(simd, op="waveforms"):
        return _square_core(as_f32(t), duty)
    return square_na(t, duty).astype(np.float32)


def square_na(t, duty: float = 0.5):
    duty = _check_frac(duty, "duty")
    return _square_core(np.asarray(t, np.float64), duty)


def sawtooth(t, width: float = 1.0, simd=None):
    """Sawtooth/triangle of period ``2*pi`` (scipy's ``sawtooth``):
    rises -1→1 over the first ``width`` fraction of the cycle, falls
    back over the rest (``width=0.5`` is a symmetric triangle)."""
    width = _check_frac(width, "width")
    if resolve_simd(simd, op="waveforms"):
        return _sawtooth_core(as_f32(t), width)
    return sawtooth_na(t, width).astype(np.float32)


def sawtooth_na(t, width: float = 1.0):
    width = _check_frac(width, "width")
    return _sawtooth_core(np.asarray(t, np.float64), width)


def _gauss_a(fc, bw, bwr):
    fc, bw, bwr = float(fc), float(bw), float(bwr)
    if fc <= 0:
        raise ValueError("center frequency fc must be > 0")
    if bw <= 0:
        raise ValueError("fractional bandwidth bw must be > 0")
    if bwr >= 0:
        raise ValueError("bwr must be < 0 dB")
    ref = 10.0 ** (bwr / 20.0)
    return -(math.pi * fc * bw) ** 2 / (4.0 * math.log(ref))


def gausspulse(t, fc: float = 1000.0, bw: float = 0.5,
               bwr: float = -6.0, simd=None):
    """Gaussian-modulated sinusoid (scipy's ``gausspulse`` real part):
    carrier ``fc`` Hz, fractional bandwidth ``bw`` measured ``bwr`` dB
    down the spectral envelope."""
    a = _gauss_a(fc, bw, bwr)
    if resolve_simd(simd, op="waveforms"):
        tt = as_f32(t)
        return (torch.exp(-a * tt * tt)
                * torch.cos(2 * math.pi * float(fc) * tt))
    return gausspulse_na(t, fc, bw, bwr).astype(np.float32)


def gausspulse_na(t, fc: float = 1000.0, bw: float = 0.5,
                  bwr: float = -6.0):
    t = np.asarray(t, np.float64)
    a = _gauss_a(fc, bw, bwr)
    return np.exp(-a * t * t) * np.cos(2 * np.pi * float(fc) * t)


def unit_impulse(n: int, idx: int = 0, simd=None):
    """Length-``n`` impulse with a 1 at ``idx`` (scipy's
    ``unit_impulse``; ``idx='mid'`` centers it)."""
    n = int(n)
    if n < 1:
        raise ValueError("n must be >= 1")
    if idx == "mid":
        idx = n // 2
    idx = int(idx)
    if not 0 <= idx < n:
        raise ValueError(f"idx {idx} outside [0, {n})")
    if resolve_simd(simd, op="waveforms"):
        out = torch.zeros(n, dtype=torch.float32, device=device())
        out[idx] = 1.0
        return out
    out = np.zeros(n, np.float32)
    out[idx] = 1.0
    return out


# the standard primitive-polynomial tap table (scipy's _mls_taps)
_MLS_TAPS = {2: [1], 3: [2], 4: [3], 5: [3], 6: [5], 7: [6], 8: [7, 6, 1],
             9: [5], 10: [7], 11: [9], 12: [11, 10, 4], 13: [12, 11, 8],
             14: [13, 12, 2], 15: [14], 16: [15, 13, 4], 17: [14],
             18: [11], 19: [18, 17, 14], 20: [17], 21: [19], 22: [21],
             23: [18], 24: [23, 22, 17], 25: [22], 26: [25, 24, 20],
             27: [26, 25, 22], 28: [25], 29: [27], 30: [29, 28, 7],
             31: [28], 32: [31, 30, 10]}


def max_len_seq(nbits: int, state=None, length=None):
    """Maximum-length sequence (scipy's ``max_len_seq``): the
    ``2^nbits - 1``-periodic pseudo-random binary sequence from a
    Fibonacci LFSR — the classic broadband excitation for impulse-
    response measurement (its circular autocorrelation is a delta).

    Returns ``(seq, final_state)`` with ``seq`` uint8 in {0, 1}.
    Host-side NumPy (a sequential register by definition); map to ±1
    and hand the result to the device pipeline.  Lengths are capped at
    2^22 — large ``nbits`` stay usable by passing an explicit
    ``length`` and resuming via ``state``.
    """
    nbits = int(nbits)
    if nbits not in _MLS_TAPS:
        raise ValueError(f"nbits must be in [2, 32], got {nbits}")
    period = (1 << nbits) - 1
    length = period if length is None else int(length)
    if length < 0:
        raise ValueError("length must be >= 0")
    if length > 1 << 22:
        raise ValueError(
            f"length {length} > 2^22: the per-bit host loop would take "
            "minutes+; generate in <= 4M-sample pieces (resume with the "
            "returned state) or reduce nbits")
    if state is None:
        reg = np.ones(nbits, np.int8)
    else:
        reg = (np.asarray(state) != 0).astype(np.int8)
        if reg.shape != (nbits,) or not reg.any():
            raise ValueError(f"state must be {nbits} bits, not all zero")
    taps = _MLS_TAPS[nbits]
    out = np.empty(length, np.uint8)
    # scipy's register convention: emit reg[0], feedback from the
    # absolute tap positions, shift left, feedback enters at the tail
    for i in range(length):
        fb = reg[0]
        out[i] = fb
        for t in taps:
            fb ^= reg[t]
        reg[:-1] = reg[1:]
        reg[-1] = fb
    return out, reg


def _cosine_sum_window(n: int, coeffs) -> np.ndarray:
    """Symmetric generalized cosine-sum window
    ``sum_k (-1)^k a_k cos(2 pi k t / (n-1))``."""
    if n == 1:
        return np.ones(1)
    t = np.arange(n, dtype=np.float64)
    w = np.zeros(n)
    for k, a in enumerate(coeffs):
        w += ((-1.0) ** k) * a * np.cos(2 * np.pi * k * t / (n - 1))
    return w


def get_window(name, n: int, **kwargs) -> np.ndarray:
    """SYMMETRIC analysis windows by name (the common
    ``scipy.signal.get_window`` names with ``fftbins=False`` — note
    scipy's own default is the periodic form): 'hann', 'hamming',
    'blackman', 'blackmanharris', 'nuttall', 'flattop', 'bartlett',
    'cosine', 'boxcar', 'tukey' (``alpha=``, default 0.5), 'gaussian'
    (needs ``std=``), or 'kaiser' (needs ``beta=``).  scipy's
    ``(name, param)`` tuple convention is accepted for the
    parameterized windows — ``("kaiser", beta)``, ``("gaussian",
    std)``, ``("tukey", alpha)``.  Float64 host-side — pass the result
    to :func:`~veles.simd_tpu_torch.ops.spectral.stft`/``welch`` or use
    as FIR taps weighting."""
    n = int(n)
    if n < 1:
        raise ValueError("n must be >= 1")
    _PARAM_KEY = {"kaiser": "beta", "gaussian": "std", "tukey": "alpha"}
    if isinstance(name, (tuple, list)):
        # scipy's ("kaiser", beta) tuple convention
        if len(name) != 2 or not isinstance(name[0], str):
            raise ValueError(f"window tuple must be (name, param), "
                             f"got {name!r}")
        if kwargs:
            raise ValueError(
                f"unexpected arguments {sorted(kwargs)}: the tuple "
                "form already carries the window parameter")
        key = _PARAM_KEY.get(str(name[0]).lower())
        if key is None:
            raise ValueError(f"window {name[0]!r} takes no parameter; "
                             "pass the bare name")
        return get_window(name[0], n, **{key: float(name[1])})
    name = str(name).lower()
    allowed = ({_PARAM_KEY[name]} if name in _PARAM_KEY else set())
    stray = set(kwargs) - allowed
    if stray:
        raise ValueError(f"unexpected arguments {sorted(stray)} for "
                         f"window {name!r}")
    if name in ("hann", "hanning"):
        return np.hanning(n)
    if name == "hamming":
        return np.hamming(n)
    if name == "blackman":
        return np.blackman(n)
    if name == "blackmanharris":
        return _cosine_sum_window(n, (0.35875, 0.48829, 0.14128,
                                      0.01168))
    if name == "nuttall":
        return _cosine_sum_window(n, (0.3635819, 0.4891775, 0.1365995,
                                      0.0106411))
    if name == "flattop":
        return _cosine_sum_window(
            n, (0.21557895, 0.41663158, 0.277263158, 0.083578947,
                0.006947368))
    if name == "bartlett":
        return np.bartlett(n)
    if name == "cosine":
        return np.sin(np.pi * (np.arange(n) + 0.5) / n)
    if name in ("boxcar", "rect", "rectangular"):
        return np.ones(n)
    if name == "tukey":
        alpha = float(kwargs.get("alpha", 0.5))
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("tukey alpha must be in [0, 1]")
        if alpha == 0.0 or n == 1:
            return np.ones(n)
        t = np.arange(n, dtype=np.float64) / (n - 1)
        w = np.ones(n)
        edge = t < alpha / 2
        w[edge] = 0.5 * (1 + np.cos(np.pi * (2 * t[edge] / alpha - 1)))
        edge = t >= 1 - alpha / 2
        w[edge] = 0.5 * (1 + np.cos(np.pi * (2 * t[edge] / alpha
                                             - 2 / alpha + 1)))
        return w
    if name == "gaussian":
        if "std" not in kwargs:
            raise ValueError("gaussian window needs std=")
        t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
        return np.exp(-0.5 * (t / float(kwargs["std"])) ** 2)
    if name == "kaiser":
        if "beta" not in kwargs:
            raise ValueError("kaiser window needs beta=")
        return np.kaiser(n, float(kwargs["beta"]))
    raise ValueError(f"unknown window {name!r}")
