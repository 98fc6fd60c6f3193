"""The least work of each benchmarked operation, and the H100's peaks.

Frozen copy of ``conv_work``, ``rfft_flops``, ``filter_bank_work``,
``stft_work``, ``fp32_bound`` and the H100 peaks of
``veles/simd_tpu_torch/utils/benchmark.py`` at commit
``6aec0c295a27add59d868157438f6a1a29c48632``, so that a change to the
program cannot move the yardstick.  ``dwt_work`` is the benchmark's own.

A bound counts the function's least work, whatever route implements it:
each input byte read once, each output byte written once, and the fewer
operations of the direct and the FFT forms where both exist.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, 700 W, dense rates without sparsity
H100_FP32_TFLOPS = 67.0
H100_HBM_TBPS = 3.35


def rfft_flops(n: int) -> float:
    """Operations of a real FFT of ``n`` samples: half the usual
    ``5 n log2 n`` of a complex one (the split-radix estimate)."""
    n = int(n)
    return 2.5 * n * math.log2(n)


def fp32_bound(flops: float, nbytes: float) -> tuple[float, str]:
    """``(ms, bound_by)``: the least time for ``flops`` fp32 operations
    that move ``nbytes``, and whether ``"operations"`` or ``"bytes"``
    set it."""
    t_ops = float(flops) / (H100_FP32_TFLOPS * 1e12) * 1e3
    t_bytes = float(nbytes) / (H100_HBM_TBPS * 1e12) * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations"
    return t_bytes, "bytes"


def conv_work(rows: int, n: int, k: int) -> tuple[float, float]:
    """``(flops, bytes)`` of a full float32 linear convolution of
    ``rows`` signals of ``n`` samples with one ``k``-tap filter.  The
    operations are the smaller of the direct form (one multiply-add per
    (sample, tap) pair) and an FFT overlap-save (segments of N, a power
    of two >= 2k, each a forward and an inverse real FFT and a complex
    product per bin, plus the taps' FFT), the least over N up to 2^20.
    The bytes read the signal and taps once and write the ``n + k - 1``
    outputs once."""
    rows, n, k = int(rows), int(n), int(k)
    out_len = n + k - 1
    flops = 2.0 * rows * n * k
    N = 1 << max(1, (2 * k - 1).bit_length())
    while N <= 1 << 20:
        segs = -(-out_len // (N - k + 1))
        fft_form = (rows * segs * (2 * rfft_flops(N) + 6 * (N // 2 + 1))
                    + rfft_flops(N))
        flops = min(flops, fft_form)
        N *= 2
    nbytes = 4.0 * (rows * n + k + rows * out_len)
    return flops, nbytes


def stft_work(rows: int, n: int, frame_length: int,
              hop: int) -> tuple[float, float]:
    """``(flops, bytes)`` of a float32 STFT of ``rows`` signals of ``n``
    samples: per frame, ``L`` window multiplies and a real FFT; the
    signal and window read once, the complex64 spectrum written once."""
    rows, n, L, hop = int(rows), int(n), int(frame_length), int(hop)
    frames = 1 + (n - L) // hop
    cols = 2 * (L // 2 + 1)
    flops = rows * frames * (L + rfft_flops(L))
    nbytes = 4.0 * (rows * n + L + rows * frames * cols)
    return flops, nbytes


def filter_bank_work(rows: int, n_in: int, channels: int, k: int,
                     n_out: int) -> tuple[float, float]:
    """``(flops, bytes)`` of a float32 FIR bank: ``channels`` filters
    of ``k`` taps, each giving ``n_out`` outputs a row of ``rows``
    signals of ``n_in`` samples (one multiply-add per output and tap).
    The bytes read the input and the taps once and write every
    channel's outputs once."""
    rows, n_in, channels, k, n_out = (int(v) for v in (rows, n_in,
                                                       channels, k,
                                                       n_out))
    flops = 2.0 * channels * k * rows * n_out
    nbytes = 4.0 * (rows * n_in + channels * k + channels * rows * n_out)
    return flops, nbytes


def dwt_work(rows: int, n: int, k: int, levels: int) -> tuple[float, float]:
    """``(flops, bytes)`` of a ``levels``-level decimated float32 DWT of
    ``rows`` signals of ``n`` samples with a ``k``-tap filter pair: at
    level l, two channels of ``n / 2^l`` outputs a row, one multiply-add
    per output and tap.  The bytes read the input and both filters once
    and write the bands once: ``levels`` highpass bands and the last
    lowpass, ``n`` samples a row in all.  The intermediate lowpass
    bands need not leave the chip, so they move nothing."""
    rows, n, k, levels = int(rows), int(n), int(k), int(levels)
    flops = sum(2.0 * 2 * k * rows * (n >> lvl)
                for lvl in range(1, levels + 1))
    nbytes = 4.0 * (rows * n + 2 * k + rows * n)
    return flops, nbytes
