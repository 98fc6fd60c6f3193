"""Plain reference of the ``stft_2p20`` configuration.

The short-time Fourier transform ``X[r, f, k] = sum_t w[t] x[r, f hop
+ t] e^{-2 pi i t k / L}``, ``0 <= k <= L // 2``, of every row of
``x`` over ``1 + (n - L) // hop`` frames, with the periodic Hann
window ``w[t] = 0.5 - 0.5 cos(2 pi t / L)`` (scipy's ``fftbins=True``
Hann, which librosa.stft uses, and ``torch.hann_window``, which
Whisper's front end uses), computed in float64 as ``unfold`` frames
times the window, then ``torch.fft.rfft``, in blocks of rows.  Plain
PyTorch only: it imports nothing of the program and works from the
operands the benchmark made.

Departures from the sources: no centre padding (both sources default
to ``center=True``, which pads ``L // 2`` samples at each end, so a
2^20-sample row gives 2045 frames at 2048/512 where librosa gives 2049
and 6552 at 400/160 where Whisper's ``torch.stft`` gives 6554); the
layout is ``[rows, frames, bins]`` where librosa's is ``[bins,
frames]``; the result is returned as ``torch.view_as_real`` of the
complex128 spectrum, ``[rows, frames, bins, 2]``.

``control=True`` computes it from the signal and the window rounded
to TF32 (ten mantissa bits, round to nearest), which is what a float32
product on the tensor cores with TF32 on multiplies: the step below
the float32 with TF32 off that the configuration states.  Its sums stay
exact, so it errs less than a real TF32 route would.
"""

import math

import torch

_ROWS_A_BLOCK = 8


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's ten mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def hann(frame_length: int, device=None) -> torch.Tensor:
    """The periodic Hann window of ``frame_length`` samples, float64."""
    t = torch.arange(frame_length, dtype=torch.float64, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * t / frame_length)


def expected(params, x, fixed, control=False):
    """``[view_as_real(X)]``: the float64 STFT of ``x`` (``[rows, n]``)
    at ``params``' ``frame_length`` and ``hop``."""
    L, hop = int(params["frame_length"]), int(params["hop"])
    window = hann(L, x.device)
    if control:
        x = tf32(x)
        window = tf32(window.to(torch.float32)).to(torch.float64)
    rows, n = x.shape
    frames = 1 + (n - L) // hop
    out = torch.empty(rows, frames, L // 2 + 1, dtype=torch.complex128,
                      device=x.device)
    for r0 in range(0, rows, _ROWS_A_BLOCK):
        block = x[r0:r0 + _ROWS_A_BLOCK].to(torch.float64)
        out[r0:r0 + _ROWS_A_BLOCK] = torch.fft.rfft(
            block.unfold(-1, L, hop) * window, dim=-1)
    return [torch.view_as_real(out)]
