"""Plain reference of the ``conv1d_1m`` configuration.

The full linear convolution ``y[r, t] = sum_j h[j] x[r, t - j]``,
``0 <= t < n + k - 1``, of every row of ``x`` with the filter ``h``
(the reference library's ``convolve``, ``inc/simd/convolve.h``),
computed in float64 as one zero-padded FFT product a row, in blocks of
rows.  Plain PyTorch only: it imports nothing of the program and works
from the operands the benchmark made.

``control=True`` computes it from operands rounded to TF32 (ten
mantissa bits, round to nearest), which is what a float32 product on
the tensor cores with TF32 on multiplies: the step below the float32
with TF32 off that the configuration states.  Its sums stay exact, so
it errs less than a real TF32 route would.
"""

import torch

_ROWS_A_BLOCK = 8


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's ten mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def expected(params, x, fixed, control=False):
    """``[y]``: the float64 convolution of ``x`` (``[rows, n]``) with
    ``fixed["h"]``."""
    h = fixed["h"]
    if control:
        x, h = tf32(x), tf32(h)
    n, k = x.shape[-1], h.shape[-1]
    m = n + k - 1
    size = 1 << (m - 1).bit_length()
    spec_h = torch.fft.rfft(h.to(torch.float64), size)
    y = torch.empty(x.shape[0], m, dtype=torch.float64, device=x.device)
    for r0 in range(0, x.shape[0], _ROWS_A_BLOCK):
        block = x[r0:r0 + _ROWS_A_BLOCK].to(torch.float64)
        y[r0:r0 + _ROWS_A_BLOCK] = torch.fft.irfft(
            torch.fft.rfft(block, size) * spec_h, size)[:, :m]
    return [y]
