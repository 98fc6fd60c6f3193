"""1D cross-correlation — convolution with a reversed kernel.

The port of ``veles.simd_tpu.ops.correlate`` (rebuild of the
reference's ``src/correlate.c``).  With ``j`` indexing the ``x_length +
h_length - 1`` output,

    result[j] = Σ_m x[m] · h[m + h_length - 1 - j]

which is exactly ``convolve(x, reverse(h))``.  The same algorithms and
handle API as :mod:`veles.simd_tpu_torch.ops.convolve` apply;
``reverse=True`` handles fold the flip into the routes and kernels.
"""

from __future__ import annotations

import numpy as np

from veles.simd_tpu_torch.ops import convolve as _conv
from veles.simd_tpu_torch.ops.convolve import (
    ConvolutionAlgorithm, ConvolutionHandle)
from veles.simd_tpu_torch.utils.config import resolve_simd

__all__ = [
    "ConvolutionAlgorithm", "ConvolutionHandle",
    "cross_correlate_simd", "cross_correlate_na",
    "cross_correlate_fft", "cross_correlate_fft_initialize",
    "cross_correlate_fft_finalize",
    "cross_correlate_overlap_save", "cross_correlate_overlap_save_initialize",
    "cross_correlate_overlap_save_finalize",
    "cross_correlate", "cross_correlate_initialize",
    "cross_correlate_finalize", "correlation_lags",
]


def cross_correlate_na(x, h):
    """Direct-form oracle (``src/correlate.c:118-124`` scalar branch)."""
    h = np.asarray(h, np.float32)
    return _conv.convolve_na(x, h[..., ::-1])


def cross_correlate_simd(x, h, simd=None):
    """Direct form (``inc/simd/correlate.h:41-56``)."""
    if resolve_simd(simd, op="correlate"):
        return _conv._direct(*_conv._operands(x, h), reverse=True)
    return cross_correlate_na(x, h)


def cross_correlate_fft_initialize(x_length, h_length):
    """``src/correlate.c:37-43`` — FFT plan with ``reverse=1``."""
    return _conv.convolve_fft_initialize(x_length, h_length, reverse=True)


def cross_correlate_fft(handle, x, h, simd=None):
    return _conv.convolve_fft(handle, x, h, simd)


def cross_correlate_fft_finalize(handle):
    """No-op (``src/correlate.c:50-52``)."""


def cross_correlate_overlap_save_initialize(x_length, h_length):
    """``src/correlate.c:54-60``."""
    return _conv.convolve_overlap_save_initialize(x_length, h_length,
                                                  reverse=True)


def cross_correlate_overlap_save(handle, x, h, simd=None):
    return _conv.convolve_overlap_save(handle, x, h, simd)


def cross_correlate_overlap_save_finalize(handle):
    """No-op (``src/correlate.c:69-72``)."""


def cross_correlate_initialize(x_length, h_length, algorithm=None):
    """``src/correlate.c:128-143`` — auto-select with reverse set."""
    return _conv.convolve_initialize(x_length, h_length, algorithm,
                                     reverse=True)


def cross_correlate(handle_or_x, x_or_h, h=None, simd=None, *,
                    mode="full"):
    """``src/correlate.c:145-159``; also the convenience
    ``cross_correlate(x, h)`` form, and numpy's ``mode``
    ('full'/'same'/'valid') slicing of the full result."""
    _conv._check_mode(mode)
    if isinstance(handle_or_x, ConvolutionHandle):
        out = _conv._run(handle_or_x, x_or_h, h, simd)
        return _conv._mode_slice(out, handle_or_x.x_length,
                                 handle_or_x.h_length, mode,
                                 correlate=handle_or_x.reverse)
    x, h_ = handle_or_x, x_or_h
    if h is not None:
        simd = h
    n, k = _conv._length(x), _conv._length(h_)
    handle = cross_correlate_initialize(n, k)
    return _conv._mode_slice(_conv._run(handle, x, h_, simd), n, k, mode,
                             correlate=True)


def cross_correlate_finalize(handle):
    """No-op (``src/correlate.c:159-161``)."""


def correlation_lags(in_len: int, in2_len: int, mode: str = "full"):
    """Lag axis for :func:`cross_correlate` output (numpy.correlate's
    mode convention).  Host-side int array."""
    in_len, in2_len = int(in_len), int(in2_len)
    if in_len < 1 or in2_len < 1:
        raise ValueError("lengths must be >= 1")
    _conv._check_mode(mode)
    return _conv._mode_slice(np.arange(-(in2_len - 1), in_len),
                             in_len, in2_len, mode, correlate=True)
