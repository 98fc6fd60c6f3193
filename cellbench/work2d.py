"""The least work of a 2D filter: the benchmark's own count, beside the
frozen 1D counts of ``cellbench/work.py``, whose real-FFT operation
count it uses.

Modelled on the program's ``utils/benchmark.conv2d_work``, with powers
of two as ``work.conv_work`` uses: the operations are the smaller of
the direct form and one 2D FFT product an image, whatever route
implements the filter; the bytes read the unextended images and the
kernel once and write the kept outputs once.
"""

from __future__ import annotations

from cellbench import work


def _pow2(m: int) -> int:
    return 1 << max(0, (int(m) - 1).bit_length())


def kept(n0: int, n1: int, k0: int, k1: int, mode: str) -> tuple[int, int]:
    """The output of a ``mode`` filter of an ``n0 x n1`` image with a
    ``k0 x k1`` kernel (scipy's ``convolve2d``)."""
    if mode == "valid":
        return n0 - k0 + 1, n1 - k1 + 1
    if mode == "same":
        return n0, n1
    if mode == "full":
        return n0 + k0 - 1, n1 + k1 - 1
    raise ValueError(f"no mode {mode!r}")


def filter2d_work(images: int, n0: int, n1: int, k0: int, k1: int,
                  mode: str) -> tuple[float, float]:
    """``(flops, bytes)`` of a float32 2D filter of ``images`` images of
    ``n0 x n1`` with one ``k0 x k1`` kernel in ``mode``.

    * direct form: one multiply-add per kept output and tap;
    * FFT form: a forward and an inverse real 2D FFT an image
      (``work.rfft_flops`` of the grid's points) and 6 operations a
      complex bin, plus the kernel's transform.  The grid is the
      smallest power of two per axis that holds the kept outputs
      without wrap-around: ``n`` for ``valid``, ``n + k - 1`` for
      ``same`` (over an extended input as over a zero-filled one) and
      for ``full``.
    """
    images, n0, n1, k0, k1 = (int(v) for v in (images, n0, n1, k0, k1))
    o0, o1 = kept(n0, n1, k0, k1, mode)
    direct = 2.0 * images * o0 * o1 * k0 * k1
    g0, g1 = (n0, n1) if mode == "valid" else (n0 + k0 - 1, n1 + k1 - 1)
    m0, m1 = _pow2(g0), _pow2(g1)
    fft2 = work.rfft_flops(m0 * m1)
    fft_form = images * (2 * fft2 + 6 * m0 * (m1 // 2 + 1)) + fft2
    nbytes = 4.0 * (images * n0 * n1 + k0 * k1 + images * o0 * o1)
    return min(direct, fft_form), nbytes
