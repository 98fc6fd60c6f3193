"""Buffer & layout helpers (the port's ``veles.simd_tpu.utils.memory``).

On the GPU, PyTorch's caching allocator owns buffer layout and
alignment, so what survives of the reference's memory layer is the
arithmetic the rest of the library builds on:

* ``next_highest_power_of_2``   (``inc/simd/arithmetic.h:1227-1235``)
* ``zeropadding`` / ``zeropadding_ex`` — pad to 2 × next-pow-2, the
  FFT-size helper (``src/memory.c:126-146``).

The helpers accept NumPy arrays or torch tensors and stay in that
domain (NumPy in, NumPy out; tensor in, tensor out on its device).
"""

from __future__ import annotations

import numpy as np

__all__ = ["next_highest_power_of_2", "zeropadding_length",
           "zeropadding", "zeropadding_ex"]


def next_highest_power_of_2(value: int) -> int:
    """Smallest power of two >= ``value`` (``inc/simd/arithmetic.h:
    1227-1235``, bit-smearing trick)."""
    value = int(value)
    if value <= 1:
        return 1
    return 1 << (value - 1).bit_length()


def zeropadding_length(length: int) -> int:
    """The reference's FFT padding size: 2 × (next power of 2 > length),
    the loop at ``src/memory.c:131-137``: e.g. 100 → 256, 128 → 512,
    1 → 4."""
    length = int(length)
    nl = length
    log = 2
    while nl:
        nl >>= 1
        log += 1
    return 1 << (log - 1)


def _pad_tail(data, extra: int):
    if isinstance(data, np.ndarray):
        return np.pad(data, [(0, 0)] * (data.ndim - 1) + [(0, extra)])
    import torch

    return torch.nn.functional.pad(data, (0, extra))


def zeropadding(data, new_length: int | None = None):
    """Zero-pad ``data`` to :func:`zeropadding_length` (or
    ``new_length``); returns ``(padded, new_length)`` like
    ``src/memory.c:126-129``."""
    n = data.shape[-1]
    nl = zeropadding_length(n) if new_length is None else int(new_length)
    return _pad_tail(data, nl - n), nl


def zeropadding_ex(data, additional_length: int):
    """Like :func:`zeropadding` with an extra zero tail beyond the
    reported length (``src/memory.c:129-142``)."""
    n = data.shape[-1]
    nl = zeropadding_length(n)
    return _pad_tail(data, nl + int(additional_length) - n), nl

