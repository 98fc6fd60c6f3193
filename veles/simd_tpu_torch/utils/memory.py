"""Buffer & layout helpers (the port's ``veles.simd_tpu.utils.memory``).

On the GPU, PyTorch's caching allocator owns buffer layout and
alignment, so what survives of the reference's memory layer is the
arithmetic the rest of the library builds on:

* ``next_highest_power_of_2``   (``inc/simd/arithmetic.h:1227-1235``)
* ``zeropadding`` / ``zeropadding_ex`` — pad to 2 × next-pow-2, the
  FFT-size helper (``src/memory.c:126-146``).
* ``rmemcpyf`` / ``crmemcpyf`` — reversed (complex-pairwise) copies,
  correlation's flip-h trick (``src/memory.c:148-183``).

The reference's aligned allocators (``src/memory.c:71-91``) and
alignment-complement queries (``src/memory.c:41-69``) are kept as the
JAX package keeps them: host stubs, and a complement that is always 0.

The helpers accept NumPy arrays or torch tensors and stay in that
domain (NumPy in, NumPy out; tensor in, tensor out on its device).
"""

from __future__ import annotations

import numpy as np

__all__ = ["next_highest_power_of_2", "zeropadding_length",
           "zeropadding", "zeropadding_ex", "rmemcpyf", "crmemcpyf",
           "memsetf", "malloc_aligned", "malloc_aligned_offset",
           "mallocf", "align_complement"]


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



def rmemcpyf(data):
    """Reversed copy: ``out[i] = in[n-1-i]`` (``src/memory.c:148-176``);
    a tensor is flipped (torch has no negative strides)."""
    if isinstance(data, np.ndarray):
        return data[..., ::-1]
    return data.flip(-1)


def crmemcpyf(data):
    """Complex-pairwise reversed copy of an interleaved re/im array:
    reverses the complex samples but keeps each (re, im) pair in order
    (``src/memory.c:178-183``)."""
    n = data.shape[-1]
    if n % 2:
        raise ValueError("interleaved complex array must have even length")
    pairs = data.reshape(tuple(data.shape[:-1]) + (n // 2, 2))
    if isinstance(data, np.ndarray):
        return np.flip(pairs, axis=-2).reshape(data.shape)
    return pairs.flip(-2).reshape(data.shape)


def memsetf(shape, value, dtype=np.float32):
    """Filled host array (``src/memory.c:93-124``)."""
    return np.full(shape, value, dtype=dtype)


def malloc_aligned(size: int) -> np.ndarray:
    """Compatibility stub for ``src/memory.c:77-87``: a zeroed host byte
    buffer; device buffers belong to PyTorch's allocator."""
    return np.zeros(int(size), dtype=np.uint8)


def malloc_aligned_offset(size: int, offset: int) -> np.ndarray:
    """Compatibility stub for ``inc/simd/memory.h:100`` (an allocation
    whose ``ptr + offset`` is aligned): a view at ``offset`` into a
    fresh buffer, so only the length contract holds."""
    return np.zeros(int(size) + int(offset), dtype=np.uint8)[int(offset):]


def mallocf(length: int) -> np.ndarray:
    """Compatibility stub for ``src/memory.c:89-91``."""
    return np.zeros(int(length), dtype=np.float32)


def align_complement(ptr_or_array, dtype=np.float32) -> int:
    """Alignment-complement stub (``src/memory.c:41-69``): the allocator
    owns layout, so the complement is always 0."""
    return 0
