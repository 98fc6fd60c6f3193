"""The bounded LRU the port keeps its constants in: DFT bases, twiddle
tables, analytic multipliers and windows, on the host and as device
copies.

Each cache is bounded by entries and, where its values pin device
memory, by bytes: a value larger than the byte bound is built and
returned but never kept.  ``info()`` is the ``obs.caches()`` provider
shape, so every instance is registered there under its own name.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

__all__ = ["ConstantCache", "nbytes"]


def nbytes(value) -> int:
    """Bytes held by a cached value: a tensor, a NumPy array, or a
    tuple or list of them (anything else counts 0)."""
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if isinstance(value, (tuple, list)):
        return sum(nbytes(v) for v in value)
    return 0


class ConstantCache:
    """Bounded least-recently-used map from a key to a constant.

    :meth:`get` builds a missing value outside the lock (a basis can
    take milliseconds to build); two threads racing one key keep the
    first value.  ``max_bytes`` (None: no byte bound) caps the bytes
    held: a value above it is returned uncached, and an insertion
    evicts the oldest entries until the rest fit.
    """

    def __init__(self, maxsize: int, max_bytes: int | None = None):
        self.maxsize = int(maxsize)
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self._bytes = 0
        self._hits = self._misses = self._evictions = self._uncached = 0

    def get(self, key, build):
        """The value under ``key``; ``build()`` makes it on a miss."""
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self._hits += 1
                return hit[0]
            self._misses += 1
        value = build()
        size = nbytes(value)
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                return existing[0]
            if self.max_bytes is not None and size > self.max_bytes:
                self._uncached += 1
                return value
            self._entries[key] = (value, size)
            self._bytes += size
            while len(self._entries) > self.maxsize or (
                    self.max_bytes is not None
                    and self._bytes > self.max_bytes):
                _, (_, old) = self._entries.popitem(last=False)
                self._bytes -= old
                self._evictions += 1
        return value

    def info(self) -> dict:
        """``obs.caches()`` snapshot: size, capacity, bytes held and
        traffic, and the kind (first key field) of each entry."""
        with self._lock:
            return {"size": len(self._entries), "capacity": self.maxsize,
                    "bytes": self._bytes, "max_bytes": self.max_bytes,
                    "hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions,
                    "uncached": self._uncached,
                    "keys": [k[0] if isinstance(k, tuple) else k
                             for k in self._entries]}
