"""The bounded LRU membership set for the library's rejection caches.

A copy of ``veles.simd_tpu.obs.lru`` (that module is framework-free;
the port keeps its own copy so it never imports the JAX package): a
bounded, locked, recency-refreshed membership set with
hit/miss/eviction accounting.

torch-free and numpy-free like the rest of the obs storage layer, so it
imports everywhere.
"""

from __future__ import annotations

import collections
import threading

__all__ = ["LRUSet"]


class LRUSet:
    """Bounded membership cache with least-recently-used eviction.

    Set-compatible surface (``add`` / ``in`` / ``len``) so tests can
    substitute a plain ``set``.  A membership HIT refreshes the entry:
    keys a workload keeps asking about stay resident while one-off
    churn ages out.  Locked: ``move_to_end``/``popitem`` are not
    GIL-atomic as a pair, and the motivating callers are concurrent
    services.  ``info()`` is the ``obs.caches()`` provider shape.
    """

    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self._entries = collections.OrderedDict()
        self._lock = threading.Lock()
        self._hits = self._misses = self._evictions = 0

    def __contains__(self, key) -> bool:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self._hits += 1
                return True
            self._misses += 1
            return False

    def add(self, key) -> None:
        with self._lock:
            self._entries[key] = None
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self._evictions += 1

    def check_and_add(self, key) -> bool:
        """One atomic probe-or-insert: True when ``key`` was already
        present (recency refreshed), False when it was new (now
        recorded).  The memoization primitive — two separate
        ``in``/``add`` calls would let two threads both see "new"."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self._hits += 1
                return True
            self._misses += 1
            self._entries[key] = None
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self._evictions += 1
            return False

    def discard(self, key) -> None:
        """Remove ``key`` if present (set-compatible; no traffic
        counted — tests use this to un-remember a rejection)."""
        with self._lock:
            self._entries.pop(key, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def info(self) -> dict:
        """``obs.caches()`` snapshot: size/capacity plus membership
        traffic."""
        with self._lock:
            return {"size": len(self._entries),
                    "capacity": self.maxsize, "hits": self._hits,
                    "misses": self._misses,
                    "evictions": self._evictions}

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._hits = self._misses = self._evictions = 0
