"""Shared atomic file writer for every obs exporter.

Copied from ``veles.simd_tpu.obs.atomic`` (framework-free; the port
keeps its own copy so it never imports the JAX package).  The flight
recorder (:mod:`veles.simd_tpu_torch.obs.flightrec`) writes artifacts
that other tools parse later — a crash mid-write (a wedged
bench run, an OOM-killed server, the very exception a flight bundle is
documenting) must never leave a truncated file where a consumer expects
a complete one.  This module is the single home for the
write-temp-then-``os.replace`` discipline the exporters used to
duplicate per call site.
"""

from __future__ import annotations

import itertools
import os
import threading

__all__ = ["atomic_write_text", "atomic_write_bytes"]

_TMP_SEQ = itertools.count()


def atomic_write_text(path: str, text: str) -> str:
    """Write ``text`` to ``path`` atomically; returns ``path``.

    The temp name is unique per write (pid + thread + sequence), so
    concurrent saves to the same path from different threads cannot
    collide on — or unlink — each other's temp file; last
    ``os.replace`` wins.  If serialization already happened (``text``
    is a complete string) the only failure modes left are filesystem
    ones, and those leave the previous file intact.
    """
    return atomic_write_bytes(path, text.encode("utf-8"))


def atomic_write_bytes(path: str, data: bytes) -> str:
    """Binary form of the shared writer: the same temp +
    ``os.replace`` discipline, so a crash mid-write can never leave a
    torn file where a reader expects a complete one.
    :func:`atomic_write_text` delegates here: one copy of the
    discipline, not two to keep in sync."""
    tmp = "%s.%d.%d.%d.tmp" % (path, os.getpid(),
                               threading.get_ident(), next(_TMP_SEQ))
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # the write itself failed mid-flight
            os.unlink(tmp)
    return path
