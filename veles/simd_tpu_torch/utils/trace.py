"""The port's counterpart of a JAX trace.

A JAX core harvests no resources while it is being traced, so a core
called inside another compiled core, or inside a ``shard_map`` body,
leaves no ``obs.resources()`` row of its own.  The port compiles
nothing per call, so it keeps that rule with :data:`TRACE_DEPTH`: how
deep this context runs inside instrumented calls
(``obs.instrumented_jit``) and shard bodies (``parallel._spmd``).  An
instrumented call records only at depth 0.  A context variable, so a
thread starts at 0.

Imports nothing of the package: ``obs`` and the compute modules both
read it.
"""

from __future__ import annotations

import contextlib
import contextvars

__all__ = ["TRACE_DEPTH", "traced"]

TRACE_DEPTH = contextvars.ContextVar("veles_simd_torch_trace_depth",
                                     default=0)


@contextlib.contextmanager
def traced():
    """Run a block one level deeper in :data:`TRACE_DEPTH`."""
    token = TRACE_DEPTH.set(TRACE_DEPTH.get() + 1)
    try:
        yield
    finally:
        TRACE_DEPTH.reset(token)
