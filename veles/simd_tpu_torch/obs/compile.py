"""Compile and build-cache tracking: the port's compile events, counted.

The port of ``veles.simd_tpu.obs.compile``.  The JAX package bridges
``jax.monitoring``'s compile and persistent-cache events into the
telemetry registry.  The port compiles in two places of its own, and
announces each through :func:`record_event` / :func:`record_duration`
under the same counter and histogram names:

* the ``nvcc`` build of the kernel library
  (``ops/cuda_kernels.load_library``): a build counts as
  ``compile.backend_compile`` (and ``compile.cache_misses``) and adds
  its seconds to ``compile.backend_compile_secs``; a library found
  already built under ``build/simd_tpu_torch/<hash>/`` counts as
  ``compile.cache_hits``;
* the capture of a pipeline's CUDA graph (``pipeline/compiler.py``):
  one ``compile.backend_compile`` and its seconds.

Nothing listens until :func:`install` (``obs.enable()`` calls it);
afterwards each event goes through the gated ``obs.count`` /
``obs.observe`` helpers, so ``obs.disable()`` silences it with one
flag check.

Both compile sites sit in compute modules, which may not read a clock
or import this module (``tools/lint_torch.py``): they announce their
events through the facade's ``obs.compile_event(event)`` and ``with
obs.compile_timer(event) as t:`` (:func:`timed`; ``t.seconds`` after
the block), and the clock stays here.
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["install", "installed", "EVENT_COUNTERS", "DURATION_METRICS"]

# the port's compile event name -> telemetry counter name
EVENT_COUNTERS = {
    "/veles/cuda/library_cache_hits": "compile.cache_hits",
    "/veles/cuda/library_cache_misses": "compile.cache_misses",
}

# the port's duration event -> (counter name or None, histogram name)
DURATION_METRICS = {
    "/veles/cuda/nvcc_build_duration":
        ("compile.backend_compile", "compile.backend_compile_secs"),
    "/veles/pipeline/graph_capture_duration":
        ("compile.backend_compile", "compile.backend_compile_secs"),
}

_installed = False


def installed() -> bool:
    return _installed


def install() -> bool:
    """Route the port's compile events into the registry (idempotent).
    Returns True when this call did it, False when it was already
    done."""
    global _installed
    if _installed:
        return False
    _installed = True
    return True


def record_event(event: str) -> None:
    """One compile event (a key of :data:`EVENT_COUNTERS`): counted
    once :func:`install` ran and while telemetry is enabled."""
    if not _installed:
        return
    name = EVENT_COUNTERS.get(event)
    if name is not None:
        from veles.simd_tpu_torch import obs

        obs.count(name)


def record_duration(event: str, duration_secs: float) -> None:
    """One timed compile event (a key of :data:`DURATION_METRICS`)."""
    if not _installed:
        return
    names = DURATION_METRICS.get(event)
    if names is None:
        return
    from veles.simd_tpu_torch import obs

    counter, hist = names
    if counter is not None:
        obs.count(counter)
    obs.observe(hist, duration_secs)


class _Timing:
    """What :func:`timed` yields: ``seconds`` is None until the block
    has completed."""

    __slots__ = ("seconds",)

    def __init__(self):
        self.seconds = None


@contextlib.contextmanager
def timed(event: str):
    """Time the block and record it as the duration ``event`` (a key
    of :data:`DURATION_METRICS`) when it completes; a block that raises
    records nothing, as a failed build announced nothing before."""
    timing = _Timing()
    t0 = time.perf_counter()
    yield timing
    timing.seconds = time.perf_counter() - t0
    record_duration(event, timing.seconds)
