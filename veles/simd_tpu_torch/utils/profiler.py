"""Tracing and the kernels' build directory (the port's
``veles.simd_tpu.utils.profiler``).

Scope: this module answers **where the device time goes** inside a
step.  **What was decided** and **how long the host-side dispatch
took** live in :mod:`veles.simd_tpu_torch.obs` (decision events,
``obs.span`` histograms, ``obs.save_trace``).  The two meet in the
middle: while a :func:`trace` capture is live, every enabled
``obs.span`` also opens a ``torch.profiler.record_function`` of its
name, so the dispatch names appear in the device timeline.

* :func:`trace` / :func:`annotate` — a ``torch.profiler`` capture (the
  CPU and, with a card, its CUDA activity) written as a Chrome trace
  into a directory, and named regions inside it;
* :func:`enable_compilation_cache` — where the CUDA kernel library is
  built and found again: the port's counterpart of JAX's persistent
  compile cache.  A process that finds the library built for the same
  sources and flags loads it instead of running ``nvcc``.

Wall-clock and device timing belong to
:mod:`veles.simd_tpu_torch.utils.benchmark`.
"""

from __future__ import annotations

import contextlib
import os
import time

__all__ = ["trace", "annotate", "enable_compilation_cache"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace into ``log_dir``.

    Usage::

        with profiler.trace("/tmp/veles-trace"):
            convolve(handle, x, h)

    Writes ``trace-<pid>-<ns>.json`` (Chrome trace-event JSON: open it
    in Perfetto or ``chrome://tracing``) when the block exits.  CUDA
    activity is captured when a card is present; nested
    :func:`annotate` scopes and every enabled ``obs.span`` appear as
    named ranges."""
    import torch

    from veles.simd_tpu_torch.obs import spans as _obs_spans

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _obs_spans.set_xla_trace_active(True)
    try:
        yield log_dir
    finally:
        _obs_spans.set_xla_trace_active(False)
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Name a region so it shows up as a range inside a :func:`trace`
    capture (``torch.profiler.record_function``)."""
    import torch

    with torch.profiler.record_function(name):
        yield


def enable_compilation_cache(cache_dir: str | None = None) -> str:
    """Where the CUDA kernel library is built and reused; returns the
    directory in use.  A delegating shim: the single home of the
    configuration is
    :func:`veles.simd_tpu_torch.runtime.artifacts.\
enable_persistent_compile_cache` (``cache_dir`` or
    ``$VELES_SIMD_CACHE_DIR`` becomes the build root before the
    library's first load)."""
    from veles.simd_tpu_torch.runtime import artifacts

    return artifacts.enable_persistent_compile_cache(cache_dir)
