"""Device timing and roofline bounds on the card (the port's
``veles.simd_tpu.utils.benchmark``, reduced).

* :func:`device_time_ms` — the counterpart of the JAX package's
  ``device_time_chained``: ``iters`` launches queued back to back on
  the current stream between two CUDA events, after a warm-up, so the
  host's enqueue cost overlaps the device work and the marginal per
  launch is device time.
* :func:`host_time` — best-of-N wall time of a synchronous function.
* :func:`device_busy_ms` — ``torch.profiler``'s device time per call,
  summed over its kernels and copies: a kernel's time free of the
  host's enqueue cost.
* :func:`device_breakdown` — ``torch.profiler``'s device time per
  kernel and copy for one call, and the device's idle share.
* :func:`fp32_bound` — the least time the card could take for a
  float32 function: the larger of its operations over the fp32 peak
  outside the tensor cores and its bytes over the memory rate.

The peaks are the H100 SXM's (NVIDIA data sheet, 700 W): 67 TFLOP/s
fp32 without the tensor cores, 3.35 TB/s of HBM3.  A card set below
700 W runs slower under load; callers print its power limit beside
every bound.
"""

from __future__ import annotations

import math
import time

import torch

__all__ = ["device_time_ms", "host_time", "device_busy_ms",
           "device_breakdown", "fp32_bound", "conv_work", "stft_work",
           "H100_FP32_TFLOPS", "H100_HBM_TBPS"]

H100_FP32_TFLOPS = 67.0
H100_HBM_TBPS = 3.35


def device_time_ms(fn, *, iters: int = 50, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn`` on the current CUDA stream,
    timed with CUDA events over ``iters`` chained calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_time(fn, *, repeats: int = 3, warmup: int = 1) -> float:
    """Best-of-N wall time in seconds for a synchronous host
    function."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _profile(fn, calls: int):
    """``(rows, wall_us)``: ``torch.profiler``'s device microseconds per
    call of ``fn`` by kernel or copy, largest first, and the host-clock
    microseconds per call, over ``calls`` calls after one profiled
    warm-up."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # the first profiled call in a process also starts CUPTI, which
    # takes seconds: keep that out of the measured window
    with profile(activities=activities):
        fn()
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        # the clock runs inside the profiled window: the profiler's
        # own start and stop stay out of the wall time
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / calls
    # device-side events only (kernels, copies, memsets): the host ops
    # that launched them report the same time again
    rows = sorted(((e.device_time_total / calls, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    return rows, wall_us


def device_busy_ms(fn, *, calls: int = 20) -> float:
    """Device milliseconds per call of ``fn``: the sum of its kernels'
    and copies' device time under ``torch.profiler``, free of the
    host's enqueue cost (which sets the chained time of a call whose
    kernels are shorter than its Python dispatch)."""
    rows, _ = _profile(fn, calls)
    if not rows:
        raise RuntimeError("torch.profiler saw no device time")
    return sum(us for us, _ in rows) / 1e3


def device_breakdown(fn, *, calls: int = 5) -> str:
    """Where the device time of ``fn`` goes: device microseconds per
    call by kernel or copy, the host-clock microseconds per call, and
    the device's idle share of that wall time."""
    rows, wall_us = _profile(fn, calls)
    if not rows:
        return f"profiler saw no device time ({wall_us:.1f} us wall)"
    busy = sum(us for us, _ in rows)
    parts = [f"{name[:48]} {us:.1f}" for us, name in rows[:6]]
    return (" | ".join(parts) + f" | device busy {busy:.1f} of "
            f"{wall_us:.1f} wall (profiled), idle share "
            f"{max(0.0, 1 - busy / wall_us):.3f}")


def fp32_bound(flops: float, nbytes: float) -> tuple[float, str]:
    """``(ms, bound_by)``: the least time for ``flops`` fp32 operations
    that move ``nbytes`` (each input read once, each output written
    once), and whether ``"operations"`` or ``"bytes"`` set it."""
    t_ops = float(flops) / (H100_FP32_TFLOPS * 1e12) * 1e3
    t_bytes = float(nbytes) / (H100_HBM_TBPS * 1e12) * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations"
    return t_bytes, "bytes"


def conv_work(rows: int, n: int, k: int) -> tuple[float, float]:
    """``(flops, bytes)`` of a full float32 linear convolution of
    ``rows`` signals of ``n`` samples with one ``k``-tap filter: one
    multiply-add per (sample, tap) pair, the signal and taps read
    once, the ``n + k - 1`` outputs written once."""
    rows, n, k = int(rows), int(n), int(k)
    flops = 2.0 * rows * n * k
    nbytes = 4.0 * (rows * n + k + rows * (n + k - 1))
    return flops, nbytes


def stft_work(rows: int, n: int, frame_length: int,
              hop: int) -> tuple[float, float]:
    """``(flops, bytes)`` of a float32 STFT of ``rows`` signals of ``n``
    samples against a window-folded ``[L, 2 * (L // 2 + 1)]`` basis.
    The operations are the function's least, not the DFT form's: per
    frame, ``L`` window multiplies and a real FFT's ``2.5 L log2 L``
    (half the usual ``5 N log2 N`` of a complex one).  The bytes read
    the signal and the basis once and write the complex64 spectrum
    once."""
    rows, n, L, hop = int(rows), int(n), int(frame_length), int(hop)
    frames = 1 + (n - L) // hop
    cols = 2 * (L // 2 + 1)
    flops = rows * frames * (L + 2.5 * L * math.log2(L))
    nbytes = 4.0 * (rows * n + L * cols + rows * frames * cols)
    return flops, nbytes
