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
  kernel and copy for one call, and the device's idle share;
  :func:`device_kernels` — the names of those kernels and copies.
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
           "device_breakdown", "device_kernels", "fp32_bound", "conv_work",
           "conv2d_work", "stft_work",
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
        # a trace can come back empty on its own: one more window
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


def device_kernels(fn, *, calls: int = 5) -> list[str]:
    """Names of the kernels and copies ``fn`` runs on the device
    (``torch.profiler``), largest device time first."""
    return [name for _, name in _profile(fn, calls)[0]]


def fp32_bound(flops: float, nbytes: float) -> tuple[float, str]:
    """``(ms, bound_by)``: the least time for ``flops`` fp32 operations
    that move ``nbytes`` (each input read once, each output written
    once), and whether ``"operations"`` or ``"bytes"`` set it."""
    t_ops = float(flops) / (H100_FP32_TFLOPS * 1e12) * 1e3
    t_bytes = float(nbytes) / (H100_HBM_TBPS * 1e12) * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations"
    return t_bytes, "bytes"


def _rfft_flops(n: int) -> float:
    """Operations of a real FFT of ``n`` samples: half the usual
    ``5 n log2 n`` of a complex one."""
    return 2.5 * n * math.log2(n)


def conv_work(rows: int, n: int, k: int) -> tuple[float, float]:
    """``(flops, bytes)`` of a full float32 linear convolution of
    ``rows`` signals of ``n`` samples with one ``k``-tap filter.  The
    operations are the function's least: the smaller of the direct
    form (one multiply-add per (sample, tap) pair) and an FFT
    overlap-save (segments of N, a power of two >= 2k, each a forward
    and an inverse real FFT and a complex product per bin, plus the
    taps' FFT), the least over N up to 2^20.  The bytes read the
    signal and taps once and write the ``n + k - 1`` outputs once."""
    rows, n, k = int(rows), int(n), int(k)
    out_len = n + k - 1
    flops = 2.0 * rows * n * k
    N = 1 << max(1, (2 * k - 1).bit_length())
    while N <= 1 << 20:
        segs = -(-out_len // (N - k + 1))
        fft_form = (rows * segs * (2 * _rfft_flops(N) + 6 * (N // 2 + 1))
                    + _rfft_flops(N))
        flops = min(flops, fft_form)
        N *= 2
    nbytes = 4.0 * (rows * n + k + rows * out_len)
    return flops, nbytes


def conv2d_work(imgs: int, n0: int, n1: int, k0: int,
                k1: int) -> tuple[float, float]:
    """``(flops, bytes)`` of a full float32 2D linear convolution of
    ``imgs`` images of ``n0 x n1`` with one ``k0 x k1`` kernel, the 2D
    twin of :func:`conv_work`.  The operations are the function's least:
    the smaller of the direct form (one multiply-add per (sample, tap)
    pair) and one 2D FFT product per image at powers of two that hold
    the output (a forward and an inverse real 2D FFT and a complex
    product per bin, plus the kernel's FFT).  The bytes read the
    unpadded images and the kernel once and write the ``(n0 + k0 - 1)
    x (n1 + k1 - 1)`` outputs once."""
    imgs, n0, n1, k0, k1 = (int(v) for v in (imgs, n0, n1, k0, k1))
    m0, m1 = n0 + k0 - 1, n1 + k1 - 1
    flops = 2.0 * imgs * n0 * n1 * k0 * k1
    p0 = 1 << max(0, (m0 - 1).bit_length())
    p1 = 1 << max(1, (m1 - 1).bit_length())
    fft2 = _rfft_flops(p0 * p1)
    fft_form = imgs * (2 * fft2 + 6 * p0 * (p1 // 2 + 1)) + fft2
    nbytes = 4.0 * (imgs * n0 * n1 + k0 * k1 + imgs * m0 * m1)
    return min(flops, fft_form), nbytes


def stft_work(rows: int, n: int, frame_length: int,
              hop: int) -> tuple[float, float]:
    """``(flops, bytes)`` of a float32 STFT of ``rows`` signals of ``n``
    samples.  The operations are the function's least, not the DFT
    form's: per frame, ``L`` window multiplies and a real FFT's
    ``2.5 L log2 L``.  The bytes read the signal and the window once
    and write the complex64 spectrum once."""
    rows, n, L, hop = int(rows), int(n), int(frame_length), int(hop)
    frames = 1 + (n - L) // hop
    cols = 2 * (L // 2 + 1)
    flops = rows * frames * (L + _rfft_flops(L))
    nbytes = 4.0 * (rows * n + L + rows * frames * cols)
    return flops, nbytes
