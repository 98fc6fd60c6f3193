"""Device timing and roofline bounds on the card (the port's
``veles.simd_tpu.utils.benchmark``).

* :func:`device_time_chained` — the JAX package's primary timer, in
  seconds: ``step`` (an ``x -> x`` function) run ``k`` times back to
  back on the current stream, the marginal per step between two trip
  counts.  The card has no ``fori_loop``: the loop is eager, so each
  step's host dispatch lies inside the window, and the result is
  *chained* time — the device's when its kernels outlast the host's
  enqueue, the host's otherwise — not device busy time
  (:func:`device_busy_ms` reads that).
* :func:`device_time` — the JAX package's burst timer, in seconds: the
  marginal per call between bursts of 1 and ``burst`` calls on the
  host clock, each burst waited for.
* :func:`device_time_ms` — milliseconds per call over ``iters`` calls
  queued between two CUDA events, after a warm-up.
* :func:`host_time` — best-of-N wall time of a synchronous function.
* :func:`rms_normalize` — keeps a chained GEMM step bounded.
* :func:`device_busy_ms` — the device time per call (CUPTI's records,
  :mod:`~veles.simd_tpu_torch.utils.devtrace`), summed over its
  kernels and copies: a kernel's time free of the host's enqueue cost.
* :func:`device_breakdown` — the device time per kernel and copy for
  one call, and the device's idle share;
  :func:`device_kernels` — the names of those kernels and copies;
  :func:`device_profile` — the busy time and how many kernels and
  copies one call runs.
* :func:`fp32_bound` — the least time the card could take for a
  float32 function: the larger of its operations over the fp32 peak
  outside the tensor cores and its bytes over the memory rate.
* :func:`gemm_work` and :func:`gemm_bound` — the same for a GEMM at
  one of the precision layer's schemes, each against the peak of the
  units its passes run on.
* The JAX package's roofline attributions, with the H100's rates
  (:data:`GEMM_PEAK_TFLOPS` at each precision in place of the MXU's):
  :func:`conv_roofline`, :func:`stft_roofline`, :func:`gemm_roofline`,
  :func:`dft_matmul_roofline`, :func:`analytical_roofline` and
  :func:`roofline_disagreement_pct`.  Their dict keys are the JAX
  package's, so readers of either package's bench rows parse both.
* :func:`a2a_bytes`, :func:`ct_dft_flops`, :func:`rfft_flops` and
  :func:`mesh_copy_gbps` — the sharded Fourier route's cost model
  (``parallel/fourier.py``): the JAX package's counts, the copy rate
  between a mesh's shards (half of HBM's on one card, NVLink's between
  cards).

The peaks are the H100 SXM's (NVIDIA data sheet, 700 W, dense rates
without sparsity): 67 TFLOP/s fp32 without the tensor cores, 495
TFLOP/s TF32, 989 TFLOP/s bf16, 1979 TOP/s int8 on the tensor cores,
3.35 TB/s of HBM3, 450 GB/s each way over NVLink 4.  A card set below
700 W runs slower under load; callers print its power limit beside
every bound.  The JAX module's TPU rates (``mxu_*``, ``MXU_*``,
``hbm_bw_gbps``, ``ICI_*``, ``xla_fft_eff_gflops``, ``a2a_ici_bytes``)
have no counterpart here.
"""

from __future__ import annotations

import math
import os
import time
import warnings

import torch

__all__ = ["device_time", "device_time_chained", "device_time_ms",
           "host_time", "rms_normalize", "device_busy_ms",
           "device_breakdown", "device_kernels", "device_profile",
           "fp32_bound", "conv_work", "elementwise_work",
           "conv2d_work", "stft_work", "filter_bank_work",
           "cascade_bank_work", "filter_2d_work", "gemm_work",
           "gemm_bound", "a2a_bytes", "ct_dft_flops", "rfft_flops",
           "mesh_copy_gbps", "H100_NVLINK_GBPS", "H100_FP32_TFLOPS",
           "H100_TF32_TFLOPS", "H100_BF16_TFLOPS",
           "H100_INT8_TOPS", "H100_HBM_TBPS", "GEMM_PEAK_TFLOPS",
           "conv_roofline", "stft_roofline", "analytical_roofline",
           "gemm_roofline", "roofline_disagreement_pct",
           "dft_matmul_roofline", "ROOFLINE_DISAGREEMENT_WARN_PCT"]

H100_FP32_TFLOPS = 67.0
H100_TF32_TFLOPS = 495.0
H100_BF16_TFLOPS = 989.0
H100_INT8_TOPS = 1979.0
H100_HBM_TBPS = 3.35
# NVLink 4 between two H100 SXM cards: 900 GB/s both ways, 450 each way
H100_NVLINK_GBPS = 450.0
MESH_BW_ENV = "VELES_SIMD_MESH_BW_GBPS"

# a GEMM's ceiling at each precision of runtime.precision: the peak of
# the units its input type runs on, over its pass count (bf16_comp is
# three bf16 passes); the matrix module's fp32 route sums in float64 on
# the FP64 tensor cores, whose data-sheet peak is the same 67 TFLOP/s
GEMM_PEAK_TFLOPS = {
    "highest": H100_FP32_TFLOPS,
    "high": H100_FP32_TFLOPS,
    "default": H100_TF32_TFLOPS,
    "bf16": H100_BF16_TFLOPS,
    "bf16_comp": H100_BF16_TFLOPS / 3,
    "int8": H100_INT8_TOPS,
}


def _leaves(out):
    """The leaves of ``out`` (nested dicts, lists and tuples), ``None``
    dropped."""
    if isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _leaves(v)
    elif out is not None:
        yield out


def _sync(out):
    """Force completion of ``out`` (a tensor, or dicts, lists and tuples
    of them).  Leaves that are not tensors (Python scalars, strings,
    host metadata riding along in a result dict) and empty containers
    have nothing to wait on and are skipped; a card tensor waits for
    its device, a host tensor is complete already."""
    tensors = [leaf for leaf in _leaves(out)
               if isinstance(leaf, torch.Tensor)]
    if tensors and tensors[-1].device.type == "cuda":
        torch.cuda.synchronize(tensors[-1].device)


def device_time(fn, *, burst: int = 8, repeats: int = 3,
                warmup: int = 2) -> float:
    """Marginal seconds per call of ``fn`` (which returns a tensor or a
    container of them): the best of ``repeats`` bursts of 1 and of
    ``burst`` calls on the host clock, each burst waited for, the
    fixed cost of a burst cancelled by the difference."""
    for _ in range(warmup):
        _sync(fn())

    def burst_time(k):
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = None
            for _ in range(k):
                out = fn()
            _sync(out)
            best = min(best, time.perf_counter() - t0)
        return best

    t1 = burst_time(1)
    tk = burst_time(burst)
    per_op = (tk - t1) / (burst - 1)
    # degenerate case (dispatch-dominated tiny op): fall back to t1
    return max(per_op, 1e-9) if per_op > 0 else t1


def device_time_chained(step, x0, *, iters: int = 256, base: int = 8,
                        repeats: int = 3, min_window: float = 0.04,
                        max_iters: int = 1 << 15) -> float:
    """Seconds per step of ``step`` (an ``x -> x`` function), the
    marginal between two trip counts of a chain of steps:

        per_step = (T(k) - T(base)) / (k - base)

    so the fixed cost of a chain (the first launch, the final wait)
    cancels.  ``k`` starts at ``iters`` and quadruples until the window
    ``T(k) - T(base)`` clears ``min_window`` seconds; a chain that never
    clears it by ``max_iters`` returns NaN with a ``RuntimeWarning`` (a
    number under the clock's noise must not pass for a measurement).

    The card has no ``fori_loop``: the chain runs eagerly, each step's
    output the next one's input, and a card operand's chain is timed
    with CUDA events on the current stream (best of ``repeats``), a
    host operand's on the host clock.  Each step's host dispatch lies
    inside the window, so the result is chained time: the device's
    when a step's kernels outlast its dispatch, the host's otherwise.
    It is not device busy time (:func:`device_busy_ms`).  ``step`` must
    keep the shape and dtype and keep values bounded (it runs up to
    ``max_iters`` times)."""
    cuda = isinstance(x0, torch.Tensor) and x0.device.type == "cuda"

    def chain(k):
        v = x0
        for _ in range(k):
            v = step(v)
        return v

    def timed(k):
        best = float("inf")
        for _ in range(repeats):
            if cuda:
                with torch.cuda.device(x0.device):
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    chain(k)
                    end.record()
                    end.synchronize()
                    t = start.elapsed_time(end) * 1e-3
            else:
                t0 = time.perf_counter()
                _sync(chain(k))
                t = time.perf_counter() - t0
            best = min(best, t)
        return best

    _sync(chain(base))      # warm: kernel builds, plans, caches
    tb = timed(base)
    k = max(iters, base * 2)
    while True:
        tk = timed(k)
        if tk - tb >= min_window or k >= max_iters:
            if tk - tb < min_window:
                warnings.warn(
                    f"device_time_chained: marginal window {tk - tb:.4f}s "
                    f"below {min_window}s at max_iters={max_iters}; the "
                    "estimate is clock noise (step too fast); returning "
                    "NaN", RuntimeWarning, stacklevel=2)
                return float("nan")
            return max((tk - tb) / (k - base), 1e-9)
        k = min(k * 4, max_iters)


def rms_normalize(p, eps: float = 1e-30):
    """``p`` over its root mean square: keeps a chained GEMM or gemv
    step bounded over hundreds of steps (the reduction is negligible
    next to the product it stabilizes)."""
    return p / (torch.sqrt(torch.mean(p * p)) + eps)


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
    """``(rows, wall_us)``: the device microseconds per call of ``fn`` by
    kernel or copy (:mod:`~veles.simd_tpu_torch.utils.devtrace`'s
    records, summed by name), largest first, with their names and
    launches per call, and the host-clock microseconds per call, over
    ``calls`` calls after one traced warm-up."""
    from veles.simd_tpu_torch.utils import devtrace

    # the first trace in a process also starts CUPTI, which takes
    # seconds: keep that out of the measured window
    devtrace.trace(fn)

    def window():
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6 / calls

    records, wall_us = devtrace.trace(window)
    by_name: dict[str, list] = {}
    for rec in records:
        total = by_name.setdefault(rec.name, [0, 0])
        total[0] += rec.ns
        total[1] += 1
    rows = sorted(((ns / 1e3 / calls, name, n / calls)
                   for name, (ns, n) in by_name.items()), reverse=True)
    return rows, wall_us


def _device_rows(fn, calls: int, windows: int = 12, keep: int = 3):
    """:func:`_profile`'s rows from the longest of ``keep`` windows: up
    to ``windows`` windows, the first ``keep`` that saw device time
    compared, the longest kept (``torch.profiler``, which this module
    read before :mod:`~veles.simd_tpu_torch.utils.devtrace`, lost
    kernels from windows and never added any)."""
    best, seen = None, 0
    for _ in range(windows):
        rows, _ = _profile(fn, calls)
        if not rows:
            continue
        if best is None or sum(r[0] for r in rows) > sum(
                r[0] for r in best):
            best = rows
        seen += 1
        if seen == keep:
            break
    if best is None:
        raise RuntimeError("the trace saw no device time")
    return best


def device_busy_ms(fn, *, calls: int = 20, keep: int = 3) -> float:
    """Device milliseconds per call of ``fn``: the sum of its kernels'
    and copies' device time in CUPTI's records, free of the host's
    enqueue cost (which sets the chained time of a call whose kernels
    are shorter than its Python dispatch); the longest of ``keep``
    windows that saw device time."""
    return device_profile(fn, calls=calls, keep=keep)[0]


def device_breakdown(fn, *, calls: int = 5) -> str:
    """Where the device time of ``fn`` goes: device microseconds per
    call by kernel or copy, the host-clock microseconds per call, and
    the device's idle share of that wall time."""
    rows, wall_us = _profile(fn, calls)
    if not rows:
        return f"the trace saw no device time ({wall_us:.1f} us wall)"
    busy = sum(row[0] for row in rows)
    parts = [f"{name[:48]} {us:.1f}" for us, name, _ in rows[:6]]
    return (" | ".join(parts) + f" | device busy {busy:.1f} of "
            f"{wall_us:.1f} wall (profiled), idle share "
            f"{max(0.0, 1 - busy / wall_us):.3f}")


def device_kernels(fn, *, calls: int = 5) -> list[str]:
    """Names of the kernels and copies ``fn`` runs on the device
    (CUPTI's records), largest device time first."""
    return [name for _, name, _ in _device_rows(fn, calls)]


def device_profile(fn, *, calls: int = 20,
                   keep: int = 3) -> tuple[float, float]:
    """``(busy_ms, launches)`` per call of ``fn`` from one profiled
    window: :func:`device_busy_ms` and the number of kernels and copies
    it runs on the device."""
    rows = _device_rows(fn, calls, keep=keep)
    return (sum(row[0] for row in rows) / 1e3,
            sum(row[2] for row in rows))


def fp32_bound(flops: float, nbytes: float) -> tuple[float, str]:
    """``(ms, bound_by)``: the least time for ``flops`` fp32 operations
    that move ``nbytes`` (each input read once, each output written
    once), and whether ``"operations"`` or ``"bytes"`` set it."""
    return _bound(flops, nbytes, H100_FP32_TFLOPS)


def gemm_bound(flops: float, nbytes: float,
               precision: str) -> tuple[float, str]:
    """:func:`fp32_bound` for a GEMM at ``precision`` (a key of
    :data:`GEMM_PEAK_TFLOPS`): its operations over that precision's
    ceiling."""
    return _bound(flops, nbytes, _peak_tflops(precision))


def _peak_tflops(precision: str) -> float:
    """:data:`GEMM_PEAK_TFLOPS` at ``precision``; ValueError for a
    precision it lacks."""
    try:
        return GEMM_PEAK_TFLOPS[precision]
    except KeyError:
        raise ValueError(f"precision must be one of "
                         f"{sorted(GEMM_PEAK_TFLOPS)}, got "
                         f"{precision!r}") from None


def gemm_work(h1: int, w1: int, w2: int,
              rows: int = 1) -> tuple[float, float]:
    """``(flops, bytes)`` of ``rows`` float32 GEMMs ``[h1, w1] @ [w1,
    w2]``: two operations per multiply-add, and the bytes of the three
    float32 matrices of each, read or written once."""
    h1, w1, w2, rows = (int(v) for v in (h1, w1, w2, rows))
    return (2.0 * rows * h1 * w1 * w2,
            4.0 * rows * (h1 * w1 + w1 * w2 + h1 * w2))


def _bound(flops, nbytes, peak_tflops):
    t_ops = float(flops) / (peak_tflops * 1e12) * 1e3
    t_bytes = float(nbytes) / (H100_HBM_TBPS * 1e12) * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations"
    return t_bytes, "bytes"


def rfft_flops(n: int) -> float:
    """Operations of a real FFT of ``n`` samples: half the usual
    ``5 n log2 n`` of a complex one (the split-radix estimate)."""
    n = int(n)
    return 2.5 * n * math.log2(n)


# ---------------------------------------------------------------------------
# the JAX package's roofline attributions, against the H100's peaks
# ---------------------------------------------------------------------------

# the stft routes by formulation: dense real-DFT products (the JAX
# package's fused Pallas kernel is one), and FFTs (cuFFT, and K4, the
# port's kernel, a block FFT in shared memory)
_STFT_MATMUL_ROUTES = ("rdft_matmul", "pallas_fused")
_STFT_FFT_ROUTES = ("xla_fft", "cuda_fused")


def conv_roofline(samples_per_s: float, h_length: int,
                  precision: str = "highest") -> dict:
    """Roofline attribution of a 1D-convolution rate: effective
    TFLOP/s at 2·h FLOPs per output sample and its share of the peak
    at ``precision`` (:data:`GEMM_PEAK_TFLOPS`).

    2·h is the direct form's work, the JAX package's count, kept so
    the figure means what it meant there: a *direct-form equivalent*
    rate.  An FFT route (K1, the overlap-save kernel, is one) does far
    less work, so ``pct_of_roofline`` can read above 100 % and is no
    share of a peak; the least-work bound is :func:`conv_work` with
    :func:`fp32_bound`."""
    bound = _peak_tflops(precision)
    eff = 2.0 * int(h_length) * samples_per_s / 1e12
    return {"tflops_effective": eff,
            "roofline_bound_tflops": bound,
            "pct_of_roofline": 100.0 * eff / bound,
            "precision": precision}


def stft_roofline(frames_per_s: float, frame_length: int,
                  precision: str = "highest",
                  route: str = "rdft_matmul") -> dict:
    """Roofline attribution of an STFT frame rate, with the useful-FLOP
    constant of the formulation the route runs: ``4 * L * bins`` a frame
    for the dense real-DFT routes (``rdft_matmul``, and the JAX
    package's ``pallas_fused``), :func:`rfft_flops` for the FFT routes
    (``xla_fft``, and ``cuda_fused``, the port's kernel, an FFT).
    Same dict shape as :func:`conv_roofline`."""
    L = int(frame_length)
    if route in _STFT_MATMUL_ROUTES:
        flops_per_frame = 4.0 * L * (L // 2 + 1)
    elif route in _STFT_FFT_ROUTES:
        flops_per_frame = rfft_flops(L)
    else:
        raise ValueError(f"unknown stft route {route!r}")
    bound = _peak_tflops(precision)
    eff = flops_per_frame * frames_per_s / 1e12
    return {"tflops_effective": eff,
            "roofline_bound_tflops": bound,
            "pct_of_roofline": 100.0 * eff / bound,
            "flops_per_frame": flops_per_frame,
            "route": route,
            "precision": precision}


def gemm_roofline(flops: float, t_seconds: float,
                  precision: str = "highest") -> dict:
    """Roofline attribution of one GEMM: ``flops`` (the 2mnk useful
    count) in ``t_seconds`` against the peak at ``precision`` (a
    ``bf16_comp`` rate divides by its own three-pass ceiling).  Same
    dict shape as :func:`conv_roofline`."""
    bound = _peak_tflops(precision)
    eff = float(flops) / float(t_seconds) / 1e12
    return {"tflops_effective": eff,
            "roofline_bound_tflops": bound,
            "pct_of_roofline": 100.0 * eff / bound,
            "precision": precision}


def dft_matmul_roofline(samples_per_s: float, n1: int, n2: int,
                        precision: str = "highest") -> dict:
    """Roofline attribution of a factorized matmul-DFT sample rate
    (:func:`ct_dft_flops` a transform) against the peak at
    ``precision``.  Same dict shape as :func:`conv_roofline`."""
    n = int(n1) * int(n2)
    bound = _peak_tflops(precision)
    eff = ct_dft_flops(n, n1, n2) / n * samples_per_s / 1e12
    return {"tflops_effective": eff,
            "roofline_bound_tflops": bound,
            "pct_of_roofline": 100.0 * eff / bound,
            "flops_per_sample": ct_dft_flops(n, n1, n2) / n,
            "precision": precision}


def analytical_roofline(flops: float, t_seconds: float,
                        precision: str = "highest") -> dict:
    """Roofline attribution from the count the resource axis recorded
    for the route that ran: ``flops`` is a row of ``obs.resources()``
    (``instrumented_jit`` on the kernel wrappers), which is the
    function's least work from this module's ``*_work`` functions —
    not a compiler's cost model, which the JAX package read.  Effective
    TFLOP/s in ``t_seconds`` against the peak at ``precision``.  The
    JAX keys are kept (``xla_flops`` holds the count), so readers of
    either package's rows parse both."""
    bound = _peak_tflops(precision)
    eff = float(flops) / float(t_seconds) / 1e12
    return {"tflops_analytical": eff,
            "roofline_bound_tflops": bound,
            "analytical_pct_of_roofline": 100.0 * eff / bound,
            "xla_flops": float(flops),
            "precision": precision}


# analytical-vs-measured disagreement above this % is worth a warning
ROOFLINE_DISAGREEMENT_WARN_PCT = 15.0


def roofline_disagreement_pct(measured_pct: float,
                              analytical_pct: float) -> float:
    """Relative disagreement (%) between the measured and analytical
    roofline figures, normalized by the measured one."""
    if not measured_pct:
        return float("inf") if analytical_pct else 0.0
    return 100.0 * abs(analytical_pct - measured_pct) / abs(
        measured_pct)


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
        fft_form = (rows * segs * (2 * rfft_flops(N) + 6 * (N // 2 + 1))
                    + rfft_flops(N))
        flops = min(flops, fft_form)
        N *= 2
    nbytes = 4.0 * (rows * n + k + rows * out_len)
    return flops, nbytes


def elementwise_work(ops: float, out_itemsize: int, *operands,
                     out_elems=None) -> tuple[float, float]:
    """``(flops, bytes)`` of an elementwise or reducing function:
    ``ops`` operations an output element, over ``out_elems`` outputs
    (default: the broadcast size of the array operands) of
    ``out_itemsize`` bytes, written once; each array operand (a tensor
    or a NumPy array) is read once, and a Python scalar moves
    nothing."""
    arrays = [o for o in operands if hasattr(o, "shape")]
    if out_elems is None:
        out_elems = math.prod(torch.broadcast_shapes(
            *(tuple(o.shape) for o in arrays))) if arrays else 1
    read = sum(int(o.nbytes) for o in arrays)
    return (float(ops) * out_elems,
            float(read + int(out_itemsize) * out_elems))


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
    fft2 = rfft_flops(p0 * p1)
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
    flops = rows * frames * (L + rfft_flops(L))
    nbytes = 4.0 * (rows * n + L + rows * frames * cols)
    return flops, nbytes


def filter_bank_work(rows: int, n_in: int, channels: int, k: int,
                     n_out: int) -> tuple[float, float]:
    """``(flops, bytes)`` of a float32 FIR bank: ``channels`` filters
    of ``k`` taps, each giving ``n_out`` outputs a row of ``rows``
    signals of ``n_in`` samples (one multiply-add per output and tap,
    any stride or dilation).  The bytes read the input and the taps
    once and write every channel's outputs once.  A full convolution
    (one channel, unit stride, ``n_out = n + k - 1``) is
    :func:`conv_work`, whose FFT form may be less."""
    rows, n_in, channels, k, n_out = (int(v) for v in (rows, n_in,
                                                       channels, k,
                                                       n_out))
    flops = 2.0 * channels * k * rows * n_out
    nbytes = 4.0 * (rows * n_in + channels * k + channels * rows * n_out)
    return flops, nbytes


def cascade_bank_work(rows: int, n_in: int, slots: int, channels: int,
                      n_out: int) -> tuple[float, float]:
    """``(flops, bytes)`` of a float32 cascade bank: ``channels``
    outputs of ``n_out`` samples a row from ``slots`` (phase, offset,
    tap) slots in all (one multiply-add per output and slot).  The
    bytes read the ``n_in`` input samples a row and the taps once and
    write every channel's outputs once."""
    rows, n_in, slots, channels, n_out = (int(v) for v in (
        rows, n_in, slots, channels, n_out))
    flops = 2.0 * slots * rows * n_out
    nbytes = 4.0 * (rows * n_in + slots + channels * rows * n_out)
    return flops, nbytes


def filter_2d_work(imgs: int, n0: int, n1: int, k0: int, k1: int,
                   n_out0: int, n_out1: int) -> tuple[float, float]:
    """``(flops, bytes)`` of a float32 2D correlation of ``imgs``
    images of ``n0 x n1`` with a ``k0 x k1`` kernel into ``n_out0 x
    n_out1`` outputs (one multiply-add per output and tap).  The bytes
    read the unpadded images and the kernel once and write the outputs
    once.  The full 2D convolution is :func:`conv2d_work`."""
    imgs, n0, n1, k0, k1, n_out0, n_out1 = (int(v) for v in (
        imgs, n0, n1, k0, k1, n_out0, n_out1))
    flops = 2.0 * imgs * n_out0 * n_out1 * k0 * k1
    nbytes = 4.0 * (imgs * n0 * n1 + k0 * k1 + imgs * n_out0 * n_out1)
    return flops, nbytes


# ---------------------------------------------------------------------------
# the sharded Fourier cost model (parallel/fourier.py): the JAX
# package's counts, with the H100's rates
# ---------------------------------------------------------------------------

def a2a_bytes(n_elems: int, itemsize: int, n_shards: int) -> int:
    """Bytes that move between shards in ONE tiled all-to-all of a
    global ``n_elems``-element array over ``n_shards`` shards: each
    shard keeps 1/S of its block and sends the rest, so the global
    payload is ``elems * itemsize * (S - 1) / S``."""
    if n_shards <= 1:
        return 0
    return int(n_elems) * int(itemsize) * (n_shards - 1) // n_shards


def ct_dft_flops(n: int, n1: int, n2: int) -> float:
    """Useful-FLOP count of one length-``n = n1*n2`` Cooley-Tukey
    factorized matmul DFT: two dense per-factor stages (8 real FLOPs
    per complex multiply-add) plus the twiddle multiply (6 FLOPs a
    sample)."""
    return 8.0 * float(n) * (int(n1) + int(n2)) + 6.0 * float(n)


def mesh_copy_gbps(cards: int = 1) -> float:
    """GB/s of a copy between two shards of a mesh: ``$VELES_SIMD_MESH_
    BW_GBPS`` when set; else NVLink's one-way rate between ``cards`` >
    1 cards, and on one card (or the CPU, modeled as one card) half of
    HBM's, since a copy there reads and writes the same memory."""
    env = os.environ.get(MESH_BW_ENV)
    if env:
        return float(env)
    if int(cards) > 1:
        return H100_NVLINK_GBPS
    return H100_HBM_TBPS * 1e3 / 2.0
