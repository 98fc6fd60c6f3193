#!/usr/bin/env python3
"""Relative benchmark generator of the port — ``tools/benchmark_suite.py``'s
twin over ``veles.simd_tpu_torch``, parity with ``tests/benchmark.inc``.

The reference compiles macro-generated benchmark TESTs (under
``--enable-benchmarks``) that time `iter_count` SIMD calls against the
scalar baseline and print
``SIMD version took X% of the original time. Speedup is Y% (Z times)``.
This module is the same generator over the port: each instantiation
times the port's path (``CUDA`` on the card, ``CPU`` when asked for)
against the NumPy oracle and prints the reference's line format plus
absolute throughput, at the JAX tool's instantiations and sizes.

What each row adds to the JAX tool's line:

* **Correctness first.** Before a row is timed, its ``simd=True``
  answer is checked against the section's NumPy oracle (relative to
  the oracle's largest magnitude, at the tolerance the matching port
  test or chip_smoke check uses, :data:`TOL`); a row that disagrees
  raises :class:`SuiteCheckError` and the run exits 1.
* **Chained time is not busy time.** ``utils.benchmark.
  device_time_chained`` runs the row's ``x -> x`` step as an eager
  chain between CUDA events: each step's host dispatch lies inside the
  window, so the Msamples/s it gives is the host's wherever the step's
  kernels are shorter than its dispatch.  Each row therefore also
  prints the device busy ms of one step (CUPTI's records,
  ``utils/devtrace.py``; "not measured" off the card) and the kernel
  launches one step made (``ops/cuda_kernels``' counters: K1
  ``overlap_save``, K2 ``filter_bank``, K3 ``cascade_bank``, K4
  ``stft``, K5 ``filter_2d``).
* **The conv roofline** keeps the JAX figure (2·h FLOPs an output
  sample, a *direct-form equivalent* that reads above 100 % on an FFT
  route) and prints beside it the share of the least-work bound
  (``utils.benchmark.conv_work``, at most 100 %), on the busy time.

Sections are functions (one per ``# ---`` block of the JAX tool), each
taking its sizes and returning its rows; :func:`run` drives them at
:data:`FULL` or :data:`QUICK` sizes.  On the card a chain never
resolves below the clock (a tiny step is host dispatch, tens of µs);
on the CPU the tiny convolve rows may read ``nan`` as in the JAX tool.

It runs on the card (``VELES_SIMD_PLATFORM=cpu`` asks for the CPU,
``utils.platform.select_device``; without a card and without that
request it exits 2).

Run:  python3 tools/benchmark_suite_torch.py [--quick]
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, NamedTuple

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))

from veles.simd_tpu_torch.utils.benchmark import (  # noqa: E402
    conv_roofline, conv_work, device_busy_ms, device_time_chained,
    fp32_bound, host_time, rms_normalize as _rms_normalize)

# relative to max|oracle|; the port's checks of the same calls
TOL = {
    "oracle": 1e-4,         # chip_smoke ORACLE_TOL (tools/tpu_smoke.py)
    "cascade": 5e-4,        # fused vs level loop (tests/test_pallas.py)
    "round_trip": 2e-4,     # DWT round trip (test_wavelet_synthesis)
    "iir": 2e-5,            # tests/test_iir.py, chip_smoke IIR_TOL
    "resample": 2e-5,       # tests/test_resample.py
    "mathfun": 1e-6,        # tests/test_torch_mathfun.py atol
    "normalize": 1e-6,      # tests/test_torch_normalize.py atol
    "peaks": 1e-6,          # values; positions exact
}

# the JAX tool's sizes (tools/benchmark_suite.py), nothing cut
FULL = {
    "conv_sizes": ((50, 50), (256, 256), (350, 21), (1000, 50),
                   (2000, 950), (1 << 17, 127), (1 << 20, 2047)),
    "conv_high": (1 << 20, 2047),
    "conv_batched": (256, 4096, 129),
    "gemm": (300, 256, 1000),
    "gemm_sizes": (512, 1024, 2048, 4096),
    "gemm_batched": (64, 512),
    "gemv": 4096,
    "dwt": (64, 512),
    "cascade": (512, 4096),
    "conv2d": (8, 512, (9, 63)),
    "conv2d_small": (64, 128, 5),
    "mathfun": 1 << 20,
    "signal": 1 << 20,
    "stft": 1 << 20,
    "iir": (64, 1 << 14),
    "batched": (256, 4096),
    "medfilt": (64, 1 << 16, 8, 8192),
    "czt_bins": 1024,
    "lombscargle": (1 << 14, 1024),
    "normalize": 2048,
    "peaks": (64, 1 << 16, 1024),
}

# --quick, as the JAX tool cuts it
QUICK = dict(FULL, conv_sizes=FULL["conv_sizes"][:5], conv_high=None,
             gemm_sizes=(512, 1024, 2048), signal=1 << 17, stft=1 << 17,
             iir=(8, 1 << 12), batched=(64, 4096))

# every checked row appends {"name", "args", "got", "want"} here when a
# caller sets it to a list (the CPU tests hold each answer to the JAX
# package's on the same inputs)
RECORD = None


class SuiteCheckError(RuntimeError):
    """A row's answer disagrees with its NumPy oracle."""


class Check(NamedTuple):
    """A row's correctness check: ``got()`` is the ``simd=True``
    answer, ``want()`` the NumPy oracle's, ``args`` the NumPy inputs
    of the call (kept for :data:`RECORD`)."""
    got: Callable
    want: Callable
    tol: float
    args: tuple = ()


def _host(v):
    """``v`` (a tensor, array or tuple of them) as NumPy."""
    from veles.simd_tpu_torch.utils.platform import to_host

    if isinstance(v, (tuple, list)):
        return [_host(a) for a in v]
    return to_host(v)


def _flat(v) -> np.ndarray:
    if isinstance(v, (tuple, list)):
        return np.concatenate([np.ravel(np.asarray(a)) for a in v])
    return np.ravel(np.asarray(v))


def rel_err(got, want) -> float:
    """max|got - want| over max|want| (complex and tuples alike)."""
    g, w = _flat(got), _flat(want)
    if g.shape != w.shape:
        return float("inf")
    scale = float(np.max(np.abs(w))) if w.size else 0.0
    return float(np.max(np.abs(g.astype(np.complex128)
                               - w.astype(np.complex128)))
                 / (scale or 1.0)) if w.size else 0.0


def _dev(a, dtype=np.float32):
    from veles.simd_tpu_torch.utils.platform import to_device

    return to_device(np.asarray(a, dtype))


def _on_card() -> bool:
    from veles.simd_tpu_torch.utils.platform import on_cuda

    return on_cuda()


def path_name() -> str:
    """The port's path in the reference's line (the JAX tool's
    "XLA")."""
    return "CUDA" if _on_card() else "CPU"


def _launches(fn) -> tuple:
    """``(launches, seconds)`` of one call of ``fn``: the kernels that
    ran (counters reset before it) and its wall time, waited for."""
    import torch

    from veles.simd_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launches()
    t0 = time.perf_counter()
    fn()
    if _on_card():
        torch.cuda.synchronize()
    took = time.perf_counter() - t0
    return {k: v for k, v in ck.LAUNCHES.items() if v}, took


# a chain's first trip count covers at least this many seconds of steps
# and at most the caller's ``iters``: a slow step (the czt row's host
# chirp, about 1 s a step at 2^20) needs no 256-step chain to clear
# the timer's window
CHAIN_S = 0.5


def _busy_ms(fn):
    """Device busy ms of one call of ``fn`` on the card, else None."""
    if not _on_card():
        return None
    return device_busy_ms(fn, calls=10, keep=3)


def _check(name: str, check: Check) -> float:
    got = _host(check.got())
    want = check.want()
    err = rel_err(got, want)
    if RECORD is not None:
        RECORD.append({"name": name, "args": check.args, "got": got,
                       "want": want})
    if not err <= check.tol:
        raise SuiteCheckError(f"[{name}] rel err {err:.3e} against the "
                              f"NumPy oracle > {check.tol:.0e}")
    return err


def _fmt_busy(busy) -> str:
    return "not measured" if busy is None else f"{busy:.4f} ms"


def benchmark(name, step, x0, baseline_fn, *, samples=None, flops=None,
              baseline_repeats=3, iters=256, baseline_samples=None,
              check: Check | None = None) -> dict:
    """The benchmark.inc pattern: chained device time vs host-time
    baseline, after the row's check against its oracle.

    ``step`` is the workload as an ``x -> x`` function (chained on the
    device by the timer); ``baseline_fn`` is synchronous host code.
    ``baseline_samples`` scales the baseline time up to the device
    workload size when the oracle runs on a subset (linear-cost ops
    only).  Returns the row: ``times`` (speedup), ``t_peak`` (s a
    step, chained), ``samples_per_s``, ``busy_ms`` (one step's device
    time, None off the card), ``launches`` and ``rel_err``."""
    t0 = time.perf_counter()
    err = _check(name, check) if check is not None else None
    launches, step_s = _launches(lambda: step(x0))
    busy = _busy_ms(lambda: step(x0))
    t_peak = device_time_chained(
        step, x0, iters=min(iters, max(16, int(CHAIN_S / step_s))))
    # the check's oracle call warmed the host path (the JAX tool's
    # warm-up call); a row without a check warms once here
    t_base = host_time(baseline_fn, repeats=baseline_repeats,
                       warmup=0 if check is not None else 1)
    if baseline_samples is not None and samples:
        t_base *= samples / baseline_samples
    pct = 100.0 * t_peak / t_base
    times = t_base / t_peak
    line = (f"[{name}] {path_name()} version took {pct:.2f}% of the "
            f"original time. Speedup is {100 - pct:.0f}% "
            f"({times:.1f} times)")
    if samples:
        line += f" | {samples / t_peak / 1e6:.0f} Msamples/s"
    if flops:
        line += f" | {flops / t_peak / 1e9:.0f} GFLOP/s"
    line += f" | busy {_fmt_busy(busy)} | launches {launches}"
    if err is not None:
        line += f" | rel err {err:.1e}"
    print(line, flush=True)
    return {"name": name, "times": times, "t_peak": t_peak,
            "samples_per_s": (samples / t_peak) if samples else None,
            "busy_ms": busy, "launches": launches, "rel_err": err,
            "wall_s": time.perf_counter() - t0}


def _roofline_line(label: str, samples_per_s: float, n: int, k: int,
                   precision: str, busy_ms) -> dict:
    """The conv-roofline row: the JAX figure (direct-form equivalent)
    and the share of the least-work bound the busy time reaches."""
    roof = conv_roofline(samples_per_s, k, precision)
    bound_ms, bound_by = fp32_bound(*conv_work(1, n, k))
    least = (100.0 * bound_ms / busy_ms) if busy_ms else None
    roof.update(least_work_bound_ms=bound_ms,
                least_work_bound_by=bound_by,
                pct_of_least_work_bound=least)
    print(f"[conv-roofline {label}] {roof['tflops_effective']:.1f} "
          f"TFLOP/s effective = {roof['pct_of_roofline']:.0f}% of the "
          f"fp32-{precision.upper()} peak "
          f"({roof['roofline_bound_tflops']:.1f} TFLOP/s), a direct-"
          f"form equivalent | least-work bound {bound_ms:.4f} ms "
          f"({bound_by}): "
          + ("not measured" if least is None else f"{least:.1f}%")
          + " of it on the busy time", flush=True)
    return {"name": f"conv-roofline {label}", "roofline": roof}


# --- convolve crossovers (tests/convolve.cc:168-401) ---
def section_convolve(rng, sizes) -> list:
    from veles.simd_tpu_torch.ops import convolve as cv

    rows = []
    for xlen, hlen in sizes:
        x = rng.randn(xlen).astype(np.float32)
        h = rng.randn(hlen).astype(np.float32)
        xd, hd = _dev(x), _dev(h)
        handle = cv.convolve_initialize(xlen, hlen)

        def conv_step(v, handle=handle, hd=hd, xlen=xlen):
            y = cv.convolve(handle, v, hd, simd=True)
            return v + 1e-30 * y[..., :xlen]

        def oracle(handle=handle, x=x, h=h):
            return cv.convolve(handle, x, h, simd=False)

        res = benchmark(
            f"convolve {xlen}x{hlen} [{handle.algorithm.value}]",
            conv_step, xd, oracle, samples=xlen,
            baseline_repeats=1 if xlen >= 1 << 17 else 3,
            check=Check(lambda handle=handle, xd=xd, hd=hd:
                        cv.convolve(handle, xd, hd, simd=True),
                        oracle, TOL["oracle"], (x, h)))
        res["route"] = (("cuda_fused" if cv._use_cuda_os(hlen, xd)
                         else "xla_matmul") if handle.os_matmul
                        else handle.algorithm.value)
        rows.append(res)
        if (handle.os_matmul and xlen >= 1 << 17
                and res["samples_per_s"]
                and np.isfinite(res["samples_per_s"])):
            rows.append(_roofline_line(
                f"{xlen}x{hlen} {res['route']}", res["samples_per_s"],
                xlen, hlen, cv.os_precision(), res["busy_ms"]))
    return rows


# --- 1M conv at conv_precision="high" (the block-matmul route's
# documented fast knob; K1, which the card's handle takes, has no
# precision knob and runs the same) ---
def section_convolve_high(rng, xlen, hlen) -> list:
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.utils.config import get_config, set_config

    x = rng.randn(xlen).astype(np.float32)
    h = rng.randn(hlen).astype(np.float32)
    xd, hd = _dev(x), _dev(h)
    handle = cv.convolve_initialize(xlen, hlen)
    prev = get_config().conv_precision
    set_config(conv_precision="high")
    try:
        def conv_hi_step(v, handle=handle, hd=hd, xlen=xlen):
            y = cv.convolve(handle, v, hd, simd=True)
            return v + 1e-30 * y[..., :xlen]

        def oracle():
            return cv.convolve(handle, x, h, simd=False)

        res = benchmark(
            f"convolve {xlen}x{hlen} [overlap_save, precision=high]",
            conv_hi_step, xd, oracle, samples=xlen, baseline_repeats=1,
            check=Check(lambda: cv.convolve(handle, xd, hd, simd=True),
                        oracle, TOL["oracle"], (x, h)))
        res["route"] = ("cuda_fused" if cv._use_cuda_os(hlen, xd)
                        else "xla_matmul")
        rows = [res]
        if res["samples_per_s"] and np.isfinite(res["samples_per_s"]):
            rows.append(_roofline_line(
                f"{xlen}x{hlen} precision=high", res["samples_per_s"],
                xlen, hlen, "high", res["busy_ms"]))
        return rows
    finally:
        set_config(conv_precision=prev)


# --- batched direct convolution (K2 on the card, the filter-bank
# kernel; tests/convolve.cc brute-force form) ---
def section_convolve_batched(rng, rows_, n, k) -> list:
    from veles.simd_tpu_torch.ops import convolve as cv

    xb = rng.randn(rows_, n).astype(np.float32)
    hb = rng.randn(k).astype(np.float32)
    xbd, hbd = _dev(xb), _dev(hb)

    def bconv_step(v):
        y = cv.convolve_simd(v, hbd, simd=True)
        return v + 1e-30 * y[..., :n]

    return [benchmark(
        f"convolve batched {rows_}x{n}x{k} [direct]", bconv_step, xbd,
        lambda: cv.convolve_na(xb, hb), samples=xb.size,
        baseline_repeats=1,
        check=Check(lambda: cv.convolve_simd(xbd, hbd, simd=True),
                    lambda: cv.convolve_na(xb, hb), TOL["oracle"],
                    (xb, hb)))]


def _fold(y, n):  # [m, w] -> [m, n], all columns used
    return _rms_normalize(sum(y[:, s:s + n]
                              for s in (0, 248, 496, 744)))


# --- GEMM straight vs transposed (tests/matrix.cc:206-288) ---
def section_gemm(rng, m, k, n) -> list:
    from veles.simd_tpu_torch.ops import matrix as mx
    from veles.simd_tpu_torch.runtime import precision as prx

    # the step folds the [m, n] product back to the [m, k] input shape
    # as a sum of overlapping column slices (every column used)
    a = rng.randn(m, k).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    ad, bd = _dev(a), _dev(b)
    btd = _dev(b.T.copy())
    flops_ref = 2 * m * k * n
    want64 = a.astype(np.float64) @ b.astype(np.float64)
    rows = [benchmark(
        f"gemm {m}x{k}x{n}", lambda v: _fold(mx._matmul_p(v, bd), k), ad,
        lambda: mx.matrix_multiply_novec(a, b), flops=flops_ref,
        check=Check(lambda: mx._matmul_p(ad, bd), lambda: want64,
                    prx.ERROR_BUDGETS["highest"], (a, b)))]
    rows.append(benchmark(
        f"gemm {m}x{k}x{n} transposed-B",
        lambda v: _fold(mx._matmul_t_p(v, btd), k), ad,
        lambda: mx.matrix_multiply_transposed_novec(a, b.T),
        flops=flops_ref,
        check=Check(lambda: mx._matmul_t_p(ad, btd), lambda: want64,
                    prx.ERROR_BUDGETS["highest"], (a, b.T.copy()))))
    return rows


# the JAX sweep's f32/HIGHEST and bf16 "fast" arms: the port's fp32
# route, and its bf16 and bf16_comp routes (runtime/precision.py)
GEMM_ROUTES = ("highest", "bf16_comp", "bf16")


# --- GEMM size sweep, fp32 against the bf16 routes; a batched GEMM ---
def section_gemm_sweep(rng, sizes, batch, bn) -> list:
    from veles.simd_tpu_torch.ops import matrix as mx
    from veles.simd_tpu_torch.runtime import precision as prx

    rows = []

    def sweep(label, an, bnm, flops, iters, want64):
        t0 = time.perf_counter()
        and_, bnd = _dev(an), _dev(bnm)
        parts, row = [], {"name": label, "gflops": {}, "busy_ms": {},
                          "rel_err": {}}
        for prec in GEMM_ROUTES:
            err = _check(f"{label} {prec}", Check(
                lambda: mx._matmul_p(and_, bnd, precision=prec),
                lambda: want64, prx.ERROR_BUDGETS[prec], (an, bnm)))

            def step(v, prec=prec):
                return _rms_normalize(
                    mx._matmul_p(v, bnd, precision=prec))

            t = device_time_chained(step, and_, iters=iters)
            busy = _busy_ms(lambda: step(and_))
            row["gflops"][prec] = flops / t / 1e9
            row["busy_ms"][prec] = busy
            row["rel_err"][prec] = err
            parts.append(f"[{prec}] {flops / t / 1e9:.0f} GFLOP/s "
                         f"(busy {_fmt_busy(busy)}, rel err {err:.1e})")
        row["wall_s"] = time.perf_counter() - t0
        rows.append(row)
        return parts

    for n in sizes:
        an = rng.randn(n, n).astype(np.float32)
        bnm = rng.randn(n, n).astype(np.float32)
        t_base = host_time(
            lambda: mx.matrix_multiply_novec(an[:256], bnm),
            repeats=1) * (n / 256)
        flops = 2 * n ** 3
        parts = sweep(f"gemm {n}", an, bnm, flops,
                      64 if n >= 2048 else 256,
                      an.astype(np.float64) @ bnm.astype(np.float64))
        print(f"[gemm {n}] " + " | ".join(parts)
              + f" | cpu-oracle ~{flops / t_base / 1e9:.0f} GFLOP/s",
              flush=True)
    # batched GEMM: batch x (bn^3) — amortizes dispatch, fills the card
    ab = rng.randn(batch, bn, bn).astype(np.float32)
    bb = rng.randn(batch, bn, bn).astype(np.float32)
    parts = sweep(f"gemm batched {batch}x{bn}^3", ab, bb,
                  2 * batch * bn ** 3, 64,
                  np.matmul(ab.astype(np.float64), bb.astype(np.float64)))
    print(f"[gemm batched {batch}x{bn}^3] " + " | ".join(parts),
          flush=True)
    return rows


# --- gemv (BASELINE.md config 3; tests/matrix.cc gemv pattern) ---
def section_gemv(rng, n) -> list:
    from veles.simd_tpu_torch.ops import matrix as mx

    am = rng.randn(n, n).astype(np.float32)
    v = rng.randn(n).astype(np.float32)
    amd, vd = _dev(am), _dev(v)
    return [benchmark(
        f"gemv {n}x{n}",
        lambda w: _rms_normalize(
            mx.matrix_vector_multiply(amd, w, simd=True)), vd,
        lambda: am @ v, flops=2 * n * n,
        check=Check(lambda: mx.matrix_vector_multiply(amd, vd, simd=True),
                    lambda: am.astype(np.float64) @ v.astype(np.float64),
                    TOL["oracle"], (am, v)))]


def _dwt_check(name, wtype, order, sig, sigd):
    from veles.simd_tpu_torch.ops import wavelet as wv

    ext = wv.ExtensionType.PERIODIC
    return Check(lambda: wv.wavelet_apply(wtype, order, ext, sigd,
                                          simd=True),
                 lambda: wv.wavelet_apply_na(wtype, order, ext, sig),
                 TOL["oracle"], (sig,))


# --- DWT per order (tests/wavelet.cc:290-336) ---
def section_dwt(rng, rows_, n, orders=(4, 6, 8, 12, 16)) -> list:
    import torch

    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.ops.wavelet_coeffs import WaveletType

    sig = rng.randn(rows_, n).astype(np.float32)
    sigd = _dev(sig)
    rows = []
    for order in orders:

        def dwt_step(v, order=order):
            hi, lo = wv.wavelet_apply(
                WaveletType.DAUBECHIES, order, wv.ExtensionType.PERIODIC,
                v, simd=True)
            return torch.cat([hi, lo], dim=-1)

        name = f"dwt daub{order} {rows_}x{n}"
        rows.append(benchmark(
            name, dwt_step, sigd,
            lambda order=order: wv.wavelet_apply_na(
                WaveletType.DAUBECHIES, order, wv.ExtensionType.PERIODIC,
                sig),
            samples=sig.size,
            check=_dwt_check(name, WaveletType.DAUBECHIES, order, sig,
                             sigd)))
    return rows


# --- DWT other families + stationary SWT (BASELINE config 5 names
# daub-8 / coiflet-3 (order 18) / symlet-4 (order 8), DWT + SWT) ---
def section_dwt_families(rng, rows_, n) -> list:
    import torch

    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.ops.wavelet_coeffs import WaveletType

    sig = rng.randn(rows_, n).astype(np.float32)
    sigd = _dev(sig)
    rows = []
    for wtype, order in ((WaveletType.COIFLET, 18),
                         (WaveletType.SYMLET, 8)):

        def dwt_fam_step(v, wtype=wtype, order=order):
            hi, lo = wv.wavelet_apply(
                wtype, order, wv.ExtensionType.PERIODIC, v, simd=True)
            return torch.cat([hi, lo], dim=-1)

        name = f"dwt {wtype.name.lower()}{order} {rows_}x{n}"
        rows.append(benchmark(
            name, dwt_fam_step, sigd,
            lambda wtype=wtype, order=order: wv.wavelet_apply_na(
                wtype, order, wv.ExtensionType.PERIODIC, sig),
            samples=sig.size,
            check=_dwt_check(name, wtype, order, sig, sigd)))

    ext = wv.ExtensionType.PERIODIC

    def swt_step(v):
        hi, lo = wv.stationary_wavelet_apply(
            WaveletType.DAUBECHIES, 8, 2, ext, v, simd=True)
        return _rms_normalize(hi + lo)

    def swt_oracle():
        return wv.stationary_wavelet_apply_na(
            WaveletType.DAUBECHIES, 8, 2, ext, sig)

    rows.append(benchmark(
        f"swt daub8 level2 {rows_}x{n}", swt_step, sigd, swt_oracle,
        samples=sig.size,
        check=Check(lambda: wv.stationary_wavelet_apply(
            WaveletType.DAUBECHIES, 8, 2, ext, sigd, simd=True),
            swt_oracle, TOL["oracle"], (sig,))))
    return rows


# --- fused multi-level cascade (K3) vs the level loop (K2 a level);
# the fused cascade is the port's default where its gate admits the
# shape (the JAX package keeps it opt-in), and the level-loop entry
# runs one wavelet_apply a level so the comparison stays on record ---
def section_cascade(rng, rows_, n) -> list:
    import torch

    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.ops.wavelet_coeffs import WaveletType

    big = rng.randn(rows_, n).astype(np.float32)
    bigd = _dev(big)
    ext = wv.ExtensionType.PERIODIC

    def fused(v):
        return wv.wavelet_transform(WaveletType.DAUBECHIES, 8, ext, v, 3,
                                    simd=True)

    def cascade_fused_step(v):
        return torch.cat(list(fused(v)), dim=-1)

    def loop(v):
        cur, outs = v, []
        for _ in range(3):
            hi, cur = wv.wavelet_apply(WaveletType.DAUBECHIES, 8, ext,
                                       cur, simd=True)
            outs.append(hi)
        return outs + [cur]

    def cascade_loop_step(v):
        return torch.cat(loop(v), dim=-1)

    def oracle():
        return wv.wavelet_transform(WaveletType.DAUBECHIES, 8, ext, big,
                                    3, simd=False)

    return [
        benchmark(f"dwt cascade L3 fused {rows_}x{n}",
                  cascade_fused_step, bigd, oracle, samples=big.size,
                  baseline_repeats=1,
                  check=Check(lambda: fused(bigd), oracle,
                              TOL["cascade"], (big,))),
        benchmark(f"dwt cascade L3 level-loop {rows_}x{n}",
                  cascade_loop_step, bigd, oracle, samples=big.size,
                  baseline_repeats=1,
                  check=Check(lambda: loop(bigd), oracle, TOL["oracle"],
                              (big,))),
    ]


# --- wavelet synthesis (analysis + exact inverse per iteration) ---
def section_synthesis(rng, rows_, n) -> list:
    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.ops.wavelet_coeffs import WaveletType

    sig = rng.randn(rows_, n).astype(np.float32)
    sigd = _dev(sig)
    d8 = WaveletType.DAUBECHIES

    def synth_step(v):
        hi, lo = wv.wavelet_apply(d8, 8, wv.ExtensionType.PERIODIC, v,
                                  simd=True)
        return wv.wavelet_reconstruct(d8, 8, hi, lo, simd=True)

    def oracle():
        return wv.wavelet_reconstruct_na(
            d8, 8, *wv.wavelet_apply_na(d8, 8, wv.ExtensionType.PERIODIC,
                                        sig))

    return [benchmark(f"dwt+idwt round trip daub8 {rows_}x{n}",
                      synth_step, sigd, oracle, samples=sig.size,
                      check=Check(lambda: synth_step(sigd), oracle,
                                  TOL["round_trip"], (sig,)))]


# --- 2D convolution (K5, the 2D kernel, where its shared-memory gate
# admits the kernel; the FFT route beyond, k = 63 among them) ---
def section_conv2d(rng, imgs, n, ks, small) -> list:
    from veles.simd_tpu_torch.ops import convolve2d as cv2d

    # algorithm=None -> the auto route (K5 when the kernel's area is at
    # most 256 taps, else the FFT route)
    img = rng.randn(imgs, n, n).astype(np.float32)
    imgd = _dev(img)
    rows = []
    for klen in ks:
        k2 = rng.randn(klen, klen).astype(np.float32)
        k2d = _dev(k2)
        algo = cv2d.select_algorithm2d(klen, klen, img.shape)

        def conv2d_step(v, k2d=k2d):
            y = cv2d.convolve2d(v, k2d, simd=True)
            return v + 1e-30 * y[..., :n, :n]

        res = benchmark(
            f"conv2d {imgs}x{n}x{n} k={klen} [auto:{algo}]", conv2d_step,
            imgd, lambda k2=k2: cv2d.convolve2d_na(img, k2),
            samples=img.size, baseline_repeats=1,
            check=Check(lambda k2d=k2d: cv2d.convolve2d(imgd, k2d,
                                                        simd=True),
                        lambda k2=k2: cv2d.convolve2d_na(img, k2),
                        TOL["oracle"], (img, k2)))
        res["route"] = algo
        rows.append(res)
    # the kernel's small-image shape
    simgs, sn, sk = small
    imgp = rng.randn(simgs, sn, sn).astype(np.float32)
    imgpd = _dev(imgp)
    k2p = rng.randn(sk, sk).astype(np.float32)
    k2pd = _dev(k2p)
    algo = cv2d.select_algorithm2d(sk, sk, imgp.shape)
    res = benchmark(
        f"conv2d {simgs}x{sn}x{sn} k={sk} [auto:{algo}]",
        lambda v: v + 1e-30 * cv2d.convolve2d(v, k2pd, simd=True)[
            ..., :sn, :sn],
        imgpd, lambda: cv2d.convolve2d_na(imgp, k2p),
        samples=imgp.size, baseline_repeats=1,
        check=Check(lambda: cv2d.convolve2d(imgpd, k2pd, simd=True),
                    lambda: cv2d.convolve2d_na(imgp, k2p),
                    TOL["oracle"], (imgp, k2p)))
    res["route"] = algo
    rows.append(res)
    return rows


# --- mathfun (tests/mathfun.cc pattern) ---
def section_mathfun(rng, n) -> list:
    from veles.simd_tpu_torch.ops.mathfun import sin_psv

    v = rng.randn(n).astype(np.float32)
    vd = _dev(v)
    return [benchmark(
        f"sin {n >> 20}M" if n >= 1 << 20 else f"sin {n >> 10}k",
        lambda w: sin_psv(w, simd=True) + 0.5, vd,
        lambda: sin_psv(v, simd=False), samples=v.size,
        check=Check(lambda: sin_psv(vd, simd=True),
                    lambda: sin_psv(v, simd=False), TOL["mathfun"],
                    (v,)))]


# --- spectral: STFT over a long signal (K4 where its route admits the
# geometry: at least two hops a frame, at least 64 frames, the frame in
# shared memory) ---
def section_stft(rng, ns, frame=1024, hop=256) -> list:
    import torch

    from veles.simd_tpu_torch.ops import spectral as sp

    xs = rng.randn(ns).astype(np.float32)
    xsd = _dev(xs)

    def stft_step(v):
        s = sp.stft(v, frame, hop, simd=True)
        return v + 1e-30 * torch.abs(s[..., 0, 0])

    res = benchmark(
        f"stft {ns >> 10}k fl={frame} hop={hop}", stft_step, xsd,
        lambda: sp.stft_na(xs, frame, hop), samples=xs.size,
        baseline_repeats=1,
        check=Check(lambda: sp.stft(xsd, frame, hop, simd=True),
                    lambda: sp.stft_na(xs, frame, hop), TOL["oracle"],
                    (xs,)))
    res["route"] = sp._select_stft_route(
        frame, hop, (ns - frame) // hop + 1, cuda=xsd.is_cuda)
    print(f"[stft {ns >> 10}k fl={frame} hop={hop}] route "
          f"{res['route']}", flush=True)
    return [res]


# --- resample: polyphase 48k->44.1k ---
def section_resample(rng, ns) -> list:
    from veles.simd_tpu_torch.ops import resample as rs

    xs = rng.randn(ns).astype(np.float32)
    xsd = _dev(xs)

    def rsp_step(v):
        y = rs.resample_poly(v, 160, 147, simd=True)
        return v + 1e-30 * y[..., : v.shape[-1]]

    return [benchmark(
        f"resample_poly {ns >> 10}k 160/147", rsp_step, xsd,
        lambda: rs.resample_poly_na(xs, 160, 147), samples=xs.size,
        baseline_repeats=1,
        check=Check(lambda: rs.resample_poly(xsd, 160, 147, simd=True),
                    lambda: rs.resample_poly_na(xs, 160, 147),
                    TOL["resample"], (xs,)))]


# --- iir: order-4 biquad cascade (the log-depth doubling scan) vs the
# sequential float64 oracle ---
def section_iir(rng, bi, ni) -> list:
    from veles.simd_tpu_torch.ops import iir

    sos = iir.butterworth(4, 0.25, "lowpass")
    xi = rng.randn(bi, ni).astype(np.float32)
    xid = _dev(xi)

    def iir_step(v):
        y = iir.sosfilt(sos, v, simd=True)
        return v + 1e-30 * y

    return [benchmark(
        f"sosfilt order4 {bi}x{ni >> 10}k", iir_step, xid,
        lambda: iir.sosfilt_na(sos, xi), samples=xi.size,
        baseline_repeats=1,
        check=Check(lambda: iir.sosfilt(sos, xid, simd=True),
                    lambda: iir.sosfilt_na(sos, xi), TOL["iir"],
                    (sos, xi)))]


# --- batched-throughput layer (ops/batched): the same per-signal
# length single-signal and as one batched dispatch, ratio printed ---
def section_batched(rng, nb, per, bi, ni) -> list:
    from veles.simd_tpu_torch.ops import batched as bt
    from veles.simd_tpu_torch.ops import iir
    from veles.simd_tpu_torch.ops import resample as rs

    rows = []
    x1 = rng.randn(per).astype(np.float32)
    xbm = rng.randn(nb, per).astype(np.float32)
    x1d, xbmd = _dev(x1), _dev(xbm)

    def rsp_single_step(v):
        y = rs.resample_poly(v, 160, 147, simd=True)
        return v + 1e-30 * y[..., :per]

    def rsp_batched_step(v):
        y = bt.batched_resample_poly(v, 160, 147, simd=True)
        return v + 1e-30 * y[..., :per]

    sub = min(8, nb)
    r1 = benchmark(f"resample_poly single 1x{per} 160/147",
                   rsp_single_step, x1d,
                   lambda: rs.resample_poly_na(x1, 160, 147),
                   samples=per, baseline_repeats=1,
                   check=Check(lambda: rs.resample_poly(
                       x1d, 160, 147, simd=True),
                       lambda: rs.resample_poly_na(x1, 160, 147),
                       TOL["resample"], (x1,)))
    rb = benchmark(f"resample_poly batched {nb}x{per} 160/147",
                   rsp_batched_step, xbmd,
                   lambda: rs.resample_poly_na(xbm[:sub], 160, 147),
                   samples=nb * per, baseline_samples=sub * per,
                   baseline_repeats=1,
                   check=Check(lambda: bt.batched_resample_poly(
                       xbmd, 160, 147, simd=True)[:sub],
                       lambda: rs.resample_poly_na(xbm[:sub], 160, 147),
                       TOL["resample"], (xbm,)))
    rows += [r1, rb]
    if all(v and np.isfinite(v) for v in (r1["samples_per_s"],
                                          rb["samples_per_s"])):
        print(f"[batched/single resample_poly @ {per}] "
              f"{rb['samples_per_s'] / r1['samples_per_s']:.1f}x",
              flush=True)

    sos = iir.butterworth(4, 0.25, "lowpass")
    xi1 = rng.randn(ni).astype(np.float32)
    xib = rng.randn(bi, ni).astype(np.float32)
    xi1d, xibd = _dev(xi1), _dev(xib)
    sub = min(8, bi)

    s1 = benchmark(f"sosfilt single 1x{ni >> 10}k order4",
                   lambda v: v + 1e-30 * iir.sosfilt(sos, v, simd=True),
                   xi1d, lambda: iir.sosfilt_na(sos, xi1), samples=ni,
                   baseline_repeats=1,
                   check=Check(lambda: iir.sosfilt(sos, xi1d, simd=True),
                               lambda: iir.sosfilt_na(sos, xi1),
                               TOL["iir"], (sos, xi1)))
    sb = benchmark(f"sosfilt batched {bi}x{ni >> 10}k order4",
                   lambda v: v + 1e-30 * bt.batched_sosfilt(sos, v,
                                                           simd=True),
                   xibd, lambda: iir.sosfilt_na(sos, xib[:sub]),
                   samples=bi * ni, baseline_samples=sub * ni,
                   baseline_repeats=1,
                   check=Check(lambda: bt.batched_sosfilt(
                       sos, xibd, simd=True)[:sub],
                       lambda: iir.sosfilt_na(sos, xib[:sub]),
                       TOL["iir"], (sos, xib)))
    rows += [s1, sb]
    if all(v and np.isfinite(v) for v in (s1["samples_per_s"],
                                          sb["samples_per_s"])):
        print(f"[batched/single sosfilt @ {ni >> 10}k] "
              f"{sb['samples_per_s'] / s1['samples_per_s']:.1f}x",
              flush=True)

    bco = np.array([0.2, 0.3, 0.1])
    aco = np.array([1.0, -0.5, 0.2, -0.05])
    rows.append(benchmark(
        f"lfilter batched {bi}x{ni >> 10}k order3",
        lambda v: v + 1e-30 * bt.batched_lfilter(bco, aco, v, simd=True),
        xibd, lambda: iir.lfilter_na(bco, aco, xib[:sub]),
        samples=bi * ni, baseline_samples=sub * ni, baseline_repeats=1,
        check=Check(lambda: bt.batched_lfilter(bco, aco, xibd,
                                               simd=True)[:sub],
                    lambda: iir.lfilter_na(bco, aco, xib[:sub]),
                    TOL["iir"], (bco, aco, xib))))
    return rows


# --- filters: median (the compare-exchange network) ---
def section_medfilt(rng, rows_, n, sub_rows, sub_n) -> list:
    from veles.simd_tpu_torch.ops import filters as flt

    xm = rng.randn(rows_, n).astype(np.float32)
    xmd = _dev(xm)
    xs = xm[:sub_rows, :sub_n].copy()
    xsd = _dev(xs)
    return [benchmark(
        f"medfilt k=7 {rows_}x{n >> 10}k", lambda v: flt.medfilt(
            v, 7, simd=True), xmd, lambda: flt.medfilt_na(xs, 7),
        samples=xm.size, baseline_samples=xs.size, baseline_repeats=1,
        check=Check(lambda: flt.medfilt(xsd, 7, simd=True),
                    lambda: flt.medfilt_na(xs, 7), TOL["oracle"],
                    (xs,)))]


# --- czt: Bluestein zoom on a long capture ---
def section_czt(rng, ns, bins) -> list:
    import torch

    from veles.simd_tpu_torch.ops import spectral as sp

    xs = rng.randn(ns).astype(np.float32)
    xsd = _dev(xs)

    def czt_step(v):
        z = sp.czt(v, bins, simd=True)
        return v + 1e-30 * torch.abs(z[..., 0])

    # baseline = the host Bluestein fallback at FULL size (the direct
    # O(n*m) oracle would need a 16 GB matrix at 1M samples)
    return [benchmark(
        f"czt {ns >> 10}k -> {bins} bins", czt_step, xsd,
        lambda: sp.czt(xs, bins, simd=False), samples=xs.size,
        baseline_repeats=1,
        check=Check(lambda: sp.czt(xsd, bins, simd=True),
                    lambda: sp.czt(xs, bins, simd=False), TOL["oracle"],
                    (xs,)))]


# --- lombscargle: the dense [freqs, samples] trig grid ---
def section_lombscargle(rng, n, nf) -> list:
    from veles.simd_tpu_torch.ops import spectral as sp

    tu = np.sort(rng.uniform(0, 100, n))
    xu = np.sin(1.7 * tu).astype(np.float32)
    fr = np.linspace(0.5, 3.0, nf)
    tud = _dev(tu)
    xud, frd = _dev(xu), _dev(fr)
    wud = _dev(np.ones(n))      # unit weights

    def ls_step(v):
        p = sp._lombscargle_torch(tud, v, frd, wud)
        return v + 1e-30 * p[..., 0]

    return [benchmark(
        f"lombscargle {n >> 10}k x {nf}", ls_step, xud,
        lambda: sp.lombscargle_na(tu, xu, fr), samples=n * nf,
        baseline_repeats=1,
        check=Check(lambda: sp._lombscargle_torch(tud, xud, frd, wud),
                    lambda: sp.lombscargle_na(tu, xu, fr),
                    TOL["oracle"], (tu, xu, fr)))]


# --- normalize: the reference's min-max plane family, f32 plane (a
# shape/dtype-preserving step; repeated normalization is a fixpoint) ---
def section_normalize(rng, n) -> list:
    from veles.simd_tpu_torch.ops import normalize as nz

    npl = rng.randn(n, n).astype(np.float32) * 100 + 50
    npld = _dev(npl)
    return [benchmark(
        f"normalize2D {n}x{n} f32",
        lambda v: nz.normalize2D(v, simd=True), npld,
        lambda: nz.normalize2D_novec(npl), samples=npl.size,
        baseline_repeats=1,
        check=Check(lambda: nz.normalize2D(npld, simd=True),
                    lambda: nz.normalize2D_novec(npl), TOL["normalize"],
                    (npl,)))]


# --- detect_peaks: the fixed-capacity form keeps the step
# shape-preserving; the oracle (sequential scan) runs one row ---
def section_detect_peaks(rng, rows_, n, cap) -> list:
    from veles.simd_tpu_torch.ops import detect_peaks as dp

    xp_sig = np.cumsum(rng.randn(rows_, n), axis=-1).astype(np.float32)
    xpd = _dev(xp_sig)

    def peaks_step(v):
        _, vals, _ = dp.detect_peaks_fixed(v, dp.ExtremumType.BOTH,
                                           max_peaks=cap)
        return v + 1e-30 * vals[..., :1]

    def first_row():
        pos, vals, count = dp.detect_peaks_fixed(
            xpd[:1], dp.ExtremumType.BOTH, max_peaks=cap)
        c = int(_host(count)[0])
        return np.concatenate([_host(pos)[0, :c].astype(np.float64),
                               _host(vals)[0, :c]])

    def oracle_row():
        pos, vals = dp.detect_peaks_na(xp_sig[0])
        c = min(len(pos), cap)
        return np.concatenate([np.asarray(pos[:c], np.float64),
                               np.asarray(vals[:c], np.float64)])

    # positions exact: any shift is >= 1 of a position, far above the
    # tolerance of the values beside them
    return [benchmark(
        f"detect_peaks {rows_}x{n >> 10}k cap={cap}", peaks_step, xpd,
        lambda: dp.detect_peaks_na(xp_sig[0]), samples=rows_ * n,
        baseline_samples=n, baseline_repeats=1,
        check=Check(first_row, oracle_row, TOL["peaks"], (xp_sig,)))]


def run(sizes: dict, rng=None) -> list:
    """Every section in the JAX tool's order at ``sizes`` (a dict like
    :data:`FULL`); returns the rows."""
    rng = np.random.RandomState(0) if rng is None else rng
    s = sizes
    rows = section_convolve(rng, s["conv_sizes"])
    if s.get("conv_high"):
        rows += section_convolve_high(rng, *s["conv_high"])
    rows += section_convolve_batched(rng, *s["conv_batched"])
    rows += section_gemm(rng, *s["gemm"])
    rows += section_gemm_sweep(rng, s["gemm_sizes"], *s["gemm_batched"])
    rows += section_gemv(rng, s["gemv"])
    rows += section_dwt(rng, *s["dwt"])
    rows += section_dwt_families(rng, *s["dwt"])
    rows += section_cascade(rng, *s["cascade"])
    rows += section_synthesis(rng, *s["dwt"])
    rows += section_conv2d(rng, *s["conv2d"], s["conv2d_small"])
    rows += section_mathfun(rng, s["mathfun"])
    rows += section_stft(rng, s["stft"])
    rows += section_resample(rng, s["signal"])
    rows += section_iir(rng, *s["iir"])
    rows += section_batched(rng, *s["batched"], *s["iir"])
    rows += section_medfilt(rng, *s["medfilt"])
    rows += section_czt(rng, s["signal"], s["czt_bins"])
    rows += section_lombscargle(rng, *s["lombscargle"])
    rows += section_normalize(rng, s["normalize"])
    rows += section_detect_peaks(rng, *s["peaks"])
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    from veles.simd_tpu_torch.utils.platform import select_device

    # the card, or the CPU when VELES_SIMD_PLATFORM=cpu asks for it
    # (rc 2 when no card answers)
    select_device()
    t0 = time.perf_counter()
    try:
        rows = run(QUICK if "--quick" in argv else FULL)
    except SuiteCheckError as e:
        print(f"benchmark_suite: {e}", file=sys.stderr)
        return 1
    timed = sorted((r for r in rows if "wall_s" in r),
                   key=lambda r: -r["wall_s"])
    print(f"benchmark_suite: {len(rows)} rows in "
          f"{time.perf_counter() - t0:.1f} s; slowest: " + ", ".join(
              f"{r['name']} {r['wall_s']:.1f} s" for r in timed[:5]),
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
