#!/usr/bin/env python3
"""Benchmark harness of the PyTorch/CUDA port: ``bench.py``'s configs on
the card.

The port's twin of ``bench.py``.  It measures the same configs at
``bench.py``'s own shapes, nothing cut, through ``veles.simd_tpu_torch``
on the card, and prints ONE JSON line for the headline — the 1M-sample
convolution with a 2047-tap filter in Msamples/s (K1, the overlap-save
kernel, two launches a call) — with ``vs_baseline`` its speedup over
the single-threaded NumPy oracle measured in the same process.

Capture-first order, as ``bench.py``: a short chained GEMM warms the
card's clocks, the headline runs FIRST with its own check against the
oracle (rel err <= 1e-3) before any number, and its JSON line is
printed and flushed at once.  Every config is appended to
``BENCH_DETAILS_torch.json`` as it completes (with the decisions,
counters, spans and resource rows of ``obs`` that lie behind its
number), then the remaining configs run, and the per-family
correctness smoke (``tools/tpu_smoke_torch.py``) runs last, one
``TPU-CHECK`` line a family on stderr.

Times: ``utils.benchmark.device_time_chained`` (seconds a step of an
eager chain on the card, CUDA events; each step's host dispatch lies
inside the window, so a step whose kernels are shorter than its
dispatch reads the host's time) and ``device_time`` (host-clock
bursts).  The headline also carries ``device_busy_ms``, its kernels'
device time from CUPTI's records, under its own key.  Roofline rows
keep ``bench.py``'s keys against the H100's peaks; a convolution's
``pct_of_roofline`` counts 2·h FLOPs a sample, the direct form's work
(a "direct-form equivalent", above 100 % for an FFT route), and each
conv row also carries the share of its least-work bound
(``utils.benchmark.conv_work``, at most 100 %).

Stage supervision, as ``bench.py``: every stage (warm-up, headline,
each config, each smoke family) runs in a supervised worker thread
under ``$VELES_SIMD_STAGE_TIMEOUT`` (default 300 s; 0 runs stages
inline).  A stage that stalls past its budget or raises a transient
device fault (``runtime.faults.is_transient``) is retried
``$VELES_SIMD_STAGE_RETRIES`` times (default 1), then skipped and
recorded in the details file's tail entry (``skipped_stages``,
``stage_faults``); a watchdog hard-exits at 3x the budget if the skip
layer itself stalls.  rc 0 once the headline line is out, 2 when no
headline was measured (and when no card answers:
``utils.platform.select_device``; ``VELES_SIMD_PLATFORM=cpu`` runs on
the CPU, where the kernel wrappers compute their plain versions).

Usage:  python3 bench_torch.py           # one JSON line on stdout (first)
        python3 bench_torch.py --all     # a table of every config
        python3 bench_torch.py --check   # the correctness smoke only
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from veles.simd_tpu_torch import obs  # noqa: E402
from veles.simd_tpu_torch.runtime import faults, routing  # noqa: E402
from veles.simd_tpu_torch.utils.benchmark import (  # noqa: E402
    ROOFLINE_DISAGREEMENT_WARN_PCT, analytical_roofline, conv_roofline,
    conv_work, device_busy_ms, device_time, device_time_chained,
    fp32_bound, host_time, rms_normalize, roofline_disagreement_pct,
    stft_roofline)
from veles.simd_tpu_torch.utils.platform import on_cuda  # noqa: E402

DETAILS = "BENCH_DETAILS_torch.json"

# headline vs_baseline (the card's Msamples/s over the NumPy oracle's
# on the same host) below this is flagged in the artifact
# (headline_regressed, a BENCH-WARN line).  From this script's headline
# on an NVIDIA H100 80GB HBM3 at 700.00 W (nvidia-smi's power.limit):
# 176.1 to 230.4 over two full runs and two chip_smoke bench phases
# (PERF.md §6).  The chained step is the host's and read 4,401 to
# 11,833 Msamples/s between processes, so the floor is about 0.4x the
# lowest reading, not near the typical one.
HEADLINE_VS_BASELINE_FLOOR = 75.0

# the headline's inline check against the oracle (bench.py's bound)
HEADLINE_TOL = 1e-3

# the kernel route a route name's resource row is recorded under
# (obs.resources(): op "cuda", the kernel wrapper's name)
_KERNEL_ROW = {"cuda_fused": "stft"}


def _dev(a):
    """``a`` as a float32 tensor on the configured device."""
    from veles.simd_tpu_torch.utils.platform import to_device

    return to_device(np.asarray(a, np.float32))


def _launches(fn) -> dict:
    """The kernel launches of one call of ``fn`` (the wrappers'
    counters, reset before it): which of the port's kernels it ran."""
    from veles.simd_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launches()
    fn()
    return {k: v for k, v in ck.LAUNCHES.items() if v}


def _resource_flops(route: str):
    """FLOPs the resource axis recorded for the kernel behind
    ``route`` (its least work, ``utils.benchmark``), or None."""
    rows = [e for e in obs.resources()
            if e["op"] == "cuda" and e["route"] == route
            and e.get("flops")]
    return max(e["flops"] for e in rows) if rows else None


def _telemetry_entry():
    """Per-config telemetry for the details file: the route decisions,
    the autotuner's traffic, counters, spans, resource rows, caches
    and kernel-build counts behind the config's number."""
    from veles.simd_tpu_torch.obs.export import (flatten_counters,
                                                 span_summary)

    snap = obs.snapshot()
    decisions = [{k: v for k, v in e.items() if v is not None}
                 for e in snap["events"]]
    return {
        "decisions": decisions[-16:],
        "autotune": {
            "mode": routing.autotune_mode(),
            "decisions": [e for e in decisions
                          if e.get("op") == "autotune"],
            "cache": snap.get("caches", {}).get("autotune_cache", {}),
        },
        "counters": flatten_counters(snap),
        "spans": span_summary(snap),
        "resources": snap.get("resources", []),
        "caches": snap.get("caches", {}),
        "compiles": obs.counter_value("compile.backend_compile"),
        "cache_hits": obs.counter_value("compile.cache_hits"),
        "cache_misses": obs.counter_value("compile.cache_misses"),
        "events_dropped": snap["events_dropped"],
        "spans_dropped": snap["spans_dropped"],
    }


def bench_elementwise(rng):
    """Config 1: int16 -> float, mul, add and back on 4096 signals of
    4096 (one chained step converts both ways)."""
    from veles.simd_tpu_torch.ops import arithmetic as ar
    from veles.simd_tpu_torch.utils.platform import to_device

    n = 4096
    batch = 4096
    a_np = rng.randn(batch, n).astype(np.float32)
    b_np = rng.randn(batch, n).astype(np.float32)
    i16 = rng.randint(-3000, 3000, (batch, n)).astype(np.int16)
    b = _dev(b_np)
    i16t = to_device(i16)

    def step(v):
        # the int16 carry: values stay in the +-3000 range the
        # saturating cast keeps
        f = ar._to_float(v)
        return ar._float_to_int16((f * 1e-4 + b) * 300.0)

    t = device_time_chained(step, i16t)
    elems = batch * n
    t_base = host_time(
        lambda: (a_np + b_np) * i16.astype(np.float32))
    return {"metric": "elementwise add*mul*convert", "unit": "Melem/s",
            "value": elems / t / 1e6, "baseline": elems / t_base / 1e6}


def bench_mathfun(rng):
    """Config 2: sin/cos/log/exp on 1M floats (``ops/mathfun``)."""
    import torch

    from veles.simd_tpu_torch.ops import mathfun as mf

    n = 1 << 20
    x_np = np.abs(rng.randn(n).astype(np.float32)) + 0.1
    x = _dev(x_np)

    def step(v):  # 4 transcendentals; output stays in [0.1, ~4.7]
        return torch.abs(mf.sin_psv(v, simd=True) + mf.cos_psv(v, simd=True)
                         + mf.log_psv(v, simd=True)
                         + mf.exp_psv(-v, simd=True)) + 0.1

    t = device_time_chained(step, x)
    t_base = host_time(
        lambda: np.sin(x_np) + np.cos(x_np) + np.log(x_np) + np.exp(-x_np))
    return {"metric": "sin+cos+log+exp 1M floats", "unit": "Msamples/s",
            "value": 4 * n / t / 1e6, "baseline": 4 * n / t_base / 1e6}


def bench_sgemm(rng):
    """Config 3: sgemm 512 x 512 in GFLOP/s (the fp32 route)."""
    from veles.simd_tpu_torch.ops import matrix as mx

    n = 512
    a_np = rng.randn(n, n).astype(np.float32)
    b_np = rng.randn(n, n).astype(np.float32)
    a, b = _dev(a_np), _dev(b_np)

    def step(v):  # rms-normalized so the chained GEMMs stay bounded
        return rms_normalize(mx._matmul_p(v, b))

    t = device_time_chained(step, a)
    flops = 2 * n ** 3
    t_base = host_time(lambda: mx.matrix_multiply_novec(a_np, b_np))
    return {"metric": "sgemm 512", "unit": "GFLOP/s",
            "value": flops / t / 1e9, "baseline": flops / t_base / 1e9}


def _conv_least_work(roof: dict, rows: int, n: int, k: int,
                     t: float) -> dict:
    """``roof`` with the least-work bound beside the direct-form
    figure: the share of :func:`conv_work`'s bound that ``t`` seconds
    a call reach (at most 100 %)."""
    bound_ms, bound_by = fp32_bound(*conv_work(rows, n, k))
    roof.update(flops_basis="direct-form equivalent (2*h a sample)",
                least_work_bound_ms=bound_ms,
                least_work_bound_by=bound_by,
                pct_of_least_work_bound=100.0 * bound_ms / (t * 1e3))
    return roof


def bench_convolve_1m(rng):
    """Config 4 (headline): 1,048,576 x 2047 overlap-save against the
    NumPy FFT oracle, after one device output is checked against that
    oracle (rel err <= 1e-3).  On the card the handle's route is K1,
    two launches a call."""
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.utils.platform import to_host

    n, k = 1 << 20, 2047
    x = rng.randn(n).astype(np.float32)
    h = rng.randn(k).astype(np.float32)
    handle = cv.convolve_overlap_save_initialize(n, k)
    xd, hd = _dev(x), _dev(h)   # on the device: time the card, not copies

    want = cv._conv_overlap_save_na(x, h, handle.block_length)
    got = to_host(cv.convolve_overlap_save(handle, xd, hd, simd=True))
    rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    if rel > HEADLINE_TOL:
        raise RuntimeError(
            f"headline conv device-vs-oracle rel err {rel:.2e} > "
            f"{HEADLINE_TOL:.0e}")
    print(f"TPU-CHECK convolve-headline: ok (rel err {rel:.1e})",
          file=sys.stderr)

    def call():
        return cv.convolve_overlap_save(handle, xd, hd, simd=True)

    def step(v):  # 1e-30 * y forces the conv without perturbing v
        y = cv.convolve_overlap_save(handle, v, hd, simd=True)
        return v + 1e-30 * y[..., :n]

    t = device_time_chained(step, xd)
    t_base = host_time(lambda: cv._conv_overlap_save_na(
        x, h, handle.block_length), repeats=2)
    out = {"metric": "convolve 1M x 2047 overlap-save",
           "unit": "Msamples/s",
           "value": n / t / 1e6, "baseline": n / t_base / 1e6,
           "oracle_rel_err": rel, "launches": _launches(call)}
    if on_cuda():
        out["device_busy_ms"] = device_busy_ms(call)
    if np.isfinite(t):
        roof = _conv_least_work(
            conv_roofline(n / t, k, cv.os_precision()), 1, n, k, t)
        print(f"CONV-ROOFLINE 1Mx2047: {roof['tflops_effective']:.1f} "
              f"TFLOP/s direct-form equivalent = "
              f"{roof['pct_of_roofline']:.0f}% of the fp32 peak "
              f"({roof['roofline_bound_tflops']:.1f} TFLOP/s); "
              f"{roof['pct_of_least_work_bound']:.1f}% of the "
              f"least-work bound ({roof['least_work_bound_ms']:.4f} ms, "
              f"{roof['least_work_bound_by']})", file=sys.stderr)
        # the count the resource axis recorded for K1 (its least work)
        # beside the direct-form constant: they differ by the FFT's
        # saving, so a disagreement is the route's, not drift
        flops = _resource_flops("overlap_save")
        if flops:
            ana = analytical_roofline(flops, t, roof["precision"])
            dis = roofline_disagreement_pct(
                roof["pct_of_roofline"],
                ana["analytical_pct_of_roofline"])
            roof.update(ana, analytical_route="overlap_save",
                        disagreement_pct=dis)
            print(f"CONV-ROOFLINE analytical (overlap_save, least-work "
                  f"flops={flops:.3g}): "
                  f"{ana['analytical_pct_of_roofline']:.1f}% of the "
                  f"peak vs direct-form {roof['pct_of_roofline']:.0f}% "
                  f"(disagreement {dis:.0f}%)", file=sys.stderr)
            if dis > ROOFLINE_DISAGREEMENT_WARN_PCT:
                print(f"CONV-ROOFLINE NOTE: the direct-form and the "
                      f"least-work counts differ by {dis:.0f}% "
                      f"(> {ROOFLINE_DISAGREEMENT_WARN_PCT:.0f}%): the "
                      "FFT route's saving over 2*h a sample",
                      file=sys.stderr)
        out["roofline"] = roof
    return out


def bench_autotuned_headline(rng):
    """Config 10: the headline geometry under the measured autotuner
    (``on``, a private in-memory tune cache): one eager dispatch
    probes the ``convolve.os`` candidates and keeps the winner, then
    the chain times dispatch through the cached decision.
    ``vs_baseline`` is tuned over static (mode ``off``) on the same
    shape."""
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.utils.platform import to_host

    n, k = 1 << 20, 2047
    x = rng.randn(n).astype(np.float32)
    h = rng.randn(k).astype(np.float32)
    handle = cv.convolve_overlap_save_initialize(n, k)
    xd, hd = _dev(x), _dev(h)

    def step(v):
        y = cv.convolve_overlap_save(handle, v, hd, simd=True)
        return v + 1e-30 * y[..., :n]

    # thread-local overrides: an abandoned stage must not re-route the
    # rest of the process, and the operator's pack is neither read nor
    # written
    with routing.autotune_mode_override("off"):
        t_static = device_time_chained(step, xd)
    with routing.private_tune_cache() as stage_cache, \
            routing.autotune_mode_override("on"):
        to_host(cv.convolve_overlap_save(handle, xd, hd, simd=True))
        t_tuned = device_time_chained(step, xd)
        stage_cache_info = stage_cache.info()
    tuned_entry = None
    for e in obs.events():
        if e["op"] == "autotune" and e.get("family") == "convolve.os":
            tuned_entry = {kk: vv for kk, vv in e.items()
                           if kk in ("decision", "static", "timings")}
    out = {"metric": "convolve 1M x 2047 autotuned",
           "unit": "Msamples/s",
           "value": n / t_tuned / 1e6,
           "baseline": n / t_static / 1e6,
           "autotune_stage": {"mode": "on",
                              "cache": stage_cache_info}}
    if tuned_entry:
        out["autotune_winner"] = tuned_entry
    if np.isfinite(t_tuned) and np.isfinite(t_static):
        ratio = t_static / t_tuned
        print(f"AUTOTUNE-HEADLINE: tuned {n / t_tuned / 1e6:.0f} Ms/s "
              f"vs static {n / t_static / 1e6:.0f} Ms/s "
              f"({ratio:.2f}x)", file=sys.stderr)
        if ratio < 0.95:
            print("AUTOTUNE-WARN: the autotuned choice measured "
                  ">5% slower than the static choice on the headline "
                  "geometry — probe noise or a stale winner; rerun "
                  f"and inspect the autotune decisions in {DETAILS}",
                  file=sys.stderr)
    return out


def _precision_err_gate(got, want, precision, label):
    """Accuracy gate before a precision row is timed: the route must
    stay inside its ``runtime/precision.ERROR_BUDGETS`` entry."""
    from veles.simd_tpu_torch.runtime import precision as prx
    from veles.simd_tpu_torch.utils.platform import to_host

    rel = float(np.max(np.abs(to_host(got) - want))
                / max(1e-30, np.max(np.abs(want))))
    budget = prx.ERROR_BUDGETS[precision]
    if rel > budget:
        raise RuntimeError(
            f"{label} {precision} rel err {rel:.2e} > budget "
            f"{budget:.0e}")
    print(f"TPU-CHECK {label} [{precision}]: ok (rel err {rel:.1e})",
          file=sys.stderr)


def bench_precision_gemm(rng):
    """Config 14: gemm 2048 at ``bf16_comp`` against the fp32 route;
    ``vs_baseline`` is the comp-over-fp32 speedup, each side's roofline
    against its own precision's peak."""
    from veles.simd_tpu_torch.ops import matrix as mx
    from veles.simd_tpu_torch.utils.benchmark import gemm_roofline

    n = 2048
    a_np = rng.randn(n, n).astype(np.float32)
    b_np = rng.randn(n, n).astype(np.float32)
    a, b = _dev(a_np), _dev(b_np)
    want = np.asarray(a_np, np.float64) @ np.asarray(b_np, np.float64)
    _precision_err_gate(mx._matmul_p(a, b, precision="bf16_comp"),
                        want, "bf16_comp", "gemm-2048")

    def make_step(precision):
        def step(v):
            return rms_normalize(mx._matmul_p(v, b,
                                              precision=precision))
        return step

    t_fp32 = device_time_chained(make_step("highest"), a)
    t_comp = device_time_chained(make_step("bf16_comp"), a)
    flops = 2 * n ** 3
    out = {"metric": "gemm 2048 bf16_comp", "unit": "GFLOP/s",
           "value": flops / t_comp / 1e9,
           "baseline": flops / t_fp32 / 1e9}
    if np.isfinite(t_comp) and np.isfinite(t_fp32):
        roofs = {"bf16_comp": gemm_roofline(flops, t_comp,
                                            "bf16_comp"),
                 "highest": gemm_roofline(flops, t_fp32, "highest")}
        out["roofline_precisions"] = roofs
        print(f"GEMM-PRECISION 2048: bf16_comp "
              f"{flops / t_comp / 1e9:.0f} GFLOP/s "
              f"({roofs['bf16_comp']['pct_of_roofline']:.0f}% of its "
              f"peak) vs fp32 {flops / t_fp32 / 1e9:.0f} "
              f"({roofs['highest']['pct_of_roofline']:.0f}% of its "
              f"peak) — {t_fp32 / t_comp:.2f}x", file=sys.stderr)
    return out


def bench_precision_convolve(rng):
    """Config 15: the headline geometry (1M x 2047) on the block-matmul
    overlap-save at ``bf16_comp`` against ``highest``."""
    from veles.simd_tpu_torch.ops import convolve as cv

    n, k = 1 << 20, 2047
    x_np = rng.randn(n).astype(np.float32)
    h_np = rng.randn(k).astype(np.float32)
    x, h = _dev(x_np), _dev(h_np)
    step_len = cv.overlap_save_step(k)
    want = np.convolve(np.asarray(x_np[: 1 << 16], np.float64),
                       np.asarray(h_np, np.float64))
    got = cv._conv_os_matmul(_dev(x_np[: 1 << 16]), h, step_len,
                             precision="bf16_comp")
    _precision_err_gate(got, want, "bf16_comp", "convolve-os")

    def make_step(precision):
        def step(v):
            y = cv._conv_os_matmul(v, h, step_len,
                                   precision=precision)
            return v + 1e-30 * y[..., :n]
        return step

    t_hi = device_time_chained(make_step("highest"), x)
    t_comp = device_time_chained(make_step("bf16_comp"), x)
    out = {"metric": "convolve 1M x 2047 bf16_comp",
           "unit": "Msamples/s",
           "value": n / t_comp / 1e6, "baseline": n / t_hi / 1e6}
    if np.isfinite(t_comp) and np.isfinite(t_hi):
        out["roofline_precisions"] = {
            "bf16_comp": _conv_least_work(
                conv_roofline(n / t_comp, k, "bf16_comp"), 1, n, k,
                t_comp),
            "highest": _conv_least_work(
                conv_roofline(n / t_hi, k, "highest"), 1, n, k, t_hi)}
        print(f"CONV-PRECISION 1Mx2047: bf16_comp "
              f"{n / t_comp / 1e6:.0f} Ms/s vs highest "
              f"{n / t_hi / 1e6:.0f} Ms/s ({t_hi / t_comp:.2f}x)",
              file=sys.stderr)
    return out


def bench_precision_stft(rng):
    """Config 16: STFT 16k x 512/128 (batch 64) on
    ``rdft_matmul_bf16_comp`` against ``rdft_matmul``."""
    import torch

    from veles.simd_tpu_torch.ops import spectral as sp

    batch, n, fl, hop = 64, 1 << 14, 512, 128
    x_np = rng.randn(batch, n).astype(np.float32)
    xd = _dev(x_np)
    want = sp.stft_na(x_np[:2], fl, hop)
    got = sp.stft(xd[:2], fl, hop, simd=True,
                  route="rdft_matmul_bf16_comp")
    _precision_err_gate(got, want, "bf16_comp", "stft-rdft")

    def make_step(route):
        def step(v):
            s = sp.stft(v, fl, hop, simd=True, route=route)
            return v + 1e-30 * torch.abs(s).mean()
        return step

    t_hi = device_time_chained(make_step("rdft_matmul"), xd)
    t_comp = device_time_chained(make_step("rdft_matmul_bf16_comp"),
                                 xd)
    samples = batch * n
    frames = sp.frame_count(n, fl, hop)
    out = {"metric": "stft 16k x 512 bf16_comp",
           "unit": "Msamples/s",
           "value": samples / t_comp / 1e6,
           "baseline": samples / t_hi / 1e6}
    if np.isfinite(t_comp) and np.isfinite(t_hi):
        out["roofline_precisions"] = {
            "bf16_comp": stft_roofline(batch * frames / t_comp, fl,
                                       precision="bf16_comp"),
            "highest": stft_roofline(batch * frames / t_hi, fl,
                                     precision="highest")}
        print(f"STFT-PRECISION 16kx512/128: bf16_comp "
              f"{samples / t_comp / 1e6:.0f} Ms/s vs highest "
              f"{samples / t_hi / 1e6:.0f} Ms/s "
              f"({t_hi / t_comp:.2f}x)", file=sys.stderr)
    return out


def bench_cold_start(rng):
    """Config 17: process birth to first served request of a fresh
    serving process, warm pack (``VELES_SIMD_ARTIFACTS=readonly``, the
    kernel library placed at ``Server.start``) against cold (nvcc
    builds it), through ``tools/cold_start_torch.py``, which also
    writes ``COLD_START_DETAILS_torch.json``.  ``vs_baseline`` is the
    cold/warm speedup; the gate is warm <= 50 % of cold."""
    del rng                        # subprocess children seed themselves
    import tempfile

    from tools import cold_start_torch as cs

    with tempfile.TemporaryDirectory(prefix="veles-warmpack-") as tmp:
        ns = argparse.Namespace(pack=os.path.join(tmp, "pack"),
                                reuse_pack=False, timeout=600.0,
                                rounds=1)
        rows, evidence = cs.run(ns)
    with open(cs.DEFAULT_DETAILS, "w") as f:
        json.dump(rows + [{"cold_start_evidence": evidence}], f,
                  indent=2)
    failed = cs.gate(rows, evidence, cs.MIN_SPEEDUP)
    out = {"metric": "cold start warm vs cold",
           "unit": "x", "value": evidence["speedup"], "baseline": 1.0,
           "artifact_evidence": rows[0]["telemetry"],
           "gate": failed or "pass"}
    print(f"COLD-START: cold {evidence['cold']['wall_s']:.2f}s -> "
          f"warm {evidence['warm']['wall_s']:.2f}s "
          f"(x{evidence['speedup']:.2f}, warm = "
          f"{100 * evidence['warm_fraction_of_cold']:.0f}% of cold)",
          file=sys.stderr)
    for reason in failed:
        print(f"COLD-START-WARN: {reason}", file=sys.stderr)
    return out


def bench_dwt(rng):
    """Config 5: DWT daub8 on 512 x 4096 signals (K2, two channels at
    stride 2, on the card)."""
    import torch

    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.ops.wavelet_coeffs import WaveletType

    batch, n = 512, 4096
    x = rng.randn(batch, n).astype(np.float32)
    xd = _dev(x)

    def call(v=xd):
        return wv.wavelet_apply(WaveletType.DAUBECHIES, 8,
                                wv.ExtensionType.PERIODIC, v, simd=True)

    def step(v):  # [B, n] -> hi, lo each [B, n/2] -> back to [B, n]
        return torch.cat(call(v), dim=-1)

    t = device_time_chained(step, xd)
    t_base = host_time(lambda: wv.wavelet_apply_na(
        WaveletType.DAUBECHIES, 8, wv.ExtensionType.PERIODIC, x),
        repeats=2)
    samples = batch * n
    return {"metric": "DWT daub8 512x4096", "unit": "Msamples/s",
            "value": samples / t / 1e6, "baseline": samples / t_base / 1e6,
            "launches": _launches(call)}


def _stft_roofs(routes_times, frames_per_call, fl):
    """``stft_roofline`` per timed route, with the resource axis's
    count for a kernel route beside it."""
    roofs = {}
    for route, t in routes_times:
        if not np.isfinite(t):
            continue
        roof = stft_roofline(frames_per_call / t, fl, route=route)
        flops = (_resource_flops(_KERNEL_ROW[route])
                 if route in _KERNEL_ROW else None)
        if flops:
            ana = analytical_roofline(flops, t, roof["precision"])
            dis = roofline_disagreement_pct(
                roof["pct_of_roofline"],
                ana["analytical_pct_of_roofline"])
            roof.update(ana, disagreement_pct=dis)
            print(f"STFT-ROOFLINE {route}: measured "
                  f"{roof['pct_of_roofline']:.1f}% vs analytical "
                  f"{ana['analytical_pct_of_roofline']:.1f}% of the "
                  f"peak (disagreement {dis:.0f}%)", file=sys.stderr)
        roofs[route] = roof
    return roofs


def bench_stft(rng):
    """Config 6: STFT 16k x 512/64, batch 64 — the table's route raced
    against the forced ``xla_fft`` (cuFFT) route on the same shape;
    then the acceptance geometry, 1M samples at 512/128, where the
    table picks K4 on the card.  Each route is checked against the
    oracle first; the row names the routes that ran."""
    import torch

    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.utils.platform import to_host

    batch, n, fl, hop = 64, 1 << 14, 512, 64
    x = rng.randn(batch, n).astype(np.float32)
    xd = _dev(x)
    frames = sp.frame_count(n, fl, hop)
    sel = sp._STFT_FAMILY.select(frame_length=fl, hop=hop, frames=frames,
                                 cuda=xd.is_cuda)

    want = sp.stft_na(x[:2], fl, hop)
    for route in (sel, "xla_fft"):
        got = to_host(sp.stft(xd, fl, hop, simd=True, route=route))
        rel = np.max(np.abs(got[:2] - want)) / np.max(np.abs(want))
        if rel > 1e-3:
            raise RuntimeError(f"stft route {route} device-vs-oracle "
                               f"rel err {rel:.2e} > 1e-3")
    print(f"TPU-CHECK stft-routes ({sel}, xla_fft): ok",
          file=sys.stderr)

    def make_step(route, fl=fl, hop=hop):
        def step(v):
            s = sp.stft(v, fl, hop, simd=True, route=route)
            # scalar feedback forces the transform without perturbing v
            return v + 1e-30 * torch.abs(s).mean()
        return step

    t_sel = device_time_chained(make_step(sel), xd)
    t_fft = device_time_chained(make_step("xla_fft"), xd)
    t_base = host_time(lambda: sp.stft_na(x, fl, hop), repeats=2)
    samples = batch * n
    out = {"metric": "stft 16k x 512/64 b64", "unit": "Msamples/s",
           "value": samples / t_sel / 1e6,
           "baseline": samples / t_base / 1e6,
           "stft_route": sel}
    if np.isfinite(t_fft):
        out["xla_fft_msamples_per_s"] = samples / t_fft / 1e6
    if np.isfinite(t_sel) and np.isfinite(t_fft):
        out["speedup_vs_xla_fft"] = t_fft / t_sel
        print(f"STFT-ROUTE {sel}: {samples / t_sel / 1e6:.0f} Ms/s vs "
              f"xla_fft {samples / t_fft / 1e6:.0f} Ms/s "
              f"({t_fft / t_sel:.1f}x)", file=sys.stderr)
    out["roofline_routes"] = _stft_roofs(
        ((sel, t_sel), ("xla_fft", t_fft)), batch * frames, fl)

    # the acceptance geometry: 1M samples at 512/128
    n1m, hop1m = 1 << 20, 128
    x1m_np = rng.randn(n1m).astype(np.float32)
    x1m = _dev(x1m_np)
    frames1m = sp.frame_count(n1m, fl, hop1m)
    sel1m = sp._STFT_FAMILY.select(frame_length=fl, hop=hop1m,
                                   frames=frames1m, cuda=x1m.is_cuda)
    want1m = sp.stft_na(x1m_np, fl, hop1m)
    got1m = to_host(sp.stft(x1m, fl, hop1m, simd=True, route=sel1m))
    rel1m = float(np.max(np.abs(got1m - want1m)) / np.max(np.abs(want1m)))
    if rel1m > 1e-3:
        raise RuntimeError(f"stft 1M route {sel1m} device-vs-oracle "
                           f"rel err {rel1m:.2e} > 1e-3")
    t1_sel = device_time_chained(make_step(sel1m, hop=hop1m), x1m)
    t1_fft = device_time_chained(make_step("xla_fft", hop=hop1m), x1m)
    block = {"route": sel1m, "oracle_rel_err": rel1m,
             "launches": _launches(lambda: sp.stft(x1m, fl, hop1m,
                                                   simd=True))}
    if np.isfinite(t1_sel):
        block["msamples_per_s"] = n1m / t1_sel / 1e6
        block["roofline"] = _stft_roofs(((sel1m, t1_sel),), frames1m,
                                        fl)[sel1m]
    if np.isfinite(t1_fft):
        block["xla_fft_msamples_per_s"] = n1m / t1_fft / 1e6
    if np.isfinite(t1_sel) and np.isfinite(t1_fft):
        block["speedup_vs_xla_fft"] = t1_fft / t1_sel
        print(f"STFT-ROUTE 1Mx512/128 {sel1m}: "
              f"{n1m / t1_sel / 1e6:.0f} Ms/s vs xla_fft "
              f"{n1m / t1_fft / 1e6:.0f} Ms/s "
              f"({t1_fft / t1_sel:.1f}x)", file=sys.stderr)
    out["stft_1m_512_128"] = block
    return out


def bench_istft_roundtrip(rng):
    """Config 7: istft(stft(x)) round trip, 16k x 512/128, batch 64,
    the interior within 1e-3 of x before it is timed."""
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.utils.platform import to_host

    batch, n, fl, hop = 64, 1 << 14, 512, 128
    x = rng.randn(batch, n).astype(np.float32)
    xd = _dev(x)

    rec = to_host(sp.istft(sp.stft(xd, fl, hop, simd=True), n, fl,
                           hop, simd=True))
    err = np.max(np.abs(rec[:, fl:-fl] - x[:, fl:-fl]))
    if err > 1e-3:
        raise RuntimeError(f"istft round-trip err {err:.2e} > 1e-3")

    def step(v):
        # reconstruction == v but for the edges' decay: the chain stays
        # bounded
        return sp.istft(sp.stft(v, fl, hop, simd=True), n, fl, hop,
                        simd=True)

    t = device_time_chained(step, xd)
    spec_np = sp.stft_na(x, fl, hop)
    t_base = (host_time(lambda: sp.stft_na(x, fl, hop), repeats=2)
              + host_time(lambda: sp.istft_na(spec_np, n, fl, hop),
                          repeats=2))
    samples = batch * n
    return {"metric": "istft round-trip 16k x 512/128 b64",
            "unit": "Msamples/s", "value": samples / t / 1e6,
            "baseline": samples / t_base / 1e6, "round_trip_err": err}


def bench_spectrogram(rng):
    """Config 8: power spectrogram |STFT|^2 at the stft shape."""
    from veles.simd_tpu_torch.ops import spectral as sp

    batch, n, fl, hop = 64, 1 << 14, 512, 128
    x = rng.randn(batch, n).astype(np.float32)
    xd = _dev(x)

    def step(v):
        p = sp.spectrogram(v, fl, hop, simd=True)
        return v + 1e-30 * p.mean()

    t = device_time_chained(step, xd)
    t_base = host_time(lambda: sp.spectrogram_na(x, fl, hop),
                       repeats=2)
    samples = batch * n
    return {"metric": "spectrogram 16k x 512/128 b64",
            "unit": "Msamples/s", "value": samples / t / 1e6,
            "baseline": samples / t_base / 1e6}


def bench_batched_stft(rng):
    """Config 9: ``batched_stft`` (one dispatch, K4 on the card) against
    the same work as per-signal ``stft`` dispatches; ``vs_baseline`` is
    the batched-over-single ratio."""
    import torch

    from veles.simd_tpu_torch.ops import batched as bt
    from veles.simd_tpu_torch.ops import spectral as sp

    batch, n, fl, hop = 256, 4096, 512, 128
    x = rng.randn(batch, n).astype(np.float32)
    xd = _dev(x)

    def batched_call():
        return torch.abs(bt.batched_stft(xd, fl, hop)).mean()

    t_b = device_time(batched_call)

    rows = [xd[i] for i in range(batch)]

    def single_loop():
        acc = None
        for r in rows:
            acc = torch.abs(sp.stft(r, fl, hop, simd=True)).mean()
        return float(acc)            # sync: the loop really finished

    single_loop()                    # warm the single-signal path
    t_s = host_time(single_loop)
    samples = batch * n
    # the table's route: K4 needs 64 frames a row (4096 samples give 29)
    return {"metric": "batched stft 256x4096 512/128",
            "unit": "Msamples/s", "value": samples / t_b / 1e6,
            "baseline": samples / t_s / 1e6,
            "stft_route": sp._STFT_FAMILY.select(
                frame_length=fl, hop=hop,
                frames=sp.frame_count(n, fl, hop), cuda=xd.is_cuda),
            "launches": _launches(batched_call)}


def bench_serve(rng):
    """Config 11: the serving layer's coalescing — loadgen traffic
    (flat-out arrivals, mixed tenants and shapes; the K4 class among
    them) through a Server against the same requests one by one
    through the single-signal ops.  ``vs_baseline`` is served over
    sequential."""
    from tools import loadgen_torch as loadgen
    from veles.simd_tpu_torch import serve
    from veles.simd_tpu_torch.utils.platform import to_host

    schedule = loadgen.build_schedule(rng, 160, rate_hz=0.0,
                                      burst_every=0, burst_size=0)
    # a warm pass outside the measured window proves the accounting
    with serve.Server(max_batch=8, max_wait_ms=2.0, workers=2) as srv:
        warm = loadgen.run_load(srv, schedule, result_timeout=600.0)
        if warm["lost"] or warm["double_answered"]:
            raise RuntimeError(f"serve accounting failed: {warm}")
        t0 = time.perf_counter()
        report = loadgen.run_load(srv, schedule, result_timeout=600.0,
                                  verify=16, rng=np.random.RandomState(0))
        t_serve = time.perf_counter() - t0
    if report["lost"] or report["double_answered"] \
            or report["parity_failures"]:
        raise RuntimeError(f"serve run failed its accounting: {report}")
    done = report["ok"] + report["degraded"]

    from veles.simd_tpu_torch.ops import iir, resample as rs
    from veles.simd_tpu_torch.ops import spectral as sp

    def one(req):
        p = req.params
        if req.op == "sosfilt":
            return iir.sosfilt(p["sos"], req.x[None, :], simd=True)
        if req.op == "lfilter":
            return iir.lfilter(p["b"], p["a"], req.x[None, :],
                               simd=True)
        if req.op == "resample_poly":
            return rs.resample_poly(req.x, p["up"], p["down"],
                                    simd=True)
        return sp.stft(req.x, p["frame_length"], p["hop"], simd=True)

    for _, req in schedule:
        one(req)                       # warm the per-request paths
    t0 = time.perf_counter()
    for _, req in schedule:
        to_host(one(req))              # to the host per request, as served
    t_single = time.perf_counter() - t0
    return {"metric": "serve loadgen 160req mixed",
            "unit": "req/s", "value": done / t_serve,
            "baseline": len(schedule) / t_single}


def _bench_sensor_chain(block: int = 2048):
    """The sensor-conditioning chain the pipeline configs time: despike
    -> block detrend -> IIR notch -> STFT -> power."""
    from veles.simd_tpu_torch import pipeline as pl
    from veles.simd_tpu_torch.ops import iir

    notch = iir.butterworth(4, (44 / 1000.0, 56 / 1000.0), "bandstop")
    chain = pl.Pipeline(
        [pl.medfilt(5), pl.detrend("linear"), pl.sosfilt(notch),
         pl.stft(256, 64), pl.power()],
        name="sensor_bench")
    return chain.compile(block)


def _pipeline_block_times(cp, blocks, fused: bool) -> list:
    """Wall seconds a block through the compiled pipeline (each block
    brought to the host, like a served answer); state threads
    through."""
    from veles.simd_tpu_torch.utils.platform import to_host

    state = cp.init_state()
    times = []
    for b in blocks:
        t0 = time.perf_counter()
        out, state = cp.process(b, state, fused=fused)
        to_host(out)
        times.append(time.perf_counter() - t0)
    return times


# configs 12 and 13 report two views (throughput, tail latency) of ONE
# measurement: memoized so the second neither pays the warm-up, parity
# and timing again nor reports from another sample (a config abandoned
# mid-measure leaves the memo unset)
_PIPELINE_MEASURE_MEMO: dict = {}


def _pipeline_measure(rng, n_blocks: int = 24, block: int = 2048):
    """The shared fused-vs-unfused measurement: ``(cp, blocks,
    fused_times, unfused_times)``, both paths warmed (on the card the
    fused step's CUDA graph is captured there) and the stream checked
    against the stage-by-stage oracle."""
    from veles.simd_tpu_torch.utils.platform import to_host

    memo_key = (n_blocks, block)
    cached = _PIPELINE_MEASURE_MEMO.get(memo_key)
    if cached is not None:
        return cached
    cp = _bench_sensor_chain(block)
    x = rng.randn(n_blocks * block).astype(np.float32)
    blocks = [x[i:i + block] for i in range(0, len(x), block)]
    for fused in (True, False):
        state = cp.init_state()
        for b in blocks[:2]:
            out, state = cp.process(b, state, fused=fused)
        to_host(out)
    got, _ = cp.stream(x)
    want = cp.oracle(x)
    scale = float(np.max(np.abs(want))) or 1.0
    err = float(np.max(np.abs(to_host(got) - want)) / scale)
    # a sanity bound (the sharp notch costs float32 digits against the
    # float64 oracle); the tight streaming parity lives in the tests
    if err > 1e-3:
        raise RuntimeError(
            f"pipeline parity failed before timing: rel err {err}")
    fused_times = _pipeline_block_times(cp, blocks, fused=True)
    unfused_times = _pipeline_block_times(cp, blocks, fused=False)
    result = (cp, blocks, fused_times, unfused_times)
    _PIPELINE_MEASURE_MEMO[memo_key] = result
    return result


def bench_pipeline(rng):
    """Config 12: the fused sensor chain (one CUDA-graph replay a block
    on the card) against the same stages dispatched one by one, in
    blocks/s; ``vs_baseline`` is the fusion speedup."""
    cp, blocks, fused_times, unfused_times = _pipeline_measure(rng)
    return {"metric": f"pipeline sensor chain {cp.block_len}-blocks",
            "unit": "blocks/s",
            "value": len(blocks) / sum(fused_times),
            "baseline": len(blocks) / sum(unfused_times)}


def bench_pipeline_p99(rng):
    """Config 13: a block's tail latency, fused against stage by stage,
    as inverse p99 seconds (higher is better)."""
    _, _, fused_times, unfused_times = _pipeline_measure(rng)

    def inv_p99(ts):
        ts = np.sort(np.asarray(ts))
        return 1.0 / float(ts[int(0.99 * (len(ts) - 1))])

    return {"metric": "pipeline sensor chain p99 inverse latency",
            "unit": "1/s",
            "value": inv_p99(fused_times),
            "baseline": inv_p99(unfused_times)}


def _warm_device(seconds: float = 1.0):
    """Ramp the card's clocks with a sustained chained GEMM before the
    first timed config (a process's first sustained work runs slow
    while power and clocks ramp)."""
    from veles.simd_tpu_torch.utils.benchmark import _sync

    a = _dev(np.random.RandomState(1).randn(1024, 1024))
    v = a
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        for _ in range(64):
            v = rms_normalize(v @ a)
        _sync(v)


class _StageWatchdog:
    """Last-resort hard exit when the skip layer itself stops making
    progress (a call blocked in native code on the main thread, between
    stages).  Such a call cannot be interrupted from Python; every
    result so far is already flushed, so exiting is safe.  Its
    threshold is a multiple of the stage budget: per-stage stalls are
    handled one level up by :class:`_StageRunner`."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._stage = "(startup)"
        self._t0 = time.monotonic()
        self._stopped = False
        self.headline_out = False
        if timeout_s > 0:  # 0 disables
            threading.Thread(target=self._watch, daemon=True).start()

    def stage(self, name: str) -> None:
        with self._lock:
            self._stage = name
            self._t0 = time.monotonic()

    def stop(self) -> None:
        """Disarm on completion (an in-process caller, such as the test
        suite, must not be hard-exited by a leftover daemon)."""
        with self._lock:
            self._stopped = True

    def _watch(self) -> None:
        while True:
            time.sleep(5.0)
            with self._lock:
                if self._stopped:
                    return
                stalled = time.monotonic() - self._t0
                stage = self._stage
            if stalled > self.timeout_s:
                print(f"bench_torch.py: stage {stage!r} stalled for "
                      f"{stalled:.0f}s (> {self.timeout_s:.0f}s) past "
                      "the per-stage skip layer; exiting with the "
                      "results captured so far", file=sys.stderr)
                sys.stderr.flush()
                sys.stdout.flush()
                os._exit(0 if self.headline_out else 2)


class _StageRunner:
    """Run each stage in a supervised worker thread; retry it on
    transient device faults, then skip it (and keep going) when it
    stays stalled or broken.

    A stalled call cannot be cancelled, so its worker is abandoned (a
    daemon thread, dying with the process).  The fault policy is the
    dispatch layer's (``runtime/faults.py``): a stage that stalls or
    raises a transient fault (device loss or timeout,
    ``faults.is_transient``) is retried up to
    ``$VELES_SIMD_STAGE_RETRIES`` times (default 1, with the engine's
    jittered backoff), then skipped.  Every fault is recorded in
    ``self.faults`` (the details file's tail) and counted
    (``fault_stage_retry``, ``fault_stage_exhausted``).  Other errors
    are not retried: a deterministic bug gets no second budget.

    A stage that was merely SLOW may resume after being skipped and
    run beside later stages, its device work and events bleeding into
    theirs; stage-private RandomStates keep the data draws apart.
    Size ``VELES_SIMD_STAGE_TIMEOUT`` above the slowest honest stage.
    ``timeout_s <= 0`` runs stages inline on the main thread."""

    _WEDGED = object()

    def __init__(self, timeout_s: float, watchdog: _StageWatchdog,
                 retries: int | None = None):
        self.timeout_s = timeout_s
        self._watchdog = watchdog
        self.skipped = []          # [{"stage": ..., "reason": ...}]
        self.faults = []           # transient-fault records (tail)
        if retries is None:
            try:
                retries = int(os.environ.get(
                    "VELES_SIMD_STAGE_RETRIES", "1"))
            except ValueError:
                retries = 1
        self.retries = max(0, retries)

    def run(self, name: str, fn):
        """Execute ``fn()`` under the stage budget and fault policy.
        Returns ``(ok, result)``; ``ok`` is False when the stage stalled
        past its retries (skip recorded) or raised (error recorded)."""
        for attempt in range(self.retries + 1):
            self._watchdog.stage(name)   # a fresh clock an attempt
            outcome, payload = self._attempt(name, fn)
            if outcome == "ok":
                return True, payload
            transient = (outcome == "wedged"
                         or faults.is_transient(payload))
            if transient:
                kind = ("wedged" if outcome == "wedged" else
                        "timeout" if faults.is_timeout(payload)
                        else "device_lost")
                self.faults.append({
                    "stage": name, "attempt": attempt, "kind": kind,
                    "detail": (f"> {self.timeout_s:.0f}s"
                               if outcome == "wedged"
                               else repr(payload)[:300])})
                if attempt < self.retries:
                    obs.count("fault_stage_retry", stage=name)
                    print(f"bench_torch.py: stage {name!r} hit a "
                          f"transient fault ({kind}); retry "
                          f"{attempt + 1}/{self.retries}",
                          file=sys.stderr)
                    time.sleep(faults.backoff_delay(attempt))
                    continue
                obs.count("fault_stage_exhausted", stage=name)
            if outcome == "wedged":
                print(f"bench_torch.py: stage {name!r} stalled past "
                      f"{self.timeout_s:.0f}s; skipping it and "
                      "continuing with the remaining stages",
                      file=sys.stderr)
                self.skipped.append(
                    {"stage": name,
                     "reason": f"wedged (> {self.timeout_s:.0f}s)"})
                return False, self._WEDGED
            return self._failed(name, payload)

    def _attempt(self, name: str, fn):
        """One supervised execution: ('ok', result) / ('error', exc) /
        ('wedged', None)."""
        if self.timeout_s <= 0:
            try:
                return "ok", fn()
            except Exception as e:  # noqa: BLE001 — record, keep going
                return "error", e
        box = {}

        def work():
            try:
                box["result"] = fn()
            except Exception as e:  # noqa: BLE001
                box["error"] = e

        t = threading.Thread(target=work, daemon=True,
                             name=f"bench-stage-{name}")
        t.start()
        t.join(self.timeout_s)
        if t.is_alive():
            return "wedged", None
        if "error" in box:
            return "error", box["error"]
        return "ok", box.get("result")

    def _failed(self, name, e):
        print(f"bench_torch.py: stage {name!r} failed ({e!r}); "
              "continuing", file=sys.stderr)
        self.skipped.append({"stage": name, "reason": f"error: {e!r}"})
        return False, e


CONFIGS = ("bench_elementwise", "bench_mathfun", "bench_sgemm",
           "bench_dwt", "bench_stft", "bench_istft_roundtrip",
           "bench_spectrogram", "bench_batched_stft",
           "bench_serve", "bench_pipeline", "bench_pipeline_p99",
           "bench_autotuned_headline", "bench_precision_gemm",
           "bench_precision_convolve", "bench_precision_stft",
           "bench_cold_start")


def main():
    from veles.simd_tpu_torch.utils.platform import (probe_history,
                                                     select_device,
                                                     smi_line)

    # the card unless VELES_SIMD_PLATFORM=cpu; rc 2 when no card
    # answers within $VELES_SIMD_DEVICE_WAIT (default 600 s)
    select_device(wait=600.0)

    from tools.tpu_smoke_torch import FAMILIES, device_name, run_smoke

    stage_timeout = float(os.environ.get("VELES_SIMD_STAGE_TIMEOUT",
                                         "300"))
    dog = _StageWatchdog(3 * stage_timeout)
    runner = _StageRunner(stage_timeout, dog)

    try:
        if "--check" in sys.argv:
            # the smoke only, each family under its own budget.  rc: 0
            # all pass, 1 a numerical failure, 2 a family stalled
            all_ok = True
            for fam, _ in FAMILIES:
                ok, res = runner.run(
                    f"smoke:{fam}",
                    lambda fam=fam: run_smoke(families=[fam]))
                all_ok &= ok and bool(res)
            if runner.skipped:
                print(f"bench_torch.py: smoke incomplete — skipped "
                      f"{[s['stage'] for s in runner.skipped]}",
                      file=sys.stderr)
                sys.exit(2)
            sys.exit(0 if all_ok else 1)

        device = device_name()
        card = smi_line() if on_cuda() else "not measured (CPU run)"
        print(f"bench_torch.py: device {device} | card {card}",
              file=sys.stderr)
        # telemetry on for the whole run: every details entry carries
        # the decisions and counters behind its number
        obs.enable()
        obs.reset()
        rng = np.random.RandomState(0)
        results = []

        def write_details():
            # the tail entry records skipped and failed stages, the
            # transient faults the retry policy absorbed and failed
            # device probes: a partial or degraded run says so in the
            # artifact itself
            tail_info = {}
            if runner.skipped:
                tail_info["skipped_stages"] = runner.skipped
            if runner.faults:
                tail_info["stage_faults"] = runner.faults
            probes = probe_history()
            if any(not p["ok"] for p in probes):
                tail_info["device_probes"] = probes
            tail = [tail_info] if tail_info else []
            with open(DETAILS, "w") as f:
                json.dump(results + tail, f, indent=2, allow_nan=False,
                          default=str)

        def flush(r):
            r["vs_baseline"] = r["value"] / r["baseline"]
            r["device"] = device
            r["card"] = card
            # per-config telemetry (reset right after, so each entry's
            # decisions and builds are its config's alone)
            r["telemetry"] = _telemetry_entry()
            obs.reset()
            # an unresolved chained time is NaN, which strict JSON
            # lacks: flag it and null the numbers
            if not all(np.isfinite(r[k]) for k in ("value", "baseline",
                                                   "vs_baseline")):
                r["flagged"] = "unresolved measurement (timer returned NaN)"
                r = {k: (None if isinstance(v, float) and not np.isfinite(v)
                         else v) for k, v in r.items()}
            results.append(r)
            write_details()
            if "--all" in sys.argv:
                def fmt(v, spec):
                    return format(v, spec) if v is not None else "  (flagged)"
                print(f"{r['metric']:36s} {fmt(r['value'], '12.1f')} "
                      f"{r['unit']:11s} "
                      f"(cpu-oracle {fmt(r['baseline'], '10.1f')}, "
                      f"x{fmt(r['vs_baseline'], '.1f')})", file=sys.stderr)
            return r

        # the headline first: warm the clocks, measure, print the line
        runner.run("warmup", _warm_device)
        obs.reset()  # the warm-up's events are not the headline's
        ok, res = runner.run("headline:convolve_1m",
                             lambda: bench_convolve_1m(rng))
        if ok:
            head = flush(res)
            print(json.dumps({
                "metric": head["metric"],
                "value": (None if head["value"] is None
                          else round(head["value"], 2)),
                "unit": head["unit"],
                "vs_baseline": (None if head["vs_baseline"] is None
                                else round(head["vs_baseline"], 2)),
            }, allow_nan=False), flush=True)
            dog.headline_out = True  # a stall from here on exits 0
            if (head.get("vs_baseline") is not None
                    and head["vs_baseline"] < HEADLINE_VS_BASELINE_FLOOR):
                head["headline_regressed"] = True
                write_details()
                print(f"BENCH-WARN: headline vs_baseline "
                      f"{head['vs_baseline']:.2f} < "
                      f"{HEADLINE_VS_BASELINE_FLOOR:.0f} — the 1M-conv "
                      "headline regressed against the oracle multiple "
                      f"(recorded as headline_regressed in {DETAILS})",
                      file=sys.stderr)
        else:
            # no headline: nulls in the parseable slot, never a number,
            # and the remaining stages still run (rc 2 at the end)
            write_details()
            print(json.dumps({
                "metric": "convolve 1M x 2047 overlap-save", "value": None,
                "unit": "Msamples/s", "vs_baseline": None,
                "skipped": runner.skipped[-1]["reason"]
                if runner.skipped else "stage failed"}), flush=True)

        # after the headline a failed or stalled config costs itself
        # only; the timed configs run before the smoke
        module = sys.modules[__name__]
        for i, name in enumerate(CONFIGS):
            fn = getattr(module, name)
            obs.reset()      # a failed config's events are not the next's
            cfg_rng = np.random.RandomState(i + 1)  # stage-private
            cfg_ok, cfg_res = runner.run(f"config:{fn.__name__}",
                                         lambda fn=fn, r=cfg_rng: fn(r))
            if cfg_ok:
                flush(cfg_res)
            else:
                write_details()
        # the smoke last, a family a stage
        smoke_ok = True
        for fam, _ in FAMILIES:
            fam_ok, fam_res = runner.run(
                f"smoke:{fam}", lambda fam=fam: run_smoke(families=[fam]))
            smoke_ok &= fam_ok and bool(fam_res)
            if not fam_ok:
                write_details()
        if not smoke_ok:
            print(f"bench_torch.py: correctness smoke incomplete or "
                  f"FAILED on {device!r}; timing numbers are suspect",
                  file=sys.stderr)
        if not dog.headline_out:
            sys.exit(2)  # a partial run: no headline was measured
    finally:
        dog.stop()


if __name__ == "__main__":
    main()
