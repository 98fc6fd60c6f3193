#!/usr/bin/env python3
"""Overlap-save attribution on the card: where does each route's time go?

The twin of ``tools/profile_overlap_save.py`` over the PyTorch/CUDA
port.  It runs the headline shape (``--n 1048576 --h 2047``) through
each of the port's overlap-save formulations:

* ``cuda_fused`` — the overlap-save kernel (``csrc/overlap_save.cu``,
  ``ops/convolve._conv_os_cuda``; two launches a call: the taps'
  spectrum, then the segments);
* ``xla_matmul`` — the fp32 block matmul over shifted frames
  (``ops/convolve._conv_os_matmul`` at ``overlap_save_step(h)``, under
  ``os_precision()``);
* ``handle`` — the public ``convolve_overlap_save`` call, whichever
  route it picks;
* ``cudnn_conv1d`` — one cuDNN ``conv1d`` in fp32, the library
  yardstick (not a route of the port).

Each answer is first held to a float64 FFT oracle (1e-4 of max|y|; a
route that disagrees makes the run exit 1).  Then, per route: the
chained rate (``utils.benchmark.device_time_chained``: an eager chain
between CUDA events, so a step shorter than its dispatch reads the
host's pace), the device busy ms and the kernels and copies of one
call (CUPTI's records, ``utils/devtrace.py``), the kernel launches the
port's counters saw, the share of the least-work bound that the busy
time reaches (``utils.benchmark.conv_work``: the least of the direct
and FFT forms' operations, bytes read and written once), and the JAX
tool's figure, 2h FLOPs an output sample over the fp32 peak: a
*direct-form equivalent*, no share of a peak (an FFT route reads above
100 %).  The block matmul also gets its formulation ceiling
``h / (h + step)`` (the Toeplitz redundancy).  The decision events of
the handle call say which route the public path took.

``--trace DIR`` writes one traced call a route as ``DIR/<route>.json``:
CUPTI's records (name, device ns) from ``utils/devtrace.py``, not a
``torch.profiler`` trace (which lost kernel records as a process aged
on the H100).

On the CPU (``VELES_SIMD_PLATFORM=cpu``) the kernel route computes its
plain version, busy times are not measured and the rates are the
host's: that checks the plumbing only.  Without a card and without that
request it exits 2.

Run:  python3 tools/profile_overlap_save_torch.py [--n 1048576]
          [--h 2047] [--trace DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))

TOL = 1e-4   # of max|y| against float64 (chip_smoke ORACLE_TOL)


def _oracle(x, h):
    """The full linear convolution in float64 by FFT."""
    m = len(x) + len(h) - 1
    nfft = 1 << (m - 1).bit_length()
    return np.fft.irfft(np.fft.rfft(x.astype(np.float64), nfft)
                        * np.fft.rfft(h.astype(np.float64), nfft),
                        nfft)[:m]


def routes(x, h):
    """``[(name, step or None, fn)]``: the formulations, each ``fn(v)``
    the full convolution of a signal ``v`` shaped like ``x`` with the
    device taps ``h``."""
    import torch.nn.functional as F

    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.runtime import precision as prx

    n, k = x.shape[-1], h.shape[-1]
    prec = cv.os_precision()
    step = cv.overlap_save_step(k)
    handle = cv.convolve_overlap_save_initialize(n, k)
    kernel = h.flip(-1).reshape(1, 1, k)

    def cudnn(v):
        with prx.fp32_conv(v.device):
            return F.conv1d(v.reshape(1, 1, n), kernel,
                            padding=k - 1).reshape(n + k - 1)

    return [("cuda_fused", None, lambda v: cv._conv_os_cuda(v, h)),
            ("xla_matmul", step,
             lambda v: cv._conv_os_matmul(v, h, step, precision=prec)),
            ("handle", None,
             lambda v: cv.convolve_overlap_save(handle, v, h, simd=True)),
            ("cudnn_conv1d", None, cudnn)]


def profile(n=1 << 20, k=2047, trace_dir=None, emit=print, seed=0):
    """Every route at ``n`` x ``k``: checked, then timed; returns one
    dict a route (``name``, ``rel_err``, ``msamples_per_s``,
    ``busy_ms``, ``kernels``, ``launches``, ``least_work_bound_ms``,
    ``pct_of_least_work_bound``, ``roofline``, ``ceiling_pct``) and
    raises ``RuntimeError`` when a route disagrees with the oracle."""
    import torch

    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils import platform

    card = platform.on_cuda()
    rng = np.random.RandomState(seed)
    x_np = rng.randn(n).astype(np.float32)
    h_np = rng.randn(k).astype(np.float32)
    want = _oracle(x_np, h_np)
    scale = float(np.max(np.abs(want)))
    x, h = platform.to_device(x_np), platform.to_device(h_np)
    bound_ms, bound_by = bm.fp32_bound(*bm.conv_work(1, n, k))
    obs.enable()
    obs.reset()
    emit(f"overlap-save attribution: n={n} h={k} precision="
         f"{cv.os_precision()} | device {platform.device_line()} | "
         f"least-work bound {bound_ms:.4f} ms ({bound_by})")
    rows = []
    for name, step, fn in routes(x, h):
        with ck.count_launches() as launches:
            got = platform.to_host(fn(x))
        err = float(np.max(np.abs(got - want)) / scale)
        if not err <= TOL:
            raise RuntimeError(f"overlap-save route {name}: rel err "
                               f"{err:.3e} against float64 > {TOL:g}")
        t0 = time.perf_counter()
        fn(x)
        if card:
            torch.cuda.synchronize()
        step_s = time.perf_counter() - t0

        def chained(v, fn=fn):
            return v + 1e-30 * fn(v)[..., :n]

        t = bm.device_time_chained(
            chained, x, iters=min(256, max(16, int(0.5 / max(step_s,
                                                              1e-6)))))
        busy, kernels = (bm.device_profile(lambda fn=fn: fn(x), calls=10)
                         if card else (None, None))
        if trace_dir and card:
            from veles.simd_tpu_torch.utils import devtrace

            os.makedirs(trace_dir, exist_ok=True)
            records, _ = devtrace.trace(lambda fn=fn: fn(x))
            with open(os.path.join(trace_dir, f"{name}.json"), "w") as f:
                json.dump([{"name": r.name, "ns": r.ns} for r in records],
                          f, indent=1)
        rate = n / t if np.isfinite(t) else float("nan")
        roof = bm.conv_roofline(rate, k, "highest")
        row = {"name": name, "step": step, "rel_err": err,
               "msamples_per_s": rate / 1e6, "chained_ms": t * 1e3,
               "busy_ms": busy, "kernels": kernels, "launches": launches,
               "least_work_bound_ms": bound_ms,
               "pct_of_least_work_bound": (100.0 * bound_ms / busy
                                           if busy else None),
               "roofline": roof,
               "ceiling_pct": (100.0 * k / (k + step) if step else None)}
        rows.append(row)
        emit(_line(row, card))
    # the last event of each distinct decision: the chains repeat them
    decisions = {(e["op"], e.get("decision")): e for e in obs.events()
                 if str(e.get("op", "")).startswith("convolve")}
    emit("obs decisions (the handle's own account):")
    for e in decisions.values():
        emit(f"  {e}")
    return rows


def _line(row, card):
    busy = row["busy_ms"]
    least = row["pct_of_least_work_bound"]
    roof = row["roofline"]
    line = (f"  {row['name']:12s} rel {row['rel_err']:.1e} | "
            f"{row['msamples_per_s']:9.1f} Ms/s chained "
            f"({row['chained_ms']:.4f} ms) | busy "
            + (f"{busy:.4f} ms, {row['kernels']:.0f} kernels and copies "
               f"a call" if busy is not None else "not measured")
            + f" | launches {row['launches'] or 0} | least-work bound: "
            + (f"{least:.1f}%" if least is not None else "not measured")
            + f" | direct-form equivalent {roof['tflops_effective']:.1f} "
            f"TFLOP/s = {roof['pct_of_roofline']:.0f}% of the fp32 peak "
            f"({roof['roofline_bound_tflops']:.0f}), no share of a peak")
    if row["ceiling_pct"] is not None:
        line += (f" | step {row['step']}: formulation ceiling "
                 f"{row['ceiling_pct']:.0f}% (h/(h+step) Toeplitz "
                 "redundancy)")
    if not card:
        line += " | CPU: plumbing only"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n", 1)[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--h", type=int, default=2047)
    ap.add_argument("--trace", default=None,
                    help="directory for one CUPTI record file a route")
    args = ap.parse_args(argv)
    from veles.simd_tpu_torch.utils.platform import select_device

    # the card, or the CPU when VELES_SIMD_PLATFORM=cpu asks for it
    # (rc 2 when no card answers)
    select_device()
    try:
        profile(args.n, args.h, args.trace)
    except RuntimeError as e:
        print(f"profile_overlap_save: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
