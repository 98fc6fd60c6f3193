#!/usr/bin/env python3
"""Sweep the PyTorch port's overlap-save candidates on a CUDA card.

    python3 tools/tune_overlap_save_torch.py [--quick] [--n 1048576]
        [--cache autotune_pack_torch.json]
        [--precisions highest,high,bf16_comp]

The CUDA counterpart of the JAX package's ``tools/tune_overlap_save.py``.
For each filter length it times, with chained CUDA events
(``utils.benchmark.device_time_ms``), on one signal of ``--n`` samples:

* the block matmul (``convolve._conv_os_matmul``) at each output-block
  step of 256 to 2048 and each swept precision — the data behind
  ``overlap_save_step``;
* the engine's ``convolve.os`` candidates: ``cuda_fused`` (the
  overlap-save kernel, where its gate admits the length),
  ``xla_matmul`` at the engine's step and ``xla_matmul_bf16_comp``.

Every timing is gated on accuracy against a float64 oracle: a block
matmul at the smaller of 1e-4 and its precision's ``ERROR_BUDGETS``
entry, a kernel or ``conv1d`` at 1e-4 of max|y| (the route contract
``chip_smoke.py`` holds them to); a candidate that fails its gate
never wins.  With ``--cache`` (default
``$VELES_SIMD_AUTOTUNE_CACHE``) the gated winner of each filter length
and base precision is stored with ``source="sweep"`` under the
engine's tune key (``rows=1``, the pow2-bucketed length, the taps, the
step and the precision), in the same pack ``autotune_pack_torch.py``
writes.

Then it times ``convolve.direct`` (the filter-bank kernel where its
gate admits the shape, and fp32 ``conv1d``) against the overlap-save
kernel and the block matmul at the short-row shapes where the kernel
lost to a direct form on the card: 3 x 5000 x 256, 70,000 x 8 x 256
and 1 x 2^20 x 300.  It changes no constant; prints the card's name
and power limit and one JSON line per measurement; exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
ERR_GATE = 1e-4
STEPS = (256, 512, 1024, 2048)
SHORT_ROWS = ((3, 5000, 256), (70000, 8, 256), (1, 1 << 20, 300))


def conv64(x, h):
    """float64 full convolution of every row of x with h."""
    n, k = x.shape[-1], h.shape[-1]
    m = 1 << (n + k - 2).bit_length()
    spec = (np.fft.rfft(x.astype(np.float64), m, axis=-1)
            * np.fft.rfft(h.astype(np.float64), m))
    return np.fft.irfft(spec, m, axis=-1)[..., : n + k - 1]


def main() -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="filter lengths 127 and 2047 only")
    parser.add_argument("--n", type=int, default=1 << 20,
                        help="signal length (default 2^20)")
    parser.add_argument(
        "--cache", default=os.environ.get("VELES_SIMD_AUTOTUNE_CACHE")
        or None, help="tune-cache file to store the route winners in "
                      "(default: $VELES_SIMD_AUTOTUNE_CACHE; omit to "
                      "print the tables only)")
    parser.add_argument(
        "--precisions", default="highest,high,bf16_comp",
        help="comma-separated precision axis (highest/high/default and "
             "the precision layer's bf16_comp/bf16/int8)")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    from veles.simd_tpu_torch.runtime import precision as prx

    precisions = tuple(p.strip() for p in args.precisions.split(",")
                       if p.strip())
    for p in precisions:
        if p not in prx.PRECISIONS:
            parser.error(f"unknown precision {p!r} (choose from "
                         f"{sorted(prx.PRECISIONS)})")
    import torch

    if not torch.cuda.is_available():
        print("tune_overlap_save_torch: no CUDA card; the sweep times "
              "the card", file=sys.stderr)
        return 2
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.runtime import routing
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import smi_line

    set_config(device="cuda")
    cache = routing.TuneCache(args.cache) if args.cache else None
    n = args.n
    rng = np.random.RandomState(SEED)
    x_np = rng.randn(n).astype(np.float32)
    x = torch.as_tensor(x_np, device="cuda")
    print(f"card: {smi_line()} | signal {n}", flush=True)

    def gate(p):
        return min(ERR_GATE, prx.ERROR_BUDGETS.get(p, ERR_GATE))

    def measure(fn, want, tol):
        """(ms or None when the output fails the gate, rel err)."""
        got = fn().double().cpu().numpy()
        err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        if err > tol:
            return None, err
        return bm.device_time_ms(fn, iters=20), err

    def show(**row):
        print(json.dumps(row), flush=True)

    ks = (127, 2047) if args.quick else (127, 511, 2047, 8191)
    for k in ks:
        h_np = rng.randn(k).astype(np.float32)
        h = torch.as_tensor(h_np, device="cuda")
        want = conv64(x_np, h_np)
        # the step table of the block matmul
        for prec in precisions:
            best = None
            for step in STEPS:
                ms, err = measure(
                    lambda s=step, p=prec: cv._conv_os_matmul(
                        x, h, s, precision=p), want, gate(prec))
                show(sweep="step", k=k, precision=prec, step=step, ms=ms,
                     msamples_s=n / ms / 1e3 if ms else None, rel=err)
                if ms is not None and (best is None or ms < best[0]):
                    best = (ms, step)
            show(sweep="step_best", k=k, precision=prec,
                 step=best and best[1],
                 overlap_save_step=cv.overlap_save_step(k))
        # the engine's candidates, one tune entry per base precision
        step = cv.overlap_save_step(k)
        for base in [p for p in precisions
                     if p in prx.JAX_PRECISIONS] or ["highest"]:
            runs = {"xla_matmul": (lambda b=base: cv._conv_os_matmul(
                x, h, step, precision=b), gate(base))}
            if "bf16_comp" in precisions:
                runs["xla_matmul_bf16_comp"] = (
                    lambda: cv._conv_os_matmul(x, h, step,
                                               precision="bf16_comp"),
                    gate("bf16_comp"))
            if "cuda_fused" in cv._OS_FAMILY.eligible(h_length=k,
                                                      cuda=x.is_cuda):
                runs["cuda_fused"] = (lambda: cv._conv_os_cuda(x, h),
                                      ERR_GATE)
            timings_us = {}
            for route, (fn, tol) in runs.items():
                ms, err = measure(fn, want, tol)
                timings_us[route] = ms * 1e3 if ms is not None else None
                show(sweep="route", k=k, precision=base, route=route,
                     step=None if route == "cuda_fused" else step, ms=ms,
                     rel=err)
            measured = {r: t for r, t in timings_us.items()
                        if t is not None}
            if not measured:
                continue
            winner = min(measured, key=measured.get)
            key = None
            if cache is not None:
                key = cache.store(
                    "convolve.os",
                    {"rows": 1, "x_length": routing.pow2_bucket(n),
                     "h_length": k, "step": step, "precision": base},
                    winner, timings_us=timings_us, source="sweep")
            show(sweep="route_winner", k=k, precision=base,
                 winner=winner, timings_us=timings_us, key=key)
    # convolve.direct against the overlap-save kernel on short rows
    for rows, n_s, k in SHORT_ROWS:
        xs_np = rng.randn(rows, n_s).astype(np.float32)
        hs_np = rng.randn(k).astype(np.float32)
        xs = torch.as_tensor(xs_np, device="cuda")
        hs = torch.as_tensor(hs_np, device="cuda")
        want = conv64(xs_np, hs_np)
        runs = {"overlap_save kernel": lambda: ck.overlap_save_cuda(xs, hs),
                "conv1d": lambda: cv._conv_direct(xs, hs),
                "xla_matmul": lambda: cv._conv_os_matmul(
                    xs, hs, cv.overlap_save_step(k)),
                "xla_matmul_bf16_comp": lambda: cv._conv_os_matmul(
                    xs, hs, cv.overlap_save_step(k),
                    precision="bf16_comp")}
        if "direct_cuda" in cv._DIRECT_FAMILY.eligible(
                rows=rows, n=n_s, k=k, cuda=xs.is_cuda):
            runs["filter_bank kernel"] = lambda: cv._conv_direct_cuda(
                xs, hs)
        for name, fn in runs.items():
            tol = {"xla_matmul": gate("highest"),
                   "xla_matmul_bf16_comp": gate("bf16_comp")}.get(
                       name, ERR_GATE)
            ms, err = measure(fn, want, tol)
            show(sweep="short_rows", rows=rows, n=n_s, k=k, candidate=name,
                 ms=ms, rel=err)
    if cache is not None:
        print(f"tune cache {args.cache}: {len(cache.entries())} entries, "
              f"device {cache.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
