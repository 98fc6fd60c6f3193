#!/usr/bin/env python3
"""Measure the 2D convolution crossover on the card.

The twin of ``tools/tune_conv2d.py`` over the PyTorch/CUDA port: the
re-measurement harness of the ``convolve2d`` routing table
(``ops/convolve2d.py``: the 2D kernel when its gate admits the kernel,
else the batched rFFT2).  For each (rows, image, kernel) cell it runs
the port's 2D candidates:

* ``cuda_direct`` — the 2D kernel (``csrc/filter_2d.cu``,
  ``ops/convolve2d._conv2d_direct_cuda``), within its gate (kernel
  area <= 256 and its tile in shared memory); off the card the wrapper
  computes its plain version;
* ``cudnn`` — the direct form as cuDNN ``conv2d``
  (``_conv2d_direct``), pinned to fp32 by ``runtime/precision.
  fp32_conv`` (cuDNN runs TF32 unless pinned); with ``--precisions``
  also ``cudnn@<p>`` through ``precision.p_conv`` at each other
  precision;
* ``fft`` — the batched ``rfft2 . multiply . irfft2``
  (``_conv2d_fft``).

Each candidate is first held to the float64 oracle
(``convolve2d_na``, 1e-4 of max|y|: a candidate that misses it is
marked ``(ERR)`` and cannot win), then timed as a chain of steps
(``utils.benchmark.device_time_chained``: CUDA events around an eager
chain, so a step shorter than its dispatch reads the host's pace),
with its device busy ms a call on the card (CUPTI's records) and the
kernel launches of its check call.  The winner is the fastest chained
candidate.  It prints a winner table and the kernel-area cut that best
separates direct-form wins from FFT wins.

With ``--cache`` (or ``$VELES_SIMD_AUTOTUNE_CACHE``) each cell whose
winner is an auto route of the table — ``cuda_direct`` (the table's
``direct``) or ``fft`` — is stored in the port's tune cache
(``runtime/routing.TuneCache``) under the ``convolve2d`` family's
geometry key with ``source="sweep"``, from the ``highest`` round only.
A cuDNN win is printed but not stored: cuDNN's direct form is no auto
route of the table.

Without a card and without ``VELES_SIMD_PLATFORM=cpu`` it exits 2; on
the CPU the crossover means nothing (plumbing only).

Run:  python3 tools/tune_conv2d_torch.py [--quick]
          [--cache autotune_pack.json] [--rows 1,8]
          [--precisions highest,bf16_comp]
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))

ERR_GATE = 1e-4  # tools/tpu_smoke_torch.py's convolve2d tolerance

QUICK = {"images": ((128, 128), (512, 512)),
         "kernels": ((3, 3), (15, 15), (33, 33), (65, 65))}
FULL = {"images": ((128, 128), (256, 256), (512, 512), (1024, 1024)),
        "kernels": ((3, 3), (5, 7), (9, 9), (15, 15), (21, 21), (33, 33),
                    (49, 49), (65, 65), (97, 97))}

# a sweep winner -> the convolve2d table's route it stands for
ROUTE_OF = {"cuda_direct": "direct", "fft": "fft"}


def candidates(k0, k1, precisions) -> list:
    """The candidates of one cell: the 2D kernel where its gate admits
    the kernel, cuDNN at each precision, the batched rFFT2."""
    from veles.simd_tpu_torch.ops import cuda_kernels as ck

    kernel = [] if not (k0 * k1 <= ck.MAX_AREA_2D
                        and ck.fits_smem_f2d(k0, k1)) else ["cuda_direct"]
    return kernel + [("cudnn" if p == "highest" else f"cudnn@{p}")
                     for p in precisions] + ["fft"]


def run_candidate(kind, x, h):
    """The full 2D convolution of ``x`` with ``h`` by candidate
    ``kind``."""
    from veles.simd_tpu_torch.ops import convolve2d as cv2
    from veles.simd_tpu_torch.runtime import precision as prx

    if kind == "cuda_direct":
        return cv2._conv2d_direct_cuda(x, h)
    if kind == "fft":
        return cv2._conv2d_fft(x, h)
    _, _, p = kind.partition("@")
    if not p:
        return cv2._conv2d_direct(x, h)
    n0, n1 = x.shape[-2:]
    k0, k1 = h.shape[-2:]
    out = prx.p_conv(x.reshape(-1, 1, n0, n1),
                     h.flip((-2, -1)).reshape(1, 1, k0, k1), p,
                     padding=(k0 - 1, k1 - 1))
    return out.reshape(tuple(x.shape[:-2]) + (n0 + k0 - 1, n1 + k1 - 1))


def time_candidate(kind, x, h, card):
    """``(answer in float64 NumPy, launches, chained s, busy ms or
    None)`` of one candidate; the check call's launches from the
    port's counters."""
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.platform import to_host

    n0, n1 = x.shape[-2:]
    with ck.count_launches() as launches:
        got = to_host(run_candidate(kind, x, h)).astype(np.float64)

    def stp(v):
        return v + 1e-30 * run_candidate(kind, v, h)[..., :n0, :n1]

    t = bm.device_time_chained(stp, x, iters=32, repeats=2)
    busy = (bm.device_busy_ms(lambda: run_candidate(kind, x, h), calls=10)
            if card else None)
    return got, launches, t, busy


def sweep(images, kernels, rows_list, precisions=("highest",),
          cache=None, emit=print, seed=0) -> dict:
    """Every cell of ``rows_list x images x kernels``; returns ``{(rows,
    n0, n1, k0, k1): cell}`` with each candidate's ``err``, ``ok``,
    ``launches``, ``chained_ms``, ``busy_ms``, the ``winner`` (None when
    no candidate held) and the tune-cache ``key`` stored."""
    from veles.simd_tpu_torch.ops import convolve2d as cv2
    from veles.simd_tpu_torch.runtime import routing
    from veles.simd_tpu_torch.utils.platform import on_cuda, to_device

    card = on_cuda()
    rng = np.random.RandomState(seed)
    results = {}
    for rows, (n0, n1) in itertools.product(rows_list, images):
        shape = (rows, n0, n1) if rows > 1 else (n0, n1)
        x_np = rng.randn(*shape).astype(np.float32)
        x = to_device(x_np)
        for k0, k1 in kernels:
            h_np = rng.randn(k0, k1).astype(np.float32)
            h = to_device(h_np)
            want = cv2.convolve2d_na(x_np, h_np)       # float64 inside
            scale = float(np.max(np.abs(want)))
            cell = {"rows": rows, "n0": n0, "n1": n1, "k0": k0, "k1": k1,
                    "cands": {}, "winner": None, "key": None}
            for kind in candidates(k0, k1, precisions):
                got, launches, t, busy = time_candidate(kind, x, h, card)
                err = float(np.max(np.abs(got - want)) / scale)
                cell["cands"][kind] = {
                    "err": err, "launches": launches,
                    "chained_ms": t * 1e3, "busy_ms": busy,
                    "ok": err <= ERR_GATE and bool(np.isfinite(t))}
            held = {k: c for k, c in cell["cands"].items() if c["ok"]}
            if held:
                cell["winner"] = min(held, key=lambda k:
                                     held[k]["chained_ms"])
            cell["heuristic"] = cv2.select_algorithm2d(k0, k1, x.shape)
            results[(rows, n0, n1, k0, k1)] = cell
            if cache is not None and cell["winner"] in ROUTE_OF:
                # the dispatch's tune class (convolve2d._run2d_torch):
                # rows and image dims pow2-bucketed, kernel dims exact
                cell["key"] = cache.store(
                    "convolve2d",
                    {"rows": routing.pow2_bucket(rows),
                     "n0": routing.pow2_bucket(n0),
                     "n1": routing.pow2_bucket(n1), "k0": k0, "k1": k1},
                    ROUTE_OF[cell["winner"]],
                    timings_us={ROUTE_OF[k]: c["chained_ms"] * 1e3
                                for k, c in held.items() if k in ROUTE_OF},
                    source="sweep")
            emit(_cell_line(cell))
    return results


def _cell_line(cell) -> str:
    parts = []
    for kind, c in cell["cands"].items():
        busy = ("" if c["busy_ms"] is None
                else f" busy {c['busy_ms']:.4f}")
        parts.append(f"{kind}={c['chained_ms']:7.3f}ms{busy}"
                     + (f" {c['launches']}" if c["launches"] else "")
                     + ("" if c["ok"] else "(ERR)"))
    head = (f"img {cell['rows']}x{cell['n0']:4d}x{cell['n1']:<4d} ker "
            f"{cell['k0']:3d}x{cell['k1']:<3d} (area "
            f"{cell['k0'] * cell['k1']:5d}): ")
    if cell["winner"] is None:
        return head + "  ".join(parts) + "  -> NO VALID CANDIDATE"
    mark = ("" if ROUTE_OF.get(cell["winner"]) == cell["heuristic"]
            else f"  << heuristic picks {cell['heuristic']}")
    line = head + "  ".join(parts) + f"  -> {cell['winner']}{mark}"
    if cell["key"]:
        line += f"\n    cache entry {cell['key']} = {ROUTE_OF[cell['winner']]}"
    return line


def crossover(results) -> tuple:
    """``(cut, misclassified, cells)``: the kernel area that best
    separates direct-form winners (below) from FFT winners (at or
    above), over the cells with a winner; ``(None, 0, 0)`` when none
    has one."""
    won = {key: c["winner"] for key, c in results.items() if c["winner"]}
    if not won:
        return None, 0, 0
    areas = sorted({k0 * k1 for (_, _, _, k0, k1) in won})
    best_cut, best_miss = None, 1 << 30
    for cut in areas + [areas[-1] + 1]:
        miss = sum(1 for (_, _, _, k0, k1), win in won.items()
                   if (k0 * k1 >= cut) != (win == "fft"))
        if miss < best_miss:
            best_miss, best_cut = miss, cut
    return best_cut, best_miss, len(won)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n", 1)[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument(
        "--cache", default=os.environ.get("VELES_SIMD_AUTOTUNE_CACHE")
        or None, help="tune-cache file to store auto-route winners in "
        "(default: $VELES_SIMD_AUTOTUNE_CACHE; omit to print only)")
    ap.add_argument(
        "--rows", default="1,8", help="comma-separated batch sizes; "
        "dispatch pow2-buckets the batch and the image dims into the "
        "tune class, so sweep the buckets production runs land in")
    ap.add_argument(
        "--precisions", default="highest", help="comma-separated "
        "precisions the cuDNN candidate runs at (runtime/precision.py's "
        "PRECISIONS), each its own accuracy-gated candidate")
    args = ap.parse_args(argv)
    from veles.simd_tpu_torch.runtime import precision as prx
    from veles.simd_tpu_torch.runtime import routing
    from veles.simd_tpu_torch.utils.platform import (
        device_line, select_device)

    precisions = [p.strip() for p in args.precisions.split(",")
                  if p.strip()]
    for p in precisions:
        if p not in prx.PRECISIONS:
            ap.error(f"unknown precision {p!r} (choose from "
                     f"{sorted(prx.PRECISIONS)})")
    # the card, or the CPU when VELES_SIMD_PLATFORM=cpu asks for it
    # (rc 2 when no card answers)
    select_device()
    print(f"device: {device_line()}", flush=True)
    cache = routing.TuneCache(args.cache) if args.cache else None
    sizes = QUICK if args.quick else FULL
    rows_list = [int(r) for r in args.rows.split(",") if r.strip()]
    results = sweep(sizes["images"], sizes["kernels"], rows_list,
                    precisions, cache,
                    emit=lambda line: print(line, flush=True))
    if cache is not None:
        print(f"\ntune cache {args.cache}: {len(cache.entries())} entries")
    cut, miss, cells = crossover(results)
    if cut is None:
        print("\nno valid cells; nothing to recommend")
        return 1
    print(f"\nbest direct-vs-fft area cut = {cut} ({miss} misclassified "
          f"cells of {cells}; routing: the 2D kernel when its gate "
          "admits the kernel, else fft)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
