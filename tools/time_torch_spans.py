#!/usr/bin/env python3
"""The program's span capture on the card: what it costs, and whether
its stamps land where CUPTI's records say the work ran.

    python3 tools/time_torch_spans.py [--cells A,B] [--seconds 20]
        [--seed N] [--runs N] [--ab-seconds S]

Prints JSON lines.  ``span_cost``: ``timeit`` of one ``obs.span`` with
telemetry and capture off, with capture armed, and with telemetry on,
in microseconds (best of the repeats), on this host.  Then, per cell,
``--runs`` traced runs of the benchmark (``cellbench``, in this
process, the capture armed by ``cellbench/progspans.py``), each with
the cell's idle device time a call by the harness's host span, the
metrics, and ``clock``: bounds on the error of the harness's map from
host instants onto CUPTI's clock (``host_to_device``).  The card's
first record of a call cannot start before the call did, and the wait
for the card cannot return before its last record ends: the smallest
head bounds how early the map may place a host instant, the smallest
tail how late.  In the cells of the port's own kernels (K1
``os_*_kernel``, K2 ``fb_kernel``) each kernel record is matched in
launch order with the runner span that launched it
(``convolve.os_route`` or ``wavelet_apply.dispatch``): a kernel cannot
start before its runner began, a tighter bound on the same side as the
head.  With ``--ab-seconds``, ``capture_ab``: the cell's entry in one
process under CUPTI, capture off and on in alternate calls, the median
host time of a call in each arm.  Needs an NVIDIA card (exits 2 without one).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import timeit
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
KERNELS = ("os_conv_kernel", "os_taps_kernel", "fb_kernel")
KERNEL_ROUTES = ("cuda_fused", "cuda")


def span_cost(number: int = 100_000, repeat: int = 15) -> dict:
    """Microseconds of one ``with obs.span(...)`` off, captured, on."""
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.obs import spans

    def one():
        with obs.span("convolve.dispatch", algo="overlap_save"):
            pass

    def best():
        return min(timeit.repeat(one, number=number,
                                 repeat=repeat)) / number * 1e6

    out = {"off_us": best()}
    obs.configure(max_spans=number + 1)
    obs.start_capture()
    out["captured_us"] = best()
    obs.stop_capture()
    obs.configure(max_spans=spans.DEFAULT_MAX_SPANS)
    obs.enable(compile_listeners=False)
    out["enabled_us"] = best()
    obs.disable()
    obs.reset()
    return out


def clock_check(readings, calls) -> dict:
    """Bounds, in microseconds, on the map's error in one window.  Every
    cell: the smallest head from a call's mapped start to its first
    device record, and the smallest tail from a call's last device
    record to the mapped return of its wait.  With the port's kernels:
    the gaps from each kernel's runner span (start and end, mapped) to
    the kernel's start, matched in launch order."""
    import numpy as np

    from cellbench import progspans

    busy = readings.busy
    w = readings.window
    a, c = readings.to_device(w.a), readings.to_device(w.c)
    first = np.searchsorted(busy[:, 1], a, side="right")
    last = np.searchsorted(busy[:, 0], c, side="left") - 1
    ok_a, ok_c = first < len(busy), last >= 0
    head = (busy[first[ok_a], 0] - a[ok_a]) / 1e3
    tail = (c[ok_c] - busy[last[ok_c], 1]) / 1e3
    out = {"min_head_us": float(head.min()),
           "p50_head_us": float(np.median(head)),
           "min_sync_tail_us": float(tail.min()),
           "p50_sync_tail_us": float(np.median(tail))}
    lo, hi = readings.device_window()
    kernels = sorted(
        (r.start - readings.origin for r in readings.records
         if r.kind == "kernel" and any(k in r.name for k in KERNELS)
         and lo <= r.start - readings.origin <= hi))
    runners = sorted(
        (s.start_ns, s.end_ns) for c in calls for s in c.spans
        if s.name in progspans.RUNNERS
        and s.attrs.get("route") in KERNEL_ROUTES)
    if not kernels or not runners or len(kernels) % len(runners):
        return out
    per = len(kernels) // len(runners)
    run = np.repeat(readings.to_device(np.array(runners, np.int64)),
                    per, axis=0)
    k = np.array(kernels, np.float64)
    from_start, from_end = (k - run[:, 0]) / 1e3, (k - run[:, 1]) / 1e3
    out.update({"kernels": len(kernels), "per_runner": per,
                "min_gap_from_start_us": float(from_start.min()),
                "p50_gap_from_start_us": float(np.median(from_start)),
                "min_gap_from_end_us": float(from_end.min()),
                "p50_gap_from_end_us": float(np.median(from_end)),
                "negative_from_start": int(np.sum(from_start < 0))})
    return out


def capture_ab(cell, seed: int, seconds: float) -> dict:
    """The capture's cost in one process, call by call: the cell's entry
    in the harness's closed loop (each call waited for, the pool in
    turn) for ``seconds`` under CUPTI as a traced run is, capture off
    and on in alternate calls over one store; the median host time of a
    call (start to return) in each arm, in microseconds."""
    import numpy as np

    from cellbench import devtrace, harness, progspans
    from veles.simd_tpu_torch import obs

    import torch

    params = cell.params
    entry_mod = harness.load_module(cell.path(
        "entries", f"{cell.config['entry']}.py"))
    slots, fixed = harness.make_operands(
        entry_mod.OPERANDS, params, seed, int(cell.traffic["pool"]),
        "cuda")
    entry = entry_mod.Entry(params, fixed)
    for i in range(len(slots) + 2):
        entry(**slots[i % len(slots)])
    torch.cuda.synchronize()
    progspans.arm()
    times = {False: [], True: []}
    clock = time.perf_counter_ns

    def loop():
        deadline = clock() + int(seconds * 1e9)
        i = 0
        while clock() < deadline:
            on = bool(i % 2)
            if on:
                obs.start_capture(counts=progspans.COUNTS)
            else:
                obs.stop_capture()
            a = clock()
            entry(**slots[(i // 2) % len(slots)])
            b = clock()
            torch.cuda.synchronize()
            times[on].append(b - a)
            i += 1

    devtrace.trace(loop)
    obs.stop_capture()
    entry.close()
    off = float(np.median(times[False])) / 1e3
    on = float(np.median(times[True])) / 1e3
    return {"calls_a_side": len(times[True]), "median_off_us": off,
            "median_on_us": on, "on_over_off": on / off,
            "records": len(obs.captured().records)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="conv1d_1m.taps2047,"
                    "dwt_daub8.rows16384")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=2_718_281_828)
    ap.add_argument("--runs", type=int, default=1,
                    help="traced runs a cell, each with its own seed")
    ap.add_argument("--ab-seconds", type=float, default=0.0,
                    help="seconds of alternate capture off/on calls a "
                         "cell (0: none)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_torch_spans: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from cellbench import harness

    harness.set_environment()
    why = harness.load_program()
    if why:
        print(f"time_torch_spans: {why}", file=sys.stderr)
        return 2
    print(json.dumps({"span_cost": span_cost(),
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    from cellbench import progspans

    kept = {}

    class Kept(harness.Readings):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept["r"] = self

    harness.Readings = Kept
    for name in args.cells.split(","):
        cell = harness.load_cell(name)
        for run_i in range(args.runs):
            seed = args.seed + 1000 * run_i
            progspans.arm()
            line = harness.run(cell, seed, args.seconds, True, "cuda",
                               time.perf_counter())
            r = kept.pop("r")
            calls = progspans.calls(r)
            idle = {k: v / r.calls * 1e6
                    for k, v in r.idle_by_span().items()}
            print(json.dumps({
                "cell": name, "seed": seed, "correct": line["correct"],
                "calls": r.calls,
                "calls_grouped": None if calls is None else len(calls),
                "dropped": progspans._OBS.captured().dropped,
                "idle_us_per_call": idle,
                "clock": None if calls is None else clock_check(r, calls),
                "metrics": {k: v["value"]
                            for k, v in line["metrics"].items()},
                "power_limit": line["card"].get("power.limit")}),
                flush=True)
        if args.ab_seconds:
            print(json.dumps({"cell": name, "capture_ab": capture_ab(
                cell, args.seed, args.ab_seconds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
