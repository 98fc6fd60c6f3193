#!/usr/bin/env python3
"""Count the device-trace windows that lose their kernels as a CUDA
process ages, on one CUDA card: ``torch.profiler``'s, with and without
CUPTI torn down after each session or a forced flush, against
``utils.devtrace``'s.

    python3 tools/time_torch_profiler_sessions.py [--reader profiler|devtrace]
        [--teardown 0|1] [--flush] [--threads cuda|host|pool|none]
        [--seconds 200] [--quick]

The device work is one 2048 x 2048 float32 matrix product a call (one
library kernel, no build).  ``--teardown`` sets ``TEARDOWN_CUPTI`` once
CUDA is up and before the first profiler session, as
``utils.benchmark`` does (1: kineto finalizes CUPTI after every
session; 0: it keeps CUPTI set up across sessions, torch's default).
``--flush`` calls CUPTI's ``cuptiActivityFlushAll`` with the forced
flag in every window, after its last synchronize (on the ``libcupti``
that torch loaded, named on the second line).
``--reader devtrace`` reads every window through
``veles.simd_tpu_torch.utils.devtrace`` (CUPTI's activity records,
nothing matched to the host's clock) in place of ``torch.profiler``;
its ``matched`` column then counts the window's kernels only.
Every census, at a process age of 0, 50, 100, ... seconds up to
``--seconds`` (100 with ``--quick``), prints one line:

- ``matched``: for a window of 10 calls, each launched on an idle card
  and the window padded with 100 ms of host sleep at both ends, how
  many kernel events and how many launch runtime events came back, how
  many kernels came with their launch (same correlation id), and the
  median microseconds from the launch's start to the kernel's;
- ``bare``, ``pad_end`` and ``pad_start``: how many of 6 windows of 5
  calls (a warm-up session, then the measured one, as
  ``utils.benchmark`` profiles) saw no device time, and how many were
  short (under 0.8 of the longest), with no padding, with 30 ms of host
  sleep after the last call's synchronize and with 30 ms before the
  first call.

Between censuses the card runs bursts of products, and 50 small tasks
a burst run on the host as ``--threads`` says: ``cuda``, each on a
short-lived thread that launches a kernel (as a long chip_smoke run's
servers and replicas do); ``host``, the same threads doing host work
only; ``pool``, the CUDA tasks on one pool of 8 long-lived threads;
``none``, no task.  Each census line also gives the threads started so
far and the seconds the census took.  Prints the card's name and power
limit first.  Exits non-zero without a card.
"""

import argparse
import os
import statistics
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WINDOWS, CALLS, PAD, EVERY = 6, 5, 0.03, 50.0
TEARDOWN = "TEARDOWN_CUPTI"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reader", choices=("profiler", "devtrace"),
                    default="profiler")
    ap.add_argument("--teardown", choices=("0", "1"), default="0")
    ap.add_argument("--flush", action="store_true")
    ap.add_argument("--threads", choices=("cuda", "host", "pool", "none"),
                    default="none")
    ap.add_argument("--seconds", type=float, default=200.0)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_torch_profiler_sessions: no CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from veles.simd_tpu_torch.utils import devtrace
    from veles.simd_tpu_torch.utils.platform import smi_line

    print(smi_line(), flush=True)
    born = time.perf_counter()
    a = torch.randn(2048, 2048, device="cuda")
    b = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    os.environ[TEARDOWN] = args.teardown
    act = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cpu, dev = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def call():
        return a @ b

    with profile(activities=[ProfilerActivity.CUDA]):
        call()
        torch.cuda.synchronize()
    cupti = devtrace.library_path()
    print(f"libcupti: {cupti}", flush=True)
    flush_all = None
    if args.flush:
        import ctypes

        flush_all = ctypes.CDLL(cupti).cuptiActivityFlushAll
        flush_all.argtypes = [ctypes.c_uint32]
        flush_all.restype = ctypes.c_int

    def flush():
        if flush_all is not None:
            rc = flush_all(1)
            if rc:
                raise RuntimeError(f"cuptiActivityFlushAll returned {rc}")

    def traced(body):
        records, _ = devtrace.trace(body)
        return [r for r in records if not r.name.startswith("Mem")]

    def matched():
        if args.reader == "devtrace":
            def body():
                time.sleep(0.1)
                for _ in range(10):
                    call()
                    torch.cuda.synchronize()
                time.sleep(0.1)
            return f"kernels {len(traced(body))} of 10"
        with profile(activities=act) as prof:
            torch.cuda.synchronize()
            time.sleep(0.1)
            for _ in range(10):
                call()
                torch.cuda.synchronize()
            time.sleep(0.1)
            flush()
        events = prof.profiler.kineto_results.events()
        launch = {e.correlation_id(): e.start_ns() for e in events
                  if e.device_type() == cpu and e.name().startswith("cu")
                  and "Launch" in e.name()}
        kernels = [e for e in events if e.device_type() == dev]
        lags = [(e.start_ns() - launch[e.correlation_id()]) / 1e3
                for e in kernels if e.correlation_id() in launch]
        return (f"kernels {len(kernels)} launches {len(launch)} "
                f"matched {len(lags)} of 10"
                + (f", median lag {statistics.median(lags):.1f} us"
                   if lags else ""))

    def window(pad_start, pad_end):
        if args.reader == "devtrace":
            traced(call)

            def body():
                if pad_start:
                    time.sleep(pad_start)
                for _ in range(CALLS):
                    call()
                torch.cuda.synchronize()
                if pad_end:
                    time.sleep(pad_end)
            return sum(r.ns for r in traced(body)) / 1e3 / CALLS
        with profile(activities=act):
            call()
            torch.cuda.synchronize()
        with profile(activities=act) as prof:
            if pad_start:
                torch.cuda.synchronize()
                time.sleep(pad_start)
            for _ in range(CALLS):
                call()
            torch.cuda.synchronize()
            if pad_end:
                time.sleep(pad_end)
            flush()
        return sum(e.device_time_total for e in prof.key_averages()
                   if e.device_type == dev) / CALLS

    def census(pad_start, pad_end):
        us = [window(pad_start, pad_end) for _ in range(WINDOWS)]
        empty = sum(1 for u in us if u == 0)
        short = sum(1 for u in us if 0 < u < 0.8 * max(us))
        return f"empty {empty} short {short} max {max(us):.1f} us"

    started = [0]
    pool = ThreadPoolExecutor(8) if args.threads == "pool" else None

    def task():
        if args.threads == "host":
            sum(range(1000))
        else:
            (a[:64] + 1).sum()

    def burst(seconds):
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(200):
                call()
            if pool is not None:
                for f in [pool.submit(task) for _ in range(50)]:
                    f.result()
            elif args.threads != "none":
                workers = [threading.Thread(target=task) for _ in range(50)]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join()
                started[0] += len(workers)
            torch.cuda.synchronize()

    print(f"reader {args.reader}, {TEARDOWN}={args.teardown}, flush "
          f"{args.flush}, threads {args.threads}", flush=True)
    age, last = 0.0, 100.0 if args.quick else args.seconds
    while age <= last:
        burst(max(0.0, born + age - time.perf_counter()))
        t0 = time.perf_counter()
        line = (f"age {t0 - born:.1f} s, {started[0]} threads: "
                f"{matched()} | bare {census(0, 0)} | pad_end "
                f"{census(0, PAD)} | pad_start {census(PAD, 0)}")
        print(f"{line} | {time.perf_counter() - t0:.1f} s", flush=True)
        age += EVERY
    if pool is not None:
        pool.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
