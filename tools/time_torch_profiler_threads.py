#!/usr/bin/env python3
"""Count the ``torch.profiler`` windows that lose kernels after many
shard-runner threads, on one CUDA card.

    python3 tools/time_torch_profiler_threads.py

For the fused wavelet cascade on 512 x 4096 daub8, 3 levels (one
cascade-bank kernel a call, ``VELES_SIMD_FORCE_FUSED_CASCADE``), it
profiles ``WINDOWS`` windows of ``CALLS`` calls each (a warm-up
session, then the measured one, as ``utils.benchmark`` profiles) and
prints one line a census: how many windows saw no device time, how
many were short (under 0.8 of the longest), and the longest and median
device microseconds a call.  The censuses run in a fresh process, then
after 200 and after 400 more ``sharded_convolve`` calls on an 8-shard
mesh of the card (65,536 x 129), each with and without a 50 ms pause
at the window's start, then with 20 calls a window.  It shows whether
a sharded call's threads degrade the profiler's later windows: with a
thread a shard started per call (the runner before its pool), 4800
threads left 21 of 24 windows short.  Prints the card's name and power
limit first.  Exits non-zero without a card.
"""

import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WINDOWS, CALLS = 24, 5
FUSED = "VELES_SIMD_FORCE_FUSED_CASCADE"


def main():
    import torch

    if not torch.cuda.is_available():
        print("time_torch_profiler_threads: no CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from veles.simd_tpu_torch import parallel as par
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import smi_line

    set_config(device="cuda")
    ck.load_library()
    print(smi_line())
    x = torch.randn(512, 4096, device="cuda")

    def fused():
        os.environ[FUSED] = "1"
        try:
            wv.wavelet_transform("daub", 8, wv.ExtensionType.PERIODIC, x, 3)
        finally:
            del os.environ[FUSED]

    def window(calls, pause):
        act = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=act):
            fused()
            torch.cuda.synchronize()
        with profile(activities=act) as prof:
            if pause:
                torch.cuda.synchronize()
                time.sleep(pause)
            for _ in range(calls):
                fused()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   ) / calls

    def census(label, pause=0.0, calls=CALLS):
        t0 = time.perf_counter()
        us = [window(calls, pause) for _ in range(WINDOWS)]
        empty = sum(1 for u in us if u == 0)
        short = sum(1 for u in us if 0 < u < 0.8 * max(us))
        print(f"{label}: empty {empty} of {WINDOWS}, short {short}, max "
              f"{max(us):.1f} us, median {np.median(us):.1f} us | "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    census("fresh")
    census("fresh, pause 50 ms", 0.05)
    mesh = par.make_mesh({"sp": 8})
    xs = torch.randn(1 << 16, device="cuda")
    h = torch.randn(129, device="cuda")
    for rounds in (200, 400):
        t0 = time.perf_counter()
        for _ in range(rounds):
            par.sharded_convolve(xs, h, mesh)
        torch.cuda.synchronize()
        print(f"{rounds} sharded calls in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        census(f"after {rounds} more sharded calls")
        census(f"after {rounds} more sharded calls, pause 50 ms", 0.05)
    census("calls=20, no pause", calls=20)
    return 0


if __name__ == "__main__":
    sys.exit(main())
