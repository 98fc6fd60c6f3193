#!/usr/bin/env python3
"""Where the chained step of ``bench_torch.py``'s headline row goes, in
one process on the card.

    python3 tools/time_torch_bench_headline.py [--rounds 3] [--burn 30]
        [--quick]

The headline row times a chain of steps at 1,048,576 x 2047: the
convolve handle call (K1, two launches), then ``v + 1e-30 * y[..., :n]``
to feed the output back (``utils.benchmark.device_time_chained``).
Each round measures, in this order:

* ``step`` — that chain, ms a step (``device_time_chained``);
* ``thread`` — the same chain inside ``bench_torch``'s stage runner (a
  supervised worker thread, as ``bench_torch.py`` runs every config);
* ``call`` — the bare handle call, ms a call over 50 calls queued
  between two CUDA events (``device_time_ms``, as chip_smoke's
  ``times`` phase reads the headline);
* ``feedback`` — the chain's two elementwise ops alone, the same way;
* ``busy`` — the device time of one step (CUPTI's records:
  ``device_busy_ms``);
* ``telemetry off`` — ``step`` again with ``obs`` disabled;

and the host's mean CPU clock (``/proc/cpuinfo``) before it.  Between
rounds the host runs ``--burn`` seconds of the NumPy oracle's FFT
convolution (the host work ``bench_torch.py``'s baselines do).  One
line a round, then a JSON summary, each beside the card's name and
power limit.  Exits 2 without a card.  About 1.5 minutes on one H100
(``--quick``: 2 rounds, 10 s of burn).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, K = 1 << 20, 2047


def cpu_mhz():
    """The mean of ``/proc/cpuinfo``'s ``cpu MHz`` lines, or None."""
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
    except OSError:
        return None
    return sum(mhz) / len(mhz) if mhz else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--burn", type=float, default=30.0,
                    help="seconds of host work between rounds")
    ap.add_argument("--quick", action="store_true",
                    help="2 rounds, 10 s of burn")
    args = ap.parse_args(argv)
    if args.quick:
        args.rounds, args.burn = 2, 10.0
    import torch

    if not torch.cuda.is_available():
        print("time_torch_bench_headline: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import bench_torch as bt
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import smi_line

    set_config(device="cuda")
    smi = smi_line()
    runner = bt._StageRunner(300.0, bt._StageWatchdog(0))
    obs.enable()
    bt._warm_device()
    rng = np.random.RandomState(0)
    x = rng.randn(N).astype(np.float32)
    h = rng.randn(K).astype(np.float32)
    handle = cv.convolve_overlap_save_initialize(N, K)
    xd, hd = bt._dev(x), bt._dev(h)
    y = cv.convolve_overlap_save(handle, xd, hd, simd=True)

    def call():
        return cv.convolve_overlap_save(handle, xd, hd, simd=True)

    def step(v):
        return v + 1e-30 * cv.convolve_overlap_save(
            handle, v, hd, simd=True)[..., :N]

    def chained_ms():
        return bm.device_time_chained(step, xd) * 1e3

    rounds = []
    for r in range(max(1, args.rounds)):
        if r:
            t_end = time.perf_counter() + args.burn
            while time.perf_counter() < t_end:
                cv._conv_overlap_save_na(x, h, handle.block_length)
        got = {"cpu_mhz": cpu_mhz(), "step": chained_ms()}
        ok, ms = runner.run("headline", chained_ms)
        got["thread"] = ms if ok else None
        got["call"] = bm.device_time_ms(call)
        got["feedback"] = bm.device_time_ms(
            lambda: xd + 1e-30 * y[..., :N])
        got["busy"] = bm.device_busy_ms(lambda: step(xd))
        obs.disable()
        got["telemetry off"] = chained_ms()
        obs.enable()
        rounds.append(got)
        print(f"round {r} (host {got['cpu_mhz']} MHz): step "
              f"{got['step']:.4f} ms ({N / got['step'] / 1e3:.1f} "
              f"Msamples/s) | in a stage thread {got['thread']:.4f} | "
              f"bare call {got['call']:.4f} | feedback ops "
              f"{got['feedback']:.4f} | busy a step {got['busy']:.4f} | "
              f"telemetry off {got['telemetry off']:.4f} | card {smi}",
              flush=True)
    print(json.dumps({"ms": rounds, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
