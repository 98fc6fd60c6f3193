#!/usr/bin/env python3
"""Time what the observability layer adds to a call with telemetry off.

    python3 tools/time_torch_obs_off.py

With telemetry off and no journal, two things still run on every main-
path call: ``obs.record_decision`` asks the journal whether it is armed
(a read of ``$VELES_SIMD_JOURNAL_DIR``) before its ``enabled`` check,
and each kernel wrapper of ``ops/cuda_kernels.py`` is an
``obs.instrumented_jit`` call, which checks one flag before it calls the
launch.  This script times that in one process, as
``tools/time_torch_autotune_off.py`` times the autotuner's check: for
the headline ``convolve(handle, x, h)`` at 1,048,576 x 2047, ``stft``
on 2^20 samples at 512/128 and ``convolve2d`` on 16 x 512^2 with 7 x 7
(operands on the card, telemetry off), it runs ``ROUNDS`` rounds, each
timing ``ITERS`` chained calls (CUDA events) with the shipped layer,
with the layer bypassed (``record_decision`` returning on its
``enabled`` check alone, the kernel wrappers replaced by the bare
launches) and with the shipped layer again (an A/A control: what two
identical arms differ by), in an order that rotates each round, and
prints one JSON line per call with each round's differences.  It also
prints the host nanoseconds of one disabled ``record_decision`` and of
one instrumented call of a no-op, shipped and bypassed.  Prints the
card's name and power limit first.  Exits non-zero without a card.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SEED = 20261017
ROUNDS, ITERS = 9, 300
WRAPPERS = ("overlap_save_cuda", "filter_bank_cuda", "cascade_bank_cuda",
            "cascade_bank_periodic_cuda", "filter_2d_cuda", "stft_cuda")


def _host_ns(fn, n=200000):
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e9


def main():
    import torch

    if not torch.cuda.is_available():
        print("time_torch_obs_off: no CUDA card", file=sys.stderr)
        return 2
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.obs import journal
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.ops import convolve2d as cv2
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import smi_line

    print(f"card: {smi_line()}")
    obs.disable()
    if journal.armed():
        print("time_torch_obs_off: the journal is armed", file=sys.stderr)
        return 2
    set_config(device="cuda")
    ck.load_library()
    rng = np.random.RandomState(SEED)

    def cuda(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device="cuda")

    handle = cv.convolve_initialize(1 << 20, 2047)
    xh, th = cuda(1 << 20), cuda(2047)
    xs = cuda(1 << 20)
    x2, h2 = cuda(16, 512, 512), cuda(7, 7)
    calls = (("convolve 1048576x2047", lambda: cv.convolve(handle, xh, th)),
             ("stft 1048576 512/128", lambda: sp.stft(xs, 512, 128)),
             ("convolve2d 16x512x512 k 7x7",
              lambda: cv2.convolve2d(x2, h2)))

    shipped_decision = obs.record_decision
    shipped_wrappers = {n: getattr(ck, n) for n in WRAPPERS}

    def bare_decision(op, decision, **fields):
        # the decision funnel without the journal's armed check
        if not obs.enabled():
            return
        shipped_decision(op, decision, **fields)

    def use(shipped):
        obs.record_decision = shipped_decision if shipped \
            else bare_decision
        for n, w in shipped_wrappers.items():
            setattr(ck, n, w if shipped else w.fn)

    noop = obs.instrumented_jit(lambda: None, op="noop")
    print(json.dumps({
        "record_decision_ns": _host_ns(
            lambda: shipped_decision("noop", "x")),
        "bare_decision_ns": _host_ns(lambda: bare_decision("noop", "x")),
        "instrumented_noop_ns": _host_ns(noop),
        "bare_noop_ns": _host_ns(noop.fn)}))

    for name, fn in calls:
        on, off, again = [], [], []
        arms = ((True, on), (False, off), (True, again))
        for r in range(ROUNDS):
            k = r % len(arms)
            for shipped, out in arms[k:] + arms[:k]:
                use(shipped)
                out.append(bm.device_time_ms(fn, iters=ITERS))
        use(True)
        print(json.dumps({
            "call": name, "ab": "shipped / bypassed / shipped again",
            "shipped_ms": on, "bypassed_ms": off, "again_ms": again,
            "shipped_median_ms": float(np.median(on)),
            "bypassed_median_ms": float(np.median(off)),
            "again_median_ms": float(np.median(again)),
            "diff_us": [(a - b) * 1e3 for a, b in zip(on, off)],
            "aa_diff_us": [(a - b) * 1e3 for a, b in zip(on, again)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
