#!/usr/bin/env python3
"""Time the PyTorch port's guarded entry points on one CUDA card.

    python3 tools/time_torch_guard.py [--repo DIR] [--label NAME]

Imports ``veles.simd_tpu_torch`` from the checkout at DIR (default: the
one holding this script), so a checkout with the fault policy and one
without it (its parent, unpacked with ``git archive`` into a directory
that ``.gitignore`` lists) can be timed on one card in one call, in
turns (parent, change, change, parent).  For the three entry points
whose dispatch the fault policy wraps — the headline ``convolve(handle,
x, h)`` at 1,048,576 x 2047, ``stft`` on 2^20 samples at 512/128 and
``convolve2d`` on 16 x 512^2 with 7 x 7, operands on the card,
telemetry off, no fault plan — it prints one JSON line each: the
chained CUDA-event time per call in each of ``ROUNDS`` rounds of
``ITERS`` calls and their median, the device busy time per call from
``torch.profiler`` and the kernels it saw.  The difference of the
medians between two checkouts is what the change adds to a call's host
dispatch; the busy time and the kernels must not differ.  For a
checkout with the fault policy it also prints, per entry, an
in-process A/B line: ``ROUNDS`` rounds, each timing ``ITERS`` chained
calls with the policy on and with it bypassed (the guards, the
demotion wrappers and the route gates' rejection and plan lookups
replaced by the bare call and the parent's gate), in alternating
order, with each round's difference; one process sees none of the
spread between processes.  Prints the card's name and power limit
first.  Exits non-zero without a card.
"""

import argparse
import json
import os
import sys

import numpy as np

SEED = 20261016
ROUNDS, ITERS = 7, 300


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=here,
                    help="checkout whose veles.simd_tpu_torch is timed")
    ap.add_argument("--label", default=None,
                    help="name printed with each line (default: --repo)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_torch_guard: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.repo))
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.ops import convolve2d as cv2
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import smi_line

    label = args.label or args.repo
    print(f"card: {smi_line()} | checkout {label} ({cv.__file__})")
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
    for name, fn in calls:
        rounds = [bm.device_time_ms(fn, iters=ITERS) for _ in range(ROUNDS)]
        busy, launches = bm.device_profile(fn, calls=20)
        print(json.dumps({
            "checkout": label, "call": name,
            "chained_ms": rounds, "chained_median_ms":
                float(np.median(rounds)),
            "busy_ms": busy, "kernels_per_call": launches,
            "kernels": sorted(bm.device_kernels(fn, calls=5))}))
    try:
        from veles.simd_tpu_torch.runtime import faults, routing
    except ImportError:
        return 0    # a checkout without the fault policy
    policy = (faults.breaker_guarded, faults.demote_and_remember,
              routing.Route.allowed)
    bypass = (lambda site, key, thunk, **kw: thunk(),
              lambda site, run, fallback=None, **kw: run(),
              lambda self, geom: self.gate(geom))

    def use(fns):
        (faults.breaker_guarded, faults.demote_and_remember,
         routing.Route.allowed) = fns

    for name, fn in calls:
        on, off = [], []
        for r in range(ROUNDS):
            for fns, out in (((policy, on), (bypass, off)) if r % 2 == 0
                             else ((bypass, off), (policy, on))):
                use(fns)
                out.append(bm.device_time_ms(fn, iters=ITERS))
        use(policy)
        print(json.dumps({
            "checkout": label, "call": name, "ab": "policy on / bypassed",
            "on_ms": on, "off_ms": off,
            "on_median_ms": float(np.median(on)),
            "off_median_ms": float(np.median(off)),
            "diff_us": [(a - b) * 1e3 for a, b in zip(on, off)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
