#!/usr/bin/env python3
"""Time what the autotuner's ``off`` check adds to a call, on one card.

    python3 tools/time_torch_autotune_off.py

With ``VELES_SIMD_AUTOTUNE`` unset, every routed call site asks
``routing.autotune_mode()`` once and, on ``off``, takes its static
route before it builds a tune class or a runner.  A checkout without
the autotuner asked nothing: its site took the first eligible route
through a plain ``Family.select``.  This script times the difference in
one process, as ``tools/time_torch_guard.py`` times the fault policy:
for the headline ``convolve(handle, x, h)`` at 1,048,576 x 2047, ``stft``
on 2^20 samples at 512/128, ``convolve2d`` on 16 x 512^2 with 7 x 7 and
``hilbert`` on 8 x 1024 (operands on the card, telemetry off), it runs
``ROUNDS`` rounds, each timing ``ITERS`` chained calls (CUDA events)
with the shipped check, with the check answered by a constant
``"off"`` (the cost of the checkout without it) and with the shipped
check again (an A/A control: what two identical arms differ by), in
an order that rotates each round, and prints one JSON line per call
with each round's differences.  It also prints the host nanoseconds of
one ``autotune_mode()`` call.
Prints the card's name and power limit first.  Exits non-zero without
a card.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SEED = 20261017
ROUNDS, ITERS = 9, 300


def main():
    import torch

    if not torch.cuda.is_available():
        print("time_torch_autotune_off: no CUDA card", file=sys.stderr)
        return 2
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.ops import convolve2d as cv2
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.runtime import routing
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import smi_line

    print(f"card: {smi_line()}")
    if routing.autotune_mode() != "off":
        print("time_torch_autotune_off: VELES_SIMD_AUTOTUNE is set",
              file=sys.stderr)
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
    xb = cuda(8, 1024)
    calls = (("convolve 1048576x2047", lambda: cv.convolve(handle, xh, th)),
             ("stft 1048576 512/128", lambda: sp.stft(xs, 512, 128)),
             ("convolve2d 16x512x512 k 7x7",
              lambda: cv2.convolve2d(x2, h2)),
             ("hilbert 8x1024", lambda: sp.hilbert(xb)))

    shipped = routing.autotune_mode
    n = 100000
    t0 = time.perf_counter()
    for _ in range(n):
        shipped()
    mode_ns = (time.perf_counter() - t0) / n * 1e9
    print(json.dumps({"autotune_mode_ns": mode_ns}))

    def constant():
        return "off"

    for name, fn in calls:
        on, off, again = [], [], []
        arms = ((shipped, on), (constant, off), (shipped, again))
        for r in range(ROUNDS):
            k = r % len(arms)
            for mode, out in arms[k:] + arms[:k]:
                routing.autotune_mode = mode
                out.append(bm.device_time_ms(fn, iters=ITERS))
        routing.autotune_mode = shipped
        print(json.dumps({
            "call": name, "ab": "off check / constant off / check again",
            "check_ms": on, "constant_ms": off, "again_ms": again,
            "check_median_ms": float(np.median(on)),
            "constant_median_ms": float(np.median(off)),
            "again_median_ms": float(np.median(again)),
            "diff_us": [(a - b) * 1e3 for a, b in zip(on, off)],
            "aa_diff_us": [(a - b) * 1e3 for a, b in zip(on, again)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
