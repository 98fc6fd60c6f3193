#!/usr/bin/env python3
"""Time the PyTorch port's overlap-save kernel at batched shapes on one
CUDA card.

    python3 tools/time_torch_overlap_save.py [--repo DIR] [--label NAME]

Imports ``veles.simd_tpu_torch`` from the checkout at DIR (default: the
one holding this script), so two checkouts can be timed on one card in
one call: unpack the other commit (``git archive``) into a directory
that ``.gitignore`` lists and run the script once for each, in turns.
Prints the card's name and power limit, then one JSON line per shape:
rows, samples a row, taps, the segment length the checkout picks (null
where it has no segment rule), the kernel's launches for one call, the
device time per call from ``torch.profiler`` (mean of 20 calls after
warm-up) beside the chained CUDA-event time, and the relative error
against a float64 FFT convolution.  Exits non-zero without a card.
"""

import argparse
import json
import os
import sys

import numpy as np

# (rows, samples a row, taps): the headline and one long row at the
# route's short filters, batched rows that take one segment each, and
# rows shorter than the shortest segment
SHAPES = ((1, 1 << 20, 2047), (1, 1 << 20, 300), (512, 4096, 300),
          (3, 5000, 256), (4096, 1000, 300), (70000, 8, 256))
SEED = 20261016


def conv64(x, h):
    """float64 full convolution of every row of x with h."""
    n, k = x.shape[-1], h.shape[-1]
    m = 1 << (n + k - 2).bit_length()
    spec = (np.fft.rfft(x.astype(np.float64), m, axis=-1)
            * np.fft.rfft(h.astype(np.float64), m))
    return np.fft.irfft(spec, m, axis=-1)[..., : n + k - 1]


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
        print("time_torch_overlap_save: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.repo))
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.platform import smi_line

    label = args.label or args.repo
    print(f"card: {smi_line()} | checkout {label} ({ck.__file__})")
    ck.load_library()
    rng = np.random.RandomState(SEED)
    for rows, n, k in SHAPES:
        x_np = rng.randn(rows, n).astype(np.float32)
        h_np = rng.randn(k).astype(np.float32)
        x = torch.as_tensor(x_np, device="cuda")
        h = torch.as_tensor(h_np, device="cuda")
        ck.reset_launches()
        y = ck.overlap_save_cuda(x, h)
        torch.cuda.synchronize()
        launches = ck.LAUNCHES["overlap_save"]
        want = conv64(x_np, h_np)
        err = float(np.max(np.abs(y.cpu().numpy() - want))
                    / np.max(np.abs(want)))
        rule = getattr(ck, "os_fft_length", None)
        print(json.dumps({
            "checkout": label, "rows": rows, "n": n, "k": k,
            "fft_length": rule(k, n) if rule is not None else None,
            "launches": launches,
            "ms": bm.device_busy_ms(lambda: ck.overlap_save_cuda(x, h),
                                    calls=20),
            "chained_ms": bm.device_time_ms(
                lambda: ck.overlap_save_cuda(x, h)),
            "rel_err_vs_f64": err}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
