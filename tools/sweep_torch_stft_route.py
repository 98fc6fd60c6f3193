#!/usr/bin/env python3
"""Time the three STFT routes against each other on one CUDA card, over
the frame lengths and hops that set the ``stft`` table's gate.

    python3 tools/sweep_torch_stft_route.py [--quick] [--out FILE]

For each frame length L in 256, 400, 512, 640, 1024, 2048 and 4096,
each hop of L/4, L/2 and hops that do not divide L (Whisper's 400/160,
512/200, 1024/300, 2048/441, 256/100 and the odd hops 256/85 and
4096/1023), and each shape of rows in 1, 8 and 64 by n in 2^16 and
2^20, the routes of ``ops.spectral.stft`` run forced on the same
seeded card operand with the periodic Hann window: ``cuda_fused`` (the
fused STFT kernel, one launch), ``rdft_matmul`` (framing copy, the
fp32 basis matmul, complex assembly) and ``xla_fft`` (windowed frames,
``torch.fft.rfft``), whatever the gate would pick.  Each gives its
device busy milliseconds a call (``utils.benchmark.device_busy_ms``,
the sum of its kernels and copies in CUPTI's records) and its chained
milliseconds a call (CUDA events over back-to-back calls, host
dispatch included), and each route's largest difference from
``xla_fft`` relative to max|X|.  ``frames`` is the frame count of a
row, ``gate`` the route the static selection picks for it on a card,
and ``best`` the route of least busy time.  Prints the card's name and
power limit, then one JSON line a shape, also written to ``--out``
(default ``build/sweep_stft_route.jsonl``), then the count of shapes
the gate sends to the kernel where another route, and where the basis
matmul it displaces, took less device time.  ``--quick`` runs 400/160
at 8 x 2^16 and 64 x 2^20 alone.  Exits non-zero without a card.
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# L: L/4, L/2, then hops that do not divide L
HOPS = {256: (64, 128, 100, 85), 400: (100, 200, 160),
        512: (128, 256, 200), 640: (160, 320), 1024: (256, 512, 300),
        2048: (512, 1024, 441), 4096: (1024, 2048, 1023)}
ROWS = (1, 8, 64)
LENGTHS = (1 << 16, 1 << 20)
ROUTES = ("cuda_fused", "rdft_matmul", "xla_fft")
SEED = 20261018
# samples a profiled window should cover, so short calls are many
WINDOW_SAMPLES = 1 << 28


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="400/160 at 8 x 2^16 and 64 x 2^20 only")
    ap.add_argument("--out", default=os.path.join(
        HERE, "build", "sweep_stft_route.jsonl"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sweep_torch_stft_route: no CUDA card", file=sys.stderr)
        return 2
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import smi_line

    print(f"card: {smi_line()}", flush=True)
    set_config(device="cuda")
    geoms = ([(400, 160)] if args.quick
             else [(L, hop) for L, hops in HOPS.items() for hop in hops])
    shapes = ([(8, 1 << 16), (64, 1 << 20)] if args.quick
              else [(r, n) for r in ROWS for n in LENGTHS])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    losses, matmul_wins = [], []
    with open(args.out, "w") as out:
        for rows, n in shapes:
            x = torch.randn(rows, n, device="cuda", generator=gen)
            calls = int(np.clip(WINDOW_SAMPLES // (rows * n), 5, 50))
            for L, hop in geoms:
                window = sp.hann_window(L)
                routes = {route: (lambda route=route: sp._run_stft_route(
                    route, x, window, L, hop, forced=True, host=False))
                    for route in ROUTES}
                frames = sp.frame_count(n, L, hop)
                row = {"L": L, "hop": hop, "rows": rows, "n": n,
                       "frames": frames,
                       "gate": sp._STFT_FAMILY.select(
                           frame_length=L, hop=hop, frames=frames,
                           cuda=True)}
                ref = torch.view_as_real(routes["xla_fft"]())
                scale = float(ref.abs().max())
                for route in ROUTES[:2]:
                    got = torch.view_as_real(routes[route]())
                    row[f"{route}_rel_diff"] = float(
                        (got - ref).abs().max()) / scale
                    del got
                del ref
                for route, fn in routes.items():
                    row[f"{route}_busy_ms"] = bm.device_busy_ms(
                        fn, calls=calls)
                    row[f"{route}_chained_ms"] = bm.device_time_ms(
                        fn, iters=calls)
                row["best"] = min(ROUTES, key=lambda r: row[f"{r}_busy_ms"])
                row["busy_ratio"] = (
                    min(row[f"{r}_busy_ms"] for r in ROUTES[1:])
                    / row["cuda_fused_busy_ms"])
                if row["gate"] == "cuda_fused" != row["best"]:
                    losses.append((L, hop, rows, n))
                    if row["rdft_matmul_busy_ms"] < row["cuda_fused_busy_ms"]:
                        matmul_wins.append((L, hop, rows, n))
                line = json.dumps(row)
                print(line, flush=True)
                out.write(line + "\n")
                torch.cuda.empty_cache()
            del x
            torch.cuda.empty_cache()
    print(f"gate sends {len(losses)} shapes to the kernel where another "
          f"route took less device time: {losses}; the basis matmul in "
          f"{len(matmul_wins)}: {matmul_wins}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
