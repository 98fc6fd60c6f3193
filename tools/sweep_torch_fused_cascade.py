#!/usr/bin/env python3
"""Time the fused DWT cascade against the level loop on one CUDA card,
over the shapes that set the ``wavelet.cascade`` gate.

    python3 tools/sweep_torch_fused_cascade.py [--quick] [--out FILE]

For each wavelet group (family, order, levels) near the top of the
fused pass's multiply-add budget and each shape of rows in 8, 512 and
16,384 by n in 256, 4096 and 65,536, the two routes of
``ops.wavelet.wavelet_transform`` run on the same seeded operand: the
fused cascade (one cascade-bank launch, ``wavelet._fused_cascade``)
and the level loop (one ``wavelet`` step a level,
``wavelet._level_loop``), whatever the gate would pick.  Each gives its
device busy milliseconds a call (``utils.benchmark.device_busy_ms``,
the sum of its kernels and copies in CUPTI's records) and its chained
milliseconds a call (CUDA events over back-to-back calls, host
dispatch included), and the two routes' largest band difference
relative to the band's max|y|.  ``gate`` says whether the gate admits
the shape.  Prints the card's name and power limit, then one JSON line
a shape, also written to ``--out`` (default
``chiprun_out/sweep_fused_cascade.jsonl``).  ``--quick`` runs the
first group at 512 x 4096 alone.  Exits non-zero without a card.
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# (family, order, levels): the budget's named groups, its largest coif
# and its two largest counts (daub22 L3 512, daub64 L2 508)
GROUPS = (("daub", 8, 3), ("daub", 4, 4), ("daub", 8, 2), ("daub", 8, 4),
          ("sym", 16, 3), ("coif", 18, 3), ("daub", 22, 3),
          ("daub", 64, 2))
ROWS = (8, 512, 16384)
LENGTHS = (256, 4096, 65536)
SEED = 20261018
# samples a profiled window should cover, so short calls are many
WINDOW_SAMPLES = 1 << 28


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the first group at 512 x 4096 only")
    ap.add_argument("--out", default=os.path.join(
        HERE, "chiprun_out", "sweep_fused_cascade.jsonl"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sweep_torch_fused_cascade: no CUDA card", file=sys.stderr)
        return 2
    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import smi_line

    print(f"card: {smi_line()}", flush=True)
    set_config(device="cuda")
    P = wv.ExtensionType.PERIODIC
    groups = GROUPS[:1] if args.quick else GROUPS
    shapes = ([(512, 4096)] if args.quick
              else [(r, n) for r in ROWS for n in LENGTHS])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with open(args.out, "w") as out:
        for rows, n in shapes:
            x = torch.randn(rows, n, device="cuda", generator=gen)
            calls = int(np.clip(WINDOW_SAMPLES // (rows * n), 5, 50))
            for type, order, levels in groups:
                routes = {
                    "fused": lambda: wv._fused_cascade(x, type, order,
                                                       levels),
                    "loop": lambda: wv._level_loop(type, order, P, x,
                                                   levels, None)}
                row = {"group": f"{type}{order} L{levels}", "rows": rows,
                       "n": n, "gate": wv._use_fused_cascade(
                           x.shape, order, P, levels, cuda=True)}
                bands = {k: fn() for k, fn in routes.items()}
                row["max_rel_diff"] = max(
                    float((f - g).abs().max() / g.abs().max())
                    for f, g in zip(bands["fused"], bands["loop"]))
                del bands
                for k, fn in routes.items():
                    row[f"{k}_busy_ms"] = bm.device_busy_ms(fn,
                                                            calls=calls)
                    row[f"{k}_chained_ms"] = bm.device_time_ms(
                        fn, iters=calls)
                row["busy_ratio"] = (row["loop_busy_ms"]
                                     / row["fused_busy_ms"])
                line = json.dumps(row)
                print(line, flush=True)
                out.write(line + "\n")
            del x
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
