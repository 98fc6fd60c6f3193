#!/usr/bin/env python3
"""Cold and warm starts of a port process on the card: spawn to the
first headline result, with and without the warm pack.

    python3 tools/time_torch_cold_start.py [--rounds 2] [--quick]

Each arm is a fresh process (``chip_smoke.ARTIFACT_CHILD``) with an
empty kernel build root (``$VELES_SIMD_CACHE_DIR``): it starts a
``serve.Server``, runs the headline convolution (1,048,576 x 2047,
K1) and reports.  The arms, in turns (cold, warm, warm, cold a round):

* cold — ``VELES_SIMD_ARTIFACTS=off``: nvcc builds the kernel library
  before the first launch;
* warm — ``VELES_SIMD_ARTIFACTS=readonly`` with a pack of the library
  this process loaded (``runtime/artifacts.py``): ``Server.start()``
  places it under the build root, and no nvcc runs.

Prints one line an arm (seconds from spawn to the result line, nvcc
seconds, compile counters, preload report, the headline's K1 launches
and error against float64), then one JSON summary line, each beside
the card's name and power limit.  Exits 2 without a card.  About 1.5
minutes on one H100 with 2 rounds (``--quick``: 1).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--quick", action="store_true",
                    help="one round (cold, warm, warm, cold)")
    args = ap.parse_args(argv)
    if args.quick:
        args.rounds = 1
    import torch

    if not torch.cuda.is_available():
        print("time_torch_cold_start: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.runtime import artifacts as art
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import smi_line

    set_config(device="cuda")
    smi = smi_line()
    ck.load_library()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="cold-start-",
                            dir=os.path.join(ROOT, "build"))
    try:
        pack = os.path.join(work, "pack")
        with art.private_artifact_store(pack), \
                art.artifacts_mode_override("on"):
            cs.check(art.store_kernel_library() == "stored",
                     "packing the loaded library")
        times = {"cold": [], "warm": []}
        for r in range(args.rounds):
            for i, arm in enumerate(("cold", "warm", "warm", "cold")):
                env = dict(os.environ, VELES_SIMD_ARTIFACT_DIR=pack,
                           VELES_SIMD_CACHE_DIR=os.path.join(
                               work, f"root-{r}-{i}"),
                           VELES_SIMD_ARTIFACTS=("off" if arm == "cold"
                                                 else "readonly"))
                got, spawn_s = cs.artifact_child("headline", env)
                built = "compile.backend_compile" in got["compile"]
                cs.check(built == (arm == "cold")
                         and got["launches"]["overlap_save"] == 2
                         and got["err"] <= cs.ORACLE_TOL,
                         f"{arm} child: {got}")
                times[arm].append(spawn_s)
                print(f"{arm}: spawn to first result {spawn_s:.3f} s | "
                      f"nvcc {got['nvcc_s']:.3f} s | compile counters "
                      f"{got['compile']} | preload {got['preload']} | "
                      f"overlap_save x {got['launches']['overlap_save']}, "
                      f"rel err {got['err']:.2e} | card {smi}",
                      flush=True)
        print(json.dumps({"cold_s": times["cold"], "warm_s": times["warm"],
                          "cold_min_s": min(times["cold"]),
                          "warm_min_s": min(times["warm"]),
                          "card": smi}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
