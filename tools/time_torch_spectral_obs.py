#!/usr/bin/env python3
"""Time the spectral route cores with telemetry on, in one checkout.

    python3 tools/time_torch_spectral_obs.py [--root DIR]

Each route core of ``stft``, ``istft``, ``hilbert`` and ``morlet_cwt``
(and ``stft_stream_step``'s, and ``batched_stft``'s handle) may be an
``obs.instrumented_jit``: with telemetry on, every call then builds a
signature and looks it up in the resource LRU.  This script times what
a user pays per call for that.  With ``obs.enable()``, for each forced
route at a small shape, where the host's share of a call is largest, it
runs ``ROUNDS`` rounds, each timing ``ITERS`` chained calls (CUDA
events, ``utils.benchmark.device_time_ms``) three times: with the
shipped cores, with every instrumented core of ``ops/spectral.py``
replaced by its bare function (the parent's code path; ``batched_stft``
keeps its cached handle in both), and with the shipped cores again (an
A/A control), in an order that rotates each round.  It prints one JSON
line per call with each arm's ms, their medians and each round's
shipped-minus-bypassed µs, then the number of instrumented cores
bypassed and of ``obs.resources()`` rows the calls left.

``--root DIR`` imports ``veles.simd_tpu_torch`` from the checkout at
DIR (default: this script's), so one copy of the script times two
trees: run it on the parent and on the change in one session, in the
order parent, change, change, parent, and compare the medians within
that session.  Prints the card's name and power limit first.  Exits
non-zero without a card.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

SEED = 20261018
ROUNDS, ITERS = 7, 200


def _calls(sp, batched, cuda):
    """``(name, fn)`` of each timed call: one forced route a line."""
    x = cuda(16384)
    spec = sp.stft(x, 256, 64, route="xla_fft")
    xh, xc = cuda(1024), cuda(1024)
    scales = np.geomspace(2.0, 64.0, 16)
    carry = sp.stft_stream_carry(256, 64)
    x_ext = cuda(carry + 4096)
    win = sp._resolve_window(None, 256)
    xb = cuda(8, 4096)
    out = []
    for r in ("xla_fft", "rdft_matmul", "rdft_matmul_bf16_comp"):
        out.append((f"stft 16384 256/64 {r}",
                    lambda r=r: sp.stft(x, 256, 64, route=r)))
    for r in ("xla_fft", "rdft_matmul", "rdft_matmul_bf16_comp"):
        out.append((f"istft 16384 256/64 {r}",
                    lambda r=r: sp.istft(spec, 16384, 256, 64, route=r)))
    for r in ("xla_fft", "matmul_dft", "matmul_dft_bf16_comp"):
        out.append((f"hilbert 1024 {r}",
                    lambda r=r: sp.hilbert(xh, route=r)))
    for r in ("xla_fft", "matmul_dft", "matmul_dft_bf16_comp",
              "ct_matmul"):
        out.append((f"morlet_cwt 1024 x 16 {r}",
                    lambda r=r: sp.morlet_cwt(xc, scales, route=r)))
    out.append(("stft_stream_step 4096 256/64 xla_fft",
                lambda: sp.stft_stream_step(x_ext, 256, 64, win,
                                            "xla_fft")))
    out.append(("batched_stft 8 x 4096 256/64 (its own pick)",
                lambda: batched.batched_stft(xb, 256, 64)))
    return out


def _instrumented(sp):
    """``{name: core}`` of the module's instrumented cores."""
    return {n: v for n, v in vars(sp).items()
            if type(v).__name__ == "InstrumentedJit"}


def _use(sp, cores, shipped):
    """Ship the instrumented cores, or bypass them with their bare
    functions (the module's globals and its rdft core table)."""
    for name, core in cores.items():
        setattr(sp, name, core if shipped else core.fn)
    table = getattr(sp, "_STFT_RDFT_CORES", None)
    if table is not None:
        for k, core in list(table.items()):
            base = core.fn if hasattr(core, "fn") else core
            match = [c for c in cores.values() if c.fn is base]
            table[k] = match[0] if shipped and match else base


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]),
                    help="the checkout whose veles.simd_tpu_torch is "
                    "timed")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_torch_spectral_obs: no CUDA card", file=sys.stderr)
        return 2
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.ops import batched
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import smi_line

    root = Path(sp.__file__).resolve().parents[3]
    print(f"card: {smi_line()}")
    print(f"root: {root}")
    set_config(device="cuda")
    obs.enable()
    rng = np.random.RandomState(SEED)

    def cuda(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device="cuda")

    cores = _instrumented(sp)
    for name, fn in _calls(sp, batched, cuda):
        on, off, again = [], [], []
        arms = ((True, on), (False, off), (True, again))
        for r in range(ROUNDS):
            k = r % len(arms)
            for shipped, out in arms[k:] + arms[:k]:
                _use(sp, cores, shipped)
                out.append(bm.device_time_ms(fn, iters=ITERS))
        _use(sp, cores, True)
        print(json.dumps({
            "call": name, "telemetry": obs.enabled(),
            "ab": "shipped / bypassed / shipped again",
            "shipped_ms": on, "bypassed_ms": off, "again_ms": again,
            "median_ms": float(np.median(on)),
            "bypassed_median_ms": float(np.median(off)),
            "again_median_ms": float(np.median(again)),
            "diff_us": [(a - b) * 1e3 for a, b in zip(on, off)],
            "aa_diff_us": [(a - b) * 1e3 for a, b in zip(on, again)]}),
              flush=True)
    rows = obs.resources()
    print(json.dumps({"instrumented_cores": len(cores),
                      "resource_rows": len(rows), "keys": sorted(
        {f"{r['op']}/{r['route']}" for r in rows})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
