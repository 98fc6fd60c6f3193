#!/usr/bin/env python3
"""Build a pre-warmed autotune pack for the PyTorch port on a CUDA card.

    python3 tools/autotune_pack_torch.py [--out autotune_pack_torch.json]
        [--quick] [--precisions highest,bf16_comp]

Runs the port's measured autotuner (``VELES_SIMD_AUTOTUNE=on``,
``veles/simd_tpu_torch/runtime/routing.py``) across the geometry sweep
of the JAX package's ``tools/autotune_pack.py`` for every routed family
of the port — ``matrix.gemm``, ``convolve.os``, ``convolve.direct``,
``convolve2d``, ``stft``/``istft``, ``hilbert``/``morlet_cwt`` and
``wavelet`` — with the operands on the card, and writes the winners
into one version-1 tune-cache file stamped with the card's name
(``torch.cuda.get_device_name``).  Ship it and point services at it::

    VELES_SIMD_AUTOTUNE=readonly \\
    VELES_SIMD_AUTOTUNE_CACHE=autotune_pack_torch.json python serve.py

A pack built on one kind of card is refused (``device_mismatch``) on
any other, and by the JAX package.  ``--precisions`` narrows the
candidates through the precision layer's switches: a list without
``bf16_comp`` sets ``VELES_SIMD_DISABLE_BF16_COMP=1`` for the drive, a
list with ``int8`` sets ``VELES_SIMD_ENABLE_INT8=1``.  Prints one line
per geometry and the pack's entries; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _drive(torch, quick: bool) -> None:
    """One call per geometry class: the measured mode probes and
    persists as a side effect of normal dispatch."""
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.ops import convolve2d as cv2
    from veles.simd_tpu_torch.ops import matrix as mx
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.ops import wavelet as wv

    rng = np.random.RandomState(7)

    def cuda(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device="cuda")

    def done(what, out):
        torch.cuda.synchronize()
        del out
        print(f"  {what}: done", flush=True)

    # matrix.gemm: the precision family
    for nm in ([1024] if quick else [512, 1024, 2048]):
        done(f"matrix.gemm {nm}x{nm}",
             mx.matrix_multiply(cuda(nm, nm), cuda(nm, nm)))
    # overlap-save: the headline first, then medium filters
    os_geoms = [(1 << 20, 2047)] if quick else [
        (1 << 20, 2047), (1 << 20, 511), (1 << 18, 1023), (1 << 16, 127)]
    for n, k in os_geoms:
        handle = cv.convolve_overlap_save_initialize(n, k)
        done(f"convolve.os {n}x{k}",
             cv.convolve_overlap_save(handle, cuda(n), cuda(k)))
    # batched direct form: the filter-bank kernel against conv1d
    for rows, n, k in ([(64, 4096, 65)] if quick
                       else [(64, 4096, 65), (512, 4096, 9)]):
        done(f"convolve.direct {rows}x{n} k={k}",
             cv.convolve_simd(cuda(rows, n), cuda(k)))
    # convolve2d auto cells inside the kernel's gate
    for n0, k0 in ([(128, 3)] if quick else [(128, 3), (256, 5)]):
        done(f"convolve2d 8x{n0}^2 k={k0}",
             cv2.convolve2d(cuda(8, n0, n0), cuda(k0, k0)))
    # spectral: stft/istft per (frame, hop) class, hilbert and cwt
    stft_geoms = [(16384, 512, 128)] if quick else [
        (16384, 512, 128), (16384, 512, 64), (65536, 1024, 256)]
    for n, fl, hop in stft_geoms:
        spec = sp.stft(cuda(n), fl, hop)
        done(f"stft/istft {n}/{fl}/{hop}", sp.istft(spec, n, fl, hop))
    xs = cuda(512)
    sp.hilbert(xs)
    done("hilbert/morlet_cwt 512", sp.morlet_cwt(xs, [2.0, 4.0, 8.0]))
    # the wavelet filter bank (kernel against conv1d)
    done("wavelet 64x4096 daub8",
         wv.wavelet_apply(wv.WaveletType.DAUBECHIES, 8,
                          wv.ExtensionType.PERIODIC, cuda(64, 4096)))


def main() -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="autotune_pack_torch.json",
                        help="tune-cache file to build (default "
                             "autotune_pack_torch.json)")
    parser.add_argument("--quick", action="store_true",
                        help="headline geometries only")
    parser.add_argument(
        "--precisions", default="highest,bf16_comp",
        help="precision candidates the drive may explore "
             "(comma-separated; omit bf16_comp for a classic-precision "
             "pack, add int8 to let the opt-in route compete)")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    from veles.simd_tpu_torch.runtime import precision as prx

    precisions = {p.strip() for p in args.precisions.split(",")
                  if p.strip()}
    for p in precisions:
        if p not in prx.PRECISIONS:
            parser.error(f"unknown precision {p!r} (choose from "
                         f"{sorted(prx.PRECISIONS)})")
    import torch

    if not torch.cuda.is_available():
        print("autotune_pack_torch: no CUDA card; a pack is measured on "
              "the card it is for", file=sys.stderr)
        return 2
    # the switches are read at each gate, so setting them here steers
    # the whole drive
    if "bf16_comp" not in precisions:
        os.environ[prx.BF16_COMP_ENV] = "1"
    if "int8" in precisions:
        os.environ[prx.INT8_ENV] = "1"
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.runtime import routing
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import smi_line

    set_config(device="cuda")
    os.environ[routing.AUTOTUNE_ENV] = "on"
    routing.set_cache_path(args.out)
    obs.enable()
    print(f"card: {smi_line()} | pack: {args.out}", flush=True)
    try:
        _drive(torch, args.quick)
    finally:
        cache = routing.tune_cache()
        cache.save()
        entries = cache.entries()
        print(f"\npack {args.out}: {len(entries)} entries (version "
              f"{routing.TUNE_CACHE_VERSION}, device {cache.device})")
        for key, entry in sorted(entries.items()):
            print(f"  {key} -> {entry['route']} "
                  f"[{entry.get('source', '?')}] "
                  f"{entry.get('timings_us', {})}")
        print(json.dumps(cache.info(), sort_keys=True))
        routing.set_cache_path(None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
