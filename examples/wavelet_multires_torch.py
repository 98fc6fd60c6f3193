#!/usr/bin/env python3
"""Multi-resolution wavelet analysis of a chirp, on the card.

The twin of ``examples/wavelet_multires.py`` over the PyTorch/CUDA port
(``veles.simd_tpu_torch.ops.wavelet``), on a 2^14-sample chirp whose
frequency rises with time:

* the DWT daub8 over 4 levels (``wavelet_transform``), with each
  band's energy share;
* the SWT sym8 over 2 levels, mirror extension (every band full
  length);
* a 3-level wavelet packet tree and its inverse, within 5e-4;
* ``wavelet_apply`` against the oracle ``wavelet_apply_na``, within
  5e-4.

The port's route (``CUDA`` on the card, ``CPU`` when asked) stands
where the JAX example printed "XLA".  One row sits under the
filter-bank kernel's row gate, so these calls run cuDNN ``conv1d`` on
the card; the kernel launches are printed all the same.

Run:  python3 examples/wavelet_multires_torch.py            # the card
      VELES_SIMD_PLATFORM=cpu python3 examples/wavelet_multires_torch.py

Without a card and without ``VELES_SIMD_PLATFORM=cpu`` it exits 2.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))

from veles.simd_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from veles.simd_tpu_torch.ops import wavelet as wv  # noqa: E402
from veles.simd_tpu_torch.ops.wavelet_coeffs import WaveletType  # noqa: E402
from veles.simd_tpu_torch.utils import platform  # noqa: E402

# the JAX example's sizes
SIZES = {"n": 1 << 14, "dwt_levels": 4, "swt_levels": 2,
         "packet_levels": 3}
DAUB, SYM = WaveletType.DAUBECHIES, WaveletType.SYMLET
PERIODIC, MIRROR = wv.ExtensionType.PERIODIC, wv.ExtensionType.MIRROR


def make_chirp(n):
    t = np.linspace(0, 1, n, dtype=np.float32)
    return np.sin(2 * np.pi * (20 + 400 * t) * t).astype(np.float32)


def _energy(b):
    return float(np.sum(np.asarray(b, np.float64) ** 2))


def dwt_bands(chirp, levels):
    """The decimated cascade ``[hi_1, ..., hi_L, lo_L]`` (NumPy) and each
    band's share of the energy."""
    bands = [platform.to_host(b) for b in wv.wavelet_transform(
        DAUB, 8, PERIODIC, chirp, levels)]
    total = sum(_energy(b) for b in bands)
    return {"bands": bands,
            "shares": [_energy(b) / total for b in bands]}


def swt_bands(chirp, levels):
    """The stationary transform's bands (NumPy), each full length."""
    bands = [platform.to_host(b) for b in wv.stationary_wavelet_transform(
        SYM, 8, MIRROR, chirp, levels)]
    return {"bands": bands,
            "checks": {"swt_full_length": all(
                b.shape[-1] == chirp.shape[-1] for b in bands)}}


def packet_tree(chirp, levels):
    """The full binary packet tree's leaves (NumPy), the leaf holding
    the most energy, and the inverse's error."""
    leaves = [platform.to_host(b) for b in wv.wavelet_packet_transform(
        DAUB, 8, PERIODIC, chirp, levels)]
    energies = [_energy(b) for b in leaves]
    back = platform.to_host(wv.wavelet_packet_inverse_transform(
        DAUB, 8, leaves))
    err = float(np.max(np.abs(back - chirp)))
    peak = int(np.argmax(energies))
    return {"leaves": leaves, "back": back, "peak": peak,
            "peak_share": energies[peak] / sum(energies), "err": err,
            "checks": {"packet_round_trip": err < 5e-4}}


def oracle_check(chirp):
    """``wavelet_apply`` against its NumPy oracle ``wavelet_apply_na``."""
    hi, lo = (platform.to_host(v) for v in wv.wavelet_apply(
        DAUB, 8, PERIODIC, chirp))
    hi_na, lo_na = wv.wavelet_apply_na(DAUB, 8, PERIODIC, chirp)
    err = max(float(np.max(np.abs(hi - hi_na))),
              float(np.max(np.abs(lo - lo_na))))
    return {"hi": hi, "lo": lo, "err": err,
            "checks": {"apply_vs_oracle": err < 5e-4}}


def run(n=SIZES["n"], dwt_levels=SIZES["dwt_levels"],
        swt_levels=SIZES["swt_levels"],
        packet_levels=SIZES["packet_levels"], emit=print):
    """Every step at the given sizes, printing the JAX example's lines
    through ``emit``; returns each step's results and ``checks``."""
    chirp = make_chirp(n)
    with ck.count_launches() as launches:
        dwt = dwt_bands(chirp, dwt_levels)
        swt = swt_bands(chirp, swt_levels)
        pk = packet_tree(chirp, packet_levels)
        oc = oracle_check(chirp)
    emit(f"DWT daub8, {dwt_levels} levels (finest -> coarsest + "
         "approximation):")
    for i, (b, share) in enumerate(zip(dwt["bands"], dwt["shares"])):
        label = (f"detail {i + 1}" if i < dwt_levels
                 else f"approx  {dwt_levels}")
        emit(f"  {label}: len={b.shape[-1]:6d} energy={100 * share:5.1f}%")
    emit(f"SWT sym8, {swt_levels} levels: band lengths "
         f"{[b.shape[-1] for b in swt['bands']]}")
    emit(f"packet tree, {packet_levels} levels: {len(pk['leaves'])} "
         f"uniform leaves; leaf {pk['peak']} holds "
         f"{100 * pk['peak_share']:.1f}% of the energy")
    route = "CUDA" if platform.on_cuda() else "CPU"
    emit(f"{route} vs oracle max abs err: {oc['err']:.2e} | launches "
         f"{launches or 0}")
    return {"dwt": dwt, "swt": swt, "packets": pk, "oracle": oc,
            "launches": launches,
            "checks": {**swt["checks"], **pk["checks"], **oc["checks"]}}


def main(argv=None):
    platform.select_device()
    print(f"device: {platform.device_line()}")
    res = run()
    ok = all(res["checks"].values())
    print("ok" if ok else f"FAILED {res['checks']}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
