#!/usr/bin/env python3
"""Wavelet denoising on the card: analysis -> soft threshold -> synthesis.

The twin of ``examples/wavelet_denoise.py`` over the PyTorch/CUDA port
(``veles.simd_tpu_torch.ops.wavelet``): a 5-level sym8 DWT of a noisy
8192-sample signal (``wavelet_transform``), the detail bands
soft-thresholded at the universal threshold sigma * sqrt(2 ln n), and
the exact inverse (``wavelet_inverse_transform``).  Denoising must
gain more than 3 dB of SNR, and the zero-threshold round trip must
come back within 1e-3.

One row sits under the filter-bank kernel's row gate, so the DWT runs
cuDNN ``conv1d`` on the card; the kernel launches are printed all the
same.

Run:  python3 examples/wavelet_denoise_torch.py            # the card
      VELES_SIMD_PLATFORM=cpu python3 examples/wavelet_denoise_torch.py

Without a card and without ``VELES_SIMD_PLATFORM=cpu`` it exits 2.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))

from veles.simd_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from veles.simd_tpu_torch.ops import wavelet as wv  # noqa: E402
from veles.simd_tpu_torch.utils import platform  # noqa: E402

# the JAX example's sizes
SIZES = {"n": 1 << 13, "levels": 5, "sigma": 0.3}


def snr_db(clean, noisy):
    err = np.asarray(noisy, np.float64) - clean
    return float(10 * np.log10(np.sum(clean ** 2)
                               / max(np.sum(err ** 2), 1e-30)))


def make_signal(n, sigma, seed=3):
    """``(clean, noisy)``: a sine plus a square wave, and the same with
    white noise of ``sigma``."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 1, n, endpoint=False)
    clean = (np.sin(2 * np.pi * 5 * t)
             + 0.5 * np.sign(np.sin(2 * np.pi * 2 * t))).astype(np.float32)
    return clean, clean + sigma * rng.randn(n).astype(np.float32)


def soft_threshold(coeffs, thresh):
    """The detail bands soft-thresholded, the approximation kept (NumPy
    out)."""
    den = []
    for band in coeffs[:-1]:
        b = platform.to_host(band)
        den.append(np.sign(b) * np.maximum(np.abs(b) - thresh, 0.0))
    den.append(platform.to_host(coeffs[-1]))
    return den


def denoise(n, levels, sigma):
    """The denoising step and the zero-threshold round trip."""
    clean, noisy = make_signal(n, sigma)
    thresh = np.float32(sigma * np.sqrt(2 * np.log(n)))
    with ck.count_launches() as launches:
        coeffs = wv.wavelet_transform("sym", 8, wv.ExtensionType.PERIODIC,
                                      noisy, levels, simd=True)
        rec = platform.to_host(wv.wavelet_inverse_transform(
            "sym", 8, soft_threshold(coeffs, thresh), simd=True))
        ident = platform.to_host(wv.wavelet_inverse_transform(
            "sym", 8, coeffs, simd=True))
    snr_in, snr_out = snr_db(clean, noisy), snr_db(clean, rec)
    err = float(np.abs(ident - noisy).max())
    return {"rec": rec, "ident": ident, "thresh": float(thresh),
            "snr_in": snr_in, "snr_out": snr_out, "round_trip_err": err,
            "launches": launches,
            "checks": {"snr_gain_3db": snr_out > snr_in + 3,
                       "round_trip": err < 1e-3}}


def run(n=SIZES["n"], levels=SIZES["levels"], sigma=SIZES["sigma"],
        emit=print):
    """The step at the given sizes, printing the JAX example's lines
    through ``emit``; returns its results and ``checks``."""
    res = denoise(n, levels, sigma)
    emit(f"signal: {n} samples, noise sigma={sigma}")
    emit(f"SNR in : {res['snr_in']:6.2f} dB")
    emit(f"SNR out: {res['snr_out']:6.2f} dB  (sym8, {levels}-level soft "
         f"threshold {res['thresh']:.3f}) | launches "
         f"{res['launches'] or 0}")
    emit(f"zero-threshold round trip max err: {res['round_trip_err']:.2e}")
    return res


def main(argv=None):
    platform.select_device()
    print(f"device: {platform.device_line()}")
    res = run()
    ok = all(res["checks"].values())
    print("ok" if ok else f"FAILED {res['checks']}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
