#!/usr/bin/env python3
"""Sub-bin frequency analysis on the card: zoom FFT and Lomb-Scargle.

The twin of ``examples/spectral_zoom.py`` over the PyTorch/CUDA port
(``veles.simd_tpu_torch.ops.spectral``).  A 0.5 Hz pair at 400 and
400.5 Hz in 2^14 samples at 2 kHz (an FFT bin is 0.12 Hz):

1. ``zoom_fft`` zooms a 5 Hz band onto a 4096-point grid (Bluestein
   chirp-Z);
2. ``lombscargle`` fits the same pair when 35 % of the samples are
   missing.

Both must resolve 400 / 400.5 Hz within 0.05 Hz.  ``zoom_fft`` rests
on ``czt``, which builds its chirp constants on the host on each call
(as the JAX package does); each step's wall seconds are printed.
Neither step reaches one of the port's five CUDA kernels.

Run:  python3 examples/spectral_zoom_torch.py            # the card
      VELES_SIMD_PLATFORM=cpu python3 examples/spectral_zoom_torch.py

Without a card and without ``VELES_SIMD_PLATFORM=cpu`` it exits 2.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))

from veles.simd_tpu_torch.ops import spectral as sp  # noqa: E402
from veles.simd_tpu_torch.utils import platform  # noqa: E402

# the JAX example's sizes
SIZES = {"n": 1 << 14, "fs": 2000.0, "m": 4096, "band": (398.0, 403.0),
         "keep": 0.65}
PAIR = (400.0, 400.5)
TOL_HZ = 0.05


def two_peaks(freq_axis, mag):
    i1 = int(np.argmax(mag))
    m2 = mag.copy()
    lo = max(0, i1 - len(mag) // 20)
    m2[lo: i1 + len(mag) // 20] = 0
    i2 = int(np.argmax(m2))
    return sorted((float(freq_axis[i1]), float(freq_axis[i2])))


def make_signal(n, fs, seed=0):
    """``(rng, t, x)``: the doppler pair in noise; the rng goes on to
    pick the dropouts, as in the JAX example."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / fs
    clean = (np.sin(2 * np.pi * PAIR[0] * t)
             + 0.5 * np.sin(2 * np.pi * PAIR[1] * t))
    return rng, t, (clean + 0.3 * rng.randn(n)).astype(np.float32)


def _resolved(pair):
    return all(abs(g - want) < TOL_HZ for g, want in zip(pair, PAIR))


def zoom(x, band, m, fs):
    """The uniform capture: ``zoom_fft`` of ``band`` onto ``m`` points."""
    t0 = time.perf_counter()
    f, z = sp.zoom_fft(x, list(band), m=m, fs=fs)
    mag = np.abs(platform.to_host(z))
    wall = time.perf_counter() - t0
    pair = two_peaks(platform.to_host(f), mag)
    return {"f": platform.to_host(f), "mag": mag, "pair": pair,
            "wall_s": wall, "checks": {"zoom_fft": _resolved(pair)}}


def lomb(rng, t, x, band, m, keep):
    """The same signal with ``1 - keep`` of the samples dropped:
    Lomb-Scargle on what is left."""
    n = len(x)
    idx = np.sort(rng.choice(n, int(keep * n), replace=False))
    w = 2 * np.pi * np.linspace(band[0], band[1], m)
    t0 = time.perf_counter()
    p = platform.to_host(sp.lombscargle(t[idx], x[idx] - x[idx].mean(),
                                        w))
    wall = time.perf_counter() - t0
    pair = two_peaks(w / (2 * np.pi), p)
    return {"p": p, "pair": pair, "wall_s": wall,
            "checks": {"lombscargle": _resolved(pair)}}


def run(n=SIZES["n"], fs=SIZES["fs"], m=SIZES["m"], band=SIZES["band"],
        keep=SIZES["keep"], emit=print):
    """Both steps at the given sizes, printing the JAX example's lines
    through ``emit``; returns each step's results and ``checks``."""
    rng, t, x = make_signal(n, fs)
    zm = zoom(x, band, m, fs)
    emit(f"zoom_fft     : {zm['pair'][0]:8.3f} / {zm['pair'][1]:8.3f} Hz "
         f"(true {PAIR[0]} / {PAIR[1]}) | {zm['wall_s']:.3f} s")
    ls = lomb(rng, t, x, band, m, keep)
    emit(f"lombscargle  : {ls['pair'][0]:8.3f} / {ls['pair'][1]:8.3f} Hz "
         f"({100 * (1 - keep):.0f}% of samples missing) | "
         f"{ls['wall_s']:.3f} s")
    return {"zoom": zm, "lomb": ls,
            "checks": {**zm["checks"], **ls["checks"]}}


def main(argv=None):
    platform.select_device()
    print(f"device: {platform.device_line()}")
    res = run()
    ok = all(res["checks"].values())
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
