#!/usr/bin/env python3
"""Attenuation-driven FIR design on the card: spec -> kaiserord ->
filter -> verify.

The twin of ``examples/kaiser_design.py`` over the PyTorch/CUDA port:

1. ``filters.kaiserord`` sizes the filter from a 60 dB spec and a 0.05
   transition width;
2. ``filters.firwin`` designs it with the ``("kaiser", beta)`` window;
3. ``iir.frequency_response`` confirms the stopband;
4. ``convolve.oaconvolve(mode="same")`` applies it to 2^17 samples of
   a two-tone signal;
5. the Kaiser-windowed ``spectral.welch`` shows the 2500 Hz tone down
   by 60 dB or more and the 440 Hz tone changed by less than 1 dB.

The filtering step's kernel launches are printed: the 147 taps of
this spec sit under the overlap-save kernel's 256-tap gate, so the
``convolve`` family routes the call off the kernels of ``csrc/``.

Run:  python3 examples/kaiser_design_torch.py            # the card
      VELES_SIMD_PLATFORM=cpu python3 examples/kaiser_design_torch.py

Without a card and without ``VELES_SIMD_PLATFORM=cpu`` it exits 2.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))

from veles.simd_tpu_torch.ops import convolve as cv  # noqa: E402
from veles.simd_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from veles.simd_tpu_torch.ops import filters as fl  # noqa: E402
from veles.simd_tpu_torch.ops import iir  # noqa: E402
from veles.simd_tpu_torch.ops import spectral as sp  # noqa: E402
from veles.simd_tpu_torch.utils import platform  # noqa: E402

FS = 8000.0
# the JAX example's sizes
SIZES = {"atten_db": 60.0, "width": 0.05, "cutoff": 0.25, "n": 1 << 17,
         "nperseg": 2048}


def design(atten_db, width, cutoff):
    """Size and design the filter, then its worst stopband rejection."""
    numtaps, beta = fl.kaiserord(atten_db, width)
    taps = platform.to_host(fl.firwin(numtaps, cutoff,
                                      window=("kaiser", beta)))
    w, h = (platform.to_host(v) for v in iir.frequency_response(
        taps, [1.0], n_points=2048))
    mag_db = 20 * np.log10(np.maximum(np.abs(h), 1e-12))
    worst = float(mag_db[w >= cutoff + width].max())
    return {"numtaps": int(numtaps), "beta": float(beta), "taps": taps,
            "worst_db": worst,
            "checks": {"stopband_meets_spec": worst <= -atten_db + 1.0}}


def make_signal(n, seed=5):
    """A 440 Hz passband tone, a 2500 Hz stopband tone and a little
    noise."""
    t = np.arange(n) / FS
    return (np.sin(2 * np.pi * 440.0 * t) + np.sin(2 * np.pi * 2500.0 * t)
            + 0.01 * np.random.RandomState(seed).randn(n)).astype(
                np.float32)


def apply_and_verify(taps, n, nperseg, atten_db):
    """The filter over the signal, then the two tones' change in the
    Kaiser-windowed Welch PSD."""
    x = make_signal(n)
    with ck.count_launches() as launches:
        y = platform.to_host(cv.oaconvolve(x, taps.astype(np.float32),
                                           mode="same", simd=True))
    f, p_in = (platform.to_host(v) for v in sp.welch(
        x, fs=FS, nperseg=nperseg, window=("kaiser", 8.0), simd=True))
    _, p_out = (platform.to_host(v) for v in sp.welch(
        y, fs=FS, nperseg=nperseg, window=("kaiser", 8.0), simd=True))
    b440 = np.argmin(np.abs(f - 440.0))
    b2500 = np.argmin(np.abs(f - 2500.0))
    keep = float(10 * np.log10(p_out[b440] / p_in[b440]))
    kill = float(10 * np.log10(p_out[b2500] / p_in[b2500]))
    return {"y": y, "p_in": p_in, "p_out": p_out, "keep_db": keep,
            "kill_db": kill, "launches": launches,
            "checks": {"passband_kept": abs(keep) < 1.0,
                       "stopband_killed": kill < -atten_db}}


def run(atten_db=SIZES["atten_db"], width=SIZES["width"],
        cutoff=SIZES["cutoff"], n=SIZES["n"], nperseg=SIZES["nperseg"],
        emit=print):
    """Every step at the given sizes, printing the JAX example's lines
    through ``emit``; returns each step's results and ``checks``."""
    d = design(atten_db, width, cutoff)
    emit(f"spec {atten_db:.0f} dB / width {width} -> {d['numtaps']} taps, "
         f"beta {d['beta']:.3f}")
    emit(f"worst stopband rejection: {d['worst_db']:.1f} dB")
    a = apply_and_verify(d["taps"], n, nperseg, atten_db)
    emit(f"oaconvolve {n} x {d['numtaps']} (same): launches "
         f"{a['launches'] or 0}")
    emit(f"440 Hz tone change: {a['keep_db']:+.2f} dB (want ~0)")
    emit(f"2500 Hz tone change: {a['kill_db']:+.1f} dB (want <= "
         f"-{atten_db:.0f})")
    return {"design": d, "apply": a,
            "checks": {**d["checks"], **a["checks"]}}


def main(argv=None):
    platform.select_device()
    print(f"device: {platform.device_line()}")
    res = run()
    ok = all(res["checks"].values())
    print("OK" if ok else f"FAILED {res['checks']}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
