#!/usr/bin/env python3
"""Always-on sensor conditioning as a compiled streaming pipeline, on
the card.

The twin of ``examples/sensor_pipeline.py`` over the PyTorch/CUDA port
(``veles.simd_tpu_torch``): despike (``medfilt`` 5, halo carried) ->
block detrend -> causal 50 Hz notch (``sosfilt``, ``zi`` carried) ->
per-block Welch PSD -> dB -> Savitzky-Golay smooth, on 4096-sample
blocks of a 2^15-sample trace, then the resonances read off the
averaged smoothed spectrum with ``detect_peaks_fixed``.  It must find
the two resonances (137 and 310 Hz) and show the 50 Hz hum at least
20 dB below the strongest of them.

None of the port's five CUDA kernels is on this chain: the notch runs
the IIR doubling scan, the Welch frames stay under the STFT kernel's
64-frame gate.  The kernel launches of one block (stage by stage) are
printed all the same, with the device busy ms of one fused block (a
CUDA graph replay).  Fused against unfused blocks/s read each block
back to the host inside the timed loop.

Run:  python3 examples/sensor_pipeline_torch.py            # the card
      python3 examples/sensor_pipeline_torch.py --no-fuse  # per-op dispatch
      VELES_SIMD_PLATFORM=cpu python3 examples/sensor_pipeline_torch.py

Without a card and without ``VELES_SIMD_PLATFORM=cpu`` it exits 2.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))

from veles.simd_tpu_torch import pipeline as pl  # noqa: E402
from veles.simd_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from veles.simd_tpu_torch.ops import detect_peaks as dp  # noqa: E402
from veles.simd_tpu_torch.ops import iir  # noqa: E402
from veles.simd_tpu_torch.utils import platform  # noqa: E402

FS = 2000.0
NPERSEG = 1024
RESONANCES = (137.0, 310.0)
# the JAX example's sizes
SIZES = {"n": 1 << 15, "block": 4096}


def make_signal(n, seed=7):
    """The JAX example's trace: two resonances, mains hum, drift,
    noise and 60 dropouts."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / FS
    x = sum(a * np.sin(2 * np.pi * f0 * t)
            for a, f0 in zip((1.0, 0.6), RESONANCES))
    x = x + 1.5 * np.sin(2 * np.pi * 50.0 * t)       # mains hum
    x = x + 0.4 * t / t[-1] + 0.2                    # baseline drift
    x = x + 0.05 * rng.randn(n)                      # sensor noise
    spikes = rng.choice(n, 60, replace=False)
    x[spikes] = 30.0 * np.sign(rng.randn(60))        # dropouts
    return x.astype(np.float32)


def make_chain():
    """The six-stage chain, as the JAX example declares it."""
    notch = iir.butterworth(4, (44 / (FS / 2), 56 / (FS / 2)),
                            "bandstop")
    return pl.Pipeline(
        [pl.medfilt(5), pl.detrend("linear"), pl.sosfilt(notch),
         pl.welch(fs=FS, nperseg=NPERSEG), pl.power_db(),
         pl.savgol(7, 2)],
        name="sensor")


def run_stream(cp, x, block, fused):
    """``(smoothed dB rows, seconds)``, each block's row read back to
    the host inside the timed loop."""
    blocks = [x[i:i + block] for i in range(0, len(x), block)]
    out, _ = cp.process(blocks[0], cp.init_state(), fused=fused)
    platform.to_host(out)                      # capture, plans
    state = cp.init_state()
    rows = []
    t0 = time.perf_counter()
    for b in blocks:
        out, state = cp.process(b, state, fused=fused)
        rows.append(platform.to_host(out))
    return np.stack(rows), time.perf_counter() - t0


def resonances(rows):
    """The monitor's read-off: the first block skipped (transients), the
    smoothed dB rows averaged; returns ``(spectrum, peaks found within
    12 dB of the top in Hz, hum level below the top in dB)``."""
    smooth = rows[1:].mean(axis=0).astype(np.float32)
    freqs = np.fft.rfftfreq(NPERSEG, 1.0 / FS)
    pos, vals, count = (platform.to_host(v) for v in
                        dp.detect_peaks_fixed(smooth, dp.ExtremumType.MAXIMUM,
                                              max_peaks=64))
    count = int(count)
    found = sorted(float(freqs[p]) for p, v in zip(pos[:count],
                                                    vals[:count])
                   if v > smooth.max() - 12.0)
    hum_bin = int(round(50.0 / (FS / NPERSEG)))
    return smooth, found, float(smooth[hum_bin] - smooth.max())


def condition(n, block, fused=True):
    """The conditioning step: the chain over the trace, the resonances,
    the hum, the launches of one block and the checks."""
    x = make_signal(n)
    cp = make_chain().compile(block)
    rows, _ = run_stream(cp, x, block, fused)
    smooth, found, hum_db = resonances(rows)
    with ck.count_launches() as launches:
        platform.to_host(cp.process(x[:block], cp.init_state(),
                                    fused=False)[0])
    return {"cp": cp, "x": x, "rows": rows, "smooth": smooth,
            "found": found, "hum_db": hum_db,
            "chain": [s["stage"] for s in cp.describe()["stages"]],
            "routes": cp.routes(), "launches_a_block": launches,
            "checks": {
                "two_resonances": len(found) == 2 and all(
                    abs(g - want) < FS / NPERSEG + 1e-9
                    for g, want in zip(found, RESONANCES)),
                "hum_20db_down": hum_db < -20.0}}


def compare(cp, x, block):
    """Fused against unfused blocks/s over the same blocks, and the busy
    ms of a fused block on the card (else None)."""
    nblk = len(x) // block
    _, t_fused = run_stream(cp, x, block, fused=True)
    _, t_unfused = run_stream(cp, x, block, fused=False)
    busy = None
    if platform.on_cuda():
        from veles.simd_tpu_torch.utils.benchmark import device_busy_ms

        _, state = cp.process(x[:block], cp.init_state())
        busy = device_busy_ms(
            lambda: cp.process(x[block:2 * block], state), calls=10)
    return {"fused_blocks_s": nblk / t_fused,
            "unfused_blocks_s": nblk / t_unfused, "busy_ms_a_block": busy}


def run(n=SIZES["n"], block=SIZES["block"], fused=True, emit=print):
    """Every step at the given sizes, printing the JAX example's lines
    through ``emit``; returns the results and ``checks``."""
    res = condition(n, block, fused)
    emit(f"chain: {' -> '.join(res['chain'])}")
    mode = ("FUSED (one graph replay/block)" if fused
            else "UNFUSED (one dispatch/stage)")
    emit(f"mode: {mode} | routes {res['routes']} | kernel launches a "
         f"block {res['launches_a_block'] or 0}")
    emit(f"resonances found: {[f'{v:.0f} Hz' for v in res['found']]}")
    emit(f"hum suppression: {res['hum_db']:.0f} dB below the strongest "
         "resonance")
    res.update(compare(res["cp"], res["x"], block))
    busy = res["busy_ms_a_block"]
    emit(f"fused   : {res['fused_blocks_s']:8.1f} blocks/s "
         f"(busy {'not measured' if busy is None else f'{busy:.4f} ms'}"
         " a block)")
    emit(f"unfused : {res['unfused_blocks_s']:8.1f} blocks/s (fused is "
         f"{res['fused_blocks_s'] / res['unfused_blocks_s']:.2f}x)")
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    platform.select_device()
    print(f"device: {platform.device_line()}")
    res = run(fused="--no-fuse" not in argv)
    ok = all(res["checks"].values())
    print("OK" if ok else f"FAILED {res['checks']}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
