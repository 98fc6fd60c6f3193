#!/usr/bin/env python3
"""Matched-filter pulse detection as a streaming pipeline, on the card.

The twin of ``examples/matched_filter.py`` over the PyTorch/CUDA port
(``veles.simd_tpu_torch``): normalize, then a one-stage compiled
pipeline (``pipeline.matched_filter``, 2047 taps, 2^17-sample blocks,
1M samples, the overlap-save halo carried between blocks), then
``detect_peaks``.  The planted pulse must be found at exactly 424242.

The stage's route comes from the ``convolve`` table at compile
(``overlap_save`` here); its block runs the route's block matmul
(``ops/convolve._conv_os_matmul``), as the JAX stage runs XLA's and
never the Pallas kernel, so no kernel of ``csrc/`` launches.  The
route and the kernel launches of one block (the stage by stage path,
whose launches the counters see) are printed, with the device busy ms
of one fused block (a CUDA graph replay).  Fused against
unfused blocks/s read each block back to the host inside the timed
loop, so they are the stream's rate, not the launch rate.

Run:  python3 examples/matched_filter_torch.py            # the card
      python3 examples/matched_filter_torch.py --no-fuse  # per-op dispatch
      VELES_SIMD_PLATFORM=cpu python3 examples/matched_filter_torch.py

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
from veles.simd_tpu_torch.ops import normalize as nz  # noqa: E402
from veles.simd_tpu_torch.utils import platform  # noqa: E402

# the JAX example's sizes
SIZES = {"n": 1 << 20, "k": 2047, "planted_at": 424242, "block": 1 << 17}


def make_signal(n, k, planted_at, seed=0):
    """``(template, signal)``: a ``k``-tap random template planted at
    ``planted_at`` in ``n`` samples of noise (the JAX example's)."""
    rng = np.random.RandomState(seed)
    template = rng.randn(k).astype(np.float32)
    signal = 0.5 * rng.randn(n).astype(np.float32)
    signal[planted_at:planted_at + k] += template
    return template, signal


def normalize(signal):
    """The signal scaled to [-1, 1] by ``minmax1D`` (NumPy out)."""
    mn, mx = (float(v) for v in nz.minmax1D(signal))
    return ((signal - mn) / (mx - mn) * 2 - 1).astype(np.float32)


def compile_filter(template, block):
    """The matched filter as a one-stage streaming pipeline."""
    return pl.Pipeline([pl.matched_filter(template)],
                       name="matched").compile(block)


def run_stream(cp, signal, block, fused):
    """``(correlation, seconds)``: the signal streamed block by block,
    each block's output read back to the host inside the timed loop;
    the outputs concatenate to the causal one-shot cross-correlation."""
    blocks = [signal[i:i + block] for i in range(0, len(signal), block)]
    out, _ = cp.process(blocks[0], cp.init_state(), fused=fused)
    platform.to_host(out)                      # capture, plans, builds
    state = cp.init_state()
    outs = []
    t0 = time.perf_counter()
    for b in blocks:
        out, state = cp.process(b, state, fused=fused)
        outs.append(platform.to_host(out))
    return np.concatenate(outs), time.perf_counter() - t0


def block_launches(cp, signal, block):
    """Kernel launches of one block through the stage by stage path
    (a fused block is a graph replay, which no counter sees)."""
    with ck.count_launches() as launches:
        platform.to_host(cp.process(signal[:block], cp.init_state(),
                                    fused=False)[0])
    return launches


def busy_ms_a_block(cp, signal, block, fused=True):
    """Device busy ms of one block on the card (CUPTI's records), else
    None."""
    if not platform.on_cuda():
        return None
    from veles.simd_tpu_torch.utils.benchmark import device_busy_ms

    _, state = cp.process(signal[:block], cp.init_state(), fused=fused)
    return device_busy_ms(
        lambda: cp.process(signal[block:2 * block], state, fused=fused),
        calls=10)


def detect(n, k, planted_at, block, fused=True, seed=0):
    """The example's detection step: returns the route, the correlation,
    where the peak and the strongest local maximum say the pulse is,
    the launches of one block and the checks."""
    template, signal = make_signal(n, k, planted_at, seed)
    signal_n = normalize(signal)
    cp = compile_filter(template, block)
    corr, _ = run_stream(cp, signal_n, block, fused)
    # causal grid: the peak lands at the pulse's end, planted_at + k - 1
    found = int(np.argmax(corr)) - (k - 1)
    pos, vals = (platform.to_host(v) for v in dp.detect_peaks(
        corr.astype(np.float32), dp.ExtremumType.MAXIMUM))
    strongest = int(pos[np.argmax(vals)]) - (k - 1)
    return {"cp": cp, "signal_n": signal_n, "corr": corr,
            "route": cp.routes()["matched_filter"], "found": found,
            "strongest": strongest, "blocks": n // block,
            "launches_a_block": block_launches(cp, signal_n, block),
            "checks": {"peak": found == planted_at,
                       "strongest_maximum": strongest == planted_at}}


def compare(cp, signal_n, block):
    """Fused against unfused blocks/s over the same blocks, and the busy
    ms of a fused block on the card."""
    nblk = len(signal_n) // block
    _, t_fused = run_stream(cp, signal_n, block, fused=True)
    _, t_unfused = run_stream(cp, signal_n, block, fused=False)
    return {"fused_blocks_s": nblk / t_fused,
            "unfused_blocks_s": nblk / t_unfused,
            "busy_ms_a_block": busy_ms_a_block(cp, signal_n, block)}


def run(n=SIZES["n"], k=SIZES["k"], planted_at=SIZES["planted_at"],
        block=SIZES["block"], fused=True, emit=print):
    """Every step at the given sizes, printing the JAX example's lines
    through ``emit``; returns the results and ``checks``."""
    res = detect(n, k, planted_at, block, fused)
    emit(f"route: {res['route']}  ({'FUSED' if fused else 'UNFUSED'} "
         f"streaming, {res['blocks']} blocks) | kernel launches a block "
         f"{res['launches_a_block'] or 0}")
    emit(f"planted at {planted_at}, matched filter says {res['found']}")
    emit(f"strongest local maximum at {res['strongest']}")
    res.update(compare(res["cp"], res["signal_n"], block))
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
    print("ok" if ok else f"FAILED {res['checks']}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
