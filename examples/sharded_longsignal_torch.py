#!/usr/bin/env python3
"""Sequence-parallel convolution of a long signal over a mesh of the card.

The twin of ``examples/sharded_longsignal.py`` over the PyTorch/CUDA
port (``veles.simd_tpu_torch.parallel``).  The mesh is 8 shards of the
configured device (``cuda:0`` on the card, ``cpu`` when asked; the JAX
example's 8 virtual CPU devices):

* ``sharded_convolve`` of 2^22 samples with 255 taps over an 8-shard
  ``sp`` mesh (each shard's halo from its left neighbour), with the
  JAX example's 64 spot checks against float64 dot products;
* ``sharded_convolve_batch`` of 5 x 2^16 over ``dp=2 x sp=4`` (batch 5
  is not divisible by dp: the layer pads and slices);
* ``sharded_swt`` -> ``sharded_swt_reconstruct``, daub8 over 3 levels
  on 2^20 samples, within 1e-3.

On one card the shards share the card, so the mesh costs more than
the single-card op: it shows the plumbing, not a speed-up.  Each
step's kernel launches are printed: each shard holds one row, under
the filter-bank kernel's 8-row gate, so no kernel of ``csrc/``
launches.

Run:  python3 examples/sharded_longsignal_torch.py            # the card
      VELES_SIMD_PLATFORM=cpu python3 examples/sharded_longsignal_torch.py

Without a card and without ``VELES_SIMD_PLATFORM=cpu`` it exits 2.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))

from veles.simd_tpu_torch import parallel as par  # noqa: E402
from veles.simd_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from veles.simd_tpu_torch.utils import platform  # noqa: E402

# the JAX example's sizes
SIZES = {"n": 1 << 22, "k": 255, "spots": 64, "batch": 5,
         "batch_n": 1 << 16, "swt_n": 1 << 20, "swt_levels": 3}


def _counted(fn):
    """``(fn()'s result on the host, the kernel launches it made)``."""
    with ck.count_launches() as launches:
        out = platform.to_host(fn())
    return out, launches


def make_inputs(n, k, seed=0):
    """``(rng, x, h)``; the rng goes on to the spot checks and the
    batch, as in the JAX example."""
    rng = np.random.RandomState(seed)
    return (rng, rng.randn(n).astype(np.float32),
            rng.randn(k).astype(np.float32))


def convolve_long(rng, x, h, spots):
    """``sharded_convolve`` over an 8-shard ``sp`` mesh, spot-checked
    against float64 dot products."""
    mesh = par.make_mesh({"sp": 8})
    n, k = len(x), len(h)
    y, launches = _counted(lambda: par.sharded_convolve(x, h, mesh,
                                                        axis="sp"))
    bad = []
    for i in rng.randint(k, n - k, spots):
        want = float(np.dot(x[i - k + 1:i + 1].astype(np.float64),
                            h[::-1].astype(np.float64)))
        if not abs(y[i] - want) < 1e-2 * max(1.0, abs(want)):
            bad.append(int(i))
    return {"y": y, "launches": launches, "shards": mesh.size,
            "bad_spots": bad, "checks": {"spot_checks": not bad}}


def convolve_batch(rng, h, batch, batch_n):
    """``sharded_convolve_batch`` of ``batch`` rows over ``dp=2 x
    sp=4``; row 0 against ``np.convolve``."""
    mesh = par.make_mesh({"dp": 2, "sp": 4})
    xb = rng.randn(batch, batch_n).astype(np.float32)
    yb, launches = _counted(lambda: par.sharded_convolve_batch(
        platform.to_device(xb), platform.to_device(h), mesh))
    ref0 = np.convolve(xb[0], h)
    err = float(np.max(np.abs(yb[0] - ref0)) / np.max(np.abs(ref0)))
    return {"xb": xb, "yb": yb, "err": err, "launches": launches,
            "checks": {"batch_row0": err < 1e-3}}


def swt_round_trip(x, levels):
    """The sharded a-trous analysis, then the sharded synthesis, over
    an 8-shard ``sp`` mesh: the signal never leaves the mesh."""
    mesh = par.make_mesh({"sp": 8})
    with ck.count_launches() as analysis:
        bands = par.sharded_swt("daub", 8, levels, x, mesh, axis="sp")
    rec, synthesis = _counted(lambda: par.sharded_swt_reconstruct(
        "daub", 8, levels, bands, mesh, axis="sp"))
    err = float(np.max(np.abs(rec - x)))
    return {"rec": rec, "err": err,
            "launches": {"analysis": analysis, "synthesis": synthesis},
            "checks": {"swt_round_trip": err < 1e-3}}


def run(n=SIZES["n"], k=SIZES["k"], spots=SIZES["spots"],
        batch=SIZES["batch"], batch_n=SIZES["batch_n"],
        swt_n=SIZES["swt_n"], swt_levels=SIZES["swt_levels"], emit=print):
    """Every step at the given sizes, printing the JAX example's lines
    through ``emit``; returns each step's results and ``checks``."""
    rng, x, h = make_inputs(n, k)
    cl = convolve_long(rng, x, h, spots)
    emit(f"sharded convolve: {n} samples over {cl['shards']} shards -> "
         f"{cl['y'].shape[-1]} output samples | launches "
         f"{cl['launches'] or 0}")
    emit("spot-check vs oracle: "
         + ("ok" if not cl["bad_spots"] else f"FAILED {cl['bad_spots']}"))
    cb = convolve_batch(rng, h, batch, batch_n)
    emit(f"dp x sp batch: {cb['yb'].shape} rel err {cb['err']:.1e} | "
         f"launches {cb['launches'] or 0}")
    sw = swt_round_trip(x[:swt_n], swt_levels)
    emit(f"sharded SWT L{swt_levels} analysis -> synthesis round trip "
         f"over 8 shards: max|err| {sw['err']:.1e} | launches "
         f"{sw['launches']}")
    return {"convolve": cl, "batch": cb, "swt": sw,
            "checks": {**cl["checks"], **cb["checks"], **sw["checks"]}}


def main(argv=None):
    platform.select_device()
    print(f"device: {platform.device_line()}")
    res = run()
    ok = all(res["checks"].values())
    print("ok" if ok else f"FAILED {res['checks']}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
