#!/usr/bin/env python3
"""Time the instrumented cores of the op families, telemetry off and on.

    python3 tools/time_torch_ops_obs.py [--root DIR]

The cores of ``arithmetic``, ``mathfun``, ``matrix``, ``normalize``,
``iir`` and the other op families are ``obs.instrumented_jit`` calls,
under the JAX package's core names, so that ``obs.resources()`` has a
row for each.  With telemetry off such a call adds one Python frame and
one flag check; with telemetry on, every call also builds a signature
and looks it up in the resource LRU.  This script times what a user
pays per call for that, on short calls where the host's share of a call
is largest: ``real_multiply`` on 1024 floats, ``sin_psv`` on 1024,
``normalize2D`` on 64 x 64, ``matrix_add`` on 64 x 64 and ``sosfilt``
(butterworth order 4) on 64 x 16,384.

For each call, telemetry off and then on, it runs ``ROUNDS`` rounds,
each timing ``ITERS`` chained calls (CUDA events,
``utils.benchmark.device_time_ms``) three times: with the shipped
cores, with every instrumented core of the five modules replaced by its
bare function (the code path without the wrapper), and with the shipped
cores again (an A/A control), in an order that rotates each round.  It
prints one JSON line per call and telemetry state with each arm's ms,
their medians and each round's shipped-minus-bypassed and
shipped-minus-again µs, then the ``obs.resources()`` keys the calls
left.

``--root DIR`` imports ``veles.simd_tpu_torch`` from the checkout at
DIR (default: this script's).  Prints the card's name and power limit
first.  Exits non-zero without a card.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

SEED = 20261018
ROUNDS, ITERS = 7, 200
MODULES = ("arithmetic", "mathfun", "matrix", "normalize", "iir")
SOS = np.array([[0.0048243434, 0.0096486868, 0.0048243434, 1.0,
                 -1.0485995764, 0.2961403575],
                [1.0, 2.0, 1.0, 1.0, -1.3209134308, 0.6327387929]])


def _calls(ops, cuda):
    """``(name, fn)`` of each timed call."""
    x, y = cuda(1024), cuda(1024)
    a, b = cuda(64, 64), cuda(64, 64)
    xs = cuda(64, 1 << 14)
    return [
        ("real_multiply 1024",
         lambda: ops["arithmetic"].real_multiply(x, y)),
        ("sin_psv 1024", lambda: ops["mathfun"].sin_psv(x)),
        ("normalize2D 64x64", lambda: ops["normalize"].normalize2D(a)),
        ("matrix_add 64x64", lambda: ops["matrix"].matrix_add(a, b)),
        ("sosfilt 64x16384 order 4",
         lambda: ops["iir"].sosfilt(SOS, xs)),
    ]


def _instrumented(mod):
    """``[(container, key, core)]`` of a module's instrumented cores:
    its globals, and the values of its module-level dicts."""
    found = []
    for name, v in vars(mod).items():
        if type(v).__name__ == "InstrumentedJit":
            found.append((vars(mod), name, v))
        elif isinstance(v, dict) and not name.startswith("__"):
            found.extend((v, k, c) for k, c in v.items()
                         if type(c).__name__ == "InstrumentedJit")
    return found


def _use(cores, shipped):
    """Ship the instrumented cores, or bypass them with their bare
    functions."""
    for container, key, core in cores:
        container[key] = core if shipped else core.fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]),
                    help="the checkout whose veles.simd_tpu_torch is "
                    "timed")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import importlib

    import torch

    if not torch.cuda.is_available():
        print("time_torch_ops_obs: no CUDA card", file=sys.stderr)
        return 2
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import smi_line

    ops = {m: importlib.import_module(f"veles.simd_tpu_torch.ops.{m}")
           for m in MODULES}
    root = Path(ops["iir"].__file__).resolve().parents[3]
    print(f"card: {smi_line()}")
    print(f"root: {root}")
    set_config(device="cuda")
    rng = np.random.RandomState(SEED)

    def cuda(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device="cuda")

    cores = [c for m in ops.values() for c in _instrumented(m)]
    calls = _calls(ops, cuda)
    obs.reset()
    for telemetry in (False, True):
        (obs.enable if telemetry else obs.disable)()
        for name, fn in calls:
            on, off, again = [], [], []
            arms = ((True, on), (False, off), (True, again))
            for r in range(ROUNDS):
                k = r % len(arms)
                for shipped, out in arms[k:] + arms[:k]:
                    _use(cores, shipped)
                    out.append(bm.device_time_ms(fn, iters=ITERS))
            _use(cores, True)
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
    obs.disable()
    rows = obs.resources()
    print(json.dumps({"instrumented_cores": len(cores),
                      "resource_rows": len(rows), "keys": sorted(
        {f"{r['op']}/{r['route']}" for r in rows})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
