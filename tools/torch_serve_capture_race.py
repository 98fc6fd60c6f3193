#!/usr/bin/env python3
"""Show what the serving loop's capture gate keeps out, on the card.

    python3 tools/torch_serve_capture_race.py [--trials N]

A pipeline row class captures its CUDA graph at its first batch, inside
``torch.cuda.graph`` (``global`` capture mode).  With two workers, the
other one may be running a plain batch at that moment.  This script
runs ``N`` trials of exactly that: a ``serve.Server(workers=2)`` with
plain ``sosfilt`` requests flowing (lengths that vary, so the caching
allocator keeps asking for memory) while a fresh compiled pipeline
takes its first batch.  It runs them twice, each arm in its own
process: with the server as shipped (``gate``) and with its
``_CaptureGate.exclusive`` replaced by ``shared`` (``no gate``), so the
capture runs beside the plain batches.  One JSON line per arm: the
trials, the tickets answered ``ok`` and otherwise, answers off their
float64 oracle, graphs captured, and the first errors seen.  Prints the
card's name and power limit first.  Exits non-zero without a card, or
when the shipped arm answered anything but ``ok``.
"""

import argparse
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SEED = 20261018
BLOCK, STREAMS, PLAIN_ROUND = 4096, 8, 8
TOL = 2e-5          # of max|y|, the IIR oracle's (tests/test_iir.py)


def trial(serve, pl, iir, rng, errors):
    """One capture beside plain traffic; returns (ok, other, off, graphs)."""
    sos = iir.butterworth(4, 0.25, "lowpass")
    h = rng.randn(65).astype(np.float32)
    cp = pl.Pipeline([pl.sosfilt(sos), pl.fir(h)],
                     name="race").compile(BLOCK)
    ok = other = off = 0
    stop = threading.Event()
    plain = []

    def feeder(srv):
        r = np.random.RandomState(int(rng.randint(1 << 30)))
        while not stop.is_set():
            xs = [r.randn(int(r.randint(200, 6000))).astype(np.float32)
                  for _ in range(PLAIN_ROUND)]
            tks = [srv.submit(serve.Request("sosfilt", x, {"sos": sos}))
                   for x in xs]
            for x, t in zip(xs, tks):
                try:
                    plain.append((x, t.result(timeout=60.0), t))
                except Exception as e:  # noqa: BLE001 — tallied
                    plain.append((x, None, t))
                    errors.append(f"plain: {type(e).__name__}: {e}"[:300])

    with serve.Server(max_batch=STREAMS, max_wait_ms=1.0,
                      workers=2) as srv:
        op = srv.register_pipeline("race", cp)
        t = threading.Thread(target=feeder, args=(srv,))
        t.start()
        try:
            while len(plain) < PLAIN_ROUND:     # plain batches in flight
                threading.Event().wait(0.001)
            x = rng.randn(STREAMS, BLOCK).astype(np.float32)
            tks = [srv.submit(op=op, x=x[i], params={"state": None})
                   for i in range(STREAMS)]
            for i, tk in enumerate(tks):
                try:
                    out, _ = tk.result(timeout=60.0)
                    want = cp.oracle(x[i:i + 1])[0]
                    err = np.max(np.abs(out - want)) / np.max(np.abs(want))
                    off += int(err > TOL)
                except Exception as e:  # noqa: BLE001 — tallied
                    errors.append(f"pipeline: {type(e).__name__}: "
                                  f"{e}"[:300])
                ok += tk.status == "ok"
                other += tk.status != "ok"
        finally:
            stop.set()
            t.join(timeout=120.0)
    for x, y, tk in plain:
        ok += tk.status == "ok"
        other += tk.status != "ok"
        if y is not None:
            want = iir.sosfilt_na(sos, x)
            off += int(np.max(np.abs(y - want)) / np.max(np.abs(want))
                       > TOL)
    return ok, other, off, cp.compile_cache_size()


def arm(gate: bool, trials: int) -> dict:
    import torch

    from veles.simd_tpu_torch import pipeline as pl
    from veles.simd_tpu_torch import serve
    from veles.simd_tpu_torch.ops import iir
    from veles.simd_tpu_torch.serve import server
    from veles.simd_tpu_torch.utils.config import set_config

    set_config(device="cuda")
    if not gate:
        server._CaptureGate.exclusive = server._CaptureGate.shared
    rng = np.random.RandomState(SEED)
    errors, tally = [], {"ok": 0, "other": 0, "off_oracle": 0,
                         "graphs": 0}
    for _ in range(trials):
        ok, other, off, graphs = trial(serve, pl, iir, rng, errors)
        tally["ok"] += ok
        tally["other"] += other
        tally["off_oracle"] += off
        tally["graphs"] += graphs
    torch.cuda.synchronize()
    return {"arm": "gate" if gate else "no gate", "trials": trials,
            **tally, "errors": len(errors),
            "first_errors": sorted(set(errors))[:4]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--arm", choices=("gate", "no-gate"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_capture_race: no CUDA card", file=sys.stderr)
        return 2
    if args.arm:
        print(json.dumps(arm(args.arm == "gate", args.trials)))
        return 0
    from veles.simd_tpu_torch.utils.platform import smi_line

    print(f"card: {smi_line()}")
    rc = 0
    for name in ("gate", "no-gate"):
        # its own process each: a broken capture can leave the context
        # unusable for the rest of the process
        try:
            out = subprocess.run(
                [sys.executable, __file__, "--arm", name, "--trials",
                 str(args.trials)], capture_output=True, text=True,
                timeout=600)
            line = (out.stdout.strip().splitlines() or [""])[-1]
            res = (json.loads(line) if line.startswith("{") else
                   {"arm": name, "rc": out.returncode,
                    "stderr": out.stderr[-1500:]})
        except subprocess.TimeoutExpired:
            res = {"arm": name, "rc": "timeout after 600 s"}
        print(json.dumps(res))
        if name == "gate" and (res.get("other") or res.get("errors")
                               or "ok" not in res):
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
