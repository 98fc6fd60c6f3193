#!/usr/bin/env python3
"""Show what the serving loop's capture gate keeps out, on the card.

    python3 tools/torch_serve_capture_race.py [--trials N] [--servers 2]

A pipeline row class captures its CUDA graph at its first batch, inside
``torch.cuda.graph`` (``global`` capture mode: a ``cudaMalloc`` or a
synchronous copy on any thread of the process breaks it).  With two
workers, the other one may be running a plain batch at that moment;
with ``--servers 2``, a second ``serve.Server`` in the same process
runs the plain batches (two replicas of a thread-mode
``serve.ReplicaGroup``).  This script runs ``N`` trials of exactly
that: plain ``sosfilt`` requests flowing (lengths that vary, so the
caching allocator keeps asking for memory) while a fresh compiled
pipeline takes its first batch.  It runs each arm in its own process:
the server as shipped (``gate``: one gate a process); with
``--servers 2`` also one gate a server (``per-server``: each server
its own ``_CaptureGate``, as before the gate became process-wide);
and ``no gate`` (``_CaptureGate.exclusive`` replaced by ``shared``, so
the capture runs beside the plain batches).  One JSON line per arm:
the trials, the tickets answered ``ok`` and otherwise, answers off
their float64 oracle, graphs captured, and the first errors seen.
Prints the card's name and power limit first.  Exits non-zero without
a card, or when the shipped arm answered anything but ``ok``.
"""

import argparse
import contextlib
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


def trial(serve, pl, iir, rng, errors, servers=1):
    """One capture beside plain traffic, the plain batches on the same
    server or (``servers=2``) on a second one; returns (ok, other, off,
    graphs)."""
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

    with contextlib.ExitStack() as stack:
        srvs = [stack.enter_context(serve.Server(
            max_batch=STREAMS, max_wait_ms=1.0, workers=2))
            for _ in range(servers)]
        # the pipeline on the first server, the plain traffic on the
        # last (the same one when there is one)
        srv, plain_srv = srvs[0], srvs[-1]
        op = srv.register_pipeline("race", cp)
        t = threading.Thread(target=feeder, args=(plain_srv,))
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


def arm(name: str, trials: int, servers: int) -> dict:
    import torch

    from veles.simd_tpu_torch import pipeline as pl
    from veles.simd_tpu_torch import serve
    from veles.simd_tpu_torch.ops import iir
    from veles.simd_tpu_torch.serve import server
    from veles.simd_tpu_torch.utils.config import set_config

    set_config(device="cuda")
    if name == "no-gate":
        server._CaptureGate.exclusive = server._CaptureGate.shared
    elif name == "per-server":
        init = server.Server.__init__

        def own_gate(self, *args, **kwargs):
            init(self, *args, **kwargs)
            self._gate = server._CaptureGate()

        server.Server.__init__ = own_gate
    rng = np.random.RandomState(SEED)
    errors, tally = [], {"ok": 0, "other": 0, "off_oracle": 0,
                         "graphs": 0}
    for _ in range(trials):
        ok, other, off, graphs = trial(serve, pl, iir, rng, errors,
                                       servers)
        tally["ok"] += ok
        tally["other"] += other
        tally["off_oracle"] += off
        tally["graphs"] += graphs
    torch.cuda.synchronize()
    return {"arm": name, "servers": servers, "trials": trials,
            **tally, "errors": len(errors),
            "first_errors": sorted(set(errors))[:4]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--servers", type=int, choices=(1, 2), default=1)
    ap.add_argument("--arm", choices=("gate", "per-server", "no-gate"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_capture_race: no CUDA card", file=sys.stderr)
        return 2
    if args.arm:
        print(json.dumps(arm(args.arm, args.trials, args.servers)))
        return 0
    from veles.simd_tpu_torch.utils.platform import smi_line

    print(f"card: {smi_line()}")
    rc = 0
    arms = (("gate", "per-server", "no-gate") if args.servers == 2
            else ("gate", "no-gate"))
    for name in arms:
        # its own process each: a broken capture can leave the context
        # unusable for the rest of the process
        try:
            out = subprocess.run(
                [sys.executable, __file__, "--arm", name, "--trials",
                 str(args.trials), "--servers", str(args.servers)],
                capture_output=True, text=True,
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
