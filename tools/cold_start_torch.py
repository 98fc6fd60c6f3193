#!/usr/bin/env python3
"""Cold-start bench of the port: process birth to first served request,
from the warm pack against cold.

The port's twin of ``tools/cold_start.py``.  Fresh SUBPROCESS children
(a fresh interpreter, CUDA context and an empty kernel build root,
``$VELES_SIMD_CACHE_DIR``) run the same body (:func:`child_main`):
start a ``serve.Server``, register the cold-start pipeline and answer
one request per serving shape class (:func:`serve_param_sets`; the
``stft`` class, 16,384 samples at 512/128, is one K4 launch), each
answer held to its NumPy oracle.  The parent clocks each child from
``Popen`` to its report line:

* **cold** — ``VELES_SIMD_ARTIFACTS=off``: nvcc builds the kernel
  library before the first kernel launch;
* **warm** — ``VELES_SIMD_ARTIFACTS=readonly`` with the pack
  ``tools/warm_pack_torch.py`` built: ``Server.start()`` places the
  library under the build root and no nvcc runs.

The arms run in turns (cold, warm, warm, cold a round, ``--rounds``).
Writes ``COLD_START_DETAILS_torch.json`` in BENCH_DETAILS row format:
the headline row's value is the speedup (the fastest cold child over
the fastest warm one), with the warm child's ``artifact_*`` and
``compile.*`` counters as its evidence; the gate is warm <= 50 % of
cold (``--min-speedup 2``).  Each child's line names the card and its
power limit.

Run:  python3 tools/cold_start_torch.py [--rounds 1] [--pack DIR]
      [--reuse-pack] [--min-speedup 2] [--details FILE]
      (bench_torch.py runs it as its cold-start config)

It runs on the card only (the warm pack holds the CUDA kernel library;
``VELES_SIMD_PLATFORM=cpu`` exits 2, as does a process without a
card).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_DETAILS = "COLD_START_DETAILS_torch.json"
DEFAULT_PACK = "warm_pack_torch"
MIN_SPEEDUP = 2.0
REPORT_TAG = "COLD_START_REPORT "
# each served answer against its NumPy oracle, of max|y| (the serve
# family's bound in tools/tpu_smoke_torch.py)
ANSWER_TOL = 2e-3

# the cold-start pipeline: a conditioning chain compiled at this block
# size and registered under this name
PIPELINE_NAME = "coldline"
PIPELINE_BLOCK = 2048


def serve_param_sets():
    """``[(op, length, params), ...]`` — the serving classes a cold
    start replays (the JAX tools' set: lengths are pow2 bucket sizes,
    parameters deterministic)."""
    import numpy as np

    from veles.simd_tpu_torch.ops import iir

    sos = iir.butterworth(6, 0.2, "lowpass")
    return [
        ("sosfilt", 4096, {"sos": np.asarray(sos)}),
        ("lfilter", 4096, {"b": [1.0, 0.5], "a": [1.0, -0.3]}),
        ("resample_poly", 4096, {"up": 160, "down": 147}),
        ("stft", 16384, {"frame_length": 512, "hop": 128}),
    ]


def build_pipeline():
    """The cold-start pipeline chain (deterministic)."""
    from veles.simd_tpu_torch import pipeline as pl
    from veles.simd_tpu_torch.ops import iir

    notch = iir.butterworth(4, (44 / 1000.0, 56 / 1000.0), "bandstop")
    chain = pl.Pipeline(
        [pl.sosfilt(notch), pl.stft(256, 64), pl.power()],
        name=PIPELINE_NAME)
    return chain.compile(PIPELINE_BLOCK)


# ---------------------------------------------------------------------------
# the child body (--child): one fresh serving process, either mode
# ---------------------------------------------------------------------------


def _oracle(op: str, x, params: dict):
    import numpy as np

    from veles.simd_tpu_torch.serve.server import _OPS, _oracle_call

    canonical, _ = _OPS[op][0](params, int(x.shape[0]))
    return np.asarray(_oracle_call(op, x[None, :], canonical))[0]


def child_main() -> int:
    t_birth = time.perf_counter()
    import numpy as np

    from veles.simd_tpu_torch import obs, serve
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.runtime import artifacts
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import requested_device

    # the parent probed the card; a child pays no second probe
    set_config(device=requested_device())
    root = artifacts.enable_persistent_compile_cache()
    obs.enable()
    per_op, errs = {}, {}
    ck.reset_launches()
    with serve.Server(max_batch=4, max_wait_ms=1.0, workers=2,
                      obs_port=-1) as srv:
        pipe_op = srv.register_pipeline(PIPELINE_NAME, build_pipeline())
        t_ready = time.perf_counter()
        rng = np.random.RandomState(7)
        for op, n, params in serve_param_sets():
            x = rng.randn(n).astype(np.float32)
            t0 = time.perf_counter()
            got = srv.submit(op=op, x=x, params=params).result(
                timeout=600.0)
            per_op[op] = time.perf_counter() - t0
            want = _oracle(op, x, params)
            errs[op] = float(np.max(np.abs(np.asarray(got) - want))
                             / (np.max(np.abs(want)) or 1.0))
        t0 = time.perf_counter()
        srv.submit(op=pipe_op,
                   x=rng.randn(PIPELINE_BLOCK).astype(np.float32),
                   params={"state": None}).result(timeout=600.0)
        per_op["pipeline"] = time.perf_counter() - t0
        preload = srv.stats().get("artifact_preload")
    t_done = time.perf_counter()
    snap = obs.snapshot()
    counters: dict = {}
    for c in snap["counters"]:       # sum across label sets per name
        if c["name"].startswith(("artifact_", "compile.")):
            counters[c["name"]] = counters.get(c["name"], 0) \
                + c["value"]
    report = {
        "mode": artifacts.artifacts_mode(),
        "birth_to_first_s": t_done - t_birth,
        "ready_s": t_ready - t_birth,
        "requests_s": t_done - t_ready,
        "per_op_s": {k: round(v, 4) for k, v in per_op.items()},
        "rel_err": errs,
        "launches": dict(ck.LAUNCHES),
        # the nvcc build and the pipeline's graph captures
        "compile_s": sum(h["sum"] for h in snap["histograms"]
                         if h["name"] == "compile.backend_compile_secs"),
        "build_root": root,
        "preload": preload,
        "counters": counters,
        "artifact_store": artifacts.store().info(),
    }
    print(REPORT_TAG + json.dumps(report, default=str), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the parent: build the pack, spawn and clock the children, gate
# ---------------------------------------------------------------------------


def _run_child(extra_env: dict, timeout_s: float) -> dict:
    """Spawn one fresh child; its report with the parent-clocked wall
    time (``wall_s``: Popen to the report line, interpreter, imports,
    CUDA context and server start included)."""
    env = dict(os.environ)
    env.update({k: str(v) for k, v in extra_env.items()})
    env.pop("VELES_SIMD_TELEMETRY", None)   # the child enables its own
    cmd = [sys.executable, os.path.abspath(__file__), "--child"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=ROOT)
    report, tail = None, []
    try:
        for line in proc.stdout:
            if line.startswith(REPORT_TAG):
                report = json.loads(line[len(REPORT_TAG):])
                report["wall_s"] = time.perf_counter() - t0
            else:
                tail = (tail + [line])[-40:]
        proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        pass
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if report is None or proc.returncode != 0:
        raise RuntimeError(f"cold-start child failed (rc="
                           f"{proc.returncode}):\n{''.join(tail)[-3000:]}")
    return report


def build_pack(pack: str, timeout_s: float) -> None:
    """Build the warm pack in a subprocess (``tools/warm_pack_torch.py``,
    as a deployment builds it)."""
    cmd = [sys.executable, os.path.join(ROOT, "tools",
                                        "warm_pack_torch.py"),
           "--dir", pack]
    proc = subprocess.run(cmd, timeout=timeout_s, capture_output=True,
                          text=True, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"warm_pack_torch failed (rc="
                           f"{proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")


def _check_child(arm: str, got: dict) -> None:
    """A cold child built the library with nvcc (a library cache miss;
    ``compile.backend_compile`` also counts graph captures), a warm one
    found it placed; each served its classes right, K4 answering the
    stft request."""
    built = got["counters"].get("compile.cache_misses", 0) > 0
    bad = [op for op, e in got["rel_err"].items() if not e <= ANSWER_TOL]
    if built != (arm == "cold") or bad \
            or got["launches"].get("stft", 0) < 1:
        raise RuntimeError(f"cold-start {arm} child: nvcc ran {built}, "
                           f"answers over {ANSWER_TOL:.0e} {bad}, "
                           f"launches {got['launches']}")


def run(args) -> tuple:
    """Build (or reuse) the pack, clock the children in turns, build
    the BENCH_DETAILS-format rows.  Returns ``(rows, evidence)``."""
    from veles.simd_tpu_torch.utils.platform import smi_line

    smi = smi_line()
    pack = os.path.abspath(args.pack)
    if not (args.reuse_pack
            and os.path.exists(os.path.join(pack, "MANIFEST.json"))):
        print(f"building warm pack at {pack} ...", flush=True)
        build_pack(pack, args.timeout)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="cold-start-",
                            dir=os.path.join(ROOT, "build"))
    children = {"cold": [], "warm": []}
    try:
        for r in range(max(1, int(args.rounds))):
            for i, arm in enumerate(("cold", "warm", "warm", "cold")):
                env = {"VELES_SIMD_ARTIFACTS": ("off" if arm == "cold"
                                                else "readonly"),
                       "VELES_SIMD_ARTIFACT_DIR": (pack if arm == "warm"
                                                   else ""),
                       "VELES_SIMD_CACHE_DIR": os.path.join(
                           work, f"root-{r}-{i}")}
                got = _run_child(env, args.timeout)
                _check_child(arm, got)
                children[arm].append(got)
                print(f"{arm}: birth to first served request "
                      f"{got['wall_s']:.3f} s (ready {got['ready_s']:.3f}"
                      f" s in the child) | nvcc and graph captures "
                      f"{got['compile_s']:.3f} s | "
                      f"per op {got['per_op_s']} | preload "
                      f"{got['preload']} | K4 x "
                      f"{got['launches'].get('stft', 0)} | card {smi}",
                      flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cold = min(children["cold"], key=lambda c: c["wall_s"])
    warm = min(children["warm"], key=lambda c: c["wall_s"])
    speedup = cold["wall_s"] / warm["wall_s"] if warm["wall_s"] else 0.0
    warm_counters = warm.get("counters", {})
    evidence = {
        "pack": pack,
        "card": smi,
        "cold": cold,
        "warm": warm,
        "cold_s": [c["wall_s"] for c in children["cold"]],
        "warm_s": [c["wall_s"] for c in children["warm"]],
        "speedup": speedup,
        "warm_fraction_of_cold": (warm["wall_s"] / cold["wall_s"]
                                  if cold["wall_s"] else None),
    }
    rows = [
        {"metric": "cold start warm-pack speedup",
         "value": round(speedup, 3), "unit": "x",
         "vs_baseline": None,
         "telemetry": {
             "artifact_counters": {
                 k: v for k, v in warm_counters.items()
                 if k.startswith("artifact_")},
             "compile_counters": {
                 k: v for k, v in warm_counters.items()
                 if k.startswith("compile.")},
             "artifact_store": warm.get("artifact_store"),
             "preload": warm.get("preload"),
             "cold_wall_s": round(cold["wall_s"], 3),
             "warm_wall_s": round(warm["wall_s"], 3),
             "cold_compile_s": round(cold["compile_s"], 3),
             "card": smi,
         }},
        {"metric": "cold start warm first request",
         "value": round(1.0 / warm["wall_s"], 4), "unit": "1/s",
         "vs_baseline": None},
        {"metric": "cold start cold first request",
         "value": round(1.0 / cold["wall_s"], 4), "unit": "1/s",
         "vs_baseline": None},
    ]
    return rows, evidence


def gate(rows, evidence, min_speedup: float) -> list:
    """The reasons the run fails: no artifact hit in the warm child (the
    pack did not cover the request set), or a speedup under
    ``min_speedup`` (0 reports only)."""
    hits = sum(v for k, v in rows[0]["telemetry"]
               ["artifact_counters"].items()
               if k.startswith("artifact_hit"))
    bad = []
    if hits == 0:
        bad.append("the warm child recorded zero artifact hits")
    if min_speedup and evidence["speedup"] < min_speedup:
        bad.append(f"speedup x{evidence['speedup']:.2f} < "
                   f"x{min_speedup:.2f} (warm above "
                   f"{100 / min_speedup:.0f}% of cold)")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--details", default=DEFAULT_DETAILS,
                    help=f"row output (default {DEFAULT_DETAILS})")
    ap.add_argument("--pack", default=DEFAULT_PACK,
                    help=f"warm-pack directory (default {DEFAULT_PACK}/)")
    ap.add_argument("--reuse-pack", action="store_true",
                    help="skip the pack build when one exists")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of cold, warm, warm, cold children")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="per-subprocess budget, seconds")
    ap.add_argument("--min-speedup", type=float, default=MIN_SPEEDUP,
                    help="rc=1 when cold/warm falls below this (0 = "
                         "report only; 2 is warm <= 50%% of cold)")
    args = ap.parse_args(argv)
    if args.child:
        return child_main()
    from veles.simd_tpu_torch.utils.platform import select_device

    if select_device() != "cuda":
        print("cold_start_torch: the warm pack holds the CUDA kernel "
              "library; a CPU process has no cold start to measure",
              file=sys.stderr)
        return 2
    rows, evidence = run(args)
    with open(args.details, "w") as f:
        json.dump(rows + [{"cold_start_evidence": evidence}], f,
                  indent=2)
    print(f"\ncold {evidence['cold']['wall_s']:.2f}s -> warm "
          f"{evidence['warm']['wall_s']:.2f}s  speedup "
          f"x{evidence['speedup']:.2f} (warm = "
          f"{100 * evidence['warm_fraction_of_cold']:.0f}% of cold) | "
          f"card {evidence['card']}")
    print(f"rows -> {args.details}  (gate: python3 "
          f"tools/bench_regress.py --details {args.details})")
    bad = gate(rows, evidence, args.min_speedup)
    for reason in bad:
        print(f"COLD-START-FAIL: {reason}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
