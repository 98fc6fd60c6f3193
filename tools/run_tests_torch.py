#!/usr/bin/env python
"""Test runner of the port — the twin of ``tools/run_tests.py`` over
``tests/test_torch_*.py``.

Each suite runs in its own child under a per-suite timeout, with its
peak RSS reported, its junit XML written (``test_results_<suite>.xml``)
and its output appended to ``tests_torch.log``; the run fails if any
suite fails (the ``[FAILED]`` gate).  Each child also runs under the
stdlib line tracer of ``tools/linecov_torch.py`` over
``veles/simd_tpu_torch/``: the merged per-module table lands in the
log, the merged lines in ``tests_torch_coverage.json`` (repo-relative
paths), and the aggregates over the port's ``obs/`` and ``serve/``
are gated by floors (``linecov_torch.DEFAULT_FLOORS``).
``--no-coverage`` restores the untraced (faster) run; the floors are
then skipped.  ``--out-dir DIR`` puts the log, the XML and the
coverage JSON in DIR instead of the repo root (where ``.gitignore``
lists them).

``--cuda`` is the card's report, with no floor: it runs the card
suite (``--noconftest -m cuda tests/test_torch_cuda.py``, with the
card cases of ``tests/test_torch_properties.py``) under the tracer,
prints the coverage table of ``ops/cuda_kernels.py`` and the
lines of it that the card run reached and the CPU run did not (the
CPU run's ``tests_torch_coverage.json`` in ``--out-dir``, else in the
repo root; without one it says so and lists none).

Run:  python tools/run_tests_torch.py [--timeout 300] [--no-coverage]
      python tools/run_tests_torch.py --cov-floor-obs 85
      python tools/run_tests_torch.py --cuda        # on the card
"""

import argparse
import glob
import json
import os
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TOOLS)

import linecov_torch as linecov  # noqa: E402

PKG = os.path.join("veles", "simd_tpu_torch")
CUDA_SUITE = os.path.join("tests", "test_torch_cuda.py")
# the other files with card cases (K2 held to the filter-bank
# properties), run with the card suite
CUDA_EXTRA = (os.path.join("tests", "test_torch_properties.py"),)
CUDA_MODULE = os.path.join(PKG, "ops", "cuda_kernels.py")
COVERAGE_JSON = "tests_torch_coverage.json"


def _suite_cmd(pytest_args, cov_out):
    """The child's command: pytest under the peak-RSS report and,
    with ``cov_out``, the line tracer (installed before pytest imports
    the port, so import-time lines count too)."""
    # per-suite peak RSS, like the reference's `/usr/bin/time -f "peak
    # memory %M Kb"`: RUSAGE_CHILDREN is a max over ALL children, so
    # the child reports its own ru_maxrss at exit
    wrapper = (
        "import atexit, resource, runpy, sys; "
        "atexit.register(lambda: print("
        "f'__peak_rss_kb={resource.getrusage("
        "resource.RUSAGE_SELF).ru_maxrss}', file=sys.stderr)); ")
    if cov_out:
        wrapper += (
            f"sys.path.insert(0, {TOOLS!r}); "
            "import linecov_torch; "
            f"linecov_torch.start({os.path.join(REPO, PKG)!r}, "
            f"{cov_out!r}); ")
    wrapper += (
        f"sys.argv = ['pytest'] + {pytest_args!r}; "
        "runpy.run_module('pytest', run_name='__main__')")
    return [sys.executable, "-c", wrapper]


def run_suite(suite, pytest_args, timeout, cov_out=None):
    """One suite in its own child: ``(ok, output, peak_kb)``."""
    pytest_args = [suite, "-q", *pytest_args]
    # a per-test timeout under the suite's, where the plugin exists, so
    # a hung test gets a named traceback before the outer kill
    if _has_pytest_timeout():
        pytest_args.append(f"--timeout={max(30, timeout // 2)}")
    cmd = _suite_cmd(pytest_args, cov_out)
    try:
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True,
                              text=True, timeout=timeout + 60)
        out = proc.stdout + proc.stderr
        ok = proc.returncode == 0
    except subprocess.TimeoutExpired as e:
        out = (_text(e.stdout) + _text(e.stderr) + "\n[TIMEOUT]")
        ok = False
    peak_kb = "?"
    for tok in out.splitlines():
        if tok.startswith("__peak_rss_kb="):
            peak_kb = tok.split("=", 1)[1]
    return ok, out, peak_kb


def _has_pytest_timeout():
    try:
        import pytest_timeout  # noqa: F401

        return True
    except ImportError:
        return False


def _text(b):
    if b is None:
        return ""
    return b.decode(errors="replace") if isinstance(b, bytes) else b


def save_relative(merged: dict, path: str) -> None:
    """The merged lines with repo-relative keys (a checkout elsewhere,
    the card's, reads them back with :func:`load_relative`)."""
    rel = {os.path.relpath(k, REPO): v for k, v in merged.items()
           if k.startswith(REPO + os.sep)}
    linecov.dump(rel, path)


def load_relative(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    return {os.path.join(REPO, k): set(v) for k, v in data.items()}


def cuda_report(args) -> int:
    """The card suite under the tracer, then the table of
    ``ops/cuda_kernels.py`` and its card-only lines."""
    cov_out = os.path.join(args.out_dir, "coverage_torch_cuda.json")
    xml = os.path.join(args.out_dir, "test_results_torch_cuda.xml")
    ok, out, peak_kb = run_suite(
        CUDA_SUITE, [*CUDA_EXTRA, "--noconftest", "-m", "cuda",
                     f"--junitxml={xml}"], args.timeout * 2, cov_out)
    status = "OK" if ok else "[FAILED]"
    line = (f"=== {' '.join((CUDA_SUITE,) + CUDA_EXTRA)} -m cuda: "
            f"{status} (peak memory {peak_kb} Kb)")
    print(line)
    merged = linecov.merge([cov_out])
    table = linecov.table(merged, REPO, scope=CUDA_MODULE)
    with open(os.path.join(args.out_dir, "tests_torch_cuda.log"),
              "w") as log:
        log.write(line + "\n" + out + "\n")
        log.write("\n=== card line coverage (tools/linecov_torch.py) ===\n")
        log.write(linecov.table(merged, REPO, scope=PKG))
    print(table, end="")
    base_path = os.path.join(args.out_dir, COVERAGE_JSON)
    if not os.path.exists(base_path):
        base_path = os.path.join(REPO, COVERAGE_JSON)
    if os.path.exists(base_path):
        cpu = load_relative(base_path)
        only = linecov.only_in(merged, cpu,
                               os.path.join(REPO, CUDA_MODULE))
        print(f"{CUDA_MODULE}: {len(only)} lines only the card run "
              f"reached (CPU baseline {base_path})")
        print("card-only lines: " + _ranges(only))
    else:
        print(f"{CUDA_MODULE}: no CPU baseline ({base_path} is absent: "
              "run the CPU gate first); card-only lines not listed")
    if os.path.exists(cov_out):
        os.unlink(cov_out)
    return 0 if ok else 1


def _ranges(lines) -> str:
    """``[1, 2, 3, 7]`` as ``1-3 7``."""
    out, start, prev = [], None, None
    for n in lines:
        if start is None:
            start = prev = n
        elif n == prev + 1:
            prev = n
        else:
            out.append(f"{start}-{prev}" if prev > start else str(start))
            start = prev = n
    if start is not None:
        out.append(f"{start}-{prev}" if prev > start else str(start))
    return " ".join(out) or "(none)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=int, default=300,
                    help="per-suite timeout in seconds; doubled "
                    "automatically when coverage tracing is on")
    ap.add_argument("--out-dir", default=REPO,
                    help="directory of the log (tests_torch.log, "
                    "tests_torch_cuda.log with --cuda), the XML and the "
                    "coverage JSON (default the repo root)")
    ap.add_argument("--no-coverage", action="store_true",
                    help="skip the line tracer (faster; no table, no "
                    "floor)")
    ap.add_argument("--cov-floor-obs", type=float,
                    default=linecov.DEFAULT_FLOORS[
                        "veles/simd_tpu_torch/obs"],
                    help="minimum aggregate line coverage %% for "
                    "veles/simd_tpu_torch/obs/ (0 disables)")
    ap.add_argument("--cov-floor-serve", type=float,
                    default=linecov.DEFAULT_FLOORS[
                        "veles/simd_tpu_torch/serve"],
                    help="minimum aggregate line coverage %% for "
                    "veles/simd_tpu_torch/serve/ (0 disables)")
    ap.add_argument("--suites", nargs="*", default=None,
                    help="suite paths (default tests/test_torch_*.py)")
    ap.add_argument("--cuda", action="store_true",
                    help="the card suite under the tracer: the "
                    "ops/cuda_kernels.py table and its card-only lines "
                    "(no floor)")
    args = ap.parse_args(argv)
    args.out_dir = os.path.abspath(args.out_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.cuda:
        return cuda_report(args)
    log_path = os.path.join(args.out_dir, "tests_torch.log")
    coverage = not args.no_coverage
    timeout = args.timeout * (2 if coverage else 1)

    suites = sorted(args.suites if args.suites is not None else glob.glob(
        os.path.join(REPO, "tests", "test_torch_*.py")))

    def one(suite):
        name = os.path.basename(suite)
        xml = os.path.join(args.out_dir, f"test_results_{name[:-3]}.xml")
        cov_out = (os.path.join(args.out_dir, f"coverage_{name[:-3]}.json")
                   if coverage else None)
        return (name, cov_out) + run_suite(
            suite, [f"--junitxml={xml}"], timeout, cov_out)

    failures, cov_files = [], []
    with open(log_path, "w") as log:
        for name, cov_out, ok, out, peak_kb in map(one, suites):
            status = "OK" if ok else "[FAILED]"
            line = f"=== {name}: {status} (peak memory {peak_kb} Kb)"
            print(line, flush=True)
            log.write(line + "\n" + out + "\n")
            if cov_out:
                cov_files.append(cov_out)
            if not ok:
                failures.append(name)

        rc = 0
        if coverage:
            merged = linecov.merge(cov_files)
            save_relative(merged, os.path.join(args.out_dir, COVERAGE_JSON))
            log.write("\n=== line coverage (tools/linecov_torch.py) ===\n")
            log.write(linecov.table(merged, REPO, scope=PKG))
            for scope, floor in (("obs", args.cov_floor_obs),
                                 ("serve", args.cov_floor_serve)):
                pct = linecov.aggregate_pct(
                    merged, REPO, scope=os.path.join(PKG, scope))
                floor_line = (f"veles/simd_tpu_torch/{scope}/ aggregate: "
                              f"{pct:.1f}% (floor {floor:.0f}%)")
                print(floor_line)
                log.write(floor_line + "\n")
                if floor > 0 and pct < floor:
                    print(f"{scope} coverage below floor — failing "
                          "the run")
                    log.write(f"[FAILED] {scope} coverage floor\n")
                    rc = 1
            for f in cov_files:
                if os.path.exists(f):
                    os.unlink(f)

    if failures:
        print(f"\n{len(failures)} suite(s) FAILED: {', '.join(failures)}")
        return 1
    if rc:
        print(f"\nsuites green but coverage floor FAILED; log at "
              f"{log_path}")
        return rc
    print(f"\nall {len(suites)} suites passed; log at {log_path}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
