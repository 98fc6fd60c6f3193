"""Dependency-free line coverage for the port's test runner.

The twin of ``tools/linecov.py`` for ``veles/simd_tpu_torch/``.  The
container ships neither ``coverage`` nor ``pytest-cov``, so
``tools/run_tests_torch.py`` collects line coverage with a stdlib
``sys.settrace`` hook: the global trace function prunes every frame
whose code lives outside the traced prefix (the port's package; the
JAX package the port's tests compare against is not traced, so it
costs only the per-call event), and traced frames record their
executed line numbers into one set.

Two halves:

* **collector** (runs inside the per-suite child): :func:`start`
  installs the tracer (both ``sys.settrace`` and ``threading.settrace``
  — the serving layer and the shard runner work in threads) and
  registers an atexit dump of ``{filename: [lines]}`` JSON.
* **reporter** (runs in the parent): :func:`merge` folds the per-suite
  dumps, :func:`executable_lines` computes each module's denominator
  from the *compiled* code objects (``co_lines`` over the nested code
  tree — exactly the set a tracer could ever report, so docstrings and
  blank lines never count against coverage), :func:`table` renders the
  per-module report, :func:`aggregate_pct` the gated number, and
  :func:`only_in` the lines one run reached and another did not (the
  card run's lines of ``ops/cuda_kernels.py`` that no CPU run reaches).
"""

from __future__ import annotations

import json
import os
import sys
import threading

__all__ = ["start", "merge", "executable_lines", "table",
           "aggregate_pct", "only_in", "dump", "main", "DEFAULT_FLOORS"]

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

# the gated scopes: repo-relative directory -> minimum aggregate line
# coverage % (consumed by tools/run_tests_torch.py; CLI flags
# override).  Each is the highest whole 5 % step below the lowest of
# three full CPU runs' aggregates (obs/ 91.3 % in each, serve/ 89.8–90.0 %;
# PERF.md), and never below the JAX package's floors
# (tools/linecov.py: 60 and 62).
DEFAULT_FLOORS = {
    "veles/simd_tpu_torch/obs": 90.0,
    "veles/simd_tpu_torch/serve": 85.0,
}


def start(prefix: str, out_path: str) -> None:
    """Install the tracer for files under ``prefix`` and dump counts
    to ``out_path`` at interpreter exit (atomic rename, so a killed
    suite leaves no torn JSON)."""
    import atexit

    prefix = os.path.abspath(prefix) + os.sep
    hits: dict = {}

    def _global(frame, event, arg):
        if event != "call":
            return None
        fname = frame.f_code.co_filename
        if not fname.startswith(prefix):
            return None     # foreign frame: no local line tracing
        target = hits.setdefault(fname, set())
        target.add(frame.f_lineno)

        def local(frame, event, arg):
            if event == "line":
                target.add(frame.f_lineno)
            return local
        return local

    def _dump():
        sys.settrace(None)
        threading.settrace(None)
        dump(hits, out_path)

    atexit.register(_dump)
    threading.settrace(_global)
    sys.settrace(_global)


def dump(merged: dict, out_path: str) -> None:
    """Write ``{filename: lines}`` as JSON, atomically."""
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({k: sorted(v) for k, v in merged.items()}, f)
    os.replace(tmp, out_path)


def merge(paths) -> dict:
    """Union the per-suite dumps into ``{filename: set(lines)}``."""
    merged: dict = {}
    for p in paths:
        try:
            with open(p) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue        # skipped/killed suite: no dump, not fatal
        for fname, lines in data.items():
            merged.setdefault(fname, set()).update(lines)
    return merged


def executable_lines(path: str) -> set:
    """Line numbers the compiled module could ever report: the union
    of ``co_lines()`` over the module's nested code objects."""
    with open(path) as f:
        src = f.read()
    try:
        code = compile(src, path, "exec")
    except SyntaxError:
        return set()
    lines: set = set()
    stack = [code]
    while stack:
        co = stack.pop()
        for _, _, line in co.co_lines():
            if line is not None:
                lines.add(line)
        for const in co.co_consts:
            if hasattr(const, "co_lines"):
                stack.append(const)
    return lines


def _module_rows(merged: dict, repo: str, scope: str):
    """``(relpath, covered, executable)`` for each module of ``scope``
    (a repo-relative directory, or one ``.py`` file)."""
    scope_abs = os.path.join(os.path.abspath(repo), scope)
    if scope_abs.endswith(".py"):
        paths = [scope_abs] if os.path.exists(scope_abs) else []
    else:
        paths = []
        for root, _dirs, files in os.walk(scope_abs):
            if "__pycache__" in root:
                continue
            paths += [os.path.join(root, fn) for fn in sorted(files)
                      if fn.endswith(".py")]
    rows = []
    for path in sorted(paths):
        exe = executable_lines(path)
        if not exe:
            continue
        hit = merged.get(path, set()) & exe
        rows.append((os.path.relpath(path, repo), len(hit), len(exe)))
    return rows


def table(merged: dict, repo: str,
          scope: str = "veles/simd_tpu_torch") -> str:
    """Per-module coverage table over ``scope`` (repo-relative dir or
    file)."""
    rows = _module_rows(merged, repo, scope)
    if not rows:
        return "(no coverage data)\n"
    width = max(len(r[0]) for r in rows)
    lines = ["%-*s %8s %8s %6s" % (width, "module", "covered",
                                   "lines", "pct")]
    tot_hit = tot_exe = 0
    for rel, hit, exe in rows:
        tot_hit += hit
        tot_exe += exe
        lines.append("%-*s %8d %8d %5.1f%%"
                     % (width, rel, hit, exe, 100.0 * hit / exe))
    lines.append("%-*s %8d %8d %5.1f%%"
                 % (width, "TOTAL", tot_hit, tot_exe,
                    100.0 * tot_hit / max(tot_exe, 1)))
    return "\n".join(lines) + "\n"


def aggregate_pct(merged: dict, repo: str, scope: str) -> float:
    """Aggregate line-coverage % over one repo-relative directory —
    the number ``run_tests_torch.py`` gates."""
    rows = _module_rows(merged, repo, scope)
    hit = sum(r[1] for r in rows)
    exe = sum(r[2] for r in rows)
    return 100.0 * hit / exe if exe else 0.0


def only_in(merged: dict, other: dict, path: str) -> list:
    """Executable lines of ``path`` that ``merged`` reached and
    ``other`` did not, sorted."""
    path = os.path.abspath(path)
    exe = executable_lines(path)
    return sorted((merged.get(path, set()) - other.get(path, set()))
                  & exe)


def main(argv=None) -> int:
    """``python tools/linecov_torch.py COVERAGE_JSON [--scope DIR]``:
    the table and the gated aggregates of a saved run (the
    repo-relative ``tests_torch_coverage.json`` that
    ``run_tests_torch.py`` writes)."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("coverage")
    ap.add_argument("--scope", default="veles/simd_tpu_torch")
    args = ap.parse_args(argv)
    merged = {os.path.join(REPO, k): set(v)
              for k, v in merge([args.coverage]).items()}
    print(table(merged, REPO, scope=args.scope), end="")
    for scope, floor in DEFAULT_FLOORS.items():
        print(f"{scope}/ aggregate: "
              f"{aggregate_pct(merged, REPO, scope):.1f}% "
              f"(floor {floor:.0f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
