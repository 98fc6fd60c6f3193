"""Nothing that a run runs imports JAX or the JAX package, compared by
whole dotted parts; the references import nothing of the program."""

import ast
import subprocess
import sys
import types

import pytest

from cellbench import harness

ROOT = harness.ROOT
HERE = ROOT / "cellbench"
JAX = (("jax",), ("jaxlib",), ("flax",), ("veles", "simd_tpu"))
PROGRAM = (("veles",),)


def _imports(path):
    """Dotted names ``path`` imports, at any depth of its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def _walk(paths):
    """Every dotted name imported by ``paths`` and, transitively, by the
    benchmark's own modules they import."""
    seen, names = set(), set()
    todo = list(paths)
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for name in _imports(p):
            names.add(name)
            parts = name.split(".")
            if parts[0] == "cellbench":
                for k in range(len(parts), 1, -1):
                    cand = HERE.joinpath(*parts[1:k]).with_suffix(".py")
                    if cand.is_file():
                        todo.append(cand)
                        break
    return names


def _hits(names, refused):
    return sorted(n for n in names
                  if any(tuple(n.split("."))[:len(r)] == r for r in refused))


def _run_files():
    return ([HERE / "run.py", HERE / "control.py"]
            + sorted((HERE / "entries").glob("*.py"))
            + sorted((HERE / "reference").glob("*.py"))
            + sorted((HERE / "metrics").glob("*.py")))


def test_nothing_a_run_runs_imports_jax_or_the_jax_package():
    names = _walk(_run_files())
    assert "veles.simd_tpu_torch.ops" in names     # the program passes
    assert _hits(names, JAX) == []


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_a_reference_imports_nothing_of_the_program(path):
    names = _walk([path])
    assert _hits(names, JAX + PROGRAM) == []
    assert {n.split(".")[0] for n in names} <= {"torch", "numpy",
                                                "math", "__future__"}


def test_the_parts_are_compared_whole(monkeypatch):
    for name in ("veles.simd_tpu_torch.ops", "jaxtyping", "flaxen",
                 "veles.simd_tpu.ops.convolve", "jax.numpy", "jaxlib",
                 "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert {"veles.simd_tpu.ops.convolve", "jax.numpy", "jaxlib",
            "flax"} <= set(found)
    assert not {"veles.simd_tpu_torch.ops", "jaxtyping",
                "flaxen"} & set(found)


def test_a_run_process_holds_no_jax_module():
    """Everything a run imports, imported in a fresh process, and the
    program's timed entries built on the CPU: no JAX module loaded."""
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from cellbench import harness\n"
        "harness.set_environment()\n"
        "assert harness.load_program() is None\n"
        "for part in ('entries', 'reference', 'metrics'):\n"
        "    for p in sorted((harness.ROOT / 'cellbench' / part)"
        ".glob('*.py')):\n"
        "        harness.load_module(p)\n"
        "import cellbench.control, cellbench.run\n"
        "cell = harness.load_cell('conv1d_1m.taps2047')\n"
        "harness.run(cell, 1, 0.05, False, 'cpu', time.perf_counter(),\n"
        "            params={'rows': 2, 'n': 1024, 'taps': 300})\n"
        "cell = harness.load_cell('dwt_daub8.rows4')\n"
        "harness.run(cell, 1, 0.05, False, 'cpu', time.perf_counter(),\n"
        "            params={'rows': 2, 'n': 256})\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
