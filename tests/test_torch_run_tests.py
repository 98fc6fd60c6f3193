"""``tools/run_tests_torch.py`` and ``tools/linecov_torch.py``: the
port's test runner and its line coverage.

The coverage reporter on a synthetic module in ``tmp_path``
(``executable_lines``, ``merge``, ``aggregate_pct``, ``table``,
``only_in``); the runner on one small port suite (its log, junit XML
and merged coverage JSON, all in ``--out-dir``); a floor above the
aggregate and a failing suite each give rc 1.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import linecov_torch as linecov  # noqa: E402
import run_tests_torch as rt  # noqa: E402

MODULE = '''"""A docstring, not an executable line."""

import os


def covered(x):
    # a comment
    return x + 1


def uncovered(x):
    if x:
        return os.sep
    return None
'''


@pytest.fixture
def module(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    path = pkg / "mod.py"
    path.write_text(MODULE)
    return tmp_path, path


def test_executable_lines_are_the_compiled_lines(module):
    _root, path = module
    exe = linecov.executable_lines(str(path))
    # import, two defs, three bodies of uncovered, covered's return
    # (the module docstring's line is the module's first instruction)
    assert {3, 6, 8, 11, 12, 13, 14} <= exe
    assert 7 not in exe             # the comment
    assert 5 not in exe and 9 not in exe   # blank lines
    bad = path.parent / "broken.py"
    bad.write_text("def f(:\n")
    assert linecov.executable_lines(str(bad)) == set()


def test_merge_unions_dumps_and_skips_missing(module, tmp_path):
    _root, path = module
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    linecov.dump({str(path): {3, 6}}, str(a))
    linecov.dump({str(path): {6, 8}}, str(b))
    merged = linecov.merge([str(a), str(b), str(tmp_path / "gone.json")])
    assert merged == {str(path): {3, 6, 8}}
    assert json.loads(a.read_text()) == {str(path): [3, 6]}


def test_aggregate_pct_and_table(module):
    root, path = module
    exe = linecov.executable_lines(str(path))
    hit = {3, 6, 8}
    merged = {str(path): hit | {999}}       # a line no code has
    pct = linecov.aggregate_pct(merged, str(root), "pkg")
    assert pct == pytest.approx(100.0 * len(hit & exe) / len(exe))
    assert linecov.aggregate_pct({}, str(root), "pkg") == 0.0
    assert linecov.aggregate_pct(merged, str(root), "nothing") == 0.0
    table = linecov.table(merged, str(root), scope="pkg")
    assert "pkg/mod.py" in table and "TOTAL" in table
    # one file as the scope
    assert linecov.table(merged, str(root), scope="pkg/mod.py") == table
    assert linecov.table({}, str(root), scope="none") == \
        "(no coverage data)\n"


def test_only_in_lists_the_lines_one_run_alone_reached(module):
    _root, path = module
    card = {str(path): {3, 6, 8, 12, 13}}
    cpu = {str(path): {3, 6, 8}}
    assert linecov.only_in(card, cpu, str(path)) == [12, 13]
    assert rt._ranges([1, 2, 3, 7, 9, 10]) == "1-3 7 9-10"
    assert rt._ranges([]) == "(none)"


def test_relative_coverage_round_trips(tmp_path):
    path = str(REPO / "veles" / "simd_tpu_torch" / "obs" / "lru.py")
    out = tmp_path / "cov.json"
    rt.save_relative({path: {1, 2}, "/elsewhere/x.py": {1}}, str(out))
    assert json.loads(out.read_text()) == {
        "veles/simd_tpu_torch/obs/lru.py": [1, 2]}
    assert rt.load_relative(str(out)) == {path: {1, 2}}


def test_the_floors_are_at_least_the_jax_packages():
    floors = linecov.DEFAULT_FLOORS
    assert floors["veles/simd_tpu_torch/obs"] >= 60.0
    assert floors["veles/simd_tpu_torch/serve"] >= 62.0
    for floor in floors.values():
        assert floor % 5 == 0


def _run(args):
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "run_tests_torch.py"),
         *args], cwd=REPO, capture_output=True, text=True, timeout=600)
    return out.returncode, out.stdout + out.stderr


def test_runner_on_a_small_port_suite(tmp_path):
    rc, out = _run(["--suites", "tests/test_torch_journal.py",
                    "--out-dir", str(tmp_path), "--cov-floor-obs", "0",
                    "--cov-floor-serve", "0"])
    assert rc == 0, out
    assert "=== test_torch_journal.py: OK (peak memory" in out
    assert "veles/simd_tpu_torch/obs/ aggregate:" in out
    log = (tmp_path / "tests_torch.log").read_text()
    assert "=== line coverage (tools/linecov_torch.py) ===" in log
    assert "veles/simd_tpu_torch/obs/journal.py" in log
    assert (tmp_path / "test_results_test_torch_journal.xml").exists()
    cov = json.loads((tmp_path / "tests_torch_coverage.json").read_text())
    assert "veles/simd_tpu_torch/obs/journal.py" in cov
    # the per-suite dumps are folded and removed
    assert not list(tmp_path.glob("coverage_*.json"))
    # the reporter CLI reads the saved run back
    rep = subprocess.run(
        [sys.executable, str(REPO / "tools" / "linecov_torch.py"),
         str(tmp_path / "tests_torch_coverage.json"), "--scope",
         "veles/simd_tpu_torch/obs"], capture_output=True, text=True,
        timeout=120)
    assert rep.returncode == 0 and "journal.py" in rep.stdout


SUITE_OK = '''
from veles.simd_tpu_torch.obs import lru


def test_lru():
    s = lru.LRUSet(2)
    s.add(1)
    assert 1 in s
'''

SUITE_FAILS = '''
def test_fails():
    assert False
'''


def test_a_floor_above_the_aggregate_fails_the_run(tmp_path):
    suite = tmp_path / "test_tiny.py"
    suite.write_text(SUITE_OK)
    out_dir = tmp_path / "out"
    rc, out = _run(["--suites", str(suite), "--out-dir", str(out_dir),
                    "--cov-floor-obs", "99", "--cov-floor-serve", "0"])
    assert rc == 1, out
    assert "obs coverage below floor" in out
    assert "suites green but coverage floor FAILED" in out
    assert "[FAILED] obs coverage floor" in (
        out_dir / "tests_torch.log").read_text()
    rc, out = _run(["--suites", str(suite), "--out-dir", str(out_dir),
                    "--cov-floor-obs", "0", "--cov-floor-serve", "0"])
    assert rc == 0, out


def test_a_failing_suite_fails_the_run(tmp_path):
    suite = tmp_path / "test_tiny_fails.py"
    suite.write_text(SUITE_FAILS)
    rc, out = _run(["--suites", str(suite), "--out-dir", str(tmp_path),
                    "--no-coverage"])
    assert rc == 1
    assert "=== test_tiny_fails.py: [FAILED]" in out
    assert "1 suite(s) FAILED: test_tiny_fails.py" in out
    # no tracer, no coverage JSON, no floor line
    assert not (tmp_path / "tests_torch_coverage.json").exists()
    assert "aggregate" not in out


def test_cuda_report_says_when_there_is_no_baseline(tmp_path, monkeypatch,
                                                   capsys):
    # the card suite itself is the card's; here its run is faked and
    # the report's two forms are read
    path = str(REPO / rt.CUDA_MODULE)

    def fake_run_suite(suite, args, timeout, cov_out=None):
        linecov.dump({path: {1, 2, 3}}, cov_out)
        return True, "", "1"

    monkeypatch.setattr(rt, "run_suite", fake_run_suite)
    # no baseline in --out-dir nor in the repo root
    monkeypatch.setattr(rt, "COVERAGE_JSON", "absent_coverage.json")
    assert rt.main(["--cuda", "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "veles/simd_tpu_torch/ops/cuda_kernels.py" in out
    assert "no CPU baseline" in out
    # the CPU run's file in --out-dir is the baseline
    monkeypatch.undo()
    monkeypatch.setattr(rt, "run_suite", fake_run_suite)
    base = tmp_path / rt.COVERAGE_JSON
    rt.save_relative({path: set()}, str(base))
    assert rt.main(["--cuda", "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"(CPU baseline {base})" in out
    assert "1 lines only the card run reached" in out
    assert "card-only lines: 1" in out
    assert (tmp_path / "tests_torch_cuda.log").exists()
    # the per-run dump is removed
    assert not (tmp_path / "coverage_torch_cuda.json").exists()


@pytest.mark.parametrize("option", ["--log", "--jobs", "--cpu-coverage"])
def test_the_out_dir_is_the_one_output_option(option):
    # the log, the XML and both coverage files follow --out-dir alone
    with pytest.raises(SystemExit):
        rt.main([option, "x"])
