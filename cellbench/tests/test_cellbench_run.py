"""``run.py`` as the driver starts it: without a card it fails and
prints no result; without the program in the checkout it cannot run."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from cellbench import harness

ROOT = harness.ROOT


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "cellbench/run.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def _has_card():
    import torch

    return torch.cuda.is_available()


def test_without_a_card_it_fails_and_prints_no_result():
    if _has_card():
        pytest.skip("this machine has a card")
    out = _run(ROOT, "--workload", "conv1d_1m.taps2047", "--seed",
               "4294967311", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_an_unknown_workload_fails():
    out = _run(ROOT, "--workload", "nope", "--seed", "1", "--seconds",
               "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""


def test_alone_in_a_directory_the_benchmark_finds_no_program(tmp_path):
    """A directory that holds only ``BENCHMARK.json`` and ``cellbench``:
    the run fails with no result, and the program, found only outside
    that directory, is refused."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--workload", "conv1d_1m.taps2047", "--seed",
               "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    why = harness.load_program(tmp_path)
    assert why and "outside" in why


def test_the_result_line_is_strict_json():
    from cellbench import run

    line = run._finite({"a": float("inf"), "b": [1.5, float("nan")],
                        "c": {"d": 2}})
    assert json.loads(json.dumps(line, allow_nan=False)) == {
        "a": "inf", "b": [1.5, "nan"], "c": {"d": 2}}
