"""``run.py`` on the card, every cell, untraced and traced, with a
short window: the result line as the contract has it, and ``correct``.

    python -m pytest --noconftest -m cuda \
        cellbench/tests/test_cellbench_card.py
"""

import json
import subprocess
import sys

import pytest

from cellbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_on_the_card(card, name, trace):
    out = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 2 * trace + 1), "--seconds", "2", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "check"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert (dev["platform"], dev["kind"], dev["count"]) == ("gpu", card, 1)
    assert dev["memory_peak_bytes"] > 0
    cell = harness.load_cell(name)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) == {m["name"] for m in want}
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert 0 < line["metrics"]["op_roofline"]["value"] <= 100
        assert line["breakdown"]["device_ops"]
        assert {k for k, _ in line["breakdown"]["idle_gaps"]} <= {
            "call", "sync", "loop"}
