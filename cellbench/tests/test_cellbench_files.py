"""The benchmark's files: ``BENCHMARK.json`` against its contract, each
cell, configuration and metric file it names, and a cell and a metric
added as new files only."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest

from cellbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cellbench"]
    assert BENCH["command"][:2] == ["python3", "cellbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and LINE.match(w["why"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_with_its_files(name):
    cell = harness.load_cell(name)
    assert cell.chips == 1
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["name"] == name
    for part in ("entries", cell.config["entry"] + ".py"), (
            "reference", cell.config_name + ".py"):
        assert cell.path(*part).is_file()
    assert set(cell.config["traffic_sets"]) <= set(cell.traffic["shape"])
    limits = cell.traffic["check"]["limits"]
    assert limits and all(v is not None and v > 0
                          for v in limits.values())


def test_every_configuration_has_its_file_and_a_cell():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("cellbench/configs/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert conf["name"] == c["name"]


@pytest.mark.parametrize(
    "name", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(name):
    mod = harness.load_module(ROOT / "cellbench" / "metrics" / f"{name}.py")
    assert callable(mod.read)


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    """A copy of the benchmark gains a cell and a metric by a new
    workload file, a new metric file and new entries in BENCHMARK.json;
    no file that was there changes, and the new cell runs on the CPU."""
    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes()
              for p in (tmp_path / "cellbench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "conv1d_1m.tiny", "config": "conv1d_1m", "traffic": "tiny",
        "chips": 1, "why": "a throwaway cell"})
    bench["end_to_end"].append({
        "name": "calls_per_s", "unit": "calls/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["conv1d_1m.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "cellbench" / "workloads" / "conv1d_1m.tiny.json"
     ).write_text(json.dumps({
         "name": "conv1d_1m.tiny", "config": "conv1d_1m",
         "traffic": "tiny", "pool": 2,
         "shape": {"rows": 2, "n": 2048, "taps": 300},
         "check": {"sample": 3, "limits": {"max_rel_err": 3e-5}}}))
    (tmp_path / "cellbench" / "metrics" / "calls_per_s.py").write_text(
        "def read(r):\n    return r.calls / r.window.seconds\n")
    cell = harness.load_cell("conv1d_1m.tiny", root=tmp_path)
    assert [m["name"] for m in cell.end_to_end][-1] == "calls_per_s"
    line = harness.run(cell, 7, 0.2, False, "cpu", time.perf_counter())
    assert line["correct"] is True
    assert line["metrics"]["calls_per_s"]["value"] > 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for p, data in before.items():
        assert p.read_bytes() == data
    # the other cells do not report the new metric
    other = harness.load_cell(CELLS[0], root=tmp_path)
    assert "calls_per_s" not in {m["name"] for m in other.end_to_end}


def test_an_unknown_cell_is_refused():
    with pytest.raises(harness.SpecError):
        harness.load_cell("no_such.cell")
