"""The port's durable journal (``obs/journal.py``) against the JAX
package's.

The port keeps its own copy of the module (it imports nothing of the
JAX package), taps it in ``obs.record_decision`` before the telemetry
check, and writes the same schema: a journal written by either package
is read by the other's ``read_file``/``read_pack``, and its ``cursor``
and ``tail`` describe what the other reads back.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from veles.simd_tpu import obs as jobs
from veles.simd_tpu.obs import journal as jjournal
from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.obs import journal as tjournal

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def packs(tmp_path, monkeypatch):
    """Each package armed on its own pack, both disarmed afterwards."""
    monkeypatch.delenv(tjournal.JOURNAL_DIR_ENV, raising=False)
    tjournal._reset_for_tests()
    jjournal._reset_for_tests()
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    obs.configure(journal_dir=str(tdir))
    jobs.configure(journal_dir=str(jdir))
    yield str(tdir), str(jdir)
    obs.configure(journal_dir="")
    jobs.configure(journal_dir="")
    tjournal._reset_for_tests()
    jjournal._reset_for_tests()


def _strip(records):
    return [{k: v for k, v in r.items() if k != "_file"}
            for r in records]


def test_module_all_and_constants_equal_jax():
    assert tjournal.__all__ == jjournal.__all__
    for name in ("SCHEMA", "JOURNAL_DIR_ENV", "MAX_BYTES_ENV",
                 "MAX_TOTAL_BYTES_ENV", "DEFAULT_MAX_BYTES",
                 "DEFAULT_MAX_TOTAL_BYTES", "TAIL_KEEP"):
        assert getattr(tjournal, name) == getattr(jjournal, name)


def test_record_decision_taps_the_journal_with_telemetry_off(packs):
    tdir, _ = packs
    obs.disable()
    obs.record_decision("breaker_transition", "open",
                        site="convolve.dispatch")
    records, skipped = tjournal.read_pack(tdir)
    assert skipped == 0
    assert [(r["op"], r["decision"]) for r in records] == [
        ("breaker_transition", "open")]
    assert records[0]["data"] == {"site": "convolve.dispatch"}
    assert obs.journal_stats()["records"] == 1
    assert obs.events() == []           # the in-memory log stayed off


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_each_package_reads_the_others_journal(packs, writer):
    tdir, jdir = packs
    w_obs, w_mod, pack = ((obs, tjournal, tdir) if writer == "torch"
                          else (jobs, jjournal, jdir))
    r_mod = jjournal if writer == "torch" else tjournal
    tjournal.set_replica("writer")
    jjournal.set_replica("writer")
    for i in range(5):
        w_obs.record_decision("fault_policy", "retry", attempt=i)
    w_mod.emit("chaos_phase", {"phase": "baseline"})
    records, skipped = r_mod.read_pack(pack)
    assert skipped == 0
    assert _strip(records) == w_mod.tail()
    assert [r["seq"] for r in records] == list(range(1, 7))
    assert {r["schema"] for r in records} == {r_mod.SCHEMA}
    assert records[0]["replica"] == "writer"
    assert records[-1]["kind"] == "chaos_phase"
    cur = w_mod.cursor()
    path = os.path.join(cur["dir"], cur["file"])
    assert os.path.getsize(path) == cur["offset"]
    recs, _ = r_mod.read_file(path)
    assert len(recs) == cur["records"] == 6
    assert r_mod.discover(pack) == [path]


def test_one_pack_holds_both_packages_in_order(tmp_path, monkeypatch):
    # one process, one pack: the second writer opens its own segment
    # and read_pack merges both by wall clock
    monkeypatch.delenv(tjournal.JOURNAL_DIR_ENV, raising=False)
    tjournal._reset_for_tests()
    jjournal._reset_for_tests()
    obs.configure(journal_dir=str(tmp_path))
    jobs.configure(journal_dir=str(tmp_path))
    try:
        obs.record_decision("demo", "torch-1")
        jobs.record_decision("demo", "jax-1")
        obs.record_decision("demo", "torch-2")
        for mod in (tjournal, jjournal):
            records, skipped = mod.read_pack(str(tmp_path))
            assert skipped == 0
            assert [r["decision"] for r in records] == [
                "torch-1", "jax-1", "torch-2"]
        assert len(tjournal.discover(str(tmp_path))) == 2
    finally:
        obs.configure(journal_dir="")
        jobs.configure(journal_dir="")
        tjournal._reset_for_tests()
        jjournal._reset_for_tests()


def test_torn_tail_counted_by_both_readers(packs):
    tdir, _ = packs
    for i in range(3):
        tjournal.emit("decision", {"i": i})
    path = os.path.join(tdir, obs.journal_cursor()["file"])
    with open(path, "ab") as f:
        f.write(b'{"schema": "veles-simd-journal-v1", "tru')
    for mod in (tjournal, jjournal):
        records, skipped = mod.read_file(path)
        assert [r["data"]["i"] for r in records] == [0, 1, 2]
        assert skipped == 1


def test_disarmed_by_default(monkeypatch):
    monkeypatch.delenv(tjournal.JOURNAL_DIR_ENV, raising=False)
    tjournal._reset_for_tests()
    obs.configure(journal_dir="")
    assert not tjournal.armed()
    assert tjournal.emit_decision("x", "y", {}) is False
    assert obs.journal_stats()["armed"] is False
    assert obs.journal_cursor() is None
    assert obs.journal_tail() == []


def test_rotation_and_prune_match_jax(tmp_path):
    stats = []
    for mod, sub in ((tjournal, "t"), (jjournal, "j")):
        w = mod.JournalWriter(str(tmp_path / sub), max_bytes=512,
                              max_total_bytes=2048)
        for i in range(200):
            assert w.append({"kind": "decision", "data": {"i": i,
                                                          "pad": "x" * 40}})
        s = w.stats()
        w.close()
        stats.append((s["rotations"] > 0, s["pruned"] > 0, s["dropped"]))
    assert stats[0] == stats[1] == (True, True, 0)


def test_env_arms_a_subprocess(tmp_path):
    # the env var alone arms the journal in a fresh port process
    code = ("import sys; sys.modules['jax'] = None\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "from veles.simd_tpu_torch import obs\n"
            "obs.record_decision('device_probe', 'ok')\n")
    env = dict(os.environ, VELES_SIMD_JOURNAL_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    records, _ = jjournal.read_pack(str(tmp_path))
    assert [r["decision"] for r in records] == ["ok"]
