"""The port's tuning and profiling tools on the CPU.

``tools/bench_multichip_torch.py``, ``tools/tune_conv2d_torch.py``,
``tools/profile_overlap_save_torch.py`` and
``tools/check_wavelet_parity_torch.py`` at small sizes
(``set_config(device="cpu")``, ``VELES_SIMD_PLATFORM=cpu`` where a
tool's ``main`` picks its device):

* the multichip rows in ``tools/bench_regress.py``'s format, each
  answer within its tolerance of ``np.fft`` in float64, and a wrong
  route exiting 1;
* the 2D sweep on one image and two kernels: every candidate within
  its float64 gate, the tune-cache entries read back by ``routing``;
* the overlap-save attribution at 4096 x 255, every route held to
  float64;
* the symlet selections recovered for orders 4 and 8 (rc 0, the JAX
  tool's lines), and rc 1 when one bit of the port's map is flipped.
"""

import contextlib
import dataclasses
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from veles.simd_tpu_torch import obs as tobs
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import bench_multichip_torch as bmc  # noqa: E402
import bench_regress  # noqa: E402
import check_wavelet_parity_torch as cwp  # noqa: E402
import profile_overlap_save_torch as pos  # noqa: E402
import tune_conv2d_torch as tc2  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    prev = tconfig.get_config()
    was = tobs.enabled()
    tconfig.set_config(device="cpu")
    monkeypatch.setenv("VELES_SIMD_PLATFORM", "cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))
    if not was:
        tobs.disable()


def _quiet(line):
    pass


# --- bench_multichip_torch --------------------------------------------------

def test_multichip_rows_read_by_bench_regress(tmp_path):
    out = tmp_path / "MULTICHIP_DETAILS_torch.json"
    entries = bmc.run_bench(8, str(out), quick=True, emit=_quiet)
    assert json.loads(out.read_text()) == json.loads(json.dumps(entries))
    rows, tail = entries[:-1], entries[-1]
    assert [r["metric"] for r in rows] == [
        "sharded rfft 16k x8", "sharded rfft bf16_comp 16k x8",
        "sharded stft 8192/2048 x8 above-cutoff"]
    for r in rows:
        assert r["unit"] == "Msamples/s" and "flagged" not in r
        assert all(np.isfinite(r[k]) and r[k] > 0
                   for k in ("value", "baseline", "vs_baseline"))
        # the port's names, not the TPU's
        assert "mesh_copy" in r and "ici" not in r
    assert rows[0]["rel_err"] <= bmc.TOL
    assert rows[0]["mesh_copy"]["a2a_bytes"] == 8 * (1 << 14) * 7 // 8
    assert rows[0]["mesh_copy"]["mesh_copy_gbps"] == pytest.approx(1675.0)
    assert rows[1]["rel_err"] <= 1e-4
    assert all(v <= bmc.TOL for v in rows[2]["rel_err"].values())
    assert set(rows[2]["rel_err"]) == {"ct_matmul", "xla_fft"}
    assert all(b is None for r in rows for b in r["busy_ms"].values())
    assert tail == {"n_devices": 8, "mesh": {"sp": 8}, "device": "cpu",
                    "card": "cpu", "distinct_cards": 0,
                    "note": "8 shards of the CPU: plumbing only"}
    rc = bench_regress.main(["--details", str(out), "--history",
                             str(tmp_path / "history.jsonl"),
                             "--no-append"])
    assert rc == 0
    assert bench_regress.load_run(str(out))[0] == rows


def test_multichip_wrong_row_exits_1(tmp_path, monkeypatch):
    from veles.simd_tpu_torch.parallel import fourier as fr

    real = fr.sharded_rfft
    monkeypatch.setattr(fr, "sharded_rfft",
                        lambda *a, **k: real(*a, **k) * 1.001)
    out = tmp_path / "m.json"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = bmc.main(["--quick", "--out", str(out)])
    assert rc == 1 and "rel err" in err.getvalue()
    assert not out.exists()


# --- tune_conv2d_torch ------------------------------------------------------

def test_tune_conv2d_sweep_gates_every_candidate(tmp_path):
    from veles.simd_tpu_torch.runtime import routing

    path = tmp_path / "pack.json"
    cache = routing.TuneCache(str(path))
    results = tc2.sweep([(64, 64)], [(3, 3), (17, 17)], [1],
                        ("highest", "bf16_comp"), cache, emit=_quiet)
    assert set(results) == {(1, 64, 64, 3, 3), (1, 64, 64, 17, 17)}
    small, large = results[(1, 64, 64, 3, 3)], results[(1, 64, 64, 17, 17)]
    # the 2D kernel's gate admits 3x3 (its plain version on the CPU)
    # and refuses 17x17 (area 289)
    assert list(small["cands"]) == ["cuda_direct", "cudnn",
                                    "cudnn@bf16_comp", "fft"]
    assert list(large["cands"]) == ["cudnn", "cudnn@bf16_comp", "fft"]
    for cell in results.values():
        for kind, c in cell["cands"].items():
            assert c["ok"] and c["err"] <= tc2.ERR_GATE, (kind, c)
            assert c["launches"] == {} and c["busy_ms"] is None
        assert cell["winner"] in cell["cands"]
    stored = {key: c for key, c in results.items() if c["key"]}
    assert all(c["winner"] in tc2.ROUTE_OF for c in stored.values())
    reread = routing.TuneCache(str(path))
    for (rows, n0, n1, k0, k1), cell in stored.items():
        geom = {"rows": routing.pow2_bucket(rows),
                "n0": routing.pow2_bucket(n0),
                "n1": routing.pow2_bucket(n1), "k0": k0, "k1": k1}
        assert reread.lookup("convolve2d", geom) == \
            tc2.ROUTE_OF[cell["winner"]]
        assert reread.entry("convolve2d", geom)["source"] == "sweep"
    cut, miss, cells = tc2.crossover(results)
    assert cells == 2 and cut in (9, 289, 290) and miss in (0, 1)


def test_tune_conv2d_main_quick_on_small_sizes(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.setattr(tc2, "QUICK", {"images": ((32, 32),),
                                       "kernels": ((3, 3), (5, 7))})
    path = tmp_path / "pack.json"
    rc = tc2.main(["--quick", "--rows", "1,2", "--cache", str(path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.splitlines()[0] == "device: cpu"
    assert out.count("img ") == 4 and "best direct-vs-fft area cut" in out
    assert "(ERR)" not in out and "NO VALID CANDIDATE" not in out
    assert json.loads(path.read_text())["device"] == "cpu"


def test_tune_conv2d_rejects_an_unknown_precision():
    with pytest.raises(SystemExit) as e, \
            contextlib.redirect_stderr(io.StringIO()):
        tc2.main(["--precisions", "highest,fp8"])
    assert e.value.code == 2


# --- profile_overlap_save_torch ---------------------------------------------

def test_profile_overlap_save_small(tmp_path):
    lines = []
    rows = pos.profile(4096, 255, trace_dir=str(tmp_path), emit=lines.append)
    assert [r["name"] for r in rows] == ["cuda_fused", "xla_matmul",
                                         "handle", "cudnn_conv1d"]
    for r in rows:
        assert r["rel_err"] <= pos.TOL
        assert r["msamples_per_s"] > 0 and r["busy_ms"] is None
        assert r["least_work_bound_ms"] > 0
    matmul = rows[1]
    assert matmul["step"] == 256
    assert matmul["ceiling_pct"] == pytest.approx(100 * 255 / (255 + 256))
    assert "formulation ceiling 50%" in lines[2]
    assert "no share of a peak" in lines[1]
    assert any("convolve_os_route" in line for line in lines)
    # the CUPTI record files are written on the card only
    assert not list(tmp_path.iterdir())


def test_profile_overlap_save_main(capsys):
    assert pos.main(["--n", "4096", "--h", "255"]) == 0
    out = capsys.readouterr().out
    assert "overlap-save attribution: n=4096 h=255" in out
    assert out.count("CPU: plumbing only") == 4


# --- check_wavelet_parity_torch ---------------------------------------------

def test_check_wavelet_parity_orders_4_8_match_the_jax_tool(capsys):
    import check_wavelet_parity as jcwp

    assert cwp.main(["--orders", "4", "8"]) == 0
    port = capsys.readouterr().out
    assert jcwp.main(["--orders", "4", "8"]) == 0
    assert port == capsys.readouterr().out
    assert port.count("[ok]") == 2


def test_check_wavelet_parity_fails_on_a_flipped_bit(monkeypatch, capsys):
    sel = dict(cwp.wc._SYMLET_SELECTIONS)
    mirror, bits = sel[8]
    sel[8] = (mirror, ("1" if bits[0] == "0" else "0") + bits[1:])
    monkeypatch.setattr(cwp.wc, "_SYMLET_SELECTIONS", sel)
    assert cwp.main(["--orders", "4", "8"]) == 1
    out = capsys.readouterr()
    assert "sym8" in out.out and "[FAIL]" in out.out
    assert "sym4" in out.out and out.out.count("[ok]") == 1
    assert "1 order(s) failed" in out.err


def test_check_wavelet_parity_reads_the_port_module():
    from veles.simd_tpu_torch.ops import wavelet_coeffs

    assert cwp.wc is wavelet_coeffs
