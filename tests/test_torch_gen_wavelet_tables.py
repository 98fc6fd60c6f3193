"""``tools/gen_wavelet_tables_torch.py``: the port's table generator.

A handful of orders, regenerated into ``tmp_path``, hold to the
committed rows within their published drift bounds; a default run of
those orders leaves the committed ``npz`` byte-identical; a derived
row outside its bound fails, naming its key.  The whole regeneration
(about 4 minutes on one core, most of it the coiflets; a process a
family, at once, takes about 3) is the ``slow`` case.
"""

import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import gen_wavelet_tables_torch as gen  # noqa: E402

from veles.simd_tpu_torch.ops import wavelet_coeffs as wc  # noqa: E402

SAMPLED = "daub2,daub4,daub6,daub8,sym8,coif6"


def _sha(path):
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _committed():
    return gen.load_table(wc._TABLE_PATH)


def test_the_port_table_is_the_jax_packages():
    jax_table = REPO / "veles" / "simd_tpu" / "ops" / "_wavelet_tables.npz"
    assert _sha(wc._TABLE_PATH) == _sha(jax_table)


@pytest.mark.parametrize("spec,keys", [
    ("daub8", ["daub8"]),
    ("sym8,daub8", ["daub8", "sym8"]),
    ("coif", ["coif6", "coif12", "coif18", "coif24", "coif30"]),
    (None, None),
])
def test_select_keys(spec, keys):
    got = [f"{f}{o}" for f, o in gen.select_keys(spec)]
    if keys is None:
        assert len(got) == 38 + 38 + 5
        assert sorted(got) == sorted(_committed())
    else:
        assert got == keys


@pytest.mark.parametrize("spec", ["wave8", "daub7", "coif7"])
def test_select_keys_refuses_unknown_orders(spec):
    with pytest.raises(SystemExit):
        gen.select_keys(spec)


@pytest.mark.parametrize("family,order,bound", [
    ("daub", 76, 1e-12), ("sym", 50, 1e-9), ("sym", 52, 2e-8),
    ("sym", 76, 5e-5), ("coif", 6, 1e-10), ("coif", 30, 2e-5)])
def test_drift_bounds(family, order, bound):
    assert gen.published_drift_bound(order, family) == bound


def test_sampled_orders_hold_to_the_committed_rows(tmp_path):
    out = tmp_path / "derived.npz"
    assert gen.main(["--orders", SAMPLED, "--out", str(out),
                     "--derived", "--reference", str(tmp_path)]) == 0
    derived, committed = gen.load_table(str(out)), _committed()
    assert derived.keys() == committed.keys()
    for family, order in gen.select_keys(SAMPLED):
        key = f"{family}{order}"
        drift = float(np.max(np.abs(derived[key] - committed[key])))
        assert drift < gen.published_drift_bound(order, family), key
        target = np.sqrt(2) if family == "daub" else 1.0
        assert abs(derived[key].sum() - target) < 1e-10
        assert gen.orth_err(derived[key], target) < 1e-9
    # the rows it did not regenerate are the committed ones
    for key in set(committed) - {f"{f}{o}" for f, o in
                                 gen.select_keys(SAMPLED)}:
        assert np.array_equal(derived[key], committed[key])


def test_default_run_leaves_the_committed_table_byte_identical(tmp_path):
    before = _sha(wc._TABLE_PATH)
    assert gen.main(["--orders", SAMPLED,
                     "--reference", str(tmp_path)]) == 0
    assert _sha(wc._TABLE_PATH) == before


def test_kept_rows_are_the_committed_rows(tmp_path):
    out = tmp_path / "kept.npz"
    # a fresh output file: the table is written, every row committed
    assert gen.main(["--orders", "sym8,coif6", "--out", str(out),
                     "--reference", str(tmp_path)]) == 0
    kept = gen.load_table(str(out))
    assert gen.tables_equal(kept, _committed())
    # and a second run finds it unchanged and leaves its bytes
    before = _sha(out)
    assert gen.main(["--orders", "sym8", "--out", str(out),
                     "--reference", str(tmp_path)]) == 0
    assert _sha(out) == before


def test_a_row_outside_its_bound_fails_naming_the_key(tmp_path, capsys):
    committed = _committed()
    committed["sym8"] = committed["sym8"] + 1e-6
    with pytest.raises(gen.DriftError, match="sym8"):
        gen.regenerate(gen.select_keys("sym8"), committed, log=lambda m: 0)
    fake = tmp_path / "fake.npz"
    np.savez(fake, **committed)
    orig = wc._TABLE_PATH
    try:
        wc._TABLE_PATH = str(fake)
        rc = gen.main(["--orders", "daub4,sym8", "--out",
                       str(tmp_path / "o.npz"), "--reference",
                       str(tmp_path)])
    finally:
        wc._TABLE_PATH = orig
    assert rc == 1
    assert "sym8" in capsys.readouterr().err
    assert not (tmp_path / "o.npz").exists()


def test_published_rows_are_stored_when_the_reference_is_present(tmp_path):
    # a reference tree whose published rows are the committed ones
    committed = _committed()
    src = tmp_path / "src"
    src.mkdir()
    for fam, (fname, symbol, step) in gen._PUBLISHED_FILES.items():
        orders = wc.supported_orders(wc.WaveletType(fam))
        rows = ",\n".join(
            "{" + ", ".join(repr(float(v)) for v in committed[f"{fam}{o}"])
            + "}" for o in orders)
        (src / fname).write_text(
            f"const double {symbol}[][{orders[-1]}] = {{\n{rows}\n}};\n")
    out = tmp_path / "pub.npz"
    assert gen.main(["--orders", "sym8,coif6", "--out", str(out),
                     "--reference", str(tmp_path), "--derived"]) == 0
    table = gen.load_table(str(out))
    # --derived stores the derived row, held to the published one;
    # without it the published row is stored
    assert float(np.max(np.abs(table["sym8"] - committed["sym8"]))) < 1e-9
    assert not np.array_equal(table["sym8"], committed["sym8"])
    assert gen.main(["--orders", "sym8", "--out", str(out),
                     "--reference", str(tmp_path)]) == 0
    assert np.array_equal(gen.load_table(str(out))["sym8"],
                          committed["sym8"])


@pytest.mark.slow
def test_whole_regeneration_holds_every_row(tmp_path):
    # one process a family, at once (the coiflets take the longest,
    # about 3 minutes); in child processes, so a line tracer around
    # this test does not slow the solves
    procs = {fam: subprocess.Popen(
        [sys.executable, str(REPO / "tools" / "gen_wavelet_tables_torch.py"),
         "--orders", fam, "--derived", "--out", str(tmp_path / f"{fam}.npz"),
         "--reference", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for fam in ("coif", "daub", "sym")}
    for fam, proc in procs.items():
        out = proc.communicate(timeout=1200)[0]
        assert proc.returncode == 0, out[-2000:]
    committed = _committed()
    for family, order in gen.select_keys(None):
        key = f"{family}{order}"
        derived = gen.load_table(str(tmp_path / f"{family}.npz"))[key]
        assert float(np.max(np.abs(derived - committed[key]))) < \
            gen.published_drift_bound(order, family), key
