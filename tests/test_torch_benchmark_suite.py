"""The port's benchmark generator (``tools/benchmark_suite_torch.py``) on
the CPU, at small sizes.

Every section runs once (``set_config(device="cpu")``); each row's
answer was held to its NumPy oracle inside the run (the tool raises
otherwise), each recorded ``simd=True`` answer is held here to the JAX
package's same call on the same inputs at the row's tolerance, each
convolve row names the algorithm ``convolve_initialize`` picks in the
JAX package, and each line keeps the reference's format.
"""

import contextlib
import dataclasses
import io
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import benchmark_suite_torch as bs  # noqa: E402
from veles.simd_tpu_torch.utils import config  # noqa: E402

# small sizes: every section, every route family of the full run that
# the CPU has (the overlap-save handle, the FFT and brute-force
# crossovers, the batched direct form, each precision route)
SMALL = dict(
    bs.FULL,
    conv_sizes=((50, 50), (350, 21), (2000, 950), (1 << 13, 127)),
    conv_high=(1 << 13, 255), conv_batched=(8, 512, 33),
    gemm=(30, 256, 1000), gemm_sizes=(64,), gemm_batched=(4, 32),
    gemv=256, dwt=(8, 256), cascade=(8, 512), conv2d=(2, 64, (5, 17)),
    conv2d_small=(4, 32, 5), mathfun=1 << 12, signal=1 << 13,
    stft=1 << 13,
    iir=(4, 1 << 10), batched=(8, 512), medfilt=(8, 1 << 11, 4, 1024),
    czt_bins=64, lombscargle=(1 << 10, 64), normalize=64,
    peaks=(4, 1 << 11, 64))

LINE = re.compile(
    r"^\[(?P<name>[^\]]+(?:\][^\]]*)?)\] CPU version took "
    r"(?P<pct>-?[0-9.]+|nan)% of the original time\. Speedup is "
    r"(?P<spd>-?[0-9]+|nan)% \((?P<times>[0-9.]+|nan) times\)"
    r"( \| [0-9]+ Msamples/s)?( \| [0-9]+ GFLOP/s)?"
    r" \| busy not measured \| launches \{\} \| rel err [0-9.e+-]+$")


@pytest.fixture(scope="module")
def suite():
    prev = config.get_config()
    config.set_config(device="cpu")
    bs.RECORD = []
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rows = bs.run(SMALL, np.random.RandomState(0))
        records = bs.RECORD
    finally:
        bs.RECORD = None
        config.set_config(**dataclasses.asdict(prev))
    return rows, records, out.getvalue().splitlines()


def test_every_section_ran_and_held_to_its_oracle(suite):
    rows, records, _ = suite
    names = [r["name"] for r in rows]
    for prefix in ("convolve 50x50", "convolve 8192x255 [overlap_save, "
                   "precision=high]", "convolve batched", "gemm 30x256",
                   "gemm 64", "gemm batched 4x32^3", "gemv",
                   "dwt daub4", "dwt daub16", "dwt coiflet18",
                   "dwt symlet8", "swt daub8", "dwt cascade L3 fused",
                   "dwt cascade L3 level-loop", "dwt+idwt", "conv2d",
                   "sin", "stft", "resample_poly 8k",
                   "resample_poly batched", "sosfilt order4",
                   "sosfilt batched", "lfilter batched", "medfilt",
                   "czt", "lombscargle", "normalize2D",
                   "detect_peaks"):
        assert any(n.startswith(prefix) for n in names), prefix
    checked = [r for r in rows if r.get("rel_err") is not None]
    assert len(checked) >= 30
    for row in checked:
        if isinstance(row["rel_err"], dict):     # the GEMM sweep
            from veles.simd_tpu_torch.runtime import precision as prx

            for prec, err in row["rel_err"].items():
                assert err <= prx.ERROR_BUDGETS[prec], (row["name"], prec)
        else:
            assert row["rel_err"] <= max(bs.TOL.values()), row
    # every row's check was recorded, with its inputs
    assert len(records) >= len(checked)


def test_a_wrong_answer_fails_the_row():
    prev = config.get_config()
    config.set_config(device="cpu")
    try:
        with pytest.raises(bs.SuiteCheckError, match="rel err"):
            bs.benchmark("wrong", lambda v: v, np.zeros(4, np.float32),
                         lambda: None,
                         check=bs.Check(lambda: np.ones(4),
                                        lambda: np.zeros(4) + 2.0,
                                        bs.TOL["oracle"]))
    finally:
        config.set_config(**dataclasses.asdict(prev))


def test_lines_keep_the_reference_format(suite):
    _, _, lines = suite
    rows = [line for line in lines if "version took" in line]
    assert len(rows) >= 30
    for line in rows:
        assert LINE.match(line), line
    assert any(line.startswith("[gemm 64] [highest] ")
               for line in lines)
    assert any(re.match(r"\[stft 8k fl=1024 hop=256\] route \w+", line)
               for line in lines)
    assert any(line.startswith("[batched/single sosfilt") for line in
               lines)


def test_convolve_brackets_name_the_jax_algorithm(suite):
    from veles.simd_tpu.ops import convolve as jcv

    rows, _, _ = suite
    seen = 0
    for row in rows:
        m = re.match(r"convolve (\d+)x(\d+) \[(\w+)", row["name"])
        if not m:
            continue
        n, k, algo = int(m[1]), int(m[2]), m[3]
        assert algo == jcv.convolve_initialize(n, k).algorithm.value
        seen += 1
    assert seen == len(SMALL["conv_sizes"]) + 1


def _jax_answer(name, args, got):
    """The JAX package's answer to the call a row checked."""
    import jax.numpy as jnp

    from veles.simd_tpu.ops import batched as jbt
    from veles.simd_tpu.ops import convolve as jcv
    from veles.simd_tpu.ops import convolve2d as jcv2d
    from veles.simd_tpu.ops import detect_peaks as jdp
    from veles.simd_tpu.ops import filters as jflt
    from veles.simd_tpu.ops import iir as jiir
    from veles.simd_tpu.ops import matrix as jmx
    from veles.simd_tpu.ops import normalize as jnz
    from veles.simd_tpu.ops import resample as jrs
    from veles.simd_tpu.ops import spectral as jsp
    from veles.simd_tpu.ops import wavelet as jwv
    from veles.simd_tpu.ops.mathfun import sin_psv
    from veles.simd_tpu.ops.wavelet_coeffs import WaveletType

    per = jwv.ExtensionType.PERIODIC
    d8 = WaveletType.DAUBECHIES
    rows = len(got) if isinstance(got, np.ndarray) else None
    if name.startswith("convolve batched"):
        return jcv.convolve_simd(*args, simd=True)
    if name.startswith("convolve"):
        x, h = args
        if "precision=high" in name:
            from veles.simd_tpu.utils.config import get_config, set_config
            prev = get_config().conv_precision
            set_config(conv_precision="high")
            try:
                return jcv.convolve(jcv.convolve_initialize(
                    len(x), len(h)), x, h, simd=True)
            finally:
                set_config(conv_precision=prev)
        return jcv.convolve(jcv.convolve_initialize(len(x), len(h)), x,
                            h, simd=True)
    if re.match(r"gemm \d+x\d+x\d+ transposed", name):
        return jmx._matmul_t_p(*args)
    if re.match(r"gemm \d+x\d+x\d+", name):
        return jmx._matmul_p(*args)
    if name.startswith("gemm"):
        return jmx._matmul_p(*args, precision=name.split()[-1])
    if name.startswith("gemv"):
        return jmx.matrix_vector_multiply(*args, simd=True)
    m = re.match(r"dwt (daub|coiflet|symlet)(\d+) ", name)
    if m:
        family = {"daub": d8, "coiflet": WaveletType.COIFLET,
                  "symlet": WaveletType.SYMLET}[m[1]]
        return jwv.wavelet_apply(family, int(m[2]), per, args[0],
                                 simd=True)
    if name.startswith("swt"):
        return jwv.stationary_wavelet_apply(d8, 8, 2, per, args[0],
                                            simd=True)
    if name.startswith("dwt cascade L3 fused"):
        os.environ["VELES_SIMD_FORCE_FUSED_CASCADE"] = "1"
        try:
            return jwv.wavelet_transform(d8, 8, per, args[0], 3,
                                         simd=True)
        finally:
            os.environ.pop("VELES_SIMD_FORCE_FUSED_CASCADE", None)
    if name.startswith("dwt cascade"):
        return jwv.wavelet_transform(d8, 8, per, args[0], 3, simd=True)
    if name.startswith("dwt+idwt"):
        return jwv.wavelet_reconstruct(
            d8, 8, *jwv.wavelet_apply(d8, 8, per, args[0], simd=True),
            simd=True)
    if name.startswith("conv2d"):
        return jcv2d.convolve2d(*args, simd=True)
    if name.startswith("sin"):
        return sin_psv(args[0], simd=True)
    if name.startswith("stft"):
        fl, hop = map(int, re.findall(r"=(\d+)", name))
        return jsp.stft(args[0], fl, hop, simd=True)
    if name.startswith("resample_poly batched"):
        return jbt.batched_resample_poly(args[0], 160, 147,
                                         simd=True)[:rows]
    if name.startswith("resample_poly"):
        return jrs.resample_poly(args[0], 160, 147, simd=True)
    if name.startswith("sosfilt batched"):
        return jbt.batched_sosfilt(*args, simd=True)[:rows]
    if name.startswith("sosfilt"):
        return jiir.sosfilt(*args, simd=True)
    if name.startswith("lfilter batched"):
        return jbt.batched_lfilter(*args, simd=True)[:rows]
    if name.startswith("medfilt"):
        return jflt.medfilt(args[0], 7, simd=True)
    if name.startswith("czt"):
        bins = int(re.search(r"-> (\d+) bins", name)[1])
        return jsp.czt(args[0], bins, simd=True)
    if name.startswith("lombscargle"):
        t, x, f = args
        return jsp._lombscargle_xla(
            jnp.asarray(t, jnp.float32), jnp.asarray(x),
            jnp.asarray(f, jnp.float32),
            jnp.ones(len(t), jnp.float32))
    if name.startswith("normalize2D"):
        return jnz.normalize2D(args[0], simd=True)
    if name.startswith("detect_peaks"):
        cap = int(re.search(r"cap=(\d+)", name)[1])
        pos, vals, count = jdp.detect_peaks_fixed(
            args[0][:1], jdp.ExtremumType.BOTH, max_peaks=cap)
        c = int(np.asarray(count)[0])
        return np.concatenate([np.asarray(pos)[0, :c].astype(np.float64),
                               np.asarray(vals)[0, :c]])
    raise AssertionError(f"no JAX twin for row {name!r}")


def _tol(name):
    """The row's tolerance (bs.TOL), as the tool holds the oracle."""
    if name.startswith("gemm"):
        from veles.simd_tpu_torch.runtime import precision as prx

        last = name.split()[-1]
        return prx.ERROR_BUDGETS.get(last, prx.ERROR_BUDGETS["highest"])
    for key, prefixes in (("cascade", ("dwt cascade L3 fused",)),
                          ("round_trip", ("dwt+idwt",)),
                          ("iir", ("sosfilt", "lfilter")),
                          ("resample", ("resample_poly",)),
                          ("mathfun", ("sin",)),
                          ("normalize", ("normalize2D",)),
                          ("peaks", ("detect_peaks",))):
        if name.startswith(prefixes):
            return bs.TOL[key]
    return bs.TOL["oracle"]


def test_each_answer_matches_the_jax_package(suite):
    _, records, _ = suite
    assert records
    for rec in records:
        want = _jax_answer(rec["name"], rec["args"], rec["got"])
        if isinstance(want, (list, tuple)):
            want = [np.asarray(w) for w in want]
        else:
            want = np.asarray(want)
        err = bs.rel_err(rec["got"], want)
        assert err <= _tol(rec["name"]), (rec["name"], err)
