"""The port's examples (``examples/*_torch.py``) against the JAX package.

Each example's step functions run at small sizes on the CPU
(``set_config(device="cpu")``), and the same seeded NumPy inputs go
through the JAX package's own ops (``veles.simd_tpu.ops``,
``pipeline``, and ``parallel`` on the conftest's 8-device CPU mesh).
They are held to each other: planted indices, peak positions and
resonance bins exactly; arrays within 1e-4 of max|y| (a dB spectrum
as power); SNR within
0.01 dB; the zoom and Lomb-Scargle peaks within 1e-3 Hz.  Every
example's own checks hold.  One example (the matched filter, at a
small size) also runs in a subprocess with JAX blocked.  The full-size
runs are ``tests/test_examples.py``'s (slow tier), which picks the
twins up with the JAX examples.
"""

import dataclasses
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
TOL = 1e-4          # of max|y|
SNR_TOL_DB = 0.01
HZ_TOL = 1e-3


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


def _close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(port - ref))) / scale
    assert err <= tol, err


def _jax_stream(cp, x, block):
    """A JAX pipeline streamed block by block (NumPy out)."""
    state = cp.init_state()
    outs = []
    for i in range(0, x.shape[-1], block):
        out, state = cp.process(x[i:i + block], state)
        outs.append(np.asarray(out))
    return outs


def test_every_jax_example_has_a_twin():
    jax_examples = {p.stem for p in EXAMPLES.glob("*.py")
                    if not p.stem.endswith("_torch")}
    twins = {p.stem[:-len("_torch")] for p in EXAMPLES.glob("*_torch.py")}
    assert jax_examples == twins == {
        "matched_filter", "sensor_pipeline", "image_filter",
        "wavelet_denoise", "wavelet_multires", "spectral_zoom",
        "kaiser_design", "sharded_longsignal"}


@pytest.mark.parametrize("name", [
    "matched_filter", "sensor_pipeline", "image_filter",
    "wavelet_denoise", "wavelet_multires", "spectral_zoom",
    "kaiser_design", "sharded_longsignal"])
def test_example_reads_results_with_to_host(name):
    # np.asarray of a card tensor raises: every result goes through
    # utils.platform.to_host, and nothing of JAX is imported
    src = (EXAMPLES / f"{name}_torch.py").read_text()
    assert not re.search(r"np\.asarray\(\s*\w+\.\w+\(", src)
    assert "to_host" in src and "select_device()" in src
    assert "import jax" not in src and "veles.simd_tpu." not in src


def test_matched_filter_against_jax_pipeline():
    from veles.simd_tpu import pipeline as jpl
    from veles.simd_tpu.ops import detect_peaks as jdp
    from veles.simd_tpu.ops import normalize as jnz

    mf = _example("matched_filter")
    n, k, planted, block = 1 << 15, 255, 9000, 1 << 12
    res = mf.detect(n, k, planted, block)
    assert all(res["checks"].values()), res["checks"]
    assert res["found"] == res["strongest"] == planted

    template, signal = mf.make_signal(n, k, planted)
    mn, mx = (float(v) for v in jnz.minmax1D(signal))
    signal_n = ((signal - mn) / (mx - mn) * 2 - 1).astype(np.float32)
    np.testing.assert_allclose(res["signal_n"], signal_n, atol=1e-6)
    cp = jpl.Pipeline([jpl.matched_filter(template)],
                      name="matched").compile(block)
    want = np.concatenate(_jax_stream(cp, signal_n, block))
    _close(res["corr"], want)
    pos, vals = jdp.detect_peaks(want.astype(np.float32),
                                 jdp.ExtremumType.MAXIMUM)
    assert int(np.argmax(want)) - (k - 1) == res["found"]
    assert int(np.asarray(pos)[np.argmax(np.asarray(vals))]) - (k - 1) \
        == res["strongest"]
    assert res["launches_a_block"] == {}

    cmp = mf.compare(res["cp"], res["signal_n"], block)
    assert cmp["fused_blocks_s"] > 0 and cmp["unfused_blocks_s"] > 0
    assert cmp["busy_ms_a_block"] is None


def test_sensor_pipeline_against_jax_pipeline():
    from veles.simd_tpu import pipeline as jpl
    from veles.simd_tpu.ops import iir as jiir

    sp = _example("sensor_pipeline")
    n, block = 1 << 14, 4096
    res = sp.condition(n, block)
    assert all(res["checks"].values()), res

    notch = jiir.butterworth(4, (44 / (sp.FS / 2), 56 / (sp.FS / 2)),
                             "bandstop")
    cp = jpl.Pipeline(
        [jpl.medfilt(5), jpl.detrend("linear"), jpl.sosfilt(notch),
         jpl.welch(fs=sp.FS, nperseg=sp.NPERSEG), jpl.power_db(),
         jpl.savgol(7, 2)], name="sensor").compile(block)
    rows = np.stack(_jax_stream(cp, sp.make_signal(n), block))
    # the rows are dB: held as power (10^(dB/10)) within 1e-4 of its
    # max, since the deepest bins (76 dB down) move by hundredths of a
    # dB with float32 rounding of a PSD that agrees within 1e-5
    _close(10.0 ** (res["rows"] / 10.0), 10.0 ** (rows / 10.0))
    _, found, hum_db = sp.resonances(rows)
    assert found == res["found"]
    # the hum bin is 61 dB down, where float32 rounding moves it by
    # about 0.01 dB: both hold the check, within 0.1 dB of each other
    assert hum_db < -20.0 and abs(hum_db - res["hum_db"]) < 0.1
    assert res["chain"] == [s["stage"] for s in cp.describe()["stages"]]


def test_image_filter_against_jax_convolve2d():
    from veles.simd_tpu import parallel as jpar
    from veles.simd_tpu.ops import convolve2d as jcv2

    im = _example("image_filter")
    rng, img = im.make_image(256)
    be = im.blur_and_edges(img, 9, 2.0)
    assert all(be["checks"].values()), be["checks"]
    k = im.gaussian2d(9, 2.0)
    blur = np.asarray(jcv2.convolve2d(img, k, simd=True))
    _close(be["blur"], blur)
    gx = np.asarray(jcv2.convolve2d(blur, im.SOBEL_X, simd=True))
    gy = np.asarray(jcv2.convolve2d(blur, im.SOBEL_X.T.copy(), simd=True))
    _close(be["edges"], np.hypot(gx, gy))

    rng_j = np.random.RandomState(0)
    rng_j.set_state(rng.get_state())
    tm = im.find_template(rng, 256, 16, (40, 200))
    assert tm["peak"] == (55, 215) and all(tm["checks"].values())
    tpl = rng_j.randn(16, 16).astype(np.float32)
    img2 = 0.1 * rng_j.randn(256, 256).astype(np.float32)
    img2[40:56, 200:216] += tpl
    score = np.asarray(jcv2.cross_correlate2d(img2, tpl, simd=True))
    _close(tm["score"], score)
    assert tuple(int(v) for v in np.unravel_index(np.argmax(score),
                                                  score.shape)) \
        == tm["peak"]

    sh = im.sharded_blur(img, 9, 2.0, be["blur"])
    assert sh["checks"]["sharded_agrees"]
    assert len(sh["shards"]) == 8 and set(sh["shards"]) == {"cpu"}
    want = np.asarray(jpar.sharded_convolve2d(
        img, k, jpar.make_mesh({"dp": 2, "sp": 4})))
    _close(sh["sharded"], want)


def test_wavelet_denoise_against_jax_wavelet():
    from veles.simd_tpu.ops import wavelet as jwv

    wd = _example("wavelet_denoise")
    n, levels, sigma = 1 << 12, 5, 0.3
    res = wd.denoise(n, levels, sigma)
    assert all(res["checks"].values()), res["checks"]
    clean, noisy = wd.make_signal(n, sigma)
    coeffs = jwv.wavelet_transform("sym", 8, jwv.ExtensionType.PERIODIC,
                                   noisy, levels, simd=True)
    thresh = np.float32(sigma * np.sqrt(2 * np.log(n)))
    den = [np.sign(np.asarray(b)) * np.maximum(np.abs(np.asarray(b))
                                               - thresh, 0.0)
           for b in coeffs[:-1]] + [np.asarray(coeffs[-1])]
    rec = np.asarray(jwv.wavelet_inverse_transform("sym", 8, den,
                                                   simd=True))
    _close(res["rec"], rec)
    assert abs(res["snr_out"] - wd.snr_db(clean, rec)) < SNR_TOL_DB
    assert abs(res["snr_in"] - wd.snr_db(clean, noisy)) < SNR_TOL_DB
    ident = np.asarray(jwv.wavelet_inverse_transform("sym", 8, coeffs,
                                                     simd=True))
    _close(res["ident"], ident)


def test_wavelet_multires_against_jax_wavelet():
    from veles.simd_tpu.ops import wavelet as jwv
    from veles.simd_tpu.ops.wavelet_coeffs import WaveletType as JWT

    wm = _example("wavelet_multires")
    chirp = wm.make_chirp(1 << 12)
    res = wm.run(n=1 << 12, emit=lambda line: None)
    assert all(res["checks"].values()), res["checks"]
    per, mir = jwv.ExtensionType.PERIODIC, jwv.ExtensionType.MIRROR
    bands = jwv.wavelet_transform(JWT.DAUBECHIES, 8, per, chirp, 4)
    for got, want in zip(res["dwt"]["bands"], bands, strict=True):
        _close(got, np.asarray(want))
    sbands = jwv.stationary_wavelet_transform(JWT.SYMLET, 8, mir, chirp, 2)
    for got, want in zip(res["swt"]["bands"], sbands, strict=True):
        _close(got, np.asarray(want))
    leaves = jwv.wavelet_packet_transform(JWT.DAUBECHIES, 8, per, chirp, 3)
    energies = [float(np.sum(np.asarray(b, np.float64) ** 2))
                for b in leaves]
    for got, want in zip(res["packets"]["leaves"], leaves, strict=True):
        _close(got, np.asarray(want))
    assert res["packets"]["peak"] == int(np.argmax(energies))
    hi, lo = jwv.wavelet_apply(JWT.DAUBECHIES, 8, per, chirp)
    _close(res["oracle"]["hi"], np.asarray(hi))
    _close(res["oracle"]["lo"], np.asarray(lo))


def test_spectral_zoom_against_jax_spectral():
    from veles.simd_tpu.ops import spectral as jsp

    sz = _example("spectral_zoom")
    s = sz.SIZES
    res = sz.run(emit=lambda line: None)
    assert all(res["checks"].values()), res["checks"]
    rng, t, x = sz.make_signal(s["n"], s["fs"])
    f, z = jsp.zoom_fft(x, list(s["band"]), m=s["m"], fs=s["fs"])
    mag = np.abs(np.asarray(z))
    _close(res["zoom"]["mag"], mag)
    pair = sz.two_peaks(np.asarray(f), mag)
    assert np.allclose(res["zoom"]["pair"], pair, atol=HZ_TOL)
    keep = np.sort(rng.choice(s["n"], int(s["keep"] * s["n"]),
                              replace=False))
    w = 2 * np.pi * np.linspace(s["band"][0], s["band"][1], s["m"])
    p = np.asarray(jsp.lombscargle(t[keep], x[keep] - x[keep].mean(), w))
    _close(res["lomb"]["p"], p)
    assert np.allclose(res["lomb"]["pair"],
                       sz.two_peaks(w / (2 * np.pi), p), atol=HZ_TOL)


def test_kaiser_design_against_jax_filters():
    from veles.simd_tpu.ops import convolve as jcv
    from veles.simd_tpu.ops import filters as jfl
    from veles.simd_tpu.ops import spectral as jsp

    kd = _example("kaiser_design")
    s = kd.SIZES
    d = kd.design(s["atten_db"], s["width"], s["cutoff"])
    numtaps, beta = jfl.kaiserord(s["atten_db"], s["width"])
    assert d["numtaps"] == numtaps and abs(d["beta"] - beta) < 1e-9
    taps = np.asarray(jfl.firwin(numtaps, s["cutoff"],
                                 window=("kaiser", beta)))
    _close(d["taps"], taps)
    n = 1 << 15
    a = kd.apply_and_verify(d["taps"], n, s["nperseg"], s["atten_db"])
    assert all({**d["checks"], **a["checks"]}.values())
    x = kd.make_signal(n)
    y = np.asarray(jcv.oaconvolve(x, taps.astype(np.float32), mode="same",
                                  simd=True))
    _close(a["y"], y)
    _, p_out = jsp.welch(y, fs=kd.FS, nperseg=s["nperseg"],
                         window=("kaiser", 8.0), simd=True)
    _close(a["p_out"], np.asarray(p_out))


def test_sharded_longsignal_against_jax_parallel():
    import jax
    import jax.numpy as jnp

    from veles.simd_tpu import parallel as jpar

    sl = _example("sharded_longsignal")
    n, k = 1 << 16, 63
    rng, x, h = sl.make_inputs(n, k)
    cl = sl.convolve_long(rng, x, h, 16)
    assert cl["checks"]["spot_checks"] and cl["shards"] == 8
    mesh = jpar.make_mesh({"sp": 8})
    want = jax.jit(lambda a, b: jpar.sharded_convolve(a, b, mesh,
                                                      axis="sp"))(x, h)
    _close(cl["y"], np.asarray(want))

    cb = sl.convolve_batch(rng, h, 5, 1 << 12)
    assert cb["checks"]["batch_row0"]
    mesh2 = jpar.make_mesh({"dp": 2, "sp": 4})
    wantb = jax.jit(lambda a, b: jpar.sharded_convolve_batch(
        a, b, mesh2))(jnp.asarray(cb["xb"]), jnp.asarray(h))
    _close(cb["yb"], np.asarray(wantb))

    xs = x[:1 << 14]
    sw = sl.swt_round_trip(xs, 3)
    assert sw["checks"]["swt_round_trip"]
    bands = jpar.sharded_swt("daub", 8, 3, xs, mesh, axis="sp")
    rec = np.asarray(jpar.sharded_swt_reconstruct("daub", 8, 3, bands,
                                                  mesh, axis="sp"))
    _close(sw["rec"], rec)


@pytest.mark.parametrize("name,sizes", [
    ("matched_filter", "n=1 << 14, k=127, planted_at=5000, block=1 << 12"),
    ("wavelet_denoise", "n=1 << 12"),
])
def test_example_runs_with_jax_blocked(name, sizes):
    # the example's run() at a small size in a fresh interpreter where
    # ``import jax`` fails: every check holds and nothing of the JAX
    # package is loaded
    code = f"""
import runpy, sys
sys.modules["jax"] = None
sys.path.insert(0, {str(REPO)!r})
from veles.simd_tpu_torch.utils.config import set_config
set_config(device="cpu")
ns = runpy.run_path({str(EXAMPLES / (name + "_torch.py"))!r},
                    run_name="example")
res = ns["run"]({sizes})
assert all(res["checks"].values()), res["checks"]
bad = sorted(m for m in sys.modules
             if m == "veles.simd_tpu" or m.startswith("veles.simd_tpu."))
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
