"""The port's C shim (``veles/simd_tpu_torch/cshim.py``) against the JAX
package's (``veles/simd_tpu/cshim.py``), on the CPU.

* every top-level function of the JAX shim has a port twin with the
  same signature, and the ``_C_*`` code maps are the same;
* each twin agrees with the JAX shim on the same NumPy buffers, passed
  by pointer (as the C bridge passes them) to both, at the C suite's
  sizes (``csrc/test_veles_simd.c``), with ``simd`` on and off: within
  1e-5 of max|y| (1e-4 for STFT, ISTFT and CWT), integer outputs and
  return values exact;
* the handle and streaming registries, through their whole flows;
* a bad code raises the same error class in both.

The port's shim computes on the CPU here: it is imported with
``VELES_SIMD_PLATFORM=cpu``, and every test sets ``Config.device`` to
the CPU.  The C bridge itself (``cabi/``) runs in
``tests/test_torch_cabi.py``; the shim's C entries on the card in
``tests/test_torch_cuda.py``.
"""

import dataclasses
import importlib
import inspect
import os

import numpy as np
import pytest

from veles.simd_tpu_torch.utils import config as tconfig

TOL = 1e-5
TOL_SPECTRAL = 1e-4     # STFT, ISTFT and CWT


def _import_port_shim():
    prev = os.environ.get("VELES_SIMD_PLATFORM")
    os.environ["VELES_SIMD_PLATFORM"] = "cpu"
    try:
        return importlib.import_module("veles.simd_tpu_torch.cshim")
    finally:
        if prev is None:
            del os.environ["VELES_SIMD_PLATFORM"]
        else:
            os.environ["VELES_SIMD_PLATFORM"] = prev


@pytest.fixture(scope="module")
def shims():
    jshim = importlib.import_module("veles.simd_tpu.cshim")
    return jshim, _import_port_shim()


@pytest.fixture(autouse=True)
def _cpu():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


def _functions(mod):
    return {name: fn for name, fn in vars(mod).items()
            if inspect.isfunction(fn) and fn.__module__ == mod.__name__}


def test_every_function_has_a_twin_with_its_signature(shims):
    # the public ones are the C bridge's entries: exactly the JAX set;
    # the port adds only private helpers (its one result writer)
    jshim, tshim = shims
    ref, port = _functions(jshim), _functions(tshim)
    assert len([n for n in ref if not n.startswith("_")]) == 90
    assert {n for n in port if not n.startswith("_")} \
        == {n for n in ref if not n.startswith("_")}
    for name, fn in ref.items():
        assert name in port, name
        assert inspect.signature(port[name]) == inspect.signature(fn), name


@pytest.mark.parametrize("table", [
    "_C_WAVELET_TYPES", "_C_EXTENSIONS", "_C_ALGORITHMS",
    "_C_CONV2D_MODES", "_C_CONV2D_BOUNDARIES", "_C_BTYPES",
    "_C_SG_MODES", "_C_CORR_MODES", "_C_CHIRP_METHODS",
    "_C_WINDOW_KINDS"])
def test_code_maps_are_the_jax_maps(shims, table):
    jshim, tshim = shims
    ref, port = getattr(jshim, table), getattr(tshim, table)
    assert list(ref) == list(port)
    for code in ref:
        want, got = ref[code], port[code]
        if hasattr(want, "name"):      # an enum member of either package
            want, got = want.name, got.name
        assert want == got, (table, code)


def test_backend_description_names_the_port(shims):
    _, tshim = shims
    assert tshim.backend_description() == "torch:cpu"


# ---- buffers passed by pointer -------------------------------------------


@dataclasses.dataclass
class Out:
    """An output buffer the shim writes (zeros before the call)."""
    shape: tuple
    dtype: type = np.float32


@dataclasses.dataclass
class InOut:
    """A buffer the shim reads and writes back (a filter state)."""
    value: np.ndarray


def _call(fn, args):
    """Call ``fn`` with every array passed as its address; returns
    ``(return value, written buffers)``."""
    keep, written, flat = [], [], []
    for a in args:
        if isinstance(a, Out):
            a = np.zeros(a.shape, a.dtype)
            written.append(a)
        elif isinstance(a, InOut):
            a = a.value.copy()
            written.append(a)
        elif isinstance(a, np.ndarray):
            a = a.copy()
        if isinstance(a, np.ndarray):
            keep.append(a)
            flat.append(a.ctypes.data)
        else:
            flat.append(a)
    return fn(*flat), written


def _assert_close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    assert np.all(np.isfinite(got)), what
    scale = max(float(np.max(np.abs(want), initial=0.0)), 1e-30)
    err = float(np.max(np.abs(got.astype(np.float64) - want), initial=0.0))
    assert err <= tol * scale, (what, err / scale)


def _parity(shims, name, args, tol=TOL):
    jshim, tshim = shims
    want_rc, want = _call(getattr(jshim, name), args)
    got_rc, got = _call(getattr(tshim, name), args)
    if isinstance(want_rc, tuple):         # (positions, values) etc.
        assert len(got_rc) == len(want_rc)
        for g, w in zip(got_rc, want_rc):
            _assert_close(np.asarray(g), np.asarray(w), tol, name)
    else:
        assert got_rc == want_rc, name
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_close(g, w, tol, f"{name} buffer {i}")


_R = np.random.RandomState(20261017)
SIG64 = np.cos(np.arange(64) * 0.3).astype(np.float32)
SIG120 = np.sin(0.21 * np.arange(120)).astype(np.float32)
SIG256 = np.cos(2 * np.pi * 5 * np.arange(256) / 64).astype(np.float32)
SIG300 = (np.sin(0.37 * np.arange(300))
          + 0.5 * np.cos(1.1 * np.arange(300))).astype(np.float32)
SIG400 = np.cos(2 * np.pi * 7 * np.arange(400) / 400).astype(np.float32)
SIG1000 = np.sin(np.arange(1000) * 0.01).astype(np.float32)
NOISE4096 = (np.sin(0.2 * np.pi * np.arange(4096)) + 0.001
             * np.arange(4096) + 3.0).astype(np.float32)
Y4096 = np.sin(0.2 * np.pi * np.arange(4096) + 0.7).astype(np.float32)
# a correlated noise pair: coherence away from a pure tone's bin is a
# ratio of float32 rounding residues (both packages' fp32 paths lie
# about 1.5e-2 from float64 there), so the parity case uses this pair
# and test_coherence_of_the_c_suite_tone_is_no_worse holds the tone
NOISE_X = _R.randn(4096).astype(np.float32)
NOISE_Y = (0.6 * NOISE_X + 0.4 * _R.randn(4096)).astype(np.float32)
IMG8 = np.sin(np.arange(64) * 0.45).astype(np.float32).reshape(8, 8)
IMG24 = np.sin(np.arange(24) * 0.7).astype(np.float32).reshape(4, 6)
K6 = (0.5 - 0.1 * np.arange(6)).astype(np.float32).reshape(2, 3)
SOS = np.array([[0.0048, 0.0096, 0.0048, 1.0, -1.1429, 0.4128],
                [1.0, 2.0, 1.0, 1.0, -1.4, 0.6]])
PEAKS = np.array([10, 31, 52, 73, 94], np.int64)
U8_PLANE = (_R.rand(12, 20) * 255).astype(np.uint8)


def _sg_quadratic():
    t = np.arange(120) / 120 - 0.5
    return (1 + 2 * t - 3 * t * t).astype(np.float32)


def _irregular_times():
    t = np.cumsum(0.05 + 0.13 * ((np.arange(300, dtype=np.uint64)
                                  * np.uint64(2654435761) >> np.uint64(8))
                                 % 100) / 100.0)
    return t, np.sin(1.7 * t).astype(np.float32)


# (function, args with Out / InOut buffers); each runs with ``simd`` 1
# and 0 where the function takes it (its first argument).
SIMD_CASES = {
    "matrix_add": lambda: [IMG8, IMG8.T.copy(), Out((8, 8)), 8, 8],
    "matrix_sub": lambda: [IMG8, IMG8.T.copy(), Out((8, 8)), 8, 8],
    "matrix_multiply": lambda: [IMG24, IMG24.T.copy(), Out((4, 4)), 6, 4,
                                4, 6],
    "matrix_multiply_transposed": lambda: [IMG24, IMG24, Out((4, 4)), 6,
                                           4, 6, 4],
    "convolve2d": lambda: [0, IMG24, 4, 6, K6, 2, 3, Out((5, 8))],
    "convolve2d_mb": lambda: [1, IMG24, 4, 6, K6, 2, 3, 1, 1, 0.0,
                              Out((4, 6))],
    "convolve_simd": lambda: [SIG1000, 1000, np.full(31, 1 / 31,
                                                     np.float32),
                              31, Out((1030,))],
    "cross_correlate_simd": lambda: [SIG1000, 1000, SIG64[:31], 31,
                                     Out((1030,))],
    "wavelet_apply": lambda: [0, 8, 0, SIG64, 64, Out((32,)), Out((32,))],
    "stationary_wavelet_apply": lambda: [0, 4, 1, 0, SIG64, 64,
                                         Out((64,)), Out((64,))],
    "wavelet_reconstruct": lambda: [0, 8, 0, SIG64[:32], SIG64[32:], 32,
                                    Out((64,))],
    "stationary_wavelet_reconstruct": lambda: [0, 4, 1, 0, SIG64,
                                               SIG64[::-1].copy(), 64,
                                               Out((64,))],
    "wavelet_apply2d": lambda: [0, 4, 0, IMG8, 8, 8] + [Out((4, 4))] * 4,
    "wavelet_reconstruct2d": lambda: [0, 4, 0] + [IMG8[:4, :4].copy(),
                                                  IMG8[4:, :4].copy(),
                                                  IMG8[:4, 4:].copy(),
                                                  IMG8[4:, 4:].copy()]
    + [4, 4, Out((8, 8))],
    "stationary_wavelet_apply2d": lambda: [0, 4, 1, 0, IMG8, 8, 8]
    + [Out((8, 8))] * 4,
    "stationary_wavelet_reconstruct2d": lambda: [0, 4, 1, 0, IMG8,
                                                 IMG8.T.copy(), -IMG8,
                                                 IMG8 * 0.5, 8, 8,
                                                 Out((8, 8))],
    "wavelet_packet_transform": lambda: [0, 4, 0, SIG64, 64, 2,
                                         Out((64,))],
    "wavelet_packet_inverse_transform": lambda: [0, 4, 0, SIG64, 64, 2,
                                                 Out((64,))],
    "wavelet_packet_transform2d": lambda: [0, 4, 0, IMG8, 8, 8, 1,
                                           Out((64,))],
    "wavelet_packet_inverse_transform2d": lambda: [0, 4, 0, IMG8, 8, 8,
                                                   1, Out((8, 8))],
    "pow_psv": lambda: [np.linspace(0.1, 3, 64, dtype=np.float32),
                        np.linspace(-2, 2, 64, dtype=np.float32), 64,
                        Out((64,))],
    "stft": lambda: [SIG256, 256, 64, 32, 0, Out((7, 33, 2))],
    "istft": lambda: [_R.randn(7, 33, 2).astype(np.float32), 256, 64, 32,
                      0, Out((256,))],
    "spectrogram": lambda: [SIG256, 256, 64, 32, 0, Out((7, 33))],
    "hilbert": lambda: [SIG256, 256, Out((256, 2))],
    "envelope": lambda: [SIG256, 256, Out((256,))],
    "morlet_cwt": lambda: [SIG256, 256, np.array([6 * 256 / (2 * np.pi
                                                            * 20), 2.0]),
                           2, 6.0, Out((2, 256, 2))],
    "spectral_detrend": lambda: [NOISE4096, 4096, 0, Out((4096,))],
    "spectral_welch": lambda: [NOISE4096, 4096, 2.0, 256, -1,
                               Out((129,), np.float64), Out((129,))],
    "spectral_periodogram": lambda: [SIG1000, 1000, 2.0,
                                     Out((501,), np.float64),
                                     Out((501,))],
    "spectral_csd": lambda: [NOISE4096, Y4096, 4096, 2.0, 256, -1,
                             Out((129,), np.float64), Out((129, 2))],
    "spectral_coherence": lambda: [NOISE_X, NOISE_Y, 4096, 2.0, 256, -1,
                                   Out((129,), np.float64), Out((129,))],
    "spectral_czt": lambda: [SIG256, 256, 256, 0.0, 0.0, 1.0, 0.0,
                             Out((256, 2))],
    "spectral_zoom_fft": lambda: [SIG256, 256, 0.15, 0.25, 128, 2.0,
                                  Out((128,), np.float64),
                                  Out((128, 2))],
    "spectral_lombscargle": lambda: [*_irregular_times(), 300,
                                     0.5 + 2.5 * np.arange(200) / 199,
                                     200, Out((200,))],
    "upfirdn": lambda: [np.array([0.25, 0.5, 0.25]), 3, SIG400, 400, 3,
                        2, Out((601,))],
    "resample_poly": lambda: [SIG400, 400, 2, 1, 0, 0, Out((800,))],
    "resample_fourier": lambda: [SIG400, 400, 800, Out((800,))],
    "iir_sosfilt_stream": lambda: [SOS, 2, SIG300, 300,
                                   InOut(np.array([[0.1, -0.2],
                                                   [0.05, 0.0]])),
                                   Out((300,))],
    "iir_sosfilt": lambda: [SOS, 2, SIG300, 300, 0, Out((300,))],
    "iir_sosfiltfilt": lambda: [SOS, 2, SIG300, 300, -1, Out((300,))],
    "iir_lfilter": lambda: [np.array([0.2, 0.3, 0.1]), 3,
                            np.array([1.0, -0.4, 0.1]), 3, SIG300, 300,
                            Out((300,))],
    "filt_medfilt": lambda: [SIG120, 120, 5, Out((120,))],
    "filt_order_filter": lambda: [SIG120, 120, 0, 3, Out((120,))],
    "filt_medfilt2d": lambda: [(0.1 * (np.arange(192) % 7)).astype(
        np.float32), 12, 16, 3, 3, Out((12, 16))],
    "filt_savgol": lambda: [_sg_quadratic(), 120, 11, 3, 0, 1.0, 0,
                            Out((120,))],
    "filt_wiener": lambda: [SIG120, 120, 5, 0.5, Out((120,))],
    "wave_chirp": lambda: [np.linspace(0, 1, 256, dtype=np.float32), 256,
                           2.0, 1.0, 20.0, 0, 0.0, Out((256,))],
    "wave_square": lambda: [np.linspace(0, 20, 256, dtype=np.float32),
                            256, 0.3, Out((256,))],
    "wave_sawtooth": lambda: [np.linspace(0, 20, 256, dtype=np.float32),
                              256, 0.5, Out((256,))],
    "wave_gausspulse": lambda: [np.linspace(-1, 1, 256,
                                            dtype=np.float32), 256, 5.0,
                                0.5, -6.0, Out((256,))],
    "wave_unit_impulse": lambda: [64, 7, Out((64,))],
    "normalize2D": lambda: [U8_PLANE, 20, 16, 12, Out((12, 18)), 18],
    "minmax2D": lambda: [U8_PLANE, 20, 16, 12],
    "minmax1D": lambda: [SIG1000, 1000],
    "normalize2D_minmax": lambda: [3, 250, U8_PLANE, 20, 16, 12,
                                   Out((12, 18)), 18],
    "detect_peaks": lambda: [SIG1000 * np.sin(np.arange(1000) * 0.2
                                              ).astype(np.float32),
                             1000, 3],
    "peak_prominences": lambda: [np.sin(0.3 * np.arange(105)).astype(
        np.float32), 105, PEAKS, 5, Out((5,))],
    "peak_widths": lambda: [np.sin(0.3 * np.arange(105)).astype(
        np.float32), 105, PEAKS, 5, 0.5] + [Out((5,))] * 4,
    "find_peaks": lambda: [SIG1000 * np.sin(np.arange(1000) * 0.2
                                            ).astype(np.float32), 1000,
                           0.1, np.nan, np.nan, np.nan, 3, np.nan,
                           np.nan, Out((64,), np.int64), 64],
}

# cases whose tolerance is the spectral one
SPECTRAL = {"stft", "istft", "morlet_cwt"}

# (function, args) with no simd flag (host designs and lengths)
PLAIN_CASES = {
    "wavelet_validate_order": lambda: [0, 8],
    "iir_butterworth": lambda: [4, 0.25, 0.0, 0, Out((2, 6),
                                                     np.float64)],
    "iir_bessel": lambda: [5, 0.2, 0.0, 0, Out((3, 6), np.float64)],
    "iir_cheby1": lambda: [4, 1.0, 0.25, 0.0, 0, Out((2, 6),
                                                     np.float64)],
    "iir_cheby2": lambda: [3, 30.0, 0.2, 0.5, 2, Out((3, 6),
                                                     np.float64)],
    "iir_ellip": lambda: [4, 1.0, 40.0, 0.3, 0.0, 0, Out((2, 6),
                                                         np.float64)],
    "iir_notch": lambda: [0.25, 30.0, Out((1, 6), np.float64)],
    "iir_peak": lambda: [0.25, 30.0, Out((1, 6), np.float64)],
    "iir_sosfilt_zi": lambda: [SOS, 2, Out((2, 2), np.float64)],
    "filt_savgol_coeffs": lambda: [11, 3, 0, 1.0, Out((11,),
                                                      np.float64)],
    "filt_firwin": lambda: [33, np.array([0.4]), 1, 1, 0,
                            Out((33,), np.float64)],
    "filt_firwin_w": lambda: [33, np.array([0.2, 0.5]), 2, 0, 5, 6.0,
                              Out((33,), np.float64)],
    "filt_kaiserord": lambda: [65.0, 0.08, Out((1,), np.uint64),
                               Out((1,), np.float64)],
    "filt_firwin2": lambda: [31, np.array([0.0, 0.5, 1.0]),
                             np.array([1.0, 1.0, 0.0]), 3, 0, 1,
                             Out((31,), np.float64)],
    "filt_remez": lambda: [21, np.array([0.0, 0.2, 0.3, 0.5]), 2,
                           np.array([1.0, 0.0]), 0, 1.0,
                           Out((21,), np.float64)],
    "correlation_lags": lambda: [3, 3, 0, Out((5,), np.int64)],
    "deconvolve": lambda: [np.array([4.0, 13.0, 28.0, 27.0, 18.0]), 5,
                           np.array([4.0, 5.0, 6.0]), 3,
                           Out((3,), np.float64), Out((5,), np.float64)],
    "wave_max_len_seq": lambda: [6, InOut(np.ones(6, np.uint8)), 63,
                                 Out((63,), np.uint8)],
    "wave_get_window": lambda: [5, 64, 8.6, Out((64,), np.float64)],
}


@pytest.mark.parametrize("simd", [1, 0])
@pytest.mark.parametrize("name", sorted(SIMD_CASES))
def test_simd_function_matches_the_jax_shim(shims, name, simd):
    tol = TOL_SPECTRAL if name in SPECTRAL else TOL
    _parity(shims, name, [simd] + SIMD_CASES[name](), tol)


def test_coherence_of_the_c_suite_tone_is_no_worse(shims):
    # the C suite's tone pair (test_psd): off the tone's bin coherence
    # is ill-conditioned in float32, so each package is held to the
    # float64 SciPy value there, the port no further than the JAX shim
    signal = pytest.importorskip("scipy.signal")
    _, want = signal.coherence(NOISE4096.astype(np.float64),
                               Y4096.astype(np.float64), fs=2.0,
                               nperseg=256)
    errs = []
    for shim in shims:
        _, (freqs, coh) = _call(shim.spectral_coherence, [
            1, NOISE4096, Y4096, 4096, 2.0, 256, -1,
            Out((129,), np.float64), Out((129,))])
        errs.append(float(np.max(np.abs(coh - want))))
    assert errs[1] <= errs[0] * 1.25, errs


@pytest.mark.parametrize("name", sorted(PLAIN_CASES))
def test_host_function_matches_the_jax_shim(shims, name):
    _parity(shims, name, PLAIN_CASES[name]())


@pytest.mark.parametrize("simd", [1, 0])
@pytest.mark.parametrize("fn", ["sin", "cos", "log", "exp", "sqrt"])
def test_mathfun_matches_the_jax_shim(shims, fn, simd):
    src = np.linspace(0.1, 12.0, 128, dtype=np.float32)
    _parity(shims, "mathfun", [fn, simd, src, 128, Out((128,))])


@pytest.mark.parametrize("method, wp, ws, n", [
    ("buttord", [0.25], [0.35], 1), ("cheb1ord", [0.25], [0.35], 1),
    ("cheb2ord", [0.2, 0.5], [0.1, 0.6], 2),
    ("ellipord", [0.25], [0.35], 1)])
def test_iir_ord_matches_the_jax_shim(shims, method, wp, ws, n):
    _parity(shims, "iir_ord", [method, np.array(wp), np.array(ws), n, 1.0,
                               40.0, Out((n,), np.float64)])


_CONVERT_IN = {
    "int16_to_float": (np.arange(-300, 300, 5).astype(np.int16), np.float32),
    "float_to_int16": (np.linspace(-4e4, 4e4, 120, dtype=np.float32),
                       np.int16),
    "int32_to_float": (np.arange(-3 << 20, 3 << 20, 52429).astype(
        np.int32), np.float32),
    "float_to_int32": (np.linspace(-3e9, 3e9, 120, dtype=np.float32),
                       np.int32),
    "int16_to_int32": (np.arange(-300, 300, 5).astype(np.int16), np.int32),
    "int32_to_int16": (np.arange(-1 << 17, 1 << 17, 2185).astype(np.int32),
                       np.int16),
    "float16_to_float": (np.linspace(-8, 8, 120).astype(np.float16).view(
        np.uint16), np.float32),
}


@pytest.mark.parametrize("simd", [1, 0])
@pytest.mark.parametrize("name", sorted(_CONVERT_IN))
def test_conversions_match_the_jax_shim(shims, name, simd):
    src, out_dtype = _CONVERT_IN[name]
    _parity(shims, "convert", [name, simd, src, len(src),
                               Out((len(src),), out_dtype)])


@pytest.mark.parametrize("algorithm", [0, 1, 2, 3])
@pytest.mark.parametrize("reverse", [0, 1])
def test_convolution_handles_match_the_jax_shim(shims, algorithm,
                                                reverse):
    # initialize / run / finalize: each shim's registry holds its own
    # package's handle; the C suite's 1000 x 31 geometry
    outs = []
    h = np.linspace(-1, 1, 31).astype(np.float32)
    for shim in shims:
        hid = shim.convolve_initialize(1000, 31, algorithm, reverse)
        y = np.zeros(1030, np.float32)
        assert shim.convolve_run(hid, SIG1000.ctypes.data, h.ctypes.data,
                                 y.ctypes.data) == 0
        assert shim.convolve_finalize(hid) == 0
        assert hid not in shim._handles
        outs.append(y)
    _assert_close(outs[1], outs[0], TOL, f"handle {algorithm}")


@pytest.mark.parametrize("simd", [1, 0])
def test_streaming_convolution_matches_the_jax_shim(shims, simd):
    # four chunks of 250, then the flushed tail (the C suite's flow)
    h = np.linspace(1, 0, 31).astype(np.float32)
    results = []
    for shim in shims:
        sid = shim.streaming_convolve_initialize(h.ctypes.data, 31, 250, 0,
                                                 simd)
        ys = []
        for i in range(0, 1000, 250):
            chunk = SIG1000[i:i + 250].copy()
            y = np.zeros(250, np.float32)
            shim.streaming_convolve_process(sid, chunk.ctypes.data,
                                            y.ctypes.data)
            ys.append(y)
        tail = np.zeros(30, np.float32)
        shim.streaming_convolve_flush(sid, tail.ctypes.data)
        shim.streaming_convolve_finalize(sid)
        results.append(np.concatenate(ys + [tail]))
    _assert_close(results[1], results[0], TOL, "streaming")
    _assert_close(results[1], np.convolve(SIG1000.astype(np.float64), h),
                  TOL, "streaming vs np.convolve")


def test_unfed_stream_flushes_zeros(shims):
    _, tshim = shims
    h = np.ones(5, np.float32)
    sid = tshim.streaming_convolve_initialize(h.ctypes.data, 5, 16, 0, 1)
    tail = np.full(4, 7.0, np.float32)
    tshim.streaming_convolve_flush(sid, tail.ctypes.data)
    tshim.streaming_convolve_finalize(sid)
    assert np.all(tail == 0.0)


def _ptrs(*arrays):
    return [a.ctypes.data for a in arrays]


BAD_CODES = {
    "wavelet type": ("wavelet_apply", lambda b: [1, 7, 8, 0, *_ptrs(
        SIG64), 64, *_ptrs(b, b)]),
    "extension": ("wavelet_apply", lambda b: [1, 0, 8, 9, *_ptrs(SIG64),
                                              64, *_ptrs(b, b)]),
    "algorithm": ("convolve_initialize", lambda b: [100, 5, 9, 0]),
    "conv2d mode": ("convolve2d_mb", lambda b: [1, 0, *_ptrs(IMG24), 4, 6,
                                                *_ptrs(K6), 2, 3, 5, 0,
                                                0.0, *_ptrs(b)]),
    "conv2d boundary": ("convolve2d_mb", lambda b: [1, 0, *_ptrs(IMG24), 4,
                                                    6, *_ptrs(K6), 2, 3, 0,
                                                    7, 0.0, *_ptrs(b)]),
    "btype": ("iir_butterworth", lambda b: [4, 0.25, 0.0, 9, 0]),
    "n_edges": ("iir_ord", lambda b: ["buttord", *_ptrs(b, b), 3, 1.0,
                                      40.0, 0]),
    "ord method": ("iir_ord", lambda b: ["bogusord", *_ptrs(b, b), 1,
                                         1.0, 40.0, 0]),
    "savgol mode": ("filt_savgol", lambda b: [1, *_ptrs(SIG120), 120, 11,
                                              3, 0, 1.0, 9, *_ptrs(b)]),
    "firwin window": ("filt_firwin", lambda b: [33, *_ptrs(
        np.array([0.4])), 1, 1, 3, *_ptrs(b)]),
    "window kind": ("wave_get_window", lambda b: [9, 16, 0.0, *_ptrs(b)]),
    "firwin2 kaiser": ("filt_firwin2", lambda b: [31, *_ptrs(
        np.array([0.0, 1.0]), np.array([1.0, 0.0])), 2, 0, 5,
        *_ptrs(b)]),
    "chirp method": ("wave_chirp", lambda b: [1, *_ptrs(SIG64), 64, 1.0,
                                              1.0, 5.0, 9, 0.0,
                                              *_ptrs(b)]),
    "corr mode": ("correlation_lags", lambda b: [3, 3, 9, *_ptrs(b)]),
    "detrend kind": ("spectral_detrend", lambda b: [1, *_ptrs(SIG64), 64,
                                                    5, *_ptrs(b)]),
    "mathfun name": ("mathfun", lambda b: ["tan", 1, *_ptrs(SIG64), 64,
                                           *_ptrs(b)]),
    "convert name": ("convert", lambda b: ["int8_to_float", 1,
                                           *_ptrs(SIG64), 64, *_ptrs(b)]),
    "packet length": ("wavelet_packet_inverse_transform", lambda b: [
        1, 0, 4, 0, *_ptrs(SIG64), 60, 3, *_ptrs(b)]),
    "packet quad": ("wavelet_packet_transform2d", lambda b: [
        1, 0, 4, 0, *_ptrs(IMG8), 6, 8, 2, *_ptrs(b)]),
}


@pytest.mark.parametrize("what", sorted(BAD_CODES))
def test_bad_code_raises_the_same_error_class(shims, what):
    name, args = BAD_CODES[what]
    classes = []
    for shim in shims:
        scratch = np.zeros(256, np.float64)
        with pytest.raises(Exception) as info:
            getattr(shim, name)(*args(scratch))
        classes.append(type(info.value))
    assert classes[0] is classes[1], (what, classes)
