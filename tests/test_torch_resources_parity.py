"""The resource axis of the spectral families, held to the JAX
package's.

Every spectral route core of the JAX package is an
``obs.instrumented_jit`` labelled with its ``op``/``route``, so after
an ``stft``, ``istft``, ``hilbert`` or ``morlet_cwt`` call its
``obs.resources()`` has a row for the route that ran.  The port's
route cores carry the same labels: the same seeded NumPy inputs, sent
through both packages (JAX on the CPU, the port with
``set_config(device="cpu")``), leave the same set of ``(op, route)``
keys, on the auto-selected routes and on every forced route but the
fused kernel's, and the outputs agree within 1e-4 of max|y|.  Each
port row carries the function's least work (``work=``).

An istft is compared on its interior, the samples past the first and
before the last ``frame_length - hop``: there the overlap envelope
falls to the square of the Hann window's end taps (2.3e-8 at 256
samples), whose reciprocal magnifies either package's float32
round-off up to 4e7 times (``spectral.istft``'s docstring).
"""

import numpy as np
import pytest

from veles.simd_tpu import obs as jobs
from veles.simd_tpu.ops import batched as jbt
from veles.simd_tpu.ops import spectral as jsp
from veles.simd_tpu_torch import obs as tobs
from veles.simd_tpu_torch.ops import batched as tbt
from veles.simd_tpu_torch.ops import cuda_kernels as tck
from veles.simd_tpu_torch.ops import spectral as tsp
from veles.simd_tpu_torch.utils import benchmark as bm
from veles.simd_tpu_torch.utils import config

TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu_and_telemetry():
    prev = config.get_config().device
    config.set_config(device="cpu")
    try:
        yield
    finally:
        for o in (jobs, tobs):
            o.disable()
            o.reset()
        config.set_config(device=prev)


def _rng(seed):
    return np.random.RandomState(seed)


def _inputs(family, n, rows, seed):
    x = _rng(seed).randn(rows, n).astype(np.float32)
    if family == "istft":
        return jsp.stft_na(x, 256, 64).astype(np.complex64)
    return x


def _call(pkg, family, operand, n, route):
    sp = jsp if pkg == "jax" else tsp
    kw = {} if route is None else {"route": route}
    if family == "stft":
        return sp.stft(operand, 256, 64, **kw)
    if family == "istft":
        return sp.istft(operand, n, 256, 64, **kw)
    if family == "hilbert":
        return sp.hilbert(operand, **kw)
    if family == "morlet_cwt":
        return sp.morlet_cwt(operand, [2.0, 4.0, 8.0], **kw)
    bt = jbt if pkg == "jax" else tbt
    return bt.batched_stft(operand, 256, 64)


def _run(pkg, family, operand, n, route):
    o = jobs if pkg == "jax" else tobs
    o.reset()
    o.enable()
    try:
        out = _call(pkg, family, operand, n, route)
        rows = [r for r in o.resources()]
    finally:
        o.disable()
    return np.asarray(out), rows


# (family, n, rows, route): the auto pick at two lengths (each family's
# dense route below its bound, its FFT or factored route above it) and
# every forced route of the four tables but the fused kernel's
CASES = [
    ("stft", 2048, 3, None),
    ("stft", 2048, 1, "xla_fft"),
    ("stft", 2048, 2, "rdft_matmul"),
    ("stft", 2048, 2, "rdft_matmul_bf16_comp"),
    ("istft", 2048, 3, None),
    ("istft", 2048, 2, "xla_fft"),
    ("istft", 2048, 2, "rdft_matmul"),
    ("istft", 2048, 1, "rdft_matmul_bf16_comp"),
    ("hilbert", 512, 3, None),
    ("hilbert", 2048, 2, None),
    ("hilbert", 512, 2, "xla_fft"),
    ("hilbert", 512, 2, "matmul_dft"),
    ("hilbert", 512, 1, "matmul_dft_bf16_comp"),
    ("morlet_cwt", 512, 2, None),
    ("morlet_cwt", 2048, 1, None),
    ("morlet_cwt", 512, 1, "xla_fft"),
    ("morlet_cwt", 512, 2, "matmul_dft"),
    ("morlet_cwt", 512, 1, "matmul_dft_bf16_comp"),
    ("morlet_cwt", 2048, 2, "ct_matmul"),
    ("batched_stft", 2048, 4, None),
]


@pytest.mark.parametrize("family,n,rows,route", CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}-{c[3] or 'auto'}"
                              for c in CASES])
def test_resource_keys_equal_the_jax_packages(family, n, rows, route):
    operand = _inputs(family, n, rows, seed=len(family) * 100 + n + rows)
    jy, jrows = _run("jax", family, operand, n, route)
    ty, trows = _run("torch", family, operand, n, route)
    jkeys = {(r["op"], r["route"]) for r in jrows}
    tkeys = {(r["op"], r["route"]) for r in trows}
    assert tkeys == jkeys, (tkeys, jkeys)
    assert len(tkeys) == 1
    if route is not None and family != "batched_stft":
        assert tkeys == {(family, route)}
    assert ty.shape == jy.shape
    if family == "istft":
        edge = 256 - 64
        ty, jy = ty[..., edge:n - edge], jy[..., edge:n - edge]
    scale = float(np.max(np.abs(jy)))
    assert float(np.max(np.abs(ty - jy))) <= TOL * scale


def _work(family, operand, n):
    rows = int(np.prod(operand.shape[:-1]))
    if family in ("stft", "batched_stft"):
        return bm.stft_work(rows, n, 256, 64)
    if family == "istft":
        rows = int(np.prod(operand.shape[:-2]))
        frames = operand.shape[-2]
        flops = rows * (frames * (bm.rfft_flops(256) + 512) + n)
        return flops, (8.0 * rows * frames * 129
                       + 4.0 * (256 + n + rows * n))
    if family == "hilbert":
        return (rows * (3 * bm.rfft_flops(n) + 2 * n),
                4.0 * (rows * n + n) + 8.0 * rows * n)
    s = 3
    return (rows * (bm.rfft_flops(n) + s * (2 * n + 2 * bm.rfft_flops(n))),
            4.0 * (rows * n + s * n) + 8.0 * rows * s * n)


@pytest.mark.parametrize("family,n,rows,route", [
    ("stft", 2048, 2, None), ("stft", 2048, 2, "xla_fft"),
    ("istft", 2048, 2, "xla_fft"), ("istft", 2048, 2, "rdft_matmul"),
    ("hilbert", 512, 2, "matmul_dft"), ("hilbert", 512, 2, "xla_fft"),
    ("morlet_cwt", 512, 2, "matmul_dft"),
    ("morlet_cwt", 2048, 2, "ct_matmul"),
    ("morlet_cwt", 512, 2, "xla_fft"), ("batched_stft", 2048, 2, None)])
def test_rows_carry_the_functions_least_work(family, n, rows, route):
    operand = _inputs(family, n, rows, seed=7)
    _y, trows = _run("torch", family, operand, n, route)
    (row,) = trows
    flops, nbytes = _work(family, operand, n)
    assert row["flops"] == pytest.approx(flops)
    assert row["bytes_accessed"] == pytest.approx(nbytes)
    pct = row["attainable_pct_of_roofline"]
    assert pct is not None and 0.0 < pct <= 100.0


def test_a_route_core_records_once_per_geometry_and_nests_silently():
    x = _inputs("stft", 2048, 2, seed=3)
    tobs.reset()
    tobs.enable()
    tsp.stft(x, 256, 64)
    tsp.stft(x, 256, 64)
    tsp.stft(x[:1], 256, 64)
    # one row a key, its analyses the geometries seen
    (row,) = [r for r in tobs.resources() if r["op"] == "stft"]
    assert row["analyses"] == 2
    # batched_stft's handle holds the core: one row, the handle's
    tobs.reset()
    tbt.batched_stft(x, 256, 64)
    assert {(r["op"], r["route"]) for r in tobs.resources()} == {
        ("batched_stft", "rdft_matmul")}


def test_telemetry_off_records_nothing():
    x = _inputs("hilbert", 512, 2, seed=5)
    tobs.reset()
    tobs.disable()
    tsp.hilbert(x)
    assert tobs.resources() == []


# ---------------------------------------------------------------------------
# every other family: the JAX package's instrumented cores against the
# port's, through the kernel-route mapping
# ---------------------------------------------------------------------------

# JAX key -> port key where the port launches a hand-written kernel:
# there the port leaves its route unwrapped, and the kernel wrapper's
# ("cuda", kernel) row stands for the JAX core's (a nested
# instrumented call records nothing in either package)
KERNEL_ROUTES = {
    ("convolve", "os_pallas"): ("cuda", "overlap_save"),
    ("convolve", "direct_pallas"): ("cuda", "filter_bank"),
    ("filter_bank_pallas", "default"): ("cuda", "filter_bank"),
    ("fused_cascade", "default"): ("cuda", "cascade_bank"),
    ("convolve2d", "direct_pallas"): ("cuda", "filter_2d"),
    ("stft", "pallas_fused"): ("cuda", "stft"),
}

_MODULES = {"ar": "arithmetic", "mf": "mathfun", "mx": "matrix",
            "nm": "normalize", "dp": "detect_peaks", "fl": "filters",
            "iir": "iir", "rs": "resample", "wv": "wavelet",
            "cv": "convolve", "cc": "correlate", "c2": "convolve2d",
            "bt": "batched", "sp": "spectral"}

# a kernel route's gate, opened in both packages so that the CPU runs
# it (the JAX package's Pallas kernel in interpret mode, the port's
# kernel wrapper as its plain version): name -> (module, JAX gate,
# the port's device term in ops/cuda_kernels.py that opens its gate)
GATES = {"fused": ("wv", "_use_fused_cascade", "on_card"),
         "wavelet": ("wv", "_use_pallas", "should_route"),
         "direct": ("cv", "_use_pallas_direct", "should_route"),
         "os": ("cv", "_use_pallas_os", "on_card"),
         "direct2d": ("c2", "_use_pallas_direct2d", "on_card")}


def _mods(pkg):
    import importlib
    import types

    base = "veles.simd_tpu" if pkg == "jax" else "veles.simd_tpu_torch"
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{base}.ops.{v}")
        for k, v in _MODULES.items()})


def _f32(seed, *shape):
    return _rng(seed).randn(*shape).astype(np.float32)


def _i16(seed, *shape):
    return _rng(seed).randint(-30000, 30000, shape).astype(np.int16)


def _sos():
    return np.array([[0.00482434, 0.00964869, 0.00482434, 1.0,
                      -1.04859958, 0.29614036],
                     [1.0, 2.0, 1.0, 1.0, -1.32091343, 0.63273879]])


def _conv_algo(m, algo, n, k):
    handle = m.cv.convolve_initialize(
        n, k, getattr(m.cv.ConvolutionAlgorithm, algo))
    return m.cv.convolve(handle, _f32(n + k, n), _f32(n - k, k))


def _stream_conv(m):
    s = m.cv.StreamingConvolution(_f32(124, 33), 128)
    x = _f32(125, 512)
    return [s.process(x[i:i + 128]) for i in range(0, 512, 128)]


def _stream_sos(m):
    s = m.iir.StreamingSosfilt(_sos())
    x = _f32(77, 512)
    return [s.process(x[i:i + 128]) for i in range(0, 512, 128)]


def _times():
    return np.sort(_rng(162).rand(100)) * 10


# (family, case, call on the package's modules, kernel gate opened)
OPS_CASES = [
    ("arithmetic", "int16_to_float",
     lambda m: m.ar.int16_to_float(_i16(1, 3, 64)), None),
    ("arithmetic", "float_to_int16",
     lambda m: m.ar.float_to_int16(_f32(2, 3, 64) * 1e4), None),
    ("arithmetic", "int32_to_float",
     lambda m: m.ar.int32_to_float(_i16(3, 64).astype(np.int32)), None),
    ("arithmetic", "float_to_int32",
     lambda m: m.ar.float_to_int32(_f32(4, 64) * 1e6), None),
    ("arithmetic", "int16_to_int32",
     lambda m: m.ar.int16_to_int32(_i16(5, 64)), None),
    ("arithmetic", "int32_to_int16",
     lambda m: m.ar.int32_to_int16(_i16(6, 64).astype(np.int32) * 3),
     None),
    ("arithmetic", "float16_to_float",
     lambda m: m.ar.float16_to_float(_f32(7, 64).astype(np.float16)),
     None),
    ("arithmetic", "int16_multiply",
     lambda m: m.ar.int16_multiply(_i16(8, 64), _i16(9, 64)), None),
    ("arithmetic", "real_multiply",
     lambda m: m.ar.real_multiply(_f32(10, 2, 64), _f32(11, 2, 64)), None),
    ("arithmetic", "real_multiply_array",
     lambda m: m.ar.real_multiply_array(_f32(10, 64), _f32(11, 64)), None),
    ("arithmetic", "real_multiply_scalar",
     lambda m: m.ar.real_multiply_scalar(_f32(12, 64), 1.5), None),
    ("arithmetic", "complex_multiply",
     lambda m: m.ar.complex_multiply(_f32(13, 64), _f32(14, 64)), None),
    ("arithmetic", "complex_multiply_conjugate",
     lambda m: m.ar.complex_multiply_conjugate(_f32(15, 64), _f32(16, 64)),
     None),
    ("arithmetic", "complex_conjugate",
     lambda m: m.ar.complex_conjugate(_f32(17, 64)), None),
    ("arithmetic", "sum_elements",
     lambda m: m.ar.sum_elements(_f32(18, 3, 64)), None),
    ("arithmetic", "add_to_all",
     lambda m: m.ar.add_to_all(_f32(19, 64), 2.5), None),
    ("mathfun", "sin", lambda m: m.mf.sin_psv(_f32(20, 256)), None),
    ("mathfun", "cos", lambda m: m.mf.cos_psv(_f32(21, 256)), None),
    ("mathfun", "log",
     lambda m: m.mf.log_psv(np.abs(_f32(22, 256)) + 0.1), None),
    ("mathfun", "exp", lambda m: m.mf.exp_psv(_f32(23, 256)), None),
    ("mathfun", "sqrt",
     lambda m: m.mf.sqrt_psv(np.abs(_f32(24, 256))), None),
    ("mathfun", "pow",
     lambda m: m.mf.pow_psv(np.abs(_f32(25, 256)) + 0.5, _f32(26, 256)),
     None),
    ("matrix", "add",
     lambda m: m.mx.matrix_add(_f32(30, 16, 32), _f32(31, 16, 32)), None),
    ("matrix", "sub",
     lambda m: m.mx.matrix_sub(_f32(32, 16, 32), _f32(33, 16, 32)), None),
    ("matrix", "gemm-auto",
     lambda m: m.mx.matrix_multiply(_f32(34, 16, 32), _f32(35, 32, 8)),
     None),
    ("matrix", "gemm-bf16_comp",
     lambda m: m.mx.matrix_multiply(_f32(34, 16, 32), _f32(35, 32, 8),
                                    precision="bf16_comp"), None),
    ("matrix", "gemm-bf16",
     lambda m: m.mx.matrix_multiply(_f32(34, 16, 32), _f32(35, 32, 8),
                                    precision="bf16"), None),
    ("matrix", "gemm-int8",
     lambda m: m.mx.matrix_multiply(_f32(34, 16, 32), _f32(35, 32, 8),
                                    precision="int8"), None),
    ("matrix", "gemm_t-auto",
     lambda m: m.mx.matrix_multiply_transposed(_f32(36, 2, 16, 32),
                                               _f32(37, 2, 8, 32)), None),
    ("matrix", "gemm_t-fp32",
     lambda m: m.mx.matrix_multiply_transposed(
         _f32(36, 16, 32), _f32(37, 8, 32), precision="fp32"), None),
    ("matrix", "gemv",
     lambda m: m.mx.matrix_vector_multiply(_f32(38, 16, 32),
                                           _f32(39, 32)), None),
    ("normalize", "normalize2D",
     lambda m: m.nm.normalize2D(
         _rng(40).randint(0, 255, (2, 16, 24)).astype(np.uint8)), None),
    ("normalize", "normalize2D_minmax",
     lambda m: m.nm.normalize2D_minmax(-1.0, 2.0, _f32(41, 16, 24)), None),
    ("normalize", "minmax2D",
     lambda m: m.nm.minmax2D(_f32(42, 2, 16, 24)), None),
    ("normalize", "minmax1D",
     lambda m: m.nm.minmax1D(_f32(43, 3, 64)), None),
    ("detect_peaks", "detect_peaks",
     lambda m: m.dp.detect_peaks(_f32(50, 256)), None),
    ("detect_peaks", "detect_peaks_fixed",
     lambda m: m.dp.detect_peaks_fixed(_f32(51, 2, 256), max_peaks=64),
     None),
    ("detect_peaks", "peak_prominences",
     lambda m: m.dp.peak_prominences(_f32(52, 256), [3, 50, 100]), None),
    ("detect_peaks", "peak_widths",
     lambda m: m.dp.peak_widths(_f32(53, 256), [3, 50, 100]), None),
    ("detect_peaks", "find_peaks",
     lambda m: m.dp.find_peaks(_f32(54, 256), height=0.0)[0], None),
    ("detect_peaks", "find_peaks-prominence",
     lambda m: m.dp.find_peaks(_f32(55, 256), prominence=0.5)[0], None),
    ("detect_peaks", "find_peaks-width",
     lambda m: m.dp.find_peaks(_f32(56, 256), width=1.0)[0], None),
    ("filters", "order_filter",
     lambda m: m.fl.order_filter(_f32(60, 2, 128), 1, 5), None),
    ("filters", "medfilt", lambda m: m.fl.medfilt(_f32(61, 128), 7), None),
    ("filters", "medfilt-sort",
     lambda m: m.fl.medfilt(_f32(61, 128), 41), None),
    ("filters", "medfilt2d",
     lambda m: m.fl.medfilt2d(_f32(62, 24, 20), 3), None),
    ("filters", "wiener", lambda m: m.fl.wiener(_f32(63, 2, 128), 5), None),
    ("filters", "wiener-noise",
     lambda m: m.fl.wiener(_f32(64, 128), 5, noise=0.5), None),
    ("filters", "savgol",
     lambda m: m.fl.savgol_filter(_f32(65, 128), 11, 3), None),
    ("iir", "sosfilt", lambda m: m.iir.sosfilt(_sos(), _f32(70, 2, 256)),
     None),
    ("iir", "sosfilt-zi",
     lambda m: m.iir.sosfilt(_sos(), _f32(71, 2, 256),
                             zi=_f32(72, 2, 2) * 0.1, return_zf=True),
     None),
    ("iir", "sosfiltfilt",
     lambda m: m.iir.sosfiltfilt(_sos(), _f32(73, 256)), None),
    ("iir", "filtfilt",
     lambda m: m.iir.filtfilt([0.2, 0.3], [1.0, -0.5], _f32(74, 256)),
     None),
    ("iir", "lfilter",
     lambda m: m.iir.lfilter([0.2, 0.3, 0.1], [1.0, -0.5, 0.1],
                             _f32(75, 2, 256)), None),
    ("iir", "lfilter-fir",
     lambda m: m.iir.lfilter([0.2, 0.3, 0.1], [1.0], _f32(76, 256)), None),
    ("iir", "streaming", _stream_sos, None),
    ("resample", "resample_poly",
     lambda m: m.rs.resample_poly(_f32(80, 2, 300), 3, 2), None),
    ("resample", "upfirdn",
     lambda m: m.rs.upfirdn(_f32(81, 9), _f32(82, 200), 2, 3), None),
    ("resample", "decimate-fir",
     lambda m: m.rs.decimate(_f32(83, 400), 4), None),
    ("resample", "decimate-iir",
     lambda m: m.rs.decimate(_f32(84, 400), 4, ftype="iir"), None),
    ("resample", "resample_fourier",
     lambda m: m.rs.resample_fourier(_f32(85, 2, 300), 200), None),
    ("resample", "upsample", lambda m: m.rs.upsample(_f32(86, 200), 3),
     None),
    ("wavelet", "dwt-auto",
     lambda m: m.wv.wavelet_apply("daub", 8, "periodic", _f32(90, 2, 256)),
     None),
    ("wavelet", "dwt-xla_conv",
     lambda m: m.wv.wavelet_apply("daub", 8, "mirror", _f32(90, 2, 256),
                                  route="xla_conv"), None),
    ("wavelet", "dwt-pallas",
     lambda m: m.wv.wavelet_apply("daub", 8, "periodic", _f32(91, 8, 256),
                                  route="pallas"), None),
    ("wavelet", "dwt-kernel-gate",
     lambda m: m.wv.wavelet_apply("daub", 8, "periodic", _f32(91, 8, 256)),
     "wavelet"),
    ("wavelet", "swt-auto",
     lambda m: m.wv.stationary_wavelet_apply("daub", 4, 2, "periodic",
                                             _f32(92, 256)), None),
    ("wavelet", "swt-pallas",
     lambda m: m.wv.stationary_wavelet_apply(
         "daub", 4, 2, "periodic", _f32(92, 8, 256), route="pallas"), None),
    ("wavelet", "transform",
     lambda m: m.wv.wavelet_transform("daub", 4, "periodic",
                                      _f32(93, 256), 3), None),
    ("wavelet", "transform-fused",
     lambda m: m.wv.wavelet_transform("daub", 4, "periodic",
                                      _f32(94, 8, 256), 3), "fused"),
    ("wavelet", "reconstruct",
     lambda m: m.wv.wavelet_reconstruct("daub", 8, _f32(95, 128),
                                        _f32(96, 128)), None),
    ("wavelet", "reconstruct-mirror",
     lambda m: m.wv.wavelet_reconstruct("daub", 4, _f32(95, 128),
                                        _f32(96, 128), ext="mirror"),
     None),
    ("wavelet", "swt_reconstruct",
     lambda m: m.wv.stationary_wavelet_reconstruct(
         "daub", 4, 2, _f32(97, 128), _f32(98, 128)), None),
    ("wavelet", "swt_reconstruct-zero",
     lambda m: m.wv.stationary_wavelet_reconstruct(
         "daub", 4, 1, _f32(97, 128), _f32(98, 128), ext="zero"), None),
    ("wavelet", "inverse",
     lambda m: m.wv.wavelet_inverse_transform(
         "daub", 4, m.wv.wavelet_transform("daub", 4, "periodic",
                                           _f32(99, 256), 2)), None),
    ("wavelet", "apply2d",
     lambda m: m.wv.wavelet_apply2d("daub", 4, "periodic",
                                    _f32(100, 32, 32)), None),
    ("convolve", "simd",
     lambda m: m.cv.convolve_simd(_f32(110, 2, 300), _f32(111, 17)), None),
    ("convolve", "auto-short",
     lambda m: m.cv.convolve(_f32(112, 300), _f32(113, 9)), None),
    ("convolve", "auto-long",
     lambda m: m.cv.convolve(_f32(114, 4000), _f32(115, 300)), None),
    ("convolve", "brute", lambda m: _conv_algo(m, "BRUTE_FORCE", 500, 31),
     None),
    ("convolve", "fft", lambda m: _conv_algo(m, "FFT", 500, 31), None),
    ("convolve", "os", lambda m: _conv_algo(m, "OVERLAP_SAVE", 3000, 300),
     None),
    ("convolve", "os-fft",
     lambda m: _conv_algo(m, "OVERLAP_SAVE", 36000, 17000), None),
    ("convolve", "fftconvolve",
     lambda m: m.cv.fftconvolve(_f32(116, 500), _f32(117, 40),
                                mode="same"), None),
    ("convolve", "oaconvolve",
     lambda m: m.cv.oaconvolve(_f32(118, 500), _f32(119, 40),
                               mode="valid"), None),
    ("convolve", "correlate",
     lambda m: m.cc.cross_correlate(_f32(120, 500), _f32(121, 40)), None),
    ("convolve", "stream", _stream_conv, None),
    ("convolve", "direct-kernel-gate",
     lambda m: m.cv.convolve_simd(_f32(122, 8, 300), _f32(123, 17)),
     "direct"),
    ("convolve", "os-kernel-gate",
     lambda m: _conv_algo(m, "OVERLAP_SAVE", 3000, 300), "os"),
    ("convolve2d", "auto",
     lambda m: m.c2.convolve2d(_f32(130, 2, 24, 20), _f32(131, 3, 3)),
     None),
    ("convolve2d", "direct",
     lambda m: m.c2.convolve2d(_f32(132, 24, 20), _f32(133, 5, 5),
                               algorithm="direct"), None),
    ("convolve2d", "fft",
     lambda m: m.c2.convolve2d(_f32(134, 24, 20), _f32(135, 5, 5),
                               algorithm="fft"), None),
    ("convolve2d", "same-symm",
     lambda m: m.c2.convolve2d(_f32(136, 24, 20), _f32(137, 5, 5),
                               mode="same", boundary="symm"), None),
    ("convolve2d", "valid",
     lambda m: m.c2.cross_correlate2d(_f32(138, 24, 20), _f32(139, 5, 5),
                                      mode="valid"), None),
    ("convolve2d", "large-kernel",
     lambda m: m.c2.convolve2d(_f32(140, 40, 40), _f32(141, 21, 21)),
     None),
    ("convolve2d", "direct-kernel-gate",
     lambda m: m.c2.convolve2d(_f32(142, 4, 24, 20), _f32(143, 3, 3)),
     "direct2d"),
    ("batched", "resample_poly",
     lambda m: m.bt.batched_resample_poly(_f32(150, 4, 300), 3, 2), None),
    ("batched", "sosfilt",
     lambda m: m.bt.batched_sosfilt(_sos(), _f32(151, 4, 256)), None),
    ("batched", "lfilter",
     lambda m: m.bt.batched_lfilter([0.2, 0.3], [1.0, -0.5],
                                    _f32(152, 4, 256)), None),
    ("spectral", "czt", lambda m: m.sp.czt(_f32(160, 2, 100), 50), None),
    ("spectral", "zoom_fft",
     lambda m: m.sp.zoom_fft(_f32(161, 200), [0.1, 0.4], 64)[1], None),
    ("spectral", "lombscargle",
     lambda m: m.sp.lombscargle(_times(), _f32(163, 100),
                                np.linspace(0.5, 10, 40)), None),
]


def _ops_run(pkg, call, gate, monkeypatch):
    m = _mods(pkg)
    o = jobs if pkg == "jax" else tobs
    with monkeypatch.context() as mp:
        if gate is not None:
            mod, jax_gate, port_seam = GATES[gate]
            if pkg == "jax":
                mp.setattr(getattr(m, mod), jax_gate, lambda *a, **k: True)
            else:
                mp.setattr(tck, port_seam, lambda *a, **k: True)
        o.reset()
        o.enable()
        try:
            out = call(m)
            rows = list(o.resources())
        finally:
            o.disable()
    return out, rows


def _arrays(out):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _arrays(o)]
    if hasattr(out, "cpu"):
        out = out.cpu()
    return [np.asarray(out)]


def _check_family_case(case, monkeypatch):
    _family, _name, call, gate = case
    jy, jrows = _ops_run("jax", call, gate, monkeypatch)
    ty, trows = _ops_run("torch", call, gate, monkeypatch)
    jkeys = {KERNEL_ROUTES.get((r["op"], r["route"]),
                               (r["op"], r["route"])) for r in jrows}
    tkeys = {(r["op"], r["route"]) for r in trows}
    assert tkeys == jkeys, (tkeys, jkeys)
    for r in trows:
        assert np.isfinite(r["flops"]) and r["flops"] > 0, r
        assert np.isfinite(r["bytes_accessed"]) and \
            r["bytes_accessed"] > 0, r
    jys, tys = _arrays(jy), _arrays(ty)
    assert len(tys) == len(jys)
    for t, j in zip(tys, jys):
        assert t.shape == j.shape, (t.shape, j.shape)
        scale = float(np.max(np.abs(j))) if j.size else 0.0
        err = float(np.max(np.abs(t.astype(np.complex128)
                                  - j.astype(np.complex128)))) \
            if j.size else 0.0
        assert err <= TOL * scale, (err, scale)


def _family(name):
    return [pytest.param(c, id=c[1]) for c in OPS_CASES if c[0] == name]


@pytest.mark.parametrize("case", _family("arithmetic"))
def test_arithmetic_rows_equal_the_jax_packages(case, monkeypatch):
    _check_family_case(case, monkeypatch)


@pytest.mark.parametrize("case", _family("mathfun"))
def test_mathfun_rows_equal_the_jax_packages(case, monkeypatch):
    _check_family_case(case, monkeypatch)


@pytest.mark.parametrize("case", _family("matrix"))
def test_matrix_rows_equal_the_jax_packages(case, monkeypatch):
    _check_family_case(case, monkeypatch)


@pytest.mark.parametrize("case", _family("normalize"))
def test_normalize_rows_equal_the_jax_packages(case, monkeypatch):
    _check_family_case(case, monkeypatch)


@pytest.mark.parametrize("case", _family("detect_peaks"))
def test_detect_peaks_rows_equal_the_jax_packages(case, monkeypatch):
    _check_family_case(case, monkeypatch)


@pytest.mark.parametrize("case", _family("filters"))
def test_filters_rows_equal_the_jax_packages(case, monkeypatch):
    _check_family_case(case, monkeypatch)


@pytest.mark.parametrize("case", _family("iir"))
def test_iir_rows_equal_the_jax_packages(case, monkeypatch):
    _check_family_case(case, monkeypatch)


@pytest.mark.parametrize("case", _family("resample"))
def test_resample_rows_equal_the_jax_packages(case, monkeypatch):
    _check_family_case(case, monkeypatch)


@pytest.mark.parametrize("case", _family("wavelet"))
def test_wavelet_rows_equal_the_jax_packages(case, monkeypatch):
    _check_family_case(case, monkeypatch)


@pytest.mark.parametrize("case", _family("convolve"))
def test_convolve_rows_equal_the_jax_packages(case, monkeypatch):
    _check_family_case(case, monkeypatch)


@pytest.mark.parametrize("case", _family("convolve2d"))
def test_convolve2d_rows_equal_the_jax_packages(case, monkeypatch):
    _check_family_case(case, monkeypatch)


@pytest.mark.parametrize("case", _family("batched"))
def test_batched_rows_equal_the_jax_packages(case, monkeypatch):
    _check_family_case(case, monkeypatch)


@pytest.mark.parametrize("case", _family("spectral"))
def test_spectral_czt_lombscargle_rows_equal_the_jax_packages(
        case, monkeypatch):
    _check_family_case(case, monkeypatch)


def _core_labels(base):
    """``(op, route)`` of every instrumented core a family module
    holds: its globals and the values of its module-level dicts."""
    import importlib

    labels = set()
    for name in set(_MODULES.values()):
        mod = importlib.import_module(f"{base}.ops.{name}")
        for v in vars(mod).values():
            for c in [v] + (list(v.values()) if isinstance(v, dict)
                            else []):
                if type(c).__name__ == "InstrumentedJit":
                    labels.add((c.op, c.route))
    return labels


def test_every_jax_core_has_a_port_twin_or_a_kernel_row():
    """Each core the JAX package compiles through ``instrumented_jit``
    in the op families has a port twin under the same labels, but the
    kernel routes, whose rows are the kernel wrappers' (the mapping
    above); and the port adds no label of its own."""
    jax_labels = _core_labels("veles.simd_tpu")
    port_labels = _core_labels("veles.simd_tpu_torch")
    assert jax_labels - port_labels == set(KERNEL_ROUTES) - {
        ("stft", "pallas_fused")}
    assert port_labels <= jax_labels
    assert len(port_labels) >= 60


# chip_smoke.py's table of one op per family, run here on the CPU at
# small sizes: the same keys, alone, and the same literal work
_CHIP_SMOKE = None


def _chip_smoke():
    global _CHIP_SMOKE
    if _CHIP_SMOKE is None:
        import runpy
        from pathlib import Path

        _CHIP_SMOKE = runpy.run_path(
            str(Path(__file__).resolve().parent.parent / "chip_smoke.py"),
            run_name="chip_smoke")
    return _CHIP_SMOKE


SMALL_SIZES = {"rows": 4, "n": 256, "gemm": 32, "imgs": 2, "side": 24,
               "freqs": 16}


def test_chip_smoke_ops_table_holds_on_the_cpu():
    import torch

    cs = _chip_smoke()
    tobs.enable()
    try:
        rows = cs["ops_resource_rows"](torch, tobs, bm,
                                       torch.device("cpu"), _rng(21),
                                       sizes=SMALL_SIZES)
    finally:
        tobs.disable()
    # one row a family of the parity cases, in the table's order
    assert {r["family"] for r in rows} == {c[0] for c in OPS_CASES}
    assert len(rows) == len(cs["OPS_RESOURCE_ROWS"])


@pytest.mark.parametrize("family", sorted({c[0] for c in OPS_CASES}))
def test_chip_smoke_ops_table_keys_are_the_jax_packages(family):
    """The table's op, run through the JAX package on the CPU at the
    small sizes on the same operands, leaves the table's key, alone."""
    import importlib
    import types

    import torch

    cs = _chip_smoke()
    call, key = [(r[1], r[2]) for r in cs["OPS_RESOURCE_ROWS"]
                 if r[0] == family][0]
    operands = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in cs["ops_operands"](
                    torch, _rng(22), torch.device("cpu"),
                    SMALL_SIZES).items()}
    mods = types.SimpleNamespace(**{
        name: importlib.import_module(f"veles.simd_tpu.ops.{name}")
        for name in set(_MODULES.values())})
    jobs.reset()
    jobs.enable()
    try:
        call(mods, operands)
        keys = [(r["op"], r["route"]) for r in jobs.resources()]
    finally:
        jobs.disable()
    assert keys == [key]
