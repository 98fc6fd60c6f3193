#!/usr/bin/env python3
"""Per-family correctness smoke of the PyTorch/CUDA port on the card.

The port's twin of ``tools/tpu_smoke.py``: each op family runs through
its public entry points of ``veles.simd_tpu_torch`` on the configured
device (the card) against the same float64 or NumPy oracle, at the
same shapes and tolerance as the JAX check, and prints one
``TPU-CHECK`` line (the JAX tool's line, so rows line up).  The family
names and their order are the JAX tool's.  Two families keep the JAX
names but check the port's own kernels, as the JAX ones check its
Pallas kernels:

* ``pallas1d`` — K2 (``filter_bank_cuda``: the DWT's two channels at
  stride 2, the SWT's at dilation 4, and through ``wavelet_apply`` and
  ``convolve_simd``), K1 (``overlap_save_cuda`` at 200,000 x 2047) and
  K4 (``stft_cuda`` at 2 x 40960, 512/128), each against the NumPy
  oracle and against its plain version run in float64; and the
  multi-level cascade (the level loop);
* ``pallas2d`` — K5 (``convolve2d`` direct on 4 x 64 x 48 with 5 x 7,
  which the route sends to ``filter_2d_cuda`` on the card) against the
  oracle and ``filter_2d_plain`` in float64.

``parallel`` runs on the default mesh of the configured device (8
shards of one card, ``$VELES_SIMD_MESH_SHARDS``).

Used two ways:

* ``python3 tools/tpu_smoke_torch.py [--family=NAME ...]`` — exits 1 on
  a failure, 2 without a card (``VELES_SIMD_PLATFORM=cpu`` runs it on
  the CPU, where the kernel wrappers compute their plain versions);
* ``bench_torch.py`` runs it last (and ``bench_torch.py --check`` runs
  only it), one family a stage.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))


def _rel_err(got, want):
    from veles.simd_tpu_torch.utils.platform import to_host

    got = to_host(got).astype(np.complex128)
    want = np.asarray(want, np.complex128)
    scale = np.max(np.abs(want)) or 1.0
    return float(np.max(np.abs(got - want)) / scale)


def _on_device(a):
    """``a`` as a float32 tensor on the configured device."""
    from veles.simd_tpu_torch.utils.platform import to_device

    return to_device(np.asarray(a, np.float32))


def _check_arithmetic(rng):
    from veles.simd_tpu_torch.ops import arithmetic as ar

    i16 = rng.randint(-30000, 30000, 4096).astype(np.int16)
    f = rng.randn(4096).astype(np.float32) * 100
    errs = [
        _rel_err(ar.int16_to_float(i16, simd=True),
                 ar.int16_to_float_na(i16)),
        _rel_err(ar.float_to_int16(f, simd=True), ar.float_to_int16_na(f)),
    ]
    wide = rng.randint(-1 << 20, 1 << 20, 1024).astype(np.int32)
    errs.append(_rel_err(ar.int32_to_int16(wide, simd=True),
                         ar.int32_to_int16_na(wide)))
    a = rng.randn(2048).astype(np.float32)
    b = rng.randn(2048).astype(np.float32)
    errs.append(_rel_err(ar.complex_multiply(a, b, simd=True),
                         ar.complex_multiply_na(a, b)))
    return max(errs), 1e-6


def _check_mathfun(rng):
    from veles.simd_tpu_torch.ops import mathfun as mf

    x = np.abs(rng.randn(65536).astype(np.float32)) + 0.1
    errs = [
        _rel_err(mf.sin_psv(x, simd=True), np.sin(x)),
        _rel_err(mf.cos_psv(x, simd=True), np.cos(x)),
        _rel_err(mf.log_psv(x, simd=True), np.log(x)),
        _rel_err(mf.exp_psv(x, simd=True), np.exp(x)),
    ]
    return max(errs), 1e-5


def _check_matrix(rng):
    from veles.simd_tpu_torch.ops import matrix as mx

    a = rng.randn(256, 192).astype(np.float32)
    b = rng.randn(192, 320).astype(np.float32)
    v = rng.randn(192).astype(np.float32)
    errs = [
        _rel_err(mx.matrix_multiply(a, b, simd=True),
                 mx.matrix_multiply_novec(a, b)),
        _rel_err(mx.matrix_multiply_transposed(a, b.T.copy(), simd=True),
                 mx.matrix_multiply_novec(a, b)),
        _rel_err(mx.matrix_vector_multiply(a, v, simd=True), a @ v),
        _rel_err(mx.matrix_add(a, a, simd=True), a + a),
    ]
    return max(errs), 1e-4


def _check_convolve(rng):
    from veles.simd_tpu_torch.ops import convolve as cv

    x = rng.randn(20000).astype(np.float32)
    h = rng.randn(257).astype(np.float32)
    want = np.convolve(x.astype(np.float64), h.astype(np.float64))
    errs = []
    for algo in cv.ConvolutionAlgorithm:
        handle = cv.convolve_initialize(len(x), len(h), algo)
        errs.append(_rel_err(cv.convolve(handle, x, h, simd=True), want))
    return max(errs), 1e-4


def _check_convolve2d(rng):
    """2D family: the direct and FFT routes, cross_correlate2d, and the
    batched direct route (the 2D kernel's shape class), each vs the
    float64 oracle."""
    from veles.simd_tpu_torch.ops import convolve2d as cv2

    x2 = rng.randn(96, 80).astype(np.float32)
    h2 = rng.randn(9, 13).astype(np.float32)
    want2 = cv2.convolve2d_na(x2, h2)
    errs = []
    for algo in ("direct", "fft"):
        errs.append(_rel_err(cv2.convolve2d(x2, h2, algorithm=algo,
                                            simd=True), want2))
    errs.append(_rel_err(cv2.cross_correlate2d(x2, h2, simd=True),
                         cv2.cross_correlate2d_na(x2, h2)))
    img = rng.randn(8, 128, 96).astype(np.float32)
    k2 = rng.randn(5, 7).astype(np.float32)
    errs.append(_rel_err(cv2.convolve2d(img, k2, algorithm="direct",
                                        simd=True),
                         cv2.convolve2d_na(img, k2)))
    return max(errs), 1e-4


def _check_streaming(rng):
    """StreamingConvolution: chunked == one-shot, for convolution and
    (reversed-h) correlation, with a chunk length that does not divide
    the signal."""
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.utils.platform import to_host

    x = rng.randn(17000).astype(np.float32)
    h = rng.randn(129).astype(np.float32)
    errs = []
    for reverse in (False, True):
        if reverse:
            want = np.correlate(np.pad(x.astype(np.float64), (128, 128)),
                                h.astype(np.float64), mode="valid")
        else:
            want = np.convolve(x.astype(np.float64), h.astype(np.float64))
        sc = cv.StreamingConvolution(h, chunk_length=4096, reverse=reverse)
        parts = []
        for i in range(0, 16384, 4096):
            parts.append(to_host(sc.process(x[i:i + 4096])))
        parts.append(to_host(sc.process(
            np.pad(x[16384:], (0, 4096 - (len(x) - 16384))))))
        parts.append(to_host(sc.flush()))
        got = np.concatenate(parts)[:len(x) + len(h) - 1]
        errs.append(_rel_err(got, want))
    return max(errs), 1e-4


def _check_synthesis(rng):
    """Analysis -> synthesis round trips on the device: 1D DWT and SWT,
    the separable 2D step, the multi-level 1D and 2D pyramids (exact
    PERIODIC inverses), and the non-periodic SWT synthesis against its
    NumPy twin."""
    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.ops.wavelet_coeffs import WaveletType
    from veles.simd_tpu_torch.utils.platform import to_host

    x = rng.randn(2048).astype(np.float32)
    ext = wv.ExtensionType.PERIODIC
    errs = []
    for wtype, order in ((WaveletType.DAUBECHIES, 8),
                         (WaveletType.SYMLET, 12),
                         (WaveletType.COIFLET, 6)):
        hi, lo = wv.wavelet_apply(wtype, order, ext, x, simd=True)
        errs.append(_rel_err(
            wv.wavelet_reconstruct(wtype, order, hi, lo, simd=True), x))
    shi, slo = wv.stationary_wavelet_apply(
        WaveletType.DAUBECHIES, 8, 2, ext, x, simd=True)
    errs.append(_rel_err(wv.stationary_wavelet_reconstruct(
        WaveletType.DAUBECHIES, 8, 2, shi, slo, simd=True), x))
    coeffs = wv.wavelet_transform(WaveletType.SYMLET, 8, ext, x, 3,
                                  simd=True)
    errs.append(_rel_err(wv.wavelet_inverse_transform(
        WaveletType.SYMLET, 8, coeffs, simd=True), x))
    img = rng.randn(128, 96).astype(np.float32)
    ll, lh, hl, hh = wv.wavelet_apply2d(WaveletType.DAUBECHIES, 4, ext, img,
                                        simd=True)
    errs.append(_rel_err(wv.wavelet_reconstruct2d(
        WaveletType.DAUBECHIES, 4, ll, lh, hl, hh, simd=True), img))
    coeffs2 = wv.wavelet_transform2d(WaveletType.DAUBECHIES, 4, ext, img, 2,
                                     simd=True)
    errs.append(_rel_err(wv.wavelet_inverse_transform2d(
        WaveletType.DAUBECHIES, 4, coeffs2, simd=True), img))
    mhi, mlo = wv.stationary_wavelet_apply(
        WaveletType.DAUBECHIES, 8, 1, wv.ExtensionType.MIRROR, x, simd=True)
    rec_m = wv.stationary_wavelet_reconstruct(
        WaveletType.DAUBECHIES, 8, 1, mhi, mlo, simd=True,
        ext=wv.ExtensionType.MIRROR)
    rec_m_na = wv.stationary_wavelet_reconstruct_na(
        WaveletType.DAUBECHIES, 8, 1, to_host(mhi), to_host(mlo),
        ext=wv.ExtensionType.MIRROR)
    errs.append(_rel_err(rec_m, rec_m_na))
    return max(errs), 5e-4


def _check_correlate(rng):
    from veles.simd_tpu_torch.ops import correlate as cr

    x = rng.randn(20000).astype(np.float32)
    h = rng.randn(257).astype(np.float32)
    want = np.correlate(np.pad(x.astype(np.float64), (256, 256)),
                        h.astype(np.float64), mode="valid")
    handle = cr.cross_correlate_initialize(len(x), len(h))
    errs = [_rel_err(cr.cross_correlate(handle, x, h, simd=True), want),
            _rel_err(cr.cross_correlate_simd(x, h, simd=True), want)]
    return max(errs), 1e-4


def _check_wavelet(rng):
    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.ops.wavelet_coeffs import WaveletType

    x = rng.randn(4096).astype(np.float32)
    errs = []
    for wtype, order in ((WaveletType.DAUBECHIES, 8), (WaveletType.SYMLET, 8),
                         (WaveletType.COIFLET, 6)):
        for ext in wv.ExtensionType:
            hi, lo = wv.wavelet_apply(wtype, order, ext, x, simd=True)
            hi_na, lo_na = wv.wavelet_apply_na(wtype, order, ext, x)
            errs += [_rel_err(hi, hi_na), _rel_err(lo, lo_na)]
    shi, slo = wv.stationary_wavelet_apply(
        WaveletType.DAUBECHIES, 8, 2, wv.ExtensionType.PERIODIC, x,
        simd=True)
    shi_na, slo_na = wv.stationary_wavelet_apply_na(
        WaveletType.DAUBECHIES, 8, 2, wv.ExtensionType.PERIODIC, x)
    errs += [_rel_err(shi, shi_na), _rel_err(slo, slo_na)]
    phi, plo = wv.wavelet_apply(
        WaveletType.DAUBECHIES, 8, wv.ExtensionType.PERIODIC, x, simd=True)
    rec = wv.wavelet_reconstruct(WaveletType.DAUBECHIES, 8, phi, plo,
                                 simd=True)
    errs.append(_rel_err(rec, x))
    return max(errs), 5e-4


def _check_spectral(rng):
    """STFT round trip, the forced routes, Hilbert, CWT, the PSD layer,
    chirp-Z and Lomb-Scargle vs their float64 oracles."""
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.utils.platform import to_host

    x = rng.randn(4, 2048).astype(np.float32)
    errs = [_rel_err(sp.stft(x, 256, 64, simd=True),
                     sp.stft_na(x, 256, 64))]
    spec = sp.stft(x, 256, 64, simd=True)
    rec = to_host(sp.istft(spec, 2048, 256, 64, simd=True))
    errs.append(_rel_err(rec[:, 256:-256], x[:, 256:-256]))
    errs.append(_rel_err(sp.stft(x, 256, 64, simd=True,
                                 route="rdft_matmul"),
                         sp.stft_na(x, 256, 64)))
    errs.append(_rel_err(sp.stft(x, 256, 64, simd=True,
                                 route="xla_fft"),
                         sp.stft_na(x, 256, 64)))
    spec64 = sp.stft_na(x, 512, 128)
    want_i = sp.istft_na(spec64, 2048, 512, 128)[:, 512:-512]
    rec_m = to_host(sp.istft(spec64.astype(np.complex64), 2048, 512,
                             128, simd=True, route="rdft_matmul"))
    errs.append(_rel_err(rec_m[:, 512:-512], want_i))
    errs.append(_rel_err(sp.hilbert(x, simd=True), sp.hilbert_na(x)))
    errs.append(_rel_err(
        sp.morlet_cwt(x, [4.0, 16.0, 64.0], simd=True),
        sp.morlet_cwt_na(x, [4.0, 16.0, 64.0])))
    errs.append(_rel_err(sp.detrend(x, "linear", simd=True),
                         sp.detrend_na(x, "linear")))
    errs.append(_rel_err(sp.welch(x, nperseg=256, simd=True)[1],
                         sp.welch_na(x, nperseg=256)[1]))
    errs.append(_rel_err(
        sp.csd(x, x[::-1], nperseg=256, simd=True)[1],
        sp.csd_na(x, x[::-1], nperseg=256)[1]))
    errs.append(_rel_err(sp.czt(x[0], 100, simd=True),
                         sp.czt_na(x[0], 100)))
    tu = np.sort(rng.uniform(0, 50, 400))
    xu = np.sin(1.3 * tu).astype(np.float32)
    fr = np.linspace(0.5, 3.0, 128)
    errs.append(_rel_err(sp.lombscargle(tu, xu, fr, simd=True),
                         sp.lombscargle_na(tu, xu, fr)))
    return max(errs), 1e-4


# The resample smoke's geometries, the JAX tool's
# (tests/test_torch_smoke_shapes.py holds them): the classic 160/147
# pair with an explicit short filter, since the smoke gates parity
# (device vs the same-taps oracle), not filter quality.
RESAMPLE_SMOKE_NTAPS = 641
RESAMPLE_SMOKE_RATES = ((2, 1), (1, 2), (3, 2), (160, 147))
RESAMPLE_SMOKE_SHAPE = (4, 730)


def _resample_smoke_taps(rs, up, down):
    """Explicit taps for the big-rate smoke cases (None keeps the
    default design for the small ones, whose filters are tiny)."""
    if max(up, down) <= 4:
        return None
    return rs._resample_taps(up, down, RESAMPLE_SMOKE_NTAPS)


def _check_resample(rng):
    """Polyphase and Fourier resampling vs their oracles."""
    from veles.simd_tpu_torch.ops import resample as rs

    x = rng.randn(*RESAMPLE_SMOKE_SHAPE).astype(np.float32)
    errs = []
    for up, down in RESAMPLE_SMOKE_RATES:
        taps = _resample_smoke_taps(rs, up, down)
        errs.append(_rel_err(
            rs.resample_poly(x, up, down, taps=taps, simd=True),
            rs.resample_poly_na(x, up, down, taps)))
    errs.append(_rel_err(rs.resample_fourier(x, 333, simd=True),
                         rs.resample_fourier_na(x, 333)))
    errs.append(_rel_err(rs.resample_fourier(x, 1460, simd=True),
                         rs.resample_fourier_na(x, 1460)))
    return max(errs), 1e-4


def _check_iir(rng):
    """The doubling-scan IIR vs the sequential DF2T oracle."""
    from veles.simd_tpu_torch.ops import iir

    x = rng.randn(4, 2048).astype(np.float32)
    errs = []
    sos = iir.butterworth(4, 0.25, "lowpass")
    errs.append(_rel_err(iir.sosfilt(sos, x, simd=True),
                         iir.sosfilt_na(sos, x)))
    sos_bp = iir.butterworth(3, (0.2, 0.6), "bandpass")
    errs.append(_rel_err(iir.sosfiltfilt(sos_bp, x, simd=True),
                         iir.sosfiltfilt_na(sos_bp, x)))
    b = np.array([0.2, 0.3, 0.1])
    a = np.array([1.0, -0.5, 0.2, -0.05])
    errs.append(_rel_err(iir.lfilter(b, a, x, simd=True),
                         iir.lfilter_na(b, a, x)))
    return max(errs), 1e-3


def _check_filters(rng):
    """Median/rank filters and Savitzky-Golay vs their oracles."""
    from veles.simd_tpu_torch.ops import filters as fl

    x = rng.randn(4, 1024).astype(np.float32)
    img = rng.randn(64, 80).astype(np.float32)
    errs = [
        _rel_err(fl.medfilt(x, 7, simd=True), fl.medfilt_na(x, 7)),
        _rel_err(fl.order_filter(x, 1, 5, simd=True),
                 fl.order_filter_na(x, 1, 5)),
        _rel_err(fl.medfilt2d(img, (3, 5), simd=True),
                 fl.medfilt2d_na(img, (3, 5))),
        _rel_err(fl.savgol_filter(x, 11, 3, simd=True),
                 fl.savgol_filter_na(x, 11, 3)),
        _rel_err(fl.savgol_filter(x, 9, 2, deriv=1, simd=True),
                 fl.savgol_filter_na(x, 9, 2, deriv=1)),
        _rel_err(fl.wiener(x, 7, simd=True), fl.wiener_na(x, 7)),
    ]
    return max(errs), 1e-3


def _check_waveforms(rng):
    """Generators vs float64 twins (elementwise closed forms)."""
    from veles.simd_tpu_torch.ops import waveforms as wf
    from veles.simd_tpu_torch.utils.platform import to_host

    t = np.linspace(0, 1, 8192)
    ph = np.linspace(0, 40, 8192)
    # square/sawtooth: float32 phase wrap flips samples within rounding
    # of a cycle boundary; those are masked out
    sq = _away_from_edges(ph, (0.0, 0.3, 1.0))
    saw = _away_from_edges(ph, (0.0, 0.5, 1.0))
    errs = [
        _rel_err(wf.chirp(t, 20, 1.0, 400, simd=True),
                 wf.chirp_na(t, 20, 1.0, 400)),
        _rel_err(wf.gausspulse(t - 0.5, 100, 0.5, simd=True),
                 wf.gausspulse_na(t - 0.5, 100, 0.5)),
        _rel_err(to_host(wf.square(ph, 0.3, simd=True))[sq],
                 wf.square_na(ph, 0.3)[sq]),
        _rel_err(to_host(wf.sawtooth(ph, 0.5, simd=True))[saw],
                 wf.sawtooth_na(ph, 0.5)[saw]),
    ]
    return max(errs), 1e-3


def _away_from_edges(ph, edges, eps=1e-3):
    """Mask of phase samples whose cycle fraction is at least ``eps``
    away from every discontinuity in ``edges``."""
    frac = np.mod(np.asarray(ph, np.float64), 2 * np.pi) / (2 * np.pi)
    dist = np.min([np.abs(frac - e) for e in edges], axis=0)
    return dist > eps


def _check_normalize(rng):
    from veles.simd_tpu_torch.ops import normalize as nz

    plane = rng.randint(0, 256, (64, 96)).astype(np.uint8)
    errs = [_rel_err(nz.normalize2D(plane, simd=True),
                     nz.normalize2D_novec(plane))]
    mn, mx = nz.minmax2D(plane, simd=True)
    mn_na, mx_na = nz.minmax2D_novec(plane)
    errs.append(0.0 if (int(mn), int(mx)) == (int(mn_na), int(mx_na))
                else 1.0)
    f = rng.randn(5000).astype(np.float32)
    fmn, fmx = nz.minmax1D(f, simd=True)
    errs.append(_rel_err([float(fmn), float(fmx)], [f.min(), f.max()]))
    return max(errs), 1e-6


def _check_detect_peaks(rng):
    from veles.simd_tpu_torch.ops import detect_peaks as dp
    from veles.simd_tpu_torch.utils.platform import to_host

    x = np.cumsum(rng.randn(8192)).astype(np.float32)
    pos, vals = dp.detect_peaks(x, dp.ExtremumType.BOTH, simd=True)
    pos_na, vals_na = dp.detect_peaks_na(x, dp.ExtremumType.BOTH)
    pos = to_host(pos)
    if len(pos) != len(pos_na) or not np.array_equal(pos, pos_na):
        return 1.0, 1e-6
    errs = [_rel_err(vals, vals_na)]
    peaks, _ = dp.find_peaks(x)
    errs.append(_rel_err(dp.peak_prominences(x, peaks, simd=True),
                         dp.peak_prominences_na(x, peaks)))
    return max(errs), 1e-6


def _plain_err(got, want):
    """Largest difference of the kernel's outputs (a tensor or a tuple
    of them) from its plain version's, over the plain version's max."""
    from veles.simd_tpu_torch.utils.platform import to_host

    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    scale = max(float(np.max(np.abs(to_host(w)))) for w in want) or 1.0
    return max(float(np.max(np.abs(to_host(g).astype(np.complex128)
                                   - to_host(w))))
               for g, w in zip(got, want)) / scale


def _check_pallas1d(rng):
    """The port's 1D kernels on the card: K2 (``filter_bank_cuda``), K1
    (``overlap_save_cuda``) and K4 (``stft_cuda``) called directly at
    the JAX check's shapes, each against the NumPy oracle and its plain
    version run in float64; K2 through ``wavelet_apply`` (16 rows) and
    ``convolve_simd`` (the C=1 form); and the 3-level cascade (the
    level loop)."""
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.ops import spectral as spl
    from veles.simd_tpu_torch.ops import wavelet as wv

    x = rng.randn(16, 1024).astype(np.float32)
    errs = []
    hi_f, lo_f = wv._filters("daub", 8)
    taps = _on_device(np.stack([hi_f, lo_f]))
    # DWT daub8 periodic (the phase-split stride-2 form)
    x_ext = _on_device(np.concatenate([x, x[:, :8]], axis=1))
    hi, lo = ck.filter_bank_cuda(x_ext, taps, 2, 1, 512)
    want_hi, want_lo = wv.wavelet_apply_na(
        "daub", 8, wv.ExtensionType.PERIODIC, x)
    errs += [_rel_err(hi, want_hi), _rel_err(lo, want_lo),
             _plain_err((hi, lo), ck.filter_bank_plain(
                 x_ext.double(), taps.double(), 2, 1, 512))]
    # SWT level 3 (the dilated single-phase form)
    x_ext = _on_device(np.concatenate([x, x[:, :32]], axis=1))
    shi, slo = ck.filter_bank_cuda(x_ext, taps, 1, 4, 1024)
    want_shi, want_slo = wv.stationary_wavelet_apply_na(
        "daub", 8, 3, wv.ExtensionType.PERIODIC, x)
    errs += [_rel_err(shi, want_shi), _rel_err(slo, want_slo),
             _plain_err((shi, slo), ck.filter_bank_plain(
                 x_ext.double(), taps.double(), 1, 4, 1024))]
    # the integrated routes: wavelet_apply on 16 rows and the batched
    # direct convolution reach K2 on the card
    bhi, blo = wv.wavelet_apply("daub", 8, wv.ExtensionType.MIRROR, x,
                                simd=True)
    whi, wlo = wv.wavelet_apply_na("daub", 8, wv.ExtensionType.MIRROR, x)
    errs += [_rel_err(bhi, whi), _rel_err(blo, wlo)]
    hh = rng.randn(65).astype(np.float32)
    errs.append(_rel_err(cv.convolve_simd(x, hh, simd=True),
                         cv.convolve_na(x, hh)))
    # K1 at the headline filter length, several segments long
    xos = _on_device(rng.randn(200000))
    hos = _on_device(rng.randn(2047))
    yos = ck.overlap_save_cuda(xos, hos)
    errs += [_rel_err(yos, np.convolve(xos.cpu().double().numpy(),
                                       hos.cpu().double().numpy())),
             _plain_err(yos, ck.overlap_save_plain(xos.double(),
                                                   hos.double()))]
    # K4 at 512/128 over 2 rows of 40960
    xst = _on_device(rng.randn(2, 40960))
    window = _on_device(spl.hann_window(512))
    sst = ck.stft_cuda(xst, window, 512, 128)
    errs += [_rel_err(sst, spl.stft_na(xst.cpu().numpy(), 512, 128)),
             _plain_err(sst, ck.stft_plain(xst.double(), window.double(),
                                           512, 128))]
    # the multi-level cascade (the level loop), all four bands
    got = wv.wavelet_transform("daub", 8, wv.ExtensionType.PERIODIC, x,
                               3, simd=True)
    cur, want = x, []
    for _ in range(3):
        w_hi, cur = wv.wavelet_apply_na("daub", 8,
                                        wv.ExtensionType.PERIODIC, cur)
        want.append(w_hi)
    want.append(cur)
    errs += [_rel_err(g, w) for g, w in zip(got, want)]
    return max(errs), 5e-4


def _check_serve(rng):
    """The serving layer end to end on the device: a small Server
    coalescing mixed sosfilt/stft traffic into batched guarded
    dispatches, answers parity-checked against the per-request NumPy
    oracle."""
    from veles.simd_tpu_torch import serve
    from veles.simd_tpu_torch.ops import iir, spectral as sp

    sos = iir.butterworth(4, 0.25, "lowpass")
    errs = []
    with serve.Server(max_batch=4, max_wait_ms=10.0,
                      workers=2) as srv:
        xs = [rng.randn(n).astype(np.float32)
              for n in (300, 500, 500, 777)]
        ts = [srv.submit(serve.Request("sosfilt", x, {"sos": sos}))
              for x in xs]
        for x, t in zip(xs, ts):
            errs.append(_rel_err(t.result(timeout=120.0),
                                 iir.sosfilt_na(sos, x[None, :])[0]))
        xq = rng.randn(1024).astype(np.float32)
        tq = srv.submit(serve.Request(
            "stft", xq, {"frame_length": 128, "hop": 64}))
        errs.append(_rel_err(tq.result(timeout=120.0),
                             sp.stft_na(xq, 128, 64)))
    return max(errs), 2e-3


def _check_pallas2d(rng):
    """K5, the 2D kernel: ``convolve2d`` direct on a batch the route
    sends to ``filter_2d_cuda`` on the card (``VELES_SIMD_DISABLE_
    CUDA2D=1`` closes the route, and the family then checks the cuDNN
    direct route), against the oracle and ``filter_2d_plain`` in
    float64."""
    from veles.simd_tpu_torch.ops import convolve2d as cv2
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.utils.platform import on_cuda

    img = rng.randn(4, 64, 48).astype(np.float32)
    k2 = rng.randn(5, 7).astype(np.float32)
    cuda = on_cuda()
    if cuda and not os.environ.get("VELES_SIMD_DISABLE_CUDA2D") \
            and cv2.select_algorithm2d(5, 7, img.shape) != "direct":
        raise RuntimeError("pallas2d: the direct route's gate refused "
                           f"{img.shape} with 5 x 7 on the card")
    got = cv2.convolve2d(img, k2, algorithm="direct", simd=True)
    xd, kd = _on_device(img), _on_device(k2)
    plain = ck.filter_2d_plain(xd.double(), kd.double(), 68, 54,
                               pad=(4, 6), reverse_taps=True)
    return max(_rel_err(got, cv2.convolve2d_na(img, k2)),
               _plain_err(got, plain)), 5e-4


def _check_parallel(rng):
    """The sharded families on the default mesh (8 shards of one card):
    convolve, matmul, the halo rank filter, Lomb-Scargle, the ring
    pipelines, the STFT round trip, IIR, Welch and polyphase
    resampling, sized from the shard count as the JAX check sizes them
    from the device count."""
    from veles.simd_tpu_torch.ops import convolve2d as cv2
    from veles.simd_tpu_torch.ops import filters as fl
    from veles.simd_tpu_torch.ops import iir as iir_mod
    from veles.simd_tpu_torch.ops import resample as rs_mod
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.parallel import (
        default_mesh, make_mesh, sharded_convolve, sharded_convolve2d_ring,
        sharded_convolve_ring, sharded_istft, sharded_lombscargle,
        sharded_matmul, sharded_medfilt, sharded_resample_poly,
        sharded_sosfilt, sharded_stft, sharded_welch)
    from veles.simd_tpu_torch.utils.platform import to_host

    x = rng.randn(4096).astype(np.float32)
    h = rng.randn(33).astype(np.float32)
    want = np.convolve(x.astype(np.float64), h.astype(np.float64))
    errs = [_rel_err(sharded_convolve(x, h, default_mesh("sp"), axis="sp"),
                     want)]
    a = rng.randn(64, 96).astype(np.float32)
    b = rng.randn(96, 48).astype(np.float32)
    errs.append(_rel_err(sharded_matmul(a, b, default_mesh("tp"), axis="tp"),
                         a.astype(np.float64) @ b.astype(np.float64)))
    errs.append(_rel_err(sharded_medfilt(x, 9, default_mesh("sp")),
                         fl.medfilt_na(x, 9)))
    t_ls = np.sort(rng.rand(1024)) * 50.0
    x_ls = np.sin(1.7 * t_ls).astype(np.float32)
    f_ls = np.linspace(0.5, 3.0, 32)
    errs.append(_rel_err(
        sharded_lombscargle(t_ls, x_ls, f_ls, default_mesh("sp")),
        sp.lombscargle_na(t_ls, x_ls, f_ls)))
    n_dev = default_mesh("sp").shape["sp"]
    xr = rng.randn(2048).astype(np.float32)
    kr = 1500 if n_dev == 1 else (2048 // n_dev) + 600
    hr = rng.randn(kr).astype(np.float32)
    errs.append(_rel_err(
        sharded_convolve_ring(xr, hr, default_mesh("sp"), axis="sp"),
        np.convolve(xr.astype(np.float64), hr.astype(np.float64))))
    img = rng.randn(64, 64).astype(np.float32)
    k2 = rng.randn(40, 30).astype(np.float32)
    mesh2d = make_mesh({"dp": 1, "sp": -1})
    errs.append(_rel_err(sharded_convolve2d_ring(img, k2, mesh2d),
                         cv2.convolve2d_na(img, k2)))
    fl_, hop = 128, 32
    ns = n_dev * fl_ * max(1, 2048 // (n_dev * fl_))
    xs = rng.randn(ns).astype(np.float32)
    spec = sharded_stft(xs, fl_, hop, default_mesh("sp"), axis="sp")
    errs.append(_rel_err(spec, sp.stft_na(xs, fl_, hop)))
    rec = sharded_istft(spec, ns, fl_, hop, default_mesh("sp"), axis="sp")
    errs.append(_rel_err(to_host(rec)[fl_:-fl_],
                         np.asarray(xs, np.float64)[fl_:-fl_]))
    sos = iir_mod.butterworth(3, 0.2, "lowpass")
    xq = rng.randn(n_dev * 256).astype(np.float32)
    errs.append(_rel_err(sharded_sosfilt(sos, xq, default_mesh("sp")),
                         iir_mod.sosfilt_na(sos, xq)))
    _, pw = sharded_welch(xs, default_mesh("sp"), nperseg=fl_)
    _, pw_na = sp.welch_na(np.asarray(xs), nperseg=fl_)
    errs.append(_rel_err(pw, pw_na))
    xr2 = rng.randn(n_dev * 294).astype(np.float32)  # 294*160 % 147 == 0
    errs.append(_rel_err(
        sharded_resample_poly(xr2, 160, 147, default_mesh("sp")),
        rs_mod.resample_poly_na(xr2, 160, 147)))
    return max(errs), 1e-4


FAMILIES = [
    ("arithmetic", _check_arithmetic),
    ("mathfun", _check_mathfun),
    ("matrix", _check_matrix),
    ("convolve", _check_convolve),
    ("convolve2d", _check_convolve2d),
    ("streaming", _check_streaming),
    ("correlate", _check_correlate),
    ("synthesis", _check_synthesis),
    ("wavelet", _check_wavelet),
    ("spectral", _check_spectral),
    ("resample", _check_resample),
    ("iir", _check_iir),
    ("filters", _check_filters),
    ("waveforms", _check_waveforms),
    ("normalize", _check_normalize),
    ("detect_peaks", _check_detect_peaks),
    ("pallas1d", _check_pallas1d),
    ("parallel", _check_parallel),
    ("serve", _check_serve),
    ("pallas2d", _check_pallas2d),
]


def device_name() -> str:
    """The configured device and, on the card, its name."""
    from veles.simd_tpu_torch.utils import platform

    dev = platform.device()
    if dev.type == "cuda":
        import torch

        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


def run_smoke(emit=None, families=None, on_start=None) -> bool:
    """Run every family check on the configured device; True when all
    pass.

    ``families`` restricts to the named subset (order preserved);
    ``on_start(name)`` fires before each family begins.
    ``$VELES_SIMD_SMOKE_SKIP`` (comma-separated family names) excludes
    families even when explicitly requested; an unknown name there is
    reported.  A device loss or timeout in a family is retried under
    the fault policy (``smoke.<family>``), never degraded: a family
    that cannot run on the device fails."""
    from veles.simd_tpu_torch.runtime import faults

    if emit is None:
        emit = lambda s: print(s, file=sys.stderr)  # noqa: E731
    skip = {s.strip() for s in
            os.environ.get("VELES_SIMD_SMOKE_SKIP", "").split(",")
            if s.strip()}
    known = {n for n, _ in FAMILIES}
    for bad in sorted(skip - known):
        emit(f"TPU-CHECK WARNING: unknown family {bad!r} in "
             f"VELES_SIMD_SMOKE_SKIP (known: {sorted(known)})")
    device = device_name()
    rng = np.random.RandomState(7)
    all_ok = True
    for name, check in FAMILIES:
        if families is not None and name not in families:
            continue
        if name in skip:
            emit(f"TPU-CHECK family={name} SKIPPED "
                 "(VELES_SIMD_SMOKE_SKIP)")
            continue
        if on_start is not None:
            on_start(name)
        try:
            err, tol = faults.guarded(f"smoke.{name}",
                                      lambda: check(rng))
            ok = err <= tol
        except Exception as e:  # noqa: BLE001 — reported, next family
            err, tol, ok = float("nan"), 0.0, False
            emit(f"TPU-CHECK family={name} EXCEPTION: {e!r}")
        all_ok &= ok
        emit(f"TPU-CHECK family={name} device={device!r} "
             f"max_rel_err={err:.2e} tol={tol:.0e} "
             f"{'ok' if ok else 'FAIL'}")
    return all_ok


def main(argv=None) -> int:
    from veles.simd_tpu_torch.utils.platform import select_device

    argv = sys.argv[1:] if argv is None else argv
    names = [a.split("=", 1)[1] for a in argv
             if a.startswith("--family=")]
    known = {n for n, _ in FAMILIES}
    if any(n not in known for n in names):
        print(f"unknown --family; known: {sorted(known)}",
              file=sys.stderr)
        return 2
    select_device()
    return 0 if run_smoke(families=names or None) else 1


if __name__ == "__main__":
    sys.exit(main())
