"""Python side of the port's C bridge (``veles/simd_tpu_torch/cabi/``).

The port's twin of ``veles.simd_tpu.cshim``: the C library
(``cabi/veles_simd.c``, csrc's bridge importing this module) embeds
CPython and calls the functions here with raw pointers (as integers) +
geometry; they are wrapped zero-copy with ``np.ctypeslib``, dispatched
through the port's ops (PyTorch on ``Config.device``, or the NumPy
oracle per the ``simd`` flag), and the results are written back into
the caller's output buffer.  Every function, its signature and its
``_C_*`` code maps are the JAX shim's.

What the card changes: a result is a tensor, often on the card, so
every write goes through one writer (:func:`_put`):
``torch.from_numpy(view).copy_(result)``, one device-to-host copy into
the caller's memory (float32, float64, int64, uint8, and interleaved
complex64 through :func:`_cplx_out`); scalar and tuple results
(``minmax1D``/``2D``, ``detect_peaks``, ``kaiserord``) go through
``.item()``.  The handle and stream registries hold the port's handles,
whose streaming state stays on the device.

The platform: ``VELES_SIMD_PLATFORM=cpu`` computes on the CPU
(``set_config(device="cpu")``).  Otherwise the bridge computes on the
card: importing this module probes for one
(``utils.platform.require_reachable_device``) and initialises CUDA under
``init_deadline``; with no card the import raises ``RuntimeError``, so
``veles_simd_init`` returns -1 with the message in
``veles_simd_last_error()``.  There is no CPU fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from veles.simd_tpu_torch.utils import platform as _platform
from veles.simd_tpu_torch.utils.config import set_config

PLATFORM_ENV = _platform.PLATFORM_ENV

if _platform.requested_device() == "cpu":
    set_config(device="cpu")
else:
    set_config(device="cuda")
    try:
        _platform.require_reachable_device()
    except SystemExit as e:   # a C host reads the message, not an exit
        raise RuntimeError(
            "veles.simd_tpu_torch C bridge: no CUDA card reachable; set "
            f"{PLATFORM_ENV}=cpu to compute on the CPU") from e
    # a CUDA init that hangs would hang a C host at its first call
    # with no diagnosis: fail at load time instead
    # (VELES_SIMD_INIT_DEADLINE=0 opts out)
    with _platform.init_deadline(
            what="CUDA init (veles.simd_tpu_torch C bridge)"):
        torch.cuda.init()
        torch.cuda.get_device_name(0)

from veles.simd_tpu_torch.ops import arithmetic as _ar  # noqa: E402
from veles.simd_tpu_torch.ops import convolve as _cv  # noqa: E402
from veles.simd_tpu_torch.ops import convolve2d as _cv2  # noqa: E402
from veles.simd_tpu_torch.ops import correlate as _cr  # noqa: E402
from veles.simd_tpu_torch.ops import detect_peaks as _dp  # noqa: E402
from veles.simd_tpu_torch.ops import filters as _fl  # noqa: E402
from veles.simd_tpu_torch.ops import iir as _iir  # noqa: E402
from veles.simd_tpu_torch.ops import mathfun as _mf  # noqa: E402
from veles.simd_tpu_torch.ops import matrix as _mx  # noqa: E402
from veles.simd_tpu_torch.ops import normalize as _nz  # noqa: E402
from veles.simd_tpu_torch.ops import resample as _rs  # noqa: E402
from veles.simd_tpu_torch.ops import spectral as _sp  # noqa: E402
from veles.simd_tpu_torch.ops import waveforms as _wf  # noqa: E402
from veles.simd_tpu_torch.ops import wavelet as _wv  # noqa: E402
from veles.simd_tpu_torch.ops.wavelet_coeffs import \
    WaveletType as _WT  # noqa: E402

_C_WAVELET_TYPES = {0: _WT.DAUBECHIES, 1: _WT.COIFLET, 2: _WT.SYMLET}
_C_EXTENSIONS = {0: _wv.ExtensionType.PERIODIC, 1: _wv.ExtensionType.MIRROR,
                 2: _wv.ExtensionType.CONSTANT, 3: _wv.ExtensionType.ZERO}
_C_ALGORITHMS = {0: None, 1: _cv.ConvolutionAlgorithm.BRUTE_FORCE,
                 2: _cv.ConvolutionAlgorithm.FFT,
                 3: _cv.ConvolutionAlgorithm.OVERLAP_SAVE}


def _arr(ptr, shape, ctype):
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctype)),
        shape=tuple(int(s) for s in shape))


def _f32(ptr, *shape):
    return _arr(ptr, shape, ctypes.c_float)


def _put(view, result) -> None:
    """Write ``result`` into ``view``, a NumPy view of the caller's
    buffer: a tensor in one copy (device to host when it lies on the
    card; ``copy_`` casts to the buffer's dtype), anything else through
    NumPy."""
    if isinstance(result, torch.Tensor):
        torch.from_numpy(view).copy_(result)
    else:
        view[...] = result


def _item(value):
    """A scalar result as a Python number (``.item()`` of a tensor)."""
    return value.item() if isinstance(value, torch.Tensor) else value


def _cat(parts):
    """Flattened ``parts`` end to end (tensors or NumPy arrays)."""
    if isinstance(parts[0], torch.Tensor):
        return torch.cat([p.reshape(-1) for p in parts])
    return np.concatenate([np.asarray(p).ravel() for p in parts])


def backend_description() -> str:
    if _platform.on_cuda():
        return f"torch:cuda:{torch.cuda.get_device_name(0)}"
    return "torch:cpu"


# ---- matrix ---------------------------------------------------------------

def matrix_add(simd, m1, m2, res, w, h):
    _put(_f32(res, h, w), _mx.matrix_add(
        _f32(m1, h, w), _f32(m2, h, w), simd=bool(simd)))
    return 0


def matrix_sub(simd, m1, m2, res, w, h):
    _put(_f32(res, h, w), _mx.matrix_sub(
        _f32(m1, h, w), _f32(m2, h, w), simd=bool(simd)))
    return 0


def matrix_multiply(simd, m1, m2, res, w1, h1, w2, h2):
    _put(_f32(res, h1, w2), _mx.matrix_multiply(
        _f32(m1, h1, w1), _f32(m2, h2, w2), simd=bool(simd)))
    return 0


def matrix_multiply_transposed(simd, m1, m2, res, w1, h1, w2, h2):
    _put(_f32(res, h1, h2), _mx.matrix_multiply_transposed(
        _f32(m1, h1, w1), _f32(m2, h2, w2), simd=bool(simd)))
    return 0


# ---- convolve / correlate -------------------------------------------------

_handles: dict[int, _cv.ConvolutionHandle] = {}
_next_handle = [1]


def convolve_initialize(x_length, h_length, algorithm, reverse):
    handle = _cv.convolve_initialize(x_length, h_length,
                                     _C_ALGORITHMS[int(algorithm)],
                                     reverse=bool(reverse))
    hid = _next_handle[0]
    _next_handle[0] += 1
    _handles[hid] = handle
    return hid


def convolve_run(hid, x, h, result):
    handle = _handles[int(hid)]
    out = _cv._run(handle, _f32(x, handle.x_length),
                   _f32(h, handle.h_length), simd=True)
    _put(_f32(result, handle.result_length), out)
    return 0


def convolve_finalize(hid):
    _handles.pop(int(hid), None)
    return 0


_streams: dict[int, "_cv.StreamingConvolution"] = {}


def streaming_convolve_initialize(h, h_length, chunk_length, reverse, simd):
    stream = _cv.StreamingConvolution(
        _f32(h, h_length).copy(), int(chunk_length),
        reverse=bool(reverse), simd=bool(simd))
    sid = _next_handle[0]
    _next_handle[0] += 1
    _streams[sid] = stream
    return sid


def streaming_convolve_process(sid, chunk, result):
    stream = _streams[int(sid)]
    out = stream.process(_f32(chunk, stream.chunk_length))
    _put(_f32(result, stream.chunk_length), out)
    return 0


def streaming_convolve_flush(sid, tail):
    stream = _streams[int(sid)]
    out = stream.flush()
    if stream.h_length > 1:
        buf = _f32(tail, stream.h_length - 1)
        # an un-fed stream flushes empty: the C tail is all zeros
        _put(buf, 0.0 if out.shape[-1] == 0 else out)
    return 0


def streaming_convolve_finalize(sid):
    _streams.pop(int(sid), None)
    return 0


def convolve2d(simd, reverse, x, n0, n1, h, k0, k1, result):
    fn = _cv2.cross_correlate2d if reverse else _cv2.convolve2d
    out = fn(_arr(x, (n0, n1), ctypes.c_float),
             _arr(h, (k0, k1), ctypes.c_float), simd=bool(simd))
    _put(_arr(result, (n0 + k0 - 1, n1 + k1 - 1), ctypes.c_float), out)
    return 0


_C_CONV2D_MODES = {0: "full", 1: "same", 2: "valid"}
_C_CONV2D_BOUNDARIES = {0: "fill", 1: "wrap", 2: "symm"}


def convolve2d_mb(simd, reverse, x, n0, n1, h, k0, k1, mode, boundary,
                  fillvalue, result):
    if int(mode) not in _C_CONV2D_MODES:
        raise ValueError(f"mode code {int(mode)} invalid: 0 full, "
                         "1 same, 2 valid")
    if int(boundary) not in _C_CONV2D_BOUNDARIES:
        raise ValueError(f"boundary code {int(boundary)} invalid: "
                         "0 fill, 1 wrap, 2 symm")
    fn = _cv2.cross_correlate2d if reverse else _cv2.convolve2d
    out = fn(_arr(x, (n0, n1), ctypes.c_float),
             _arr(h, (k0, k1), ctypes.c_float), simd=bool(simd),
             mode=_C_CONV2D_MODES[int(mode)],
             boundary=_C_CONV2D_BOUNDARIES[int(boundary)],
             fillvalue=float(fillvalue))
    _put(_arr(result, tuple(out.shape), ctypes.c_float), out)
    return 0


def convolve_simd(simd, x, xlen, h, hlen, result):
    out = _cv.convolve_simd(_f32(x, xlen), _f32(h, hlen), simd=bool(simd))
    _put(_f32(result, xlen + hlen - 1), out)
    return 0


def cross_correlate_simd(simd, x, xlen, h, hlen, result):
    out = _cr.cross_correlate_simd(_f32(x, xlen), _f32(h, hlen),
                                   simd=bool(simd))
    _put(_f32(result, xlen + hlen - 1), out)
    return 0


# ---- wavelet --------------------------------------------------------------

def wavelet_validate_order(wtype, order):
    return int(_wv.wavelet_validate_order(_C_WAVELET_TYPES[int(wtype)],
                                          int(order)))


def wavelet_apply(simd, wtype, order, ext, src, length, desthi, destlo):
    hi, lo = _wv.wavelet_apply(
        _C_WAVELET_TYPES[int(wtype)], int(order), _C_EXTENSIONS[int(ext)],
        _f32(src, length), simd=bool(simd))
    _put(_f32(desthi, length // 2), hi)
    _put(_f32(destlo, length // 2), lo)
    return 0


def stationary_wavelet_apply(simd, wtype, order, level, ext, src, length,
                             desthi, destlo):
    hi, lo = _wv.stationary_wavelet_apply(
        _C_WAVELET_TYPES[int(wtype)], int(order), int(level),
        _C_EXTENSIONS[int(ext)], _f32(src, length), simd=bool(simd))
    _put(_f32(desthi, length), hi)
    _put(_f32(destlo, length), lo)
    return 0


def wavelet_reconstruct(simd, wtype, order, ext, desthi, destlo, length,
                        result):
    rec = _wv.wavelet_reconstruct(
        _C_WAVELET_TYPES[int(wtype)], int(order), _f32(desthi, length),
        _f32(destlo, length), simd=bool(simd), ext=_C_EXTENSIONS[int(ext)])
    _put(_f32(result, 2 * length), rec)
    return 0


def stationary_wavelet_reconstruct(simd, wtype, order, level, ext, desthi,
                                   destlo, length, result):
    rec = _wv.stationary_wavelet_reconstruct(
        _C_WAVELET_TYPES[int(wtype)], int(order), int(level),
        _f32(desthi, length), _f32(destlo, length), simd=bool(simd),
        ext=_C_EXTENSIONS[int(ext)])
    _put(_f32(result, length), rec)
    return 0


def wavelet_apply2d(simd, wtype, order, ext, src, n0, n1, ll, lh, hl, hh):
    bands = _wv.wavelet_apply2d(
        _C_WAVELET_TYPES[int(wtype)], int(order), _C_EXTENSIONS[int(ext)],
        _f32(src, n0, n1), simd=bool(simd))
    for ptr, band in zip((ll, lh, hl, hh), bands):
        _put(_f32(ptr, n0 // 2, n1 // 2), band)
    return 0


def wavelet_reconstruct2d(simd, wtype, order, ext, ll, lh, hl, hh, m0, m1,
                          result):
    rec = _wv.wavelet_reconstruct2d(
        _C_WAVELET_TYPES[int(wtype)], int(order),
        _f32(ll, m0, m1), _f32(lh, m0, m1), _f32(hl, m0, m1),
        _f32(hh, m0, m1), simd=bool(simd), ext=_C_EXTENSIONS[int(ext)])
    _put(_f32(result, 2 * m0, 2 * m1), rec)
    return 0


def stationary_wavelet_apply2d(simd, wtype, order, level, ext, src, n0, n1,
                               ll, lh, hl, hh):
    bands = _wv.stationary_wavelet_apply2d(
        _C_WAVELET_TYPES[int(wtype)], int(order), int(level),
        _C_EXTENSIONS[int(ext)], _f32(src, n0, n1), simd=bool(simd))
    for ptr, band in zip((ll, lh, hl, hh), bands):
        _put(_f32(ptr, n0, n1), band)
    return 0


def stationary_wavelet_reconstruct2d(simd, wtype, order, level, ext, ll,
                                     lh, hl, hh, m0, m1, result):
    rec = _wv.stationary_wavelet_reconstruct2d(
        _C_WAVELET_TYPES[int(wtype)], int(order), int(level),
        _f32(ll, m0, m1), _f32(lh, m0, m1), _f32(hl, m0, m1),
        _f32(hh, m0, m1), simd=bool(simd), ext=_C_EXTENSIONS[int(ext)])
    _put(_f32(result, m0, m1), rec)
    return 0


def wavelet_packet_transform(simd, wtype, order, ext, src, length, levels,
                             leaves):
    bands = _wv.wavelet_packet_transform(
        _C_WAVELET_TYPES[int(wtype)], int(order), _C_EXTENSIONS[int(ext)],
        _f32(src, length), int(levels), simd=bool(simd))
    _put(_f32(leaves, length), _cat(bands))
    return 0


def wavelet_packet_inverse_transform(simd, wtype, order, ext, leaves,
                                     length, levels, result):
    n_leaves = 1 << int(levels)
    if int(length) % n_leaves:
        raise ValueError(
            f"length {length} not divisible by 2^levels = {n_leaves}")
    flat = _f32(leaves, length)
    leaf_len = int(length) // n_leaves
    bands = [flat[i * leaf_len:(i + 1) * leaf_len]
             for i in range(n_leaves)]
    rec = _wv.wavelet_packet_inverse_transform(
        _C_WAVELET_TYPES[int(wtype)], int(order), bands, simd=bool(simd),
        ext=_C_EXTENSIONS[int(ext)])
    _put(_f32(result, length), rec)
    return 0


def _check_quad_divisible(m0, m1, levels):
    n_side = 1 << int(levels)
    if int(m0) % n_side or int(m1) % n_side:
        raise ValueError(
            f"image dims ({m0}, {m1}) not divisible by "
            f"2^levels = {n_side}")
    return n_side


def wavelet_packet_transform2d(simd, wtype, order, ext, src, m0, m1,
                               levels, leaves):
    _check_quad_divisible(m0, m1, levels)
    bands = _wv.wavelet_packet_transform2d(
        _C_WAVELET_TYPES[int(wtype)], int(order), _C_EXTENSIONS[int(ext)],
        _f32(src, m0, m1), int(levels), simd=bool(simd))
    _put(_f32(leaves, int(m0) * int(m1)), _cat(bands))
    return 0


def wavelet_packet_inverse_transform2d(simd, wtype, order, ext, leaves,
                                       m0, m1, levels, result):
    n_side = _check_quad_divisible(m0, m1, levels)
    n_leaves = n_side * n_side
    l0, l1 = int(m0) // n_side, int(m1) // n_side
    flat = _f32(leaves, int(m0) * int(m1))
    bands = [flat[i * l0 * l1:(i + 1) * l0 * l1].reshape(l0, l1)
             for i in range(n_leaves)]
    rec = _wv.wavelet_packet_inverse_transform2d(
        _C_WAVELET_TYPES[int(wtype)], int(order), bands, simd=bool(simd),
        ext=_C_EXTENSIONS[int(ext)])
    _put(_f32(result, m0, m1), rec)
    return 0


# ---- mathfun --------------------------------------------------------------

def mathfun(name, simd, src, length, res):
    fn = {"sin": _mf.sin_psv, "cos": _mf.cos_psv, "log": _mf.log_psv,
          "exp": _mf.exp_psv, "sqrt": _mf.sqrt_psv}[name]
    _put(_f32(res, length), fn(_f32(src, length), simd=bool(simd)))
    return 0


def pow_psv(simd, base, exponent, length, res):
    _put(_f32(res, length), _mf.pow_psv(
        _f32(base, length), _f32(exponent, length), simd=bool(simd)))
    return 0


# ---- spectral -------------------------------------------------------------

def _cplx_out(ptr, out, *shape):
    """Write a complex result into an interleaved (re, im) f32 buffer:
    a tensor as its complex64 ``view_as_real`` in one copy."""
    view = _f32(ptr, *shape, 2)
    if isinstance(out, torch.Tensor):
        pairs = torch.view_as_real(
            out.to(torch.complex64).resolve_conj().reshape(shape))
        torch.from_numpy(view).copy_(pairs)
    else:
        out = np.ascontiguousarray(np.asarray(out, np.complex64))
        view[...] = out.view(np.float32).reshape(*shape, 2)


def _window_arg(ptr, frame_length):
    return None if int(ptr) == 0 else _f32(ptr, frame_length)


def stft(simd, x, length, frame_length, hop, window, spec):
    out = _sp.stft(_f32(x, length), int(frame_length), int(hop),
                   window=_window_arg(window, frame_length),
                   simd=bool(simd))
    frames = _sp.frame_count(int(length), int(frame_length), int(hop))
    _cplx_out(spec, out, frames, int(frame_length) // 2 + 1)
    return 0


def istft(simd, spec, length, frame_length, hop, window, result):
    frames = _sp.frame_count(int(length), int(frame_length), int(hop))
    bins = int(frame_length) // 2 + 1
    spec_c = _f32(spec, frames, bins, 2).view(np.complex64)[..., 0]
    out = _sp.istft(spec_c, int(length), int(frame_length), int(hop),
                    window=_window_arg(window, frame_length),
                    simd=bool(simd))
    _put(_f32(result, length), out)
    return 0


def spectrogram(simd, x, length, frame_length, hop, window, power):
    out = _sp.spectrogram(_f32(x, length), int(frame_length), int(hop),
                          window=_window_arg(window, frame_length),
                          simd=bool(simd))
    frames = _sp.frame_count(int(length), int(frame_length), int(hop))
    _put(_f32(power, frames, int(frame_length) // 2 + 1), out)
    return 0


def hilbert(simd, x, length, analytic):
    out = _sp.hilbert(_f32(x, length), simd=bool(simd))
    _cplx_out(analytic, out, int(length))
    return 0


def envelope(simd, x, length, env):
    _put(_f32(env, length), _sp.envelope(_f32(x, length), simd=bool(simd)))
    return 0


def morlet_cwt(simd, x, length, scales, n_scales, w0, result):
    sc = _arr(scales, (n_scales,), ctypes.c_double)
    out = _sp.morlet_cwt(_f32(x, length), sc, w0=float(w0),
                         simd=bool(simd))
    _cplx_out(result, out, int(n_scales), int(length))
    return 0


def spectral_detrend(simd, x, length, kind, result):
    _put(_f32(result, length), _sp.detrend(
        _f32(x, length), {0: "linear", 1: "constant"}[int(kind)],
        simd=bool(simd)))
    return 0


def spectral_welch(simd, x, length, fs, nperseg, noverlap, freqs, psd):
    nov = None if int(noverlap) < 0 else int(noverlap)
    f, p = _sp.welch(_f32(x, length), fs=float(fs),
                     nperseg=int(nperseg), noverlap=nov,
                     simd=bool(simd))
    _put(_f64(freqs, len(f)), f)
    _put(_f32(psd, len(f)), p)
    return 0


def spectral_periodogram(simd, x, length, fs, freqs, psd):
    f, p = _sp.periodogram(_f32(x, length), fs=float(fs),
                           simd=bool(simd))
    _put(_f64(freqs, len(f)), f)
    _put(_f32(psd, len(f)), p)
    return 0


def spectral_csd(simd, x, y, length, fs, nperseg, noverlap, freqs, pxy):
    nov = None if int(noverlap) < 0 else int(noverlap)
    f, p = _sp.csd(_f32(x, length), _f32(y, length), fs=float(fs),
                   nperseg=int(nperseg), noverlap=nov, simd=bool(simd))
    _put(_f64(freqs, len(f)), f)
    _cplx_out(pxy, p, len(f))
    return 0


def spectral_coherence(simd, x, y, length, fs, nperseg, noverlap, freqs,
                       coh):
    nov = None if int(noverlap) < 0 else int(noverlap)
    f, c = _sp.coherence(_f32(x, length), _f32(y, length), fs=float(fs),
                         nperseg=int(nperseg), noverlap=nov,
                         simd=bool(simd))
    _put(_f64(freqs, len(f)), f)
    _put(_f32(coh, len(f)), c)
    return 0


def spectral_czt(simd, x, length, m, w_re, w_im, a_re, a_im, result):
    w = None if (w_re == 0.0 and w_im == 0.0) else complex(w_re, w_im)
    out = _sp.czt(_f32(x, length), int(m), w, complex(a_re, a_im),
                  simd=bool(simd))
    _cplx_out(result, out, int(m))
    return 0


def spectral_zoom_fft(simd, x, length, f1, f2, m, fs, freqs, result):
    f, out = _sp.zoom_fft(_f32(x, length), [float(f1), float(f2)],
                          int(m), fs=float(fs), simd=bool(simd))
    _put(_f64(freqs, int(m)), f)
    _cplx_out(result, out, int(m))
    return 0


def spectral_lombscargle(simd, t, x, length, freqs, n_freqs, power):
    f = _f64(freqs, n_freqs)
    out = _sp.lombscargle(_f64(t, length), _f32(x, length), f,
                          simd=bool(simd))
    _put(_f32(power, n_freqs), out)
    return 0


# ---- resample -------------------------------------------------------------

def upfirdn(simd, h, h_len, x, length, up, down, result):
    out = _rs.upfirdn(_f64(h, h_len), _f32(x, length), int(up),
                      int(down), simd=bool(simd))
    _put(_f32(result, out.shape[-1]), out)
    return 0


def resample_poly(simd, x, length, up, down, taps, num_taps, result):
    t = None if int(taps) == 0 else _f32(taps, num_taps)
    out = _rs.resample_poly(_f32(x, length), int(up), int(down), taps=t,
                            simd=bool(simd))
    _put(_f32(result, _rs.resample_length(int(length), int(up),
                                          int(down))), out)
    return 0


def resample_fourier(simd, x, length, num, result):
    out = _rs.resample_fourier(_f32(x, length), int(num), simd=bool(simd))
    _put(_f32(result, num), out)
    return 0


# ---- iir ------------------------------------------------------------------

_C_BTYPES = {0: "lowpass", 1: "highpass", 2: "bandpass", 3: "bandstop"}


def _f64(ptr, *shape):
    return _arr(ptr, shape, ctypes.c_double)


def _iir_design(design, low, high, btype, sos_out):
    """Shared design shim: returns the section count; writes
    [n_sections, 6] float64 rows into ``sos_out`` when non-NULL (call
    once with NULL to size the buffer, then again to fill it)."""
    bt = _C_BTYPES[int(btype)]
    cutoff = float(low) if bt in ("lowpass", "highpass") \
        else (float(low), float(high))
    sos = design(cutoff, bt)
    if int(sos_out) != 0:
        _put(_f64(sos_out, len(sos), 6), sos)
    return len(sos)


def iir_butterworth(order, low, high, btype, sos_out):
    """Returns the section count; writes [n_sections, 6] float64 rows
    into ``sos_out`` when it is non-NULL (call once with NULL to size
    the buffer, then again to fill it).  Same contract for the cheby
    variants."""
    return _iir_design(lambda c, bt: _iir.butterworth(int(order), c, bt),
                       low, high, btype, sos_out)


def iir_bessel(order, low, high, btype, sos_out):
    return _iir_design(lambda c, bt: _iir.bessel(int(order), c, bt),
                       low, high, btype, sos_out)


def iir_cheby1(order, rp, low, high, btype, sos_out):
    return _iir_design(
        lambda c, bt: _iir.cheby1(int(order), float(rp), c, bt),
        low, high, btype, sos_out)


def iir_cheby2(order, rs, low, high, btype, sos_out):
    return _iir_design(
        lambda c, bt: _iir.cheby2(int(order), float(rs), c, bt),
        low, high, btype, sos_out)


def iir_ellip(order, rp, rs, low, high, btype, sos_out):
    return _iir_design(
        lambda c, bt: _iir.ellip(int(order), float(rp), float(rs), c, bt),
        low, high, btype, sos_out)


def iir_ord(method, wp, ws, n_edges, gpass, gstop, wn_out):
    n = int(n_edges)
    if n not in (1, 2):
        raise ValueError("n_edges must be 1 or 2")
    fn = {"buttord": _iir.buttord, "cheb1ord": _iir.cheb1ord,
          "cheb2ord": _iir.cheb2ord, "ellipord": _iir.ellipord}[method]
    wp_v = _f64(wp, n)
    ws_v = _f64(ws, n)
    order, wn = fn(wp_v if n > 1 else float(wp_v[0]),
                   ws_v if n > 1 else float(ws_v[0]),
                   float(gpass), float(gstop))
    if int(wn_out) != 0:
        _put(_f64(wn_out, n), wn)
    return int(_item(order))


def _single_biquad(sos, sos_out):
    if int(sos_out) != 0:
        _put(_f64(sos_out, 1, 6), sos)
    return 1


def iir_notch(w0, q, sos_out):
    return _single_biquad(_iir.iirnotch(float(w0), float(q)), sos_out)


def iir_peak(w0, q, sos_out):
    return _single_biquad(_iir.iirpeak(float(w0), float(q)), sos_out)


def iir_sosfilt_stream(simd, sos, n_sections, x, length, zi_inout,
                       result):
    """One streaming block: filters with the caller's state and writes
    the exit state back into the same buffer."""
    s = _f64(sos, n_sections, 6)
    z = _f64(zi_inout, n_sections, 2)
    out, zf = _iir.sosfilt(s, _f32(x, length), zi=z.copy(),
                           simd=bool(simd), return_zf=True)
    _put(_f32(result, length), out)
    _put(z, zf)
    return 0


def iir_sosfilt(simd, sos, n_sections, x, length, zi, result):
    s = _f64(sos, n_sections, 6)
    z = None if int(zi) == 0 else _f64(zi, n_sections, 2)
    out = _iir.sosfilt(s, _f32(x, length), zi=z, simd=bool(simd))
    _put(_f32(result, length), out)
    return 0


def iir_sosfiltfilt(simd, sos, n_sections, x, length, padlen, result):
    s = _f64(sos, n_sections, 6)
    pl = None if int(padlen) < 0 else int(padlen)
    out = _iir.sosfiltfilt(s, _f32(x, length), padlen=pl,
                           simd=bool(simd))
    _put(_f32(result, length), out)
    return 0


def iir_sosfilt_zi(sos, n_sections, zi_out):
    _put(_f64(zi_out, n_sections, 2),
         _iir.sosfilt_zi(_f64(sos, n_sections, 6)))
    return 0


def iir_lfilter(simd, b, nb, a, na, x, length, result):
    out = _iir.lfilter(_f64(b, nb), _f64(a, na), _f32(x, length),
                       simd=bool(simd))
    _put(_f32(result, length), out)
    return 0


# ---- filters --------------------------------------------------------------

def filt_medfilt(simd, x, length, kernel_size, result):
    _put(_f32(result, length), _fl.medfilt(
        _f32(x, length), int(kernel_size), simd=bool(simd)))
    return 0


def filt_order_filter(simd, x, length, rank, kernel_size, result):
    _put(_f32(result, length), _fl.order_filter(
        _f32(x, length), int(rank), int(kernel_size), simd=bool(simd)))
    return 0


def filt_medfilt2d(simd, img, height, width, kh, kw, result):
    _put(_f32(result, height, width), _fl.medfilt2d(
        _f32(img, height, width), (int(kh), int(kw)), simd=bool(simd)))
    return 0


_C_SG_MODES = {0: "interp", 1: "constant", 2: "nearest"}


def filt_savgol(simd, x, length, window_length, polyorder, deriv, delta,
                mode, result):
    _put(_f32(result, length), _fl.savgol_filter(
        _f32(x, length), int(window_length), int(polyorder),
        deriv=int(deriv), delta=float(delta), mode=_C_SG_MODES[int(mode)],
        simd=bool(simd)))
    return 0


def filt_wiener(simd, x, length, mysize, noise, result):
    nz = None if not np.isfinite(noise) else float(noise)
    _put(_f32(result, length), _fl.wiener(
        _f32(x, length), int(mysize), noise=nz, simd=bool(simd)))
    return 0


def filt_savgol_coeffs(window_length, polyorder, deriv, delta, taps):
    _put(_f64(taps, window_length), _fl.savgol_coeffs(
        int(window_length), int(polyorder), int(deriv), float(delta)))
    return 0


def filt_firwin(numtaps, cutoffs, n_cutoffs, pass_zero, window, taps):
    # legacy 2-code window surface; codes 0/1 coincide with
    # _C_WINDOW_KINDS, beta is ignored by the fixed windows
    if int(window) not in (0, 1):
        raise ValueError("filt_firwin takes window 0 (hamming) or 1 "
                         "(hann); use filt_firwin_w for the full range")
    return filt_firwin_w(numtaps, cutoffs, n_cutoffs, pass_zero,
                         window, 0.0, taps)


def filt_firwin_w(numtaps, cutoffs, n_cutoffs, pass_zero, window, beta,
                  taps):
    c = _f64(cutoffs, n_cutoffs)
    cut = float(c[0]) if int(n_cutoffs) == 1 else list(map(float, c))
    kind = _C_WINDOW_KINDS[int(window)]
    win = (kind, float(beta)) if kind == "kaiser" else kind
    _put(_f64(taps, numtaps), _fl.firwin(
        int(numtaps), cut, pass_zero=bool(pass_zero), window=win))
    return 0


def filt_kaiserord(ripple, width, numtaps_out, beta_out):
    numtaps, beta = _fl.kaiserord(float(ripple), float(width))
    _arr(numtaps_out, (1,), ctypes.c_size_t)[0] = _item(numtaps)
    _f64(beta_out, 1)[0] = _item(beta)
    return 0


def filt_firwin2(numtaps, freq, gain, n_freq, nfreqs, window, taps):
    kind = _C_WINDOW_KINDS[int(window)]
    if kind == "kaiser":
        raise ValueError("firwin2 has no beta channel; use a "
                         "non-parametric window (codes 0-4)")
    _put(_f64(taps, numtaps), _fl.firwin2(
        int(numtaps), _f64(freq, n_freq), _f64(gain, n_freq),
        nfreqs=int(nfreqs) or None, window=kind))
    return 0


def filt_remez(numtaps, bands, n_bands, desired, weight, fs, taps):
    n = int(n_bands)
    w = None if int(weight) == 0 else _f64(weight, n)
    _put(_f64(taps, numtaps), _fl.remez(
        int(numtaps), _f64(bands, 2 * n), _f64(desired, n), weight=w,
        fs=float(fs)))
    return 0


_C_CORR_MODES = {0: "full", 1: "same", 2: "valid"}


def correlation_lags(in_len, in2_len, mode, lags):
    out = _cr.correlation_lags(int(in_len), int(in2_len),
                               _C_CORR_MODES[int(mode)])
    _put(_i64(lags, len(out)), out)
    return 0


def deconvolve(signal, sig_len, divisor, div_len, quotient, remainder):
    q, r = _fl.deconvolve(_f64(signal, sig_len), _f64(divisor, div_len))
    _put(_f64(quotient, int(sig_len) - int(div_len) + 1), q)
    _put(_f64(remainder, sig_len), r)
    return 0


# ---- waveforms ------------------------------------------------------------

_C_CHIRP_METHODS = {0: "linear", 1: "quadratic", 2: "logarithmic",
                    3: "hyperbolic"}
_C_WINDOW_KINDS = {0: "hamming", 1: "hann", 2: "blackman", 3: "bartlett",
                   4: "boxcar", 5: "kaiser"}


def wave_chirp(simd, t, length, f0, t1, f1, method, phi, result):
    _put(_f32(result, length), _wf.chirp(
        _f32(t, length), float(f0), float(t1), float(f1),
        _C_CHIRP_METHODS[int(method)], float(phi), simd=bool(simd)))
    return 0


def wave_square(simd, t, length, duty, result):
    _put(_f32(result, length), _wf.square(
        _f32(t, length), float(duty), simd=bool(simd)))
    return 0


def wave_sawtooth(simd, t, length, width, result):
    _put(_f32(result, length), _wf.sawtooth(
        _f32(t, length), float(width), simd=bool(simd)))
    return 0


def wave_gausspulse(simd, t, length, fc, bw, bwr, result):
    _put(_f32(result, length), _wf.gausspulse(
        _f32(t, length), float(fc), float(bw), float(bwr),
        simd=bool(simd)))
    return 0


def wave_unit_impulse(simd, n, idx, result):
    _put(_f32(result, n), _wf.unit_impulse(
        int(n), int(idx), simd=bool(simd)))
    return 0


def wave_max_len_seq(nbits, state_io, length, seq):
    state = None if int(state_io) == 0 else _u8(state_io, nbits)
    out, final = _wf.max_len_seq(int(nbits), state=state,
                                 length=int(length))
    _put(_u8(seq, length), out)
    if state is not None:
        _put(state, final)
    return 0


def wave_get_window(window, n, beta, result):
    kind = _C_WINDOW_KINDS[int(window)]
    kwargs = {"beta": float(beta)} if kind == "kaiser" else {}
    _put(_f64(result, n), _wf.get_window(kind, int(n), **kwargs))
    return 0


# ---- normalize ------------------------------------------------------------

def _u8(ptr, *shape):
    return _arr(ptr, shape, ctypes.c_uint8)


def normalize2D(simd, src, src_stride, width, height, dst, dst_stride):
    plane = _u8(src, height, src_stride)[..., :width]
    _put(_f32(dst, height, dst_stride)[..., :width],
         _nz.normalize2D(plane, simd=bool(simd)))
    return 0


def minmax2D(simd, src, src_stride, width, height):
    plane = _u8(src, height, src_stride)[..., :width]
    mn, mx = _nz.minmax2D(plane, simd=bool(simd))
    return (int(_item(mn)), int(_item(mx)))


def minmax1D(simd, src, length):
    mn, mx = _nz.minmax1D(_f32(src, length), simd=bool(simd))
    return (float(_item(mn)), float(_item(mx)))


def normalize2D_minmax(simd, mn, mx, src, src_stride, width, height, dst,
                       dst_stride):
    plane = _u8(src, height, src_stride)[..., :width]
    _put(_f32(dst, height, dst_stride)[..., :width],
         _nz.normalize2D_minmax(int(mn), int(mx), plane, simd=bool(simd)))
    return 0


# ---- detect_peaks ---------------------------------------------------------

def detect_peaks(simd, data, size, etype):
    pos, vals = _dp.detect_peaks(_f32(data, size),
                                 _dp.ExtremumType(int(etype)),
                                 simd=bool(simd))
    # one copy each, like .item() for the scalar results
    return (_platform.to_host(pos).astype(np.int64).tolist(),
            _platform.to_host(vals).astype(np.float64).tolist())


def _i64(ptr, *shape):
    return _arr(ptr, shape, ctypes.c_int64)


def peak_prominences(simd, x, length, peaks, n_peaks, prom_out):
    pk = _i64(peaks, n_peaks)
    _put(_f32(prom_out, n_peaks),
         _dp.peak_prominences(_f32(x, length), pk, simd=bool(simd)))
    return 0


def peak_widths(simd, x, length, peaks, n_peaks, rel_height, widths,
                width_heights, left_ips, right_ips):
    pk = _i64(peaks, n_peaks)
    w, h, li, ri = _dp.peak_widths(_f32(x, length), pk,
                                   rel_height=float(rel_height),
                                   simd=bool(simd))
    _put(_f32(widths, n_peaks), w)
    _put(_f32(width_heights, n_peaks), h)
    _put(_f32(left_ips, n_peaks), li)
    _put(_f32(right_ips, n_peaks), ri)
    return 0


def find_peaks(simd, x, length, height_min, height_max, threshold_min,
               threshold_max, distance, prom_min, prom_max, peaks_out,
               max_out):
    """NaN bounds mean "unset"; distance 0 means no distance filter.
    Returns the total peak count; at most max_out indices are written."""
    def _iv(lo, hi):
        lo = None if np.isnan(lo) else float(lo)
        hi = None if np.isnan(hi) else float(hi)
        if lo is None and hi is None:
            return None
        return (lo, hi)

    peaks, _ = _dp.find_peaks(
        _f32(x, length), height=_iv(height_min, height_max),
        threshold=_iv(threshold_min, threshold_max),
        distance=None if int(distance) == 0 else int(distance),
        prominence=_iv(prom_min, prom_max), simd=bool(simd))
    n_write = min(len(peaks), int(max_out))
    if n_write:
        _put(_i64(peaks_out, n_write), peaks[:n_write])
    return len(peaks)


# ---- conversions ----------------------------------------------------------

def convert(name, simd, src, length, dst):
    if name == "int16_to_float":
        _put(_f32(dst, length), _ar.int16_to_float(
            _arr(src, (length,), ctypes.c_int16), simd=bool(simd)))
    elif name == "float_to_int16":
        _put(_arr(dst, (length,), ctypes.c_int16), _ar.float_to_int16(
            _f32(src, length), simd=bool(simd)))
    elif name == "int32_to_float":
        _put(_f32(dst, length), _ar.int32_to_float(
            _arr(src, (length,), ctypes.c_int32), simd=bool(simd)))
    elif name == "float_to_int32":
        _put(_arr(dst, (length,), ctypes.c_int32), _ar.float_to_int32(
            _f32(src, length), simd=bool(simd)))
    elif name == "int16_to_int32":
        _put(_arr(dst, (length,), ctypes.c_int32), _ar.int16_to_int32(
            _arr(src, (length,), ctypes.c_int16), simd=bool(simd)))
    elif name == "int32_to_int16":
        _put(_arr(dst, (length,), ctypes.c_int16), _ar.int32_to_int16(
            _arr(src, (length,), ctypes.c_int32), simd=bool(simd)))
    elif name == "float16_to_float":
        _put(_f32(dst, length), _ar.float16_to_float(
            _arr(src, (length,), ctypes.c_uint16), simd=bool(simd)))
    else:
        raise ValueError(name)
    return 0
