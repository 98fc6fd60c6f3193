"""Property-based invariants (hypothesis) of the PyTorch/CUDA port.

The twin of ``tests/test_properties.py``: the same 18 algebraic
contracts — linearity, correlation as a reversed convolution, the DWT's
energy and its QMF filters, the synthesis round trips for every
extension, ``minmax1D``, ``next_highest_power_of_2``, the int16 round
trip, the filter bank's four invariants, 2D linearity and transpose,
and streaming equal to one shot — held by the port's entry points
(``set_config(device="cpu")``), where a regression that keeps oracle
parity but breaks structure (a flipped kernel, a dropped channel) still
fails.  The filter-bank properties run through the kernel wrapper
``ops.cuda_kernels.filter_bank_cuda``: here on CPU tensors (its plain
version), and again as ``cuda`` cases on the card (K2, on 8-row shapes
its gate admits), which ``python tools/run_tests_torch.py --cuda``
runs.  The file imports no JAX, so it runs where only PyTorch is
installed.

    python -m pytest -m slow tests/test_torch_properties.py
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import (  # noqa: E402
    HealthCheck, given, settings, strategies as st)

from veles.simd_tpu_torch.ops import arithmetic as ar  # noqa: E402
from veles.simd_tpu_torch.ops import convolve as cv  # noqa: E402
from veles.simd_tpu_torch.ops import convolve2d as cv2  # noqa: E402
from veles.simd_tpu_torch.ops import correlate as cr  # noqa: E402
from veles.simd_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from veles.simd_tpu_torch.ops import normalize as nz  # noqa: E402
from veles.simd_tpu_torch.ops import wavelet as wv  # noqa: E402
from veles.simd_tpu_torch.ops.wavelet_coeffs import (  # noqa: E402
    WaveletType, scaling_coefficients, supported_orders)
from veles.simd_tpu_torch.utils import config  # noqa: E402
from veles.simd_tpu_torch.utils.memory import (  # noqa: E402
    next_highest_power_of_2)

# slow tier, as the JAX file: hypothesis sweeps
pytestmark = pytest.mark.slow

SETTINGS = dict(max_examples=20, deadline=None)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    prev = config.get_config()
    config.set_config(device="cpu")
    yield
    config.set_config(**dataclasses.asdict(prev))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _signal(min_size=8, max_size=300):
    return st.lists(
        st.floats(-100, 100, width=32), min_size=min_size,
        max_size=max_size).map(lambda v: np.asarray(v, np.float32))


@settings(**SETTINGS)
@given(_signal(), st.integers(1, 7), st.floats(-5, 5, width=32))
def test_convolution_is_linear(x, klen, alpha):
    h = np.linspace(-1, 1, klen).astype(np.float32)
    lhs = _np(cv.convolve_simd((alpha * x).astype(np.float32), h))
    rhs = alpha * _np(cv.convolve_simd(x, h))
    np.testing.assert_allclose(lhs, rhs, atol=2e-2)


@settings(**SETTINGS)
@given(_signal(min_size=16), st.integers(2, 8))
def test_correlate_is_convolve_with_reversed_kernel(x, klen):
    h = (np.arange(klen) - klen / 3).astype(np.float32)
    corr = _np(cr.cross_correlate_simd(x, h))
    conv = _np(cv.convolve_simd(x, h[::-1].copy()))
    np.testing.assert_allclose(corr, conv, atol=1e-3)


@settings(**SETTINGS)
@given(_signal(min_size=32, max_size=256).filter(lambda v: len(v) % 2 == 0),
       st.sampled_from([2, 4, 8, 12]))
def test_dwt_periodic_conserves_energy(x, order):
    """Orthonormal filter bank + periodic extension: Parseval."""
    hi, lo = wv.wavelet_apply(WaveletType.DAUBECHIES, order,
                              wv.ExtensionType.PERIODIC, x)
    e_in = float(np.sum(np.asarray(x, np.float64) ** 2))
    e_out = float(np.sum(_np(hi).astype(np.float64) ** 2)
                  + np.sum(_np(lo).astype(np.float64) ** 2))
    assert e_out == pytest.approx(e_in, rel=1e-3, abs=1e-3)


@settings(**SETTINGS)
@given(st.sampled_from(["daub", "sym", "coif"]), st.data())
def test_filters_are_orthonormal_qmf(family, data):
    wtype = {"daub": WaveletType.DAUBECHIES, "sym": WaveletType.SYMLET,
             "coif": WaveletType.COIFLET}[family]
    order = data.draw(st.sampled_from(sorted(supported_orders(wtype))))
    c = np.asarray(scaling_coefficients(wtype, order), np.float64)
    # the reference's conventions, kept by both packages: Daubechies
    # rows sum to sqrt(2) (energy 1), Symlets and Coiflets to 1 (energy
    # 1/2); the Symlets are the published table's, whose own error
    # reaches about 2e-5 at high orders
    if wtype is WaveletType.DAUBECHIES:
        want_sum, want_energy = np.sqrt(2.0), 1.0
    else:
        want_sum, want_energy = 1.0, 0.5
    tol = 5e-5 if wtype is WaveletType.SYMLET else 1e-8
    assert np.sum(c) == pytest.approx(want_sum, abs=tol)
    assert np.sum(c * c) == pytest.approx(want_energy, abs=tol)
    # double-shift orthogonality survives any scaling
    for shift in range(2, len(c), 2):
        assert np.dot(c[:-shift], c[shift:]) == pytest.approx(
            0.0, abs=max(tol / 2, 1e-8))


@settings(**SETTINGS)
@given(_signal(min_size=3).filter(lambda v: v.max() > v.min()))
def test_minmax1d_brackets_every_sample(x):
    mn, mx = nz.minmax1D(x)
    assert float(mn) == pytest.approx(float(x.min()), abs=1e-6)
    assert float(mx) == pytest.approx(float(x.max()), abs=1e-6)


@settings(**SETTINGS)
@given(st.integers(1, 1 << 30))
def test_next_pow2_is_tight(n):
    p = next_highest_power_of_2(n)
    assert p >= n and p & (p - 1) == 0
    assert p == 1 or p // 2 < n


@settings(**SETTINGS)
@given(st.lists(st.integers(-32768, 32767), min_size=1, max_size=200))
def test_int16_float_roundtrip_exact(vals):
    i16 = np.asarray(vals, np.int16)
    back = _np(ar.float_to_int16(ar.int16_to_float(i16)))
    np.testing.assert_array_equal(back, i16)


# --------------------------------------------------------------------------
# the filter-bank kernel wrapper's invariants: its plain version on CPU
# tensors, and K2 itself on the card (the cuda cases below)
# --------------------------------------------------------------------------

def _fb(x_ext, filters, stride, dilation, n_out, dev="cpu"):
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)

    return [_np(o) for o in ck.filter_bank_cuda(
        t(x_ext), t(filters), stride, dilation, n_out)]


def _fb_linear(seed, order, stride, alpha, rows=3, dev="cpu"):
    rng = np.random.RandomState(seed)
    n_out = 24
    need = (n_out - 1) * stride + order
    x_ext = rng.randn(rows, need).astype(np.float32)
    f = rng.randn(2, order).astype(np.float32)
    base = _fb(x_ext, f, stride, 1, n_out, dev)
    scaled = _fb((alpha * x_ext).astype(np.float32), f, stride, 1, n_out,
                 dev)
    for b, s in zip(base, scaled):
        np.testing.assert_allclose(s, alpha * b, atol=5e-3)


def _fb_superposition(seed, order, rows=2, dev="cpu"):
    """A 2-channel call equals two 1-channel calls (channels
    independent)."""
    rng = np.random.RandomState(seed)
    n_out = 24
    x_ext = rng.randn(rows, n_out + order).astype(np.float32)
    f = rng.randn(2, order).astype(np.float32)
    both = _fb(x_ext, f, 1, 1, n_out, dev)
    solo0 = _fb(x_ext, f[:1], 1, 1, n_out, dev)[0]
    solo1 = _fb(x_ext, f[1:], 1, 1, n_out, dev)[0]
    np.testing.assert_allclose(both[0], solo0, atol=1e-5)
    np.testing.assert_allclose(both[1], solo1, atol=1e-5)


def _fb_shift(seed, shift, rows=2, dev="cpu"):
    """Shifting the input by ``shift`` shifts a stride-1 output by
    ``shift``."""
    rng = np.random.RandomState(seed)
    order, n_out = 5, 32
    x_ext = rng.randn(rows, n_out + order + shift).astype(np.float32)
    f = rng.randn(1, order).astype(np.float32)
    (full,) = _fb(x_ext, f, 1, 1, n_out + shift, dev)
    (shifted,) = _fb(x_ext[:, shift:], f, 1, 1, n_out, dev)
    np.testing.assert_allclose(shifted, full[:, shift:], atol=1e-5)


def _fb_dilation(seed, order, dilation, rows=2, dev="cpu"):
    """Dilated taps equal zero-upsampled taps at dilation 1 (the
    a-trous identity, src/wavelet.c:211-246)."""
    rng = np.random.RandomState(seed)
    n_out = 16
    x_ext = rng.randn(rows, n_out + order * dilation + 2).astype(np.float32)
    f = rng.randn(1, order).astype(np.float32)
    up = np.zeros((1, (order - 1) * dilation + 1), np.float32)
    up[0, ::dilation] = f[0]
    (dil,) = _fb(x_ext, f, 1, dilation, n_out, dev)
    (ups,) = _fb(x_ext, up, 1, 1, n_out, dev)
    np.testing.assert_allclose(dil, ups, atol=1e-5)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(2, 9),
       st.sampled_from([1, 2]), st.floats(-3, 3, width=32))
def test_filter_bank_is_linear(seed, order, stride, alpha):
    _fb_linear(seed, order, stride, alpha)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(2, 9))
def test_filter_bank_superposition_over_channels(seed, order):
    _fb_superposition(seed, order)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 8))
def test_filter_bank_shift_equivariance(seed, shift):
    _fb_shift(seed, shift)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(2, 6), st.integers(1, 3))
def test_filter_bank_dilation_equals_upsampled_taps(seed, order, dilation):
    _fb_dilation(seed, order, dilation)


# K2 on the card: the same four properties on 8-row shapes (the
# wavelet and direct routes' gate admits 8 rows and more)
CARD_ROWS = 8


# the fixture holds for a test's examples together: its launch count
# is read once, after all of them
CARD = dict(suppress_health_check=[HealthCheck.function_scoped_fixture])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available())")
    config.set_config(device="cuda")
    ck.reset_launches()
    yield "cuda"
    config.set_config(device="cpu")
    # the examples launched K2: none took the plain version
    assert ck.LAUNCHES["filter_bank"] >= 1


@pytest.mark.cuda
@settings(max_examples=10, deadline=None, **CARD)
@given(st.integers(0, 2 ** 31 - 1), st.integers(2, 9),
       st.sampled_from([1, 2]), st.floats(-3, 3, width=32))
def test_k2_is_linear_on_the_card(card, seed, order, stride, alpha):
    _fb_linear(seed, order, stride, alpha, rows=CARD_ROWS, dev=card)


@pytest.mark.cuda
@settings(max_examples=10, deadline=None, **CARD)
@given(st.integers(0, 2 ** 31 - 1), st.integers(2, 9))
def test_k2_superposition_over_channels_on_the_card(card, seed, order):
    _fb_superposition(seed, order, rows=CARD_ROWS, dev=card)


@pytest.mark.cuda
@settings(max_examples=10, deadline=None, **CARD)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 8))
def test_k2_shift_equivariance_on_the_card(card, seed, shift):
    _fb_shift(seed, shift, rows=CARD_ROWS, dev=card)


@pytest.mark.cuda
@settings(max_examples=8, deadline=None, **CARD)
@given(st.integers(0, 2 ** 31 - 1), st.integers(2, 6), st.integers(1, 3))
def test_k2_dilation_equals_upsampled_taps_on_the_card(card, seed, order,
                                                       dilation):
    _fb_dilation(seed, order, dilation, rows=CARD_ROWS, dev=card)


# --------------------------------------------------------------------------
# 2D convolution + wavelet synthesis invariants
# --------------------------------------------------------------------------

@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.floats(-3, 3, width=32))
def test_conv2d_is_linear(seed, alpha):
    rng = np.random.RandomState(seed)
    x = rng.randn(9, 11).astype(np.float32)
    h = rng.randn(3, 2).astype(np.float32)
    lhs = _np(cv2.convolve2d((alpha * x).astype(np.float32), h))
    rhs = alpha * _np(cv2.convolve2d(x, h))
    np.testing.assert_allclose(lhs, rhs, atol=1e-2)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_conv2d_commutes_with_transpose(seed):
    """conv2d(x.T, h.T) == conv2d(x, h).T — axis symmetry."""
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 13).astype(np.float32)
    h = rng.randn(4, 3).astype(np.float32)
    a = _np(cv2.convolve2d(np.ascontiguousarray(x.T),
                           np.ascontiguousarray(h.T)))
    b = _np(cv2.convolve2d(x, h)).T
    np.testing.assert_allclose(a, b, atol=1e-4)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.sampled_from([2, 6, 8, 12]),
       st.sampled_from([16, 32, 64]))
def test_dwt_synthesis_inverts_analysis(seed, order, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(n).astype(np.float32)
    hi, lo = wv.wavelet_apply("daub", order, wv.ExtensionType.PERIODIC, x)
    rec = wv.wavelet_reconstruct("daub", order, hi, lo)
    np.testing.assert_allclose(_np(rec), x, atol=2e-4)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_streaming_equals_one_shot(seed):
    rng = np.random.RandomState(seed)
    chunk = int(rng.randint(8, 40))
    n_chunks = int(rng.randint(1, 5))
    k = int(rng.randint(1, 3 * chunk))      # carry can exceed a chunk
    x = rng.randn(chunk * n_chunks).astype(np.float32)
    h = rng.randn(k).astype(np.float32)
    sc = cv.StreamingConvolution(h, chunk)
    parts = [_np(sc.process(x[i:i + chunk]))
             for i in range(0, x.size, chunk)]
    parts.append(_np(sc.flush()))
    np.testing.assert_allclose(np.concatenate(parts), cv.convolve_na(x, h),
                               atol=1e-3)


# --------------------------------------------------------------------------
# non-periodic synthesis invariants, on the port's device path
# --------------------------------------------------------------------------

@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1),
       st.sampled_from(list(wv.ExtensionType)),
       st.sampled_from([4, 8, 12]))
def test_dwt_synthesis_is_consistent_every_ext(seed, ext, order):
    """For every extension, re-analyzing the reconstruction reproduces
    the coefficients — the least-squares guarantee that holds even
    where the non-periodic analysis is rank-deficient."""
    rng = np.random.RandomState(seed)
    x = rng.randn(128).astype(np.float32)
    hi, lo = wv.wavelet_apply("daub", order, ext, x)
    rec = wv.wavelet_reconstruct("daub", order, hi, lo, ext=ext)
    hi2, lo2 = wv.wavelet_apply("daub", order, ext, rec)
    hi, lo, hi2, lo2 = (_np(a) for a in (hi, lo, hi2, lo2))
    scale = max(float(np.max(np.abs(hi))), float(np.max(np.abs(lo))), 1e-3)
    assert float(np.max(np.abs(hi2 - hi))) < 1e-4 * scale
    assert float(np.max(np.abs(lo2 - lo))) < 1e-4 * scale


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1),
       st.sampled_from([wv.ExtensionType.MIRROR, wv.ExtensionType.CONSTANT,
                        wv.ExtensionType.ZERO]),
       st.integers(1, 3))
def test_swt_nonperiodic_synthesis_roundtrips(seed, ext, level):
    """The SWT frame stays full-rank under every extension: analysis ->
    synthesis recovers the signal (within boundary conditioning)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(192).astype(np.float32)
    hi, lo = wv.stationary_wavelet_apply("daub", 6, level, ext, x)
    rec = wv.stationary_wavelet_reconstruct("daub", 6, level, hi, lo,
                                            ext=ext)
    assert float(np.max(np.abs(_np(rec) - x))) < 5e-3


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1),
       st.sampled_from(list(wv.ExtensionType)))
def test_synthesis_is_linear_every_ext(seed, ext):
    """Reconstruction is a linear map for every extension (the Woodbury
    correction is linear in the bands)."""
    rng = np.random.RandomState(seed)
    hi = rng.randn(64).astype(np.float32)
    lo = rng.randn(64).astype(np.float32)
    a = np.float32(1.7)
    r1 = wv.wavelet_reconstruct("daub", 8, (a * hi).astype(np.float32),
                                (a * lo).astype(np.float32), ext=ext)
    r2 = a * _np(wv.wavelet_reconstruct("daub", 8, hi, lo, ext=ext))
    np.testing.assert_allclose(_np(r1), r2, atol=1e-3)
