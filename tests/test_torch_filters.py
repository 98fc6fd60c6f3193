"""The port's filters module against the JAX package.

The same seeded signals go through ``veles.simd_tpu.ops.filters`` (CPU
platform) and ``veles.simd_tpu_torch.ops.filters`` with
``device="cpu"``.  Tolerances:

* ``medfilt`` / ``medfilt2d`` / ``order_filter``: exact (a selection,
  no arithmetic), NaNs included (both order them last);
* ``savgol_filter`` and ``wiener``: 1e-5 of max|y| (float32 sums in
  another order);
* the host-side designs (``savgol_coeffs``, ``firwin``, ``firwin2``,
  ``remez``, ``kaiserord``, ``deconvolve``): 1e-12, float64 on both
  sides.
"""

import dataclasses

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import filters as jfl
from veles.simd_tpu_torch.ops import filters as tfl
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

REL_TOL = 1e-5
DESIGN_TOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _signal(shape, seed=5):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_exports_the_jax_names():
    assert tfl.__all__ == jfl.__all__


# ---- median / rank ----------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 15, 31, 33, 41])
@pytest.mark.parametrize("shape", [(300,), (3, 257)])
def test_medfilt_matches_jax(k, shape):
    x = _signal(shape)
    got = tfl.medfilt(x, k)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfl.medfilt(x, k)))
    np.testing.assert_array_equal(tfl.medfilt(x, k, simd=False),
                                  jfl.medfilt(x, k, simd=False))


@pytest.mark.parametrize("k", [3, 5, 9, 21, 33])
def test_order_filter_every_rank(k):
    x = _signal((2, 200), seed=k)
    for rank in sorted({0, 1, k // 2, k - 2, k - 1}):
        np.testing.assert_array_equal(
            tfl.order_filter(x, rank, k).numpy(),
            np.asarray(jfl.order_filter(x, rank, k)))
    np.testing.assert_array_equal(tfl.order_filter_na(x, 1, k),
                                  jfl.order_filter_na(x, 1, k))


@pytest.mark.parametrize("k", [5, 35])
def test_rank_filters_keep_the_jax_nan_semantics(k):
    """NaNs order last, as ``jnp.sort`` (and ``torch.sort``) order
    them: a window's rank-th value is NaN exactly when it holds no
    more than ``rank`` non-NaN samples — in the network (k <= 32) and
    in the sorted window matrix alike."""
    x = _signal((300,))
    x[[10, 11, 12, 100, 150, 152]] = np.nan
    x[200:240] = np.nan
    for rank in (0, k // 2, k - 1):
        got = tfl.order_filter(x, rank, k).numpy()
        want = np.asarray(jfl.order_filter(x, rank, k))
        np.testing.assert_array_equal(got, want)
        assert np.isnan(got).any()


@pytest.mark.parametrize("ksize", [3, 5, (3, 7), (5, 3), 7])
def test_medfilt2d_matches_jax(ksize):
    img = _signal((2, 33, 40))
    got = tfl.medfilt2d(img, ksize)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfl.medfilt2d(img, ksize)))
    np.testing.assert_array_equal(tfl.medfilt2d(img, ksize, simd=False),
                                  jfl.medfilt2d(img, ksize, simd=False))
    img[0, 5, 5] = np.nan
    np.testing.assert_array_equal(tfl.medfilt2d(img, ksize).numpy(),
                                  np.asarray(jfl.medfilt2d(img, ksize)))


def test_impulse_rejection():
    x = np.zeros(64, np.float32)
    x[[10, 30, 31]] = [100.0, -50.0, 80.0]
    np.testing.assert_array_equal(tfl.medfilt(x, 5).numpy()[[10, 30, 31]],
                                  [0.0, 0.0, 0.0])


@pytest.mark.parametrize("call", [
    lambda m: m.medfilt(np.ones(8), 4),
    lambda m: m.order_filter(np.ones(8), 5, 5),
    lambda m: m.medfilt2d(np.ones(8), 3),
    lambda m: m.medfilt2d(np.ones((8, 8)), (3, 2)),
    lambda m: m.savgol_filter(np.ones(8), 11, 2),
    lambda m: m.savgol_filter(np.ones(20), 5, 2, mode="wrap"),
    lambda m: m.savgol_coeffs(5, 5),
    lambda m: m.wiener(np.ones(8), 2),
], ids=["even_k", "rank", "medfilt2d_1d", "even_2d", "interp_long",
        "mode", "polyorder", "wiener_even"])
def test_contracts_match(call):
    with pytest.raises(ValueError) as jerr:
        call(jfl)
    with pytest.raises(ValueError) as terr:
        call(tfl)
    assert str(terr.value) == str(jerr.value)


# ---- Savitzky-Golay ---------------------------------------------------------

SAVGOL = [(11, 3, 0), (9, 2, 1), (15, 4, 2), (5, 4, 0), (31, 3, 0)]


@pytest.mark.parametrize("wl,po,deriv", SAVGOL)
def test_savgol_coeffs_match(wl, po, deriv):
    from scipy import signal as ss

    got = tfl.savgol_coeffs(wl, po, deriv)
    np.testing.assert_allclose(got, jfl.savgol_coeffs(wl, po, deriv),
                               atol=DESIGN_TOL)
    np.testing.assert_allclose(got, ss.savgol_coeffs(wl, po, deriv=deriv),
                               atol=DESIGN_TOL)


@pytest.mark.parametrize("mode", ["interp", "constant", "nearest"])
@pytest.mark.parametrize("wl,po,deriv", SAVGOL)
def test_savgol_filter_matches_jax(wl, po, deriv, mode):
    x = _signal((3, 180)) + 2.0
    got = tfl.savgol_filter(x, wl, po, deriv=deriv, mode=mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    want = np.asarray(jfl.savgol_filter(x, wl, po, deriv=deriv, mode=mode))
    assert _rel(got.numpy(), want) <= REL_TOL
    np.testing.assert_allclose(
        tfl.savgol_filter(x, wl, po, deriv=deriv, mode=mode, simd=False),
        jfl.savgol_filter(x, wl, po, deriv=deriv, mode=mode, simd=False),
        rtol=0, atol=0)


def test_savgol_polynomial_passthrough_and_tensor_input():
    t = np.arange(100, dtype=np.float64)
    x = (0.01 * t ** 2 - 0.5 * t + 3.0).astype(np.float32)
    got = tfl.savgol_filter(torch.from_numpy(x), 11, 2)
    assert _rel(got.numpy(), x) <= REL_TOL


# ---- Wiener -----------------------------------------------------------------

@pytest.mark.parametrize("mysize", [3, 5, 9, 33, 41])
@pytest.mark.parametrize("noise", [None, 0.3])
@pytest.mark.parametrize("offset", [0.0, 1000.0])
def test_wiener_matches_jax(mysize, noise, offset):
    x = _signal((3, 400)) + offset
    x[:, 100:200] *= 0.1
    got = tfl.wiener(x, mysize, noise)
    want = np.asarray(jfl.wiener(x, mysize, noise))
    assert got.dtype == torch.float32
    assert _rel(got.numpy() - offset, want - offset) <= REL_TOL
    np.testing.assert_array_equal(tfl.wiener_na(x, mysize, noise),
                                  jfl.wiener_na(x, mysize, noise))


def test_wiener_matches_scipy_oracle():
    from scipy import signal as ss

    x = _signal((500,)).astype(np.float64)
    np.testing.assert_allclose(tfl.wiener_na(x, 5), ss.wiener(x, 5),
                               atol=1e-10)


# ---- the host-side designs --------------------------------------------------

FIRWIN = [
    ((33, 0.4), {}), ((32, 0.25), {}), ((33, 0.3), {"pass_zero": False}),
    ((41, [0.2, 0.5]), {"pass_zero": False}),
    ((41, [0.2, 0.5]), {"pass_zero": True}),
    ((21, 0.6), {"window": "hann"}), ((55, [0.1, 0.3, 0.6]), {}),
    ((33, 0.3), {"pass_zero": "highpass"}),
    ((41, [0.2, 0.5]), {"pass_zero": "bandstop"}),
    ((41, 0.35), {"window": ("kaiser", 8.6)}),
    ((41, 0.35), {"window": ("tukey", 0.3)}),
    ((31, 0.4), {"window": np.hamming(31)}),
]


@pytest.mark.parametrize("args,kw", FIRWIN)
def test_firwin_matches(args, kw):
    np.testing.assert_allclose(tfl.firwin(*args, **kw),
                               jfl.firwin(*args, **kw), atol=DESIGN_TOL)


@pytest.mark.parametrize("args,kw", [
    ((65, [0, 0.3, 0.3, 1], [1, 1, 0, 0]), {}),
    ((64, [0, 0.5, 1], [1, 1, 0]), {}),
    ((33, [0, 0.2, 0.5, 1], [0, 1, 0.5, 0]), {}),
    ((65, [0.0, 0.3, 0.5, 1.0], [1.0, 1.0, 0.0, 0.0]),
     {"window": ("kaiser", 6.0)}),
    ((31, [0, 0.5, 1], [1, 1, 0]), {"window": None}),
])
def test_firwin2_matches(args, kw):
    np.testing.assert_allclose(tfl.firwin2(*args, **kw),
                               jfl.firwin2(*args, **kw), atol=DESIGN_TOL)


@pytest.mark.parametrize("numtaps,bands,desired,weight", [
    (65, [0, 0.18, 0.22, 0.5], [1, 0], None),
    (64, [0, 0.18, 0.22, 0.5], [1, 0], None),
    (101, [0, 0.1, 0.15, 0.35, 0.4, 0.5], [0, 1, 0], [1, 1, 1]),
    (33, [0, 0.2, 0.3, 0.5], [1, 0], [1, 10]),
    (48, [0, 0.15, 0.25, 0.35, 0.42, 0.5], [1, 0.5, 0], None),
])
def test_remez_matches(numtaps, bands, desired, weight):
    np.testing.assert_allclose(
        tfl.remez(numtaps, bands, desired, weight),
        jfl.remez(numtaps, bands, desired, weight), atol=DESIGN_TOL)


def test_kaiser_design_flow_matches():
    assert tfl.kaiserord(65.0, 0.08) == jfl.kaiserord(65.0, 0.08)
    for a in (10.0, 30.0, 65.0):
        assert tfl.kaiser_beta(a) == jfl.kaiser_beta(a)
    assert tfl.kaiser_atten(101, 0.08) == jfl.kaiser_atten(101, 0.08)


@pytest.mark.parametrize("signal,divisor", [
    ([1.0, 5.0, 10.0, 8.0, 3.0], [1.0, 2.0, 1.0]),
    ([1.0, 2.0], [1.0, 2.0, 3.0]),
    (np.random.RandomState(9).randn(40), [2.0, -0.5, 0.25]),
])
def test_deconvolve_matches(signal, divisor):
    q, r = tfl.deconvolve(signal, divisor)
    jq, jr = jfl.deconvolve(signal, divisor)
    np.testing.assert_allclose(q, jq, atol=DESIGN_TOL)
    np.testing.assert_allclose(r, jr, atol=DESIGN_TOL)


@pytest.mark.parametrize("call", [
    lambda m: m.firwin(32, 0.3, pass_zero=False),
    lambda m: m.firwin(31, [0.5, 0.2]),
    lambda m: m.firwin(31, 0.3, pass_zero="notch"),
    lambda m: m.firwin(31, 0.4, window=np.ones(30)),
    lambda m: m.firwin2(64, [0, 0.5, 1], [1, 1, 1]),
    lambda m: m.remez(31, [0, 0.2, 0.2, 0.5], [1, 0]),
    lambda m: m.kaiserord(5.0, 0.1),
    lambda m: m.deconvolve([1.0, 2.0], [0.0, 1.0]),
], ids=["odd", "increasing", "pass_zero", "window_shape", "firwin2_nyq",
        "remez_touching", "kaiserord", "deconvolve_zero"])
def test_design_contracts_match(call):
    with pytest.raises(ValueError) as jerr:
        call(jfl)
    with pytest.raises(ValueError) as terr:
        call(tfl)
    assert str(terr.value) == str(jerr.value)
