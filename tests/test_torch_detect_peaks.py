"""The port's detect_peaks module against the JAX package.

The same seeded signals go through ``veles.simd_tpu.ops.detect_peaks``
(CPU platform) and ``veles.simd_tpu_torch.ops.detect_peaks`` with
``device="cpu"``.  Both compute in float32 with the same operations,
so peak positions and values, counts, prominences and bases are
exact; the crossings and their heights to 1e-5 of max|y| (the
interpolation's division may round apart).  The widths are held to
the float64 oracle at 1e-5 of max|y|.  Against the JAX package they
differ by up to one float32 ulp of the signal's length: the JAX
package takes each width as ``right_ip - left_ip`` in float32, which
keeps only that ulp of precision (2.5e-5 of max|w| off the float64
oracle at n = 2000), where the port sums the crossings' distances
from the peak.
"""

import dataclasses

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import detect_peaks as jdp
from veles.simd_tpu_torch.ops import detect_peaks as tdp
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

WIDTH_TOL = 1e-5
X = np.random.RandomState(91).randn(2000).astype(np.float32)
# a noisy multi-tone, the chip run's signal at a small size
_t = np.arange(1 << 13)
TONES = (np.sin(2 * np.pi * _t / 500.0) + 0.5 * np.sin(2 * np.pi * _t / 37.0)
         + 0.2 * np.random.RandomState(92).randn(1 << 13)).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


def _close_to_jax_widths(got, want, n):
    """Within one float32 ulp of the largest position (the JAX
    package's rounding of ``right_ip - left_ip``) plus 1e-5 of
    max|w|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = np.spacing(np.float32(n)) + WIDTH_TOL * np.max(np.abs(want),
                                                           initial=0.0)
    return float(np.max(np.abs(got - want), initial=0.0)) <= bound


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want), initial=0.0)
                 / max(np.max(np.abs(want), initial=0.0), 1e-30))


def test_exports_the_jax_names():
    assert tdp.__all__ == jdp.__all__
    assert [(e.name, e.value) for e in tdp.ExtremumType] == \
        [(e.name, e.value) for e in jdp.ExtremumType]


@pytest.mark.parametrize("signal", ["randn", "tones", "sin", "flat",
                                    "plateau", "alternating"])
@pytest.mark.parametrize("type", [1, 2, 3])
def test_detect_peaks_matches_jax(signal, type):
    x = {"randn": X, "tones": TONES,
         "sin": np.sin(np.arange(0, 4 * np.pi, 0.01)).astype(np.float32),
         "flat": np.zeros(64, np.float32),
         "plateau": np.array([0, 1, 1, 0, 2, 2, 2, 1], np.float32),
         "alternating": np.tile([0.0, 1.0], 50).astype(np.float32)}[signal]
    pos, vals = tdp.detect_peaks(x, type)
    jpos, jvals = jdp.detect_peaks(x, type)
    assert pos.dtype == np.int32 and vals.dtype == np.float32
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(vals, jvals)
    npos, nvals = tdp.detect_peaks(x, type, simd=False)
    np.testing.assert_array_equal(npos, jpos)
    np.testing.assert_array_equal(nvals, jvals)


def test_sin_peaks_analytic():
    t = np.arange(0, 4 * np.pi, 0.01, dtype=np.float32)
    pos, vals = tdp.detect_peaks(np.sin(t), tdp.ExtremumType.MAXIMUM)
    assert len(pos) == 2
    for p, e in zip(pos, [np.pi / 2, np.pi / 2 + 2 * np.pi]):
        assert abs(t[p] - e) < 0.02
    np.testing.assert_allclose(vals, 1.0, atol=1e-3)


@pytest.mark.parametrize("shape,max_peaks", [
    ((997,), None), ((997,), 50), ((997,), 200), ((997,), 249),
    ((997,), 250), ((997,), 2000), ((4, 300), None), ((4, 300), 10),
    ((2, 3, 64), 7), ((5,), 1)])
@pytest.mark.parametrize("type", [1, 3])
def test_detect_peaks_fixed_matches_jax(shape, max_peaks, type):
    """Both compaction routes (top-k below n/4, the rank scatter
    above), batched rows, truncation and an over-large capacity."""
    x = np.random.RandomState(41).randn(*shape).astype(np.float32)
    got = tdp.detect_peaks_fixed(x, type, max_peaks)
    want = jdp.detect_peaks_fixed(x, type, max_peaks)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def test_fixed_default_capacity_holds_alternating():
    x = np.tile([0.0, 1.0], 40).astype(np.float32)
    pos, vals, count = tdp.detect_peaks_fixed(x)
    assert int(count) == 78 and pos.shape == (78,)
    assert (pos.numpy() >= 1).all()


@pytest.mark.parametrize("call", [
    lambda m: m.detect_peaks(np.zeros(2, np.float32)),
    lambda m: m.detect_peaks(np.zeros((2, 8), np.float32)),
    lambda m: m.detect_peaks_fixed(np.zeros(2, np.float32)),
    lambda m: m.peak_prominences(X, [len(X)]),
    lambda m: m.peak_widths(X, [10], rel_height=1.0),
    lambda m: m.find_peaks(np.zeros((2, 10), np.float32)),
    lambda m: m.find_peaks(X, distance=0),
    lambda m: m.find_peaks(X, height=np.zeros(3)),
], ids=["short", "2d", "fixed_short", "prom_range", "rel_height", "fp_2d",
        "distance", "per_peak"])
def test_contracts_match(call):
    with pytest.raises(ValueError) as jerr:
        call(jdp)
    with pytest.raises(ValueError) as terr:
        call(tdp)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("x", [X, TONES], ids=["randn", "tones"])
def test_prominences_match_jax_exactly(x):
    peaks, _ = jdp.find_peaks(x)
    got = tdp.peak_prominences(x, peaks)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jdp.peak_prominences(x, peaks)))
    np.testing.assert_allclose(tdp.peak_prominences(x, peaks, simd=False),
                               jdp.peak_prominences(x, peaks, simd=False),
                               atol=0)


def test_prominence_textbook_and_non_peak():
    x = np.array([0, 5, 2, 8, 1, 0], np.float32)
    np.testing.assert_allclose(tdp.peak_prominences(x, [1, 3]).numpy(),
                               [3.0, 8.0], atol=1e-6)
    y = np.array([1.0, 3.0, 2.0], np.float32)
    np.testing.assert_allclose(tdp.peak_prominences(y, [2]).numpy(), [0.0])
    np.testing.assert_allclose(tdp.peak_prominences_na(y, [2]), [0.0])


@pytest.mark.parametrize("rel_height", [0.0, 0.3, 0.5, 0.75, 0.95])
@pytest.mark.parametrize("x", [X, TONES], ids=["randn", "tones"])
def test_widths_match_jax(x, rel_height):
    peaks, _ = jdp.find_peaks(x)
    got = tdp.peak_widths(x, peaks, rel_height=rel_height)
    want = jdp.peak_widths(x, peaks, rel_height=rel_height)
    prom = tdp.peak_prominences(x, peaks).numpy()
    oracle = tdp.peak_widths_na(x, peaks, rel_height, prom=prom)
    for i, (g, w, o) in enumerate(zip(got, want, oracle)):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), o) <= WIDTH_TOL
        if i == 0:
            assert _close_to_jax_widths(g.numpy(), w, len(x))
        else:
            assert _rel(g.numpy(), np.asarray(w)) <= WIDTH_TOL
    for g, w in zip(tdp.peak_widths(x, peaks, rel_height, simd=False),
                    jdp.peak_widths(x, peaks, rel_height, simd=False)):
        np.testing.assert_array_equal(g, w)


def test_widths_textbook_case():
    x = np.r_[np.linspace(0, 4, 5), np.linspace(4, 0, 5)[1:]]
    w, h, li, ri = tdp.peak_widths(x.astype(np.float32), [4], 0.5)
    np.testing.assert_allclose(w.numpy(), [4.0], atol=1e-5)
    np.testing.assert_allclose(h.numpy(), [2.0], atol=1e-6)


@pytest.mark.parametrize("kw", [
    {}, {"height": 1.0}, {"height": (0.5, 2.0)}, {"threshold": 0.3},
    {"threshold": (0.1, 2.0)}, {"distance": 20}, {"prominence": 1.0},
    {"prominence": (0.5, 3.0)},
    {"height": 0.2, "distance": 10, "prominence": 0.8},
    {"height": 0.5, "threshold": 0.2, "distance": 15},
    {"height": np.array([0.5, 2.0])},
    {"width": 2.0}, {"width": (1.5, 4.0)},
    {"width": 2.0, "rel_height": 0.7}, {"prominence": 0.5, "width": 1.0},
])
@pytest.mark.parametrize("simd", [True, False])
@pytest.mark.parametrize("x", [X, TONES], ids=["randn", "tones"])
def test_find_peaks_matches_jax(x, simd, kw):
    """Positions, heights, thresholds, prominences and bases (scipy's
    tie rules, ``_bases_from_spans``) exact; widths to 1e-5."""
    got, gp = tdp.find_peaks(x, simd=simd, **kw)
    want, wp = jdp.find_peaks(x, simd=simd, **kw)
    np.testing.assert_array_equal(got, want)
    assert set(gp) == set(wp)
    for key in wp:
        g, w = np.asarray(gp[key]), np.asarray(wp[key])
        assert len(g) == len(got)
        if key == "widths" and simd:
            assert _close_to_jax_widths(g, w, len(x)), key
        elif key in ("widths", "width_heights", "left_ips", "right_ips"):
            assert _rel(g, w) <= WIDTH_TOL, key
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_find_peaks_distance_tie_break_matches_scipy():
    from scipy import signal as ss

    x = np.array([0, 1, 0, 1, 0], np.float64)
    got, _ = tdp.find_peaks(x.astype(np.float32), distance=3)
    np.testing.assert_array_equal(got, ss.find_peaks(x, distance=3)[0])


def test_find_peaks_tensor_input():
    got, gp = tdp.find_peaks(torch.from_numpy(TONES), prominence=0.5)
    want, wp = jdp.find_peaks(TONES, prominence=0.5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gp["prominences"], wp["prominences"])
