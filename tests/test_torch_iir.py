"""The port's IIR module against the JAX package.

The same seeded signals and the same float64 coefficient arrays go
through ``veles.simd_tpu.ops.iir`` (CPU platform) and
``veles.simd_tpu_torch.ops.iir`` with ``device="cpu"``.  Tolerances:

* the host-side designs, converters, responses and steady states:
  1e-12, float64 on both sides (the design half is a copy);
* the runtime (``sosfilt``, ``sosfiltfilt``, ``filtfilt``, ``lfilter``,
  the streaming forms): 2e-5 of max|y| against the JAX package and
  against the float64 oracles (``tests/test_iir.py``'s ``atol=2e-5``);
  both sides are float32 scans in different orders;
* ``simd=False``: the oracle twins, equal to the JAX package's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import iir as jiir
from veles.simd_tpu_torch import obs as tobs
from veles.simd_tpu_torch.ops import iir as tiir
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

TOL = 2e-5
DESIGN_TOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


def _rel(got, want):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _close(got, want, tol=DESIGN_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.max(np.abs(want))))


def _signal(shape, seed=7):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_exports_the_jax_names():
    assert tiir.__all__ == jiir.__all__


# ---- design -----------------------------------------------------------------

DESIGNS = [
    ("butterworth", (4, 0.25)), ("butterworth", (5, 0.3, "highpass")),
    ("butterworth", (3, (0.2, 0.5), "bandpass")),
    ("butterworth", (2, (0.1, 0.6), "bandstop")),
    ("cheby1", (8, 0.05, 0.2)), ("cheby1", (3, 1.0, 0.4, "highpass")),
    ("cheby1", (4, 0.5, (0.2, 0.4), "bandpass")),
    ("cheby2", (6, 40, 0.3)), ("cheby2", (5, 30, (0.2, 0.5), "bandstop")),
    ("bessel", (4, 0.2)), ("bessel", (3, 0.5, "highpass")),
    ("ellip", (5, 0.5, 60, 0.3)), ("ellip", (4, 1.0, 40, (0.2, 0.4),
                                             "bandpass")),
    ("ellip", (1, 1.0, 40, 0.3)),
    ("iirnotch", (0.1, 30.0)), ("iirpeak", (0.25, 10.0)),
]


@pytest.mark.parametrize("name,args", DESIGNS)
def test_designs_match_jax(name, args):
    got = getattr(tiir, name)(*args)
    want = getattr(jiir, name)(*args)
    _close(got, want)
    _close(tiir.sosfilt_zi(got), jiir.sosfilt_zi(want))
    for fn in ("sos_frequency_response", "sos2tf"):
        for g, w in zip(getattr(tiir, fn)(got), getattr(jiir, fn)(want)):
            _close(g, w)


@pytest.mark.parametrize("name,wp,ws", [
    ("buttord", 0.2, 0.3), ("buttord", 0.3, 0.2),
    ("buttord", (0.2, 0.5), (0.1, 0.6)), ("buttord", (0.1, 0.6),
                                           (0.2, 0.5)),
    ("cheb1ord", 0.2, 0.3), ("cheb1ord", (0.1, 0.6), (0.2, 0.5)),
    ("cheb2ord", 0.3, 0.2), ("cheb2ord", (0.2, 0.5), (0.1, 0.6)),
    ("ellipord", 0.2, 0.25), ("ellipord", (0.1, 0.6), (0.2, 0.5)),
])
def test_order_estimators_match_jax(name, wp, ws):
    order, wn = getattr(tiir, name)(wp, ws, 1.0, 40.0)
    want_order, want_wn = getattr(jiir, name)(wp, ws, 1.0, 40.0)
    assert order == want_order
    _close(wn, want_wn)


def test_converters_and_responses_match_jax():
    b, a = [0.2, 0.3, 0.1], [1.0, -0.5, 0.2, -0.05]
    for g, w in zip(tiir.tf2zpk(b, a), jiir.tf2zpk(b, a)):
        _close(g, w)
    z, p, k = jiir.tf2zpk(b, a)
    for g, w in zip(tiir.zpk2tf(z, p, k), jiir.zpk2tf(z, p, k)):
        _close(g, w)
    _close(tiir.zpk2sos(z, p, k), jiir.zpk2sos(z, p, k))
    _close(tiir.tf2sos(b, a), jiir.tf2sos(b, a))
    for fn in ("group_delay",):
        for g, w in zip(getattr(tiir, fn)((b, a), 128),
                        getattr(jiir, fn)((b, a), 128)):
            _close(g, w)
    for g, w in zip(tiir.frequency_response(b, a, 64),
                    jiir.frequency_response(b, a, 64)):
        _close(g, w)
    _close(tiir.lfilter_zi(b, a), jiir.lfilter_zi(b, a))
    _close(tiir.lfilter_zi([2.0, 1.0], [2.0]), jiir.lfilter_zi([2.0, 1.0],
                                                               [2.0]))


def test_design_errors_match_jax():
    for call in (lambda m: m.butterworth(0, 0.2),
                 lambda m: m.butterworth(2, 1.5),
                 lambda m: m.cheby1(2, -1.0, 0.2),
                 lambda m: m.ellip(3, 2.0, 1.0, 0.2),
                 lambda m: m.iirnotch(1.2, 3.0),
                 lambda m: m.buttord(0.2, 0.3, 5.0, 1.0),
                 lambda m: m.lfilter_zi([1.0], [1.0, -1.0]),
                 lambda m: m.sosfilt_zi(np.ones((2, 5)))):
        with pytest.raises(ValueError) as want:
            call(jiir)
        with pytest.raises(ValueError) as got:
            call(tiir)
        assert str(got.value) == str(want.value)


# ---- runtime ----------------------------------------------------------------

FILTERS = {
    "butter4": jiir.butterworth(4, 0.25),
    # poles near the unit circle: the ill-conditioned case
    "cheby1_8": jiir.cheby1(8, 0.05, 0.2),
    "ellip_bp": jiir.ellip(4, 0.5, 50, (0.2, 0.4), "bandpass"),
    "notch": jiir.iirnotch(0.1, 30.0),
    "bessel_hp": jiir.bessel(3, 0.4, "highpass"),
}


@pytest.mark.parametrize("name", sorted(FILTERS))
@pytest.mark.parametrize("shape", [(1,), (2,), (3,), (1001,), (3, 257),
                                   (2, 3, 130)])
def test_sosfilt_matches_jax_and_oracle(name, shape):
    sos = FILTERS[name]
    x = _signal(shape, seed=len(name) + shape[-1])
    got = tiir.sosfilt(sos, x)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert _rel(got, jiir.sosfilt(sos, x, simd=True)) <= TOL
    assert _rel(got, jiir.sosfilt_na(sos, x)) <= TOL
    np.testing.assert_array_equal(tiir.sosfilt(sos, x, simd=False),
                                  jiir.sosfilt(sos, x, simd=False))


def test_sosfilt_long_ill_conditioned_signal():
    # 16 levels of the doubling scan on cheby1 order 8
    sos = FILTERS["cheby1_8"]
    x = _signal((40000,), seed=3)
    assert _rel(tiir.sosfilt(sos, x), jiir.sosfilt_na(sos, x)) <= TOL


@pytest.mark.parametrize("zi_shape", [(2, 2), (3, 2, 2)])
def test_sosfilt_zi_and_return_zf(zi_shape):
    sos = FILTERS["butter4"]
    x = _signal((3, 300), seed=11)
    zi = np.random.RandomState(2).randn(*zi_shape)
    y, zf = tiir.sosfilt(sos, x, zi=zi, return_zf=True)
    wy, wzf = jiir.sosfilt(sos, x, zi=zi, simd=True, return_zf=True)
    oy, ozf = jiir.sosfilt_na(sos, x, zi=zi, return_zf=True)
    assert zf.shape == (3, 2, 2) and zf.dtype == torch.float32
    assert _rel(y, wy) <= TOL and _rel(y, oy) <= TOL
    assert _rel(zf, wzf) <= TOL and _rel(zf, ozf) <= TOL
    # a tensor zi on the signal's device works the same
    y_t = tiir.sosfilt(sos, torch.as_tensor(x),
                       zi=torch.as_tensor(zi, dtype=torch.float64))
    assert _rel(y_t, oy) <= TOL


def test_zi_settles_a_step():
    sos = FILTERS["cheby1_8"]
    x = np.ones(200, np.float32)
    y = tiir.sosfilt(sos, x, zi=tiir.sosfilt_zi(sos)).numpy()
    np.testing.assert_allclose(y, y[0], atol=1e-4)


def test_short_block_contracts():
    sos = FILTERS["butter4"]
    with pytest.raises(ValueError, match="at least 2 samples"):
        tiir.sosfilt(sos, np.ones(1, np.float32), return_zf=True)
    st = tiir.StreamingSosfilt(sos)
    with pytest.raises(ValueError, match="at least 2 samples"):
        st.process(np.ones(1, np.float32))
    with pytest.raises(ValueError, match="normalized"):
        tiir.sosfilt(np.ones((1, 6)) * 2, np.ones(4))


@pytest.mark.parametrize("simd", [True, False])
def test_streaming_equals_one_shot(simd):
    sos = FILTERS["cheby1_8"]
    x = _signal((2, 1000), seed=4)
    st = tiir.StreamingSosfilt(sos, simd=simd)
    bounds = [0, 2, 130, 131 + 2, 600, 1000]
    ys = [st.process(x[:, a:b]) for a, b in zip(bounds, bounds[1:])]
    got = (torch.cat(ys, -1) if simd else np.concatenate(ys, -1))
    want = jiir.sosfilt_na(sos, x)
    assert _rel(got, want) <= TOL
    jst = jiir.StreamingSosfilt(sos, simd=simd)
    want_j = np.concatenate([np.asarray(jst.process(x[:, a:b]))
                             for a, b in zip(bounds, bounds[1:])], -1)
    assert _rel(got, want_j) <= TOL
    st.reset()
    assert _rel(st.process(x[:, :100]), want[:, :100]) <= TOL


def test_stream_step_chain_matches_jax():
    sos = FILTERS["ellip_bp"]
    x = _signal((3, 512), seed=5)
    zi = np.zeros((3, len(sos), 2), np.float32)
    zj = zi
    ys, yj = [], []
    # the pipeline's form: the step inlined into one jitted program
    jstep = jax.jit(lambda c, z: jiir.sos_stream_step(c, sos, z))
    for c in np.split(x, 4, axis=-1):
        y, zi = tiir.sos_stream_step(c, sos, zi)
        ys.append(y)
        y2, zj = jstep(c, zj)
        yj.append(np.asarray(y2))
    assert _rel(torch.cat(ys, -1), np.concatenate(yj, -1)) <= TOL
    assert _rel(zi, zj) <= TOL
    oy, ozf = tiir.sos_stream_step_na(x, sos, np.zeros((3, len(sos), 2)))
    assert _rel(torch.cat(ys, -1), oy) <= TOL and _rel(zi, ozf) <= TOL


@pytest.mark.parametrize("name", ["butter4", "cheby1_8", "ellip_bp"])
@pytest.mark.parametrize("shape,padlen", [((500,), None), ((2, 301), None),
                                          ((2, 301), 0), ((3, 200), 17)])
def test_sosfiltfilt_matches_jax_and_oracle(name, shape, padlen):
    sos = FILTERS[name]
    x = _signal(shape, seed=shape[-1])
    got = tiir.sosfiltfilt(sos, x, padlen=padlen)
    assert _rel(got, jiir.sosfiltfilt(sos, x, padlen=padlen,
                                      simd=True)) <= TOL
    assert _rel(got, jiir.sosfiltfilt_na(sos, x, padlen=padlen)) <= TOL
    np.testing.assert_array_equal(
        tiir.sosfiltfilt(sos, x, padlen=padlen, simd=False),
        jiir.sosfiltfilt(sos, x, padlen=padlen, simd=False))


def test_filtfilt_and_padlen_errors():
    b, a = [0.2, 0.3, 0.1], [1.0, -0.5, 0.2, -0.05]
    x = _signal((2, 400), seed=9)
    got = tiir.filtfilt(b, a, x)
    assert _rel(got, jiir.filtfilt(b, a, x, simd=True)) <= TOL
    assert _rel(got, jiir.filtfilt(b, a, x, simd=False)) <= TOL
    with pytest.raises(ValueError, match="padlen"):
        tiir.sosfiltfilt(FILTERS["butter4"], np.ones(10), padlen=10)


@pytest.mark.parametrize("b,a", [
    ([0.2, 0.3, 0.1], [1.0, -0.5, 0.2, -0.05]),   # the suite's order 3
    ([1.0, 0.5], [1.0]),                          # pure FIR
    ([0.0, 0.0, 1.0], [1.0]),                      # pure delay
    ([2.0, 1.0], [2.0, -0.9]),                     # unnormalized a0
    (list(jiir.sos2tf(jiir.butterworth(6, 0.3))[0]),
     list(jiir.sos2tf(jiir.butterworth(6, 0.3))[1])),
])
@pytest.mark.parametrize("shape", [(1,), (2,), (777,), (2, 3, 99)])
def test_lfilter_matches_jax_and_oracle(b, a, shape):
    x = _signal(shape, seed=len(b) + shape[-1])
    got = tiir.lfilter(b, a, x)
    assert got.dtype == torch.float32
    assert _rel(got, jiir.lfilter(b, a, x, simd=True)) <= TOL
    assert _rel(got, jiir.lfilter_na(b, a, x)) <= TOL
    np.testing.assert_array_equal(tiir.lfilter(b, a, x, simd=False),
                                  jiir.lfilter(b, a, x, simd=False))


def test_lfilter_order_bound():
    assert tiir._LFILTER_MAX_ORDER == jiir._LFILTER_MAX_ORDER == 32
    a = np.r_[1.0, 0.5 ** np.arange(1, 33)]   # order 32: accepted
    x = _signal((200,), seed=1)
    assert _rel(tiir.lfilter([1.0], a, x), jiir.lfilter_na([1.0], a, x)) \
        <= TOL
    with pytest.raises(ValueError) as want:
        jiir.lfilter([1.0], np.r_[a, 0.1], x)
    with pytest.raises(ValueError) as got:
        tiir.lfilter([1.0], np.r_[a, 0.1], x)
    assert str(got.value) == str(want.value)
    assert "use sosfilt" in str(got.value)
    with pytest.raises(ValueError, match="a\\[0\\]"):
        tiir.lfilter([1.0], [0.0, 1.0], x)


def test_affine_scan_and_transition_powers_match_jax():
    # the cum_a = A^(t+1) the sharded sosfilt applies incoming states with
    drive = np.random.RandomState(8).randn(2, 3, 70, 2).astype(np.float32)
    for a1, a2 in ((-0.5, 0.2), (-1.8, 0.95)):
        cum_j, states_j = jax.jit(
            lambda d, a1=a1, a2=a2: jiir._biquad_affine_scan(a1, a2, d))(
                drive)
        cum_t, states_t = tiir._biquad_affine_scan(
            a1, a2, torch.as_tensor(drive))
        assert cum_t.shape == (70, 2, 2)
        assert _rel(np.broadcast_to(cum_t.numpy(), cum_j.shape),
                    cum_j) <= TOL
        assert _rel(states_t, states_j) <= TOL


def test_doubling_powers_stop_at_zero():
    comp = tiir._companion([1.0, -0.5, 0.06])    # poles 0.2 and 0.3
    powers = tiir._doubling_powers(comp, 20)
    # 0.3^(2^7) ~ 1e-67 rounds to zero in float32: levels 0..6 remain
    assert powers.shape == (7, 2, 2) and powers.dtype == np.float32
    np.testing.assert_allclose(powers[3], np.linalg.matrix_power(comp, 8),
                               rtol=1e-6, atol=1e-30)
    assert tiir._doubling_powers(tiir._companion([1.0]), 5).shape == \
        (0, 1, 1)


def test_telemetry_names_match_jax():
    tobs.enable()
    tobs.reset()
    try:
        x = _signal((2, 64))
        tiir.sosfilt(FILTERS["butter4"], x)
        tiir.lfilter([1.0, 0.5], [1.0, -0.3], x)
        tiir.sosfiltfilt(FILTERS["butter4"], x)
        tiir.sosfilt(FILTERS["butter4"], x, simd=False)
        assert tobs.counter_value("dispatch", op="iir",
                                  backend="torch") == 5
        assert tobs.counter_value("dispatch", op="iir",
                                  backend="oracle") == 1
        names = {h["name"] for h in tobs.snapshot()["histograms"]}
        assert {"span.sosfilt.dispatch", "span.lfilter.dispatch",
                "span.sosfiltfilt.dispatch"} <= names
        assert "iir_device_lru" in tobs.caches()
    finally:
        tobs.reset()
        tobs.disable()


@pytest.mark.parametrize("zi_shape", [(2, 3), (3, 2, 2), (4, 2, 2)])
def test_sosfilt_zi_that_does_not_broadcast_raises_the_jax_class(
        zi_shape):
    # F14: ValueError in both packages (torch alone would raise
    # RuntimeError from broadcast_to), checked before the scan
    sos = FILTERS["butter4"]
    x = _signal((2, 64), seed=5)
    zi = np.ones(zi_shape, np.float32)
    with pytest.raises(ValueError):
        jiir.sosfilt(sos, x, zi=zi, simd=True)
    with pytest.raises(ValueError, match="broadcasting"):
        tiir.sosfilt(sos, x, zi=zi)


@pytest.mark.parametrize("zi_shape", [(3, 2), (5, 2), (2, 3, 2)])
def test_sosfilt_zi_with_extra_sections_reads_the_first(zi_shape):
    # the JAX package's leniency, matched on both of the port's routes:
    # a zi with more section rows than sos is filtered with its first
    # len(sos) rows
    sos = FILTERS["butter4"]
    x = _signal((2, 300), seed=9)
    zi = np.random.RandomState(4).randn(*zi_shape).astype(np.float32)
    want, want_zf = jiir.sosfilt(sos, x, zi=zi, simd=True, return_zf=True)
    got, got_zf = tiir.sosfilt(sos, x, zi=zi, return_zf=True)
    assert _rel(got, want) <= TOL and _rel(got_zf, want_zf) <= TOL
    head = zi[..., :len(sos), :]
    assert _rel(got, jiir.sosfilt_na(sos, x, zi=head)) <= TOL
    na = tiir.sosfilt(sos, x, zi=zi, simd=False)
    assert _rel(na, want) <= TOL


@pytest.mark.parametrize("simd", [True, False])
def test_lfilter_with_an_empty_numerator_is_zeros(simd):
    # F15: both JAX routes return zeros; the port's device route read
    # b[0] and raised IndexError
    x = _signal((2, 50), seed=3)
    want = np.asarray(jiir.lfilter([], [1.0, -0.5], x, simd=simd))
    got = tiir.lfilter([], [1.0, -0.5], x, simd=simd)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert not np.any(want)
    np.testing.assert_array_equal(got, want)
    assert got.shape == x.shape and got.dtype == np.float32
