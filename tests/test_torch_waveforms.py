"""The port's waveform generators and windows against the JAX package.

The same NumPy inputs go through ``veles.simd_tpu.ops.waveforms`` (on
the CPU platform the root conftest pins) and
``veles.simd_tpu_torch.ops.waveforms`` with ``device="cpu"``.

* Generators: both sides compute in float32 with different libraries,
  so they agree to the JAX package's own float32 envelopes from
  ``tests/test_waveforms.py`` (5e-4 for a 1000-radian chirp sweep,
  1e-5 for the pulses and the square wave away from its edges); the
  sawtooth, whose float32 phase wrap may flip a sample at the apex,
  agrees on 99.9 % of the samples.
* Host-side NumPy (``get_window``, ``max_len_seq``) and every ``_na``
  twin: bit-equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import waveforms as jw
from veles.simd_tpu_torch.ops import waveforms as tw
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

T = np.linspace(0, 2, 4001)
PH = np.linspace(0, 25, 5001)


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


def _np(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


@pytest.mark.parametrize("method,f0,f1", [
    ("linear", 10, 100), ("quadratic", 10, 100),
    ("logarithmic", 5, 200), ("hyperbolic", 100, 10),
    ("hyperbolic", 10, 100), ("linear", 100, 100),
])
def test_chirp_agrees(method, f0, f1):
    got = tw.chirp(T, f0, 2.0, f1, method, phi=25.0)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    want = np.asarray(jw.chirp(T, f0, 2.0, f1, method, phi=25.0,
                               simd=True))
    np.testing.assert_allclose(_np(got), want, atol=5e-4)
    np.testing.assert_array_equal(
        tw.chirp_na(T, f0, 2.0, f1, method, 25.0),
        jw.chirp_na(T, f0, 2.0, f1, method, 25.0))
    np.testing.assert_array_equal(
        tw.chirp(T, f0, 2.0, f1, method, 25.0, simd=False),
        jw.chirp(T, f0, 2.0, f1, method, 25.0, simd=False))


@pytest.mark.parametrize("duty", [0.1, 0.3, 0.5, 0.9])
def test_square_agrees(duty):
    got = _np(tw.square(PH, duty))
    want = np.asarray(jw.square(PH, duty, simd=True))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(tw.square_na(PH, duty),
                                  jw.square_na(PH, duty))


@pytest.mark.parametrize("width", [0.0, 0.25, 0.5, 1.0])
def test_sawtooth_agrees(width):
    got = _np(tw.sawtooth(PH, width))
    want = np.asarray(jw.sawtooth(PH, width, simd=True))
    assert (np.abs(got - want) < 1e-2).mean() > 0.999
    np.testing.assert_array_equal(tw.sawtooth_na(PH, width),
                                  jw.sawtooth_na(PH, width))


def test_pulses_agree():
    t = np.linspace(-1e-2, 1e-2, 2001)
    got = _np(tw.gausspulse(t, 1000, 0.5))
    want = np.asarray(jw.gausspulse(t, 1000, 0.5, simd=True))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(tw.gausspulse_na(t, 1000, 0.5),
                                  jw.gausspulse_na(t, 1000, 0.5))
    for idx in (3, "mid", 0):
        d = tw.unit_impulse(8, idx)
        assert isinstance(d, torch.Tensor)
        np.testing.assert_array_equal(
            d.numpy(), np.asarray(jw.unit_impulse(8, idx, simd=True)))
        np.testing.assert_array_equal(
            tw.unit_impulse(8, idx, simd=False),
            jw.unit_impulse(8, idx, simd=False))


def test_tensor_input_stays_on_its_device():
    t = torch.linspace(0, 1, 101, dtype=torch.float64)
    y = tw.chirp(t, 5, 1.0, 20)
    assert y.dtype == torch.float32 and y.device == t.device
    want = np.asarray(jw.chirp(t.numpy(), 5, 1.0, 20, simd=True))
    np.testing.assert_allclose(y.numpy(), want, atol=5e-5)


def test_max_len_seq_bit_equal():
    for nbits in (3, 8, 12):
        a, sa = tw.max_len_seq(nbits)
        b, sb = jw.max_len_seq(nbits)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sa, sb)
    a, sa = tw.max_len_seq(10, state=np.arange(10) % 3, length=300)
    b, sb = jw.max_len_seq(10, state=np.arange(10) % 3, length=300)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("spec", [
    "hann", "hanning", "hamming", "blackman", "blackmanharris",
    "nuttall", "flattop", "bartlett", "cosine", "boxcar", "rect",
    "tukey", ("tukey", 0.3), ("kaiser", 7.0), ("gaussian", 3.0),
])
def test_windows_bit_equal(spec):
    for n in (1, 2, 16, 51, 256):
        np.testing.assert_array_equal(tw.get_window(spec, n),
                                      jw.get_window(spec, n))
    np.testing.assert_array_equal(tw._cosine_sum_window(33, (0.5, 0.5)),
                                  jw._cosine_sum_window(33, (0.5, 0.5)))


@pytest.mark.parametrize("call,match", [
    (lambda m: m.get_window("gaussian", 16), "std"),
    (lambda m: m.get_window("tukey", 16, alpha=1.5), "alpha"),
    (lambda m: m.get_window("hann", 16, alpha=0.5), "unexpected"),
    (lambda m: m.get_window(("hann", 2.0), 16), "takes no parameter"),
    (lambda m: m.get_window("nope", 16), "unknown window"),
    (lambda m: m.square(PH, 1.5), "duty"),
    (lambda m: m.sawtooth(PH, -0.1), "width"),
    (lambda m: m.chirp(T, 1, 0.0, 2), "t1"),
    (lambda m: m.chirp(T, 0, 1.0, 2, "logarithmic"), "f0, f1 > 0"),
    (lambda m: m.gausspulse(T, bwr=1.0), "bwr"),
    (lambda m: m.unit_impulse(8, 9), "outside"),
    (lambda m: m.max_len_seq(40), "nbits"),
])
@pytest.mark.parametrize("side", ["jax", "torch"])
def test_contract_errors_match(call, match, side):
    with pytest.raises(ValueError, match=match):
        call(jw if side == "jax" else tw)
