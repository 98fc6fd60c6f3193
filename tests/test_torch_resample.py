"""The port's resample module against the JAX package.

The same seeded signals and the same float64 taps go through
``veles.simd_tpu.ops.resample`` (CPU platform) and
``veles.simd_tpu_torch.ops.resample`` with ``device="cpu"``.
Tolerances (``tests/test_resample.py``'s):

* the polyphase resamplers (``resample_poly``, ``upfirdn``,
  ``upsample``, ``decimate``, the streaming step): 2e-5 of max|y|
  against the JAX package and against the float64 oracles;
* ``resample_fourier``: 1e-4;
* the host-side designs and plans: 1e-12; ``simd=False``: the oracle
  twins, equal to the JAX package's.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import resample as jrs
from veles.simd_tpu_torch import obs as tobs
from veles.simd_tpu_torch.ops import resample as trs
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

TOL = 2e-5
FOURIER_TOL = 1e-4


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


def _signal(shape, seed=3):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_exports_the_jax_names():
    assert trs.__all__ == jrs.__all__


@pytest.mark.parametrize("num_taps,cutoff", [(1, 1.0), (31, 0.5),
                                             (3201, 1 / 160)])
def test_design_matches_jax(num_taps, cutoff):
    np.testing.assert_allclose(trs.design_lowpass(num_taps, cutoff),
                               jrs.design_lowpass(num_taps, cutoff),
                               rtol=0, atol=1e-12)
    for n, up, down in ((1000, 160, 147), (7, 3, 2), (1, 1, 5)):
        assert trs.resample_length(n, up, down) == \
            jrs.resample_length(n, up, down)


RATES = [(3, 3), (2, 1), (1, 2), (3, 2), (2, 3), (160, 147), (147, 160),
         (5, 1), (1, 7), (4, 6)]


@pytest.mark.parametrize("up,down", RATES)
@pytest.mark.parametrize("shape", [(1,), (2,), (101,), (2, 513),
                                   (2, 3, 64)])
def test_resample_poly_matches_jax_and_oracle(up, down, shape):
    x = _signal(shape, seed=up * 7 + down + shape[-1])
    got = trs.resample_poly(x, up, down)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.shape[-1] == trs.resample_length(shape[-1], up // math.gcd(
        up, down), down // math.gcd(up, down))
    assert _rel(got, jrs.resample_poly(x, up, down, simd=True)) <= TOL
    assert _rel(got, jrs.resample_poly_na(x, up, down)) <= TOL
    np.testing.assert_array_equal(trs.resample_poly(x, up, down, simd=False),
                                  jrs.resample_poly(x, up, down, simd=False))


def test_up_equals_down_is_identity():
    x = _signal((3, 50))
    for up in (1, 3):
        got = trs.resample_poly(x, up, up)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), x)
    np.testing.assert_array_equal(trs.upsample(x, 1).numpy(), x)


def test_custom_taps_and_gcd_reduction():
    x = _signal((2, 300), seed=5)
    taps = jrs.design_lowpass(41, 0.4) * 2
    got = trs.resample_poly(x, 4, 6, taps=taps)
    assert _rel(got, jrs.resample_poly(x, 4, 6, taps=taps, simd=True)) \
        <= TOL
    assert _rel(got, jrs.resample_poly_na(x, 2, 3, taps=taps)) <= TOL


@pytest.mark.parametrize("k", [1, 2, 7, 30])
@pytest.mark.parametrize("up,down", [(1, 1), (3, 1), (1, 3), (3, 2),
                                     (4, 6), (2, 5)])
def test_upfirdn_matches_jax_and_oracle(k, up, down):
    h = np.random.RandomState(k).randn(k)
    x = _signal((2, 77), seed=k + up)
    got = trs.upfirdn(h, x, up, down)
    assert _rel(got, jrs.upfirdn(h, x, up, down, simd=True)) <= TOL
    assert _rel(got, jrs.upfirdn_na(h, x, up, down)) <= TOL
    np.testing.assert_array_equal(trs.upfirdn(h, x, up, down, simd=False),
                                  jrs.upfirdn(h, x, up, down, simd=False))


@pytest.mark.parametrize("pad_left", [-5, 0, 3, 14])
def test_core_pad_override_matches_jax(pad_left):
    # the streaming and sharded paths crop with a negative left pad
    taps = np.random.RandomState(1).randn(15)
    x = _signal((2, 50), seed=2)
    want = jrs._resample_conv(x, taps.astype(np.float32), 3, 2, 60,
                              pad=(pad_left, 20))
    got = trs._resample_conv(torch.as_tensor(x), taps, 3, 2, 60,
                             pad=(pad_left, 20))
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("up,down", [(160, 147), (147, 160), (3, 2),
                                     (1, 4), (4, 1)])
def test_polyphase_work_is_bounded(up, down):
    # the core never forms the zero-stuffed signal: its conv1d calls do
    # at most twice out_len * ceil(k/up) multiply-adds a row
    taps = jrs._resample_taps(up, down, None)
    k = len(taps)
    n_phase, step, runs = trs._polyphase_runs(taps, up, down,
                                              k - 1 - (k - 1) // 2)
    assert (n_phase, step) == (up // math.gcd(up, down),
                               down // math.gcd(up, down))
    assert sum(w.shape[0] for _, w in runs) == n_phase
    n = 1 << 20
    out_len = trs.resample_length(n, up, down)
    macs = sum(w.size for _, w in runs) * -(-out_len // n_phase)
    assert macs <= 2 * -(-out_len // n_phase) * n_phase * -(-k // up)
    # every tap lands once in its phase's weights
    assert math.isclose(sum(float(w.sum()) for _, w in runs),
                        float(np.float32(taps).astype(np.float64).sum())
                        * n_phase / up, rel_tol=1e-5)


def test_decimate_matches_jax():
    x = _signal((2, 1000), seed=9)
    for kw in ({}, {"ftype": "iir"}, {"ftype": "iir", "zero_phase": False}):
        got = trs.decimate(x, 4, **kw)
        assert _rel(got, jrs.decimate(x, 4, simd=True, **kw)) <= TOL
        assert _rel(got, jrs.decimate(x, 4, simd=False, **kw)) <= TOL
    with pytest.raises(ValueError, match="ftype"):
        trs.decimate(x, 2, ftype="kaiser")
    with pytest.raises(ValueError, match="taps only"):
        trs.decimate(x, 2, taps=[1.0], ftype="iir")


def test_upsample_matches_jax():
    x = _signal((3, 200), seed=4)
    got = trs.upsample(x, 4)
    assert _rel(got, jrs.upsample(x, 4, simd=True)) <= TOL
    assert _rel(got, jrs.resample_poly_na(x, 4, 1)) <= TOL


@pytest.mark.parametrize("n", [1, 64, 99, 100])
@pytest.mark.parametrize("num", [1, 50, 64, 100, 128, 257])
def test_resample_fourier_matches_jax_and_oracle(n, num):
    x = _signal((2, n), seed=n + num)
    got = trs.resample_fourier(x, num)
    assert got.dtype == torch.float32 and got.shape == (2, num)
    assert _rel(got, jrs.resample_fourier(x, num, simd=True)) <= FOURIER_TOL
    assert _rel(got, jrs.resample_fourier_na(x, num)) <= FOURIER_TOL
    np.testing.assert_array_equal(trs.resample_fourier(x, num, simd=False),
                                  jrs.resample_fourier(x, num, simd=False))


@pytest.mark.parametrize("up,down,block", [(3, 2, 512), (160, 147, 1470),
                                           (1, 4, 256)])
def test_streaming_step_matches_oracle_and_jax(up, down, block):
    plan = trs.resample_stream_plan(up, down, block)
    jplan = jrs.resample_stream_plan(up, down, block)
    assert {k: v for k, v in plan.items() if k != "taps"} == \
        {k: v for k, v in jplan.items() if k != "taps"}
    np.testing.assert_array_equal(plan["taps"], jplan["taps"])
    x = _signal((2, 4 * block), seed=up + down)
    carry = np.zeros((2, plan["hist"]), np.float32)
    outs, jouts = [], []
    for c in np.split(x, 4, axis=-1):
        ext = np.concatenate([carry, c], axis=-1)
        outs.append(trs.resample_stream_step(ext, plan["taps"], plan))
        jouts.append(np.asarray(jrs.resample_stream_step(
            ext, np.float32(plan["taps"]), jplan)))
        np.testing.assert_array_equal(trs.resample_stream_step_na(ext, plan),
                                      jrs.resample_stream_step_na(ext, plan))
        carry = ext[..., -plan["hist"]:]
    got = torch.cat(outs, -1)
    assert _rel(got, np.concatenate(jouts, -1)) <= TOL
    want = trs.resample_stream_oracle(x, plan)
    np.testing.assert_array_equal(want, jrs.resample_stream_oracle(x, plan))
    assert _rel(got, want) <= TOL


def test_contracts_match_jax():
    x = _signal((20,))
    for call in (lambda m: m.resample_poly(x, 0, 2),
                 lambda m: m.resample_poly(x, 2, 3, taps=np.ones(4)),
                 lambda m: m.resample_poly(np.zeros(0), 2, 3),
                 lambda m: m.upfirdn([], x),
                 lambda m: m.upfirdn([1.0], x, 0, 1),
                 lambda m: m.resample_fourier(x, 0),
                 lambda m: m.design_lowpass(0, 0.5),
                 lambda m: m.resample_stream_plan(3, 2, 511),
                 lambda m: m.resample_stream_plan(2, 2, 512)):
        with pytest.raises(ValueError) as want:
            call(jrs)
        with pytest.raises(ValueError) as got:
            call(trs)
        assert str(got.value) == str(want.value)


def test_telemetry_names_match_jax():
    tobs.enable()
    tobs.reset()
    try:
        x = _signal((2, 64))
        trs.resample_poly(x, 3, 2)
        trs.upfirdn([1.0, 0.5], x, 2, 1)
        trs.resample_fourier(x, 40)
        trs.resample_poly(x, 3, 2, simd=False)
        assert tobs.counter_value("dispatch", op="resample",
                                  backend="torch") == 3
        assert tobs.counter_value("dispatch", op="resample",
                                  backend="oracle") == 1
        names = {h["name"] for h in tobs.snapshot()["histograms"]}
        assert {"span.resample_poly.dispatch",
                "span.upfirdn.dispatch"} <= names
        assert "resample_device_lru" in tobs.caches()
    finally:
        tobs.reset()
        tobs.disable()
