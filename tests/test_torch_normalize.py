"""The port's normalize module against the JAX package.

The same seeded u8 planes go through ``veles.simd_tpu.ops.normalize``
(CPU platform) and ``veles.simd_tpu_torch.ops.normalize`` with
``device="cpu"``: min/max exact, the normalized planes to 1e-6 (one
divide and one subtract per element; XLA may lower the divide to a
reciprocal multiply), flat planes exactly zero.
"""

import dataclasses

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import normalize as jnz
from veles.simd_tpu_torch import obs as tobs
from veles.simd_tpu_torch.ops import normalize as tnz
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


def test_exports_the_jax_names():
    assert tnz.__all__ == jnz.__all__


@pytest.mark.parametrize("shape", [(3, 3), (16, 16), (127, 99), (480, 640),
                                   (4, 16, 16), (2, 3, 8, 9)])
def test_normalize2d_matches_jax(shape):
    src = np.random.RandomState(31).randint(0, 256, shape).astype(np.uint8)
    got = tnz.normalize2D(src)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(jnz.normalize2D(src)),
                               atol=1e-6)
    assert got.min() >= -1.0 - 1e-6 and got.max() <= 1.0 + 1e-6
    np.testing.assert_array_equal(tnz.normalize2D(src, simd=False),
                                  jnz.normalize2D(src, simd=False))


def test_flat_planes_are_zero_in_a_batch():
    src = np.random.RandomState(32).randint(0, 256, (4, 16, 16))
    src = src.astype(np.uint8)
    src[2] = 7
    got = tnz.normalize2D(src).numpy()
    np.testing.assert_array_equal(got[2], np.zeros((16, 16), np.float32))
    assert np.isfinite(got).all()
    for b in range(4):
        np.testing.assert_allclose(got[b], jnz.normalize2D_novec(src[b]),
                                   atol=1e-5)
    flat = np.full((8, 8), 42, np.uint8)
    np.testing.assert_array_equal(tnz.normalize2D(flat).numpy(),
                                  np.zeros((8, 8), np.float32))
    np.testing.assert_array_equal(
        tnz.normalize2D_minmax(7, 7, flat).numpy(),
        np.zeros((8, 8), np.float32))


def test_full_range_plane():
    src = np.array([[0, 255], [128, 64]], np.uint8)
    got = tnz.normalize2D(src).numpy()
    np.testing.assert_allclose(got[0], [-1.0, 1.0], atol=1e-6)


def test_normalize2d_minmax_precomputed_and_batched():
    r = np.random.RandomState(33)
    src = r.randint(10, 200, (32, 32)).astype(np.uint8)
    np.testing.assert_allclose(
        tnz.normalize2D_minmax(10, 200, src).numpy(),
        np.asarray(jnz.normalize2D_minmax(10, 200, src)), atol=1e-6)
    batch = r.randint(0, 256, (4, 16, 16)).astype(np.uint8)
    for simd in (True, False):
        mn, mx = tnz.minmax2D(batch, simd=simd)
        got = tnz.normalize2D_minmax(mn, mx, batch, simd=simd)
        want = tnz.normalize2D(batch, simd=simd)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-6)


@pytest.mark.parametrize("simd", [True, False])
def test_minmax2d_matches_jax(simd):
    src = np.random.RandomState(34).randint(0, 256, (3, 64, 64))
    src = src.astype(np.uint8)
    mn, mx = tnz.minmax2D(src, simd=simd)
    jmn, jmx = jnz.minmax2D(src, simd=simd)
    np.testing.assert_array_equal(np.asarray(mn), np.asarray(jmn))
    np.testing.assert_array_equal(np.asarray(mx), np.asarray(jmx))
    assert np.asarray(mn).dtype == np.uint8


@pytest.mark.parametrize("simd", [True, False])
@pytest.mark.parametrize("shape", [(1001,), (3, 257)])
def test_minmax1d_matches_jax(simd, shape):
    src = np.random.RandomState(35).randn(*shape).astype(np.float32)
    mn, mx = tnz.minmax1D(src, simd=simd)
    jmn, jmx = jnz.minmax1D(src, simd=simd)
    np.testing.assert_array_equal(np.asarray(mn), np.asarray(jmn))
    np.testing.assert_array_equal(np.asarray(mx), np.asarray(jmx))


@pytest.mark.parametrize("fn", ["normalize2D", "minmax2D"])
def test_contract_violation(fn):
    with pytest.raises(ValueError) as jerr:
        getattr(jnz, fn)(np.zeros(8, np.uint8))
    with pytest.raises(ValueError) as terr:
        getattr(tnz, fn)(np.zeros(8, np.uint8))
    assert str(terr.value) == str(jerr.value)


def test_dispatch_span_recorded():
    tobs.enable()
    tobs.reset()
    try:
        tnz.normalize2D(np.ones((4, 4), np.uint8))
        tnz.normalize2D_minmax(0, 1, np.ones((4, 4), np.uint8))
        names = {h["name"] for h in tobs.snapshot()["histograms"]}
    finally:
        tobs.disable()
        tobs.reset()
    assert {"span.normalize2d.dispatch",
            "span.normalize2d_minmax.dispatch"} <= names


@pytest.mark.parametrize("call,shape", [
    ("normalize2D", (0, 4)), ("normalize2D", (3, 0)),
    ("normalize2D", (2, 0, 5)), ("minmax2D", (0, 4)),
    ("minmax2D", (3, 0)), ("minmax2D", (2, 0, 5)), ("minmax1D", (0,)),
    ("minmax1D", (3, 0)), ("minmax1D", (0, 0))])
def test_empty_input_raises_the_jax_class(call, shape):
    # F4: an empty reduction on the device path raises ValueError in
    # both packages (torch alone would raise IndexError)
    src = np.zeros(shape, np.uint8 if call == "normalize2D"
                   else np.float32)
    with pytest.raises(ValueError) as want:
        getattr(jnz, call)(src, simd=True)
    with pytest.raises(ValueError) as got:
        getattr(tnz, call)(src, simd=True)
    assert "zero-size" in str(got.value) and "zero-size" in str(want.value)
