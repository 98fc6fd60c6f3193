"""The port's mathfun module against the JAX package.

The same NumPy inputs, made from a seed, go through
``veles.simd_tpu.ops.mathfun`` (CPU platform) and
``veles.simd_tpu_torch.ops.mathfun`` with ``device="cpu"``, at these
tolerances: sin/cos/exp rtol 1e-5, atol 1e-6; log
rtol 1e-4, atol 1e-4 (``tests/test_mathfun.py``'s), with its special
values exact; pow rtol 2e-5 and sqrt rtol 1e-6, the JAX test's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import mathfun as jmf
from veles.simd_tpu_torch.ops import mathfun as tmf
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

SIZES = [1, 3, 64, 199, 100003]


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


def test_exports_the_jax_names():
    assert tmf.__all__ == jmf.__all__
    for name in ("sin_psv_na", "cos_psv_na", "log_psv_na", "exp_psv_na"):
        assert hasattr(tmf, name)


@pytest.mark.parametrize("length", SIZES)
@pytest.mark.parametrize("name", ["sin_psv", "cos_psv", "exp_psv"])
def test_trig_exp_match_jax(name, length):
    data = ((np.random.RandomState(length).rand(length) - 0.5)
            * 20.0).astype(np.float32)
    got = getattr(tmf, name)(data)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(getattr(jmf, name)(data)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(getattr(tmf, name)(data, simd=False),
                                  getattr(jmf, name)(data, simd=False))
    np.testing.assert_array_equal(getattr(tmf, name + "_na")(data),
                                  getattr(jmf, name + "_na")(data))


@pytest.mark.parametrize("length", SIZES)
@pytest.mark.parametrize("scale,offset", [(1000.0, 1e-6), (4.9, 0.1)])
def test_log_matches_jax(length, scale, offset):
    data = (np.random.RandomState(length).rand(length) * scale
            + offset).astype(np.float32)
    got = tmf.log_psv(data).numpy()
    np.testing.assert_allclose(got, np.asarray(jmf.log_psv(data)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.log(data.astype(np.float64)),
                               rtol=1e-4, atol=1e-4)


def test_log_special_values_match_jax():
    """XLA flushes subnormals, so the JAX package's log
    gives -inf for them; ``torch.log`` gives their true logarithm
    (-92.1 for 1e-40), so the port flushes them explicitly."""
    x = np.array([1e-40, -1e-40, 1e-45, 0.0, -0.0, -1.0, -1e-30, np.nan,
                  np.inf, -np.inf, 1.0, float(np.finfo(np.float32).tiny)],
                 np.float32)
    got = tmf.log_psv(x).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmf.log_psv(x)))
    assert got[0] == -np.inf
    np.testing.assert_array_equal(got[:5], [-np.inf] * 5)
    assert np.isnan(got[5:8]).all()
    assert got[8] == np.inf and got[10] == 0.0


def test_pow_sqrt_match_jax():
    r = np.random.RandomState(512)
    base = (r.rand(512) * 10.0 + 0.1).astype(np.float32)
    exponent = ((r.rand(512) - 0.5) * 4.0).astype(np.float32)
    np.testing.assert_allclose(tmf.pow_psv(base, exponent).numpy(),
                               np.asarray(jmf.pow_psv(base, exponent)),
                               rtol=2e-5)
    np.testing.assert_allclose(tmf.sqrt_psv(base).numpy(),
                               np.asarray(jmf.sqrt_psv(base)), rtol=1e-6)
    np.testing.assert_array_equal(tmf.pow_psv(base, exponent, simd=False),
                                  jmf.pow_psv(base, exponent, simd=False))


def test_golden_values():
    np.testing.assert_allclose(
        tmf.sin_psv(np.array([0.0, np.pi / 2], np.float32)).numpy(),
        [0.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(
        tmf.exp_psv(np.array([0.0, 1.0], np.float32)).numpy(),
        [1.0, np.e], rtol=1e-6)
    np.testing.assert_allclose(
        tmf.log_psv(np.array([1.0, np.e], np.float32)).numpy(),
        [0.0, 1.0], atol=2e-5)


def test_tensor_input_and_batched_shape():
    x = torch.linspace(0.5, 2.0, 24).reshape(2, 3, 4)
    got = tmf.log_psv(x)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.log(x.numpy()), rtol=1e-6)
