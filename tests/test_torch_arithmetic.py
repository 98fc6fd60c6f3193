"""The port's arithmetic module against the JAX package.

The same NumPy inputs, made from a seed, go through
``veles.simd_tpu.ops.arithmetic`` (CPU platform) and
``veles.simd_tpu_torch.ops.arithmetic`` with ``device="cpu"``.  The
integer conversions, ``float16_to_float`` and the integer multiply are
exact, and so are the float ops of one IEEE operation per element.
The complex multiplies (XLA may fuse a multiply-add) agree to rtol and
atol 1e-6, the JAX test's oracle tolerance, and ``sum_elements``
(another summation order) to rtol 1e-5, the JAX test's.  The
``simd=False`` twins are bit-equal NumPy.
"""

import dataclasses

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import arithmetic as jar
from veles.simd_tpu_torch.ops import arithmetic as tar
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

RNG_SEED = 1234


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


def _both(name, *args, **kw):
    got = getattr(tar, name)(*args, **kw)
    want = np.asarray(getattr(jar, name)(*args, **kw))
    assert isinstance(got, torch.Tensor)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    return got, want


def test_exports_the_jax_names():
    assert tar.__all__ == jar.__all__
    for name in jar.__all__:
        assert hasattr(tar, name)
        na = name + "_na"
        if hasattr(jar, na):
            assert hasattr(tar, na), na


def _inputs(name, length, r):
    f = (r.rand(length).astype(np.float32) - 0.5)
    i16 = r.randint(-32768, 32768, size=length).astype(np.int16)
    return {
        "int16_to_float": (i16,),
        "float_to_int16": (f * 65000,),
        "int32_to_float": (r.randint(-(2 ** 24), 2 ** 24,
                                     size=length).astype(np.int32),),
        "float_to_int32": (f * 1e6,),
        "int16_to_int32": (i16,),
        "int32_to_int16": (r.randint(-70000, 70000,
                                     size=length).astype(np.int32),),
        "int16_multiply": (i16, r.randint(-32768, 32768, size=length)
                           .astype(np.int16)),
        "real_multiply": (f, r.rand(length).astype(np.float32)),
    }[name]


@pytest.mark.parametrize("length", [1, 3, 8, 509, 4096])
@pytest.mark.parametrize("name", [
    "int16_to_float", "float_to_int16", "int32_to_float",
    "float_to_int32", "int16_to_int32", "int32_to_int16",
    "int16_multiply", "real_multiply"])
def test_elementwise_exact(name, length):
    args = _inputs(name, length, np.random.RandomState(RNG_SEED + length))
    got, want = _both(name, *args)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(getattr(tar, name)(*args, simd=False),
                                  getattr(jar, name)(*args, simd=False))


def test_float_to_int16_truncates_and_saturates():
    vals = np.array([1.9, -1.9, 0.5, -0.5, 32767.9, -32768.9, 1e9, -1e9,
                     40000.0, -40000.0, np.nan], np.float32)
    got, want = _both("float_to_int16", vals)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, [1, -1, 0, 0, 32767, -32768, 32767, -32768, 32767, -32768,
              0])


def test_float_to_int32_saturates_and_maps_nan_to_zero():
    """A clamp to 2**31 - 1 rounds to 2**31 in float32
    and the cast then overflows; the port saturates explicitly and
    maps NaN to 0, as the JAX package's device path (XLA's convert)
    does."""
    vals = np.array([3e9, -3e9, np.nan], np.float32)
    got, want = _both("float_to_int32", vals)
    np.testing.assert_array_equal(got, [2147483647, -2147483648, 0])
    np.testing.assert_array_equal(got, want)
    edge = np.array([2147483520.0, 2.0 ** 31, -2.0 ** 31, np.inf,
                     -np.inf, 0.9, -0.9, -0.0], np.float32)
    got, want = _both("float_to_int32", edge)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, [2147483520, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 1, -2 ** 31,
              0, 0, 0])


def test_float_to_int32_oracle_copies_the_jax_oracle():
    """The JAX package's own ``_na`` maps NaN to -2**31 (NumPy's cast),
    unlike its device path; the port's ``_na`` is that oracle as it
    is."""
    vals = np.array([3e9, -3e9, np.nan, 7.5], np.float32)
    with np.errstate(invalid="ignore"):
        got = tar.float_to_int32(vals, simd=False)
        want = jar.float_to_int32(vals, simd=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [2147483647, -2147483648,
                                        -2147483648, 7])


def test_int32_to_int16_saturates():
    vals = np.array([2 ** 20, -(2 ** 20), 32768, -32769, 5], np.int32)
    got, want = _both("int32_to_int16", vals)
    np.testing.assert_array_equal(got, [32767, -32768, 32767, -32768, 5])
    np.testing.assert_array_equal(got, want)


def test_int16_multiply_widens():
    big = np.array([-32768], np.int16)
    got, want = _both("int16_multiply", big, big)
    assert got.dtype == np.int32 and got[0] == 2 ** 30 == want[0]


@pytest.mark.parametrize("bits,expected", [
    ([0x3C00, 0xC000, 0x4248], [1.0, -2.0, 3.140625]),
    ([0x0001, 0x03FF, 0x8001],
     [2.0 ** -24, (1023 / 1024) * 2.0 ** -14, -(2.0 ** -24)]),
    ([0x7C00, 0xFC00], [np.inf, -np.inf]),
    ([0x0000, 0x8000], [0.0, -0.0]),
], ids=["normals", "subnormals", "inf", "signed_zero"])
def test_float16_golden(bits, expected):
    """Golden binary16 values of ``tests/test_arithmetic.py:73-113``."""
    bits = np.asarray(bits, np.uint16)
    got, want = _both("float16_to_float", bits)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(expected, np.float32))
    np.testing.assert_array_equal(np.signbit(got),
                                  np.signbit(np.asarray(expected)))
    np.testing.assert_array_equal(tar.float16_to_float(bits, simd=False),
                                  want)


def test_float16_nan_and_random_bits():
    nan = tar.float16_to_float(np.array([0x7E00, 0xFE01], np.uint16))
    assert torch.isnan(nan).all()
    bits = np.random.RandomState(RNG_SEED).randint(
        0, 0x10000, size=4096).astype(np.uint16)
    got, want = _both("float16_to_float", bits)
    np.testing.assert_array_equal(got, want)


def test_float16_accepts_float16_input():
    x = np.array([1.5, -0.25, 65504.0], np.float16)
    np.testing.assert_array_equal(tar.float16_to_float(x).numpy(),
                                  [1.5, -0.25, 65504.0])
    t = torch.tensor([1.5, -0.25], dtype=torch.float16)
    np.testing.assert_array_equal(tar.float16_to_float(t).numpy(),
                                  [1.5, -0.25])
    as_int16 = torch.from_numpy(np.array([0x3C00], np.uint16)
                                .view(np.int16))
    assert tar.float16_to_float(as_int16).item() == 1.0


@pytest.mark.parametrize("n_complex", [1, 4, 256])
@pytest.mark.parametrize("name", ["complex_multiply",
                                  "complex_multiply_conjugate"])
def test_complex_multiplies(name, n_complex):
    r = np.random.RandomState(RNG_SEED + n_complex)
    a = r.randn(2 * n_complex).astype(np.float32)
    b = r.randn(2 * n_complex).astype(np.float32)
    got, want = _both(name, a, b)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    za, zb = tar.deinterleave_complex(a), tar.deinterleave_complex(b)
    if name.endswith("conjugate"):
        zb = np.conj(zb)
    np.testing.assert_allclose(got, tar.interleave_complex(za * zb),
                               rtol=1e-5, atol=1e-5)


def test_complex_conjugate_and_batched_layouts():
    a = np.random.RandomState(RNG_SEED).randn(3, 64).astype(np.float32)
    got, want = _both("complex_conjugate", a)
    np.testing.assert_array_equal(got, want)
    got, want = _both("complex_multiply", a, a[::-1].copy())
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["complex_multiply",
                                  "complex_multiply_conjugate",
                                  "complex_conjugate"])
def test_interleaved_contract(name):
    odd = np.ones(5, np.float32)
    args = (odd,) if name == "complex_conjugate" else (odd, odd)
    with pytest.raises(ValueError) as jerr:
        getattr(jar, name)(*args)
    with pytest.raises(ValueError) as terr:
        getattr(tar, name)(*args)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("shape", [(1,), (7,), (4096,), (5, 333)])
def test_sum_elements(shape):
    data = np.random.RandomState(RNG_SEED).rand(*shape).astype(np.float32)
    got, want = _both("sum_elements", data)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(tar.sum_elements(data, simd=False),
                                  jar.sum_elements(data, simd=False))


@pytest.mark.parametrize("name,value", [("add_to_all", 3.25),
                                        ("real_multiply_scalar", 2.5)])
def test_scalar_ops(name, value):
    data = np.random.RandomState(RNG_SEED).rand(100).astype(np.float32)
    got, want = _both(name, data, value)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(getattr(tar, name)(data, value,
                                                     simd=False),
                                  getattr(jar, name)(data, value,
                                                     simd=False))


def test_real_multiply_array_alias():
    assert tar.real_multiply_array is tar.real_multiply


def test_interleave_round_trip_numpy_and_torch():
    r = np.random.RandomState(RNG_SEED)
    z = (r.randn(32) + 1j * r.randn(32)).astype(np.complex64)
    inter = tar.interleave_complex(z)
    np.testing.assert_array_equal(inter, jar.interleave_complex(z))
    np.testing.assert_array_equal(tar.deinterleave_complex(inter), z)
    zt = torch.from_numpy(z)
    it = tar.interleave_complex(zt)
    np.testing.assert_array_equal(it.numpy(), inter)
    np.testing.assert_array_equal(tar.deinterleave_complex(it).numpy(), z)


def test_64_bit_numpy_input_computes_in_32_bits():
    """``jnp.asarray`` narrows float64 and int64 (x64 off); so does the
    port."""
    f64 = np.array([1.5, -2.25, 3e9])
    got, want = _both("float_to_int32", f64)
    np.testing.assert_array_equal(got, want)
    got, want = _both("add_to_all", f64, 1.0)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    got, want = _both("int16_to_float", np.array([3, -4], np.int64))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,a,b", [
    ("real_multiply", np.ones(3, np.float32), np.ones(4, np.float32)),
    ("real_multiply_array", np.ones((2, 3), np.float32),
     np.ones((3, 2), np.float32)),
    ("int16_multiply", np.ones(3, np.int16), np.ones(4, np.int16)),
    ("complex_multiply", np.ones(4, np.float32), np.ones(6, np.float32)),
    ("complex_multiply_conjugate", np.ones((2, 4), np.float32),
     np.ones((3, 4), np.float32)),
])
def test_mismatched_shapes_raise_the_jax_class(name, a, b):
    # F14: TypeError on the device path of both packages (torch alone
    # would raise RuntimeError), NumPy's ValueError on both oracle paths
    with pytest.raises(TypeError) as want:
        getattr(jar, name)(a, b, simd=True)
    with pytest.raises(TypeError) as got:
        getattr(tar, name)(a, b, simd=True)
    assert str(got.value) == str(want.value)
    for mod in (jar, tar):
        with pytest.raises(ValueError):
            getattr(mod, name)(a, b, simd=False)


def test_interleaved_halves_broadcast_as_in_jax():
    # one complex value against two broadcasts, as its halves do
    a = np.array([1.0, 2.0], np.float32)
    b = np.arange(4, dtype=np.float32)
    got, want = _both("complex_multiply", a, b)
    np.testing.assert_array_equal(got, want)
