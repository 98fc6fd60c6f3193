"""The port's convolve2d against the JAX package.

The same NumPy inputs, made from a seed, go through
``veles.simd_tpu.ops.convolve2d`` (on the CPU platform the root
conftest pins) and ``veles.simd_tpu_torch.ops.convolve2d`` with
``device="cpu"``, with each package's route forced both ways: the JAX
side's direct route is its Pallas 2D kernel in interpret mode (gate
monkeypatched open, as ``tests/test_pallas.py`` does) or its fft route;
the port's direct route is the 2D kernel's plain version on a CPU
tensor (gate monkeypatched open) or its fft route.  Both sides are
float32 with different summation orders, so outputs agree to 1e-5 of
max|y|; the NumPy oracles agree exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import convolve2d as j2
from veles.simd_tpu.ops import pallas_kernels as jpk
from veles.simd_tpu_torch.ops import convolve2d as t2
from veles.simd_tpu_torch.ops import cuda_kernels as tck
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

REL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


def _np(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _inputs(seed, x_shape=(2, 3, 19, 23), k_shape=(4, 5)):
    r = np.random.RandomState(seed)
    return (r.randn(*x_shape).astype(np.float32),
            r.randn(*k_shape).astype(np.float32))


@pytest.mark.parametrize("boundary", ["fill", "wrap", "symm"])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("op", ["convolve2d", "cross_correlate2d"])
def test_modes_and_boundaries_agree(monkeypatch, op, mode, boundary):
    monkeypatch.setattr(j2, "_use_pallas_direct2d", lambda *a: True)
    monkeypatch.setattr(t2, "_use_cuda_direct2d", lambda *a: True)
    x, h = _inputs(len(op) + len(mode) + len(boundary))
    fill = 0.75 if boundary == "fill" else 0.0
    kw = dict(mode=mode, boundary=boundary, fillvalue=fill)
    want = getattr(j2, op)(x, h, "fft", simd=True, **kw)
    for algo in (None, "direct", "fft"):
        got = getattr(t2, op)(x, h, algo, **kw)
        assert isinstance(got, torch.Tensor)
        assert got.dtype == torch.float32
        assert _rel(got, want) < REL_TOL, algo
    # the JAX package's Pallas route, interpret mode
    want = getattr(j2, op)(x, h, "direct", simd=True, **kw)
    assert _rel(getattr(t2, op)(x, h, "direct", **kw), want) < REL_TOL


@pytest.mark.parametrize("k_shape", [(3, 3), (1, 9), (9, 1), (6, 2),
                                     (16, 16), (2, 7)])
def test_kernel_route_agrees_with_pallas(monkeypatch, k_shape):
    monkeypatch.setattr(j2, "_use_pallas_direct2d", lambda *a: True)
    monkeypatch.setattr(t2, "_use_cuda_direct2d", lambda *a: True)
    x, h = _inputs(sum(k_shape), (3, 16, 20), k_shape)
    for op in ("convolve2d", "cross_correlate2d"):
        got = getattr(t2, op)(x, h, "direct")
        want = getattr(j2, op)(x, h, "direct", simd=True)
        assert _rel(got, want) < REL_TOL
        np.testing.assert_allclose(_np(got), getattr(j2, op + "_na")(x, h),
                                   atol=1e-3)


def test_unforced_cpu_routes():
    # off the card the kernel gate is closed: auto runs fft, an
    # explicit 'direct' runs conv2d
    x, h = _inputs(5)
    tck.reset_launches()
    for algo in (None, "direct"):
        assert _rel(t2.convolve2d(x, h, algo), j2.convolve2d_na(x, h)) \
            < REL_TOL
    assert tck.LAUNCHES["filter_2d"] == 0


def test_valid_swaps_operands_like_scipy():
    r = np.random.RandomState(7)
    x = r.randn(3, 4).astype(np.float32)
    h = r.randn(6, 7).astype(np.float32)
    for op in ("convolve2d", "cross_correlate2d"):
        got = getattr(t2, op)(x, h, mode="valid")
        want = getattr(j2, op)(x, h, simd=True, mode="valid")
        assert got.shape == (4, 4)
        assert _rel(got, want) < REL_TOL


def test_oracles_identical():
    x, h = _inputs(11)
    for op in ("convolve2d", "cross_correlate2d"):
        for mode, boundary in (("full", "fill"), ("same", "symm"),
                               ("valid", "wrap")):
            got = getattr(t2, op)(x, h, simd=False, mode=mode,
                                  boundary=boundary)
            assert isinstance(got, np.ndarray)
            np.testing.assert_array_equal(
                got, getattr(j2, op)(x, h, simd=False, mode=mode,
                                     boundary=boundary))
    np.testing.assert_array_equal(t2.convolve2d_na(x, h),
                                  j2.convolve2d_na(x, h))
    np.testing.assert_array_equal(t2.cross_correlate2d_na(x, h),
                                  j2.cross_correlate2d_na(x, h))


@pytest.mark.parametrize("k0,k1", [(3, 3), (16, 16), (17, 16), (1, 256),
                                   (256, 1), (1, 257), (40, 40)])
def test_select_algorithm2d(monkeypatch, k0, k1):
    # on the CPU both packages answer fft
    assert t2.select_algorithm2d(k0, k1) == j2.select_algorithm2d(k0, k1)
    assert t2.select_algorithm2d(k0, k1, (4, 64, 64)) == "fft"
    # with the device terms open the area rule is the same
    monkeypatch.setattr(jpk, "pallas_available", lambda: True)
    want = j2.select_algorithm2d(k0, k1, (2, 32, 32))
    got = ("direct" if t2._CONV2D_FAMILY.gate("direct", k0=k0, k1=k1,
                                               cuda=True) else "fft")
    assert got == want


def test_every_admitted_kernel_fits_shared_memory():
    for k0 in range(1, tck.MAX_AREA_2D + 1):
        for k1 in range(1, tck.MAX_AREA_2D // k0 + 1):
            assert tck.fits_smem_f2d(k0, k1), (k0, k1)


def test_disable_env_closes_the_kernel_route(monkeypatch):
    assert t2._CONV2D_FAMILY.gate("direct", k0=7, k1=7, cuda=True)
    monkeypatch.setenv("VELES_SIMD_DISABLE_CUDA2D", "1")
    assert not t2._CONV2D_FAMILY.gate("direct", k0=7, k1=7, cuda=True)


@pytest.mark.parametrize("call,match", [
    (lambda m: m.convolve2d(np.ones(5, np.float32),
                            np.ones((2, 2), np.float32)), "need x"),
    (lambda m: m.convolve2d(np.ones((5, 5), np.float32),
                            np.ones(3, np.float32)), "need x"),
    (lambda m: m.convolve2d(np.ones((5, 5), np.float32),
                            np.ones((2, 2), np.float32), "nope"),
     "algorithm"),
    (lambda m: m.convolve2d(np.ones((5, 5), np.float32),
                            np.ones((2, 2), np.float32), mode="middle"),
     "mode"),
    (lambda m: m.convolve2d(np.ones((5, 5), np.float32),
                            np.ones((2, 2), np.float32), boundary="edge"),
     "boundary"),
    (lambda m: m.convolve2d(np.ones((5, 3), np.float32),
                            np.ones((3, 5), np.float32), mode="valid"),
     "at least as large"),
    (lambda m: m.convolve2d(np.ones((2, 3, 4), np.float32),
                            np.ones((5, 6), np.float32), mode="valid"),
     "unbatched"),
])
@pytest.mark.parametrize("side", ["jax", "torch"])
def test_contract_errors_match(call, match, side):
    with pytest.raises(ValueError, match=match):
        call(j2 if side == "jax" else t2)


def test_tensor_inputs_keep_their_device_and_dtype():
    x, h = _inputs(13)
    y = t2.convolve2d(torch.from_numpy(x).double(), h)
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    assert _rel(y, j2.convolve2d_na(x, h)) < REL_TOL
