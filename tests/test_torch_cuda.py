"""The port on an NVIDIA card: kernels against their plain versions at
edge shapes, and the routes that reach them.

Every test here needs a CUDA card and skips without one.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from veles.simd_tpu_torch.ops import convolve as cv
from veles.simd_tpu_torch.ops import correlate as cr
from veles.simd_tpu_torch.ops import cuda_kernels as ck
from veles.simd_tpu_torch.utils import config

pytestmark = pytest.mark.cuda

TOL = 1e-5      # fp32 against fp32 or float64, relative to max|y|


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available())")
    prev = config.get_config()
    config.set_config(device="cuda")
    yield
    config.set_config(**dataclasses.asdict(prev))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _conv64(x, h):
    n, k = x.shape[-1], h.shape[-1]
    m = 1 << (n + k - 2).bit_length()
    spec = (np.fft.rfft(x.astype(np.float64), m, axis=-1)
            * np.fft.rfft(h.astype(np.float64), m))
    return np.fft.irfft(spec, m, axis=-1)[..., : n + k - 1]


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32), device="cuda")


@pytest.mark.parametrize("shape", [(1,), (5,), (1663,), (1665,),
                                   (2, 3, 5000)])
@pytest.mark.parametrize("k", [2, 3, 259, 260, 261, 3000])
def test_overlap_save_kernel_matches_plain(shape, k):
    r = np.random.RandomState(k + shape[-1])
    x, t = _t(r.randn(*shape)), _t(r.randn(k))
    got = ck.overlap_save_cuda(x, t)
    want = ck.overlap_save_plain(x, t)
    torch.cuda.synchronize()
    assert _rel(got.cpu(), want.cpu()) <= TOL


def test_overlap_save_kernel_many_rows():
    # more rows than one launch's grid.y (65535)
    r = np.random.RandomState(1)
    x, t = _t(r.randn(70000, 8)), _t(r.randn(3))
    got = ck.overlap_save_cuda(x, t)
    assert _rel(got.cpu(), ck.overlap_save_plain(x, t).cpu()) <= TOL


@pytest.mark.parametrize("channels,order,stride,dilation", [
    (1, 1, 1, 1), (1, 13, 1, 1), (1, 14, 1, 1), (1, 256, 1, 1),
    (2, 8, 2, 1), (3, 5, 3, 1), (2, 8, 1, 4), (2, 7, 2, 3),
    (2, 64, 1, 200),      # > 48 KB of shared memory: the opt-in path
])
def test_filter_bank_kernel_matches_plain(channels, order, stride,
                                          dilation):
    r = np.random.RandomState(order * stride + dilation)
    n_out = 3001
    need = (n_out - 1) * stride + (order - 1) * dilation + 1
    x = _t(r.randn(5, need + 2))
    f = _t(r.randn(channels, order))
    got = ck.filter_bank_cuda(x, f, stride, dilation, n_out)
    want = ck.filter_bank_plain(x, f, stride, dilation, n_out)
    for g, w in zip(got, want):
        assert _rel(g.cpu(), w.cpu()) <= TOL


def test_filter_bank_kernel_many_rows_and_refusal():
    r = np.random.RandomState(2)
    x, f = _t(r.randn(70000, 20)), _t(r.randn(2, 5))
    got = ck.filter_bank_cuda(x, f, 1, 1, 16)
    want = ck.filter_bank_plain(x, f, 1, 1, 16)
    for g, w in zip(got, want):
        assert _rel(g.cpu(), w.cpu()) <= TOL
    big = _t(np.zeros((1, 70000)))
    with pytest.raises(ValueError, match="shared memory"):
        ck.filter_bank_cuda(big, _t(np.ones((2, 64))), 1, 1024, 100)


def test_overlap_save_route_launches_the_kernel(monkeypatch):
    r = np.random.RandomState(3)
    x, h = r.randn(2, 100000).astype(np.float32), r.randn(300)
    for reverse in (False, True):
        ck.reset_launches()
        hd = cv.convolve_initialize(100000, 300, reverse=reverse)
        y = cv.convolve(hd, x, h)
        assert ck.LAUNCHES["overlap_save"] == 1
        want = _conv64(x, h[::-1] if reverse else h)
        assert y.device.type == "cuda" and _rel(y.cpu(), want) <= TOL
    ck.reset_launches()
    y = cv.convolve(x, h[:100])                 # below 256 taps: matmul
    assert ck.LAUNCHES["overlap_save"] == 0
    assert _rel(y.cpu(), _conv64(x, h[:100])) <= TOL   # fp32, no TF32
    monkeypatch.setenv("VELES_SIMD_DISABLE_CUDA_OS", "1")
    y = cv.convolve(x, h)
    assert ck.LAUNCHES["overlap_save"] == 0
    assert _rel(y.cpu(), _conv64(x, h)) <= TOL


def test_direct_routes():
    r = np.random.RandomState(4)
    h = r.randn(65).astype(np.float32)
    for rows, launches in ((8, 1), (4, 0)):
        x = r.randn(rows, 3000).astype(np.float32)
        ck.reset_launches()
        y = cv.convolve_simd(x, h)
        assert ck.LAUNCHES["filter_bank"] == launches
        # the conv1d route (4 rows) must be fp32 too: cuDNN TF32 is off
        assert _rel(y.cpu(), _conv64(x, h)) <= TOL
        yc = cr.cross_correlate_simd(x, h)
        assert _rel(yc.cpu(), _conv64(x, h[::-1].copy())) <= TOL


def test_fft_routes_and_streaming_on_the_card():
    r = np.random.RandomState(5)
    x, h = r.randn(3, 20000).astype(np.float32), r.randn(20000 // 4)
    for algo in ("fft", "overlap_save"):
        hd = cv.convolve_initialize(20000, 5000, algo)
        assert _rel(cv.convolve(hd, x, h).cpu(), _conv64(x, h)) <= TOL
    sc = cv.StreamingConvolution(h[:300], 4096)
    ys = [sc.process(x[0, i:i + 4096]) for i in range(0, 16384, 4096)]
    assert isinstance(sc.carry(), np.ndarray)
    ys.append(sc.flush())
    got = torch.cat(ys).cpu()
    assert _rel(got, _conv64(x[0, :16384], h[:300])) <= TOL
