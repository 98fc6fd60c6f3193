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

from veles.simd_tpu_torch.ops import batched as bt
from veles.simd_tpu_torch.ops import convolve as cv
from veles.simd_tpu_torch.ops import convolve2d as cv2
from veles.simd_tpu_torch.ops import correlate as cr
from veles.simd_tpu_torch.ops import cuda_kernels as ck
from veles.simd_tpu_torch.ops import spectral as sp
from veles.simd_tpu_torch.ops import wavelet as wv
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


def _conv2d64(x, h):
    m = (x.shape[-2] + h.shape[0] - 1, x.shape[-1] + h.shape[1] - 1)
    spec = (np.fft.rfft2(x.astype(np.float64), m)
            * np.fft.rfft2(h.astype(np.float64), m))
    return np.fft.irfft2(spec, m)


@pytest.mark.parametrize("type,order,levels,n,rows", [
    ("daub", 8, 3, 4096, 64), ("daub", 4, 4, 1024, 8),
    ("coif", 12, 2, 512, 8), ("daub", 8, 3, 1000, 37),
    ("sym", 16, 3, 2048, 3), ("daub", 2, 2, 4, 70000),
])
def test_cascade_bank_kernel_matches_plain_and_float64(type, order, levels,
                                                       n, rows):
    plans, taps, _, reach = wv._cascade_plan_for(wv.WaveletType(type),
                                                 order, levels)
    ns = 1 << levels
    r = np.random.RandomState(order + levels + rows)
    x = r.randn(rows, n).astype(np.float32)
    x_ext = np.concatenate([x, np.take(x, np.arange(reach + ns) % n, -1)],
                           -1)
    n_out = n // ns
    got = ck.cascade_bank_cuda(_t(x_ext), taps, plans, ns, n_out)
    want = ck.cascade_bank_plain(_t(x_ext), taps, plans, ns, n_out)
    x64 = x_ext.astype(np.float64)
    for g, w, plan, t in zip(got, want, plans, taps):
        assert _rel(g.cpu(), w.cpu()) <= TOL
        ref = sum(float(tap) * x64[:, o * ns + p:o * ns + p
                                   + (n_out - 1) * ns + 1:ns]
                  for (p, o), tap in zip(plan, t))
        assert _rel(g.cpu(), ref) <= TOL


@pytest.mark.parametrize("imgs,n0,n1,k0,k1", [
    (16, 64, 64, 7, 7), (1, 128, 128, 3, 3), (4, 100, 77, 16, 16),
    (3, 64, 300, 1, 256), (2, 300, 20, 256, 1), (5, 5, 3, 5, 3),
    (70000, 2, 3, 2, 2),
])
def test_filter_2d_kernel_matches_plain_and_float64(imgs, n0, n1, k0, k1):
    r = np.random.RandomState(n0 + n1 + k0 * k1)
    x = r.randn(imgs, n0 + 2 * (k0 - 1), n1 + 2 * (k1 - 1))
    k = r.randn(k0, k1)
    shape = (n0 + k0 - 1, n1 + k1 - 1)
    got = ck.filter_2d_cuda(_t(x), _t(k), *shape)
    want = ck.filter_2d_plain(_t(x), _t(k), *shape)
    assert _rel(got.cpu(), want.cpu()) <= TOL
    x32, k32 = x.astype(np.float32), k.astype(np.float32)
    ref = _conv2d64(x32, k32[::-1, ::-1])[..., k0 - 1:k0 - 1 + shape[0],
                                          k1 - 1:k1 - 1 + shape[1]]
    assert _rel(got.cpu(), ref) <= TOL


def test_filter_2d_kernel_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        ck.filter_2d_cuda(_t(np.zeros((2100, 8))), _t(np.ones((2048, 1))),
                          53, 8)


def test_wavelet_routes_launch_the_filter_bank():
    r = np.random.RandomState(6)
    P = wv.ExtensionType.PERIODIC
    for rows, launches in ((8, 1), (4, 0)):
        x = r.randn(rows, 1024).astype(np.float32)
        ck.reset_launches()
        hi, lo = wv.wavelet_apply("daub", 8, P, x)
        assert ck.LAUNCHES["filter_bank"] == launches
        want = wv.wavelet_apply_na("daub", 8, P, x)
        assert _rel(hi.cpu(), want[0]) <= TOL
        assert _rel(lo.cpu(), want[1]) <= TOL
        rec = wv.wavelet_reconstruct("daub", 8, hi, lo)
        assert np.max(np.abs(rec.cpu().numpy() - x)) <= 2e-4
    # non-periodic inverses: the boundary correction runs on the card
    M = wv.ExtensionType.MIRROR
    hi, lo = wv.wavelet_apply_na("daub", 8, M, x)
    rec = wv.wavelet_reconstruct("daub", 8, hi, lo, ext=M)
    want = wv.wavelet_reconstruct_na("daub", 8, hi, lo, ext=M)
    assert np.max(np.abs(rec.cpu().numpy() - want)) <= 5e-5
    hi, lo = wv.stationary_wavelet_apply_na("daub", 8, 2, M, x)
    rec = wv.stationary_wavelet_reconstruct("daub", 8, 2, hi, lo, ext=M)
    want = wv.stationary_wavelet_reconstruct_na("daub", 8, 2, hi, lo, ext=M)
    assert np.max(np.abs(rec.cpu().numpy() - want)) <= 5e-5
    # a deep SWT level's span does not fit shared memory: conv1d (the
    # length is no divisor of the dilation, so the taps hit distinct
    # samples)
    x = r.randn(8, 1000).astype(np.float32)
    ck.reset_launches()
    shi, slo = wv.stationary_wavelet_apply("daub", 16, 14, P, x)
    assert ck.LAUNCHES["filter_bank"] == 0
    want = wv.stationary_wavelet_apply_na("daub", 16, 14, P, x)
    assert _rel(shi.cpu(), want[0]) <= TOL
    assert _rel(slo.cpu(), want[1]) <= TOL


def test_fused_cascade_launches_the_cascade_bank(monkeypatch):
    r = np.random.RandomState(7)
    x = r.randn(64, 4096).astype(np.float32)
    P = wv.ExtensionType.PERIODIC
    ck.reset_launches()
    loop = wv.wavelet_transform("daub", 8, P, x, 3)
    assert ck.LAUNCHES["filter_bank"] == 3
    assert ck.LAUNCHES["cascade_bank"] == 0
    monkeypatch.setenv("VELES_SIMD_FORCE_FUSED_CASCADE", "1")
    ck.reset_launches()
    fused = wv.wavelet_transform("daub", 8, P, x, 3)
    assert ck.LAUNCHES["cascade_bank"] == 1
    assert ck.LAUNCHES["filter_bank"] == 0
    for f, g in zip(fused, loop):
        assert f.shape == g.shape
        assert _rel(f.cpu(), g.cpu()) <= 5e-5


def test_convolve2d_routes():
    r = np.random.RandomState(8)
    x = r.randn(3, 200, 150).astype(np.float32)
    for k, launches in (((7, 7), 1), ((1, 256), 1), ((17, 17), 0)):
        h = r.randn(*k).astype(np.float32)
        ck.reset_launches()
        y = cv2.convolve2d(x, h)
        assert ck.LAUNCHES["filter_2d"] == launches
        assert _rel(y.cpu(), _conv2d64(x, h)) <= TOL
        # an explicit direct form the kernel refuses is cuDNN in fp32
        y = cv2.convolve2d(x, h, algorithm="direct")
        assert _rel(y.cpu(), _conv2d64(x, h)) <= TOL
    h = r.randn(5, 5).astype(np.float32)
    yc = cv2.cross_correlate2d(x, h, mode="valid")
    want = _conv2d64(x, h[::-1, ::-1])[:, 4:200, 4:150]
    assert _rel(yc.cpu(), want) <= TOL


def test_convolve2d_kernel_route_opt_out(monkeypatch):
    r = np.random.RandomState(9)
    x, h = r.randn(2, 64, 64), r.randn(3, 3)
    monkeypatch.setenv("VELES_SIMD_DISABLE_CUDA2D", "1")
    ck.reset_launches()
    y = cv2.convolve2d(x, h)
    assert ck.LAUNCHES["filter_2d"] == 0
    want = _conv2d64(x.astype(np.float32), h.astype(np.float32))
    assert _rel(y.cpu(), want) <= TOL


def _crel(got, want):
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _stft64(x, L, hop):
    return sp.stft_na(x.astype(np.float64), L, hop)


@pytest.mark.parametrize("rows,n,L,hop", [
    (1, 1 << 18, 512, 128), (64, 16384, 512, 128), (3, 5000, 256, 128),
    (2, 8192, 1024, 128), (4, 4096, 384, 128), (2, 700, 512, 128),
    (3, 2000, 255, 85), (70000, 600, 512, 128),
])
def test_stft_kernel_matches_plain_and_float64(rows, n, L, hop):
    r = np.random.RandomState(rows + L)
    x = r.randn(rows, n).astype(np.float32)
    basis = _t(ck.stft_basis(L, sp.hann_window(L)))
    ck.reset_launches()
    got = ck.stft_cuda(_t(x), basis, L, hop)
    # one launch per 65535 rows (the grid's z limit)
    assert ck.LAUNCHES["stft"] == -(-rows // 65535)
    want = ck.stft_plain(_t(x), basis, L, hop)
    torch.cuda.synchronize()
    assert got.shape == (rows, 1 + (n - L) // hop, L // 2 + 1)
    assert _rel(torch.view_as_real(got).cpu(),
                torch.view_as_real(want).cpu()) <= TOL
    if rows * n <= 1 << 20:
        ref = _stft64(x, L, hop)
        assert np.max(np.abs(got.cpu().numpy() - ref)) <= \
            TOL * np.max(np.abs(ref))


def test_stft_routes_launch_the_kernel(monkeypatch):
    r = np.random.RandomState(10)
    x = r.randn(4, 16384).astype(np.float32)
    ref = _stft64(x, 512, 128)
    scale = np.max(np.abs(ref))
    for call, launches in (
            (lambda: sp.stft(x, 512, 128), 1),
            (lambda: bt.batched_stft(x, 512, 128), 1),
            (lambda: sp.stft(x, 512, 128, route="rdft_matmul"), 0),
            (lambda: sp.stft(x, 512, 128, route="xla_fft"), 0)):
        ck.reset_launches()
        y = call()
        assert ck.LAUNCHES["stft"] == launches
        assert y.device.type == "cuda"
        assert np.max(np.abs(y.cpu().numpy() - ref)) <= TOL * scale
    # hop 64 is no 128-lane multiple: the basis matmul
    ck.reset_launches()
    y = sp.stft(x, 512, 64)
    assert ck.LAUNCHES["stft"] == 0
    ref64 = _stft64(x, 512, 64)
    assert np.max(np.abs(y.cpu().numpy() - ref64)) <= \
        TOL * np.max(np.abs(ref64))
    s = sp.spectrogram(x, 512, 128)
    assert _rel(s.cpu(), np.abs(ref) ** 2) <= TOL
    rec = sp.istft(sp.stft(x, 512, 128), 16384, 512, 128)
    assert np.max(np.abs(rec.cpu().numpy() - x)[:, 512:-512]) <= 1e-4
    monkeypatch.setenv("VELES_SIMD_DISABLE_STFT_CUDA", "1")
    ck.reset_launches()
    sp.stft(x, 512, 128)
    assert ck.LAUNCHES["stft"] == 0


def test_analytic_and_psd_routes_on_the_card():
    r = np.random.RandomState(11)
    for n in (1024, 65536):
        x = r.randn(2, n).astype(np.float32)
        assert _crel(sp.hilbert(x).cpu(), sp.hilbert_na(x)) <= TOL
    x = r.randn(3, 4096).astype(np.float32)
    scales = np.geomspace(2.0, 256.0, 8)
    want = sp.morlet_cwt_na(x, scales)
    for route in ("ct_matmul", "xla_fft"):
        got = sp.morlet_cwt(x, scales, route=route)
        assert _crel(got.cpu(), want) <= 1e-4
    f, p = sp.welch(x, nperseg=512)
    assert _rel(p.cpu(), sp.welch_na(x, nperseg=512)[1]) <= TOL
    assert _crel(sp.czt(x[0]).cpu(),
                 np.fft.fft(x[0].astype(np.float64))) <= 1e-4
