"""The port on an NVIDIA card: kernels against their plain versions at
edge shapes, and the routes that reach them.

Every test here needs a CUDA card and skips without one.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from veles.simd_tpu_torch.ops import batched as bt
from veles.simd_tpu_torch.ops import convolve as cv
from veles.simd_tpu_torch.ops import convolve2d as cv2
from veles.simd_tpu_torch.ops import correlate as cr
from veles.simd_tpu_torch.ops import cuda_kernels as ck
from veles.simd_tpu_torch.ops import iir
from veles.simd_tpu_torch.ops import resample as rs
from veles.simd_tpu_torch.ops import spectral as sp
from veles.simd_tpu_torch.ops import wavelet as wv
from veles.simd_tpu_torch.utils import benchmark as bm
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
    # the plain version in float64 (a float32 sum of k terms drifts)
    want = ck.overlap_save_plain(x.double(), t.double())
    torch.cuda.synchronize()
    assert _rel(got.cpu(), want.cpu()) <= TOL


@pytest.mark.parametrize("k", [256, 2047, 16384])
def test_overlap_save_kernel_long_filters(k):
    # segments of 8192 to 32768 samples, three rows each restarting
    r = np.random.RandomState(k)
    x, t = _t(r.randn(3, 50000)), _t(r.randn(k))
    ck.reset_launches()
    got = ck.overlap_save_cuda(x, t)
    # the taps' spectrum, then one launch of segments
    assert ck.LAUNCHES["overlap_save"] == 2
    want = ck.overlap_save_plain(x.double(), t.double())
    torch.cuda.synchronize()
    assert _rel(got.cpu(), want.cpu()) <= TOL
    assert _rel(got[1].cpu(), _conv64(x[1].cpu().numpy(),
                                      t.cpu().numpy())) <= TOL


def test_kernels_refuse_what_they_do_not_admit():
    # no fallback on a card: the wrappers raise, the routes go elsewhere
    with pytest.raises(ValueError, match="2..16384 taps"):
        ck.overlap_save_cuda(_t(np.ones(40000)), _t(np.ones(16385)))
    with pytest.raises(ValueError, match="refuses"):
        ck.stft_cuda(_t(np.ones(40000)), _t(np.ones(32768)), 32768, 128)
    assert sp._STFT_FAMILY.select(frame_length=32768, hop=128, frames=500,
                                  cuda=True) == "xla_fft"


def test_overlap_save_kernel_many_rows():
    # more rows than one launch's grid.y (65535)
    r = np.random.RandomState(1)
    x, t = _t(r.randn(70000, 8)), _t(r.randn(3))
    got = ck.overlap_save_cuda(x, t)
    want = ck.overlap_save_plain(x.double(), t.double())
    assert _rel(got.cpu(), want.cpu()) <= TOL


@pytest.mark.parametrize("channels,order,stride,dilation", [
    (1, 1, 1, 1), (1, 2, 1, 1), (1, 3, 1, 1), (1, 8, 1, 1), (1, 13, 1, 1),
    (1, 14, 1, 1), (1, 16, 1, 1), (1, 33, 1, 1), (1, 129, 1, 1),
    (1, 255, 1, 1), (1, 256, 1, 1), (2, 8, 1, 1), (2, 40, 1, 1),
    (3, 5, 1, 1), (3, 100, 1, 1),
    (2, 8, 2, 1), (3, 5, 3, 1), (2, 8, 1, 4), (2, 7, 2, 3),
    (2, 64, 1, 200),      # > 48 KB of shared memory: the opt-in path
])
def test_filter_bank_kernel_matches_plain(channels, order, stride,
                                          dilation):
    # both variants at unit stride, against the plain version run in
    # float64 (the mma variant's split TF32 is not bit-equal to a
    # float32 sum); an explicit x_ext, then the padded entry on the
    # unpadded rows with the taps reversed
    r = np.random.RandomState(order * stride + dilation + channels)
    n_out = 3001
    need = (n_out - 1) * stride + (order - 1) * dilation + 1
    x = _t(r.randn(5, need + 2))
    f = _t(r.randn(channels, order))
    unit = stride == 1 and dilation == 1
    for variant in ((None, "ffma", "mma") if unit else (None,)):
        got = ck.filter_bank_cuda(x, f, stride, dilation, n_out,
                                  variant=variant)
        want = ck.filter_bank_plain(x.double(), f.double(), stride,
                                    dilation, n_out)
        for g, w in zip(got, want):
            assert _rel(g.cpu(), w.cpu()) <= TOL
    pad = (order - 1) * dilation
    xs = _t(r.randn(5, n_out))
    n_full = n_out + pad
    got = ck.filter_bank_cuda(xs, f, 1, dilation, n_full, pad_left=pad,
                              reverse_taps=True)
    want = ck.filter_bank_plain(xs.double(), f.double(), 1, dilation,
                                n_full, pad_left=pad, reverse_taps=True)
    for g, w in zip(got, want):
        assert _rel(g.cpu(), w.cpu()) <= TOL


@pytest.mark.parametrize("k", [1, 2, 3, 8, 16, 33, 129, 255, 256])
@pytest.mark.parametrize("rows,n", [(1, 1), (8, 1663), (512, 16384),
                                    (70000, 20)])
def test_filter_bank_padded_entry_matches_float64(rows, n, k):
    # the direct route's call: unpadded rows, pad_left = k - 1, the full
    # output; one launch for the mma variant whatever the row count
    r = np.random.RandomState(rows + n + k)
    x, f = _t(r.randn(rows, n)), _t(r.randn(1, k))
    ck.reset_launches()
    (got,) = ck.filter_bank_cuda(x, f, 1, 1, n + k - 1, pad_left=k - 1)
    variant = ck.fb_variant(k, 1, 1)
    assert ck.LAUNCHES["filter_bank"] == \
        (1 if variant == "mma" else -(-rows // 65535))
    (want,) = ck.filter_bank_plain(x.double(), f.double(), 1, 1,
                                   n + k - 1, pad_left=k - 1)
    assert _rel(got.cpu(), want.cpu()) <= TOL
    if rows <= 8:
        (ext,) = ck.filter_bank_cuda(
            torch.nn.functional.pad(x, (k - 1, k - 1)), f, 1, 1, n + k - 1)
        assert _rel(ext.cpu(), want.cpu()) <= TOL


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
        # the taps' spectrum and the segments
        assert ck.LAUNCHES["overlap_save"] == 2
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


def _plan64(x64, plan, taps, ns, n_out):
    """float64 sum of one channel's slots over an extended input."""
    return sum(float(tap) * x64[:, o * ns + p:o * ns + p
                                + (n_out - 1) * ns + 1:ns]
               for (p, o), tap in zip(plan, taps))


@pytest.mark.parametrize("type,order,levels,n,rows", [
    ("daub", 8, 3, 4096, 64), ("daub", 4, 4, 1024, 8),
    ("coif", 12, 2, 512, 8), ("daub", 8, 3, 1000, 37),
    ("sym", 16, 3, 2048, 3), ("daub", 2, 2, 4, 70000),
    ("daub", 8, 3, 4096, 1), ("daub", 16, 4, 2048, 5),
])
def test_cascade_bank_kernel_matches_plain_and_float64(type, order, levels,
                                                       n, rows):
    # both call forms, one launch each: the contract form on the
    # periodically extended input, the periodic form on the signal
    # itself (its wrap exceeds n in the daub2 case, reach + 4 = 7 > 4);
    # each against the plain version run in float64
    plans, taps, reach = wv._cascade_plan_for(wv.WaveletType(type),
                                                 order, levels)
    ns = 1 << levels
    r = np.random.RandomState(order + levels + rows)
    x = r.randn(rows, n).astype(np.float32)
    x_ext = np.concatenate([x, np.take(x, np.arange(reach + ns) % n, -1)],
                           -1)
    n_out = n // ns
    ck.reset_launches()
    got = ck.cascade_bank_cuda(_t(x_ext), taps, plans, ns, n_out)
    assert ck.LAUNCHES["cascade_bank"] == 1
    want = ck.cascade_bank_plain(_t(x_ext).double(), taps, plans, ns, n_out)
    x64 = x_ext.astype(np.float64)
    for g, w, plan, t in zip(got, want, plans, taps):
        assert _rel(g.cpu(), w.cpu()) <= TOL
        assert _rel(g.cpu(), _plan64(x64, plan, t, ns, n_out)) <= TOL
    ck.reset_launches()
    coeffs = ck.cascade_bank_periodic_cuda(_t(x), taps, plans, levels)
    assert ck.LAUNCHES["cascade_bank"] == 1
    want = ck.cascade_bank_periodic_plain(_t(x).double(), taps, plans,
                                          levels)
    assert len(coeffs) == levels + 1
    for lvl, (g, w) in enumerate(zip(coeffs, want), start=1):
        assert g.is_contiguous()
        assert g.shape == (rows, n >> min(lvl, levels))
        assert _rel(g.cpu(), w.cpu()) <= TOL


@pytest.mark.parametrize("n_split,channels,max_off,n_ext,rows", [
    (3, 5, 2, 1001, 7), (1, 2, 9, 333, 2), (2, 9, 4, 517, 70000),
    (5, 3, 1, 64, 1), (8, 20, 3, 2053, 4), (12, 4, 6, 999, 3),
    (16, 17, 0, 4096, 2), (32, 33, 2, 4131, 3), (4, 1, 679, 8192, 2),
])
def test_cascade_bank_contract_form_on_any_plan(n_split, channels, max_off,
                                                n_ext, rows):
    # random plans (repeated slots included) at every phase width, more
    # channels than a pass holds, odd rows and a view off 16-byte
    # alignment: 4-byte staging; against the plain version in float64
    r = np.random.RandomState(n_split * 100 + channels)
    plans, taps = [], []
    for _ in range(channels):
        k = r.randint(1, 12)
        plans.append(tuple((int(r.randint(n_split)),
                            int(r.randint(max_off + 1))) for _ in range(k)))
        taps.append(r.randn(k))
    plans[0] += ((n_split - 1, max_off),)
    taps[0] = np.append(taps[0], 0.5)
    n_out = (n_ext - n_split * (max_off + 1)) // n_split + 1
    # a contiguous view 4 bytes into its storage, and an aligned copy
    x = _t(r.randn(rows * n_ext + 1))[1:].view(rows, n_ext)
    for x_in in (x, x.clone()):
        ck.reset_launches()
        got = ck.cascade_bank_cuda(x_in, taps, plans, n_split, n_out)
        assert ck.LAUNCHES["cascade_bank"] == 1
        want = ck.cascade_bank_plain(x_in.double(), taps, plans, n_split,
                                     n_out)
        for g, w in zip(got, want):
            assert g.shape == (x_in.shape[0], n_out)
            assert _rel(g.cpu(), w.cpu()) <= TOL
    # taps as tensors on the card: the table is scattered there
    got2 = ck.cascade_bank_cuda(x_in, [_t(t) for t in taps], plans,
                                n_split, n_out)
    for g, w in zip(got2, want):
        assert _rel(g.cpu(), w.cpu()) <= TOL


def test_cascade_bank_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="shared memory"):
        ck.cascade_bank_cuda(_t(np.ones((2, 400))), [np.ones(1)],
                             (((0, 0),),), 33, 10)
    with pytest.raises(ValueError, match="shared memory"):
        ck.cascade_bank_cuda(_t(np.ones((2, 8000))), [np.ones(1)],
                             (((0, 680),),), 8, 10)
    plans, taps, _ = wv._cascade_plan_for(wv.WaveletType("daub"), 8, 3)
    with pytest.raises(ValueError, match="multiple of 8"):
        ck.cascade_bank_periodic_cuda(_t(np.ones((2, 100))), taps, plans, 3)
    with pytest.raises(ValueError, match="8 channels"):
        ck.cascade_bank_periodic_cuda(_t(np.ones((2, 64))), taps[1:],
                                      plans[1:], 3)


@pytest.mark.parametrize("imgs,n0,n1,k0,k1", [
    (16, 64, 64, 7, 7), (1, 128, 128, 3, 3), (4, 100, 77, 16, 16),
    (3, 64, 300, 1, 256), (2, 300, 20, 256, 1), (5, 5, 3, 5, 3),
    (70000, 2, 3, 2, 2), (16, 512, 512, 7, 7), (2, 65, 130, 4, 9),
])
def test_filter_2d_kernel_matches_plain_and_float64(imgs, n0, n1, k0, k1):
    # an explicit x_ext, then the padded entry on the unpadded images
    # with the taps flipped (the full convolution): each against the
    # plain version run in float64 and the float64 oracle; one launch
    r = np.random.RandomState(n0 + n1 + k0 * k1)
    x = r.randn(imgs, n0 + 2 * (k0 - 1), n1 + 2 * (k1 - 1))
    k = r.randn(k0, k1)
    shape = (n0 + k0 - 1, n1 + k1 - 1)
    ck.reset_launches()
    got = ck.filter_2d_cuda(_t(x), _t(k), *shape)
    assert ck.LAUNCHES["filter_2d"] == 1
    want = ck.filter_2d_plain(_t(x).double(), _t(k).double(), *shape)
    assert _rel(got.cpu(), want.cpu()) <= TOL
    x32, k32 = x.astype(np.float32), k.astype(np.float32)
    if imgs * x.shape[1] * x.shape[2] <= 1 << 20:
        ref = _conv2d64(x32, k32[::-1, ::-1])[
            ..., k0 - 1:k0 - 1 + shape[0], k1 - 1:k1 - 1 + shape[1]]
        assert _rel(got.cpu(), ref) <= TOL
    xs = _t(x[:, k0 - 1:k0 - 1 + n0, k1 - 1:k1 - 1 + n1])
    got = ck.filter_2d_cuda(xs, _t(k), *shape, pad=(k0 - 1, k1 - 1),
                            reverse_taps=True)
    want = ck.filter_2d_plain(xs.double(), _t(k).double(), *shape,
                              pad=(k0 - 1, k1 - 1), reverse_taps=True)
    assert _rel(got.cpu(), want.cpu()) <= TOL
    if imgs * n0 * n1 <= 1 << 20:
        assert _rel(got.cpu(), _conv2d64(xs.cpu().numpy(), k32)) <= TOL


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


def _dwt64(x, type, order, levels):
    """The periodic DWT's level loop in float64 NumPy on the program's
    float32 taps: ``[hi_1, ..., hi_L, lo_L]``."""
    hi_f, lo_f = (f.astype(np.float64) for f in wv._filters(
        wv.WaveletType(type), order))
    cur, bands = np.asarray(x, np.float64), []
    for _ in range(levels):
        n = cur.shape[-1]
        ext = np.concatenate([cur, cur[..., :order]], -1)
        hi = sum(hi_f[k] * ext[..., k:k + n:2] for k in range(order))
        cur = sum(lo_f[k] * ext[..., k:k + n:2] for k in range(order))
        bands.append(hi)
    return bands + [cur]


@pytest.mark.parametrize("rows", [64, 512, 16384])
def test_fused_cascade_launches_the_cascade_bank(rows):
    # the default 3-level daub8 periodic DWT: one cascade-bank launch,
    # no filter-bank pass, no copy kernel, the float64 level loop's
    # bands within 5e-5 of max|y| each
    r = np.random.RandomState(7)
    x = r.randn(rows, 4096).astype(np.float32)
    P = wv.ExtensionType.PERIODIC
    xt = _t(x)
    ck.reset_launches()
    fused = wv.wavelet_transform("daub", 8, P, xt, 3)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cascade_bank"] == 1
    assert ck.LAUNCHES["filter_bank"] == 0
    want = _dwt64(x, "daub", 8, 3)
    assert [tuple(f.shape) for f in fused] == [w.shape for w in want]
    for f, w in zip(fused, want):
        assert _rel(f.cpu(), w) <= 5e-5
    # the route's device work is the one cascade-bank launch: no
    # extension copy, no interleaving stack
    kernels = bm.device_kernels(
        lambda: wv.wavelet_transform("daub", 8, P, xt, 3), calls=3)
    assert kernels and all("cb_frames" in k for k in kernels), kernels


@pytest.mark.parametrize("shape", [(4096,), (1, 4096), (2, 4096),
                                   (4, 4096), (7, 4096), (4, 1 << 20)])
def test_fused_cascade_serves_few_rows(shape):
    # below MIN_ROWS rows the default 3-level daub8 periodic DWT is the
    # one cascade-bank launch too, with no filter-bank pass, and gives
    # the NumPy oracle's bands
    x = np.random.RandomState(len(shape) + shape[0]).randn(
        *shape).astype(np.float32)
    P = wv.ExtensionType.PERIODIC
    ck.reset_launches()
    got = wv.wavelet_transform("daub", 8, P, x, 3)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cascade_bank"] == 1, shape
    assert ck.LAUNCHES["filter_bank"] == 0, shape
    want = wv.wavelet_transform("daub", 8, P, x, 3, simd=False)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert _rel(g.cpu(), w) <= TOL


def test_fused_cascade_bypasses_keep_the_level_loop(monkeypatch):
    r = np.random.RandomState(8)
    P, M = wv.ExtensionType.PERIODIC, wv.ExtensionType.MIRROR
    x = r.randn(64, 4096).astype(np.float32)
    fused = wv.wavelet_transform("daub", 8, P, x, 3)
    # (rows, ext, levels) -> filter-bank launches of the level loop
    # (fewer than MIN_ROWS rows: conv1d, no kernel of csrc/)
    cases = [(4, M, 3, 0), (64, M, 3, 3), (64, P, 1, 1)]
    for rows, ext, levels, fb in cases:
        ck.reset_launches()
        got = wv.wavelet_transform("daub", 8, ext, x[:rows], levels)
        assert ck.LAUNCHES["cascade_bank"] == 0, (rows, ext, levels)
        assert ck.LAUNCHES["filter_bank"] == fb, (rows, ext, levels)
        want = wv.wavelet_transform("daub", 8, ext, x[:rows], levels,
                                    simd=False)
        for g, w in zip(got, want):
            assert _rel(g.cpu(), w) <= TOL
    # the wavelet routes' opt-out: the conv1d level loop, no kernel of
    # csrc/, the fused bands within 5e-5
    monkeypatch.setenv("VELES_SIMD_DISABLE_CUDA_WAVELET", "1")
    ck.reset_launches()
    loop = wv.wavelet_transform("daub", 8, P, x, 3)
    assert not any(ck.LAUNCHES.values()), ck.LAUNCHES
    for f, g in zip(fused, loop):
        assert f.shape == g.shape
        assert _rel(f.cpu(), g.cpu()) <= 5e-5


@pytest.mark.parametrize("type,order,levels,p", [
    ("daub", 8, 3, 37), ("daub", 8, 3, 4095), ("daub", 4, 4, 0),
    ("sym", 8, 2, 70)])
def test_fused_cascade_nonfinite_spread_on_the_card(monkeypatch, type,
                                                    order, levels, p):
    # a zero tap of the kernel's dense frame table still multiplies its
    # sample, so a NaN poisons the outputs whose support, widened to
    # whole frames of 2^L samples, holds it; the level loop (K2) poisons
    # the support alone
    n, split = 4096, 1 << levels
    x = np.random.RandomState(p).randn(8, n).astype(np.float32)
    x[3, p] = np.nan
    P = wv.ExtensionType.PERIODIC
    fused = wv.wavelet_transform(type, order, P, x, levels)
    monkeypatch.setattr(wv._CASCADE_FAMILY, "static_select",
                        lambda **geom: "level_loop")
    ck.reset_launches()
    loop = wv.wavelet_transform(type, order, P, x, levels)
    assert ck.LAUNCHES["filter_bank"] == levels
    for lvl, f, g in zip(list(range(1, levels + 1)) + [levels], fused,
                         loop):
        reach = (order - 1) * ((1 << lvl) - 1)
        j = np.arange(n >> lvl)
        start = j << lvl
        support = (p - start) % n <= reach
        first, last = start // split, (start + reach) // split
        frames = (p // split - first) % (n // split) <= last - first
        bad_f = ~np.isfinite(f.cpu().numpy())
        bad_g = ~np.isfinite(g.cpu().numpy())
        assert not bad_f[[0, 1, 2, 4, 5, 6, 7]].any()
        assert not bad_g[[0, 1, 2, 4, 5, 6, 7]].any()
        assert (bad_g[3] == support).all(), lvl
        assert (bad_f[3] == frames).all(), lvl


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
    # 'same' reads the zero halo in the kernel; 'wrap' extends through
    # _pad2d first and calls it with pad = (0, 0): one launch each
    for kw, xe in (({"mode": "same"}, x),
                   ({"boundary": "wrap"},
                    np.pad(x, ((0, 0), (4, 4), (4, 4)), mode="wrap"))):
        ck.reset_launches()
        y = cv2.convolve2d(x, h, **kw)
        assert ck.LAUNCHES["filter_2d"] == 1
        full = _conv2d64(xe, h)
        want = (full[:, 2:202, 2:152] if "mode" in kw
                else full[:, 4:4 + 204, 4:4 + 154])
        assert _rel(y.cpu(), want) <= TOL


def test_direct_routes_launch_their_kernel_once():
    # one launch a call: the ffma variant below the grid's row limit,
    # the persistent mma variant and K5 beyond it
    r = np.random.RandomState(12)
    for rows, n, k in ((512, 3000, 33), (70000, 20, 200)):
        x, h = r.randn(rows, n).astype(np.float32), r.randn(k)
        ck.reset_launches()
        y = cv.convolve_simd(x, h)
        assert ck.LAUNCHES["filter_bank"] == 1
        assert _rel(y.cpu(), _conv64(x, h)) <= TOL
    x2, h2 = r.randn(70000, 3, 4).astype(np.float32), r.randn(2, 2)
    ck.reset_launches()
    y2 = cv2.convolve2d(x2, h2)
    assert ck.LAUNCHES["filter_2d"] == 1
    assert _rel(y2.cpu(), _conv2d64(x2, h2)) <= TOL


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
    (3, 2000, 255, 85), (70000, 600, 512, 128), (2, 5000, 640, 128),
    (2, 20000, 4096, 128), (2, 40000, 16384, 128),
    # hops that do not divide the frame: Whisper's 400/160 (M = 200 =
    # 8 * 5 * 5), a hop of three to a frame, the odd-L complex path,
    # a span of no 16-byte alignment (441 floats a hop), 512/200 and a
    # hop over half the frame
    (1, 1 << 20, 400, 160), (4, 65536, 400, 160), (2, 20000, 1024, 300),
    (3, 9000, 255, 100), (2, 30000, 2048, 441), (2, 5000, 512, 200),
    (2, 5000, 512, 384),
])
def test_stft_kernel_matches_plain_and_float64(rows, n, L, hop):
    r = np.random.RandomState(rows + L)
    x = r.randn(rows, n).astype(np.float32)
    window = _t(sp.hann_window(L))
    ck.reset_launches()
    got = ck.stft_cuda(_t(x), window, L, hop)
    # one launch per 65535 rows (the grid's y limit)
    assert ck.LAUNCHES["stft"] == -(-rows // 65535)
    # the plain version in float64 (a float32 sum of L terms drifts)
    want = ck.stft_plain(_t(x).double(), sp.hann_window(L), L, hop)
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
    # hop 64 is no 128-lane multiple, and 200 does not divide 512:
    # the kernel all the same; one hop a frame (384) takes the basis
    # matmul
    for hop, launches in ((64, 1), (200, 1), (384, 0)):
        ck.reset_launches()
        y = sp.stft(x, 512, hop)
        assert ck.LAUNCHES["stft"] == launches, hop
        ref64 = _stft64(x, 512, hop)
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


def _stft_2p20_rows():
    """64 recordings of 2^20 samples on the card: the benchmark's
    ``stft_2p20`` batch."""
    g = torch.Generator(device="cuda").manual_seed(26)
    return torch.randn(64, 1 << 20, generator=g, device="cuda")


def _dev_rel(got, want):
    """max|got - want| / max|want| over real and imaginary parts, on
    the card."""
    got, want = torch.view_as_real(got), torch.view_as_real(want)
    return float((got.double() - want).abs().max() / want.abs().max())


def test_stft_kernel_at_librosa_geometry():
    # librosa's default spectrogram, 2048/512: 2045 frames a row
    x = _stft_2p20_rows()
    ck.reset_launches()
    got = ck.stft_cuda(x, _t(sp.hann_window(2048)), 2048, 512)
    assert ck.LAUNCHES["stft"] == 1
    assert got.shape == (64, 2045, 1025)
    # the plain version in float64 (a float32 sum of L terms drifts)
    want = ck.stft_plain(x.double(), sp.hann_window(2048), 2048, 512)
    assert _dev_rel(got, want) <= TOL


def test_stft_whisper_geometry_takes_the_basis_matmul():
    """Whisper's front end, 400/160 on a card operand: the default
    route is the kernel (hop 160 neither a 128-lane multiple nor a
    divisor of 400 keeps it off the TPU kernel's route, not K4's), one
    launch and no scratch: the allocator hands out the output alone.
    Forced, the basis matmul still runs, and its span's
    ``scratch_bytes`` is what the allocator hands out in the call
    besides the output."""
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.obs import spans as tspans

    x = _stft_2p20_rows()
    hann = torch.as_tensor(sp.hann_window(400), device="cuda").double()
    want = torch.fft.rfft(x.double().unfold(-1, 400, 160) * hann, dim=-1)
    for route, launches, scratch in ((None, 1, 0),
                                     ("rdft_matmul", 0, 1_345_204_224)):
        # the window's and basis's device copies, cuBLAS's workspace
        sp.stft(x, 400, 160, route=route)
        torch.cuda.synchronize()
        ck.reset_launches()
        obs.configure(max_spans=256)
        obs.start_capture()
        try:
            before = (torch.cuda.memory_stats()
                      ["allocated_bytes.all.allocated"])
            y = sp.stft(x, 400, 160, route=route)
            torch.cuda.synchronize()
            allocated = (torch.cuda.memory_stats()
                         ["allocated_bytes.all.allocated"] - before)
        finally:
            obs.stop_capture()
            recs = obs.captured().records
            obs.configure(max_spans=tspans.DEFAULT_MAX_SPANS)
            obs.reset()
        assert ck.LAUNCHES["stft"] == launches, route
        (span,) = [r for r in recs if r.name == "stft.route"]
        assert span.attrs == {"route": route or "cuda_fused",
                              "scratch_bytes": scratch}
        out_bytes = y.numel() * y.element_size()
        assert allocated - out_bytes == scratch
        assert y.shape == want.shape == (64, 6552, 201)
        assert _dev_rel(y, want) <= TOL
        del y


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


# ---- the reference-header surface on the card ------------------------------

def _gemm64(a, b):
    return np.matmul(np.asarray(a, np.float64), np.asarray(b, np.float64))


@pytest.mark.parametrize("route", ["fp32", "bf16_comp", "int8", "bf16"])
@pytest.mark.parametrize("a_shape,b_shape", [
    ((17, 9), (9, 13)),            # int8 pads every dim
    ((3, 40, 24), (24, 16)),       # batched, b shared
    ((2, 3, 33, 17), (3, 17, 5)),  # broadcast batch dims
    ((512, 512), (512, 512)),
])
def test_gemm_routes_within_budget(route, a_shape, b_shape):
    from veles.simd_tpu_torch.ops import matrix as mx
    from veles.simd_tpu_torch.runtime import precision as prx

    rng = np.random.RandomState(71)
    a = rng.randn(*a_shape).astype(np.float32)
    b = rng.randn(*b_shape).astype(np.float32)
    got = mx.matrix_multiply(a, b, precision=route)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    budget = prx.ERROR_BUDGETS[mx.GEMM_PRECISIONS[route]]
    assert _rel(got.cpu(), _gemm64(a, b)) <= max(budget, 1e-5)
    # the CPU computes the same route: int8 accumulators bit-equal
    config.set_config(device="cpu")
    want = mx.matrix_multiply(a, b, precision=route).numpy()
    if route == "int8":
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("route", ["fp32", "bf16_comp", "int8"])
def test_gemv_routes_within_budget(route):
    from veles.simd_tpu_torch.ops import matrix as mx
    from veles.simd_tpu_torch.runtime import precision as prx

    rng = np.random.RandomState(72)
    m = rng.randn(300, 257).astype(np.float32)
    v = rng.randn(257).astype(np.float32)
    got = mx.matrix_vector_multiply(m, v, precision=route)
    budget = prx.ERROR_BUDGETS[mx.GEMM_PRECISIONS[route]]
    assert _rel(got.cpu(), _gemm64(m, v)) <= max(budget, 1e-5)


def test_fp32_route_runs_no_tf32_kernel():
    from veles.simd_tpu_torch.ops import matrix as mx

    a = _t(np.random.RandomState(73).randn(1024, 1024))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True   # a caller's setting
    try:
        names = bm.device_kernels(lambda: mx.matrix_multiply(a, a),
                                  calls=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert names and not any("tf32" in n.lower() for n in names), names


def test_float_to_int32_saturates_on_the_card():
    from veles.simd_tpu_torch.ops import arithmetic as ar

    x = np.array([3e9, -3e9, np.nan, 0.9, -0.9, 2.0 ** 31, 123.7],
                 np.float32)
    got = ar.float_to_int32(x)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        np.array([2 ** 31 - 1, -2 ** 31, 0, 0, 0, 2 ** 31 - 1, 123],
                 np.int32))
    np.testing.assert_array_equal(
        ar.float_to_int16(x).cpu().numpy(),
        np.array([32767, -32768, 0, 0, 0, 32767, 123], np.int16))


def test_log_special_values_on_the_card():
    from veles.simd_tpu_torch.ops import mathfun as mf

    x = np.array([1e-40, -1e-40, 1e-45, 0.0, -0.0, -1.0, np.nan, np.inf,
                  1.0], np.float32)
    got = mf.log_psv(x).cpu().numpy()
    want = np.array([-np.inf] * 5 + [np.nan, np.nan, np.inf, 0.0],
                    np.float32)
    np.testing.assert_array_equal(got, want)
    u = np.random.RandomState(74).uniform(0.1, 5.0, 1 << 16)
    u = u.astype(np.float32)
    np.testing.assert_allclose(mf.log_psv(u).cpu().numpy(),
                               np.log(u.astype(np.float64)),
                               rtol=1e-4, atol=1e-4)


# ---- IIR and resampling (no csrc kernel: torch ops on the card) -------------

IIR_TOL = 2e-5      # tests/test_iir.py, tests/test_resample.py
FOURIER_TOL = 1e-4


def _no_copy_no_tf32(fn):
    """The device work of ``fn`` on card-resident operands: neither a
    TF32 kernel nor a copy to or from the host (the constants are on
    the card after the profiler's warm-up call)."""
    names = bm.device_kernels(fn, calls=2)
    assert names
    assert not any("tf32" in n.lower() for n in names), names
    assert not any(d in n.lower() for n in names
                   for d in ("htod", "dtoh")), names
    return names


@pytest.mark.parametrize("sos", [iir.butterworth(4, 0.25),
                                 iir.cheby1(8, 0.05, 0.2)])
def test_sosfilt_on_the_card(sos):
    r = np.random.RandomState(3)
    x = r.randn(8, 5000).astype(np.float32)
    xt = _t(x)
    got = iir.sosfilt(sos, xt)
    assert got.is_cuda and got.dtype == torch.float32
    assert _rel(got.cpu(), iir.sosfilt_na(sos, x)) <= IIR_TOL
    zi = r.randn(len(sos), 2)
    y, zf = iir.sosfilt(sos, xt, zi=zi, return_zf=True)
    wy, wzf = iir.sosfilt_na(sos, x, zi=zi, return_zf=True)
    assert zf.is_cuda
    assert _rel(y.cpu(), wy) <= IIR_TOL and _rel(zf.cpu(), wzf) <= IIR_TOL
    assert _rel(iir.sosfiltfilt(sos, xt).cpu(),
                iir.sosfiltfilt_na(sos, x)) <= IIR_TOL
    assert _rel(bt.batched_sosfilt(sos, xt).cpu(),
                iir.sosfilt_na(sos, x)) <= IIR_TOL
    st = iir.StreamingSosfilt(sos)
    ys = torch.cat([st.process(c) for c in xt.split(1000, -1)], -1)
    assert ys.is_cuda
    assert _rel(ys.cpu(), iir.sosfilt_na(sos, x)) <= IIR_TOL
    _no_copy_no_tf32(lambda: iir.sosfilt(sos, xt))
    _no_copy_no_tf32(lambda: iir.sosfiltfilt(sos, xt))


def test_lfilter_on_the_card():
    b, a = [0.2, 0.3, 0.1], [1.0, -0.5, 0.2, -0.05]
    x = np.random.RandomState(4).randn(4, 3000).astype(np.float32)
    xt = _t(x)
    want = iir.lfilter_na(b, a, x)
    assert _rel(iir.lfilter(b, a, xt).cpu(), want) <= IIR_TOL
    assert _rel(bt.batched_lfilter(b, a, xt).cpu(), want) <= IIR_TOL
    _no_copy_no_tf32(lambda: iir.lfilter(b, a, xt))


@pytest.mark.parametrize("up,down", [(160, 147), (147, 160), (1, 4),
                                     (4, 1), (3, 2)])
def test_resample_poly_on_the_card(up, down):
    x = np.random.RandomState(up + down).randn(3, 20000).astype(np.float32)
    xt = _t(x)
    got = rs.resample_poly(xt, up, down)
    assert got.is_cuda
    assert _rel(got.cpu(), rs.resample_poly_na(x, up, down)) <= IIR_TOL
    assert _rel(bt.batched_resample_poly(xt, up, down).cpu(),
                rs.resample_poly_na(x, up, down)) <= IIR_TOL
    names = _no_copy_no_tf32(lambda: rs.resample_poly(xt, up, down))
    # the polyphase core never runs a transposed conv
    assert not any("dgrad" in n.lower() for n in names), names


def test_other_resamplers_on_the_card():
    r = np.random.RandomState(5)
    x = r.randn(2, 8192).astype(np.float32)
    xt = _t(x)
    h = r.randn(31)
    assert _rel(rs.upfirdn(h, xt, 3, 2).cpu(),
                rs.upfirdn_na(h, x, 3, 2)) <= IIR_TOL
    assert _rel(rs.decimate(xt, 4).cpu(),
                rs.resample_poly_na(x, 1, 4)) <= IIR_TOL
    assert _rel(rs.decimate(xt, 4, ftype="iir").cpu(),
                rs.decimate(x, 4, ftype="iir", simd=False)) <= IIR_TOL
    num = rs.resample_length(8192, 160, 147)
    assert _rel(rs.resample_fourier(xt, num).cpu(),
                rs.resample_fourier_na(x, num)) <= FOURIER_TOL
    sos = iir.butterworth(3, 0.3)
    for fn in (lambda: rs.upfirdn(h, xt, 3, 2),
               lambda: rs.decimate(xt, 4),
               lambda: rs.decimate(xt, 4, ftype="iir"),
               lambda: rs.resample_fourier(xt, num),
               lambda: bt.batched_resample_poly(xt, 160, 147),
               lambda: bt.batched_sosfilt(sos, xt),
               lambda: bt.batched_lfilter([1.0, 0.5], [1.0, -0.3], xt)):
        assert fn().is_cuda
        _no_copy_no_tf32(fn)


def test_oversized_smem_launch_is_a_typed_rejection(monkeypatch):
    # the STFT kernel's admission opened past the card's shared memory
    # per block: the launch is refused with cudaErrorInvalidValue (1),
    # raised as a typed CudaError that the fault policy classifies as a
    # rejection for the geometry, never as a transient fault
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.runtime import faults

    L, hop = 32768, 128
    assert not ck.fits_smem_stft(L, hop)
    monkeypatch.setattr(ck, "fits_smem_stft", lambda L, hop: True)
    r = np.random.RandomState(90)
    x = r.randn(L + 70 * hop).astype(np.float32)
    with pytest.raises(ck.CudaError) as ei:
        ck.stft_cuda(_t(x), _t(sp.hann_window(L)), L, hop)
    assert ei.value.code == 1
    assert faults.is_mosaic_vmem_oom(ei.value)
    assert not faults.is_transient(ei.value)
    # through the entry point with the operand on the card: the
    # refusal raises untouched and nothing is remembered
    obs.enable()
    obs.reset()
    try:
        with pytest.raises(ck.CudaError):
            sp.stft(_t(x), L, hop)
        assert (L, hop) not in sp._CUDA_STFT_REJECTED
        assert obs.counter_value("fault_demotion",
                                 site="spectral.stft_cuda") == 0
        # with host input: the route demotes to xla_fft, remembers the
        # class and launches nothing
        ck.reset_launches()
        got = sp.stft(x, L, hop)
        torch.cuda.synchronize()
        assert ck.LAUNCHES["stft"] == 0
        assert (L, hop) in sp._CUDA_STFT_REJECTED
        assert obs.counter_value("cuda_stft_demotion",
                                 reason="compile_oom") == 1
        assert obs.counter_value("fault_demotion",
                                 site="spectral.stft_cuda") == 1
        want = sp.stft_na(x, L, hop)
        assert _rel(got.cpu().numpy().view(np.float32),
                    want.astype(np.complex64).view(np.float32)) <= 1e-4
    finally:
        obs.disable()
        obs.reset()
        sp._CUDA_STFT_REJECTED.discard((L, hop))


def test_card_operands_reraise_after_retries(monkeypatch):
    # operands already on the card: a device loss is retried, then
    # re-raised with the fault recorded; no NumPy oracle answers
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.runtime import faults

    monkeypatch.setenv(faults.FAULT_BACKOFF_ENV, "0")
    r = np.random.RandomState(92)
    x, h = _t(r.randn(1 << 16)), _t(r.randn(2047))
    obs.enable()
    obs.reset()
    try:
        with faults.fault_plan("convolve.dispatch:device_lost:9999"):
            with pytest.raises(faults.InjectedFault):
                cv.convolve(x, h)
        assert obs.counter_value("fault_retry",
                                 site="convolve.dispatch") == 2
        assert obs.counter_value("fault_degraded", site="convolve.dispatch",
                                 to="oracle") == 0
        assert faults.fault_history()[-1]["action"] == "exhausted"
        assert cv.convolve(x, h).is_cuda
    finally:
        faults.reset_fault_history()
        obs.disable()
        obs.reset()


def test_healthy_kernel_routes_record_no_fault():
    from veles.simd_tpu_torch import obs

    r = np.random.RandomState(91)
    x = r.randn(1 << 16).astype(np.float32)
    h = r.randn(2047).astype(np.float32)
    obs.enable()
    obs.reset()
    try:
        ck.reset_launches()
        y = cv.convolve(_t(x), _t(h))
        y2 = cv2.convolve2d(_t(r.randn(4, 64, 64)), _t(r.randn(5, 5)))
        s = sp.stft(_t(r.randn(1 << 16)), 512, 128)
        torch.cuda.synchronize()
        assert ck.LAUNCHES["overlap_save"] >= 1
        assert ck.LAUNCHES["filter_2d"] == 1 and ck.LAUNCHES["stft"] == 1
        assert all(t.is_cuda for t in (y, y2, s))
        snap = obs.snapshot()
        assert not [c for c in snap["counters"]
                    if c["name"].startswith("fault_")]
        assert not [e for e in snap["events"]
                    if e["op"] == "fault_policy"]
    finally:
        obs.disable()
        obs.reset()


# ---- the measured autotuner on the card ---------------------------------

def test_autotune_probes_on_cuda_events_and_persists(tmp_path):
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.runtime import routing

    r = np.random.RandomState(5)
    x_np, h_np = r.randn(64, 4096), r.randn(129)
    x, h = _t(x_np), _t(h_np)
    pack = str(tmp_path / "pack.json")
    obs.enable()
    obs.reset()
    try:
        with routing.private_tune_cache(pack) as cache, \
                routing.autotune_mode_override("on"):
            ck.reset_launches()
            y = cv.convolve_simd(x, h)
            torch.cuda.synchronize()
            # the default timer: 1 warm-up + 2 + (2 + 8) calls of K2
            assert ck.LAUNCHES["filter_bank"] >= 13
            (ev,) = [e for e in obs.events() if e["op"] == "autotune"]
            entry = cache.entry("convolve.direct",
                                {"rows": 64, "n": 4096, "k": 129})
            assert entry["route"] == ev["decision"]
            assert set(entry["timings_us"]) == {"direct_cuda",
                                                "direct_mxu"}
            assert all(0 < t < 1e5 for t in entry["timings_us"].values())
            ck.reset_launches()
            cv.convolve_simd(x, h)          # a hit: the winner alone
            torch.cuda.synchronize()
            kern = {"direct_cuda": {"filter_bank"}}.get(entry["route"],
                                                        set())
            assert {k for k, v in ck.LAUNCHES.items() if v} == kern
        import json

        data = json.load(open(pack))
        assert data["device"] == torch.cuda.get_device_name(0)
        assert _rel(y.cpu(), _conv64(x_np, h_np)) <= TOL
    finally:
        obs.disable()
        obs.reset()


def test_autotune_off_launches_nothing_extra(monkeypatch):
    from veles.simd_tpu_torch.runtime import routing

    monkeypatch.delenv(routing.AUTOTUNE_ENV, raising=False)
    r = np.random.RandomState(6)
    x, h = _t(r.randn(1 << 16)), _t(r.randn(2047))
    handle = cv.convolve_initialize(1 << 16, 2047)

    def never(thunk, name):
        raise AssertionError("autotune off must not probe")

    with routing.probe_timer(never):
        ck.reset_launches()
        cv.convolve(handle, x, h)
        torch.cuda.synchronize()
        off = dict(ck.LAUNCHES)
        with routing.private_tune_cache():
            ck.reset_launches()
            cv.convolve(handle, x, h)
            torch.cuda.synchronize()
    assert off["overlap_save"] == 2 and ck.LAUNCHES == off


def test_autotune_never_tunes_cpu_operands_under_the_card_stamp():
    from veles.simd_tpu_torch.runtime import routing

    def never(thunk, name):
        raise AssertionError("a CPU operand must not be probed here")

    with routing.probe_timer(never), \
            routing.private_tune_cache() as cache, \
            routing.autotune_mode_override("on"):
        y = sp.hilbert(torch.randn(2, 512))
    assert y.device.type == "cpu" and not cache.entries()
    assert cache.device == torch.cuda.get_device_name(0)


def test_autotune_card_probe_refusal_raises_unremembered(monkeypatch):
    # a refused launch met while probing data already on the card
    # surfaces: no other route takes the call, nothing is remembered
    from veles.simd_tpu_torch.runtime import routing

    def refused(x, h, hd):
        raise ck.CudaError("overlap_save kernel", 1, "refused")

    monkeypatch.setitem(cv._OS_RUNNERS, "cuda_fused", refused)
    r = np.random.RandomState(7)
    x, h = _t(r.randn(1 << 16)), _t(r.randn(2047))
    handle = cv.convolve_initialize(1 << 16, 2047)
    before = len(cv._CUDA_OS_REJECTED)
    with routing.private_tune_cache() as cache, \
            routing.autotune_mode_override("on"):
        with pytest.raises(ck.CudaError):
            cv.convolve(handle, x, h)
    assert len(cv._CUDA_OS_REJECTED) == before
    assert 2047 not in cv._CUDA_OS_REJECTED
    assert not cache.entries()


# ---------------------------------------------------------------------------
# the pipeline compiler: one CUDA-graph replay per block
# ---------------------------------------------------------------------------

def _pipeline_chain(name):
    from veles.simd_tpu_torch import pipeline as pl

    sos = iir.butterworth(4, 0.25, "lowpass")
    h = np.random.RandomState(3).randn(300).astype(np.float32)
    return pl.Pipeline(
        [pl.resample_poly(2, 1), pl.fir(h), pl.sosfilt(sos),
         pl.stft(256, 64), pl.power()], name=name)


def test_pipeline_graph_step_equals_eager_step():
    from veles.simd_tpu_torch.pipeline.compiler import _tree_map

    cp = _pipeline_chain("graph_eq").compile(512)
    r = np.random.RandomState(1)
    x = _t(r.randn(3, 512))
    # a state of random values, so a replay that read the wrong buffer
    # would show
    state = cp._device_state(_tree_map(
        lambda a: r.randn(*a.shape).astype(np.float32),
        cp.init_state((3,))))
    out, new = cp.process(x, state)
    torch.cuda.synchronize()
    assert cp.compile_cache_size() == 1
    want, want_new = cp._run_stages(x, state)
    assert _rel(out.cpu(), want.cpu()) <= TOL
    flat_new = torch.cat([t.reshape(-1) for t in _flat(new)])
    flat_want = torch.cat([t.reshape(-1) for t in _flat(want_new)])
    assert _rel(flat_new.cpu(), flat_want.cpu()) <= TOL


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _flat(t)]
    return [tree]


def test_pipeline_graph_state_straddles_blocks():
    # every block a replay of the one graph, the state carried through
    # copies: block boundaries straddle the resampler history, the FIR
    # halo, the IIR zi and the STFT overlap; the outputs handed back
    # are copies, so the next replay cannot overwrite them
    cp = _pipeline_chain("graph_stream").compile(512)
    x = np.random.RandomState(2).randn(2, 6 * 512).astype(np.float32)
    outs, state = [], cp.init_state((2,))
    for i in range(6):
        out, state = cp.process(x[:, i * 512:(i + 1) * 512], state)
        outs.append(out)
    torch.cuda.synchronize()
    assert cp.compile_cache_size() == 1
    got = cp.assemble(outs)
    assert _rel(got, cp.oracle(x)) <= TOL
    eager, _ = cp.stream(x, fused=False)
    assert _rel(got, eager) <= 1e-6


def test_pipeline_graph_threads_share_one_pipeline():
    # threads replay one graph through its shared static buffers: each
    # stream must still match its own oracle
    import threading

    cp = _pipeline_chain("graph_threads").compile(512)
    r = np.random.RandomState(4)
    xs = [r.randn(2, 4 * 512).astype(np.float32) for _ in range(4)]
    cp.stream(xs[0])                # capture before the threads start
    got = [None] * len(xs)

    def worker(i):
        got[i] = cp.stream(xs[i])[0]

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert cp.compile_cache_size() == 1
    for x, y in zip(xs, got):
        assert _rel(y, cp.oracle(x)) <= TOL


def test_pipeline_second_batch_shape_captures_second_graph():
    cp = _pipeline_chain("graph_shapes").compile(512)
    r = np.random.RandomState(3)
    for rows in (1, 4, 1):
        x = r.randn(rows, 1024).astype(np.float32)
        got, _ = cp.stream(x)
        assert _rel(got, cp.oracle(x)) <= TOL
    assert cp.compile_cache_size() == 2


# ---------------------------------------------------------------------------
# the serving loop: host batches in, one copy back, K4 a batch
# ---------------------------------------------------------------------------

def test_serve_stft_class_is_one_k4_launch_a_batch():
    from veles.simd_tpu_torch import serve

    r = np.random.RandomState(21)
    xs = [r.randn(16384).astype(np.float32) for _ in range(16)]
    srv = serve.Server(max_batch=8, max_wait_ms=50.0, workers=2)
    # queued before the workers start: two full batches
    tickets = [srv.submit(serve.Request(
        "stft", x, {"frame_length": 512, "hop": 128})) for x in xs]
    ck.reset_launches()
    with srv:
        ys = [t.result(timeout=120.0) for t in tickets]
    assert srv.stats()["counts"]["batches"] == 2
    assert ck.LAUNCHES["stft"] == sum(ck.LAUNCHES.values()) == 2
    for x, y, t in zip(xs, ys, tickets):
        assert t.status == "ok" and isinstance(y, np.ndarray)
        want = sp.stft_na(x, 512, 128)
        assert np.max(np.abs(y - want)) / np.max(np.abs(want)) <= 1e-4


def test_serve_pipeline_captures_beside_plain_batches():
    import threading

    from veles.simd_tpu_torch import serve

    sos = iir.butterworth(4, 0.25, "lowpass")
    cp = _pipeline_chain("served_graph").compile(512)
    ref = _pipeline_chain("served_ref").compile(512)
    r = np.random.RandomState(22)
    x = r.randn(8, 3 * 512).astype(np.float32)
    stop = threading.Event()
    plain = []

    def feeder(srv):
        rf = np.random.RandomState(23)
        while not stop.is_set():
            xs = [rf.randn(int(rf.randint(200, 6000))).astype(np.float32)
                  for _ in range(8)]
            tks = [srv.submit(serve.Request("sosfilt", v, {"sos": sos}))
                   for v in xs]
            plain.extend((v, t, t.result(timeout=60.0))
                         for v, t in zip(xs, tks))

    with serve.Server(max_batch=8, max_wait_ms=20.0, workers=2) as srv:
        op = srv.register_pipeline("served_graph", cp)
        t = threading.Thread(target=feeder, args=(srv,))
        t.start()
        try:
            while len(plain) < 8:
                stop.wait(0.001)
            states, outs = [None] * 8, [[] for _ in range(8)]
            for b in range(3):
                tks = [srv.submit(op=op, x=x[i, b * 512:(b + 1) * 512],
                                  params={"state": states[i]})
                       for i in range(8)]
                for i, tk in enumerate(tks):
                    outs[i].append(tk.result(timeout=60.0)[0])
                    states[i] = tk.result()[1]
                    assert tk.status == "ok"
        finally:
            stop.set()
            t.join(timeout=60.0)
    assert not t.is_alive()
    assert cp.compile_cache_size() == 1
    st = None
    for b in range(3):
        want, st = ref.process(x[:, b * 512:(b + 1) * 512], st)
        got = np.stack([outs[i][b] for i in range(8)])
        assert _rel(got, want.cpu()) <= 1e-6
    assert plain and all(tk.status == "ok" for _, tk, _ in plain)
    for v, _, y in plain[:16]:
        assert _rel(y, iir.sosfilt_na(sos, v)) <= 2e-5


def test_serve_degraded_batch_equals_the_oracle(monkeypatch):
    from veles.simd_tpu_torch import serve
    from veles.simd_tpu_torch.runtime import breaker, faults
    from veles.simd_tpu_torch.serve import server

    monkeypatch.setenv("VELES_SIMD_FAULT_BACKOFF", "0")
    sos = iir.butterworth(4, 0.25, "lowpass")
    r = np.random.RandomState(24)
    xs = [r.randn(700).astype(np.float32) for _ in range(3)]
    breaker.reset()
    srv = serve.Server(max_batch=4, max_wait_ms=20.0, workers=1)
    tickets = [srv.submit(serve.Request("sosfilt", v, {"sos": sos}))
               for v in xs]
    try:
        # the batch's device attempts all fail: the host batch's oracle
        with faults.fault_plan("serve.dispatch:device_lost:3"), srv:
            ys = [t.result(timeout=60.0) for t in tickets]
    finally:
        breaker.reset()
        faults.reset_fault_history()
    batch = np.zeros((4, 1024), np.float32)
    for i, v in enumerate(xs):
        batch[i, :v.size] = v
    want = server._oracle_call("sosfilt", batch, {"sos": sos})
    for i, (v, y, t) in enumerate(zip(xs, ys, tickets)):
        assert t.status == "degraded"
        assert np.array_equal(y, want[i, :v.size])
        assert _rel(y, iir.sosfilt_na(sos, v)) <= 2e-5


# ---------------------------------------------------------------------------
# the serving fleet: K4 in every replica, one capture gate a process
# ---------------------------------------------------------------------------

def _k4_batches(tickets):
    return len({(t.replica, e["batch"]) for t in tickets
                for e in t.trace.events() if e["event"] == "batch_formed"})


def test_fleet_thread_group_launches_k4_once_a_batch_in_every_replica():
    from veles.simd_tpu_torch import obs, serve

    r = np.random.RandomState(31)
    xs = [r.randn(16384).astype(np.float32) for _ in range(96)]
    obs.enable()
    try:
        with serve.ReplicaGroup(3, max_batch=16, max_wait_ms=20.0,
                                workers=2, obs_port=-1) as group:
            router = serve.FrontRouter(group)
            ck.reset_launches()
            tickets = [router.submit(op="stft", x=x, params={
                "frame_length": 512, "hop": 128}, deadline_ms=60000.0)
                for x in xs]
            ys = [t.result(timeout=120.0) for t in tickets]
            answered = router.stats()["answered_by_replica"]
    finally:
        obs.disable()
        obs.reset()
    assert len(answered) == 3
    assert ck.LAUNCHES["stft"] == sum(ck.LAUNCHES.values()) \
        == _k4_batches(tickets)
    for x, y, t in zip(xs[:16], ys, tickets):
        assert t.status == "ok"
        want = sp.stft_na(x, 512, 128)
        assert np.max(np.abs(y - want)) / np.max(np.abs(want)) <= 1e-4


def test_fleet_capture_on_one_replica_beside_batches_on_another():
    import threading

    from veles.simd_tpu_torch import serve
    from veles.simd_tpu_torch.serve import server

    sos = iir.butterworth(4, 0.25, "lowpass")
    spec = {"name": "fleet_graph", "block": 512, "stages": [
        {"stage": "sosfilt", "sos": np.asarray(sos).tolist()},
        {"stage": "fir", "h": np.hanning(33).tolist()}]}
    r = np.random.RandomState(32)
    x = r.randn(8, 2 * 512).astype(np.float32)
    plain, stop = [], threading.Event()
    with serve.ReplicaGroup(2, max_batch=8, max_wait_ms=5.0, workers=2,
                            obs_port=-1, pipeline_specs=[spec]) as group:
        r0, r1 = group.replica("r0"), group.replica("r1")
        assert r0.server._gate is r1.server._gate is server._GATE

        def feeder():
            rf = np.random.RandomState(33)
            while not stop.is_set():
                vs = [rf.randn(int(rf.randint(200, 6000))).astype(
                    np.float32) for _ in range(8)]
                tks = [r1.server.submit(serve.Request(
                    "sosfilt", v, {"sos": sos})) for v in vs]
                plain.extend((v, t, t.result(timeout=60.0))
                             for v, t in zip(vs, tks))

        t = threading.Thread(target=feeder)
        t.start()
        try:
            while len(plain) < 8:
                stop.wait(0.001)
            states, outs = [None] * 8, [[] for _ in range(8)]
            for b in range(2):
                tks = [r0.server.submit(op="pipeline:fleet_graph",
                                        x=x[i, b * 512:(b + 1) * 512],
                                        params={"state": states[i]})
                       for i in range(8)]
                for i, tk in enumerate(tks):
                    outs[i].append(tk.result(timeout=60.0)[0])
                    states[i] = tk.result()[1]
                    assert tk.status == "ok"
        finally:
            stop.set()
            t.join(timeout=60.0)
    assert not t.is_alive()
    assert plain and all(tk.status == "ok" for _, tk, _ in plain)
    from veles.simd_tpu_torch import pipeline as tpl

    ref = tpl.pipeline_from_spec(spec)
    st = None
    for b in range(2):
        want, st = ref.process(x[:, b * 512:(b + 1) * 512], st)
        got = np.stack([outs[i][b] for i in range(8)])
        assert _rel(got, want.cpu()) <= 1e-6


def test_fleet_subprocess_child_runs_k4_on_the_card():
    import urllib.request

    from veles.simd_tpu_torch import serve

    r = np.random.RandomState(34)
    xs = [r.randn(16384).astype(np.float32) for _ in range(16)]
    ck.load_library()
    with serve.ReplicaGroup(1, spawn="subprocess", max_batch=8,
                            max_wait_ms=20.0, workers=2,
                            obs_port=-1) as group:
        child = group.replica("r0")
        assert child.ready_s is not None and child.ready_s < 60.0
        router = serve.FrontRouter(group)
        ck.reset_launches()
        tickets = [router.submit(op="stft", x=x, params={
            "frame_length": 512, "hop": 128}, deadline_ms=60000.0)
            for x in xs]
        ys = [t.result(timeout=120.0) for t in tickets]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{child.port}/metrics",
                timeout=10.0) as resp:
            metrics = resp.read().decode()
    assert sum(ck.LAUNCHES.values()) == 0        # the child launched
    assert any(ln.startswith("veles_simd_resource_")
               and 'op="cuda",route="stft"' in ln
               for ln in metrics.splitlines())
    for x, y, t in zip(xs, ys, tickets):
        assert t.status == "ok"
        want = sp.stft_na(x, 512, 128)
        assert np.max(np.abs(y - want)) / np.max(np.abs(want)) <= 1e-4


# ---------------------------------------------------------------------------
# the sharded families on an 8-shard mesh of cuda:0
# ---------------------------------------------------------------------------

def test_parallel_default_mesh_is_eight_shards_of_the_card():
    from veles.simd_tpu_torch import parallel as par

    mesh = par.make_mesh({"dp": 2, "sp": 4})
    assert mesh.size == 8
    assert {str(d) for d in mesh.devices.flat} == {"cuda:0"}


def test_parallel_convolve_halo_and_ring_on_the_card():
    from veles.simd_tpu_torch import parallel as par

    r = np.random.RandomState(41)
    mesh = par.make_mesh({"sp": 8})
    x = _t(r.randn(1 << 16))
    for k in (129, 20001):      # one hop, then k - 1 past a block
        h = _t(r.randn(k))
        y = par.sharded_convolve(x, h, mesh)
        assert y.is_cuda and y.device == torch.device("cuda", 0)
        want = _conv64(x.cpu().numpy(), h.cpu().numpy())
        assert _rel(y.cpu(), want) <= 1e-4


def test_parallel_wavelet_rows_reach_k2_and_round_trip():
    from veles.simd_tpu_torch import parallel as par

    r = np.random.RandomState(42)
    mesh = par.make_mesh({"sp": 8})
    img = _t(r.randn(512, 512))
    P = wv.ExtensionType.PERIODIC
    ck.reset_launches()
    bands = par.sharded_wavelet_apply2d("daub", 8, P, img, mesh)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["filter_bank"] >= 16     # rows and columns, 8 each
    for got, want in zip(bands, wv.wavelet_apply2d("daub", 8, P, img)):
        assert _rel(got.cpu(), want.cpu()) <= TOL
    rec = par.sharded_wavelet_reconstruct2d("daub", 8, *bands, mesh)
    assert np.max(np.abs(rec.cpu().numpy() - img.cpu().numpy())) <= 2e-4


def test_parallel_sosfilt_stft_and_matmul_on_the_card():
    from veles.simd_tpu_torch import parallel as par

    r = np.random.RandomState(43)
    sp8 = par.make_mesh({"sp": 8})
    x = _t(r.randn(2, 1 << 16))
    sos = iir.butterworth(4, 0.25)
    assert _rel(par.sharded_sosfilt(sos, x, sp8).cpu(),
                iir.sosfilt(sos, x).cpu()) <= 5e-5
    got = par.sharded_stft(x, 512, 128, sp8).cpu().numpy()
    want = sp.stft_na(x.cpu().numpy(), 512, 128)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= 1e-4
    a, b = _t(r.randn(256, 1000)), _t(r.randn(1000, 128))
    got = par.sharded_matmul(a, b, par.make_mesh({"tp": 8}))
    assert _rel(got.cpu(), (a.double() @ b.double()).cpu()) <= 1e-5


def test_parallel_operands_never_cross_between_cpu_and_card():
    from veles.simd_tpu_torch import parallel as par

    cpu8 = par.make_mesh({"sp": 8}, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="mesh of cpu"):
        par.sharded_convolve(_t(np.ones(64)), _t(np.ones(3)), cpu8)
    with pytest.raises(ValueError, match="mesh of cuda"):
        par.sharded_convolve(torch.ones(64), torch.ones(3),
                             par.make_mesh({"sp": 8}))


# ---------------------------------------------------------------------------
# the C ABI: the port's libveles_simd.so on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cbridge():
    """The port's C bridge opened in this process (``cabi.load``): its
    shim runs in this interpreter, on the card, and its launches count
    in ``ck.LAUNCHES``."""
    from veles.simd_tpu_torch import cabi

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available())")
    if cabi.toolchain() is None:
        pytest.skip("gcc, python3-config or Python's headers unavailable")
    lib = cabi.load()
    assert lib.veles_simd_init(None) == 0, lib.veles_simd_last_error()
    return lib


def _fp(a):
    import ctypes

    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def test_cabi_backend_names_the_card(cbridge):
    assert cbridge.veles_simd_backend().decode() \
        == f"torch:cuda:{torch.cuda.get_device_name(0)}"


@pytest.mark.parametrize("n, k, launches", [(1 << 20, 2047, 2),
                                            (100000, 257, 2)])
def test_cabi_convolution_handle_runs_k1(cbridge, n, k, launches):
    r = np.random.RandomState(k)
    x, h = r.randn(n).astype(np.float32), r.randn(k).astype(np.float32)
    y = np.zeros(n + k - 1, np.float32)
    handle = cbridge.convolve_initialize(n, k, 0)
    ck.reset_launches()
    assert cbridge.convolve(handle, _fp(x), _fp(h), _fp(y)) == 0
    assert ck.LAUNCHES["overlap_save"] == launches
    cbridge.convolve_finalize(handle)
    assert _rel(y, _conv64(x, h)) <= 1e-4


def test_cabi_stft_runs_k4(cbridge):
    r = np.random.RandomState(41)
    x = r.randn(1 << 20).astype(np.float32)
    frames = 1 + ((1 << 20) - 512) // 128
    spec = np.zeros((frames, 257, 2), np.float32)
    ck.reset_launches()
    assert cbridge.stft(1, _fp(x), 1 << 20, 512, 128, None, _fp(spec)) == 0
    assert ck.LAUNCHES["stft"] == 1
    got = spec[..., 0] + 1j * spec[..., 1]
    want = sp.stft_na(x, 512, 128)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= 1e-4


def test_cabi_convolve2d_runs_k5(cbridge):
    from scipy import signal

    r = np.random.RandomState(42)
    x = r.randn(512, 512).astype(np.float32)
    h = r.randn(7, 7).astype(np.float32)
    y = np.zeros((518, 518), np.float32)
    ck.reset_launches()
    assert cbridge.convolve2d(1, _fp(x), 512, 512, _fp(h), 7, 7,
                              _fp(y)) == 0
    assert ck.LAUNCHES["filter_2d"] == 1
    want = signal.convolve2d(x.astype(np.float64), h.astype(np.float64))
    assert _rel(y, want) <= 1e-4


def test_cabi_wavelet_apply2d_rows_run_k2(cbridge):
    r = np.random.RandomState(43)
    img = r.randn(512, 512).astype(np.float32)
    bands = [np.zeros((256, 256), np.float32) for _ in range(4)]
    ck.reset_launches()
    assert cbridge.wavelet_apply2d(1, 0, 8, 0, _fp(img), 512, 512,
                                   *map(_fp, bands)) == 0
    # the row pass, then the stacked column pass
    assert ck.LAUNCHES["filter_bank"] == 2
    want = wv.wavelet_apply2d("daub", 8, wv.ExtensionType.PERIODIC, img,
                              simd=False)
    for got, ref in zip(bands, want):
        assert _rel(got, ref) <= 1e-4


def test_cabi_c_suite_passes_on_the_card():
    import subprocess
    from pathlib import Path

    from veles.simd_tpu_torch import cabi

    if cabi.toolchain() is None:
        pytest.skip("gcc, python3-config or Python's headers unavailable")
    prog = cabi.build_program(Path(__file__).resolve().parent.parent
                              / "csrc" / "test_veles_simd.c")
    run = subprocess.run([str(prog)], capture_output=True, text=True,
                         env=cabi.program_env(), timeout=600)
    assert run.returncode == 0, (run.stdout[-2000:], run.stderr[-3000:])
    assert "0 failures" in run.stdout
    assert f"backend: torch:cuda:{torch.cuda.get_device_name(0)}" \
        in run.stdout


CUPTI_HEADER = "/usr/local/cuda/include/cupti_activity.h"


def test_devtrace_offsets_match_the_toolkit_header(tmp_path):
    # the record fields devtrace reads sit where the CUDA toolkit's
    # cupti_activity.h puts them, in its newest kernel, copy and
    # memset records
    import re
    import shutil
    import subprocess

    from veles.simd_tpu_torch.utils import devtrace as dt

    if shutil.which("gcc") is None or not os.path.exists(CUPTI_HEADER):
        pytest.skip(f"needs gcc and {CUPTI_HEADER}")
    text = open(CUPTI_HEADER).read()
    newest = {kind: re.findall(rf"^\}} (CUpti_Activity{name}\d+);", text,
                               re.M)[-1]
              for kind, name in (("kernel", "Kernel"), ("memcpy", "Memcpy"),
                                 ("memset", "Memset"))}
    lines = [f'printf("{kind} {field} %zu\\n", '
             f"offsetof({newest[kind]}, {field}));"
             for kind, fields in dt.OFFSETS.items() for field in fields]
    src = tmp_path / "offsets.c"
    src.write_text("#include <stdio.h>\n#include <stddef.h>\n"
                   "#include <cupti_activity.h>\nint main(void) {\n"
                   + "\n".join(lines) + "\nreturn 0; }\n")
    exe = tmp_path / "offsets"
    subprocess.run(["gcc", f"-I{os.path.dirname(CUPTI_HEADER)}", str(src),
                    "-o", str(exe)], check=True, timeout=120)
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    got = {}
    for line in out.split("\n"):
        if line:
            kind, field, off = line.split()
            got.setdefault(kind, {})[field] = int(off)
    assert got == dt.OFFSETS


def test_devtrace_reads_each_launch_and_copy():
    # one record a launch and a copy, named as torch.profiler names
    # them, each kernel's device time within its chained event time
    from veles.simd_tpu_torch.utils import devtrace as dt

    a = torch.randn(2048, 2048, device="cuda")
    host = torch.randn(1 << 20)

    def body():
        for _ in range(4):
            a @ a
        host.to("cuda")

    dt.trace(body)
    records, _ = dt.trace(body)
    copies = [r for r in records if r.name.startswith("Memcpy")]
    kernels = [r for r in records if not r.name.startswith("Mem")]
    assert len(kernels) == 4 and len({r.name for r in kernels}) == 1
    assert [r.name for r in copies] == ["Memcpy HtoD (Pageable -> Device)"]
    event_ms = bm.device_time_ms(lambda: a @ a, iters=20)
    busy_ms = float(np.median([r.ns for r in kernels])) / 1e6
    assert 0.5 * event_ms <= busy_ms <= 1.05 * event_ms


def test_chained_timer_is_in_seconds_on_the_card():
    # utils.benchmark keeps the JAX units: device_time_chained and
    # device_time in seconds, device_time_ms in milliseconds, each over
    # the same 2048^3 product (its kernel outlasts its dispatch)
    a = torch.randn(2048, 2048, device="cuda")
    s = bm.device_time_chained(lambda v: bm.rms_normalize(v @ a), a)
    burst_s = bm.device_time(lambda: a @ a)
    ms = bm.device_time_ms(lambda: a @ a, iters=20)
    assert 1e-5 < s < 1e-2 and 1e-5 < burst_s < 1e-2
    assert 0.5 < ms / (s * 1e3) < 2.0, (ms, s)


def _port_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from tools import tpu_smoke_torch

    return tpu_smoke_torch


@pytest.mark.parametrize("family", ["arithmetic", "mathfun", "matrix",
                                    "convolve", "convolve2d",
                                    "streaming", "correlate",
                                    "synthesis", "wavelet", "spectral",
                                    "resample", "iir", "filters",
                                    "waveforms", "normalize",
                                    "detect_peaks", "pallas1d",
                                    "parallel", "serve", "pallas2d"])
def test_port_smoke_family_passes_on_the_card(family):
    smoke = _port_smoke()
    assert family in dict(smoke.FAMILIES)
    lines = []
    assert smoke.run_smoke(emit=lines.append, families=[family]), lines
    assert len(lines) == 1 and lines[0].endswith(" ok"), lines


# ---------------------------------------------------------------------------
# the benchmark generator and the chaos campaigns on the card
# ---------------------------------------------------------------------------

def _tools_path():
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    for p in (str(root), str(root / "tools")):
        if p not in sys.path:
            sys.path.insert(0, p)
    return root


@pytest.mark.parametrize("kernel", ["overlap_save", "filter_bank",
                                    "cascade_bank", "stft", "filter_2d"])
def test_suite_kernel_rows_launch_their_kernels(kernel):
    _tools_path()
    import benchmark_suite_torch as bs

    rng = np.random.RandomState(61)
    if kernel == "overlap_save":
        rows = bs.section_convolve(rng, ((1 << 20, 2047),))
        assert rows[0]["launches"] == {"overlap_save": 2}
        assert rows[0]["route"] == "cuda_fused"
    elif kernel == "filter_bank":
        rows = (bs.section_convolve_batched(rng, 256, 4096, 129)
                + bs.section_dwt(rng, 64, 512, orders=(8,)))
        for row in rows:
            assert row["launches"].get("filter_bank", 0) >= 1, row
    elif kernel == "cascade_bank":
        fused = bs.section_cascade(rng, 512, 4096)[0]
        assert fused["launches"] == {"cascade_bank": 1}
    elif kernel == "stft":
        rows = bs.section_stft(rng, 1 << 20)
        row = rows[0]
        if row["route"] == "cuda_fused":
            assert row["launches"] == {"stft": 1}
        else:
            assert "stft" not in row["launches"]
    else:
        rows = bs.section_conv2d(rng, 8, 512, (9,), (64, 128, 5))
        for row in rows:
            assert row["route"] == "direct"
            assert row["launches"] == {"filter_2d": 1}, row
    for row in rows if kernel != "cascade_bank" else [fused]:
        if "launches" in row:       # not the conv-roofline row
            assert row["rel_err"] is not None and row["busy_ms"] > 0


def test_chaos_replicas_subprocess_smoke_is_green_on_the_card(tmp_path):
    import json
    import subprocess
    import sys

    root = _tools_path()
    env = dict(os.environ, VELES_SIMD_FAULT_BACKOFF="0")
    env.pop("VELES_SIMD_PLATFORM", None)
    out = subprocess.run(
        [sys.executable, str(root / "tools" / "chaos_torch.py"),
         "--replicas", "--spawn", "subprocess", "--smoke"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    entries = json.loads(
        (tmp_path / "REPLICA_RPC_DETAILS_torch.json").read_text())
    tail = entries[-1]
    assert tail["spawn"] == "subprocess"
    assert len(tail["replica_invariants"]) == 31
    assert all(tail["replica_invariants"].values())


def test_chaos_degraded_answers_match_the_float64_oracle(monkeypatch):
    _tools_path()
    import chaos_torch

    from veles.simd_tpu_torch import obs, serve
    from veles.simd_tpu_torch import parallel as par
    from veles.simd_tpu_torch.runtime import breaker, faults

    monkeypatch.setenv("VELES_SIMD_FAULT_BACKOFF", "0")
    r = np.random.RandomState(62)
    obs.enable()
    breaker.reset()
    faults.set_fault_plan(
        f"serve.dispatch@{chaos_torch.POISON_OP}:device_lost:9999,"
        "parallel.sharded_matmul:device_lost:9999")
    try:
        items = chaos_torch._poison_requests(r, 6, 60000.0)
        with serve.Server(max_batch=4, max_wait_ms=5.0) as srv:
            tickets = [srv.submit(req) for _, req in items]
            answers = [t.result(timeout=120.0) for t in tickets]
        mesh = par.make_mesh({"sp": 8})
        a = r.randn(32, 64).astype(np.float32)
        b = r.randn(64, 16).astype(np.float32)
        got = par.sharded_matmul(a, b, mesh, axis="sp").cpu().numpy()
        assert obs.counter_value("mesh_degrade", op="sharded_matmul") >= 1
    finally:
        faults.set_fault_plan(None)
        faults.reset_fault_history()
        breaker.reset()
        obs.reset()
    assert {t.status for t in tickets} == {"degraded"}
    for (_, req), y in zip(items, answers):
        want = iir.sosfilt_na(req.params["sos"],
                              req.x.astype(np.float64))
        assert _rel(y, want) <= 2e-5
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert _rel(got, want) <= 2e-3


# ---------------------------------------------------------------------------
# the examples and the tuning and profiling tools on the card
# ---------------------------------------------------------------------------

EXAMPLES = ("matched_filter", "sensor_pipeline", "image_filter",
            "wavelet_denoise", "wavelet_multires", "spectral_zoom",
            "kaiser_design", "sharded_longsignal")


def _script(*parts):
    import importlib.util

    path = _tools_path().joinpath(*parts)
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example(name):
    return _script("examples", f"{name}_torch.py")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_checks_hold_on_the_card(name):
    # each example at the JAX example's sizes: every check holds, the
    # 2D examples' calls reach the 2D kernel, and the streaming ones
    # time their blocks on the device
    with ck.count_launches() as launches:
        res = _example(name).run(emit=lambda line: None)
        torch.cuda.synchronize()
    assert all(res["checks"].values()), res["checks"]
    if name in ("matched_filter", "sensor_pipeline"):
        assert res["busy_ms_a_block"] > 0
        assert res["fused_blocks_s"] > 0 and res["unfused_blocks_s"] > 0
    if name == "image_filter":
        assert res["blur_and_edges"]["launches"]["blur"] == {"filter_2d": 1}
        assert res["template"]["launches"] == {"filter_2d": 1}
        assert launches == {"filter_2d": 4}


def test_multichip_rows_hold_on_the_card(tmp_path):
    _tools_path()
    import bench_multichip_torch as bmc

    entries = bmc.run_bench(8, str(tmp_path / "m.json"), quick=True,
                            emit=lambda line: None)
    rows, tail = entries[:-1], entries[-1]
    assert len(rows) == 3 and not any("flagged" in r for r in rows)
    assert tail["device"] == "cuda:0" and tail["distinct_cards"] == 1
    for r in rows:
        assert all(b is not None and b > 0 for b in r["busy_ms"].values())


def test_tune_conv2d_runs_the_2d_kernel_on_the_card():
    _tools_path()
    import tune_conv2d_torch as tc2

    results = tc2.sweep([(128, 128)], [(3, 3), (33, 33)], [1, 8],
                        emit=lambda line: None)
    for (rows, n0, n1, k0, k1), cell in results.items():
        assert cell["winner"] is not None
        if k0 == 3:
            c = cell["cands"]["cuda_direct"]
            assert c["ok"] and c["launches"] == {"filter_2d": 1}
            assert c["busy_ms"] > 0
        else:
            assert "cuda_direct" not in cell["cands"]
        assert all(c["ok"] for c in cell["cands"].values())


def test_profile_overlap_save_routes_on_the_card():
    _tools_path()
    import profile_overlap_save_torch as pos

    rows = {r["name"]: r for r in pos.profile(1 << 20, 2047,
                                              emit=lambda line: None)}
    assert rows["cuda_fused"]["launches"] == {"overlap_save": 2}
    for r in rows.values():
        assert r["rel_err"] <= pos.TOL
        assert r["busy_ms"] >= r["least_work_bound_ms"] > 0


# ---------------------------------------------------------------------------
# the flagship step and its training step (graft_entry_torch.py)
# ---------------------------------------------------------------------------

def _graft_entry():
    return _script("graft_entry_torch.py")


def _f64(params):
    return {k: v.detach().cpu().double() for k, v in params.items()}


def _step_inputs(ge):
    _, (params, x) = ge.entry()
    target = _t(np.random.RandomState(7).randn(x.shape[0], 64))
    return params, x, target


def test_graft_entry_forward_and_train_step_against_float64():
    # the forward and one SGD step on the card, each against a float64
    # CPU run from the same inputs; the peak mask exact wherever both
    # neighbour differences clear 1e-5 of max|filt|; no csrc kernel
    ge = _graft_entry()
    params, x, target = _step_inputs(ge)
    assert x.device.type == "cuda"
    p64, x64, t64 = _f64(params), x.cpu().double(), target.cpu().double()
    with ck.count_launches() as launches:
        feats, mask = ge._pipeline(params, x)
        loss, new = ge.train_step(params, x, target)
        torch.cuda.synchronize()
    assert not launches
    feats64, mask64 = ge._pipeline(p64, x64)
    assert _rel(feats.cpu(), feats64) <= 1e-4
    filt = ge._filtered(p64["filter"], x64)
    d = torch.minimum((filt[..., 1:-1] - filt[..., :-2]).abs(),
                      (filt[..., 1:-1] - filt[..., 2:]).abs())
    sure = d >= 1e-5 * filt.abs().max()
    differ = mask.cpu()[..., 1:-1] != mask64[..., 1:-1]
    assert not bool((differ & sure).any())
    assert not bool(mask.cpu()[..., [0, -1]].any())
    loss64, new64 = ge.train_step(p64, x64, t64)
    assert abs(float(loss) - float(loss64)) <= 1e-4 * float(loss64)
    for k in new64:
        assert new[k].device.type == "cuda"
        assert _rel(new[k].cpu(), new64[k]) <= 1e-4


def test_graft_entry_sharded_step_equals_the_card_step():
    # dp 2 x sp 2 x tp 2 over 8 shards of cuda:0 at full width
    from veles.simd_tpu_torch import parallel as par

    ge = _graft_entry()
    params, x, target = _step_inputs(ge)
    mesh = par.make_mesh({"dp": 2, "sp": 2, "tp": 2},
                         devices=["cuda:0"] * 8)
    loss, new = ge.sharded_train_step(params, x, target, mesh)
    loss1, new1 = ge.train_step(params, x, target)
    assert abs(float(loss) - float(loss1)) <= TOL * float(loss1)
    for k in new1:
        assert new[k].device == torch.device("cuda", 0)
        assert _rel(new[k].cpu(), new1[k].cpu()) <= TOL


def test_graft_entry_dryrun_on_eight_shards_of_the_card(capsys):
    ge = _graft_entry()
    loss = ge.dryrun_multichip(8)
    assert np.isfinite(loss)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == (f"dryrun_multichip: mesh dp=2 sp=2 tp=2 "
                    f"loss={loss:.4f} ok")


@pytest.mark.parametrize("key", ["daub8", "sym8", "coif6"])
def test_regenerated_filters_run_through_k2(key, tmp_path):
    # chip_smoke's devtools check: the generator's derived row for the
    # order, a 512 x 4096 periodic DWT with it through K2 (one launch),
    # within 1e-6 of max|y| of the committed filter's DWT (K2 too) and
    # within 1e-4 of float64
    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.ops import wavelet_coeffs as wc

    _tools_path()
    import gen_wavelet_tables_torch as gen

    out = tmp_path / "derived.npz"
    assert gen.main(["--orders", key, "--derived", "--out", str(out),
                     "--reference", str(tmp_path)]) == 0
    lo64 = gen.load_table(str(out))[key]
    family, order = key.rstrip("0123456789"), int(key[-1])
    hi64 = wc.qmf_highpass(lo64)
    r = np.random.RandomState(order)
    x_np = r.randn(512, 4096).astype(np.float32)
    x = _t(x_np)
    taps = _t(np.stack([hi64, lo64]))
    with ck.count_launches() as launches:
        got = ck.filter_bank_cuda(
            wv._extend(x, "periodic", order).contiguous(), taps, 2, 1, 2048)
        torch.cuda.synchronize()
    assert launches == {"filter_bank": 1}
    with ck.count_launches() as committed:
        want = wv.wavelet_apply(family, order, "periodic", x)
        torch.cuda.synchronize()
    assert committed == {"filter_bank": 1}
    got = np.stack([g.cpu().numpy() for g in got])
    assert _rel(got, np.stack([w.cpu().numpy() for w in want])) <= 1e-6
    ext = np.concatenate([x_np, x_np[:, :order]], axis=1).astype(np.float64)
    win = np.lib.stride_tricks.sliding_window_view(
        ext, order, axis=1)[:, ::2][:, :2048]
    assert _rel(got, np.stack([win @ hi64, win @ lo64])) <= 1e-4
