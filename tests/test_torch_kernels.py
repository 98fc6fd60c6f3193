"""The port's kernel layer against the JAX package's Pallas kernels.

On the CPU the wrappers of ``veles.simd_tpu_torch.ops.cuda_kernels``
compute their kernels' plain versions; here those are held against
``overlap_save_pallas``, ``filter_bank_pallas``, ``cascade_bank_pallas``,
``filter_2d_pallas`` and ``stft_pallas`` run in interpret mode, on the
same NumPy inputs.  Both sides are float32 with different
summation orders, so the tolerance is 1e-5 of max|y| (``test_pallas.py``
holds the Pallas kernel itself to 1e-5 against float64).  The kernels
themselves are compared with the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import pallas_kernels as pk
from veles.simd_tpu.ops import spectral as jsp
from veles.simd_tpu.ops import wavelet as jw
from veles.simd_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

REL_TOL = 1e-5


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("n,k,step", [
    (5000, 257, 256),
    (4096, 511, 256),
    (2048, 300, 256),
    (1000, 129, 128),
    (1537, 513, 512),
    (900, 2, 256),
    (6000, 2047, 512),
])
def test_overlap_save_matches_pallas(n, k, step):
    r = np.random.RandomState(n + k)
    x = r.randn(n).astype(np.float32)
    h = r.randn(k).astype(np.float32)
    want = np.asarray(pk.overlap_save_pallas(x, h, step=step,
                                             interpret=True))
    got = ck.overlap_save_cuda(torch.from_numpy(x), torch.from_numpy(h))
    assert _rel(got.numpy(), want) < REL_TOL


def test_overlap_save_batched_rows_restart():
    r = np.random.RandomState(3)
    x = r.randn(3, 4000).astype(np.float32)
    h = r.randn(301).astype(np.float32)
    want = np.asarray(pk.overlap_save_pallas(x, h, interpret=True))
    got = ck.overlap_save_cuda(torch.from_numpy(x), torch.from_numpy(h))
    assert got.shape == (3, 4300)
    assert _rel(got.numpy(), want) < REL_TOL
    # each row sees zero history, not the previous row's tail
    alone = ck.overlap_save_cuda(torch.from_numpy(x[1]),
                                 torch.from_numpy(h))
    np.testing.assert_array_equal(got[1].numpy(), alone.numpy())


@pytest.mark.parametrize("channels,stride,dilation,order,n_out", [
    (1, 1, 1, 129, 600),
    (1, 1, 1, 17, 58),
    (2, 2, 1, 8, 100),
    (2, 1, 4, 8, 120),
])
def test_filter_bank_matches_pallas(channels, stride, dilation, order,
                                    n_out):
    r = np.random.RandomState(order + stride + 7 * dilation)
    need = (n_out - 1) * stride + (order - 1) * dilation + 1
    x_ext = r.randn(9, need + 3).astype(np.float32)
    f = r.randn(channels, order).astype(np.float32)
    want = pk.filter_bank_pallas(x_ext, f, stride, dilation, n_out,
                                 interpret=True)
    got = ck.filter_bank_cuda(torch.from_numpy(x_ext), torch.from_numpy(f),
                              stride, dilation, n_out)
    assert len(got) == len(want) == channels
    for g, w in zip(got, want):
        assert g.shape == (9, n_out)
        assert _rel(g.numpy(), np.asarray(w)) < REL_TOL


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("k", [2, 8, 129, 256])
@pytest.mark.parametrize("channels", [1, 2])
def test_filter_bank_padded_matches_pallas(channels, k, reverse):
    # the zero halo read by the wrapper (pad_left = k - 1 on each side)
    # and the reversed taps: the Pallas kernel on np.pad(x) with the
    # taps flipped by hand, leading batch dims riding along
    r = np.random.RandomState(k + channels)
    n = 300
    x = r.randn(2, 3, n).astype(np.float32)
    f = r.randn(channels, k).astype(np.float32)
    x_ext = np.pad(x, ((0, 0), (0, 0), (k - 1, k - 1)))
    want = pk.filter_bank_pallas(x_ext, f[:, ::-1] if reverse else f, 1,
                                 1, n + k - 1, interpret=True)
    got = ck.filter_bank_cuda(torch.from_numpy(x), torch.from_numpy(f), 1,
                              1, n + k - 1, pad_left=k - 1,
                              reverse_taps=reverse)
    assert len(got) == len(want) == channels
    for g, w in zip(got, want):
        assert g.shape == (2, 3, n + k - 1)
        assert _rel(g.numpy(), np.asarray(w)) < REL_TOL


def test_filter_bank_leading_batch_dims():
    r = np.random.RandomState(5)
    x_ext = r.randn(2, 3, 40).astype(np.float32)
    f = r.randn(2, 4).astype(np.float32)
    want = pk.filter_bank_pallas(x_ext, f, 2, 1, 18, interpret=True)
    got = ck.filter_bank_cuda(torch.from_numpy(x_ext), torch.from_numpy(f),
                              2, 1, 18)
    assert got[0].shape == (2, 3, 18)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) < REL_TOL


@pytest.mark.parametrize("call,match", [
    (lambda m: m.overlap_save(np.ones(100, np.float32),
                              np.ones(1, np.float32)), ">= 2 taps"),
    (lambda m: m.overlap_save(np.ones(100, np.float32),
                              np.ones((2, 9), np.float32)),
     "taps must be 1D"),
    (lambda m: m.filter_bank(np.ones((3, 64), np.float32),
                             np.zeros(8, np.float32), 1, 1, 32),
     "channels, order"),
    (lambda m: m.filter_bank(np.ones((3, 10), np.float32),
                             np.ones((2, 8), np.float32), 2, 1, 32),
     "x_ext too short"),
])
@pytest.mark.parametrize("side", ["jax", "torch"])
def test_contract_errors_match(call, match, side):
    class Jax:
        @staticmethod
        def overlap_save(x, h):
            return pk.overlap_save_pallas(x, h, interpret=True)

        @staticmethod
        def filter_bank(x, f, s, d, n):
            return pk.filter_bank_pallas(x, f, s, d, n, interpret=True)

    class Torch:
        @staticmethod
        def overlap_save(x, h):
            return ck.overlap_save_cuda(torch.from_numpy(x),
                                        torch.from_numpy(h))

        @staticmethod
        def filter_bank(x, f, s, d, n):
            return ck.filter_bank_cuda(torch.from_numpy(x),
                                       torch.from_numpy(f), s, d, n)

    with pytest.raises(ValueError, match=match):
        call(Jax if side == "jax" else Torch)


def test_wrappers_refuse_non_float32_and_other_devices():
    with pytest.raises(ValueError, match="float32"):
        ck.overlap_save_cuda(torch.ones(100, dtype=torch.float64),
                             torch.ones(9, dtype=torch.float64))
    meta = torch.empty(100, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ck.overlap_save_cuda(meta, torch.empty(9, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        ck.filter_bank_cuda(meta, torch.empty(1, 9, device="meta"),
                            1, 1, 92)


def test_cpu_path_launches_nothing():
    ck.reset_launches()
    ck.overlap_save_cuda(torch.ones(300), torch.ones(5))
    ck.filter_bank_cuda(torch.ones(4, 30), torch.ones(1, 5), 1, 1, 26)
    ck.cascade_bank_cuda(torch.ones(2, 40), [np.ones(2)],
                         (((0, 0), (1, 1)),), 4, 8)
    ck.filter_2d_cuda(torch.ones(2, 9, 9), torch.ones(3, 2), 7, 8)
    ck.stft_cuda(torch.ones(2, 600), torch.ones(256), 256, 128)
    assert ck.LAUNCHES == {"overlap_save": 0, "filter_bank": 0,
                           "cascade_bank": 0, "filter_2d": 0, "stft": 0}


@pytest.mark.parametrize("rows,launches", [
    (1, 1), (65535, 1), (65536, 2), (70000, 2), (3 * 65535 + 1, 4)])
def test_launch_count_follows_the_grid_row_limit(rows, launches):
    # the C entry points split rows into launches of at most 65535
    assert ck._launches(rows) == launches


def test_shared_memory_admission():
    # the overlap-save kernel admits the route's filters
    assert all(ck.fits_smem_os(k) for k in (2, 256, 2047, 16384))
    # direct path: every filter the route admits fits
    assert all(ck.fits_smem_fb(1, k, 1, 1)
               for k in range(1, ck.DIRECT_MAX_H + 1))
    # mma at 129 taps: hi and lo B blocks for 20 k-steps and 3 zero
    # steps, two raw spans of 2048 - 32 + 8 * 20 samples and the hi and
    # lo parts of one, the output tile; ffma: span, taps padded to 13,
    # output tile
    assert ck.fb_smem_bytes(1, 129, 1, 1, "mma") == \
        4 * 2 * 23 * 64 + 16 * 2176 + 4 * 2048
    assert ck.fb_smem_bytes(1, 129, 1, 1, "ffma") == \
        4 * (1793 + 130 + 1664)
    # no variant: the one fb_variant picks
    assert ck.fb_smem_bytes(1, 129, 1, 1) == ck.fb_smem_bytes(
        1, 129, 1, 1, ck.fb_variant(129, 1, 1))
    # a span too long for one block is refused
    assert not ck.fits_smem_fb(2, 64, 1, 1024)
    # cascade bank: frames of 4, 8, 16 or 32 phases, min(4, 32 / that)
    # outputs a lane; the dense tap table (NSP x NSP a pass and offset)
    # and a word of channel bits a pass and offset (rounded to 4), then
    # two staged spans a warp, four warps, each span the tile's frames,
    # max_off more and one prefetched, rounded to 4 floats, padded 4 in
    # 32
    assert [ck.cb_phase_pad(n) for n in (1, 3, 4, 5, 8, 9, 16, 32, 33)] \
        == [4, 4, 4, 8, 8, 16, 16, 32, 0]
    assert [ck.cb_tile(n) for n in (2, 8, 16, 32, 64)] == [128, 128, 64,
                                                            32, 0]
    assert ck.cb_smem_bytes(8, 6, 8) == 4 * (7 * 64 + 8
                                             + 4 * 2 * (1080 + 4 * 34))
    assert ck.cb_smem_bytes(3, 2, 2) == 4 * (3 * 16 + 4
                                             + 4 * 2 * (396 + 4 * 13))
    assert ck.fits_smem_cb(8, 355, 8) and not ck.fits_smem_cb(8, 356, 8)
    assert not ck.fits_smem_cb(64, 400, 1) and not ck.fits_smem_cb(33, 0, 1)
    # 2D: the taps (rows padded to 4) and two stages of the tile plus
    # its halo (columns padded to 4)
    assert ck.f2d_smem_bytes(7, 7) == 4 * (7 * 8 + 2 * (64 + 6) * (64 + 8))
    assert ck.fits_smem_f2d(256, 1) and not ck.fits_smem_f2d(2048, 1)


def _cascade_case(type, order, levels, n, rows=8):
    gs, g_lo = jw._composed_cascade_filters(type, order, levels)
    plans, taps, _ = jw._cascade_plan(gs, g_lo, levels)
    ns = 1 << levels
    x = np.random.RandomState(n + levels).randn(rows, n).astype(np.float32)
    x_ext = np.concatenate([x, x[:, :len(g_lo) - 1 + ns]], axis=-1)
    return x_ext, taps, plans, ns, n // ns


@pytest.mark.parametrize("type,order,levels,n", [
    ("daub", 8, 2, 256), ("daub", 8, 3, 512), ("sym", 8, 2, 256),
    ("daub", 4, 4, 1024), ("coif", 12, 2, 512)])
def test_cascade_bank_matches_pallas(type, order, levels, n):
    x_ext, taps, plans, ns, n_out = _cascade_case(type, order, levels, n)
    want = pk.cascade_bank_pallas(x_ext, taps, plans, ns, n_out,
                                  interpret=True)
    got = ck.cascade_bank_cuda(torch.from_numpy(x_ext), taps, plans, ns,
                               n_out)
    assert len(got) == len(want) == len(plans)
    for g, w in zip(got, want):
        assert g.shape == (8, n_out)
        assert _rel(g.numpy(), np.asarray(w)) < REL_TOL
    # taps as tensors, plans as lists, leading batch dims: same result
    got2 = ck.cascade_bank_cuda(
        torch.from_numpy(x_ext).reshape(2, 4, -1),
        [torch.from_numpy(t) for t in taps],
        [list(plan) for plan in plans], ns, n_out)
    for g, g2 in zip(got, got2):
        np.testing.assert_array_equal(g.numpy(),
                                      g2.reshape(8, n_out).numpy())


def _pallas_fused(x, type, order, levels):
    """The JAX package's fused cascade by hand: ``cascade_bank_pallas``
    in interpret mode on the ``np.take``-extended input, each level's
    phases then interleaved as ``_fused_cascade`` does."""
    gs, g_lo = jw._composed_cascade_filters(type, order, levels)
    plans, taps, chans = jw._cascade_plan(gs, g_lo, levels)
    ns, n = 1 << levels, x.shape[-1]
    x_ext = np.take(x, np.arange(n + len(g_lo) - 1 + ns) % n, axis=-1)
    outs = pk.cascade_bank_pallas(x_ext, taps, plans, ns, n // ns,
                                  interpret=True)
    want = []
    for lvl in range(1, levels + 1):
        phases = [np.asarray(o) for o, (lv, _) in zip(outs, chans)
                  if lv == lvl]
        want.append(np.stack(phases, -1).reshape(
            x.shape[:-1] + (n >> lvl,)))
    want.append(np.asarray(outs[-1]))
    return plans, taps, want


@pytest.mark.parametrize("type,order,levels,n", [
    ("daub", 8, 2, 256), ("daub", 8, 3, 512), ("sym", 8, 2, 256),
    ("daub", 4, 4, 1024), ("coif", 12, 2, 512),
    # the wrap exceeds n: reach + 2^L samples past the end of 56 and 4
    ("daub", 8, 3, 56), ("daub", 2, 2, 4)])
def test_cascade_bank_periodic_matches_pallas(type, order, levels, n):
    # the periodic form (wrap read in place, natural-order levels)
    # against the JAX package's extend, kernel, interleave
    x = np.random.RandomState(n + levels).randn(8, n).astype(np.float32)
    plans, taps, want = _pallas_fused(x, type, order, levels)
    got = ck.cascade_bank_periodic_cuda(torch.from_numpy(x), taps, plans,
                                        levels)
    assert len(got) == len(want) == levels + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        assert _rel(g.numpy(), w) < REL_TOL
    # leading batch dims, taps as tensors, plans as lists: same result
    got2 = ck.cascade_bank_periodic_cuda(
        torch.from_numpy(x).reshape(2, 4, n),
        [torch.from_numpy(np.asarray(t)) for t in taps],
        [list(plan) for plan in plans], levels)
    for g, g2 in zip(got, got2):
        np.testing.assert_array_equal(g.numpy(),
                                      g2.reshape(g.shape).numpy())


@pytest.mark.parametrize("args,match", [
    ((np.ones((2, 64)), 1), "2..4 levels"),
    ((np.ones((2, 64)), 5), "2..4 levels"),
    ((np.ones((2, 60)), 3), "multiple of 8"),
    ((np.ones((2, 64)), 3, 1), "8 channels"),
])
def test_cascade_bank_periodic_errors(args, match):
    x, levels = torch.as_tensor(args[0], dtype=torch.float32), args[1]
    gs, g_lo = jw._composed_cascade_filters("daub", 4, 3)
    plans, taps, _ = jw._cascade_plan(gs, g_lo, 3)
    drop = args[2] if len(args) > 2 else 0
    with pytest.raises(ValueError, match=match):
        ck.cascade_bank_periodic_cuda(x, taps[drop:], plans[drop:], levels)


@pytest.mark.parametrize("x_shape,k_shape,n_out", [
    ((2, 12, 14), (3, 4), (10, 11)),
    ((6, 8), (2, 2), (5, 7)),
    ((20, 10, 12), (3, 3), (8, 10)),
    ((2, 3, 9, 300), (1, 256), (9, 45)),
    ((2, 260, 7), (256, 1), (5, 7)),
    ((3, 21, 22), (6, 5), (16, 18)),
])
def test_filter_2d_matches_pallas(x_shape, k_shape, n_out):
    r = np.random.RandomState(sum(x_shape) + sum(k_shape))
    x_ext = r.randn(*x_shape).astype(np.float32)
    k = r.randn(*k_shape).astype(np.float32)
    want = np.asarray(pk.filter_2d_pallas(x_ext, k, *n_out,
                                          interpret=True))
    got = ck.filter_2d_cuda(torch.from_numpy(x_ext), torch.from_numpy(k),
                            *n_out)
    assert got.shape == want.shape == x_shape[:-2] + n_out
    assert _rel(got.numpy(), want) < REL_TOL


@pytest.mark.parametrize("x_shape,k_shape", [
    ((2, 12, 14), (3, 4)), ((6, 8), (2, 2)), ((2, 3, 9, 30), (1, 16)),
    ((2, 20, 7), (16, 1)), ((3, 10, 11), (5, 5)), ((4, 5, 77), (16, 16)),
])
def test_filter_2d_padded_matches_pallas(x_shape, k_shape):
    # pad = (k0 - 1, k1 - 1) and reverse_taps: the full convolution,
    # against the Pallas kernel on the padded input with the flipped
    # kernel
    r = np.random.RandomState(sum(x_shape) * 3 + sum(k_shape))
    x = r.randn(*x_shape).astype(np.float32)
    k = r.randn(*k_shape).astype(np.float32)
    k0, k1 = k_shape
    pad = [(0, 0)] * (x.ndim - 2) + [(k0 - 1, k0 - 1), (k1 - 1, k1 - 1)]
    n_out = (x_shape[-2] + k0 - 1, x_shape[-1] + k1 - 1)
    want = np.asarray(pk.filter_2d_pallas(
        np.pad(x, pad), np.ascontiguousarray(k[::-1, ::-1]), *n_out,
        interpret=True))
    got = ck.filter_2d_cuda(torch.from_numpy(x), torch.from_numpy(k),
                            *n_out, pad=(k0 - 1, k1 - 1), reverse_taps=True)
    assert got.shape == want.shape == x_shape[:-2] + n_out
    assert _rel(got.numpy(), want) < REL_TOL
    # no flip: the correlation of the padded input
    want = np.asarray(pk.filter_2d_pallas(np.pad(x, pad), k, *n_out,
                                          interpret=True))
    got = ck.filter_2d_cuda(torch.from_numpy(x), torch.from_numpy(k),
                            *n_out, pad=(k0 - 1, k1 - 1))
    assert _rel(got.numpy(), want) < REL_TOL


@pytest.mark.parametrize("call,match", [
    (lambda: ck.filter_bank_cuda(torch.ones(2, 50), torch.ones(1, 5), 1, 1,
                                 54, pad_left=-1), "pad_left must be >= 0"),
    # 50 + 2 * 2 = 54 samples, the full output of 5 taps needs 58
    (lambda: ck.filter_bank_cuda(torch.ones(2, 50), torch.ones(1, 5), 1, 1,
                                 54, pad_left=2), "x_ext too short"),
    (lambda: ck.filter_bank_cuda(torch.ones(2, 50), torch.ones(2, 5), 2, 1,
                                 20, variant="mma"), "stride 1, dilation 1"),
    (lambda: ck.filter_bank_cuda(torch.ones(2, 50), torch.ones(1, 5), 1, 1,
                                 20, variant="wgmma"), "variant"),
    (lambda: ck.filter_2d_cuda(torch.ones(9, 9), torch.ones(3, 3), 11, 11,
                               pad=(-1, 1)), "pad must be >= 0"),
    # (9 + 2, 9 + 2) padded against the (13, 13) a full 3 x 3 output needs
    (lambda: ck.filter_2d_cuda(torch.ones(9, 9), torch.ones(3, 3), 11, 11,
                               pad=(1, 1)), "x_ext too short"),
])
def test_padding_argument_errors(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_fb_variant_threshold_and_admission():
    # unit stride picks mma from FB_MMA_MIN_K taps on, ffma below it;
    # strided and dilated forms always ffma; every k <= DIRECT_MAX_H
    # fits either variant for up to three channels, every area <= 256
    # fits the 2D kernel
    for k in range(1, ck.DIRECT_MAX_H + 1):
        assert ck.fb_variant(k, 1, 1) == \
            ("mma" if k >= ck.FB_MMA_MIN_K else "ffma")
        assert ck.fb_variant(k, 2, 1) == ck.fb_variant(k, 1, 2) == "ffma"
        for c in (1, 2, 3):
            assert ck.fits_smem_fb(c, k, 1, 1)
            assert ck.fits_smem_fb(c, k, 1, 1, "mma")
            assert ck.fits_smem_fb(c, k, 1, 1, "ffma")
    assert all(ck.fits_smem_f2d(k0, k1)
               for k0 in range(1, ck.MAX_AREA_2D + 1)
               for k1 in range(1, ck.MAX_AREA_2D // k0 + 1))
    assert ck.f2d_smem_bytes(256, 1) == max(
        ck.f2d_smem_bytes(k0, ck.MAX_AREA_2D // k0)
        for k0 in range(1, ck.MAX_AREA_2D + 1))


def test_padded_plain_versions_in_float64():
    # the plain versions take float64 operands (the card's reference)
    r = np.random.RandomState(40)
    x = torch.from_numpy(r.randn(3, 40))
    f = torch.from_numpy(r.randn(1, 6))
    (y,) = ck.filter_bank_plain(x, f, 1, 1, 45, pad_left=5,
                                reverse_taps=True)
    assert y.dtype == torch.float64
    want = np.stack([np.convolve(row, f[0].numpy()) for row in x.numpy()])
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-12, atol=1e-12)
    x2 = torch.from_numpy(r.randn(2, 9, 8))
    k2 = torch.from_numpy(r.randn(3, 2))
    y2 = ck.filter_2d_plain(x2, k2, 11, 9, pad=(2, 1), reverse_taps=True)
    assert y2.dtype == torch.float64 and y2.shape == (2, 11, 9)
    want2 = np.zeros((2, 11, 9))
    for p in range(3):
        for q in range(2):
            want2[:, p:p + 9, q:q + 8] += k2[p, q].item() * x2.numpy()
    np.testing.assert_allclose(y2.numpy(), want2, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("call,match", [
    (lambda m: m.cascade(np.ones((2, 64), np.float32),
                         [np.ones(2), np.ones(1)], (((0, 0), (1, 0)),), 4,
                         8), "one tap vector per plan channel"),
    (lambda m: m.cascade(np.ones((2, 64), np.float32), [np.ones(0)],
                         ((),), 4, 8), ">= 1 slot"),
    (lambda m: m.cascade(np.ones((2, 64), np.float32), [np.ones(3)],
                         (((0, 0), (1, 0)),), 4, 8), "slot count"),
    (lambda m: m.cascade(np.ones((2, 64), np.float32), [np.ones(1)],
                         (((4, 0),),), 4, 8), "outside"),
    (lambda m: m.cascade(np.ones((2, 64), np.float32), [np.ones(1)],
                         (((1, -1),),), 4, 8), "outside"),
    (lambda m: m.cascade(np.ones((2, 33), np.float32), [np.ones(2)],
                         (((0, 0), (3, 1)),), 4, 8), "too short"),
    (lambda m: m.filter_2d(np.ones((4, 4), np.float32),
                           np.ones(3, np.float32), 2, 2), "kernel2d"),
    (lambda m: m.filter_2d(np.ones((4, 4), np.float32),
                           np.ones((3, 3), np.float32), 4, 4), "too short"),
    (lambda m: m.filter_2d(np.ones(9, np.float32),
                           np.ones((3, 3), np.float32), 2, 2), "n0_ext"),
])
@pytest.mark.parametrize("side", ["jax", "torch"])
def test_cascade_and_2d_contract_errors_match(call, match, side):
    class Jax:
        @staticmethod
        def cascade(x, taps, plans, ns, n_out):
            return pk.cascade_bank_pallas(x, taps, plans, ns, n_out,
                                          interpret=True)

        @staticmethod
        def filter_2d(x, k, n0, n1):
            return pk.filter_2d_pallas(x, k, n0, n1, interpret=True)

    class Torch:
        @staticmethod
        def cascade(x, taps, plans, ns, n_out):
            return ck.cascade_bank_cuda(torch.from_numpy(x), taps, plans,
                                        ns, n_out)

        @staticmethod
        def filter_2d(x, k, n0, n1):
            return ck.filter_2d_cuda(torch.from_numpy(x),
                                     torch.from_numpy(k), n0, n1)

    with pytest.raises(ValueError, match=match):
        call(Jax if side == "jax" else Torch)


def test_new_wrappers_refuse_other_devices():
    meta = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ck.cascade_bank_cuda(meta, [np.ones(1)], (((0, 0),),), 4, 8)
    with pytest.raises(ValueError, match="no kernel"):
        ck.filter_2d_cuda(torch.empty(9, 9, device="meta"),
                          torch.empty(2, 2, device="meta"), 8, 8)
    with pytest.raises(ValueError, match="float32"):
        ck.filter_2d_cuda(torch.ones(9, 9, dtype=torch.float64),
                          torch.ones(2, 2, dtype=torch.float64), 8, 8)


def _window(L):
    return torch.from_numpy(jsp.hann_window(L).astype(np.float32))


@pytest.mark.parametrize("L,hop", [(256, 128), (512, 128), (1024, 128),
                                   (384, 128), (640, 128)])
@pytest.mark.parametrize("rows,n", [(1, 3000), (3, 2100)])
def test_stft_matches_pallas(L, hop, rows, n):
    # n is no multiple of hop in the 3-row case (the trailing samples
    # short of a frame are dropped)
    x = np.random.RandomState(L + rows).randn(rows, n).astype(np.float32)
    want = np.asarray(pk.stft_pallas(x, L, hop, interpret=True))
    got = ck.stft_cuda(torch.from_numpy(x), _window(L), L, hop)
    assert got.dtype == torch.complex64
    assert got.shape == want.shape == (rows, 1 + (n - L) // hop,
                                       L // 2 + 1)
    assert np.max(np.abs(got.numpy() - want)) < \
        REL_TOL * np.max(np.abs(want))


def test_stft_leading_dims_and_plain():
    x = np.random.RandomState(8).randn(2, 3, 1000).astype(np.float32)
    got = ck.stft_cuda(torch.from_numpy(x), _window(256), 256, 128)
    assert got.shape == (2, 3, 6, 129)
    want = jsp.stft_na(x, 256, 128)
    assert np.max(np.abs(got.numpy() - want)) < \
        REL_TOL * np.max(np.abs(want))
    # the plain version is what the CPU wrapper returns
    plain = ck.stft_plain(torch.from_numpy(x), _window(256), 256, 128)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_stft_basis_is_the_pallas_basis():
    # the JAX kernel's blocks, padding columns dropped, columns
    # re-interleaved as (re, im) pairs: bit-equal
    for L, hop in ((256, 128), (384, 128), (1024, 128), (255, 85)):
        w = jsp.hann_window(L)
        blocks = pk._stft_basis_blocks(L, hop, w).reshape(L, -1)
        bins, half = L // 2 + 1, blocks.shape[1] // 2
        want = np.stack([blocks[:, :bins], blocks[:, half:half + bins]],
                        axis=-1).reshape(L, 2 * bins)
        np.testing.assert_array_equal(ck.stft_basis(L, w), want)


def test_stft_basis_built_in_row_blocks():
    # above 2^22 / bins rows the float64 build runs in blocks of rows:
    # the same values as the one-piece build
    L = 3000
    w = jsp.hann_window(L).astype(np.float64)[:, None]
    ang = 2.0 * np.pi * np.arange(L)[:, None] * np.arange(1501) / L
    want = np.stack([(w * np.cos(ang)).astype(np.float32),
                     (-w * np.sin(ang)).astype(np.float32)], axis=-1)
    np.testing.assert_array_equal(ck.stft_basis(L, w[:, 0]),
                                  want.reshape(L, 3002))


def test_stft_plain_window_forms_and_float64():
    x = np.random.RandomState(12).randn(2, 1500).astype(np.float32)
    w = jsp.hann_window(256)
    plain = ck.stft_plain(torch.from_numpy(x), torch.from_numpy(w), 256,
                          128)
    # a host window gives the same result, with no copy from a card
    np.testing.assert_array_equal(
        ck.stft_plain(torch.from_numpy(x), w, 256, 128).numpy(),
        plain.numpy())
    # float64 operands accumulate in float64: the float64 oracle up to
    # the float32 rounding of the basis
    p64 = ck.stft_plain(torch.from_numpy(x).double(), w, 256, 128)
    assert p64.dtype == torch.complex128
    ref = jsp.stft_na(x.astype(np.float64), 256, 128)
    assert np.max(np.abs(p64.numpy() - ref)) < 1e-6 * np.max(np.abs(ref))
    assert np.max(np.abs(plain.numpy() - ref)) < \
        REL_TOL * np.max(np.abs(ref))
    y64 = ck.overlap_save_plain(torch.from_numpy(x).double(),
                                torch.ones(5, dtype=torch.float64))
    assert y64.dtype == torch.float64
    np.testing.assert_allclose(
        y64.numpy(), np.stack([np.convolve(r, np.ones(5)) for r in x]),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("args,match", [
    ((1000, 256, 96), "hop [|] frame_length"),
    ((1000, 256, 256), "frame_length > hop"),
    ((200, 256, 128), "signal length 200 < frame_length 256"),
])
@pytest.mark.parametrize("side", ["jax", "torch"])
def test_stft_contract_errors_match(args, match, side):
    n, L, hop = args
    x = np.ones((2, n), np.float32)
    with pytest.raises(ValueError, match=match):
        if side == "jax":
            pk.stft_pallas(x, L, hop, interpret=True)
        else:
            ck.stft_cuda(torch.from_numpy(x), _window(L), L, hop)


def test_stft_wrapper_checks():
    # the 128-lane hop term is the route gate's, not the kernel's
    x = torch.ones(2, 600)
    assert ck.stft_cuda(x, _window(128), 128, 64).shape == (2, 8, 65)
    with pytest.raises(ValueError, match="window shape"):
        ck.stft_cuda(x, torch.ones(255), 256, 128)
    with pytest.raises(ValueError, match="float32"):
        ck.stft_cuda(x.double(), _window(256).double(), 256, 128)
    meta = torch.empty(2, 600, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ck.stft_cuda(meta, torch.empty(256, device="meta"), 256, 128)


def test_stft_shared_memory_admission():
    # a span of F frames and F padded FFT buffers: 16 frames of 256
    # complex values at 512/128, one frame of 8192 at 16384/128
    assert ck.stft_frames_per_block(512) == 16
    assert ck.stft_smem_bytes(512, 128) == \
        4 * (15 * 128 + 512) + 8 * 16 * (256 + 16 + 1) == 44672
    assert ck.stft_frames_per_block(16384) == 1
    assert ck.stft_smem_bytes(16384, 128) == \
        4 * 16384 + 8 * (8192 + 512 + 1) == 135176
    assert ck.stft_fft_length(512) == 256 and ck.stft_fft_length(255) == 255
    assert all(ck.fits_smem_stft(L, hop) for L, hop in
               ((256, 128), (4096, 128), (16384, 128), (3, 1)))
    assert not ck.fits_smem_stft(0, 128)
    # outside the contract, or too large for one block: refused
    assert not ck.fits_smem_stft(256, 96) and not ck.fits_smem_stft(256, 256)
    assert not ck.fits_smem_stft(32768, 128)


def test_stft_admission_covers_every_frame_up_to_16384():
    # every L <= 16384 with hop | L and L > hop: the largest hop needs
    # the most shared memory, hop 1 the longest span per frame count
    for L in range(2, 16385):
        p = next(f for f in range(2, L + 1) if L % f == 0)
        assert ck.fits_smem_stft(L, L // p), L
        assert ck.fits_smem_stft(L, 1), L
        assert ck.stft_frames_per_block(L) * ck.stft_fft_length(L) <= \
            512 * 32


@pytest.mark.parametrize("k,n,n_fft,step", [
    (2, 1 << 20, 8192, 8191), (256, 1 << 20, 8192, 7937),
    (2047, 1 << 20, 8192, 6146), (16384, 50000, 32768, 16385),
    # a short row takes the least segment that holds its whole output
    (2, 1, 4096, 4095), (256, 1000, 4096, 3841), (256, 4096, 8192, 7937),
    (2047, 2050, 4096, 2050), (2047, 2051, 8192, 6146),
    (16384, 1, 32768, 16385)])
def test_overlap_save_segment_choice(k, n, n_fft, step):
    # the least power of two >= 4096 and >= 2k that holds 8192 samples
    # or the row's output n + k - 1; step = N - k + 1
    assert ck.os_fft_length(k, n) == n_fft
    assert ck.os_step(k, n) == step
    assert ck.os_smem_bytes(n_fft) == 8 * (n_fft // 2 + n_fft // 32 + 1)
    assert ck.fits_smem_os(k)


def test_overlap_save_admission_covers_the_route():
    # every k in 2..16384 (OS_MIN_H..AUTO_OS_MATMUL_MAX_H on the route,
    # and the kernel's whole contract below it) fits one block at any
    # row length
    assert all(ck.fits_smem_os(k) for k in range(2, 16385))
    assert max(ck.os_smem_bytes(ck.os_fft_length(k, n))
               for k in range(2, 16385) for n in (1, 5000, 1 << 20)) \
        == 139272
    assert not ck.fits_smem_os(1) and not ck.fits_smem_os(16385)


@pytest.mark.parametrize("n", [4, 255, 512, 4096, 32768])
def test_fft_twiddles_match_numpy(n):
    # built in float64, rounded once to float32
    got = ck.fft_twiddles(n)
    assert got.dtype == np.float32 and got.shape == (n, 2)
    want = np.exp(-2j * np.pi * np.arange(n) / n)
    np.testing.assert_array_equal(got[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(got[:, 1], want.imag.astype(np.float32))
    assert np.max(np.abs(got[:, 0] + 1j * got[:, 1] - want)) < 1e-7
