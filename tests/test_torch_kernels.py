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
    ck.stft_cuda(torch.ones(2, 600), torch.ones(256, 258), 256, 128)
    assert ck.LAUNCHES == {"overlap_save": 0, "filter_bank": 0,
                           "cascade_bank": 0, "filter_2d": 0, "stft": 0}


@pytest.mark.parametrize("rows,launches", [
    (1, 1), (65535, 1), (65536, 2), (70000, 2), (3 * 65535 + 1, 4)])
def test_launch_count_follows_the_grid_row_limit(rows, launches):
    # the C entry points split rows into launches of at most 65535
    assert ck._launches(rows) == launches


def test_shared_memory_admission():
    # the overlap-save kernel's footprint does not grow with k
    assert all(ck.fits_smem_os(k) for k in (2, 256, 2047, 16384))
    # direct path: every filter the route admits fits
    assert all(ck.fits_smem_fb(1, k, 1, 1)
               for k in range(1, ck.DIRECT_MAX_H + 1))
    assert ck.fb_smem_bytes(1, 129, 1, 1) == 4 * (1793 + 130 + 1664)
    # a span too long for one block is refused
    assert not ck.fits_smem_fb(2, 64, 1, 1024)
    # cascade bank: slot table, channel starts, staged phases whose
    # pitch puts a warp's deinterleaving stores on 32 banks
    assert ck._cb_pitch(8, 6) == 548 and 548 % 32 == 4
    assert ck._cb_pitch(4, 3) % 32 == 8 and ck._cb_pitch(3, 2) == 514
    assert ck.cb_smem_bytes(8, 6, 176, 8) == 8 * 176 + 4 * 9 + 4 * 8 * 548
    assert not ck.fits_smem_cb(64, 400, 512, 64)
    # 2D: tile plus halo (kernel rows padded to 4) and the taps
    assert ck.f2d_smem_bytes(7, 7) == 4 * ((32 + 8 - 1) * (64 + 6) + 49)
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


def _stft_basis(L):
    return torch.from_numpy(ck.stft_basis(L, jsp.hann_window(L)))


@pytest.mark.parametrize("L,hop", [(256, 128), (512, 128), (1024, 128),
                                   (384, 128)])
@pytest.mark.parametrize("rows,n", [(1, 3000), (3, 2100)])
def test_stft_matches_pallas(L, hop, rows, n):
    # n is no multiple of hop in the 3-row case (the trailing samples
    # short of a frame are dropped)
    x = np.random.RandomState(L + rows).randn(rows, n).astype(np.float32)
    want = np.asarray(pk.stft_pallas(x, L, hop, interpret=True))
    got = ck.stft_cuda(torch.from_numpy(x), _stft_basis(L), L, hop)
    assert got.dtype == torch.complex64
    assert got.shape == want.shape == (rows, 1 + (n - L) // hop,
                                       L // 2 + 1)
    assert np.max(np.abs(got.numpy() - want)) < \
        REL_TOL * np.max(np.abs(want))


def test_stft_leading_dims_and_plain():
    x = np.random.RandomState(8).randn(2, 3, 1000).astype(np.float32)
    got = ck.stft_cuda(torch.from_numpy(x), _stft_basis(256), 256, 128)
    assert got.shape == (2, 3, 6, 129)
    want = jsp.stft_na(x, 256, 128)
    assert np.max(np.abs(got.numpy() - want)) < \
        REL_TOL * np.max(np.abs(want))
    # the plain version is what the CPU wrapper returns
    plain = ck.stft_plain(torch.from_numpy(x), _stft_basis(256), 256, 128)
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
            ck.stft_cuda(torch.from_numpy(x), _stft_basis(L), L, hop)


def test_stft_wrapper_checks():
    # the 128-lane hop term is the route gate's, not the kernel's
    x = torch.ones(2, 600)
    assert ck.stft_cuda(x, _stft_basis(128), 128, 64).shape == (2, 8, 65)
    with pytest.raises(ValueError, match="basis shape"):
        ck.stft_cuda(x, torch.ones(256, 256), 256, 128)
    with pytest.raises(ValueError, match="float32"):
        ck.stft_cuda(x.double(), _stft_basis(256).double(), 256, 128)
    meta = torch.empty(2, 600, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ck.stft_cuda(meta, torch.empty(256, 258, device="meta"), 256, 128)


def test_stft_shared_memory_admission():
    # fixed 16.5 KB: a 64-sample chunk at a 68-float pitch and 64
    # basis columns, under the static 48 KB for every geometry
    assert ck.stft_smem_bytes() == 4 * 32 * (68 + 64) == 16896
    assert all(ck.fits_smem_stft(L, hop) for L, hop in
               ((256, 128), (4096, 128), (16384, 128), (3, 1)))
    assert not ck.fits_smem_stft(0, 128)
