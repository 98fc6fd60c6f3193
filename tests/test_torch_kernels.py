"""The port's kernel layer against the JAX package's Pallas kernels.

On the CPU the wrappers of ``veles.simd_tpu_torch.ops.cuda_kernels``
compute their kernels' plain versions; here those are held against
``overlap_save_pallas`` and ``filter_bank_pallas`` run in interpret
mode, on the same NumPy inputs.  Both sides are float32 with different
summation orders, so the tolerance is 1e-5 of max|y| (``test_pallas.py``
holds the Pallas kernel itself to 1e-5 against float64).  The kernels
themselves are compared with the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import pallas_kernels as pk
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
    assert ck.LAUNCHES == {"overlap_save": 0, "filter_bank": 0}


def test_shared_memory_admission():
    # the overlap-save kernel's footprint does not grow with k
    assert all(ck.fits_smem_os(k) for k in (2, 256, 2047, 16384))
    # direct path: every filter the route admits fits
    assert all(ck.fits_smem_fb(1, k, 1, 1)
               for k in range(1, ck.DIRECT_MAX_H + 1))
    assert ck.fb_smem_bytes(1, 129, 1, 1) == 4 * (1793 + 130 + 1664)
    # a span too long for one block is refused
    assert not ck.fits_smem_fb(2, 64, 1, 1024)
