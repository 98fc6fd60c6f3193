"""The frozen least-work arithmetic against the program's own copy, and
the benchmark's DWT count against the filter bank's per level."""

import math

import pytest

from cellbench import work
from veles.simd_tpu_torch.utils import benchmark as program


@pytest.mark.parametrize("rows,n,k", [
    (1, 1 << 20, 2047), (32, 1 << 20, 2047), (32, 1 << 20, 129),
    (4, 1000, 3), (7, 50000, 16384)])
def test_conv_work_is_the_programs(rows, n, k):
    assert work.conv_work(rows, n, k) == program.conv_work(rows, n, k)


@pytest.mark.parametrize("args", [
    (1, 1 << 20, 512, 128), (64, 4096, 256, 64), (3, 10000, 1024, 256)])
def test_stft_work_is_the_programs(args):
    assert work.stft_work(*args) == program.stft_work(*args)


@pytest.mark.parametrize("args", [
    (512, 4104, 2, 8, 2048), (16, 100, 1, 129, 228), (3, 77, 4, 5, 30)])
def test_filter_bank_work_is_the_programs(args):
    assert work.filter_bank_work(*args) == program.filter_bank_work(*args)


@pytest.mark.parametrize("flops,nbytes", [(2.83e9, 2.687e8), (1e12, 1e6),
                                          (0.0, 1.0)])
def test_bound_and_peaks_are_the_programs(flops, nbytes):
    assert work.fp32_bound(flops, nbytes) == program.fp32_bound(flops, nbytes)
    assert work.H100_FP32_TFLOPS == program.H100_FP32_TFLOPS
    assert work.H100_HBM_TBPS == program.H100_HBM_TBPS
    assert work.rfft_flops(4096) == program.rfft_flops(4096)


@pytest.mark.parametrize("rows,n,k,levels", [(16384, 4096, 8, 3),
                                             (4, 1 << 24, 8, 3),
                                             (5, 64, 4, 1)])
def test_dwt_work_counts_each_level_and_each_byte_once(rows, n, k, levels):
    flops, nbytes = work.dwt_work(rows, n, k, levels)
    per_level = sum(work.filter_bank_work(rows, n >> lvl, 2, k,
                                          n >> (lvl + 1))[0]
                    for lvl in range(levels))
    assert flops == per_level
    # the input once, every band once (n samples a row), both filters
    assert nbytes == 4.0 * (2 * rows * n + 2 * k)
    assert math.isclose(work.fp32_bound(flops, nbytes)[0],
                        nbytes / 3.35e9)
