"""The port's convolve/correlate slice against the JAX package.

The same NumPy inputs, made from a seed, go through
``veles.simd_tpu.ops.convolve``/``correlate`` (on the CPU platform the
root conftest pins) and through ``veles.simd_tpu_torch`` with
``device="cpu"``.  Outputs agree to 1e-5 of max|y| (both float32, with
different summation orders); handles, route choices and NumPy oracles
agree exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import convolve as jcv
from veles.simd_tpu.ops import correlate as jcr
from veles.simd_tpu.ops import pallas_kernels as jpk
from veles.simd_tpu_torch.ops import convolve as tcv
from veles.simd_tpu_torch.ops import correlate as tcr
from veles.simd_tpu_torch.ops import cuda_kernels as tck
from veles.simd_tpu_torch.utils import config as tconfig
from veles.simd_tpu_torch.utils import platform as tplatform

torch.set_num_threads(1)

REL_TOL = 1e-5
ALGOS = list(tcv.ConvolutionAlgorithm)


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


def _fields(handle):
    d = dataclasses.asdict(handle)
    d["algorithm"] = d["algorithm"].value
    return d


GRID = [(x, h) for x in (1, 7, 64, 500, 1000, 4096, 20000, 1 << 20)
        for h in (1, 2, 9, 63, 127, 255, 256, 2047, 3000, 20000)]


@pytest.mark.parametrize("reverse", [False, True])
def test_handles_agree_over_grid(reverse):
    for x, h in GRID:
        want = jcv.convolve_initialize(x, h, reverse=reverse)
        got = tcv.convolve_initialize(x, h, reverse=reverse)
        assert _fields(got) == _fields(want), (x, h)
        assert (tcv.select_algorithm(x, h).value
                == jcv.select_algorithm(x, h).value)


@pytest.mark.parametrize("algo", ALGOS)
def test_forced_handles_agree(algo):
    for x, h in [(5000, 7), (5000, 300), (100000, 2047), (70000, 20000)]:
        if algo is tcv.ConvolutionAlgorithm.OVERLAP_SAVE and \
                not h < x // 2:
            with pytest.raises(ValueError):
                tcv.convolve_initialize(x, h, algo)
            continue
        got = tcv.convolve_initialize(x, h, algo)
        want = jcv.convolve_initialize(x, h, jcv.ConvolutionAlgorithm(
            algo.value))
        assert _fields(got) == _fields(want)


def test_handle_from_fields_round_trips():
    for x, h in GRID[::7]:
        jh = jcv.convolve_initialize(x, h, reverse=True)
        th = tcv.handle_from_fields(dataclasses.asdict(jh))
        assert th == tcv.convolve_initialize(x, h, reverse=True)
        assert tcv.handle_from_fields(dataclasses.asdict(th)) == th
        assert th.result_length == jh.result_length


# route priors with the device terms opened on both sides: the JAX
# gates' shape terms are the port's static priors (the TPU's VMEM
# budget and the GPU's shared-memory admission agree on these shapes)
@pytest.mark.parametrize("k", [2, 100, 255, 256, 257, 2047, 4000])
def test_os_route_priors_match(monkeypatch, k):
    monkeypatch.setattr(jpk, "pallas_available", lambda: True)
    want = jcv._OS_FAMILY.static_select(h_length=k)
    got = tcv._OS_FAMILY.static_select(h_length=k, cuda=True)
    assert got == tcv.ROUTE_NAMES.get(want, want)
    assert tcv._OS_FAMILY.static_select(h_length=k) == "xla_matmul"


@pytest.mark.parametrize("rows,n,k", [
    (1, 4096, 9), (7, 4096, 9), (8, 4096, 9), (512, 16384, 129),
    (8, 1000, 256), (8, 1000, 257), (64, 100000, 33)])
def test_direct_route_priors_match(monkeypatch, rows, n, k):
    monkeypatch.setattr(jpk, "pallas_available", lambda: True)
    want = jcv._DIRECT_FAMILY.static_select(rows=rows, n=n, k=k)
    got = tcv._DIRECT_FAMILY.static_select(rows=rows, n=n, k=k,
                                           cuda=True)
    assert got == tcv.ROUTE_NAMES.get(want, want)
    x = torch.zeros(rows, n)
    assert tcv._DIRECT_FAMILY.select(rows=rows, n=n, k=k, cuda=x.is_cuda) \
        != "direct_cuda"                        # CPU tensor: conv1d


def _inputs(algo, batched, seed):
    r = np.random.RandomState(seed)
    n, k = (3000, 300) if algo is tcv.ConvolutionAlgorithm.OVERLAP_SAVE \
        else (700, 37)
    x = r.randn(*((2, 3, n) if batched else (n,))).astype(np.float32)
    return x, r.randn(k).astype(np.float32)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("algo", ALGOS)
def test_convolve_and_correlate_agree(algo, mode, batched):
    x, h = _inputs(algo, batched, seed=len(mode) + 3 * batched)
    n, k = x.shape[-1], h.shape[-1]
    jalgo = jcv.ConvolutionAlgorithm(algo.value)
    got = tcv.convolve(tcv.convolve_initialize(n, k, algo), x, h,
                       mode=mode)
    want = jcv.convolve(jcv.convolve_initialize(n, k, jalgo), x, h,
                        mode=mode)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert _rel(got, want) < REL_TOL
    got = tcr.cross_correlate(tcr.cross_correlate_initialize(n, k, algo),
                              x, h, mode=mode)
    want = jcr.cross_correlate(
        jcr.cross_correlate_initialize(n, k, jalgo), x, h, mode=mode)
    assert _rel(got, want) < REL_TOL


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_convenience_forms_agree(mode):
    r = np.random.RandomState(17)
    x = r.randn(4, 900).astype(np.float32)
    h = r.randn(21).astype(np.float32)
    assert _rel(tcv.convolve(x, h, mode=mode),
                jcv.convolve(x, h, mode=mode)) < REL_TOL
    assert _rel(tcr.cross_correlate(x, h, mode=mode),
                jcr.cross_correlate(x, h, mode=mode)) < REL_TOL
    # numpy correlate's 'same' window for a kernel longer than x
    xs, hl = x[0, :10], r.randn(25).astype(np.float32)
    assert _rel(tcr.cross_correlate(xs, hl, mode=mode),
                jcr.cross_correlate(xs, hl, mode=mode)) < REL_TOL
    np.testing.assert_array_equal(tcr.correlation_lags(10, 25, mode),
                                  jcr.correlation_lags(10, 25, mode))


def test_direct_simd_entry_points_agree():
    r = np.random.RandomState(23)
    x = r.randn(8, 500).astype(np.float32)
    h = r.randn(65).astype(np.float32)
    assert _rel(tcv.convolve_simd(x, h), jcv.convolve_simd(x, h)) < REL_TOL
    assert _rel(tcr.cross_correlate_simd(x, h),
                jcr.cross_correlate_simd(x, h)) < REL_TOL


def test_kernel_routes_agree(monkeypatch):
    # both packages forced onto their kernel routes: the Pallas kernels
    # run in interpret mode, the port's wrappers take their plain
    # versions (CPU tensors), through the full handle dispatch
    monkeypatch.setattr(jcv, "_use_pallas_os", lambda k: True)
    monkeypatch.setattr(jcv, "_use_pallas_direct", lambda *a: True)
    monkeypatch.setattr(tck, "on_card", lambda cuda: True)
    monkeypatch.setattr(tck, "should_route", lambda *a: True)
    r = np.random.RandomState(29)
    x = r.randn(2, 6000).astype(np.float32)
    h = r.randn(513).astype(np.float32)
    for reverse in (False, True):
        jh = jcv.convolve_initialize(6000, 513, reverse=reverse)
        th = tcv.convolve_initialize(6000, 513, reverse=reverse)
        assert th.os_matmul and jh.os_matmul
        assert _rel(tcv.convolve(th, x, h), jcv.convolve(jh, x, h)) \
            < REL_TOL
    hs = h[:40]
    jh = jcv.convolve_initialize(6000, 40, "brute_force")
    th = tcv.convolve_initialize(6000, 40, "brute_force")
    assert _rel(tcv.convolve(th, x, hs), jcv.convolve(jh, x, hs)) < REL_TOL
    assert _rel(tcr.cross_correlate_simd(x, hs),
                jcr.cross_correlate_simd(x, hs)) < REL_TOL


@pytest.mark.parametrize("k", [1, 2, 15, 16, 129, 256])
def test_direct_kernel_route_agrees(monkeypatch, k):
    # convolve_simd and cross_correlate_simd on the kernel route (gates
    # open): the port passes the unpadded rows with pad_left = k - 1
    # and the taps' reversal to the filter bank, the JAX package pads
    # and flips before its Pallas kernel (interpret mode)
    monkeypatch.setattr(jcv, "_use_pallas_direct", lambda *a: True)
    monkeypatch.setattr(tck, "should_route", lambda *a: True)
    r = np.random.RandomState(k + 50)
    x = r.randn(2, 4, 400).astype(np.float32)
    h = r.randn(k).astype(np.float32)
    assert _rel(tcv.convolve_simd(x, h), jcv.convolve_simd(x, h)) < REL_TOL
    assert _rel(tcr.cross_correlate_simd(x, h),
                jcr.cross_correlate_simd(x, h)) < REL_TOL


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fftconvolve_and_oaconvolve_agree(mode):
    r = np.random.RandomState(31)
    x = r.randn(3, 2000).astype(np.float32)
    h = r.randn(101).astype(np.float32)
    assert _rel(tcv.fftconvolve(x, h, mode=mode),
                jcv.fftconvolve(x, h, mode=mode)) < REL_TOL
    assert _rel(tcv.oaconvolve(x, h, mode=mode),
                jcv.oaconvolve(x, h, mode=mode)) < REL_TOL
    # outside the overlap-save contract both fall back to the FFT path
    hl = r.randn(1500).astype(np.float32)
    assert _rel(tcv.oaconvolve(x, hl, mode=mode),
                jcv.oaconvolve(x, hl, mode=mode)) < REL_TOL


def test_fftconvolve_rank_errors():
    x = np.ones((8, 8), np.float32)
    with pytest.raises(ValueError, match="rank 3"):
        tcv.fftconvolve(x, np.ones((2, 2, 2), np.float32))
    # a 2D kernel takes the 2D fft path, as in the JAX package
    r = np.random.RandomState(59)
    x2 = r.randn(2, 30, 41).astype(np.float32)
    h2 = r.randn(3, 5).astype(np.float32)
    for mode in ("full", "same", "valid"):
        assert _rel(tcv.fftconvolve(x2, h2, mode=mode),
                    jcv.fftconvolve(x2, h2, mode=mode)) < REL_TOL
        assert _rel(tcv.oaconvolve(x2, h2, mode=mode),
                    jcv.oaconvolve(x2, h2, mode=mode)) < REL_TOL


@pytest.mark.parametrize("k,reverse", [(33, False), (300, True), (1, False)])
def test_streaming_agrees_after_carry_handover(k, reverse):
    r = np.random.RandomState(k)
    chunk = 1024
    h = r.randn(k).astype(np.float32)
    chunks = [r.randn(2, chunk).astype(np.float32) for _ in range(5)]
    js = jcv.StreamingConvolution(h, chunk, reverse=reverse)
    ts = tcv.StreamingConvolution(h, chunk, reverse=reverse)
    for c in chunks[:2]:
        js.process(c)
    if k > 1:
        ts.load_carry(np.asarray(js._carry))
        np.testing.assert_array_equal(ts.carry(), np.asarray(js._carry))
    else:
        ts.process(chunks[0])
    for c in chunks[2:]:
        assert _rel(ts.process(c), js.process(c)) < REL_TOL
    np.testing.assert_allclose(ts.carry(), np.asarray(js._carry))
    got, want = ts.flush(), js.flush()
    assert tuple(got.shape) == tuple(want.shape)
    if k > 1:
        assert _rel(got, want) < REL_TOL


def test_streaming_matches_one_shot_and_rejects_misuse():
    r = np.random.RandomState(37)
    h = r.randn(50).astype(np.float32)
    x = r.randn(4 * 512).astype(np.float32)
    ts = tcv.StreamingConvolution(h, 512)
    ys = [ts.process(x[i:i + 512]) for i in range(0, x.size, 512)]
    ys.append(ts.flush())
    assert _rel(torch.cat(ys), jcv.convolve(x, h)) < REL_TOL
    with pytest.raises(ValueError, match="flushed"):
        ts.process(x[:512])
    with pytest.raises(ValueError, match="carry must be"):
        tcv.StreamingConvolution(h, 512).load_carry(np.zeros(10))
    with pytest.raises(ValueError, match="chunk length"):
        tcv.StreamingConvolution(h, 512).process(x[:100])


def test_causal_stream_block_agrees():
    r = np.random.RandomState(41)
    h = r.randn(31).astype(np.float32)
    x_ext = r.randn(3, 30 + 800).astype(np.float32)
    for route in ("brute_force", "overlap_save", "fft"):
        assert tcv.select_stream_route(800, 31) == \
            jcv.select_stream_route(800, 31)
        assert _rel(tcv.causal_stream_block(x_ext, h, route),
                    jcv.causal_stream_block(x_ext, h, route)) < REL_TOL
    np.testing.assert_array_equal(tcv.causal_stream_block_na(x_ext, h),
                                  jcv.causal_stream_block_na(x_ext, h))
    assert tcv.streaming_carry_len(31) == jcv.streaming_carry_len(31)


@pytest.mark.parametrize("algo", ALGOS)
def test_oracles_identical(algo):
    r = np.random.RandomState(43)
    x = r.randn(2, 3000).astype(np.float32)
    h = r.randn(300).astype(np.float32)
    jalgo = jcv.ConvolutionAlgorithm(algo.value)
    for reverse in (False, True):
        th = tcv.convolve_initialize(3000, 300, algo, reverse=reverse)
        jh = jcv.convolve_initialize(3000, 300, jalgo, reverse=reverse)
        got = tcv.convolve(th, x, h, simd=False, mode="same")
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(
            got, jcv.convolve(jh, x, h, simd=False, mode="same"))
    np.testing.assert_array_equal(tcv.convolve_simd(x, h, simd=False),
                                  jcv.convolve_simd(x, h, simd=False))
    np.testing.assert_array_equal(tcr.cross_correlate_simd(x, h, False),
                                  jcr.cross_correlate_simd(x, h, False))


def test_float64_inputs_compute_in_float32():
    r = np.random.RandomState(47)
    x = r.randn(1000)
    h = r.randn(40)
    got = tcv.convolve(x, h)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), tcv.convolve(x.astype(np.float32),
                                  h.astype(np.float32)).numpy())
    assert _rel(got, jcv.convolve(x, h)) < REL_TOL


def test_tensor_inputs_keep_their_device():
    x = torch.randn(2, 500)
    y = tcv.convolve(x, np.ones(5, np.float32))
    assert y.device == x.device
    with pytest.raises(ValueError, match="meta"):
        tcv.convolve(x, torch.ones(5, device="meta"))


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tconfig.set_config(device="cuda")
    assert not tplatform.on_cuda()
    with pytest.raises(RuntimeError, match="is_available"):
        tcv.convolve(np.ones(100, np.float32), np.ones(5, np.float32))
    with pytest.raises(RuntimeError, match="is_available"):
        tcv.StreamingConvolution(np.ones(5), 64).process(np.ones(64))
    # the oracle path needs no device
    assert isinstance(tcv.convolve(np.ones(100), np.ones(5), simd=False),
                      np.ndarray)


def test_kernel_wrappers_not_called_on_cpu_routes():
    tck.reset_launches()
    r = np.random.RandomState(53)
    tcv.convolve(r.randn(10000), r.randn(300))
    tcv.convolve_simd(r.randn(16, 400), r.randn(9))
    assert tck.LAUNCHES == {"overlap_save": 0, "filter_bank": 0,
                            "cascade_bank": 0, "filter_2d": 0, "stft": 0}


# ---- the xla_matmul_bf16_comp candidate ------------------------------------

def _comp_budget():
    from veles.simd_tpu_torch.runtime import precision as tprx

    return tprx.ERROR_BUDGETS["bf16_comp"]


@pytest.mark.parametrize("shape,k", [((20000,), 127), ((3, 5000), 300),
                                     ((2, 4096), 2047)])
def test_os_matmul_bf16_comp_route_agrees(shape, k):
    # the route's core, forced, in both packages, against float64
    r = np.random.RandomState(k)
    x = r.randn(*shape).astype(np.float32)
    h = r.randn(k).astype(np.float32)
    step = tcv.overlap_save_step(k)
    got = tcv._conv_os_matmul(torch.as_tensor(x), torch.as_tensor(h),
                              step, precision="bf16_comp")
    want = jcv._conv_os_matmul(x, h, step, precision="bf16_comp")
    want64 = jcv.convolve_na(x.astype(np.float64), h.astype(np.float64))
    assert _rel(got, want64) <= _comp_budget()
    assert _rel(want, want64) <= _comp_budget()
    assert _rel(got, want) <= 2 * _comp_budget()


def test_os_bf16_comp_is_eligible_but_never_the_static_route(tmp_path,
                                                              monkeypatch):
    from veles.simd_tpu_torch.runtime import routing as trouting

    r = np.random.RandomState(61)
    x = r.randn(2, 6000).astype(np.float32)
    h = r.randn(300).astype(np.float32)
    handle = tcv.convolve_overlap_save_initialize(6000, 300)
    assert handle.os_matmul
    static = tcv.convolve(handle, x, h, simd=True)
    forced = tcv._conv_os_matmul(torch.as_tensor(x), torch.as_tensor(h),
                                 handle.step, precision="highest")
    # autotune off (the default): the static route, bit for bit
    monkeypatch.delenv(trouting.AUTOTUNE_ENV, raising=False)
    assert torch.equal(static, forced)
    # a pack winner steers dispatch onto the compensated route
    trouting.set_cache_path(str(tmp_path / "pack.json"))
    try:
        trouting.tune_cache().store(
            "convolve.os",
            {"rows": 2, "x_length": 8192, "h_length": 300,
             "step": handle.step, "precision": "highest"},
            "xla_matmul_bf16_comp")
        monkeypatch.setenv(trouting.AUTOTUNE_ENV, "readonly")
        got = tcv.convolve(handle, x, h, simd=True)
        comp = tcv._conv_os_matmul(torch.as_tensor(x), torch.as_tensor(h),
                                   handle.step, precision="bf16_comp")
        assert torch.equal(got, comp)
        want64 = jcv.convolve_na(x.astype(np.float64),
                                 h.astype(np.float64))
        assert _rel(got, want64) <= _comp_budget()
        monkeypatch.setenv("VELES_SIMD_DISABLE_BF16_COMP", "1")
        assert torch.equal(tcv.convolve(handle, x, h, simd=True), static)
    finally:
        trouting.set_cache_path(None)
