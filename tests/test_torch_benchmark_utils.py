"""The port's profiling layer (``veles.simd_tpu_torch.utils.benchmark``)
against the JAX package's (``veles.simd_tpu.utils.benchmark``).

The nine cases of ``tests/test_benchmark_utils.py`` run against the
port on the CPU (host tensors, so the chained timer runs on the host
clock); each roofline attribution equals the JAX function's with the
MXU's rate replaced by the H100's at the same precision (same keys,
same formula); and the timers keep their units: the JAX names return
seconds, ``device_time_ms`` milliseconds.
"""

import time
import warnings

import numpy as np
import pytest
import torch

from veles.simd_tpu.utils import benchmark as jb
from veles.simd_tpu_torch.utils import benchmark as bm
from veles.simd_tpu_torch.utils.benchmark import (
    device_time, device_time_chained, host_time, rms_normalize)

PRECISIONS = ("highest", "high", "bf16_comp", "bf16", "default", "int8")

# the JAX module's names that carry a TPU rate and have no port
NOT_APPLICABLE = {
    "mxu_peak_tflops", "mxu_f32_bound_tflops", "mxu_int8_peak_tops",
    "MXU_PEAK_TFLOPS_BF16", "MXU_PEAK_TOPS_INT8", "MXU_F32_PASSES",
    "hbm_bw_gbps", "HBM_BW_GBPS", "ici_bw_gbps", "ICI_BW_GBPS",
    "xla_fft_eff_gflops", "XLA_FFT_EFF_GFLOPS", "a2a_ici_bytes"}


# ---------------------------------------------------------------------------
# the nine cases of tests/test_benchmark_utils.py
# ---------------------------------------------------------------------------

def test_chained_returns_positive_time():
    x = torch.zeros((256, 256), dtype=torch.float32)
    t = device_time_chained(lambda v: torch.sin(v) + 0.5, x,
                            iters=32, min_window=1e-4)
    assert t > 0


def test_chained_step_actually_runs():
    """The chain must execute the step: a heavy step reports far more
    time a step than a trivial one through the timer itself."""
    rng = np.random.RandomState(0)
    big = torch.as_tensor(rng.randn(512, 512).astype(np.float32))
    t_heavy = device_time_chained(
        lambda v: rms_normalize(v @ big), big, iters=16,
        min_window=1e-3)
    tiny = torch.zeros((8,), dtype=torch.float32)
    t_tiny = device_time_chained(
        lambda v: torch.sin(v) + 0.5, tiny, iters=16, min_window=1e-3,
        max_iters=1 << 20)
    # a 512^3 matmul (0.27 GFLOP) vs an 8-element sin: orders apart
    assert t_heavy > 20 * t_tiny, (t_heavy, t_tiny)


def test_chained_warns_and_returns_nan_when_window_unreachable():
    x = torch.zeros((4,), dtype=torch.float32)
    with pytest.warns(RuntimeWarning, match="marginal window"):
        # a 4-element op cannot fill a 10-second window within 64 steps
        t = device_time_chained(lambda v: torch.sin(v) + 0.5, x,
                                iters=16, min_window=10.0, max_iters=64)
    assert np.isnan(t)


def test_rms_normalize_bounds_chained_gemm():
    rng = np.random.RandomState(0)
    b = torch.as_tensor(rng.randn(64, 64).astype(np.float32))
    v = torch.as_tensor(rng.randn(64, 64).astype(np.float32))
    for _ in range(50):
        v = rms_normalize(v @ b)
    out = v.numpy()
    assert np.all(np.isfinite(out))
    assert abs(float(np.sqrt(np.mean(out ** 2))) - 1.0) < 1e-3


def test_rms_normalize_zero_input_stays_finite():
    out = rms_normalize(torch.zeros((8,), dtype=torch.float32)).numpy()
    assert np.all(np.isfinite(out))


def test_host_time_measures_wall():
    t = host_time(lambda: sum(range(10000)), repeats=2)
    assert t > 0


def test_sync_handles_empty_and_non_array_pytrees():
    from veles.simd_tpu_torch.utils.benchmark import _sync

    for empty in (None, {}, [], ()):
        assert _sync(empty) is None
    out = {"meta": "label", "n": 3, "y": torch.arange(4.0)}
    assert _sync(out) is None
    assert _sync({"only": "host", "values": 7}) is None
    assert _sync(torch.zeros((0,), dtype=torch.float32)) is None


def test_burst_device_time_still_works():
    x = torch.zeros((128,), dtype=torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = device_time(lambda: torch.sin(x), burst=4, repeats=1,
                        warmup=1)
    assert t > 0


def test_stft_roofline_per_route_constants():
    fl = 512
    frames_per_s = 1e6
    mm = bm.stft_roofline(frames_per_s, fl, route="rdft_matmul")
    pf = bm.stft_roofline(frames_per_s, fl, route="pallas_fused")
    ff = bm.stft_roofline(frames_per_s, fl, route="xla_fft")
    # the port's kernel route is an FFT: the FFT constant
    cf = bm.stft_roofline(frames_per_s, fl, route="cuda_fused")
    assert mm["flops_per_frame"] == 4 * fl * (fl // 2 + 1)
    assert pf["flops_per_frame"] == mm["flops_per_frame"]
    assert ff["flops_per_frame"] == bm.rfft_flops(fl) == 2.5 * fl * 9
    assert cf["flops_per_frame"] == ff["flops_per_frame"]
    for roof in (mm, ff):
        expect = (roof["flops_per_frame"] * frames_per_s / 1e12
                  / bm.GEMM_PEAK_TFLOPS["highest"] * 100.0)
        assert roof["pct_of_roofline"] == pytest.approx(expect)
    with pytest.raises(ValueError, match="route"):
        bm.stft_roofline(frames_per_s, fl, route="bogus")


# ---------------------------------------------------------------------------
# every roofline against the JAX one, the H100's rate in the MXU's place
# ---------------------------------------------------------------------------

@pytest.fixture
def h100_rates(monkeypatch):
    """The JAX module's bound function reading the port's peaks."""
    monkeypatch.setattr(jb, "mxu_f32_bound_tflops",
                        lambda precision="highest":
                        bm.GEMM_PEAK_TFLOPS[precision])


@pytest.mark.parametrize("precision", PRECISIONS)
def test_conv_roofline_is_the_jax_formula(h100_rates, precision):
    for rate, k in ((1.09e10, 2047), (3.3e8, 129), (1.0, 2)):
        assert bm.conv_roofline(rate, k, precision) == \
            jb.conv_roofline(rate, k, precision)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_gemm_and_analytical_rooflines_are_the_jax_formula(
        h100_rates, precision):
    for flops, t in ((2 * 512 ** 3, 3.1e-5), (2 * 2048 ** 3, 1.7e-3)):
        assert bm.gemm_roofline(flops, t, precision) == \
            jb.gemm_roofline(flops, t, precision)
        assert bm.analytical_roofline(flops, t, precision) == \
            jb.analytical_roofline(flops, t, precision)


@pytest.mark.parametrize("route", ["rdft_matmul", "pallas_fused",
                                   "xla_fft"])
@pytest.mark.parametrize("precision", ["highest", "bf16_comp"])
def test_stft_roofline_is_the_jax_formula(h100_rates, route, precision):
    for fps, fl in ((2.6e7, 512), (1.0e5, 256)):
        assert bm.stft_roofline(fps, fl, precision, route) == \
            jb.stft_roofline(fps, fl, precision, route)


@pytest.mark.parametrize("n1,n2", [(512, 512), (64, 4096), (8, 8)])
def test_dft_matmul_roofline_is_the_jax_formula(h100_rates, n1, n2):
    for precision in ("highest", "bf16"):
        assert bm.dft_matmul_roofline(5e9, n1, n2, precision) == \
            jb.dft_matmul_roofline(5e9, n1, n2, precision)


def test_disagreement_and_its_threshold_are_the_jax_ones():
    assert bm.ROOFLINE_DISAGREEMENT_WARN_PCT == \
        jb.ROOFLINE_DISAGREEMENT_WARN_PCT
    for measured, analytical in ((50.0, 60.0), (0.0, 0.0), (0.0, 3.0),
                                 (195.0, 7.5), (-4.0, 4.0)):
        assert bm.roofline_disagreement_pct(measured, analytical) == \
            jb.roofline_disagreement_pct(measured, analytical)


def test_rooflines_refuse_an_unknown_precision():
    for fn, args in ((bm.conv_roofline, (1e9, 2047)),
                     (bm.gemm_roofline, (1e9, 1e-3)),
                     (bm.analytical_roofline, (1e9, 1e-3)),
                     (bm.stft_roofline, (1e6, 512)),
                     (bm.dft_matmul_roofline, (1e9, 64, 64))):
        with pytest.raises(ValueError, match="precision"):
            fn(*args, precision="tf32x9")


def test_rooflines_read_the_h100_peaks_not_the_mxu():
    # the headline's direct-form rate: 2 * 2047 FLOPs a sample at
    # 1,048,576 samples in 0.0330 ms (K1's busy time, PERF.md) reads
    # about 195 % of the fp32 peak: no share of a peak (an FFT route)
    roof = bm.conv_roofline((1 << 20) / 0.0330e-3, 2047)
    assert roof["roofline_bound_tflops"] == bm.H100_FP32_TFLOPS == 67.0
    assert 190.0 < roof["pct_of_roofline"] < 200.0
    assert bm.gemm_roofline(1.0, 1.0, "bf16_comp")[
        "roofline_bound_tflops"] == pytest.approx(989.0 / 3)


def test_the_module_covers_the_jax_names():
    missing = sorted(set(jb.__all__) - NOT_APPLICABLE - set(bm.__all__))
    assert not missing, missing
    for name in bm.__all__:
        assert hasattr(bm, name), name


# ---------------------------------------------------------------------------
# units: the JAX timers in seconds, device_time_ms in milliseconds
# ---------------------------------------------------------------------------

def _sleeper(seconds):
    def step(v):
        time.sleep(seconds)
        return v + 1.0
    return step


# a 5 ms sleep a step, best of three: a time in seconds reads about
# 5e-3, one in milliseconds about 5; the bounds leave room for a
# loaded host either way
def test_chained_time_is_in_seconds():
    t = device_time_chained(_sleeper(5e-3), torch.zeros(4), iters=8,
                            base=2, repeats=3, min_window=0.02)
    assert 1e-3 < t < 5e-2, t


def test_burst_time_is_in_seconds():
    t = device_time(lambda: _sleeper(5e-3)(torch.zeros(4)), burst=4,
                    repeats=3, warmup=1)
    assert 1e-3 < t < 5e-2, t


class _HostEvent:
    """A CUDA event stand-in on the host clock (milliseconds apart, as
    ``torch.cuda.Event.elapsed_time``)."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_device_time_ms_is_in_milliseconds(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    step = _sleeper(5e-3)
    x = torch.zeros(4)
    ms = bm.device_time_ms(lambda: step(x), iters=5, warmup=1)
    s = device_time_chained(step, x, iters=8, base=2, repeats=3,
                            min_window=0.02)
    assert 1.0 < ms < 50.0, ms
    assert 200.0 < ms / s < 5000.0, (ms, s)
