"""The ``stft_2p20`` configuration of the benchmark on the CPU, at small
sizes and at both of its geometries: librosa's 2048/512 spectrogram
and Whisper's 400/160 front end.

* The plain reference (``cellbench/reference/stft_2p20.py``) against a
  NumPy float64 ``rfft`` of periodic-Hann frames, to 1e-12 of max|X|:
  both are float64 and differ only in summation order.
* The port's ``stft`` against the reference: the default route, the
  forced ``rdft_matmul`` and ``xla_fft`` and the kernel route (gate
  opened by monkeypatching ``cuda_kernels.on_card``; on a CPU tensor it
  computes K4's plain twin ``cuda_kernels.stft_plain``), each within
  :data:`TOL`.  The reference's control (the signal and window rounded
  to TF32, the precision below the configuration's) must fail it.
* The benchmark's entry: one real view ``[rows, frames, bins, 2]`` that
  the output check compares whole.
* The spans of one captured call: one top span ``stft.dispatch`` and
  one ``stft.route`` inside it, whose ``scratch_bytes`` is the route's
  formula.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cellbench import harness, work
from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.obs import spans as tspans
from veles.simd_tpu_torch.ops import cuda_kernels as tck
from veles.simd_tpu_torch.ops import spectral as ts
from veles.simd_tpu_torch.utils import config as tconfig

ROOT = harness.ROOT
REF = harness.load_module(ROOT / "cellbench" / "reference"
                          / "stft_2p20.py")
ENTRY = harness.load_module(ROOT / "cellbench" / "entries" / "stft.py")

# float32 with TF32 off: a bin sums L float32 products, the FFT route
# log2(L) float32 stages, and the window and basis are float32
# roundings of their float64 values, so every route drifts by a few
# float32 roundings times sqrt(L), under 2e-6 of max|X| here; the
# control's TF32 operands (2^-11 relative) err by about 3e-4.
TOL = 1e-5

# (frame_length, hop): librosa's defaults, Whisper's front end
GEOMETRIES = [(2048, 512), (400, 160)]
# enough samples that 2048/512 has 125 frames, past the kernel route's
# 64-frame gate
ROWS, N = 3, 1 << 16


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


@pytest.fixture
def open_gate(monkeypatch):
    """The kernel route's device term opened on the CPU, where the
    route computes the kernel's plain version."""
    monkeypatch.setattr(tck, "on_card", lambda cuda: True)


def _x(seed):
    return torch.randn(ROWS, N, generator=torch.Generator().manual_seed(
        seed))


def _params(L, hop):
    return {"rows": ROWS, "n": N, "frame_length": L, "hop": hop}


def _ref(x, L, hop, control=False):
    (got,) = REF.expected(_params(L, hop), x, {}, control=control)
    return got


def _rel(got, want):
    """The output check's number: max|got - want| / max|want| over the
    real and imaginary parts."""
    if got.is_complex():
        got = torch.view_as_real(got)
    return harness.rel_err(got, want)


@pytest.mark.parametrize("L,hop", GEOMETRIES)
def test_reference_is_numpy_rfft_of_periodic_hann_frames(L, hop):
    x = _x(L + hop)
    got = _ref(x, L, hop)
    xd = x.double().numpy()
    t = np.arange(L)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * t / L)
    frames = 1 + (N - L) // hop
    idx = np.arange(frames)[:, None] * hop + t[None, :]
    want = np.fft.rfft(xd[:, idx] * w, axis=-1)
    assert got.dtype == torch.float64
    assert tuple(got.shape) == (ROWS, frames, L // 2 + 1, 2)
    got = torch.view_as_complex(got).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("L,hop", GEOMETRIES)
@pytest.mark.parametrize("route", [None, "rdft_matmul", "xla_fft"])
def test_port_stft_matches_the_reference(L, hop, route):
    x = _x(L * hop)
    want = _ref(x, L, hop)
    got = ts.stft(x, L, hop, route=route)
    assert got.dtype == torch.complex64
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("L,hop", GEOMETRIES)
def test_the_control_fails_the_tolerance(L, hop):
    x = _x(L - hop)
    assert _rel(ts.stft(x, L, hop), _ref(x, L, hop)) <= TOL
    assert harness.rel_err(_ref(x, L, hop, control=True),
                           _ref(x, L, hop)) > 10 * TOL


def test_kernel_plain_twin_matches_the_reference():
    x = _x(7)
    want = _ref(x, 2048, 512)
    got = tck.stft_plain(x, ts.hann_window(2048), 2048, 512)
    assert _rel(got, want) <= TOL


def test_kernel_route_matches_the_reference(open_gate):
    x = _x(8)
    want = _ref(x, 2048, 512)
    assert ts._STFT_FAMILY.select(
        frame_length=2048, hop=512, frames=1 + (N - 2048) // 512,
        cuda=True) == "cuda_fused"
    assert ts._STFT_FAMILY.select(
        frame_length=400, hop=160, frames=1 + (N - 400) // 160,
        cuda=True) == "cuda_fused"
    assert _rel(ts.stft(x, 2048, 512, route="cuda_fused"), want) <= TOL
    assert _rel(ts.stft(x, 400, 160, route="cuda_fused"),
                _ref(x, 400, 160)) <= TOL


@pytest.mark.parametrize("L,hop", GEOMETRIES)
def test_entry_returns_one_real_view(L, hop):
    params = _params(L, hop)
    x = _x(L)
    entry = ENTRY.Entry(params, {})
    out = harness.as_list(entry(x))
    entry.close()
    frames = 1 + (N - L) // hop
    assert len(out) == 1
    assert out[0].dtype == torch.float32
    assert tuple(out[0].shape) == (ROWS, frames, L // 2 + 1, 2)
    want = REF.expected(params, x, {})
    assert len(want) == 1
    assert harness.rel_err(out[0], want[0]) <= TOL
    assert ENTRY.samples(params) == ROWS * N
    assert ENTRY.least_work(params) == work.stft_work(ROWS, N, L, hop)


@pytest.fixture
def capture():
    """Capture armed over an emptied store, and off again after."""
    obs.stop_capture()
    obs.configure(max_spans=256)
    obs.start_capture()
    yield
    obs.stop_capture()
    obs.configure(max_spans=tspans.DEFAULT_MAX_SPANS)
    obs.reset()


def _one_call(x, L, hop, route=None):
    ts.stft(x, L, hop, route=route)
    obs.stop_capture()
    recs = obs.captured().records
    tops = [r for r in recs if r.parent is None]
    assert [r.name for r in tops] == ["stft.dispatch"]
    inner = [r for r in recs if r.name == "stft.route"]
    assert len(inner) == 1 and inner[0].call == tops[0].call
    assert tops[0].start_ns <= inner[0].start_ns <= inner[0].end_ns \
        <= tops[0].end_ns
    return inner[0].attrs


def test_kernel_route_span_has_no_scratch(capture, open_gate):
    attrs = _one_call(_x(1), 2048, 512)
    assert attrs == {"route": "cuda_fused", "scratch_bytes": 0}


@pytest.mark.parametrize("L,hop,route,per_frame", [
    # contiguous frames, then the [frames, 2*bins] basis product
    (400, 160, None, 400 + 2 * 201),
    (2048, 512, "rdft_matmul", 2048 + 2 * 1025),
    # the windowed frames
    (400, 160, "xla_fft", 400),
])
def test_library_route_span_counts_its_scratch(capture, L, hop, route,
                                               per_frame):
    attrs = _one_call(_x(2), L, hop, route=route)
    frames = 1 + (N - L) // hop
    assert attrs == {"route": route or "rdft_matmul",
                     "scratch_bytes": 4 * ROWS * frames * per_frame}


def test_whisper_cell_scratch_is_the_formula():
    """At the cell's size, 64 rows of 2^20 samples at 400/160."""
    assert ts._stft_scratch_bytes("rdft_matmul", 64, 6552, 400) \
        == 1_345_204_224
    assert ts._stft_scratch_bytes("cuda_fused", 64, 2045, 2048) == 0
    assert ts._stft_scratch_bytes("rdft_matmul_bf16_comp", 64, 6552,
                                  400) is None
