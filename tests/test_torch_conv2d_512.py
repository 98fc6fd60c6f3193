"""The ``conv2d_512`` configuration of the benchmark on the CPU, at small
sizes and at both of its geometries: SSIM's 11 x 11 Gaussian window
(``cross_correlate2d``, ``valid``) and SimCLR's 51 x 51 blur
(``convolve2d``, ``same``, ``symm``).

* The plain reference (``cellbench/reference/conv2d_512.py``) against
  ``scipy.signal.correlate2d`` and ``convolve2d`` in float64, to 1e-12
  of max|y|: both are float64 and differ only in summation order.
* The port against the reference: the default route, the forced
  ``fft`` and ``direct`` (cuDNN's fp32 twin, ``conv2d``) and the 2D
  kernel's route (gate opened by monkeypatching
  ``cuda_kernels.on_card``; on a CPU tensor it computes K5's plain
  twin ``cuda_kernels.filter_2d_plain``), each within :data:`TOL`.
  The reference's control (images and window rounded to TF32, the
  precision below the configuration's) must fail it.
* The benchmark's entry: its window, its output's shape, its samples
  and its least work, which pins the two cells' numbers.
* The spans of one captured call: one top span ``convolve2d.dispatch``
  with ``convolve2d.route`` (and for ``symm`` ``convolve2d.extend``)
  inside it, whose ``scratch_bytes`` are the formulas, pinned at the
  cells' sizes.
"""

import dataclasses

import numpy as np
import pytest
import scipy.signal
import torch

from cellbench import harness, work, work2d
from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.obs import spans as tspans
from veles.simd_tpu_torch.ops import convolve2d as t2
from veles.simd_tpu_torch.ops import cuda_kernels as tck
from veles.simd_tpu_torch.utils import config as tconfig

ROOT = harness.ROOT
REF = harness.load_module(ROOT / "cellbench" / "reference"
                          / "conv2d_512.py")
ENTRY = harness.load_module(ROOT / "cellbench" / "entries"
                            / "convolve2d.py")

# float32 with TF32 off: the 2D kernel and conv2d sum k^2 float32
# products of a window that sums to 1, and the FFT route runs about
# 2 log2(m) float32 butterfly stages a transform, so every route drifts
# by a few float32 roundings of max|y|, under 1e-6 here; the control's
# TF32 images and window (2^-11 relative) err by about 4e-4.
TOL = 1e-5

# the two cells' calls at small sizes: (params, images, side)
SSIM = ({"k": 11, "sigma": 1.5, "op": "cross_correlate2d",
         "mode": "valid", "boundary": "fill"}, 3, 64)
BLUR = ({"k": 51, "sigma": 2.0, "op": "convolve2d", "mode": "same",
         "boundary": "symm"}, 3, 96)
CELLS = {"ssim11": SSIM, "blur51": BLUR}


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


@pytest.fixture
def open_gate(monkeypatch):
    """The 2D kernel route's device term opened on the CPU, where the
    route computes the kernel's plain version."""
    monkeypatch.setattr(tck, "on_card", lambda cuda: True)


def _params(cell):
    shape, images, side = CELLS[cell]
    return {**shape, "images": images, "n0": side, "n1": side}


def _x(images, side, seed):
    return torch.randn(images, side, side,
                       generator=torch.Generator().manual_seed(seed))


def _ref(params, x, control=False):
    (got,) = REF.expected(params, x, {}, control=control)
    return got


def _scipy(params, x):
    w = REF.gaussian(params["k"], params["sigma"]).double().numpy()
    f = (scipy.signal.correlate2d if params["op"] == "cross_correlate2d"
         else scipy.signal.convolve2d)
    return np.stack([f(img, w, mode=params["mode"],
                       boundary=params["boundary"])
                     for img in x.double().numpy()])


@pytest.mark.parametrize("op,mode,boundary,k,side", [
    ("cross_correlate2d", "valid", "fill", 11, 64),
    ("convolve2d", "same", "symm", 51, 96),
    # the reference's other paths: the correlation's 'same' start, an
    # even window, 'full' with either boundary
    ("cross_correlate2d", "same", "symm", 11, 40),
    ("convolve2d", "same", "fill", 6, 40),
    ("cross_correlate2d", "same", "symm", 6, 40),
    ("convolve2d", "full", "symm", 7, 30),
    ("cross_correlate2d", "full", "fill", 5, 30),
    ("convolve2d", "valid", "symm", 9, 30),
])
def test_reference_is_scipy(op, mode, boundary, k, side):
    params = {"k": k, "sigma": 1.5, "op": op, "mode": mode,
              "boundary": boundary}
    x = _x(3, side, k + side)
    got = _ref(params, x)
    want = _scipy(params, x)
    assert got.dtype == torch.float64
    assert tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def _port(params, x, **kw):
    op = getattr(t2, params["op"])
    return op(x, REF.gaussian(params["k"], params["sigma"]),
              mode=params["mode"], boundary=params["boundary"], **kw)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("algorithm", [None, "fft", "direct"])
def test_port_matches_the_reference(cell, algorithm):
    params = _params(cell)
    x = _x(params["images"], params["n0"], 3)
    got = _port(params, x, algorithm=algorithm)
    assert got.dtype == torch.float32
    assert harness.rel_err(got, _ref(params, x)) <= TOL


def test_kernel_route_matches_the_reference(open_gate):
    params = _params("ssim11")
    x = _x(params["images"], params["n0"], 4)
    assert t2.select_algorithm2d(11, 11, tuple(x.shape)) == "direct"
    obs.reset()
    obs.enable()
    try:
        got = _port(params, x)
        routes = [e["decision"] for e in obs.events()
                  if e["op"] == "convolve2d"]
    finally:
        obs.disable()
        obs.reset()
    assert routes == ["direct_cuda"]
    assert harness.rel_err(got, _ref(params, x)) <= TOL
    # the blur's 51 x 51 stays off the kernel with its gate open
    assert t2.select_algorithm2d(51, 51, (3, 146, 146)) == "fft"


def test_kernel_plain_twin_matches_the_reference():
    params = _params("ssim11")
    x = _x(params["images"], params["n0"], 5)
    w = REF.gaussian(11, 1.5)
    got = tck.filter_2d_plain(x, w, 54, 54)
    assert harness.rel_err(got, _ref(params, x)) <= TOL


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_the_tolerance(cell):
    params = _params(cell)
    x = _x(params["images"], params["n0"], 6)
    want = _ref(params, x)
    assert harness.rel_err(_port(params, x), want) <= TOL
    assert harness.rel_err(_ref(params, x, control=True), want) \
        > 10 * TOL


@pytest.mark.parametrize("k,sigma", [(11, 1.5), (51, 2.0)])
def test_entry_window_is_fspecials(k, sigma):
    w = ENTRY.gaussian(k, sigma)
    assert w.dtype == torch.float32 and tuple(w.shape) == (k, k)
    assert torch.equal(w, w.flip(0)) and torch.equal(w, w.t())
    assert abs(float(w.sum()) - 1.0) <= 1e-6
    assert torch.equal(w, REF.gaussian(k, sigma))
    assert int(w.argmax()) == (k * k) // 2


@pytest.mark.parametrize("cell,shape", [("ssim11", (3, 54, 54)),
                                        ("blur51", (3, 96, 96))])
def test_entry_returns_the_modes_part(cell, shape):
    params = _params(cell)
    x = _x(params["images"], params["n0"], 7)
    entry = ENTRY.Entry(params, {})
    out = harness.as_list(entry(x))
    entry.close()
    assert len(out) == 1 and out[0].dtype == torch.float32
    assert tuple(out[0].shape) == shape
    assert harness.rel_err(out[0], _ref(params, x)) <= TOL
    assert ENTRY.samples(params) == params["images"] * params["n0"] ** 2
    assert ENTRY.least_work(params) == work2d.filter2d_work(
        params["images"], params["n0"], params["n1"], params["k"],
        params["k"], params["mode"])


def test_least_work_of_the_two_cells():
    # ssim11: 320 x 512^2, 11 x 11, valid: the FFT form at 512^2 (7.81
    # GFLOP) under the direct form's 19.5, bound by its 658.1 MB
    flops, nbytes = work2d.filter2d_work(320, 512, 512, 11, 11, "valid")
    assert flops == 7_814_184_960 and nbytes == 658_109_924
    ms, by = work.fp32_bound(flops, nbytes)
    assert by == "bytes" and ms == pytest.approx(0.196451, abs=1e-6)
    # blur51: 256 x 512^2, 51 x 51, same: the FFT form at 1024^2 (27.7
    # GFLOP) under the direct form's 349, bound by its operations
    flops, nbytes = work2d.filter2d_work(256, 512, 512, 51, 51, "same")
    assert flops == 27_702_853_632 and nbytes == 536_881_316
    ms, by = work.fp32_bound(flops, nbytes)
    assert by == "operations" and ms == pytest.approx(0.413475, abs=1e-6)
    # the direct form where it is the smaller: a 3 x 3 'full' filter
    assert work2d.filter2d_work(2, 64, 64, 3, 3, "full")[0] == \
        2.0 * 2 * 66 * 66 * 9


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


def _one_call(params, x):
    _port(params, x)
    obs.stop_capture()
    recs = obs.captured().records
    tops = [r for r in recs if r.parent is None]
    assert [r.name for r in tops] == ["convolve2d.dispatch"]
    top = tops[0]
    inner = {}
    for r in recs:
        if r is top:
            continue
        assert r.call == top.call
        assert top.start_ns <= r.start_ns <= r.end_ns <= top.end_ns
        assert r.name not in inner
        inner[r.name] = r
    assert inner["convolve2d.route"].parent == "fault.attempt"
    return top, inner


def test_kernel_route_span_counts_the_sliced_away_outputs(capture,
                                                          open_gate):
    params = _params("ssim11")
    top, inner = _one_call(params, _x(3, 64, 8))
    assert top.attrs == {"algo": "direct", "auto": True}
    assert set(inner) == {"fault.attempt", "convolve2d.route"}
    assert inner["convolve2d.route"].attrs == {
        "route": "direct_cuda", "scratch_bytes": 4 * 3 * (74 ** 2 - 54 ** 2)}


def test_fft_route_and_extension_spans_count_their_copies(capture):
    params = _params("blur51")
    top, inner = _one_call(params, _x(3, 96, 9))
    assert top.attrs == {"algo": "fft", "auto": True}
    assert set(inner) == {"convolve2d.extend", "fault.attempt",
                          "convolve2d.route"}
    ext = inner["convolve2d.extend"]
    assert ext.parent == "convolve2d.dispatch"
    # the rows' gather [146, 96], then the columns' [146, 146]
    assert ext.attrs == {"boundary": "symm",
                         "scratch_bytes": 4 * 3 * 146 * (96 + 146)}
    # at 256^2: the padded input and kernel, the inverse, less the kept
    # 96^2 outputs, and the two spectra and their product
    grid, bins = 256 * 256, 256 * 129
    assert inner["convolve2d.route"].attrs == {
        "route": "fft",
        "scratch_bytes": 4 * (4 * grid + 3 * grid - 3 * 96 * 96)
        + 8 * 7 * bins}


def test_the_cells_scratch_is_the_formula():
    """At the cells' sizes: K5's full 522^2 output that 'valid' cuts to
    502^2; the blur's two gathers and its FFT route at 1024^2."""
    assert t2._route_scratch_bytes("direct_cuda", 320, 512, 512, 11, 11,
                                   (0, 0), (502, 502), True) == 26_214_400
    assert t2._extend_scratch_bytes("symm", 256, 512, 512, 25, 25) \
        == 618_074_112
    assert t2._route_scratch_bytes("fft", 256, 562, 562, 51, 51,
                                   (25, 25), (512, 512)) == 4_039_122_944
    # the conv2d twin writes its whole full output, and flips the taps
    assert t2._route_scratch_bytes("direct_mxu", 2, 10, 10, 3, 3) == 4 * 9
