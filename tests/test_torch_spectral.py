"""The port's spectral slice against the JAX package.

The same NumPy inputs, made from a seed, go through
``veles.simd_tpu.ops.spectral`` (on the CPU platform the root conftest
pins) and ``veles.simd_tpu_torch.ops.spectral`` with ``device="cpu"``.

* STFT, spectrogram and Hilbert: both sides are float32 with different
  summation orders, so they agree to 1e-5 of max|X|, the tolerance of
  ``tests/test_spectral.py``; the CWT to its 1e-4.  Each forced route
  is held against the JAX route of the same name; the port's
  ``cuda_fused`` route (gate opened by monkeypatching
  ``cuda_kernels.on_card``; on a CPU tensor it computes the kernel's
  plain version) against ``pallas_fused``, whose ``stft_pallas`` runs
  in interpret mode off the TPU.
* ISTFT: 1e-5 of max|x| between the packages and against the float64
  oracle away from the first and last ``frame_length - hop`` samples,
  where the partial window envelope divides by as little as 1e-8 and
  amplifies each FFT's round-off (the JAX package's own routes miss
  the oracle there by up to 1.3e-4 at a 256-sample frame); over the
  whole signal, the JAX test's case and its 1e-4.
* PSD estimators, chirp-Z and Lomb-Scargle: 1e-5 of max|y| between
  the packages (``tests/test_spectral.py`` holds the JAX side to 1e-5
  of scipy).
* ``simd=False`` and the host-side builders: bit-equal NumPy.
"""

import dataclasses

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import pallas_kernels as jpk
from veles.simd_tpu.ops import spectral as js
from veles.simd_tpu.ops import waveforms as jwf
from veles.simd_tpu_torch import obs as tobs
from veles.simd_tpu_torch.ops import batched as tb  # noqa: F401 (cache)
from veles.simd_tpu_torch.ops import cuda_kernels as tck
from veles.simd_tpu_torch.ops import spectral as ts
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

REL_TOL = 1e-5          # STFT, Hilbert, PSD (test_spectral.py)
CWT_TOL = 1e-4          # test_cwt_vs_oracle
ISTFT_ORACLE_TOL = 1e-4  # test_istft_batched_matches_oracle


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


@pytest.fixture
def open_gate(monkeypatch):
    """Open the port's fused-route device term on the CPU (the JAX
    side's forced ``pallas_fused`` runs in interpret mode off the TPU
    as it is)."""
    monkeypatch.setattr(tck, "on_card", lambda cuda: True)


def _np(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _rel(got, want):
    got = _np(got).astype(np.complex128)
    want = _np(want).astype(np.complex128)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------- STFT

STFT_CASES = [((1000,), 256, 128), ((3, 2000), 512, 128),
              ((2, 1500), 384, 128), ((2, 3000), 1024, 128),
              ((1, 1000), 256, 64), ((2, 3, 800), 128, 64),
              ((300,), 128, 32), ((1000,), 256, 96)]


@pytest.mark.parametrize("shape,frame,hop", STFT_CASES)
def test_stft_routes_agree(shape, frame, hop):
    x = _x(frame + hop, shape)
    want = js.stft(x, frame, hop, simd=True, route="rdft_matmul")
    got = ts.stft(x, frame, hop)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.complex64
    assert _rel(got, want) < REL_TOL
    for route in ("rdft_matmul", "xla_fft"):
        want = js.stft(x, frame, hop, simd=True, route=route)
        assert _rel(ts.stft(x, frame, hop, route=route), want) < REL_TOL
    assert _rel(got, js.stft_na(x, frame, hop)) < REL_TOL


@pytest.mark.parametrize("shape,frame,hop", [
    ((1000,), 256, 128), ((3, 2000), 512, 128), ((2, 1500), 384, 128),
    ((2, 3000), 1024, 128), ((2, 9000), 512, 128), ((2, 2, 700), 256, 128),
])
def test_fused_route_agrees_with_pallas(shape, frame, hop, open_gate):
    x = _x(frame + 7, shape)
    want = js.stft(x, frame, hop, simd=True, route="pallas_fused")
    got = ts.stft(x, frame, hop, route="cuda_fused")
    assert _rel(got, want) < REL_TOL
    if js.frame_count(shape[-1], frame, hop) >= tck.STFT_MIN_FRAMES:
        tobs.enable()
        try:
            tobs.reset()
            auto = ts.stft(x, frame, hop)
            assert [e["decision"] for e in tobs.events()
                    if e["op"] == "stft_route"] == ["cuda_fused"]
        finally:
            tobs.reset()
            tobs.disable()
        assert _rel(auto, want) < REL_TOL


def _stft_grid():
    for frame in (128, 256, 384, 512, 1000, 1024):
        for hop in (64, 100, 128, 256, 512):
            if hop > frame:
                continue
            for frames in (1, 63, 64, 500):
                yield frame, hop, frames


def test_stft_route_priors_match(monkeypatch):
    grid = list(_stft_grid())
    # gate closed: the JAX package off the TPU, the port on CPU tensors
    for frame, hop, frames in grid:
        assert ts._select_stft_route(frame, hop, frames, cuda=False) \
            == js._select_stft_route(frame, hop, frames)
    monkeypatch.setattr(tck, "on_card", lambda cuda: True)
    monkeypatch.setattr(jpk, "pallas_available", lambda: True)
    widened = 0
    for frame, hop, frames in grid:
        # the designed difference: the kernel's gate has no hop | L or
        # 128-lane hop term (the TPU's priors; the H100 sweep in
        # PERF.md), so where only those refuse the JAX kernel the port
        # runs its kernel and the JAX package the basis matmul
        wide = ((frame % hop or hop % 128) and frame // hop >= 2
                and frames >= tck.STFT_MIN_FRAMES)
        widened += bool(wide)
        want = js._select_stft_route(frame, hop, frames)
        got = ts._select_stft_route(frame, hop, frames, cuda=True)
        if wide:
            assert (want, got) == ("rdft_matmul", "cuda_fused"), \
                (frame, hop, frames)
        else:
            assert got == ts.ROUTE_NAMES.get(want, want), \
                (frame, hop, frames)
        for rows in (1, 5, 64):
            want = js._stft_route_for(frame, hop, frames, rows)
            got = ts._stft_route_for(frame, hop, frames, rows, cuda=True)
            assert got == ("cuda_fused" if wide
                           else ts.ROUTE_NAMES.get(want, want))
        assert ts._stft_tune_class(frame, hop, frames, 5) == \
            js._stft_tune_class(frame, hop, frames, 5)
    assert widened > 0
    # the opt-outs close the same gates
    monkeypatch.setenv("VELES_SIMD_DISABLE_STFT_PALLAS", "1")
    monkeypatch.setenv("VELES_SIMD_DISABLE_STFT_CUDA", "1")
    for frame, hop, frames in grid:
        assert ts._select_stft_route(frame, hop, frames, cuda=True) \
            == js._select_stft_route(frame, hop, frames)
    assert ts.dft_matmul_allowed() is js.dft_matmul_allowed() is True
    monkeypatch.setenv("VELES_SIMD_DISABLE_DFT_MATMUL", "1")
    assert ts.dft_matmul_allowed() is js.dft_matmul_allowed() is False
    assert ts._select_stft_route(512, 128, 500, cuda=True) == "xla_fft"
    assert js._select_stft_route(512, 128, 500) == "xla_fft"
    assert ts._use_matmul_dft(512) is js._use_matmul_dft(512) is False


def test_shared_memory_admits_what_vmem_refuses(open_gate, monkeypatch):
    # the one designed difference: K4's shared memory is fixed, where
    # the TPU kernel's VMEM holds the whole [r, hop, 2*bins_pad] basis
    monkeypatch.setattr(jpk, "pallas_available", lambda: True)
    assert not jpk.fits_vmem_stft(4096, 128)
    assert js._select_stft_route(4096, 128, 500) == "rdft_matmul"
    assert ts._select_stft_route(4096, 128, 500, cuda=True) == "cuda_fused"
    assert tck.fits_smem_stft(4096, 128)


def test_route_gate_needs_a_card():
    assert ts._use_cuda_stft(512, 128, 500, cuda=True)
    assert not ts._use_cuda_stft(512, 128, 500, cuda=False)
    # no operand: the configured device (the CPU here) decides
    assert not ts._use_cuda_stft(512, 128, 500)
    assert ts._select_stft_route(512, 128, 500) == "rdft_matmul"


def test_route_gate_admits_hops_that_do_not_divide_the_frame():
    # Whisper's 400/160 on a 2^20-sample row: 6552 frames, K4's route;
    # under the 64-frame minimum, which this gate keeps, it is not
    assert ts._use_cuda_stft(400, 160, 6552, cuda=True)
    assert ts._select_stft_route(400, 160, 6552, cuda=True) == "cuda_fused"
    assert not ts._use_cuda_stft(400, 160, 63, cuda=True)
    assert ts._select_stft_route(400, 160, 63, cuda=True) == "rdft_matmul"
    # one hop a frame stays off the kernel's route
    assert not ts._use_cuda_stft(400, 300, 6552, cuda=True)


def test_named_windows_resolve_through_the_port():
    x = _x(14, (2048,))
    w = jwf.get_window("hamming", 256)
    by_name = ts.stft(x, 256, 64, window="hamming")
    by_array = ts.stft(x, 256, 64, window=w)
    np.testing.assert_array_equal(by_name.numpy(), by_array.numpy())
    assert _rel(by_name, js.stft(x, 256, 64, window="hamming",
                                 simd=True)) < REL_TOL
    kaiser = ts.stft(x, 256, 64, window=("kaiser", 7.0))
    assert _rel(kaiser, js.stft_na(x, 256, 64,
                                   window=("kaiser", 7.0))) < REL_TOL
    rec = ts.istft(by_name, 2048, 256, 64, window="hamming")
    np.testing.assert_allclose(rec.numpy()[256:-256], x[256:-256],
                               atol=1e-4)
    with pytest.raises(ValueError, match="window shape"):
        ts.stft(x, 256, 64, window=np.ones(100))


@pytest.mark.parametrize("frame,hop", [(256, 128), (256, 64), (128, 32),
                                       (256, 96)])
def test_istft_agrees(frame, hop):
    n = 2048
    x = _x(frame + hop, (2, n))
    spec = js.stft_na(x, frame, hop).astype(np.complex64)
    want_oracle = js.istft_na(spec, n, frame, hop)
    core = slice(frame - hop, n - frame + hop)
    for route in (None, "rdft_matmul", "xla_fft"):
        got = ts.istft(spec, n, frame, hop, route=route)
        assert got.dtype == torch.float32
        want = js.istft(spec, n, frame, hop, simd=True,
                        route=route or "rdft_matmul")
        assert _rel(got.numpy()[:, core], np.asarray(want)[:, core]) \
            < REL_TOL
        assert _rel(got.numpy()[:, core], want_oracle[:, core]) < REL_TOL
    # the round trip through the port, interior (test_spectral.py)
    rec = ts.istft(ts.stft(x, frame, hop), n, frame, hop)
    np.testing.assert_allclose(rec.numpy()[:, frame:n - frame],
                               x[:, frame:n - frame], atol=1e-4)


def test_istft_batched_matches_oracle():
    x = _x(17, (4, 1024))
    spec = js.stft_na(x, 128, 64)
    want = js.istft_na(spec, 1024, 128, 64)
    for route in ("rdft_matmul", "xla_fft"):
        got = ts.istft(spec.astype(np.complex64), 1024, 128, 64,
                       route=route)
        assert _rel(got, want) < ISTFT_ORACLE_TOL


def test_spectrogram_agrees():
    x = _x(3, (2, 2048))
    got = ts.spectrogram(x, 256, 128)
    assert got.dtype == torch.float32
    assert _rel(got, js.spectrogram(x, 256, 128, simd=True)) < REL_TOL
    got = ts.spectrogram(x, 256, 128, route="xla_fft")
    assert _rel(got, js.spectrogram_na(x, 256, 128)) < REL_TOL


def test_overlap_add_is_the_adjoint_of_framing():
    for frame, hop in ((64, 16), (60, 20), (64, 48), (65, 13)):
        n = 700
        frames = torch.from_numpy(_x(frame, (3, js.frame_count(
            n, frame, hop), frame)))
        got = ts._overlap_add(frames, n, frame, hop).numpy()
        idx = js._frame_indices(n, frame, hop)
        want = np.zeros((3, n), np.float64)
        for f in range(idx.shape[0]):
            want[:, idx[f]] += frames.numpy()[:, f].astype(np.float64)
        np.testing.assert_allclose(got, want, atol=1e-5)
        x = torch.from_numpy(_x(hop, (3, n)))
        np.testing.assert_array_equal(
            ts._take_frames(x, frame, hop).numpy(), x.numpy()[..., idx])
    np.testing.assert_array_equal(ts._env_inv(1000, 256, 64,
                                              js.hann_window(256)),
                                  js._env_inv(1000, 256, 64,
                                              js.hann_window(256)))


# ------------------------------------------------------ streaming hooks

def test_stream_hooks_agree():
    frame, hop, block = 256, 64, 512
    assert ts.stft_stream_carry(frame, hop) == \
        js.stft_stream_carry(frame, hop) == frame - hop
    for frames in (1, 8, 200):
        assert ts.select_stft_stream_route(frame, hop, frames) == \
            js.select_stft_stream_route(frame, hop, frames)
    window = js.hann_window(frame)
    x = _x(5, (2, 4 * block))
    carry = frame - hop
    j_ext = np.concatenate([np.zeros((2, carry), np.float32),
                            x[:, :block]], axis=-1)
    t_ext = torch.from_numpy(j_ext)
    for b in range(1, 5):
        for route in ("rdft_matmul", "xla_fft"):
            want = js.stft_stream_step(j_ext, frame, hop, window, route)
            got = ts.stft_stream_step(t_ext, frame, hop, window, route)
            assert _rel(got, want) < REL_TOL
        nxt = x[:, b * block:(b + 1) * block]
        # each side's carry (the tail of its block) feeds the other
        j_carry, t_carry = np.asarray(j_ext)[:, -carry:], t_ext[:, -carry:]
        j_ext = np.concatenate([t_carry.numpy(), nxt], axis=-1)
        t_ext = torch.cat([torch.from_numpy(j_carry),
                           torch.from_numpy(nxt)], dim=-1)
    np.testing.assert_array_equal(ts.stft_stream_oracle(x, frame, hop),
                                  js.stft_stream_oracle(x, frame, hop))
    with pytest.raises(ValueError, match="dividing"):
        ts.stft_stream_carry(256, 96)


# ------------------------------------------------------ Hilbert and CWT

@pytest.mark.parametrize("n", [512, 511, 1000, 1024, 1025, 2048])
def test_hilbert_agrees(n):
    x = _x(n, (2, n))
    want = js.hilbert(x, simd=True)
    for route in (None, "matmul_dft", "xla_fft"):
        got = ts.hilbert(x, route=route)
        assert got.dtype == torch.complex64
        assert _rel(got, want) < REL_TOL, route
    assert _rel(ts.envelope(x), js.envelope(x, simd=True)) < REL_TOL
    assert ts._HILBERT_FAMILY.static_select(n=n) == \
        js._HILBERT_FAMILY.static_select(n=n)


@pytest.mark.parametrize("n,routes", [
    (1024, ("matmul_dft", "xla_fft", "ct_matmul")),
    (1000, ("matmul_dft", "xla_fft")),
    (2048, ("ct_matmul", "xla_fft")),
    (1031, ("xla_fft",)),
])
def test_morlet_cwt_agrees(n, routes):
    x = _x(n, (2, n))
    scales = np.array([2.0, 4.0, 8.0, 16.0, 32.0])
    want = js.morlet_cwt_na(x, scales)
    auto = ts.morlet_cwt(x, scales)
    assert auto.shape == (2, 5, n) and auto.dtype == torch.complex64
    assert _rel(auto, js.morlet_cwt(x, scales, simd=True)) < CWT_TOL
    for route in routes:
        got = ts.morlet_cwt(x, scales, route=route)
        assert _rel(got, js.morlet_cwt(x, scales, simd=True,
                                       route=route)) < CWT_TOL, route
        assert _rel(got, want) < CWT_TOL, route
    assert ts._CWT_FAMILY.static_select(n=n) == \
        js._CWT_FAMILY.static_select(n=n)


def test_ct_helpers_agree():
    for n in (4, 6, 7, 1024, 1031, 4096, 12288, 1 << 20, (1 << 24) + 2):
        assert ts.ct_factor(n) == js.ct_factor(n)
    assert ts.ct_factor(4096, 64, 8) == js.ct_factor(4096, 64, 8)
    for a, b in zip(ts.ct_basis_parts(32, 16), js.ct_basis_parts(32, 16)):
        np.testing.assert_array_equal(a, b)
    parts_t = ts.ct_basis_device(32, 16)
    parts_j = js.ct_basis_device(32, 16)
    x = _x(9, (3, 512))
    xc = (x + 1j * _x(10, (3, 512))).astype(np.complex64)
    for inp, inverse in ((x, False), (xc, False), (xc, True)):
        got = ts.ct_apply(torch.from_numpy(inp), 32, 16, parts_t,
                          inverse=inverse)
        want = js.ct_apply(inp, 32, 16, parts_j, inverse=inverse)
        for g, w in zip(got, want):
            assert _rel(g, w) < REL_TOL
    spec = np.fft.rfft(x.astype(np.float64)).astype(np.complex64)
    np.testing.assert_array_equal(
        ts.hermitian_extend(torch.from_numpy(spec), 512).numpy(),
        np.asarray(js.hermitian_extend(spec, 512)))


# ---------------------------------------------------------- estimators

def test_detrend_agrees():
    x = _x(19, (6, 500))
    for type in ("linear", "constant"):
        got = ts.detrend(x, type)
        assert _rel(got, js.detrend(x, type, simd=True)) < REL_TOL
        np.testing.assert_array_equal(ts.detrend(x, type, simd=False),
                                      js.detrend(x, type, simd=False))
        got = ts.detrend(x.T.copy(), type, axis=0)
        want = js.detrend(x.T.copy(), type, simd=True, axis=0)
        assert _rel(got, want) < REL_TOL
        np.testing.assert_array_equal(
            ts.detrend(x.T.copy(), type, simd=False, axis=0),
            js.detrend(x.T.copy(), type, simd=False, axis=0))


@pytest.mark.parametrize("kw", [
    {}, {"nperseg": 128, "noverlap": 32}, {"window": "hamming"},
    {"detrend_type": "linear", "scaling": "spectrum"},
    {"window": ("kaiser", 7.0), "fs": 100.0}, {"nperseg": 5000},
])
def test_welch_and_csd_agree(kw):
    x, y = _x(21, (2, 4096)), _x(22, (2, 4096))
    f1, p1 = ts.welch(x, **kw)
    f2, p2 = js.welch(x, simd=True, **kw)
    np.testing.assert_array_equal(f1, f2)
    assert p1.dtype == torch.float32 and _rel(p1, p2) < REL_TOL
    f1, p1 = ts.csd(x, y, **kw)
    f2, p2 = js.csd(x, y, simd=True, **kw)
    np.testing.assert_array_equal(f1, f2)
    assert p1.dtype == torch.complex64 and _rel(p1, p2) < REL_TOL
    np.testing.assert_array_equal(ts.welch(x, simd=False, **kw)[1],
                                  js.welch(x, simd=False, **kw)[1])
    np.testing.assert_array_equal(ts.welch_na(x, **kw)[1],
                                  js.welch_na(x, **kw)[1])
    np.testing.assert_array_equal(ts.csd_na(x, y, **kw)[1],
                                  js.csd_na(x, y, **kw)[1])


def test_periodogram_and_coherence_agree():
    x, y = _x(23, (3, 1024)), _x(24, (3, 1024))
    y = y + 0.5 * x
    for kw in ({}, {"window": "hann"}, {"detrend_type": None}):
        f1, p1 = ts.periodogram(x, **kw)
        f2, p2 = js.periodogram(x, simd=True, **kw)
        np.testing.assert_array_equal(f1, f2)
        assert _rel(p1, p2) < REL_TOL
        np.testing.assert_array_equal(ts.periodogram_na(x, **kw)[1],
                                      js.periodogram_na(x, **kw)[1])
    f1, c1 = ts.coherence(x, y, nperseg=128)
    f2, c2 = js.coherence(x, y, nperseg=128, simd=True)
    np.testing.assert_array_equal(f1, f2)
    assert c1.dtype == torch.float32 and _rel(c1, c2) < REL_TOL
    np.testing.assert_array_equal(ts.coherence_na(x, y, nperseg=128)[1],
                                  js.coherence_na(x, y, nperseg=128)[1])


def test_czt_and_zoom_fft_agree():
    x = _x(25, (2, 300))
    xc = (x + 1j * _x(26, (2, 300))).astype(np.complex64)
    w, a = np.exp(-0.02j), 0.9 * np.exp(0.3j)
    for inp, kw in ((x, {}), (xc, {}), (x, {"m": 128, "w": w, "a": a})):
        got = ts.czt(inp, **kw)
        assert got.dtype == torch.complex64
        assert _rel(got, js.czt(inp, simd=True, **kw)) < REL_TOL
        assert _rel(got, js.czt_na(inp, **kw)) < REL_TOL
        np.testing.assert_array_equal(ts.czt(inp, simd=False, **kw),
                                      js.czt(inp, simd=False, **kw))
        np.testing.assert_array_equal(ts.czt_na(inp, **kw),
                                      js.czt_na(inp, **kw))
    for fn, m in (([0.1, 0.3], 64), (0.5, None)):
        f1, z1 = ts.zoom_fft(x, fn, m)
        f2, z2 = js.zoom_fft(x, fn, m, simd=True)
        np.testing.assert_array_equal(f1, f2)
        assert _rel(z1, z2) < REL_TOL


def test_lombscargle_agrees():
    r = np.random.RandomState(27)
    t = np.sort(r.rand(400) * 20.0)
    x = np.sin(2.5 * t) + 0.3 * r.randn(400)
    freqs = np.linspace(0.5, 8.0, 200)
    wts = r.rand(400)
    wts[::7] = 0.0
    for kw in ({}, {"weights": wts}):
        got = ts.lombscargle(t, x, freqs, **kw)
        assert got.dtype == torch.float32
        assert _rel(got, js.lombscargle(t, x, freqs, simd=True, **kw)) \
            < REL_TOL
        np.testing.assert_array_equal(
            ts.lombscargle(t, x, freqs, simd=False, **kw),
            js.lombscargle(t, x, freqs, simd=False, **kw))
    # offset time base: centered in float64 before the f32 cast
    got = ts.lombscargle(t + 2.45e6, x, freqs)
    assert _rel(got, js.lombscargle_na(t, x, freqs)) < 2e-4


# ------------------------------------------------- oracles and builders

def test_oracle_twins_bit_equal():
    x = _x(31, (2, 1024))
    for name, args in (("stft", (x, 256, 64)), ("spectrogram",
                                                (x, 256, 128)),
                       ("hilbert", (x,)), ("envelope", (x,)),
                       ("morlet_cwt", (x, [2.0, 8.0]))):
        got = getattr(ts, name)(*args, simd=False)
        want = getattr(js, name)(*args, simd=False)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(getattr(ts, name + "_na")(*args),
                                      getattr(js, name + "_na")(*args))
    spec = js.stft_na(x, 256, 64).astype(np.complex64)
    np.testing.assert_array_equal(
        ts.istft(spec, 1024, 256, 64, simd=False),
        js.istft(spec, 1024, 256, 64, simd=False))
    # a tensor reaches the oracle through the host
    np.testing.assert_array_equal(ts.stft_na(torch.from_numpy(x), 256, 64),
                                  js.stft_na(x, 256, 64))


def test_host_builders_bit_equal():
    for L in (128, 255, 512):
        w = js.hann_window(L)
        np.testing.assert_array_equal(ts.hann_window(L), w)
        np.testing.assert_array_equal(ts._rdft_basis(L, w),
                                      js._rdft_basis(L, w))
        np.testing.assert_array_equal(ts._rdft_inv_basis(L, w),
                                      js._rdft_inv_basis(L, w))
    for n in (8, 511, 1024):
        np.testing.assert_array_equal(ts._analytic_multiplier(n),
                                      js._analytic_multiplier(n))
        np.testing.assert_array_equal(ts._hilbert_basis(n),
                                      js._hilbert_basis(n))
        for a, b in zip(ts._cwt_basis(n), js._cwt_basis(n)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            ts._morlet_hat([1.5, 4.0, 30.0], n, 6.0),
            js._morlet_hat(np.array([1.5, 4.0, 30.0]), n, 6.0))
    for args in ((300, 300, np.exp(-2j * np.pi / 300), 1.0),
                 (100, 37, np.exp(-0.01j), 0.8 * np.exp(0.4j))):
        for a, b in zip(ts._czt_constants(*args),
                        js._czt_constants(*args)):
            np.testing.assert_array_equal(a, b)
    for n in (1, 2, 5, 9, 10, 4096):
        assert ts.frame_count(n, 4, 2) == js.frame_count(n, 4, 2)
    for frame, hop in ((256, 64), (256, 96), (64, 1), (64, 64)):
        assert ts._framing_path(frame, hop) == js._framing_path(frame, hop)


# ------------------------------------------------- telemetry, contracts

@pytest.fixture
def telemetry():
    tobs.enable()
    tobs.reset()
    yield
    tobs.reset()
    tobs.disable()


def test_decision_events(telemetry):
    x = _x(41, (2048,))
    ts.stft(x, 256, 64)
    assert [(e["op"], e["decision"]) for e in tobs.events()] == [
        ("stft_route", "rdft_matmul"), ("stft", "reshape_interleave")]
    ts.stft(x, 256, 96, route="xla_fft")
    ev = tobs.events()[-2:]
    assert ev[0]["forced"] is True and ev[1]["decision"] == "gather"
    spec = ts.stft(x, 256, 64)
    ts.istft(spec, 2048, 256, 64)
    assert (tobs.events()[-1]["op"], tobs.events()[-1]["decision"]) == \
        ("istft", "reshape_overlap_add")
    ts.hilbert(x[:512])
    ts.morlet_cwt(x, [2.0, 4.0])
    assert [e["decision"] for e in tobs.events()[-2:]] == [
        "matmul_dft", "ct_matmul"]
    snap = tobs.snapshot()
    assert "span.stft.dispatch" in [h["name"] for h in snap["histograms"]]


def test_caches_report_the_three_lrus():
    ts.stft(_x(42, (1000,)), 256, 128)
    tb.batched_stft(_x(43, (2, 1000)), 256, 128)
    caches = tobs.caches()
    for name in ("spectral_host_lru", "spectral_device_lru",
                 "batched_handle_lru"):
        stats = caches[name]
        for key in ("size", "capacity", "hits", "misses", "evictions"):
            assert isinstance(stats[key], int), (name, key)
        assert stats["size"] >= 1
    # a failing provider reports its error instead of failing
    tobs.register_cache("test.broken", lambda: 1 / 0)
    try:
        assert "ZeroDivisionError" in tobs.caches()["test.broken"]["error"]
    finally:
        tobs.register_cache("test.broken", lambda: {"size": 0})


@pytest.mark.parametrize("call,match", [
    (lambda m: m.stft(np.zeros(100, np.float32), 128, 64), "signal length"),
    (lambda m: m.stft(np.zeros(300, np.float32), 128, 0), "positive"),
    (lambda m: m.stft(np.zeros(300, np.float32), 128, 200), "drops"),
    (lambda m: m.stft(np.zeros(300, np.float32), 128, 64, route="x"),
     "route must be one of"),
    (lambda m: m.istft(np.zeros((4, 65), np.complex64), 300, 128, 64),
     "inconsistent"),
    (lambda m: m.hilbert(np.zeros(0, np.float32)), "empty"),
    (lambda m: m.morlet_cwt(np.zeros(64, np.float32), [0.0]), "scales"),
    (lambda m: m.morlet_cwt(np.zeros(1031, np.float32), [2.0],
                            route="ct_matmul"), "Cooley-Tukey"),
    (lambda m: m.detrend(np.zeros(8), "quadratic"), "linear"),
    (lambda m: m.welch(np.zeros(64), nperseg=32, noverlap=32), "noverlap"),
    (lambda m: m.welch(np.zeros(64), scaling="x"), "scaling"),
    (lambda m: m.csd(np.zeros(64), np.zeros(65)), "lengths differ"),
    (lambda m: m.czt(np.zeros(8), m=0), "m must be"),
    (lambda m: m.zoom_fft(np.zeros(8), [0.5, 0.2]), "band"),
    (lambda m: m.lombscargle(np.arange(4.0), np.zeros(4), [-1.0]),
     "positive"),
    (lambda m: m.lombscargle(np.arange(4.0), np.zeros(4), [1.0],
                             weights=np.zeros(4)), "at least one"),
])
@pytest.mark.parametrize("side", ["jax", "torch"])
def test_contract_errors_match(call, match, side):
    with pytest.raises(ValueError, match=match):
        call(js if side == "jax" else ts)


# ---- the *_bf16_comp candidates --------------------------------------------

COMP_BUDGET = 1e-4      # runtime/precision.py ERROR_BUDGETS["bf16_comp"]


def _comp_cases():
    return [
        ("stft", "rdft_matmul_bf16_comp",
         lambda m, x, **kw: m.stft(x, 256, 64, **kw),
         lambda x: js.stft_na(x, 256, 64), (2, 2048)),
        ("hilbert", "matmul_dft_bf16_comp",
         lambda m, x, **kw: m.hilbert(x, **kw), js.hilbert_na, (3, 500)),
        ("morlet_cwt", "matmul_dft_bf16_comp",
         lambda m, x, **kw: m.morlet_cwt(x, [2.0, 5.0, 11.0], **kw),
         lambda x: js.morlet_cwt_na(x, [2.0, 5.0, 11.0]), (2, 600)),
    ]


@pytest.mark.parametrize("name,route,call,oracle,shape", _comp_cases(),
                         ids=[c[0] for c in _comp_cases()])
def test_bf16_comp_route_agrees(name, route, call, oracle, shape):
    x = _x(len(name), shape)
    got = call(ts, x, route=route)
    want = np.asarray(call(js, x, simd=True, route=route))
    want64 = oracle(x)
    assert _rel(got, want64) <= COMP_BUDGET
    assert _rel(want, want64) <= COMP_BUDGET
    assert _rel(got, want) <= 2 * COMP_BUDGET


def test_istft_bf16_comp_route_agrees():
    n, frame, hop = 2048, 256, 64
    spec = js.stft_na(_x(9, (2, n)), frame, hop).astype(np.complex64)
    core = slice(frame - hop, n - frame + hop)
    route = "rdft_matmul_bf16_comp"
    got = ts.istft(spec, n, frame, hop, route=route).numpy()[:, core]
    want = np.asarray(js.istft(spec, n, frame, hop, simd=True,
                               route=route))[:, core]
    want64 = js.istft_na(spec, n, frame, hop)[:, core]
    assert _rel(got, want64) <= COMP_BUDGET
    assert _rel(want, want64) <= COMP_BUDGET


@pytest.mark.parametrize("name,route,call,oracle,shape", _comp_cases(),
                         ids=[c[0] for c in _comp_cases()])
def test_autotune_off_keeps_the_static_route_bit_for_bit(
        name, route, call, oracle, shape, monkeypatch):
    from veles.simd_tpu_torch.runtime import routing as trouting

    monkeypatch.delenv(trouting.AUTOTUNE_ENV, raising=False)
    x = _x(len(name) + 1, shape)
    tobs.enable()
    tobs.reset()
    try:
        got = call(ts, x)
        (ev,) = [e for e in tobs.events()
                 if e["op"] == f"{name}_route"]
    finally:
        tobs.disable()
        tobs.reset()
    assert ev["decision"] != route and not ev["forced"]
    assert torch.equal(got, call(ts, x, route=ev["decision"]))


@pytest.mark.parametrize("entry", ["stft", "spectrogram"])
def test_jax_route_name_is_an_alias(entry):
    # F3: the JAX package's route name runs the port's kernel route
    x = np.random.RandomState(31).randn(2, 4096).astype(np.float32)
    want = getattr(js, entry)(x, 512, 128, route="pallas_fused")
    got = getattr(ts, entry)(x, 512, 128, route="pallas_fused")
    port = getattr(ts, entry)(x, 512, 128, route="cuda_fused")
    np.testing.assert_array_equal(got.numpy(), port.numpy())
    w = np.asarray(want)
    assert np.max(np.abs(got.numpy() - w)) <= REL_TOL * np.max(np.abs(w))
    with pytest.raises(ValueError, match="route must be one of"):
        ts.stft(x, 64, 16, route="nonsense")


def test_jax_stft_opt_out_switch_is_an_alias(monkeypatch):
    # F3: VELES_SIMD_DISABLE_STFT_PALLAS closes the kernel route as the
    # port's VELES_SIMD_DISABLE_STFT_CUDA does
    geom = dict(frame_length=512, hop=128, frames=64, cuda=True)
    assert ts._STFT_FAMILY.gate("cuda_fused", **geom)
    assert ts._STFT_FAMILY.gate("pallas_fused", **geom)
    monkeypatch.setenv("VELES_SIMD_DISABLE_STFT_PALLAS", "1")
    assert not ts._STFT_FAMILY.gate("cuda_fused", **geom)
    assert ts._STFT_FAMILY.static_select(**geom) == "rdft_matmul"
    monkeypatch.setenv("VELES_SIMD_DISABLE_STFT_PALLAS", "0")
    assert ts._STFT_FAMILY.gate("cuda_fused", **geom)
