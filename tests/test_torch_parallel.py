"""The port's sharded ops against the JAX package's, on 8 shards.

The twin of ``tests/test_parallel.py``: every case runs the same seeded
NumPy inputs through ``veles.simd_tpu.parallel`` on the conftest's
8-device CPU mesh and through ``veles.simd_tpu_torch.parallel`` on an
8-shard mesh of ``cpu`` devices (``set_config(device="cpu")``), and
holds the port to the JAX result and to the reference the JAX test
uses (a float64 oracle or the single-chip op; here also the port's
single-card op), at the JAX test's own tolerance:

* 1e-3 of max|y| for the halo convolutions against the single-chip op,
  1e-3 absolute against the float64 oracles, 1e-4 relative for the
  rings;
* 5e-4 for the wavelet analyses, 2e-4 for the round trips;
* 1e-3 for the STFT/ISTFT, 5e-5 of max|y| for ``sosfilt``, 1e-5 of
  max Pxx for Welch, 1e-5 for resampling, 1e-6 for the rank filters and
  the normalization, 5e-4 of max|y| for Savitzky-Golay, 1e-3 of max P
  for Lomb-Scargle.

Meshes: ``sp8``, ``dp2×sp4``, ``dp4×sp2``, ``tp8``.  The port-only
cases at the end cover the shard runner (collectives, spec errors,
device checks), the resource row, and the ``mesh_degrade`` path under
a fault plan (``tests/test_breaker.py``'s ``TestMeshDegrade``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from veles.simd_tpu import parallel as jpar
from veles.simd_tpu.ops import convolve as jcv
from veles.simd_tpu_torch import obs as tobs
from veles.simd_tpu_torch import parallel as tpar
from veles.simd_tpu_torch.ops import convolve as tcv
from veles.simd_tpu_torch.ops import convolve2d as tcv2
from veles.simd_tpu_torch.ops import filters as tfl
from veles.simd_tpu_torch.ops import iir as tiir
from veles.simd_tpu_torch.ops import normalize as tnm
from veles.simd_tpu_torch.ops import resample as trs
from veles.simd_tpu_torch.ops import spectral as tsp
from veles.simd_tpu_torch.ops import wavelet as twv
from veles.simd_tpu_torch.parallel import _spmd
from veles.simd_tpu_torch.parallel._spmd import P
from veles.simd_tpu_torch.runtime import breaker as tbreaker
from veles.simd_tpu_torch.runtime import faults as tfaults
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

RNG = np.random.RandomState(51)


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


def meshes(sizes):
    """The same axes on both packages: ``(jax_mesh, port_mesh)``."""
    return jpar.make_mesh(dict(sizes)), tpar.make_mesh(dict(sizes))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _close(port, jax_out, want, atol):
    """The port within ``atol`` of the reference and of the JAX
    package's sharded result, with the reference's shape."""
    port, jax_out, want = _np(port), _np(jax_out), _np(want)
    assert port.shape == want.shape
    assert np.all(np.isfinite(port))
    np.testing.assert_allclose(port, want, atol=atol)
    np.testing.assert_allclose(port, jax_out, atol=atol)


def _conv64(x, h):
    """float64 full convolution in FFT form: ``np.convolve`` in float64
    to rounding, without its dot-a-sample loop that a loaded CPU (the
    test workers beside it) slows a hundredfold."""
    x, h = np.asarray(x, np.float64), np.asarray(h, np.float64)
    n = x.shape[-1] + h.shape[-1] - 1
    m = 1 << (n - 1).bit_length()
    return np.fft.irfft(np.fft.rfft(x, m) * np.fft.rfft(h, m), m)[..., :n]


def _jit(thunk):
    """A JAX package call traced once under ``jax.jit``: the same
    program as the eager call, without re-dispatching its shard_map op
    by op (about a tenth of the time on the CPU mesh)."""
    return jax.jit(thunk)()


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _rel_close(port, jax_out, want, tol):
    assert _rel(port, want) < tol
    assert _rel(port, jax_out) < tol


def test_virtual_mesh_has_8_devices():
    assert len(jax.devices()) == 8  # conftest.py forces this
    mesh = tpar.default_mesh("sp")
    assert dict(mesh.shape) == {"sp": 8}
    assert {str(d) for d in mesh.devices.flat} == {"cpu"}


def test_make_mesh_shapes():
    m = tpar.make_mesh({"dp": 2, "sp": 4})
    assert m.shape == {"dp": 2, "sp": 4}
    assert m.axis_names == jpar.make_mesh({"dp": 2, "sp": 4}).axis_names
    m2 = tpar.make_mesh({"dp": 2, "tp": -1})
    assert m2.shape["tp"] == 4
    with pytest.raises(ValueError):
        tpar.make_mesh({"dp": 3})
    with pytest.raises(ValueError):
        jpar.make_mesh({"dp": 3})
    with pytest.raises(ValueError, match="divisible"):
        tpar.make_mesh({"dp": 3, "sp": -1})


@pytest.mark.parametrize("n,k", [(1 << 12, 65), (1000, 17), (8192, 129)])
def test_sharded_convolve_matches_single_device(n, k):
    """Sequence-parallel conv == the single-chip op (halo correctness)."""
    jm, tm = meshes({"sp": 8})
    x = RNG.randn(n).astype(np.float32)
    h = RNG.randn(k).astype(np.float32)
    got = tpar.sharded_convolve(x, h, tm)
    want = np.asarray(jcv.convolve_simd(x, h, simd=True))
    assert tuple(got.shape) == (n + k - 1,)
    atol = 1e-3 * max(1, np.abs(want).max())
    _close(got, jpar.sharded_convolve(x, h, jm), want, atol)
    _close(got, got, tcv.convolve_simd(x, h, simd=True), atol)


def test_sharded_convolve_2d_mesh_axis():
    """Works on a named axis of a 2D mesh."""
    jm, tm = meshes({"dp": 2, "sp": 4})
    x = RNG.randn(4096).astype(np.float32)
    h = RNG.randn(33).astype(np.float32)
    want = _conv64(x, h)
    _close(tpar.sharded_convolve(x, h, tm, axis="sp"),
           jpar.sharded_convolve(x, h, jm, axis="sp"),
           want.astype(np.float32), 1e-2)


def test_sharded_matmul_matches_dot():
    jm, tm = meshes({"tp": 8})
    a = RNG.randn(64, 256).astype(np.float32)
    b = RNG.randn(256, 48).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    _close(tpar.sharded_matmul(a, b, tm), jpar.sharded_matmul(a, b, jm),
           want.astype(np.float32), 1e-3)


def test_sharded_matmul_contract_violations():
    _, tm = meshes({"tp": 8})
    with pytest.raises(ValueError, match="contracting"):
        tpar.sharded_matmul(np.zeros((4, 5), np.float32),
                            np.zeros((6, 4), np.float32), tm)


def test_sharded_matmul_pads_indivisible_k():
    """K=300 is not a multiple of 8: zero-padding keeps it exact."""
    jm, tm = meshes({"tp": 8})
    a = RNG.randn(32, 300).astype(np.float32)
    b = RNG.randn(300, 24).astype(np.float32)
    want = (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)
    got = tpar.sharded_matmul(a, b, tm)
    assert tuple(got.shape) == (32, 24)
    _close(got, jpar.sharded_matmul(a, b, jm), want, 1e-3)


def test_sharded_convolve_batch_dpxsp():
    """dp×sp tiled convolution == per-row np.convolve."""
    jm, tm = meshes({"dp": 2, "sp": 4})
    x = RNG.randn(6, 2048).astype(np.float32)
    h = RNG.randn(65).astype(np.float32)
    got = tpar.sharded_convolve_batch(x, h, tm)
    assert tuple(got.shape) == (6, 2048 + 64)
    jgot = np.asarray(jpar.sharded_convolve_batch(x, h, jm))
    for i in range(6):
        want = _conv64(x[i], h)
        _close(got[i], jgot[i], want.astype(np.float32),
               1e-3 * max(1, np.abs(want).max()))


def test_sharded_convolve_batch_contract():
    jm, tm = meshes({"dp": 2, "sp": 4})
    out = tpar.sharded_convolve_batch(np.zeros((3, 512), np.float32),
                                      np.zeros(9, np.float32), tm)
    assert tuple(out.shape) == (3, 520) == np.asarray(
        jpar.sharded_convolve_batch(np.zeros((3, 512), np.float32),
                                    np.zeros(9, np.float32), jm)).shape
    with pytest.raises(ValueError):  # 1D input
        tpar.sharded_convolve_batch(np.zeros(512, np.float32),
                                    np.zeros(9, np.float32), tm)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_sharded_swt_matches_single_device(levels):
    """Sharded à-trous cascade == the single-chip SWT with PERIODIC."""
    from veles.simd_tpu.ops import wavelet as jwv
    from veles.simd_tpu.ops.wavelet_coeffs import WaveletType

    jm, tm = meshes({"sp": 8})
    x = RNG.randn(2048).astype(np.float32)
    got = tpar.sharded_swt("daub", 8, levels, x, tm)
    jgot = _jit(lambda: jpar.sharded_swt(
        WaveletType.DAUBECHIES, 8, levels, x, jm))
    want = jwv.stationary_wavelet_transform(
        WaveletType.DAUBECHIES, 8, jwv.ExtensionType.PERIODIC, x, levels,
        simd=True)
    single = twv.stationary_wavelet_transform(
        "daub", 8, twv.ExtensionType.PERIODIC, x, levels, simd=True)
    assert len(got) == levels + 1
    for g, j, w, s in zip(got, jgot, want, single):
        _close(g, j, w, 5e-4)
        _close(g, g, s, 5e-4)


def test_sharded_swt_contracts():
    _, tm = meshes({"sp": 8})
    with pytest.raises(ValueError, match="divisible"):
        tpar.sharded_swt("daub", 8, 1, np.zeros(1001, np.float32), tm)
    with pytest.raises(ValueError, match="halo"):
        tpar.sharded_swt("daub", 8, 6, np.zeros(1024, np.float32), tm)


def test_data_parallel_batched_op():
    from veles.simd_tpu.ops import wavelet as jwv

    jm, tm = meshes({"dp": 8})
    x = RNG.randn(16, 256).astype(np.float32)
    dwt = tpar.data_parallel(
        lambda b: twv.wavelet_apply("daub", 8, twv.ExtensionType.PERIODIC,
                                    b, simd=True), tm)
    jdwt = jpar.data_parallel(
        lambda b: jwv.wavelet_apply("daub", 8, jwv.ExtensionType.PERIODIC,
                                    b, simd=True), jm)
    hi, lo = dwt(x)
    jhi, jlo = jdwt(x)
    hi_1, lo_1 = twv.wavelet_apply("daub", 8, twv.ExtensionType.PERIODIC,
                                   x, simd=True)
    _close(hi, jhi, hi_1, 1e-5)
    _close(lo, jlo, lo_1, 1e-5)


def test_sharded_convolve_accepts_batch():
    """Leading batch dims ride along replicated."""
    _, tm = meshes({"sp": 8})
    out = tpar.sharded_convolve(np.zeros((2, 64), np.float32),
                                np.zeros(5, np.float32), tm)
    assert tuple(out.shape) == (2, 68)


def test_sharded_convolve_length1_kernel():
    """halo_len=0 edge: a length-1 kernel is a pure scale."""
    jm, tm = meshes({"sp": 8})
    x = RNG.randn(512).astype(np.float32)
    h = np.array([2.5], np.float32)
    _close(tpar.sharded_convolve(x, h, tm), jpar.sharded_convolve(x, h, jm),
           2.5 * x, 1e-5)


def test_sharded_convolve_halo_too_large_auto_rings():
    """Filters longer than a shard block auto-select the ring."""
    jm, tm = meshes({"sp": 8})
    x = RNG.randn(256).astype(np.float32)
    h = RNG.randn(40).astype(np.float32)   # halo 39 > ceil(295/8)=37
    want = _conv64(x, h)
    tobs.enable()
    tobs.reset()
    try:
        got = tpar.sharded_convolve(x, h, tm)
        ev = [e for e in tobs.events() if e["op"] == "sharded_convolve"]
        assert ev[-1]["decision"] == "ring"
    finally:
        tobs.disable()
        tobs.reset()
    _close(got, jpar.sharded_convolve(x, h, jm), want.astype(np.float32),
           1e-3 * float(np.max(np.abs(want))))


class TestSharded2D:
    def test_matches_oracle_2x2(self):
        from veles.simd_tpu.ops import convolve2d as jcv2

        rng = np.random.RandomState(21)
        jm, tm = meshes({"dp": 4, "sp": 2})
        x = rng.randn(30, 26).astype(np.float32)
        h = rng.randn(4, 5).astype(np.float32)
        _close(tpar.sharded_convolve2d(x, h, tm),
               jpar.sharded_convolve2d(x, h, jm),
               jcv2.convolve2d_na(x, h), 1e-3)

    def test_matches_oracle_2x4_uneven(self):
        rng = np.random.RandomState(22)
        jm, tm = meshes({"dp": 2, "sp": 4})
        x = rng.randn(17, 53).astype(np.float32)   # needs output padding
        h = rng.randn(3, 3).astype(np.float32)
        _close(tpar.sharded_convolve2d(x, h, tm),
               jpar.sharded_convolve2d(x, h, jm),
               tcv2.convolve2d_na(x, h), 1e-3)

    def test_halo_too_large_auto_rings(self):
        jm, tm = meshes({"dp": 2, "sp": 4})
        rng = np.random.RandomState(24)
        x = rng.randn(8, 8).astype(np.float32)
        h = rng.randn(2, 7).astype(np.float32)
        _close(tpar.sharded_convolve2d(x, h, tm),
               jpar.sharded_convolve2d(x, h, jm),
               tcv2.convolve2d_na(x, h), 1e-3)

    def test_large_kernel_takes_fft_tile_path(self):
        from veles.simd_tpu.ops import convolve2d as jcv2

        rng = np.random.RandomState(23)
        jm, tm = meshes({"dp": 2, "sp": 4})
        x = rng.randn(80, 160).astype(np.float32)
        h = rng.randn(33, 33).astype(np.float32)  # area >= fft crossover
        assert jcv2.select_algorithm2d(33, 33) == "fft"
        want = tcv2.convolve2d_na(x, h)
        _close(tpar.sharded_convolve2d(x, h, tm),
               jpar.sharded_convolve2d(x, h, jm), want, 2e-3)
        _close(tpar.sharded_convolve2d(x, h, tm),
               tcv2.convolve2d(x, h), want, 2e-3)


class TestShardedSynthesis:
    """Distributed analysis -> synthesis round trips."""

    def test_dwt_reconstruct_matches_input(self):
        rng = np.random.RandomState(31)
        jm, tm = meshes({"sp": 8})
        x = rng.randn(512).astype(np.float32)
        hi, lo = twv.wavelet_apply_na("daub", 8, twv.ExtensionType.PERIODIC,
                                      x)
        _close(tpar.sharded_wavelet_reconstruct("daub", 8, hi, lo, tm),
               _jit(lambda: jpar.sharded_wavelet_reconstruct(
                   "daub", 8, hi, lo, jm)), x, 2e-4)

    def test_swt_cascade_round_trip(self):
        rng = np.random.RandomState(32)
        jm, tm = meshes({"dp": 2, "sp": 4})
        x = rng.randn(512).astype(np.float32)
        bands = tpar.sharded_swt("sym", 8, 3, x, tm)
        jbands = _jit(lambda: jpar.sharded_swt("sym", 8, 3, x, jm))
        _close(tpar.sharded_swt_reconstruct("sym", 8, 3, bands, tm),
               _jit(lambda: jpar.sharded_swt_reconstruct(
                   "sym", 8, 3, jbands, jm)), x, 2e-4)

    def test_swt_batched(self):
        rng = np.random.RandomState(33)
        jm, tm = meshes({"dp": 2, "sp": 4})
        xb = rng.randn(3, 256).astype(np.float32)
        bands = tpar.sharded_swt("daub", 8, 2, xb, tm)
        jbands = _jit(lambda: jpar.sharded_swt("daub", 8, 2, xb, jm))
        want = twv.stationary_wavelet_transform(
            "daub", 8, twv.ExtensionType.PERIODIC, xb, 2, simd=False)
        for b, j, w in zip(bands, jbands, want):
            _close(b, j, w, 5e-4)
        _close(tpar.sharded_swt_reconstruct("daub", 8, 2, bands, tm),
               _jit(lambda: jpar.sharded_swt_reconstruct(
                   "daub", 8, 2, jbands, jm)), xb, 2e-4)

    def test_synthesis_halo_too_large_raises(self):
        _, tm = meshes({"sp": 8})
        bands = [np.zeros(64, np.float32)] * 4
        with pytest.raises(ValueError, match="halo"):
            tpar.sharded_swt_reconstruct("daub", 8, 3, bands, tm)


class TestShardedGeneralization:
    def test_batched_sharded_convolve(self):
        rng = np.random.RandomState(34)
        jm, tm = meshes({"sp": 8})
        xb = rng.randn(3, 256).astype(np.float32)
        h = rng.randn(17).astype(np.float32)
        got = tpar.sharded_convolve(xb, h, tm)
        jgot = np.asarray(jpar.sharded_convolve(xb, h, jm))
        for i in range(3):
            _close(got[i], jgot[i], np.convolve(xb[i], h), 1e-3)

    def test_batch_pad_and_slice(self):
        """batch % dp != 0 pads instead of raising."""
        rng = np.random.RandomState(35)
        jm, tm = meshes({"dp": 4, "sp": 2})
        x = rng.randn(5, 128).astype(np.float32)   # 5 % 4 != 0
        h = rng.randn(9).astype(np.float32)
        got = tpar.sharded_convolve_batch(x, h, tm)
        assert tuple(got.shape) == (5, 128 + 8)
        jgot = np.asarray(jpar.sharded_convolve_batch(x, h, jm))
        for i in range(5):
            _close(got[i], jgot[i], np.convolve(x[i], h), 1e-3)


class TestRingConvolve:
    """Multi-hop ring pipeline for filters longer than a shard block."""

    @pytest.mark.parametrize("n,k", [(1024, 300), (2048, 1500),
                                     (1024, 1024), (1000, 999)])
    def test_matches_oracle(self, n, k):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(41)
        x = rng.randn(n).astype(np.float32)
        h = rng.randn(k).astype(np.float32)
        want = _conv64(x, h)
        _rel_close(tpar.sharded_convolve_ring(x, h, tm),
                   jpar.sharded_convolve_ring(x, h, jm), want, 1e-4)

    def test_auto_selected_by_sharded_convolve(self):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(42)
        x = rng.randn(512).astype(np.float32)
        h = rng.randn(400).astype(np.float32)   # halo 399 > 512/8
        want = _conv64(x, h)
        _rel_close(tpar.sharded_convolve(x, h, tm),
                   jpar.sharded_convolve(x, h, jm), want, 1e-4)

    def test_batched(self):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(43)
        xb = rng.randn(3, 512).astype(np.float32)
        h = rng.randn(450).astype(np.float32)
        got = tpar.sharded_convolve_ring(xb, h, tm)
        jgot = np.asarray(jpar.sharded_convolve_ring(xb, h, jm))
        for i in range(3):
            want = _conv64(xb[i], h)
            _rel_close(got[i], jgot[i], want, 1e-4)

    def test_h_longer_than_x_works(self):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(49)
        x = rng.randn(64).astype(np.float32)
        h = rng.randn(200).astype(np.float32)
        want = _conv64(x, h)
        _rel_close(tpar.sharded_convolve_ring(x, h, tm),
                   jpar.sharded_convolve_ring(x, h, jm), want, 1e-4)


class TestRingConvolveBatched:
    def test_batch_axis_dpxsp(self):
        jm, tm = meshes({"dp": 2, "sp": 4})
        rng = np.random.RandomState(44)
        xb = rng.randn(5, 512).astype(np.float32)   # 5 % 2 != 0 too
        h = rng.randn(400).astype(np.float32)
        got = tpar.sharded_convolve_ring(xb, h, tm, axis="sp",
                                         batch_axis="dp")
        jgot = np.asarray(jpar.sharded_convolve_ring(
            xb, h, jm, axis="sp", batch_axis="dp"))
        assert tuple(got.shape) == (5, 911)
        for i in range(5):
            want = _conv64(xb[i], h)
            _rel_close(got[i], jgot[i], want, 1e-4)

    def test_batch_entry_falls_back_to_ring(self):
        jm, tm = meshes({"dp": 2, "sp": 4})
        rng = np.random.RandomState(45)
        xb = rng.randn(4, 256).astype(np.float32)
        h = rng.randn(250).astype(np.float32)   # halo 249 > block
        got = tpar.sharded_convolve_batch(xb, h, tm)
        jgot = np.asarray(jpar.sharded_convolve_batch(xb, h, jm))
        for i in range(4):
            want = _conv64(xb[i], h)
            _rel_close(got[i], jgot[i], want, 1e-4)

    def test_fft_hop_path(self):
        """Blocks big enough to cross AUTO_FFT_MIN_PRODUCT take the
        spectral per-hop form."""
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(46)
        x = rng.randn(1 << 15).astype(np.float32)
        h = rng.randn(1 << 14).astype(np.float32)
        want = _conv64(x, h)
        _rel_close(tpar.sharded_convolve_ring(x, h, tm),
                   jpar.sharded_convolve_ring(x, h, jm), want, 1e-4)


class TestRingConvolve2D:
    """2D ring pipeline: kernels larger than a shard tile."""

    @pytest.mark.parametrize("img,ker", [
        ((64, 64), (40, 30)),     # halo exceeds both tile dims
        ((48, 96), (48, 96)),     # kernel == image
        ((64, 64), (5, 60)),      # one axis rings, the other fits
        ((33, 57), (20, 41))])    # uneven sizes + padding
    def test_matches_oracle(self, img, ker):
        """Against the float64 oracle and the single-card op; against
        the JAX package on the first geometry (its compile dominates a
        case, and the auto-selection case below compares it too)."""
        jm, tm = meshes({"dp": 2, "sp": 4})
        rng = np.random.RandomState(47)
        x = rng.randn(*img).astype(np.float32)
        h = rng.randn(*ker).astype(np.float32)
        got = tpar.sharded_convolve2d_ring(x, h, tm)
        ref = (jpar.sharded_convolve2d_ring(x, h, jm)
               if (img, ker) == ((64, 64), (40, 30))
               else tcv2.convolve2d(x, h))
        _rel_close(got, ref, tcv2.convolve2d_na(x, h), 1e-4)

    def test_auto_selected_by_sharded_convolve2d(self):
        jm, tm = meshes({"dp": 2, "sp": 4})
        rng = np.random.RandomState(48)
        x = rng.randn(40, 40).astype(np.float32)
        h = rng.randn(30, 30).astype(np.float32)  # halo > tile
        _rel_close(tpar.sharded_convolve2d(x, h, tm),
                   jpar.sharded_convolve2d(x, h, jm),
                   tcv2.convolve2d_na(x, h), 1e-4)

    @pytest.mark.parametrize("ker", [(3, 12), (12, 3), (20, 20)])
    def test_kernel_larger_than_image_works(self, ker):
        _, tm = meshes({"dp": 2, "sp": 4})
        rng = np.random.RandomState(50)
        x = rng.randn(8, 8).astype(np.float32)
        h = rng.randn(*ker).astype(np.float32)
        _rel_close(tpar.sharded_convolve2d_ring(x, h, tm),
                   tcv2.convolve2d(x, h), tcv2.convolve2d_na(x, h), 1e-4)


class TestAllToAll2DWavelet:
    """The all-to-all pattern: rows local -> A2A transpose -> columns
    local; every extension exact."""

    @pytest.mark.parametrize("ext_name", ["periodic", "mirror",
                                          "constant", "zero"])
    def test_matches_single_chip_every_ext(self, ext_name):
        from veles.simd_tpu.ops import wavelet as jwv

        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(52)
        img = rng.randn(64, 96).astype(np.float32)
        got = tpar.sharded_wavelet_apply2d(
            "daub", 8, twv.ExtensionType(ext_name), img, tm)
        jgot = _jit(lambda: jpar.sharded_wavelet_apply2d(
            "daub", 8, jwv.ExtensionType(ext_name), img, jm))
        want = twv.wavelet_apply2d("daub", 8, twv.ExtensionType(ext_name),
                                   img, simd=False)
        single = twv.wavelet_apply2d("daub", 8,
                                     twv.ExtensionType(ext_name), img,
                                     simd=True)
        for g, j, w, s in zip(got, jgot, want, single):
            _close(g, j, w, 5e-4)
            _close(g, g, s, 5e-4)

    def test_round_trip(self):
        jm, tm = meshes({"sp": 4, "dp": 2})
        rng = np.random.RandomState(53)
        img = rng.randn(64, 64).astype(np.float32)
        bands = tpar.sharded_wavelet_apply2d(
            "sym", 8, twv.ExtensionType.PERIODIC, img, tm, axis="sp")
        jbands = _jit(lambda: jpar.sharded_wavelet_apply2d(
            "sym", 8, "periodic", img, jm, axis="sp"))
        _close(tpar.sharded_wavelet_reconstruct2d("sym", 8, *bands, tm,
                                                  axis="sp"),
               _jit(lambda: jpar.sharded_wavelet_reconstruct2d(
                   "sym", 8, *jbands, jm, axis="sp")), img, 2e-4)

    def test_divisibility_contract(self):
        _, tm = meshes({"sp": 8})
        with pytest.raises(ValueError, match="divisible"):
            tpar.sharded_wavelet_apply2d(
                "daub", 8, twv.ExtensionType.PERIODIC,
                np.zeros((60, 64), np.float32), tm)


class TestShardedDWTAnalysis:
    def test_matches_single_chip(self):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(54)
        x = rng.randn(512).astype(np.float32)
        hi, lo = tpar.sharded_wavelet_apply("daub", 8, x, tm)
        jhi, jlo = _jit(lambda: jpar.sharded_wavelet_apply("daub", 8, x, jm))
        whi, wlo = twv.wavelet_apply_na("daub", 8,
                                        twv.ExtensionType.PERIODIC, x)
        _close(hi, jhi, whi, 5e-4)
        _close(lo, jlo, wlo, 5e-4)

    def test_full_sharded_round_trip(self):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(55)
        x = rng.randn(1024).astype(np.float32)
        hi, lo = tpar.sharded_wavelet_apply("sym", 12, x, tm)
        jhi, jlo = _jit(lambda: jpar.sharded_wavelet_apply("sym", 12, x, jm))
        _close(tpar.sharded_wavelet_reconstruct("sym", 12, hi, lo, tm),
               _jit(lambda: jpar.sharded_wavelet_reconstruct(
                   "sym", 12, jhi, jlo, jm)), x, 2e-4)

    def test_batched(self):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(56)
        xb = rng.randn(3, 512).astype(np.float32)
        hi, lo = tpar.sharded_wavelet_apply("daub", 8, xb, tm)
        jhi, jlo = _jit(lambda: jpar.sharded_wavelet_apply("daub", 8, xb, jm))
        whi, wlo = twv.wavelet_apply_na("daub", 8,
                                        twv.ExtensionType.PERIODIC, xb)
        _close(hi, jhi, whi, 5e-4)
        _close(lo, jlo, wlo, 5e-4)

    def test_contracts(self):
        _, tm = meshes({"sp": 8})
        with pytest.raises(ValueError, match="divisible"):
            tpar.sharded_wavelet_apply("daub", 8,
                                       np.zeros(1004, np.float32), tm)
        with pytest.raises(ValueError, match="halo"):
            tpar.sharded_wavelet_apply("daub", 76,
                                       np.zeros(512, np.float32), tm)

    def test_multi_level_cascade_round_trip(self):
        jm, tm = meshes({"sp": 4, "dp": 2})
        rng = np.random.RandomState(57)
        x = rng.randn(1024).astype(np.float32)
        coeffs = tpar.sharded_wavelet_transform("daub", 8, x, 3, tm,
                                                axis="sp")
        jcoeffs = _jit(lambda: jpar.sharded_wavelet_transform(
            "daub", 8, x, 3, jm, axis="sp"))
        want = twv.wavelet_transform("daub", 8, twv.ExtensionType.PERIODIC,
                                     x, 3, simd=False)
        assert len(coeffs) == 4
        for c, j, w in zip(coeffs, jcoeffs, want):
            _close(c, j, w, 5e-4)
        _close(tpar.sharded_wavelet_inverse_transform("daub", 8, coeffs,
                                                      tm, axis="sp"),
               _jit(lambda: jpar.sharded_wavelet_inverse_transform(
                   "daub", 8, jcoeffs, jm, axis="sp")),
               x, 5e-4)


class TestShardedSTFT:
    """Sequence-parallel STFT/ISTFT vs the single-chip spectral ops."""

    def test_matches_single_chip(self):
        from veles.simd_tpu.ops import spectral as jsp

        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(58)
        n, fl, hop = 4096, 256, 64
        x = rng.randn(n).astype(np.float32)
        got = tpar.sharded_stft(x, fl, hop, tm)
        want = np.asarray(jsp.stft(x, fl, hop, simd=True))
        assert tuple(got.shape) == want.shape == (
            tsp.frame_count(n, fl, hop), fl // 2 + 1)
        _close(got, jpar.sharded_stft(x, fl, hop, jm), want, 1e-3)
        _close(got, got, tsp.stft(x, fl, hop, simd=True), 1e-3)

    def test_round_trip(self):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(59)
        n, fl, hop = 2048, 128, 32
        x = rng.randn(n).astype(np.float32)
        spec = tpar.sharded_stft(x, fl, hop, tm)
        rec = _np(tpar.sharded_istft(spec, n, fl, hop, tm))
        jspec = jpar.sharded_stft(x, fl, hop, jm)
        jrec = np.asarray(jpar.sharded_istft(jspec, n, fl, hop, jm))
        # interior exact; boundary frames normalized by partial envelope
        _close(rec[fl:n - fl], jrec[fl:n - fl], x[fl:n - fl], 1e-3)

    def test_istft_matches_single_chip(self):
        from veles.simd_tpu.ops import spectral as jsp

        jm, tm = meshes({"dp": 2, "sp": 4})
        rng = np.random.RandomState(60)
        n, fl, hop = 1024, 128, 64
        x = rng.randn(n).astype(np.float32)
        spec = np.asarray(jsp.stft(x, fl, hop, simd=True))
        got = tpar.sharded_istft(spec, n, fl, hop, tm, axis="sp")
        want = np.asarray(jsp.istft(spec, n, fl, hop, simd=True))
        _close(got, jpar.sharded_istft(spec, n, fl, hop, jm, axis="sp"),
               want, 1e-3)
        _close(got, got, tsp.istft(spec, n, fl, hop, simd=True), 1e-3)

    def test_hop_equals_frame_length(self):
        """Zero overlap: the halo path degenerates to empty exchanges."""
        jm, tm = meshes({"dp": 2, "sp": 4})
        rng = np.random.RandomState(61)
        n, fl = 1024, 64
        x = rng.randn(n).astype(np.float32)
        got = tpar.sharded_stft(x, fl, fl, tm)
        want = tsp.stft(x, fl, fl, simd=True)
        _close(got, jpar.sharded_stft(x, fl, fl, jm), want, 1e-3)
        rec = tpar.sharded_istft(got, n, fl, fl, tm)
        wrec = tsp.istft(want, n, fl, fl, simd=True)
        _close(rec, jpar.sharded_istft(_np(got), n, fl, fl, jm), wrec,
               1e-3)

    def test_batched(self):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(62)
        xb = rng.randn(3, 2048).astype(np.float32)
        _close(tpar.sharded_stft(xb, 128, 32, tm),
               jpar.sharded_stft(xb, 128, 32, jm),
               tsp.stft(xb, 128, 32, simd=True), 1e-3)

    def test_contracts(self):
        _, tm = meshes({"sp": 8})
        x = np.zeros(4096, np.float32)
        with pytest.raises(ValueError, match="divisible"):
            tpar.sharded_stft(np.zeros(4095, np.float32), 256, 64, tm)
        with pytest.raises(ValueError, match="hop"):
            tpar.sharded_stft(x, 256, 96, tm)  # 512 % 96 != 0
        with pytest.raises(ValueError, match="overlap"):
            tpar.sharded_stft(x, 1024, 64, tm)  # halo 960 > block 512
        with pytest.raises(ValueError, match="inconsistent"):
            tpar.sharded_istft(np.zeros((3, 129), np.complex64), 4096,
                               256, 64, tm)


class TestShardedSosfilt:
    """Sequence-parallel IIR vs the single-chip cascade."""

    def test_matches_single_chip(self):
        from veles.simd_tpu.ops import iir as jiir

        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(63)
        sos = jiir.butterworth(4, 0.25, "lowpass")
        x = rng.randn(4096).astype(np.float32)
        want = np.asarray(jiir.sosfilt(sos, x, simd=True))
        scale = max(1.0, np.abs(want).max())
        got = tpar.sharded_sosfilt(sos, x, tm)
        _close(got, _jit(lambda: jpar.sharded_sosfilt(sos, x, jm)), want,
               5e-5 * scale)
        _close(got, got, tiir.sosfilt(sos, x, simd=True), 5e-5 * scale)

    def test_matches_oracle_bandpass(self):
        _, tm = meshes({"dp": 2, "sp": 4})
        rng = np.random.RandomState(64)
        sos = tiir.butterworth(3, (0.2, 0.5), "bandpass")
        x = rng.randn(1024).astype(np.float32)
        want = tiir.sosfilt_na(sos, x)
        scale = max(1.0, np.abs(want).max())
        got = tpar.sharded_sosfilt(sos, x, tm, axis="sp")
        _close(got, tiir.sosfilt(sos, x, simd=True), want, 5e-5 * scale)

    def test_batched(self):
        _, tm = meshes({"sp": 8})
        rng = np.random.RandomState(65)
        sos = tiir.butterworth(2, 0.3, "highpass")
        xb = rng.randn(3, 2048).astype(np.float32)
        _close(tpar.sharded_sosfilt(sos, xb, tm),
               tiir.sosfilt(sos, xb, simd=True),
               tiir.sosfilt_na(sos, xb), 5e-5)

    def test_state_crosses_every_boundary(self):
        """An impulse in shard 0 rings through all later shards."""
        jm, tm = meshes({"sp": 8})
        sos = tiir.butterworth(2, 0.005, "lowpass")
        x = np.zeros(1024, np.float32)
        x[3] = 1.0
        got = _np(tpar.sharded_sosfilt(sos, x, tm))
        jgot = np.asarray(_jit(lambda: jpar.sharded_sosfilt(sos, x, jm)))
        want = tiir.sosfilt_na(sos, x)
        for s in range(8):
            blk = slice(s * 128, (s + 1) * 128)
            assert np.max(np.abs(want[blk])) > 1e-9
            _close(got[blk], jgot[blk], want[blk], 1e-5)

    def test_contracts(self):
        _, tm = meshes({"sp": 8})
        sos = tiir.butterworth(2, 0.3, "lowpass")
        with pytest.raises(ValueError, match="divisible"):
            tpar.sharded_sosfilt(sos, np.zeros(1001, np.float32), tm)


class TestShardedWelch:
    def test_matches_single_chip(self):
        from veles.simd_tpu.ops import spectral as jsp

        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(66)
        x = rng.randn(8192).astype(np.float32)
        f1, p1 = tpar.sharded_welch(x, tm, fs=100.0, nperseg=256)
        jf, jp = jpar.sharded_welch(x, jm, fs=100.0, nperseg=256)
        f2, p2 = jsp.welch(x, fs=100.0, nperseg=256, simd=True)
        np.testing.assert_allclose(f1, f2, atol=1e-12)
        np.testing.assert_allclose(f1, jf, atol=1e-12)
        _close(p1, jp, p2, 1e-5 * float(np.max(p2)))
        _close(p1, p1, tsp.welch(x, fs=100.0, nperseg=256, simd=True)[1],
               1e-5 * float(np.max(p2)))

    def test_tone_peak_and_overhang_mask(self):
        from veles.simd_tpu.ops import spectral as jsp

        _, tm = meshes({"dp": 2, "sp": 4})
        fs, n = 1000.0, 4096
        t = np.arange(n) / fs
        x = np.sin(2 * np.pi * 125.0 * t).astype(np.float32)
        f1, p1 = tpar.sharded_welch(x, tm, axis="sp", fs=fs, nperseg=512,
                                    noverlap=384)
        _, p2 = jsp.welch(x, fs=fs, nperseg=512, noverlap=384, simd=True)
        _close(p1, p1, p2, 1e-5 * float(np.max(p2)))
        assert abs(f1[int(np.argmax(_np(p1)))] - 125.0) < fs / 512

    def test_contracts(self):
        _, tm = meshes({"sp": 8})
        with pytest.raises(ValueError, match="divisible"):
            tpar.sharded_welch(np.zeros(4095, np.float32), tm)


class TestShardedResample:
    @pytest.mark.parametrize("n,up,down", [
        (2048, 2, 1), (2048, 1, 4), (2352, 160, 147), (4096, 3, 2)])
    def test_matches_single_chip(self, n, up, down):
        from veles.simd_tpu.ops import resample as jrs

        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(67)
        x = rng.randn(n).astype(np.float32)
        got = tpar.sharded_resample_poly(x, up, down, tm)
        want = np.asarray(jrs.resample_poly(x, up, down, simd=True))
        _close(got, jpar.sharded_resample_poly(x, up, down, jm), want,
               1e-5)
        _close(got, got, trs.resample_poly(x, up, down, simd=True), 1e-5)

    def test_batched_and_2d_mesh(self):
        jm, tm = meshes({"dp": 2, "sp": 4})
        rng = np.random.RandomState(68)
        xb = rng.randn(3, 1024).astype(np.float32)
        _close(tpar.sharded_resample_poly(xb, 2, 1, tm, axis="sp"),
               jpar.sharded_resample_poly(xb, 2, 1, jm, axis="sp"),
               trs.resample_poly(xb, 2, 1, simd=True), 1e-5)

    def test_tone_preserved(self):
        """48k -> 44.1k of a tone keeps its frequency."""
        jm, tm = meshes({"sp": 8})
        fs = 48000.0
        n = 2352 * 4
        t = np.arange(n) / fs
        x = np.sin(2 * np.pi * 997.0 * t).astype(np.float32)
        y = _np(tpar.sharded_resample_poly(x, 160, 147, tm))
        jy = np.asarray(jpar.sharded_resample_poly(x, 160, 147, jm))
        t2 = np.arange(len(y)) * 147 / (160 * fs)
        core = slice(400, -400)
        _close(y[core], jy[core], np.sin(2 * np.pi * 997.0 * t2)[core],
               5e-3)

    def test_contracts(self):
        _, tm = meshes({"sp": 8})
        with pytest.raises(ValueError, match="divisible into"):
            tpar.sharded_resample_poly(np.zeros(1001, np.float32), 2, 1,
                                       tm)
        with pytest.raises(ValueError, match="ownership"):
            tpar.sharded_resample_poly(np.zeros(2048, np.float32), 160,
                                       147, tm)

    def test_empty_signal(self):
        _, tm = meshes({"sp": 8})
        with pytest.raises(ValueError, match="empty"):
            tpar.sharded_resample_poly(np.zeros(0, np.float32), 2, 1, tm)


class TestSharded2DSWT:
    @pytest.mark.parametrize("ext_name", ["periodic", "mirror",
                                          "constant", "zero"])
    def test_matches_single_chip_every_ext(self, ext_name):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(61)
        img = rng.randn(64, 48).astype(np.float32)
        got = tpar.sharded_swt_apply2d("daub", 8, 2,
                                       twv.ExtensionType(ext_name), img, tm)
        jgot = _jit(lambda: jpar.sharded_swt_apply2d(
            "daub", 8, 2, ext_name, img, jm))
        want = twv.stationary_wavelet_apply2d(
            "daub", 8, 2, twv.ExtensionType(ext_name), img, simd=False)
        for g, j, w in zip(got, jgot, want):
            _close(g, j, w, 5e-4)

    def test_contracts(self):
        _, tm = meshes({"sp": 8})
        with pytest.raises(ValueError, match="divisible"):
            tpar.sharded_swt_apply2d("daub", 8, 1,
                                     twv.ExtensionType.PERIODIC,
                                     np.zeros((60, 48), np.float32), tm)


class TestSharded2DPackets:
    def test_leaves_match_single_chip(self):
        jm, tm = meshes({"sp": 4, "dp": 2})
        rng = np.random.RandomState(62)
        img = rng.randn(64, 64).astype(np.float32)
        got = tpar.sharded_wavelet_packet_transform2d(
            "daub", 4, twv.ExtensionType.PERIODIC, img, 2, tm, axis="sp")
        jgot = _jit(lambda: jpar.sharded_wavelet_packet_transform2d(
            "daub", 4, "periodic", img, 2, jm, axis="sp"))
        want = twv.wavelet_packet_transform2d(
            "daub", 4, twv.ExtensionType.PERIODIC, img, 2, simd=False)
        assert len(got) == len(jgot) == len(want) == 16
        for g, j, w in zip(got, jgot, want):
            _close(g, j, w, 5e-4)

    def test_contracts(self):
        _, tm = meshes({"sp": 8})
        with pytest.raises(ValueError, match="divisible"):
            tpar.sharded_wavelet_packet_transform2d(
                "daub", 4, twv.ExtensionType.PERIODIC,
                np.zeros((48, 64), np.float32), 2, tm)  # 48 % 32 != 0
        with pytest.raises(ValueError, match="levels"):
            tpar.sharded_wavelet_packet_transform2d(
                "daub", 4, twv.ExtensionType.PERIODIC,
                np.zeros((64, 64), np.float32), 0, tm)


class TestShardedRankFilters:
    """The open ppermute edge IS the single-chip zero padding."""

    @pytest.mark.parametrize("k", [3, 9, 15])
    def test_medfilt_exact(self, k):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(63)
        x = rng.randn(2048).astype(np.float32)
        got = tpar.sharded_medfilt(x, k, tm)
        _close(got, _jit(lambda: jpar.sharded_medfilt(x, k, jm)),
               tfl.medfilt_na(x, k), 1e-6)
        _close(got, got, tfl.medfilt(x, k, simd=True), 1e-6)

    def test_order_filter_erode(self):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(64)
        x = rng.randn(1024).astype(np.float32)
        _close(tpar.sharded_order_filter(x, 0, 7, tm),
               _jit(lambda: jpar.sharded_order_filter(x, 0, 7, jm)),
               tfl.order_filter_na(x, 0, 7), 1e-6)

    def test_contracts(self):
        _, tm = meshes({"sp": 8})
        with pytest.raises(ValueError, match="halo"):
            tpar.sharded_medfilt(np.zeros(64, np.float32), 31, tm)
        with pytest.raises(ValueError, match="rank"):
            tpar.sharded_order_filter(np.zeros(64, np.float32), 9, 9, tm)


class TestShardedSavgol:
    @pytest.mark.parametrize("mode", ["interp", "constant", "nearest"])
    @pytest.mark.parametrize("deriv", [0, 1])
    def test_matches_single_chip(self, mode, deriv):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(65)
        x = rng.randn(1024).astype(np.float32)
        want = tfl.savgol_filter(x, 11, 3, deriv=deriv, delta=0.5,
                                 mode=mode, simd=False)
        scale = max(1.0, np.max(np.abs(want)))
        _close(tpar.sharded_savgol_filter(x, 11, 3, tm, deriv=deriv,
                                          delta=0.5, mode=mode),
               _jit(lambda: jpar.sharded_savgol_filter(
                   x, 11, 3, jm, deriv=deriv, delta=0.5, mode=mode)),
               want, 5e-4 * scale)

    def test_quadratic_reproduced_interp(self):
        jm, tm = meshes({"sp": 8})
        t = np.linspace(-1, 1, 512)
        x = (3 * t * t - 0.5 * t + 1).astype(np.float32)
        _close(tpar.sharded_savgol_filter(x, 9, 2, tm),
               _jit(lambda: jpar.sharded_savgol_filter(x, 9, 2, jm)), x, 1e-4)

    def test_contracts(self):
        _, tm = meshes({"sp": 8})
        with pytest.raises(ValueError, match="mode"):
            tpar.sharded_savgol_filter(np.zeros(512, np.float32), 9, 2,
                                       tm, mode="wrap")
        with pytest.raises(ValueError, match="reach"):
            tpar.sharded_savgol_filter(np.zeros(64, np.float32), 15, 2,
                                       tm, mode="interp")


class TestShardedLombScargle:
    def test_matches_oracle(self):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(66)
        t = np.sort(rng.rand(1024)) * 100.0
        x = (np.sin(1.3 * t) + 0.4 * rng.randn(1024)).astype(np.float32)
        freqs = np.linspace(0.5, 3.0, 64)
        want = tsp.lombscargle_na(t, x, freqs)
        _close(tpar.sharded_lombscargle(t, x, freqs, tm),
               _jit(lambda: jpar.sharded_lombscargle(t, x, freqs, jm)), want,
               1e-3 * np.max(want))

    def test_finds_planted_tone(self):
        _, tm = meshes({"sp": 8})
        rng = np.random.RandomState(67)
        t = np.sort(rng.rand(2048)) * 200.0
        x = np.cos(2.1 * t).astype(np.float32)
        freqs = np.linspace(0.5, 4.0, 128)
        p = _np(tpar.sharded_lombscargle(t, x, freqs, tm))
        assert abs(freqs[np.argmax(p)] - 2.1) < 0.05

    def test_contracts(self):
        _, tm = meshes({"sp": 8})
        with pytest.raises(ValueError, match="positive"):
            tpar.sharded_lombscargle(np.arange(64.0),
                                     np.zeros(64, np.float32),
                                     np.array([-1.0]), tm)

    def test_indivisible_length_padded_exactly(self):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(68)
        n = 1021                               # prime, 1021 % 8 = 5
        t = np.sort(rng.rand(n)) * 100.0
        x = (np.sin(1.3 * t) + 0.4 * rng.randn(n)).astype(np.float32)
        freqs = np.linspace(0.5, 3.0, 64)
        want = tsp.lombscargle_na(t, x, freqs)
        _close(tpar.sharded_lombscargle(t, x, freqs, tm),
               _jit(lambda: jpar.sharded_lombscargle(t, x, freqs, jm)), want,
               1e-3 * np.max(want))

    def test_weights_channel(self):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(69)
        n = 1024
        t = np.sort(rng.rand(n)) * 100.0
        x = (np.sin(1.3 * t) + 0.4 * rng.randn(n)).astype(np.float32)
        w = np.ones(n)
        w[100:200] = 0.0
        freqs = np.linspace(0.5, 3.0, 64)
        want = tsp.lombscargle_na(np.delete(t, np.s_[100:200]),
                                  np.delete(x, np.s_[100:200]), freqs)
        _close(tpar.sharded_lombscargle(t, x, freqs, tm, weights=w),
               _jit(lambda: jpar.sharded_lombscargle(t, x, freqs, jm,
                                                     weights=w)),
               want, 1e-3 * np.max(want))


class TestShardedNormalize2d:
    def test_matches_single_chip(self):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(90)
        img = rng.randint(0, 256, (64, 48)).astype(np.uint8)
        _close(tpar.sharded_normalize2d(img, tm),
               _jit(lambda: jpar.sharded_normalize2d(img, jm)),
               tnm.normalize2D(img, simd=True), 1e-6)

    def test_indivisible_rows_and_flat_plane(self):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(91)
        img = rng.randint(0, 256, (61, 33)).astype(np.uint8)  # 61 % 8 != 0
        got = tpar.sharded_normalize2d(img, tm)
        assert tuple(got.shape) == (61, 33)
        _close(got, _jit(lambda: jpar.sharded_normalize2d(img, jm)),
               tnm.normalize2D(img, simd=True), 1e-6)
        flat = np.full((16, 8), 7, np.uint8)
        np.testing.assert_array_equal(
            _np(tpar.sharded_normalize2d(flat, tm)),
            np.zeros((16, 8), np.float32))

    def test_flat_plane_clean_under_debug_nans(self):
        """The guarded denominator manufactures no inf/nan on a flat
        plane: the shard body's every intermediate stays finite."""
        _, tm = meshes({"sp": 8})
        flat = torch.full((16, 8), 3, dtype=torch.uint8)
        seen = []
        real_where = torch.where

        def where(cond, a, b):
            for v in (a, b):
                if isinstance(v, torch.Tensor) and v.is_floating_point():
                    seen.append(bool(torch.isfinite(v).all()))
            return real_where(cond, a, b)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch, "where", where)
            got = _np(tpar.sharded_normalize2d(flat, tm))
        assert seen and all(seen)
        np.testing.assert_array_equal(got, np.zeros((16, 8), np.float32))

    def test_fewer_rows_than_shards_and_float_dtype(self):
        jm, tm = meshes({"sp": 8})
        rng = np.random.RandomState(92)
        tiny = rng.randint(0, 256, (3, 12)).astype(np.uint8)  # 3 < 8
        got = tpar.sharded_normalize2d(tiny, tm)
        assert tuple(got.shape) == (3, 12)
        _close(got, _jit(lambda: jpar.sharded_normalize2d(tiny, jm)),
               tnm.normalize2D(tiny, simd=True), 1e-6)
        fimg = rng.randn(19, 7).astype(np.float32)
        _close(tpar.sharded_normalize2d(fimg, tm),
               _jit(lambda: jpar.sharded_normalize2d(fimg, jm)),
               tnm.normalize2D(fimg, simd=True), 1e-6)


# ---------------------------------------------------------------------------
# the port's own: the shard runner, operands, the resource row
# ---------------------------------------------------------------------------

class TestShardRunner:
    def test_halo_exchanges_follow_the_jax_permutations(self):
        """Open edges get zeros, the periodic hop wraps last→first, on
        the public per-shard halo functions."""
        _, tm = meshes({"sp": 8})
        x = torch.arange(64, dtype=torch.float32)

        def body(x_local):
            return (tpar.halo_exchange_left(x_local, 2, "sp"),
                    tpar.halo_exchange_right(x_local, 2, "sp"),
                    tpar.halo_exchange_left(x_local, 2, "sp", True),
                    tpar.halo_exchange_right(x_local, 2, "sp", True))

        left, right, pleft, pright = (
            _np(o).reshape(8, 2) for o in _spmd.shard_map(
                body, tm, in_specs=P("sp"), out_specs=P("sp"))(x))
        blocks = np.arange(64, dtype=np.float32).reshape(8, 8)
        for s in range(8):
            want_l = blocks[s - 1, -2:] if s else np.zeros(2)
            want_r = blocks[s + 1, :2] if s < 7 else np.zeros(2)
            np.testing.assert_array_equal(left[s], want_l)
            np.testing.assert_array_equal(right[s], want_r)
            np.testing.assert_array_equal(pleft[s], blocks[s - 1, -2:])
            np.testing.assert_array_equal(pright[s],
                                          blocks[(s + 1) % 8, :2])

    def test_collectives_on_a_2d_mesh(self):
        """psum/all_gather/all_to_all act along one axis of dp2×sp4,
        in shard order; P() replicates."""
        _, tm = meshes({"dp": 2, "sp": 4})
        x = torch.arange(8, dtype=torch.float32).reshape(2, 4)

        def body(v, c):
            s = _spmd.psum(v, "sp")
            g = _spmd.all_gather(v, "sp")
            total = _spmd.psum(v, ("dp", "sp"))
            idx = _spmd.axis_index("dp") * 10 + _spmd.axis_index("sp")
            return s, g.reshape(1, 1, 4), total, v * 0 + idx + c

        s, g, total, idx = _spmd.shard_map(
            body, tm, in_specs=(P("dp", "sp"), P()),
            out_specs=(P("dp", "sp"), P("dp", "sp", None), P(),
                       P("dp", "sp")))(x, torch.tensor(0.5))
        np.testing.assert_array_equal(_np(s), [[6] * 4, [22] * 4])
        np.testing.assert_array_equal(_np(g)[1, 2], [4, 5, 6, 7])
        assert float(_np(total).sum()) == 28.0
        np.testing.assert_array_equal(_np(idx), [[0.5, 1.5, 2.5, 3.5],
                                                 [10.5, 11.5, 12.5, 13.5]])

    def test_a_failing_shard_stops_its_siblings(self):
        _, tm = meshes({"sp": 8})

        def body(v):
            if _spmd.axis_index("sp") == 3:
                raise RuntimeError("shard 3 fails")
            return _spmd.psum(v, "sp")

        with pytest.raises(RuntimeError, match="shard 3"):
            _spmd.shard_map(body, tm, in_specs=P("sp"),
                            out_specs=P())(torch.zeros(8))

    def test_shard_threads_are_pooled_and_calls_never_wait(self):
        """A second call reuses the first call's shard threads; calls
        from two threads at once each get all their shards at once."""
        import threading

        _, tm = meshes({"sp": 8})

        def body(v):
            return _spmd.psum(v * 0 + threading.get_ident(), "sp")

        def idents():
            seen = []
            _spmd.shard_map(lambda v: seen.append(threading.get_ident())
                            or body(v), tm, in_specs=P("sp"),
                            out_specs=P())(torch.zeros(8))
            return set(seen)

        first = idents()
        assert len(first) == 8 and idents() <= first
        outs = []
        callers = [threading.Thread(target=lambda: outs.append(
            tpar.sharded_sosfilt(tiir.butterworth(2, 0.3),
                                 np.ones(1024, np.float32), tm)))
            for _ in range(2)]
        for t in callers:
            t.start()
        for t in callers:
            t.join(timeout=60)
        assert len(outs) == 2
        np.testing.assert_array_equal(_np(outs[0]), _np(outs[1]))

    def test_indivisible_spec_and_collectives_outside_a_body_raise(self):
        _, tm = meshes({"sp": 8})
        with pytest.raises(ValueError, match="divisible"):
            _spmd.shard_map(lambda v: v, tm, in_specs=P("sp"),
                            out_specs=P("sp"))(torch.zeros(12))
        with pytest.raises(RuntimeError, match="inside"):
            _spmd.psum(torch.zeros(2), "sp")

    def test_operand_on_another_kind_of_device_raises(self):
        """A mesh of 'meta' devices refuses a CPU operand, and the
        reverse: no operand moves between kinds of device."""
        meta = tpar.make_mesh({"sp": 8}, devices=["meta"] * 8)
        with pytest.raises(ValueError, match="mesh of meta"):
            tpar.sharded_convolve(torch.zeros(64), torch.zeros(3), meta)
        _, tm = meshes({"sp": 8})
        with pytest.raises(ValueError, match="mesh of cpu"):
            tpar.sharded_matmul(torch.zeros(4, 8, device="meta"),
                                torch.zeros(8, 4, device="meta"), tm)

    def test_results_are_tensors_on_the_first_device(self):
        _, tm = meshes({"sp": 8})
        got = tpar.sharded_convolve(torch.ones(64), torch.ones(3), tm)
        assert isinstance(got, torch.Tensor)
        assert got.device == tm.first_device() and got.dtype == \
            torch.float32

    def test_resource_row_and_decision_event(self):
        _, tm = meshes({"tp": 8})
        tobs.enable()
        tobs.reset()
        try:
            tpar.sharded_matmul(RNG.randn(16, 64), RNG.randn(64, 8), tm)
            rows = tobs.resources()
            assert any(r["op"] == "sharded_matmul"
                       and r["route"] == "shard_map" for r in rows)
            ev = [e for e in tobs.events() if e["op"] == "sharded_matmul"]
            assert ev[-1]["decision"] == "contracting_dim"
            assert tobs.counter_value("mesh_degrade",
                                      op="sharded_matmul") == 0
        finally:
            tobs.disable()
            tobs.reset()


# ---------------------------------------------------------------------------
# mesh-loss degradation (tests/test_breaker.py's TestMeshDegrade)
# ---------------------------------------------------------------------------

@pytest.fixture
def telemetry(monkeypatch):
    monkeypatch.setenv("VELES_SIMD_FAULT_BACKOFF", "0")
    tobs.enable()
    tobs.reset()
    tbreaker.reset()
    tfaults.reset_fault_history()
    yield
    tobs.disable()
    tobs.reset()
    tbreaker.reset()
    tfaults.reset_fault_history()
    tfaults.set_fault_plan(None)


class TestMeshDegrade:
    def test_matmul_degrades_and_recovers(self, telemetry, monkeypatch):
        monkeypatch.setenv(tbreaker.BREAKER_PROBE_EVERY_ENV, "2")
        _, tm = meshes({"sp": 8})
        a = RNG.randn(16, 64).astype(np.float32)
        b = RNG.randn(64, 8).astype(np.float32)
        want = a.astype(np.float64) @ b.astype(np.float64)

        def check():
            got = _np(tpar.sharded_matmul(a, b, tm, axis="sp"))
            np.testing.assert_allclose(got, want, atol=1e-3)

        check()     # healthy sharded dispatch
        assert tobs.counter_value("mesh_degrade",
                                  op="sharded_matmul") == 0
        with tfaults.fault_plan(
                "parallel.sharded_matmul:device_lost:9999"):
            for _ in range(5):
                check()     # answered by the single-card twin
            br = tbreaker.lookup("parallel.dispatch",
                                 ("sharded_matmul", "sp8@sp"))
            assert br is not None and br.state != tbreaker.CLOSED
            assert tobs.counter_value("mesh_degrade",
                                      op="sharded_matmul") >= 2
            events = [e for e in tobs.events()
                      if e["op"] == "mesh_degrade"]
            assert events and events[0]["mesh"] == "sp8@sp"
            retries = tobs.counter_value(
                "fault_retry", site="parallel.sharded_matmul")
            check()
            assert tobs.counter_value(
                "fault_retry",
                site="parallel.sharded_matmul") == retries
        for _ in range(4):
            check()
        assert br.state == tbreaker.CLOSED

    def test_sharded_stft_degrades_to_single_chip(self, telemetry):
        _, tm = meshes({"sp": 8})
        x = RNG.randn(2048).astype(np.float32)
        with tfaults.fault_plan("parallel.sharded_stft:device_lost:3"):
            got = _np(tpar.sharded_stft(x, 256, 128, tm))
        want = _np(tsp.stft(x, 256, 128))
        assert got.shape == want.shape
        scale = float(np.max(np.abs(want))) or 1.0
        assert float(np.max(np.abs(got - want)) / scale) < 2e-3
        assert tobs.counter_value("mesh_degrade", op="sharded_stft") == 1


# ---------------------------------------------------------------------------
# the JAX lint rules of parallel/, on the port's sources
# ---------------------------------------------------------------------------

def _lint():
    import sys
    from pathlib import Path

    tools = Path(__file__).resolve().parent.parent / "tools"
    if str(tools) not in sys.path:
        sys.path.insert(0, str(tools))
    import lint

    return lint


def _source(name):
    from pathlib import Path

    path = (Path(__file__).resolve().parent.parent / "veles"
            / "simd_tpu_torch" / "parallel" / f"{name}.py")
    return path.read_text().replace("veles.simd_tpu_torch",
                                    "veles.simd_tpu")


def _compute_rule_errors(text, fname):
    """``tools/lint.py``'s ops/parallel rules on one source: the fault
    handler, routing selector and precision rules, and the telemetry
    rule (obs only through the approved helpers, no raw clocks)."""
    import ast

    lint = _lint()
    tree = ast.parse(text)
    errors = (lint.fault_handler_errors(tree, fname)
              + lint.routing_selector_errors(tree, fname)
              + lint.precision_literal_errors(tree, fname))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)):
            if node.value.id == "obs" and \
                    node.attr not in lint._OBS_APPROVED:
                errors.append(f"{fname}:{node.lineno}: obs.{node.attr}")
            if node.value.id == "time" and \
                    node.attr in lint._TIME_FORBIDDEN:
                errors.append(f"{fname}:{node.lineno}: time.{node.attr}")
    return errors


@pytest.mark.parametrize("name", ["ops", "fourier"])
def test_parallel_lint_rules_pass_on_the_port(name):
    import ast

    lint = _lint()
    text = _source(name)
    fname = f"veles/simd_tpu/parallel/{name}.py"
    assert _compute_rule_errors(text, fname) == []
    if name == "ops":
        assert lint.parallel_guard_errors(ast.parse(text), fname) == []
    else:
        assert lint.spectral_dispatch_errors(ast.parse(text), fname) == []


def test_the_parallel_lint_rules_are_not_vacuous():
    import ast

    lint = _lint()
    ops_text = _source("ops")
    bare = ops_text + (
        "\n\ndef _bare(x, mesh):\n"
        "    jfn = _instrumented('bare', lambda v: v)\n"
        "    return jfn(x)\n")
    errors = lint.parallel_guard_errors(ast.parse(bare), "ops.py")
    assert len(errors) == 1 and "faults.guarded" in errors[0]
    gauged = ops_text.replace(
        '        obs.count("mesh_degrade", op=op)\n',
        '        obs.count("mesh_degrade", op=op)\n'
        '        obs.gauge("mesh_degrade_last", 1)\n')
    assert gauged != ops_text
    assert _compute_rule_errors(gauged, "ops.py")
    four = _source("fourier")
    leak = four + (
        "\n\ndef leak(x, mesh):\n"
        "    return _RFFT_ROUTES['local_fft'](x, mesh, 'sp', 0, 0)\n")
    errors = lint.spectral_dispatch_errors(ast.parse(leak), "fourier.py")
    assert len(errors) == 1 and "obs.span" in errors[0]
    plain = four.replace(
        '"local_fft": _run_rfft_local,',
        '"local_fft": _plain_rfft,').replace(
        "def _run_rfft_local(", "def _plain_rfft(x, *_a, **_k):\n"
        "    return x\n\n\ndef _run_rfft_local(")
    assert plain != four
    errors = lint.spectral_dispatch_errors(ast.parse(plain), "fourier.py")
    assert any("_plain_rfft" in e for e in errors)
