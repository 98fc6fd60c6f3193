"""The port's sharded Fourier against the JAX package's, on 8 shards.

The twin of ``tests/test_parallel_fourier.py``: ``sharded_rfft`` /
``sharded_dft`` / ``sharded_irfft`` on an 8-shard ``cpu`` mesh of the
port against the NumPy float64 oracles (<= 1e-4 rel err, the JAX
test's budget) and against the JAX package's same route on the
conftest's 8-device mesh; both route families (``parallel.fourier``,
``parallel.frame_dft``), forced and selected.

The static prior of ``parallel.fourier`` differs by design: the port's
cost model carries the H100's rates (``utils.benchmark``), under which
one ``torch.fft`` call on one card beats the factorized matmul route at
every geometry (``TestStaticPicks`` pins both packages' picks at the JAX
tests' geometries).  The parity tests hold whichever route runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from veles.simd_tpu import parallel as jpar
from veles.simd_tpu.ops import spectral as jsp
from veles.simd_tpu.parallel import fourier as jfr
from veles.simd_tpu_torch import obs as tobs
from veles.simd_tpu_torch import parallel as tpar
from veles.simd_tpu_torch.ops import spectral as tsp
from veles.simd_tpu_torch.parallel import fourier as tfr
from veles.simd_tpu_torch.runtime import routing as trouting
from veles.simd_tpu_torch.utils import benchmark as tbm
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

RNG = np.random.RandomState(83)


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


@pytest.fixture(scope="module")
def mesh8():
    return tpar.make_mesh({"sp": 8}, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh8():
    return jpar.make_mesh({"sp": 8})


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv(trouting.AUTOTUNE_CACHE_ENV, path)
    trouting.set_cache_path(None)
    yield path
    trouting.set_cache_path(None)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / max(1e-30, np.max(np.abs(want)))


@pytest.fixture
def events():
    tobs.enable()
    tobs.reset()
    yield lambda op: [e for e in tobs.events() if e["op"] == op]
    tobs.disable()
    tobs.reset()


# ---------------------------------------------------------------------------
# factorization helper (the port's copy of ops/spectral.ct_factor)
# ---------------------------------------------------------------------------

class TestCtFactor:
    @pytest.mark.parametrize("n,multiple", [
        (4096, 1), (12288, 1), (13, 1), (4099, 1), (960, 8), (24, 8),
        (1 << 26, 1)])
    def test_matches_the_jax_split(self, n, multiple):
        assert tsp.ct_factor(n, multiple=multiple) == jsp.ct_factor(
            n, multiple=multiple)

    def test_balanced_split(self):
        assert tsp.ct_factor(4096) == (64, 64)
        n1, n2 = tsp.ct_factor(12288)
        assert n1 * n2 == 12288 and n1 >= n2


# ---------------------------------------------------------------------------
# parity: forced factorized route vs the NumPy oracle and the JAX route
# ---------------------------------------------------------------------------

class TestFactorizedParity:
    @pytest.mark.parametrize("n", [512, 1024, 960, 1536, 4096])
    def test_sharded_rfft_matches_numpy(self, mesh8, jmesh8, n):
        x = RNG.randn(n).astype(np.float32)
        got = tfr.sharded_rfft(x, mesh8, route="sharded_matmul_dft")
        assert tuple(got.shape) == (n // 2 + 1,)
        assert _rel(got, np.fft.rfft(x.astype(np.float64))) <= 1e-4
        if n in (960, 4096):    # an odd-factor and a square split
            assert _rel(got, jfr.sharded_rfft(
                x, jmesh8, route="sharded_matmul_dft")) <= 1e-4

    def test_sharded_rfft_batched(self, mesh8, jmesh8):
        x = RNG.randn(3, 1024).astype(np.float32)
        got = tfr.sharded_rfft(x, mesh8, route="sharded_matmul_dft")
        assert _rel(got, np.fft.rfft(x.astype(np.float64))) <= 1e-4
        assert _rel(got, jfr.sharded_rfft(
            x, jmesh8, route="sharded_matmul_dft")) <= 1e-4

    def test_sharded_dft_complex64(self, mesh8, jmesh8):
        x = (RNG.randn(512) + 1j * RNG.randn(512)).astype(np.complex64)
        got = tfr.sharded_dft(x, mesh8, route="sharded_matmul_dft")
        assert _rel(got, np.fft.fft(x.astype(np.complex128))) <= 1e-4
        assert _rel(got, jfr.sharded_dft(
            x, jmesh8, route="sharded_matmul_dft")) <= 1e-4

    def test_sharded_dft_real_input(self, mesh8):
        x = RNG.randn(960).astype(np.float32)
        got = tfr.sharded_dft(x, mesh8, route="sharded_matmul_dft")
        assert _rel(got, np.fft.fft(x.astype(np.float64))) <= 1e-4

    @pytest.mark.parametrize("n", [512, 960])
    def test_roundtrip_irfft_rfft_is_identity(self, mesh8, jmesh8, n):
        x = RNG.randn(n).astype(np.float32)
        spec = _np(tfr.sharded_rfft(x, mesh8, route="sharded_matmul_dft"))
        rec = _np(tfr.sharded_irfft(spec.astype(np.complex64), n, mesh8,
                                    route="sharded_matmul_dft"))
        jrec = np.asarray(jfr.sharded_irfft(
            spec.astype(np.complex64), n, jmesh8,
            route="sharded_matmul_dft"))
        assert rec.shape == (n,)
        assert np.max(np.abs(rec - x)) <= 1e-4 * max(1.0,
                                                    np.max(np.abs(x)))
        assert np.max(np.abs(rec - jrec)) <= 1e-4 * max(
            1.0, np.max(np.abs(x)))

    def test_local_fft_route_parity(self, mesh8, jmesh8):
        x = RNG.randn(1000).astype(np.float32)   # no mesh-div split
        got = tfr.sharded_rfft(x, mesh8, route="local_fft")
        assert _rel(got, np.fft.rfft(x.astype(np.float64))) <= 1e-4
        assert _rel(got, jfr.sharded_rfft(x, jmesh8,
                                          route="local_fft")) <= 1e-4

    def test_bf16_comp_route_parity(self, mesh8):
        x = RNG.randn(4096).astype(np.float32)
        got = tfr.sharded_rfft(x, mesh8,
                               route="sharded_matmul_dft_bf16_comp")
        assert _rel(got, np.fft.rfft(x.astype(np.float64))) <= 1e-4

    def test_forced_matmul_without_split_raises(self, mesh8):
        with pytest.raises(ValueError, match="Cooley-Tukey"):
            tfr.sharded_rfft(RNG.randn(1000).astype(np.float32),
                             mesh8, route="sharded_matmul_dft")

    def test_irfft_bin_count_checked(self, mesh8):
        with pytest.raises(ValueError, match="bins"):
            tfr.sharded_irfft(np.zeros(10, np.complex64), 512, mesh8)

    def test_unknown_route_raises(self, mesh8):
        with pytest.raises(ValueError, match="route"):
            tfr.sharded_rfft(RNG.randn(512).astype(np.float32),
                             mesh8, route="bogus")


class TestFactorizedParityLarge:
    @pytest.mark.parametrize("n", [12288, 1 << 17])
    def test_large_n_parity(self, mesh8, n):
        x = RNG.randn(n).astype(np.float32)
        got = tfr.sharded_rfft(x, mesh8, route="sharded_matmul_dft")
        assert _rel(got, np.fft.rfft(x.astype(np.float64))) <= 1e-4

    def test_large_n_auto_selects_the_local_fft(self, mesh8, events):
        """At 2^17 samples the H100 model's static predicate picks one
        local FFT (the JAX package's TPU model picks the matmul
        route): no forcing, no tuner."""
        n = 1 << 17
        x = RNG.randn(n).astype(np.float32)
        got = tfr.sharded_rfft(x, mesh8)
        ev = events("sharded_rfft")[-1]
        assert ev["decision"] == "local_fft"
        assert ev["a2a"] == 0 and ev["roofline"] == "fft"
        assert not ev["forced"]
        assert _rel(got, np.fft.rfft(x.astype(np.float64))) <= 1e-4


# ---------------------------------------------------------------------------
# routing: static prior, opt-out, the cost model, the autotuner
# ---------------------------------------------------------------------------

# the JAX tests' geometries (n, shards, rows); the second column is the
# JAX package's static pick on its TPU model, the third the port's on
# the H100's
_PICKS = [
    (512, 8, 1, "local_fft", "local_fft"),
    (960, 8, 1, "local_fft", "local_fft"),
    (1024, 8, 1, "local_fft", "local_fft"),
    (1024, 8, 3, "local_fft", "local_fft"),
    (1536, 8, 1, "local_fft", "local_fft"),
    (4096, 8, 1, "sharded_matmul_dft", "local_fft"),
    (4096, 4, 1, "sharded_matmul_dft", "local_fft"),
    (12288, 8, 1, "sharded_matmul_dft", "local_fft"),
    (1 << 17, 8, 1, "sharded_matmul_dft", "local_fft"),
    (1 << 18, 8, 1, "sharded_matmul_dft", "local_fft"),
    (1 << 18, 1, 1, "local_fft", "local_fft"),
]


class TestStaticPicks:
    @pytest.mark.parametrize("n,s,rows,jax_pick,port_pick", _PICKS)
    def test_both_models_at_the_jax_geometries(self, n, s, rows,
                                               jax_pick, port_pick):
        n1, n2 = tsp.ct_factor(n, multiple=s) or (0, 0)
        assert jfr._select_fourier_route(
            "rfft", n, s, rows, n1, n2) == jax_pick
        assert tfr._select_fourier_route(
            "rfft", n, s, rows, n1, n2) == port_pick

    def test_the_model_carries_h100_rates(self):
        """The FFT side is HBM-bound at 2^18: its bytes over 3.35 TB/s;
        the matmul side's copy term runs at half of HBM on one card."""
        t_mm, t_fft, a2a = tfr._modeled_costs(1 << 18, 512, 512, 1, 8)
        assert t_fft == pytest.approx(
            (4.0 * (1 << 18) + 8.0 * ((1 << 17) + 1)) / 3.35e12)
        assert a2a == tbm.a2a_bytes(1 << 18, 8, 8)
        flops = tbm.ct_dft_flops(1 << 18, 512, 512) / 8 / 67e12
        copy = 2.0 * a2a / 8 / (3.35e12 / 2.0)
        assert t_mm == pytest.approx(flops + copy)


class TestFourierRouting:
    def test_static_prior_is_mesh_and_size_aware(self):
        assert tfr._select_fourier_route(
            "rfft", 1024, 8, 1, 32, 32) == "local_fft"
        assert tfr._select_fourier_route(
            "rfft", 1 << 18, 8, 1, 0, 0) == "local_fft"
        assert tfr._select_fourier_route(
            "rfft", 1 << 18, 1, 1, 512, 512) == "local_fft"

    def test_env_opt_out(self, monkeypatch):
        monkeypatch.setenv(tbm.MESH_BW_ENV, "1e9")
        assert tfr._select_fourier_route(
            "rfft", 4096, 8, 1, 64, 64) == "sharded_matmul_dft"
        monkeypatch.setenv(tfr.SHARDED_DFT_ENV, "1")
        assert tfr._select_fourier_route(
            "rfft", 4096, 8, 1, 64, 64) == "local_fft"

    def test_predicate_respects_the_copy_bandwidth(self, monkeypatch):
        """The selector really consults the copy term: at 4096 samples
        the stages alone beat the FFT's bytes, so a free copy flips the
        pick to the matmul route and the modeled one-card copy rate
        flips it back; two cards copy over NVLink, slower still."""
        geom = dict(n=4096, n_shards=8, rows=1, n1=64, n2=64)
        assert not tfr._matmul_dft_viable(**geom)
        assert not tfr._matmul_dft_viable(**geom, cards=2)
        monkeypatch.setenv(tbm.MESH_BW_ENV, "1e9")
        assert tfr._matmul_dft_viable(**geom)

    def test_engine_driven_selection_persisted_mesh_keyed(
            self, mesh8, fresh_cache, monkeypatch, events):
        """With VELES_SIMD_AUTOTUNE=on the measured winner is
        selected, recorded, persisted under a MESH-KEYED tune class with
        the topology stamp, and served without re-probing; another mesh
        shape does NOT consult that winner."""
        monkeypatch.setenv(trouting.AUTOTUNE_ENV, "on")
        # a free copy makes the matmul route the static prior here, so
        # the measured pick below is provably not the table order
        monkeypatch.setenv(tbm.MESH_BW_ENV, "1e9")
        n = 4096
        x = RNG.randn(n).astype(np.float32)
        probes = []

        def timer(thunk, name):
            probes.append(name)
            thunk()
            return {"sharded_matmul_dft": 9.0, "local_fft": 1.0,
                    "sharded_matmul_dft_bf16_comp": 12.0}[name]

        with trouting.probe_timer(timer):
            tfr.sharded_rfft(x, mesh8)
        assert {"sharded_matmul_dft", "local_fft"} <= set(probes)
        assert events("sharded_rfft")[-1]["decision"] == "local_fft"
        tune_ev = events("autotune")[-1]
        assert tune_ev["family"] == "parallel.fourier"
        assert tune_ev["static"] == "sharded_matmul_dft"
        token = trouting.mesh_class(mesh8, "sp")
        entries = trouting.tune_cache().entries()
        keys = [k for k in entries if k.startswith("parallel.fourier|")]
        assert len(keys) == 1
        assert f"mesh={token}" in keys[0]
        assert entries[keys[0]]["mesh"] == token
        before = len(probes)
        with trouting.probe_timer(timer):
            tfr.sharded_rfft(x, mesh8)
        assert len(probes) == before
        assert tobs.counter_value("autotune_cache_hit",
                                  family="parallel.fourier") >= 1
        mesh4 = tpar.make_mesh({"sp": 4}, devices=["cpu"] * 4)
        with trouting.probe_timer(timer):
            tfr.sharded_rfft(x, mesh4)
        assert len(probes) > before
        keys4 = [k for k in trouting.tune_cache().entries()
                 if k.startswith("parallel.fourier|")]
        assert len(keys4) == 2


# ---------------------------------------------------------------------------
# the local frame-transform family (sharded stft/istft/welch bodies)
# ---------------------------------------------------------------------------

class TestFrameRoutes:
    def test_frame_route_ladder(self, monkeypatch):
        for fl in (512, 6144, 4099):
            assert tfr.select_frame_route(fl) == jfr.select_frame_route(fl)
        assert tfr.select_frame_route(512) == "rdft_matmul"
        assert tfr.select_frame_route(6144) == "ct_matmul"
        assert tfr.select_frame_route(4099) == "xla_fft"  # prime
        monkeypatch.setenv(tsp._DFT_MATMUL_ENV, "1")
        assert tfr.select_frame_route(512) == "xla_fft"

    @pytest.mark.parametrize("route", ["rdft_matmul", "ct_matmul",
                                       "xla_fft", "rdft_matmul_bf16_comp"])
    def test_every_frame_route_forced(self, route):
        """Each route's analysis and synthesis bodies on 64-sample
        frames: the one-sided spectrum within 1e-4 of NumPy's, and
        synthesis the window times the inverse."""
        fl = 64
        window = tsp._resolve_window(None, fl)
        frames = torch.as_tensor(RNG.randn(5, fl).astype(np.float32))
        spec = tfr.frame_rfft_fn(route, fl, window)(frames)
        want = np.fft.rfft(frames.numpy().astype(np.float64) * window)
        assert _rel(spec, want) <= 1e-4
        back = tfr.frame_irfft_fn(route, fl, window)(
            torch.as_tensor(want.astype(np.complex64)))
        assert _rel(back, np.fft.irfft(want, fl) * window) <= 1e-4

    def test_sharded_stft_records_local_route(self, mesh8, jmesh8,
                                              events):
        x = RNG.randn(8 * 256).astype(np.float32)
        got = tpar.sharded_stft(x, 64, 16, mesh8)
        assert events("sharded_stft_local")[-1]["decision"] == \
            "rdft_matmul"
        assert _rel(got, tsp.stft_na(x, 64, 16)) <= 1e-4
        assert _rel(got, jpar.sharded_stft(x, 64, 16, jmesh8)) <= 1e-4

    def test_sharded_stft_above_cutoff_rides_ct(self, mesh8, events):
        """frame > AUTO_DFT_MATMUL_MAX_FRAME: the local transform is
        the Cooley-Tukey matmul, and parity holds both ways."""
        fl, hop = 6144, 1536
        n = 8 * fl
        assert tfr.select_frame_route(fl) == "ct_matmul"
        x = RNG.randn(n).astype(np.float32)
        got = tpar.sharded_stft(x, fl, hop, mesh8)
        assert events("sharded_stft_local")[-1]["decision"] == "ct_matmul"
        want = tsp.stft_na(x, fl, hop)
        assert _rel(got, want) <= 1e-4
        rec = tpar.sharded_istft(want.astype(np.complex64), n, fl, hop,
                                 mesh8)
        assert events("sharded_istft_local")[-1]["decision"] == \
            "ct_matmul"
        assert _rel(rec, tsp.istft_na(want, n, fl, hop)) <= 1e-3

    def test_sharded_welch_records_local_route(self, mesh8, jmesh8,
                                               events):
        x = RNG.randn(8 * 256).astype(np.float32)
        _, p = tpar.sharded_welch(x, mesh8, nperseg=64, noverlap=48)
        assert events("sharded_welch_local")[-1]["decision"] == \
            "rdft_matmul"
        _, pw = tsp.welch_na(x, nperseg=64, noverlap=48)
        assert _rel(p, pw) <= 1e-4
        _, jp = jpar.sharded_welch(x, jmesh8, nperseg=64, noverlap=48)
        assert _rel(p, jp) <= 1e-4

    def test_sharded_istft_rdft_roundtrip(self, mesh8):
        x = RNG.randn(8 * 256).astype(np.float32)
        fl, hop = 64, 16
        spec = tsp.stft_na(x, fl, hop).astype(np.complex64)
        rec = tpar.sharded_istft(spec, len(x), fl, hop, mesh8)
        assert _rel(rec, tsp.istft_na(spec, len(x), fl, hop)) <= 1e-4


class TestProgramCache:
    def test_ct_program_reused_across_dispatches(self, mesh8):
        """Repeat dispatches of one CT class reuse ONE built program."""
        x = RNG.randn(1024).astype(np.float32)
        tfr.sharded_rfft(x, mesh8, route="sharded_matmul_dft")
        before = dict(tfr._program_stats)
        tfr.sharded_rfft(x, mesh8, route="sharded_matmul_dft")
        tfr.sharded_rfft(x, mesh8, route="sharded_matmul_dft")
        after = dict(tfr._program_stats)
        assert after["misses"] == before["misses"]
        assert after["hits"] >= before["hits"] + 2
        assert "fourier_program_lru" in tobs.caches()
