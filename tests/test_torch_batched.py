"""The port's batched layer against the JAX package.

``batched_stft`` on the same seeded NumPy batches through
``veles.simd_tpu.ops.batched`` (CPU platform) and
``veles.simd_tpu_torch.ops.batched`` with ``device="cpu"``: float32 on
both sides with different summation orders, so 1e-5 of max|X|
(``tests/test_spectral.py``).  The handle LRU is held to the JAX
package's contract (``tests/test_batched.py``): hits, misses and
evictions, one build per key under concurrent callers, a failed build
that releases its key, and the empty-batch and 1D errors.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import batched as jb
from veles.simd_tpu.ops import spectral as js
from veles.simd_tpu_torch import obs as tobs
from veles.simd_tpu_torch.ops import batched as tb
from veles.simd_tpu_torch.ops import cuda_kernels as tck
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

REL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    tb.clear_handle_cache()
    yield
    tb.clear_handle_cache()
    tconfig.set_config(**dataclasses.asdict(prev))


def _rel(got, want):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor)
                     else got, np.complex128)
    want = np.asarray(want, np.complex128)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape,frame,hop", [
    ((4, 1000), 256, 128), ((2, 3, 800), 128, 64), ((3, 1500), 384, 96),
    ((2, 5000), 8192 // 2, 1024), ((5, 9000), 512, 128),
])
def test_batched_stft_agrees(shape, frame, hop):
    x = _x(frame + hop, shape)
    want = jb.batched_stft(x, frame, hop, simd=True)
    got = tb.batched_stft(x, frame, hop)
    assert got.dtype == torch.complex64
    assert _rel(got, want) < REL_TOL
    assert _rel(got, js.stft_na(x, frame, hop)) < REL_TOL
    got_w = tb.batched_stft(x, frame, hop, window="hamming")
    assert _rel(got_w, jb.batched_stft(x, frame, hop, window="hamming",
                                       simd=True)) < REL_TOL
    np.testing.assert_array_equal(
        tb.batched_stft(x, frame, hop, simd=False),
        jb.batched_stft(x, frame, hop, simd=False))


def test_batched_stft_routes(monkeypatch):
    x = _x(1, (5, 9000))
    # the fused route delegates to spectral.stft (the kernel's plain
    # version on a CPU tensor); the JAX side's forced pallas_fused runs
    # stft_pallas in interpret mode
    monkeypatch.setattr(tck, "on_card", lambda cuda: True)
    want = js.stft(x, 512, 128, simd=True, route="pallas_fused")
    got = tb.batched_stft(x, 512, 128)
    assert _rel(got, want) < REL_TOL
    assert tb.handle_cache_info()["size"] == 0     # no handle built
    monkeypatch.setenv("VELES_SIMD_DISABLE_DFT_MATMUL", "1")
    monkeypatch.setenv("VELES_SIMD_DISABLE_STFT_CUDA", "1")
    got = tb.batched_stft(x, 512, 128)
    assert tb.handle_cache_info()["keys"] == [
        ("stft", 5, 9000, 512, 128, "xla_fft")]
    assert _rel(got, want) < REL_TOL


def test_same_geometry_hits_new_geometry_misses():
    x = _x(2, (4, 1000))
    tobs.enable()
    tobs.reset()
    try:
        tb.batched_stft(x, 256, 128)
        tb.batched_stft(x * 2, 256, 128, window="hamming")
        tb.batched_stft(x[:3], 256, 128)
        info = tb.handle_cache_info()
        assert (info["hits"], info["misses"], info["size"]) == (1, 2, 2)
        assert tobs.counter_value("batched_handle_cache", op="stft",
                                  event="miss") == 2
        assert tobs.counter_value("batched_handle_cache", op="stft",
                                  event="hit") == 1
        assert [e["decision"] for e in tobs.events()
                if e["op"] == "batched"] == ["stft", "stft"]
    finally:
        tobs.reset()
        tobs.disable()
    assert tobs.caches()["batched_handle_lru"]["capacity"] == \
        tb.BATCHED_CACHE_MAXSIZE == jb.BATCHED_CACHE_MAXSIZE


def test_lru_bound_evicts_oldest(monkeypatch):
    monkeypatch.setattr(tb, "BATCHED_CACHE_MAXSIZE", 2)
    for n in (600, 700, 800):
        tb.batched_stft(_x(n, (2, n)), 256, 128)
    info = tb.handle_cache_info()
    assert info["evictions"] == 1 and info["size"] == 2
    assert [k[2] for k in info["keys"]] == [700, 800]


@pytest.mark.parametrize("call,match", [
    (lambda m: m.batched_stft(np.zeros(256, np.float32), 128, 64),
     "batched ops take"),
    (lambda m: m.batched_stft(np.empty((0, 256), np.float32), 128, 64),
     "empty batch"),
    (lambda m: m.batched_stft(np.empty((3, 0, 256), np.float32), 128,
                              64), "empty batch"),
    (lambda m: m.batched_stft(np.empty((3, 0), np.float32), 128, 64),
     "empty signal"),
    (lambda m: m.batched_stft(np.zeros((2, 100), np.float32), 128, 64),
     "signal length"),
])
@pytest.mark.parametrize("simd", [True, False])
@pytest.mark.parametrize("side", ["jax", "torch"])
def test_contract_errors_match(call, match, side, simd):
    mod = jb if side == "jax" else tb

    class Bound:
        @staticmethod
        def batched_stft(*a):
            return mod.batched_stft(*a, simd=simd)

    with pytest.raises(ValueError, match=match):
        call(Bound)


def test_concurrent_same_key_builds_once():
    builds, results = [], []
    start = threading.Barrier(6)

    def builder():
        builds.append(threading.get_ident())
        time.sleep(0.05)          # hold the build window open
        return lambda *a: "built"

    def worker():
        start.wait()
        results.append(tb._get_handle(("race", "same-key"), builder))

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1
    assert len({id(h) for h in results}) == 1
    info = tb.handle_cache_info()
    assert info["misses"] == 1 and info["hits"] == 5
    assert not tb._build_locks


def test_distinct_keys_build_concurrently():
    windows = {}

    def make_builder(tag):
        def builder():
            t0 = time.perf_counter()
            time.sleep(0.05)
            windows[tag] = (t0, time.perf_counter())
            return lambda *a: tag
        return builder

    threads = [threading.Thread(
        target=lambda tag=tag: tb._get_handle(("race2", tag),
                                              make_builder(tag)))
        for tag in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    (a0, a1), (b0, b1) = windows["a"], windows["b"]
    assert a0 < b1 and b0 < a1


def test_failed_build_releases_the_key():
    def bad_builder():
        raise RuntimeError("build failed")

    with pytest.raises(RuntimeError, match="build failed"):
        tb._get_handle(("race3", "key"), bad_builder)
    assert not tb._build_locks
    h = tb._get_handle(("race3", "key"), lambda: (lambda *a: "ok"))
    assert h("x") == "ok"


# ---- resample and IIR -------------------------------------------------------

IIR_TOL = 2e-5   # tests/test_iir.py and tests/test_resample.py


def _rel64(got, want):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("shape", [(4, 300), (2, 3, 257)])
@pytest.mark.parametrize("up,down", [(160, 147), (3, 2), (1, 4), (2, 2)])
def test_batched_resample_poly_agrees(shape, up, down):
    from veles.simd_tpu.ops import resample as jrs

    x = _x(up + down + shape[-1], shape)
    jb.clear_handle_cache()
    got = tb.batched_resample_poly(x, up, down)
    want = jb.batched_resample_poly(x, up, down, simd=True)
    assert got.dtype == torch.float32
    assert _rel64(got, want) <= IIR_TOL
    assert _rel64(got, jrs.resample_poly_na(x, up, down)) <= IIR_TOL
    # the same handle key as the JAX package's (the 1/1 rate keys none)
    assert tb.handle_cache_info()["keys"] == jb.handle_cache_info()["keys"]
    np.testing.assert_array_equal(
        tb.batched_resample_poly(x, up, down, simd=False),
        jb.batched_resample_poly(x, up, down, simd=False))


@pytest.mark.parametrize("shape", [(4, 300), (2, 3, 129), (1, 2)])
def test_batched_sosfilt_agrees(shape):
    from veles.simd_tpu.ops import iir as jiir

    x = _x(shape[-1], shape)
    jb.clear_handle_cache()
    for sos in (jiir.butterworth(4, 0.25), jiir.cheby1(8, 0.05, 0.2)):
        got = tb.batched_sosfilt(sos, x)
        assert _rel64(got, jb.batched_sosfilt(sos, x, simd=True)) <= IIR_TOL
        assert _rel64(got, jiir.sosfilt_na(sos, x)) <= IIR_TOL
        np.testing.assert_array_equal(
            tb.batched_sosfilt(sos, x, simd=False),
            jb.batched_sosfilt(sos, x, simd=False))
    assert tb.handle_cache_info()["keys"] == jb.handle_cache_info()["keys"]


@pytest.mark.parametrize("b,a", [
    ([0.2, 0.3, 0.1], [1.0, -0.5, 0.2, -0.05]), ([1.0, 0.5], [2.0])])
@pytest.mark.parametrize("shape", [(4, 300), (2, 3, 65)])
def test_batched_lfilter_agrees(b, a, shape):
    from veles.simd_tpu.ops import iir as jiir

    x = _x(len(a) + shape[-1], shape)
    jb.clear_handle_cache()
    got = tb.batched_lfilter(b, a, x)
    assert _rel64(got, jb.batched_lfilter(b, a, x, simd=True)) <= IIR_TOL
    assert _rel64(got, jiir.lfilter_na(b, a, x)) <= IIR_TOL
    assert tb.handle_cache_info()["keys"] == jb.handle_cache_info()["keys"]
    np.testing.assert_array_equal(tb.batched_lfilter(b, a, x, simd=False),
                                  jb.batched_lfilter(b, a, x, simd=False))


def test_donate_is_accepted_and_keys_carry_no_donation():
    from veles.simd_tpu.ops import iir as jiir

    x = _x(5, (3, 200))
    sos = jiir.butterworth(2, 0.3)
    calls = (
        lambda m, d: m.batched_resample_poly(x, 3, 2, donate=d),
        lambda m, d: m.batched_sosfilt(sos, x, donate=d),
        lambda m, d: m.batched_lfilter([1.0, 0.5], [1.0, -0.3], x,
                                       donate=d),
    )
    jb.clear_handle_cache()
    for call in calls:
        np.testing.assert_array_equal(call(tb, True).numpy(),
                                      call(tb, False).numpy())
        call(jb, True)
    info = tb.handle_cache_info()
    assert (info["misses"], info["hits"]) == (3, 3)
    assert info["keys"] == jb.handle_cache_info()["keys"]
    assert all(k[-1] == () for k in info["keys"])
    # the same signal the JAX package's entries take, donate= included
    import inspect

    for name in ("batched_resample_poly", "batched_sosfilt",
                 "batched_lfilter"):
        assert inspect.signature(getattr(tb, name)) == \
            inspect.signature(getattr(jb, name))


def test_batched_iir_contracts_match():
    from veles.simd_tpu.ops import iir as jiir

    sos = jiir.butterworth(2, 0.3)
    for call in (lambda m: m.batched_sosfilt(sos, np.zeros(8)),
                 lambda m: m.batched_resample_poly(np.zeros((0, 8)), 3, 2),
                 lambda m: m.batched_lfilter([1.0], np.r_[1.0, 0.1 * np.ones(
                     33)], np.zeros((2, 8))),
                 lambda m: m.batched_lfilter([1.0], [0.0, 1.0],
                                             np.zeros((2, 8)))):
        with pytest.raises(ValueError) as want:
            call(jb)
        with pytest.raises(ValueError) as got:
            call(tb)
        assert str(got.value) == str(want.value)


def test_batched_iir_decisions_and_spans():
    from veles.simd_tpu.ops import iir as jiir

    x = _x(6, (2, 100))
    tobs.enable()
    tobs.reset()
    try:
        tb.batched_sosfilt(jiir.butterworth(2, 0.3), x)
        tb.batched_lfilter([1.0], [1.0, -0.5], x)
        tb.batched_resample_poly(x, 3, 2)
        assert [e["decision"] for e in tobs.events()
                if e["op"] == "batched"] == [
            "sosfilt", "lfilter", "resample_poly"]
        names = {h["name"] for h in tobs.snapshot()["histograms"]}
        assert {"span.batched.sosfilt.dispatch",
                "span.batched.lfilter.dispatch",
                "span.batched.resample_poly.dispatch"} <= names
    finally:
        tobs.reset()
        tobs.disable()
