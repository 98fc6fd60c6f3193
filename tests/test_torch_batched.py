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
