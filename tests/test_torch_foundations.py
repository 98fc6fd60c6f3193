"""The port's foundations behave like the JAX package's on the same calls.

Covers the copied telemetry storage (registry, event log, spans,
LRUSet), the slim obs facade, the static routing engine, the config
layer (its fields too), the memory helpers (all the JAX package's
names), the fp32 precision layer and the roofline
helper.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from veles.simd_tpu import obs as jobs
from veles.simd_tpu.obs import lru as jlru
from veles.simd_tpu.obs import registry as jregistry
from veles.simd_tpu.obs import spans as jspans
from veles.simd_tpu.runtime import precision as jprx
from veles.simd_tpu.runtime import routing as jrouting
from veles.simd_tpu.utils import config as jconfig
from veles.simd_tpu.utils import memory as jmemory
from veles.simd_tpu_torch import obs as tobs
from veles.simd_tpu_torch.obs import lru as tlru
from veles.simd_tpu_torch.obs import registry as tregistry
from veles.simd_tpu_torch.obs import spans as tspans
from veles.simd_tpu_torch.runtime import precision as tprx
from veles.simd_tpu_torch.runtime import routing as trouting
from veles.simd_tpu_torch.utils import benchmark as tbench
from veles.simd_tpu_torch.utils import cache as tcache
from veles.simd_tpu_torch.utils import config as tconfig
from veles.simd_tpu_torch.utils import memory as tmemory

# the facades' events() functions shadow the submodules' names
jevents = importlib.import_module("veles.simd_tpu.obs.events")
tevents = importlib.import_module("veles.simd_tpu_torch.obs.events")

torch.set_num_threads(1)


def _lru_trace(mod):
    s = mod.LRUSet(3)
    seen = []
    for key in ("a", "b", "c", "a", "d", "b", "e"):
        seen.append(key in s)
        s.add(key)
    seen.append(s.check_and_add("f"))
    seen.append(s.check_and_add("e"))
    s.discard("e")
    seen.append("e" in s)
    return seen, len(s), s.info()


def test_lru_set_matches():
    assert _lru_trace(tlru) == _lru_trace(jlru)


def _registry_trace(mod):
    r = mod.MetricsRegistry()
    r.count("dispatch", op="convolve", backend="x")
    r.count("dispatch", 2, op="convolve", backend="x")
    r.count("decisions", op="convolve", decision="fft")
    r.gauge("depth", 3.5, queue="a")
    for v in (2e-6, 5e-4, 0.2, 50.0):
        r.observe("span.convolve.dispatch", v, phase="steady")
    return r.snapshot(), r.counter_value("dispatch", op="convolve",
                                         backend="x")


def test_registry_matches():
    assert _registry_trace(tregistry) == _registry_trace(jregistry)


def _events_trace(mod):
    log = mod.EventLog(max_events=3)
    for i in range(5):
        log.record("convolve", "fft", x_length=i, forced=False)
    return log.events(), log.dropped


def test_event_log_matches():
    assert _events_trace(tevents) == _events_trace(jevents)
    with pytest.raises(ValueError):
        tevents.EventLog(0)


def _span_trace(mod):
    seen = []
    tracer = mod.SpanTracer(lambda name, v, **lab: seen.append(
        (name, lab["phase"])))
    for _ in range(2):
        with tracer.span("convolve.dispatch", algo="fft"):
            with tracer.span("convolve.os_route", route="xla_matmul"):
                pass
    events = tracer.to_chrome_trace()["traceEvents"][1:]
    shape = [(e["name"], e["ph"], e["args"]) for e in events]
    return seen, sorted(shape, key=repr), tracer.dropped


def test_spans_match():
    assert _span_trace(tspans) == _span_trace(jspans)
    assert repr(tspans.NULL_SPAN) == repr(jspans.NULL_SPAN)


@pytest.fixture
def both_obs():
    states = (jobs.enabled(), tobs.enabled())
    jobs.enable(compile_listeners=False)
    tobs.enable()
    jobs.reset()
    tobs.reset()
    yield
    for mod, was in zip((jobs, tobs), states):
        mod.reset()
        if not was:
            mod.disable()


def test_obs_facade_matches(both_obs):
    for mod, cfg in ((jobs, jconfig), (tobs, tconfig)):
        mod.count("dispatch", op="convolve", backend="b")
        mod.record_decision("convolve", "overlap_save", x_length=8,
                            h_length=2, forced=False)
        with mod.span("convolve.dispatch", algo="fft"):
            pass
        cfg.resolve_simd(None, op="convolve")
        cfg.resolve_simd(False, op="convolve")
    for name, labels in [
            ("dispatch", {"op": "convolve", "backend": "b"}),
            ("decisions", {"op": "convolve",
                           "decision": "overlap_save"})]:
        assert tobs.counter_value(name, **labels) == \
            jobs.counter_value(name, **labels) == 1
    # the port names its device backend "torch", the JAX one "xla"
    assert tobs.counter_value("dispatch", op="convolve",
                              backend="torch") == \
        jobs.counter_value("dispatch", op="convolve", backend="xla") == 1
    assert tobs.counter_value("dispatch", op="convolve",
                              backend="oracle") == 1
    assert tobs.events() == jobs.events()
    snap = tobs.snapshot()
    assert [h["name"] for h in snap["histograms"]] == \
        ["span.convolve.dispatch"]
    text = tobs.report()
    assert "dispatch" in text and "overlap_save" in text


def test_obs_disabled_is_a_no_op(both_obs):
    tobs.disable()
    tobs.count("dispatch", op="x")
    tobs.record_decision("convolve", "fft")
    assert tobs.span("x") is tspans.NULL_SPAN
    assert tobs.counter_value("dispatch", op="x") == 0
    assert tobs.events() == []
    assert "no telemetry" in tobs.report()


def _family(mod, env):
    return mod.family("test.port_parity", (
        mod.Route("fast", predicate=lambda n, **_: n >= 8,
                  disable_env=env),
        mod.Route("mid", predicate=lambda n, **_: n >= 2),
        mod.Route("slow"),
    ))


@pytest.mark.parametrize("opt_out", [False, True])
def test_routing_matches(monkeypatch, opt_out):
    env = "VELES_SIMD_TEST_PORT_PARITY_OFF"
    if opt_out:
        monkeypatch.setenv(env, "yes")
    fams = [_family(jrouting, env), _family(trouting, env)]
    for n in (0, 1, 2, 7, 8, 100):
        got = [(f.eligible(n=n), f.static_select(n=n),
                f.route("fast").gate({"n": n}),
                f.select(n=n), f.select(eligible=["mid", "slow"], n=n),
                f.select(eligible=[], n=n)) for f in fams]
        assert got[0] == got[1], n
    assert fams[1].names() == ("fast", "mid", "slow")
    assert trouting.get_family("test.port_parity") is fams[1]
    for f, mod in zip(fams, (jrouting, trouting)):
        with pytest.raises(ValueError, match="route must be one of"):
            f.route("nope")
        with pytest.raises(ValueError, match="duplicate"):
            mod.family("dup", (mod.Route("a"), mod.Route("a")))
        with pytest.raises(ValueError, match="no routes"):
            mod.family("empty", ())
    with pytest.raises(ValueError, match="unknown route family"):
        trouting.get_family("no.such.family")


def test_routing_helpers_match(monkeypatch):
    for v in (0, 1, 2, 3, 1000, 1 << 20, (1 << 20) + 1):
        assert trouting.pow2_bucket(v) == jrouting.pow2_bucket(v)
    for raw in ("1", "true", "YES", " on ", "0", "no", ""):
        monkeypatch.setenv("VELES_SIMD_TEST_TRUTHY", raw)
        assert trouting.env_truthy("VELES_SIMD_TEST_TRUTHY") == \
            jrouting.env_truthy("VELES_SIMD_TEST_TRUTHY")


def test_config_matches():
    prev = tconfig.get_config()
    try:
        cfg = tconfig.set_config(conv_precision="high", device="cpu")
        assert cfg.conv_precision == "high" and cfg.device == "cpu"
        assert tconfig.get_config() is cfg
        for mod in (jconfig, tconfig):
            with pytest.raises(ValueError, match="conv_precision"):
                mod.Config(conv_precision="default")
        with pytest.raises(ValueError, match="device"):
            tconfig.Config(device="tpu")
    finally:
        tconfig.set_config(**dataclasses.asdict(prev))
    assert tconfig.Config().device == "cuda"
    prev_b = tconfig.set_backend(tconfig.Backend.ORACLE)
    try:
        assert tconfig.resolve_simd(None) is False
        assert tconfig.resolve_simd(1) is True
    finally:
        tconfig.set_backend(prev_b)


def test_memory_helpers_match():
    for v in (0, 1, 2, 3, 100, 128, 1000):
        assert tmemory.next_highest_power_of_2(v) == \
            jmemory.next_highest_power_of_2(v)
        assert tmemory.zeropadding_length(v) == \
            jmemory.zeropadding_length(v)
    x = np.arange(12, dtype=np.float32).reshape(2, 6)
    (a, na), (b, nb) = tmemory.zeropadding(x), jmemory.zeropadding(x)
    np.testing.assert_array_equal(a, b)
    assert na == nb
    t, nt = tmemory.zeropadding(torch.from_numpy(x))
    np.testing.assert_array_equal(t.numpy(), b)
    assert nt == nb
    (a, na), (b, nb) = tmemory.zeropadding_ex(x, 3), \
        jmemory.zeropadding_ex(x, 3)
    np.testing.assert_array_equal(a, b)
    assert na == nb


@pytest.mark.parametrize("name", ["rmemcpyf", "crmemcpyf"])
@pytest.mark.parametrize("shape", [(8,), (3, 10)])
def test_reversed_copies_match(name, shape):
    x = np.random.RandomState(61).randn(*shape).astype(np.float32)
    want = getattr(jmemory, name)(x)
    got = getattr(tmemory, name)(x)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    t = getattr(tmemory, name)(torch.from_numpy(x))
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), want)


def test_crmemcpyf_odd_length_raises():
    x = np.arange(7, dtype=np.float32)
    for mod, arg in ((jmemory, x), (tmemory, x),
                     (tmemory, torch.from_numpy(x))):
        with pytest.raises(ValueError, match="even length"):
            mod.crmemcpyf(arg)


def test_memory_stubs_match():
    for a, b in ((tmemory.memsetf((2, 3), 1.5), jmemory.memsetf((2, 3), 1.5)),
                 (tmemory.memsetf(4, 2, np.float64),
                  jmemory.memsetf(4, 2, np.float64)),
                 (tmemory.malloc_aligned(10), jmemory.malloc_aligned(10)),
                 (tmemory.malloc_aligned_offset(10, 3),
                  jmemory.malloc_aligned_offset(10, 3)),
                 (tmemory.mallocf(5), jmemory.mallocf(5))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    x = np.zeros(4, np.float32)
    for arg in (x, torch.from_numpy(x), 12345):
        assert tmemory.align_complement(arg) == \
            jmemory.align_complement(arg) == 0


def test_memory_exports_the_jax_names():
    public = {name for name, obj in vars(jmemory).items()
              if callable(obj) and not name.startswith("_")
              and getattr(obj, "__module__", None) == jmemory.__name__}
    assert public <= set(tmemory.__all__)
    for name in tmemory.__all__:
        assert callable(getattr(tmemory, name))


def test_config_dtype_and_complex_layout_round_trip():
    prev = tconfig.get_config()
    try:
        cfg = tconfig.set_config(dtype="float32",
                                 interleaved_complex=False)
        assert cfg.dtype == "float32" and cfg.interleaved_complex is False
        assert tconfig.get_config() is cfg
        assert cfg.device == prev.device
    finally:
        tconfig.set_config(**dataclasses.asdict(prev))
    assert tconfig.get_config() == prev
    fields = {f.name: f.default for f in dataclasses.fields(tconfig.Config)}
    jfields = {f.name: f.default for f in dataclasses.fields(jconfig.Config)}
    for name in ("dtype", "interleaved_complex"):
        assert fields[name] == jfields[name]


def test_precision_matches():
    r = np.random.RandomState(59)
    a = r.randn(5, 64, 48).astype(np.float32)
    b = r.randn(32, 48).astype(np.float32)
    prev = torch.get_float32_matmul_precision()
    for p in ("highest", "high"):
        got = tprx.p_einsum("...ba,ta->...bt", torch.from_numpy(a),
                            torch.from_numpy(b), precision=p)
        want = np.asarray(jprx.p_einsum("...ba,ta->...bt", a, b,
                                        precision=p))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    got = tprx.p_matmul(torch.from_numpy(a), torch.from_numpy(b.T))
    np.testing.assert_allclose(got.numpy(), a @ b.T, rtol=1e-5, atol=1e-5)
    assert torch.get_float32_matmul_precision() == prev
    with pytest.raises(ValueError, match="precision"):
        tprx.p_einsum("ab,bc->ac", torch.ones(2, 2), torch.ones(2, 2),
                      precision="fp64")


def test_fp32_bound():
    # the headline convolution's least work is an FFT overlap-save (N =
    # 16384: 74 segments), under its 8.4 MB of signal in and out
    flops, nbytes = tbench.conv_work(1, 1 << 20, 2047)
    direct = 2.0 * (1 << 20) * 2047
    assert flops < direct / 40
    assert nbytes == 4.0 * ((1 << 20) + 2047 + (1 << 20) + 2046)
    ms, by = tbench.fp32_bound(flops, nbytes)
    assert by == "bytes" and abs(ms - 0.0025) < 1e-4
    # the direct form's 4.29 GFLOP stays the ceiling of a direct kernel
    ms, by = tbench.fp32_bound(direct, nbytes)
    assert by == "operations" and abs(ms - 0.0641) < 1e-3
    # a 2-tap filter: the direct form is the least
    assert tbench.conv_work(3, 1000, 2)[0] == 2.0 * 3 * 1000 * 2
    # the batched direct shape: bound by its bytes too
    ms, by = tbench.fp32_bound(*tbench.conv_work(512, 16384, 129))
    assert by == "bytes" and abs(ms - 0.0201) < 1e-4
    ms, by = tbench.fp32_bound(1e6, 3.35e9)
    assert by == "bytes" and abs(ms - 1.0) < 1e-9


def test_stft_bound_is_the_bytes():
    # 2^20 samples at 512/128: 8189 frames of an FFT-form STFT are
    # ~0.1 GFLOP, far under the 21.0 MB of signal, window and spectrum
    flops, nbytes = tbench.stft_work(1, 1 << 20, 512, 128)
    assert flops == 8189 * (512 + 2.5 * 512 * 9)
    assert nbytes == 4.0 * ((1 << 20) + 512 + 8189 * 514)
    ms, by = tbench.fp32_bound(flops, nbytes)
    assert by == "bytes" and abs(ms - 0.0063) < 1e-4


@pytest.mark.parametrize("imgs,n0,n1,k0,k1", [
    (16, 512, 512, 7, 7), (4, 100, 77, 16, 16), (3, 64, 300, 1, 256),
    (1, 1, 1, 1, 1)])
def test_conv2d_bound_reads_the_unpadded_input(imgs, n0, n1, k0, k1):
    # bytes: the unpadded images and the kernel in, the full output out
    flops, nbytes = tbench.conv2d_work(imgs, n0, n1, k0, k1)
    m0, m1 = n0 + k0 - 1, n1 + k1 - 1
    assert nbytes == 4.0 * (imgs * n0 * n1 + k0 * k1 + imgs * m0 * m1)
    assert 0 < flops <= 2.0 * imgs * n0 * n1 * k0 * k1
    if (imgs, n0, k0) == (16, 512, 7):
        # the main 2D shape: the direct form's 0.41 GFLOP is the least,
        # and its 34.0 MB set the bound
        assert flops == 2.0 * 16 * 512 * 512 * 49
        ms, by = tbench.fp32_bound(flops, nbytes)
        assert by == "bytes" and abs(ms - 0.010134) < 1e-5


def test_constant_cache_bounds_entries_and_bytes():
    cache = tcache.ConstantCache(3, max_bytes=1000)
    builds = []

    def build(n):
        def make():
            builds.append(n)
            return np.zeros(n, np.float32)
        return make

    a = cache.get(("a", 1), build(100))
    assert cache.get(("a", 1), build(100)) is a and builds == [100]
    # a value above the byte bound is returned but never kept
    big = cache.get(("big",), build(300))
    assert big.nbytes == 1200 and cache.get(("big",), build(300)) \
        is not big
    cache.get(("b",), build(100))
    # 400 + 400 + 200 bytes fit; another 200 evicts the oldest entry
    cache.get(("c",), build(50))
    cache.get(("d",), build(50))
    info = cache.info()
    assert info["keys"] == ["b", "c", "d"] and info["bytes"] == 800
    assert (info["hits"], info["misses"], info["evictions"],
            info["uncached"]) == (1, 6, 1, 2)
    # an entry bound too: a fourth small value evicts the oldest
    cache.get(("e",), lambda: (torch.zeros(2), np.zeros(2)))
    assert cache.info()["keys"] == ["c", "d", "e"]
    assert tcache.nbytes((torch.zeros(2), np.zeros(2))) == 8 + 16
    # the port's constant caches all report through obs.caches()
    importlib.import_module("veles.simd_tpu_torch.ops.spectral")
    assert {"spectral_host_lru", "spectral_device_lru",
            "cuda_kernels_device_lru"} <= set(tobs.caches())


def test_device_rows_retries_empty_profiler_windows(monkeypatch):
    # a window can come back without device events: the helper takes
    # another window, up to twelve, then raises
    got = iter([([], 1.0)] * 3 + [([(5.0, "k", 1.0)], 1.0)] * 3)
    monkeypatch.setattr(tbench, "_profile", lambda fn, calls: next(got))
    assert tbench._device_rows(lambda: None, 3) == [(5.0, "k", 1.0)]
    got = iter([([], 1.0)] * 11 + [([(4.0, "k", 1.0)], 1.0)])
    monkeypatch.setattr(tbench, "_profile", lambda fn, calls: next(got))
    assert tbench._device_rows(lambda: None, 3) == [(4.0, "k", 1.0)]
    seen = []
    monkeypatch.setattr(tbench, "_profile",
                        lambda fn, calls: seen.append(1) or ([], 1.0))
    with pytest.raises(RuntimeError, match="no device time"):
        tbench._device_rows(lambda: None, 3)
    assert len(seen) == 12


@pytest.mark.parametrize("calls", [1, 4])
def test_profile_sums_trace_records_by_name(monkeypatch, calls):
    # a traced warm-up, then one traced window of ``calls`` calls whose
    # records are summed by name, per call, largest first
    from veles.simd_tpu_torch.utils import devtrace

    seen = []

    def fake_trace(fn):
        seen.append(fn)
        records = [devtrace.Record("k", 2000), devtrace.Record("k", 4000),
                   devtrace.Record("Memset", 500)] * calls
        return records, fn()

    monkeypatch.setattr(devtrace, "trace", fake_trace)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    ran = []
    rows, wall_us = tbench._profile(lambda: ran.append(1), calls)
    assert len(seen) == 2 and wall_us > 0
    assert rows == [(6.0, "k", 2.0), (0.5, "Memset", 1.0)]
    assert len(ran) == 1 + calls


def test_device_rows_keeps_the_longest_window(monkeypatch):
    # a window can lose device time, never gain it: of three windows
    # that saw device time the longest stands, and no fourth is taken
    got = iter([([(2.0, "k", 1.0)], 1.0), ([], 1.0),
                ([(5.0, "k", 1.0)], 1.0), ([(1.0, "k", 1.0)], 1.0)])
    monkeypatch.setattr(tbench, "_profile", lambda fn, calls: next(got))
    assert tbench._device_rows(lambda: None, 3) == [(5.0, "k", 1.0)]
    got = iter([([(2.0, "a", 1.0), (1.0, "b", 1.0)], 1.0),
                ([(2.5, "a", 1.0)], 1.0), ([(2.0, "a", 1.0)], 1.0),
                ([(9.0, "a", 1.0)], 1.0)])
    monkeypatch.setattr(tbench, "_profile", lambda fn, calls: next(got))
    assert tbench._device_rows(lambda: None, 3) == [(2.0, "a", 1.0),
                                                   (1.0, "b", 1.0)]


def test_device_busy_with_one_window_takes_the_first_that_saw_time(
        monkeypatch):
    # keep=1: past the empty windows, the first window with device
    # time is the answer, and no later window is taken
    got = iter([([], 1.0), ([(2000.0, "k", 1.0)], 1.0),
                ([(9000.0, "k", 1.0)], 1.0)])
    monkeypatch.setattr(tbench, "_profile", lambda fn, calls: next(got))
    assert tbench.device_busy_ms(lambda: None, calls=3, keep=1) == 2.0
    assert next(got) == ([(9000.0, "k", 1.0)], 1.0)


def test_utils_package_all_equals_jax():
    # F2: the package re-exports the JAX package's eleven names
    import veles.simd_tpu.utils as jutils
    import veles.simd_tpu_torch.utils as tutils

    assert tutils.__all__ == jutils.__all__
    from veles.simd_tpu_torch.utils import (align_complement,  # noqa: F401
                                            crmemcpyf, malloc_aligned,
                                            mallocf, rmemcpyf)

    x = np.arange(6, dtype=np.float32)
    np.testing.assert_array_equal(tutils.rmemcpyf(x), jutils.rmemcpyf(x))
    np.testing.assert_array_equal(tutils.crmemcpyf(x),
                                  jutils.crmemcpyf(x))
    assert tutils.align_complement(x) == jutils.align_complement(x)
    for name in jutils.__all__:
        assert callable(getattr(tutils, name))
