"""The port's obs standalone half against the JAX package's.

``obs/resources.py`` (``instrumented_jit``'s record schema, its
first-call-per-geometry rule, nested suppression, the cache registry),
the five kernel wrappers' resource rows on the CPU (their work is
``utils.benchmark``'s at the call's shape), ``obs/compile.py``'s
counter and histogram names, ``obs/spans.py``'s profiler bridge and
crash hook, ``utils/profiler.py``, the facade's new names and the
flight recorder's filled axes.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from veles.simd_tpu import obs as jobs
from veles.simd_tpu.obs import compile as jcompile
from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.obs import compile as tcompile
from veles.simd_tpu_torch.obs import flightrec
from veles.simd_tpu_torch.obs import spans as tspans
from veles.simd_tpu_torch.ops import cuda_kernels as ck
from veles.simd_tpu_torch.ops import wavelet as wv
from veles.simd_tpu_torch.utils import benchmark as bm
from veles.simd_tpu_torch.utils import platform as plat
from veles.simd_tpu_torch.utils import profiler

tres = sys.modules["veles.simd_tpu_torch.obs.resources"]
jres = sys.modules["veles.simd_tpu.obs.resources"]


@pytest.fixture
def telemetry():
    obs.enable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _x(seed, *shape):
    return torch.as_tensor(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


# ---------------------------------------------------------------------------
# the record schema
# ---------------------------------------------------------------------------

def test_record_keys_equal_the_jax_entries():
    jres.RESOURCES.reset()
    tres.RESOURCES.reset()
    jres.record_resources("op", "r", "f32[4]", None, None)
    tres.record_resources("op", "r", "float32[4]", None, None)
    want = jres.resources_snapshot()[0]
    got = tres.resources_snapshot()[0]
    assert set(got) == set(want)
    assert {k for k, v in got.items() if v is None} == {
        k for k, v in want.items() if v is None}
    jres.RESOURCES.reset()
    tres.RESOURCES.reset()


def test_record_derives_intensity_and_roofline():
    tres.RESOURCES.reset()
    tres.record_resources("op", "r", "s", {"flops": 670.0,
                                           "bytes accessed": 1000.0}, {})
    e = tres.resources_snapshot()[0]
    assert e["arith_intensity"] == pytest.approx(0.67)
    # 0.67 flop/byte x 3.35 TB/s = 2.2 TFLOP/s of the 67 TFLOP/s peak
    want = 100.0 * bm.fp32_bound(670.0, 0.0)[0] / bm.fp32_bound(
        670.0, 1000.0)[0]
    assert e["attainable_pct_of_roofline"] == pytest.approx(want)
    assert e["attainable_pct_of_roofline"] == pytest.approx(
        100.0 * 0.67 * 3.35 / 67.0)
    tres.record_resources("op", "r", "s", {"flops": 1e9,
                                           "bytes accessed": 1.0}, {})
    assert tres.resources_snapshot()[0]["attainable_pct_of_roofline"] \
        == pytest.approx(100.0)
    assert tres.resources_snapshot()[0]["analyses"] == 2
    tres.RESOURCES.reset()


def test_module_all_equals_jax():
    assert tres.__all__ == jres.__all__
    assert tcompile.__all__ == jcompile.__all__
    assert tspans.__all__ == sys.modules[
        "veles.simd_tpu.obs.spans"].__all__
    from veles.simd_tpu.utils import profiler as jprofiler

    assert profiler.__all__ == jprofiler.__all__


# ---------------------------------------------------------------------------
# instrumented_jit
# ---------------------------------------------------------------------------

def test_first_call_per_geometry_records(telemetry):
    calls = []

    @obs.instrumented_jit(op="demo", route="r",
                          work=lambda x, k: (2.0 * x.numel() * k,
                                             4.0 * x.numel()))
    def f(x, k):
        calls.append(k)
        return x * k

    f(torch.ones(8), 3)
    f(torch.zeros(8), 3)
    rows = obs.resources()
    assert len(rows) == 1 and rows[0]["analyses"] == 1
    e = rows[0]
    assert (e["op"], e["route"], e["shapes"]) == ("demo", "r",
                                                  "float32[8] 3")
    assert (e["flops"], e["bytes_accessed"]) == (48.0, 32.0)
    assert (e["argument_bytes"], e["output_bytes"]) == (32, 32)
    assert e["peak_bytes"] is None
    f(torch.ones(16), 3)
    assert obs.resources()[0]["analyses"] == 2
    assert calls == [3, 3, 3]
    assert f.__name__ == "f" and isinstance(f, obs.InstrumentedJit)


class _CardLeaf:
    """A stand-in for a float32[4] tensor on the card."""
    shape, dtype, nbytes = (4,), torch.float32, 16
    device = torch.device("cuda", 0)


@pytest.mark.parametrize("raised", [True, False])
def test_card_peak_leaves_the_process_peak_alone(telemetry, monkeypatch,
                                                 raised):
    mem = {"alloc": 10, "high": 100}
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda dev=None: mem["alloc"])
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda dev=None: mem["high"])

    def no_reset(*a, **k):
        raise AssertionError("the process's peak counter was reset")

    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", no_reset)

    def run(x):
        if raised:
            mem["high"] = 150
        return x

    obs.instrumented_jit(run, op="cardpeak", route="r")(_CardLeaf())
    e = obs.resources()[0]
    # known only where the call raised the process's peak
    assert e["peak_bytes"] == (140 if raised else None)
    assert mem["high"] == (150 if raised else 100)


def test_nested_calls_record_nothing(telemetry):
    inner = obs.instrumented_jit(lambda x: x + 1, op="inner", route="i")

    @obs.instrumented_jit(op="outer", route="o")
    def outer(x):
        return inner(x) * 2

    assert float(outer(torch.ones(2))[0]) == 4.0
    assert {(r["op"], r["route"]) for r in obs.resources()} == {
        ("outer", "o")}
    inner(torch.ones(2))            # on its own it records
    assert ("inner", "i") in {(r["op"], r["route"])
                              for r in obs.resources()}


def test_disabled_records_nothing_and_exceptions_pass():
    obs.disable()
    obs.reset()
    f = obs.instrumented_jit(lambda x: x, op="off")
    f(torch.ones(2))
    assert obs.resources() == []
    obs.enable()
    try:
        boom = obs.instrumented_jit(lambda x: 1 / 0, op="boom")
        with pytest.raises(ZeroDivisionError):
            boom(torch.ones(2))
        # the depth unwinds: a later call records again
        f(torch.ones(3))
        assert [r["op"] for r in obs.resources()] == ["off"]
    finally:
        obs.disable()
        obs.reset()


def test_jax_keywords_accepted():
    f = obs.instrumented_jit(lambda x: x, op="k", artifact_key="a",
                             static_argnames=("x",))
    assert float(f(torch.ones(1))[0]) == 1.0
    assert repr(f).startswith("InstrumentedJit('k'")


def test_failing_work_records_none(telemetry):
    def bad_work(x):
        raise RuntimeError("no")

    f = obs.instrumented_jit(lambda x: x, op="w", work=bad_work)
    f(torch.ones(2))
    e = obs.resources()[0]
    assert e["flops"] is None and e["bytes_accessed"] is None


# ---------------------------------------------------------------------------
# the five kernel wrappers' rows on the CPU
# ---------------------------------------------------------------------------

def _dwt_case():
    x = _x(3, 6, 64)
    taps = wv._filter_tensor(wv.WaveletType("daub"), 8, x.device)
    x_ext = wv._extend(x, wv.ExtensionType.PERIODIC, 8).contiguous()
    return (lambda: ck.filter_bank_cuda(x_ext, taps, 2, 1, 32),
            bm.filter_bank_work(6, 72, 2, 8, 32))


def _cascade_cases():
    plans, taps, _ = wv._cascade_plan_for(wv.WaveletType("daub"), 8, 3)
    slots = sum(len(p) for p in plans)
    x = _x(4, 5, 256)
    periodic = (lambda: ck.cascade_bank_periodic_cuda(x, taps, plans, 3),
                bm.cascade_bank_work(5, 256, slots, 8, 32))
    x_ext = torch.cat([x, x[..., :64]], -1)
    contract = (lambda: ck.cascade_bank_cuda(x_ext, taps, plans, 8, 32),
                bm.cascade_bank_work(5, 320, slots, len(plans), 32))
    return periodic, contract


KERNEL_CASES = {
    "overlap_save": lambda: (
        lambda: ck.overlap_save_cuda(_x(1, 3, 500), _x(2, 31)),
        bm.conv_work(3, 500, 31)),
    "filter_bank": lambda: (
        lambda: ck.filter_bank_cuda(_x(1, 4, 300), _x(2, 1, 17), 1, 1,
                                    316, pad_left=16, reverse_taps=True),
        bm.conv_work(4, 300, 17)),
    "filter_bank_dwt": _dwt_case,
    "cascade_bank": lambda: _cascade_cases()[0],
    "cascade_bank_contract": lambda: _cascade_cases()[1],
    "filter_2d": lambda: (
        lambda: ck.filter_2d_cuda(_x(5, 2, 20, 24), _x(6, 3, 5), 22, 28,
                                  pad=(2, 4), reverse_taps=True),
        bm.conv2d_work(2, 20, 24, 3, 5)),
    "filter_2d_valid": lambda: (
        lambda: ck.filter_2d_cuda(_x(5, 2, 20, 24), _x(6, 3, 5), 18, 20),
        bm.filter_2d_work(2, 20, 24, 3, 5, 18, 20)),
    "stft": lambda: (
        lambda: ck.stft_cuda(_x(7, 2, 1024), torch.hann_window(128), 128,
                             32),
        bm.stft_work(2, 1024, 128, 32)),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_wrapper_rows_carry_benchmark_work(case, telemetry):
    call, (flops, nbytes) = KERNEL_CASES[case]()
    ck.reset_launches()
    call()
    assert not any(ck.LAUNCHES.values())        # the plain versions ran
    route = case.replace("_dwt", "").replace("_contract", "").replace(
        "_valid", "")
    rows = [r for r in obs.resources() if r["op"] == "cuda"]
    assert [r["route"] for r in rows] == [route]
    assert (rows[0]["flops"], rows[0]["bytes_accessed"]) == (flops,
                                                             nbytes)
    assert 0.0 < rows[0]["attainable_pct_of_roofline"] <= 100.0


def test_kernel_wrapper_calls_inside_an_instrumented_step_are_silent(
        telemetry):
    step = obs.instrumented_jit(
        lambda x: ck.overlap_save_cuda(x, _x(2, 31)), op="pipeline",
        route="p")
    step(_x(1, 2, 100))
    assert [(r["op"], r["route"]) for r in obs.resources()] == [
        ("pipeline", "p")]


# ---------------------------------------------------------------------------
# the cache registry moved to resources; the facade re-exports it
# ---------------------------------------------------------------------------

def test_cache_registry_lives_in_resources():
    assert obs.register_cache is tres.register_cache
    obs.register_cache("demo_cache", lambda: {"size": 1, "maxsize": 4})
    got = obs.caches()["demo_cache"]
    assert got == {"size": 1, "maxsize": 4, "capacity": 4}
    assert obs.caches() == tres.caches_snapshot()
    obs.register_cache("broken", lambda: 1 / 0)
    assert "error" in obs.caches()["broken"]
    for name in ("obs_analysis_memo", "pipeline_graphs"):
        import veles.simd_tpu_torch.pipeline  # noqa: F401

        assert name in obs.caches()


# ---------------------------------------------------------------------------
# obs.compile: the JAX counter and histogram names
# ---------------------------------------------------------------------------

def test_compile_names_are_the_jax_names():
    assert set(tcompile.EVENT_COUNTERS.values()) <= set(
        jcompile.EVENT_COUNTERS.values())
    j_names = {v for pair in jcompile.DURATION_METRICS.values()
               for v in pair if v}
    assert {v for pair in tcompile.DURATION_METRICS.values()
            for v in pair if v} <= j_names


def test_compile_events_count_while_enabled(telemetry):
    obs.install_compile_listeners()
    assert tcompile.installed()
    tcompile.record_event("/veles/cuda/library_cache_hits")
    tcompile.record_duration("/veles/cuda/nvcc_build_duration", 2.5)
    tcompile.record_duration("/veles/pipeline/graph_capture_duration",
                             0.5)
    tcompile.record_event("/unknown")
    assert obs.counter_value("compile.cache_hits") == 1
    assert obs.counter_value("compile.backend_compile") == 2
    hist = [h for h in obs.snapshot()["histograms"]
            if h["name"] == "compile.backend_compile_secs"]
    assert hist and hist[0]["count"] == 2 and hist[0]["sum"] == 3.0
    obs.disable()
    tcompile.record_event("/veles/cuda/library_cache_hits")
    assert obs.counter_value("compile.cache_hits") == 1


def test_library_load_counts_cache_hit(monkeypatch, tmp_path, telemetry):
    # a library found built counts as a cache hit (the load itself is
    # faked: the CPU has no CUDA library to open)
    obs.install_compile_listeners()
    monkeypatch.setattr(ck, "_lib", None)
    monkeypatch.setattr(ck, "_build_dir", lambda: tmp_path)
    (tmp_path / ck._LIB_NAME).write_bytes(b"")

    def no_cdll(path):
        raise OSError("not a library")

    monkeypatch.setattr(ck.ctypes, "CDLL", no_cdll)
    with pytest.raises(OSError):
        ck.load_library()
    assert obs.counter_value("compile.cache_hits") == 1


# ---------------------------------------------------------------------------
# spans, the profiler and the facade
# ---------------------------------------------------------------------------

def test_trace_writes_a_chrome_trace_with_span_names(tmp_path, telemetry):
    assert not tspans.xla_trace_active()
    with profiler.trace(str(tmp_path)) as d:
        assert tspans.xla_trace_active()
        with obs.span("demo.dispatch"):
            torch.ones(4).sum()
        with profiler.annotate("demo.region"):
            torch.ones(4).sum()
    assert d == str(tmp_path) and not tspans.xla_trace_active()
    files = list(tmp_path.glob("trace-*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(
        files[0].read_text())["traceEvents"]}
    assert {"demo.dispatch", "demo.region"} <= names


def test_enable_compilation_cache_moves_the_build_root(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(ck, "_lib", None)
    monkeypatch.setattr(ck, "_BUILD_ROOT", ck._BUILD_ROOT)
    default = profiler.enable_compilation_cache()
    assert default.endswith(os.path.join("build", "simd_tpu_torch"))
    monkeypatch.setenv("VELES_SIMD_CACHE_DIR", str(tmp_path / "env"))
    assert profiler.enable_compilation_cache() == str(tmp_path / "env")
    assert str(ck._build_dir()).startswith(str(tmp_path / "env"))
    assert profiler.enable_compilation_cache(str(tmp_path / "arg")) == \
        str(tmp_path / "arg")
    monkeypatch.setattr(ck, "_lib", object())       # loaded
    assert profiler.enable_compilation_cache(str(tmp_path / "arg")) == \
        str(tmp_path / "arg")
    with pytest.raises(RuntimeError, match="already loaded"):
        profiler.enable_compilation_cache(str(tmp_path / "other"))


def test_facade_names_and_configure(tmp_path, telemetry):
    for name in ("instrumented_jit", "InstrumentedJit", "resources",
                 "install_compile_listeners", "journal_stats",
                 "journal_cursor", "journal_tail", "trace_events",
                 "save_trace", "to_json", "save", "load",
                 "dump_debug_bundle", "configure", "observe"):
        assert name in obs.__all__ and name in jobs.__all__
        assert callable(getattr(obs, name))
    # the request axis is live: its bounds and switch configure
    obs.configure(max_traces=3, max_exemplars=2, request_axis=False)
    assert obs.request_trace("op").rid == -1
    obs.configure(max_traces=256, max_exemplars=64, request_axis=True)
    assert obs.request_trace("op").rid >= 0
    # a stitched fleet trace (a dict) is written as it is, as the JAX
    # facade writes it
    fleet = {"traceEvents": [], "otherData": {"fleet": True}}
    mine = obs.save_trace(str(tmp_path / "t.json"), fleet=fleet)
    theirs = jobs.save_trace(str(tmp_path / "j.json"), fleet=fleet)
    with open(mine) as a, open(theirs) as b:
        text = a.read()
        assert text == b.read()
    assert json.loads(text) == fleet
    obs.configure(max_events=3, max_spans=2)
    for i in range(5):
        obs.record_decision("demo", str(i))
        with obs.span("s"):
            pass
    assert [e["decision"] for e in obs.events()] == ["2", "3", "4"]
    assert len([e for e in obs.trace_events() if e["ph"] == "X"]) == 2
    path = obs.save(str(tmp_path / "snap.json"))
    snap = obs.load(path)
    assert snap["events"][-1]["decision"] == "4"
    assert "resources" in snap and "journal" in snap
    tr = json.loads(open(obs.save_trace(str(tmp_path / "t.json"))).read())
    assert tr["otherData"]["spans_dropped"] == 3
    json.loads(obs.to_json())
    obs.configure(max_events=1000, max_spans=32768)


def test_flight_bundle_fills_the_ported_axes(tmp_path, telemetry):
    plat.reset_probe_history()
    plat._note_probe(1, 0, "no card", 0.0)
    with obs.span("flight.demo"):
        pass
    path = obs.dump_debug_bundle(str(tmp_path / "b.json"))
    bundle = json.loads(open(path).read())
    assert bundle["schema"] == flightrec.SCHEMA
    assert [e["name"] for e in bundle["trace_events"]
            if e["ph"] == "X"] == ["flight.demo"]
    assert bundle["device_probes"][-1]["detail"] == "no card"
    assert set(bundle["journal"]) == {"cursor", "stats", "tail"}
    assert set(bundle["request_traces"]) == {
        "summary", "recent", "slowest_by_op", "degraded", "slo"}
    plat.reset_probe_history()


def test_exception_escaping_a_top_level_span_writes_a_bundle(tmp_path,
                                                             telemetry):
    flightrec._reset_auto_count()
    flightrec.configure_flight_dir(str(tmp_path))
    try:
        with pytest.raises(KeyError):
            with obs.span("outer"):
                with obs.span("inner"):
                    raise KeyError("x")
        bundles = list(tmp_path.glob("flight-*.json"))
        assert len(bundles) == 1
        assert json.loads(bundles[0].read_text())["reason"] == \
            "span_crash"
    finally:
        flightrec.configure_flight_dir(None)
        flightrec._reset_auto_count()
