"""The span store's capture mode (``obs.start_capture``): the record a
captured span leaves and the counts folded into it, what stays off, the
drop count, that
``obs.enable()`` keeps its behaviour over the shared store, and the
spans the dispatch layer places in a handle ``convolve`` call, a
guarded retry and a 3-level ``wavelet_transform``."""

import gc
import json
import time

import numpy as np
import pytest
import torch

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.obs import flightrec
from veles.simd_tpu_torch.obs import spans as tspans
from veles.simd_tpu_torch.ops import convolve as cv
from veles.simd_tpu_torch.ops import wavelet as wv
from veles.simd_tpu_torch.runtime import faults
from veles.simd_tpu_torch.utils.config import get_config, set_config


@pytest.fixture
def clean():
    """Telemetry and capture off before and after, the store emptied
    and left at its default size."""
    was = obs.enabled()
    obs.stop_capture()
    obs.disable()
    obs.reset()
    yield
    obs.stop_capture()
    obs.disable()
    obs.configure(max_spans=tspans.DEFAULT_MAX_SPANS)
    obs.reset()
    if was:
        obs.enable()


def _capture(slots, counts=None):
    """Arm the capture over an emptied store of ``slots`` records."""
    obs.configure(max_spans=slots)
    obs.start_capture(counts=counts)


@pytest.fixture
def on_cpu(clean):
    old = get_config().device
    set_config(device="cpu")
    yield
    set_config(device=old)


def test_a_captured_span_carries_name_stamps_parent_and_call(clean):
    _capture(64)
    t0 = time.perf_counter_ns()
    with obs.span("outer", route="a"):
        with obs.span("inner", site="s"):
            pass
    with obs.span("next"):
        pass
    t1 = time.perf_counter_ns()
    obs.stop_capture()
    cap = obs.captured()
    assert cap.dropped == 0
    inner, outer, nxt = cap.records
    assert (inner.name, inner.parent, inner.attrs, inner.phase) == (
        "inner", "outer", {"site": "s"}, None)
    assert (outer.name, outer.parent, outer.attrs) == (
        "outer", None, {"route": "a"})
    # raw perf_counter_ns stamps, nested in order
    assert t0 <= outer.start_ns <= inner.start_ns <= inner.end_ns \
        <= outer.end_ns <= nxt.start_ns <= nxt.end_ns <= t1
    # one call id for a call's spans, a new one for the next call
    assert inner.call == outer.call != nxt.call
    assert [r.seq for r in cap.records] == [0, 1, 2]
    # capture alone runs nothing else of telemetry
    assert obs.snapshot()["histograms"] == []
    assert obs.events() == []


def test_a_count_is_a_stamped_sample_with_its_call(clean):
    """A count taken inside a span is folded into that span's record,
    which gives it stamps and a call id; one outside every span belongs
    to no call and is dropped."""
    _capture(64)
    obs.count("outside", 3)
    t0 = time.perf_counter_ns()
    with obs.span("call", route="r"):
        with obs.span("runner"):
            obs.count("wavelet_extend_bytes", 4096, level=1)
            obs.count("wavelet_extend_bytes", 1024, level=2)
    t1 = time.perf_counter_ns()
    obs.stop_capture()
    runner, top = obs.captured().records
    assert runner.attrs == {"wavelet_extend_bytes": 5120}
    assert top.attrs == {"route": "r"}
    assert t0 <= runner.start_ns <= runner.end_ns <= t1
    assert runner.call == top.call is not None
    # the registry counts nothing while telemetry is off
    assert obs.counter_value("wavelet_extend_bytes", level=1) == 0


def test_capture_and_telemetry_off_record_nothing(clean):
    assert obs.span("x", a=1) is tspans.NULL_SPAN
    with obs.span("x") as sp:
        assert sp is tspans.NULL_SPAN
        obs.count("y", 2)
    _capture(8)
    obs.stop_capture()
    assert obs.span("x") is tspans.NULL_SPAN
    with obs.span("x"):
        obs.count("y")
    assert obs.captured() == (([], 0))


def test_the_ring_counts_what_it_overwrites(clean):
    _capture(4)
    for i in range(6):
        with obs.span(f"s{i}"):
            pass
    with obs.span("s6"):
        obs.count("c")
    obs.stop_capture()
    cap = obs.captured()
    assert cap.dropped == 3
    assert [r.name for r in cap.records] == ["s3", "s4", "s5", "s6"]
    assert cap.records[-1].attrs == {"c": 1}
    # configure(max_spans=) alone sizes and empties the store
    obs.configure(max_spans=4)
    assert obs.captured() == ([], 0)
    with pytest.raises(ValueError):
        obs.configure(max_spans=0)


def test_start_and_stop_keep_the_store_and_counts_can_be_chosen(clean):
    _capture(64, counts=("wavelet_extend_bytes",))
    with obs.span("a"):
        obs.count("wavelet_extend_bytes", 8)
        obs.count("dispatch", op="convolve")
    obs.stop_capture()
    with obs.span("skipped"):
        pass
    # arming again records on after what the store holds
    obs.start_capture()
    with obs.span("b"):
        obs.count("dispatch", op="convolve")
    obs.stop_capture()
    recs = obs.captured().records
    assert [(r.name, r.attrs) for r in recs] == [
        ("a", {"wavelet_extend_bytes": 8}), ("b", {"dispatch": 1})]
    assert [r.seq for r in recs] == [0, 1]
    assert obs.snapshot()["spans_dropped"] == 0


def test_captured_records_leave_nothing_for_the_collector(clean):
    """A record's tuple holds atomic fields alone, its attributes beside
    it: a full store holds no more objects that the cyclic collector
    walks than an empty one."""
    _capture(1 << 14)
    gc.collect()
    before = len(gc.get_objects())
    for _ in range(1 << 13):
        with obs.span("outer", route="r"):
            with obs.span("inner"):
                pass
    obs.stop_capture()
    gc.collect()
    assert obs.captured().dropped == 0
    assert len(gc.get_objects()) - before < 256


def test_enable_keeps_its_behaviour_over_the_shared_store(clean, tmp_path):
    obs.enable()
    with obs.span("convolve.dispatch", algo="fft") as sp:
        assert isinstance(sp, tspans.Span)
        with obs.span("convolve.os_route", route="xla_matmul"):
            pass
    with obs.span("convolve.dispatch", algo="fft"):
        pass
    snap = obs.snapshot()
    hists = {(h["name"], h["labels"]["phase"]): h["count"]
             for h in snap["histograms"]}
    assert hists == {("span.convolve.dispatch", "warmup"): 1,
                     ("span.convolve.dispatch", "steady"): 1,
                     ("span.convolve.os_route", "warmup"): 1}
    events = [e for e in obs.trace_events() if e["ph"] == "X"]
    assert [(e["name"], e["args"]) for e in events] == [
        ("convolve.dispatch", {"algo": "fft", "phase": "warmup"}),
        ("convolve.os_route", {"route": "xla_matmul", "phase": "warmup",
                               "parent": "convolve.dispatch"}),
        ("convolve.dispatch", {"algo": "fft", "phase": "steady"})]
    trace = json.loads(open(obs.save_trace(str(tmp_path / "t.json"))).read())
    assert trace["otherData"]["spans_dropped"] == 0
    # the same store: captured() reads the enabled spans, with call ids
    recs = obs.captured().records
    assert [r.name for r in recs] == ["convolve.os_route",
                                      "convolve.dispatch",
                                      "convolve.dispatch"]
    assert recs[0].call == recs[1].call != recs[2].call
    # counts go to the registry alone unless a capture is armed
    obs.count("c", 2)
    assert obs.counter_value("c") == 2
    assert len(obs.captured().records) == 3
    _capture(16)
    with obs.span("s"):
        obs.count("c", 1)
    assert obs.counter_value("c") == 3
    assert [(r.name, r.attrs) for r in obs.captured().records] == [
        ("s", {"c": 1})]


def test_enabled_crash_hook_still_fires_on_a_top_span(clean, tmp_path):
    obs.enable()
    obs.start_capture()
    flightrec._reset_auto_count()
    flightrec.configure_flight_dir(str(tmp_path))
    try:
        with pytest.raises(KeyError):
            with obs.span("outer"):
                raise KeyError("x")
        assert len(list(tmp_path.glob("flight-*.json"))) == 1
    finally:
        flightrec.configure_flight_dir(None)
        flightrec._reset_auto_count()


def test_a_handle_convolve_call_spans_its_layers(on_cpu):
    x = torch.randn(2, 4096)
    h = torch.randn(300)
    handle = cv.convolve_initialize(4096, 300)
    assert handle.os_matmul
    _capture(64)
    cv.convolve(handle, x, h)
    obs.stop_capture()
    spans = obs.captured().records
    assert [(r.name, r.parent) for r in spans] == [
        ("routing.select", "fault.attempt"),
        ("convolve.os_route", "fault.attempt"),
        ("fault.attempt", "convolve.dispatch"),
        ("convolve.dispatch", None)]
    assert spans[0].attrs == {"family": "convolve.os"}
    assert spans[1].attrs == {"route": "xla_matmul"}
    assert spans[2].attrs == {"site": "convolve.dispatch"}
    assert len({r.call for r in spans}) == 1
    select, runner, attempt, top = spans
    assert top.start_ns <= attempt.start_ns <= select.start_ns \
        <= select.end_ns <= runner.start_ns <= runner.end_ns \
        <= attempt.end_ns <= top.end_ns


def test_a_retry_is_a_second_attempt_and_trips_no_crash_hook(clean,
                                                             tmp_path,
                                                             monkeypatch):
    monkeypatch.setenv("VELES_SIMD_FAULT_BACKOFF", "0")
    seen = []

    def thunk():
        seen.append(1)
        if len(seen) == 1:
            raise faults.make_fault("device_lost")
        return "ok"

    obs.enable()
    _capture(64)
    flightrec._reset_auto_count()
    flightrec.configure_flight_dir(str(tmp_path))
    try:
        assert faults.guarded("demo.dispatch", thunk, retries=1) == "ok"
        assert list(tmp_path.glob("flight-*.json")) == []
    finally:
        flightrec.configure_flight_dir(None)
        flightrec._reset_auto_count()
    attempts = [r for r in obs.captured().records
                if r.name == "fault.attempt"]
    assert [r.attrs for r in attempts] == [{"site": "demo.dispatch"}] * 2
    assert attempts[0].end_ns <= attempts[1].start_ns
    assert obs.counter_value("fault_retry", site="demo.dispatch") == 1


def test_a_three_level_transform_spans_each_level(on_cpu):
    rows, n, order = 4, 512, 8
    x = torch.randn(rows, n)
    _capture(256)
    bands = wv.wavelet_transform("daub", order, "periodic", x, 3)
    obs.stop_capture()
    assert len(bands) == 4
    recs = obs.captured().records
    tops = [r for r in recs if r.parent is None]
    # every count is folded in: the levels' dispatch counts, taken
    # before their runners open, ride on the top span
    assert [(t.name, t.attrs) for t in tops] == [
        ("wavelet_transform.dispatch", {"route": "level_loop",
                                        "levels": 3, "dispatch": 3})]
    assert {r.call for r in recs} == {tops[0].call}
    spans = [(r.name, r.attrs.get("family") or r.attrs.get("route"))
             for r in recs if r.parent is not None]
    assert spans == [("routing.select", "wavelet"),
                     ("wavelet_apply.dispatch", "xla_conv")] * 3
    # each level's extension count rides on its runner span: rows x
    # (n / 2^(l - 1) + order) float32 samples a level
    ext = [r.attrs["wavelet_extend_bytes"] for r in recs
           if "wavelet_extend_bytes" in r.attrs]
    assert [r.name for r in recs if "wavelet_extend_bytes" in r.attrs] \
        == ["wavelet_apply.dispatch"] * 3
    assert ext == [rows * (n // 2 ** lvl + order) * 4 for lvl in range(3)]
    assert sum(ext) == 4 * (520 + 264 + 136) * 4
    # the result is the level loop's, unchanged by the spans
    ref = wv.wavelet_transform("daub", order, "periodic", x.numpy(), 3,
                               simd=False)
    for got, want in zip(bands, ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5)
