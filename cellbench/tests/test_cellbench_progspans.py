"""The program-span readers on made-up capture records: the window's
records grouped by call, what makes them unreadable, the four metrics
that read them, and one CPU window of the real program."""

import types
from typing import NamedTuple

import numpy as np
import pytest

from cellbench import devtrace, harness, progspans

ROOT = harness.ROOT

# importing the helper arms the program's capture over a large store, as
# a traced run wants it; the other tests of this process want it off
if progspans._OBS is not None:
    progspans._OBS.stop_capture()
    progspans._OBS.configure(max_spans=32768)


class Rec(NamedTuple):
    seq: int
    name: str
    start_ns: int
    end_ns: int
    parent: str | None
    call: int
    attrs: dict
    tid: int
    phase: str | None


def _span(name, start, end, parent, call, **attrs):
    return Rec(0, name, start, end, parent, call, attrs, 1, None)


def _metric(name):
    return harness.load_module(ROOT / "cellbench" / "metrics" / f"{name}.py")


# two calls: call [100, 300), sync [300, 1000), loop [1000, 1100),
# call [1100, 1400), sync [1400, 2000)
WINDOW = (np.array([100, 1100]), np.array([300, 1400]),
          np.array([1000, 2000]))


def _conv_call(call, t0, guard_extra=0):
    """A handle convolve call at ``t0``: dispatch 180 ns (+extra), one
    attempt of 150, a select of 20 and a runner of 100 inside it."""
    top = "convolve.dispatch"
    return [
        _span("routing.select", t0 + 20, t0 + 40, "fault.attempt", call,
              family="convolve.os"),
        _span("convolve.os_route", t0 + 50, t0 + 150, "fault.attempt",
              call, route="cuda_fused"),
        _span("fault.attempt", t0 + 10, t0 + 160, top, call,
              site="convolve.dispatch"),
        _span(top, t0, t0 + 180 + guard_extra, None, call),
    ]


def _records():
    warm = _conv_call(1, 10)             # before the window: dropped
    return (warm + _conv_call(2, 110) + _conv_call(3, 1120, 100)
            + [_span("late", 1990, 2100, None, 4)])


def _readings(device=None):
    w = harness.Window(*(a.copy() for a in WINDOW))
    recs = None if device is None else [
        devtrace.Record("kernel", "k", s, e) for s, e in device]
    return harness.Readings(w, 1.0, 1000, 2, (1.0, 1.0), recs,
                            lambda t: np.asarray(t, float), 0)


@pytest.fixture
def capture(monkeypatch):
    """Point the helper at made-up records instead of the program's."""
    state = {"records": _records(), "dropped": 0}
    fake = types.SimpleNamespace(captured=lambda: types.SimpleNamespace(
        records=state["records"], dropped=state["dropped"]))
    monkeypatch.setattr(progspans, "_OBS", fake)
    monkeypatch.setattr(progspans, "_LAST", [None, None])
    return state


def test_records_outside_the_window_are_dropped(capture):
    calls = progspans.calls(_readings())
    assert [c.top.call for c in calls] == [2, 3]
    assert [len(c.spans) for c in calls] == [3, 3]


@pytest.mark.parametrize("fault", ["missing_top", "dropped", "twice",
                                   "top_outside_call", "orphan"])
def test_unreadable_records_give_none(capture, fault):
    recs = capture["records"]
    if fault == "missing_top":
        capture["records"] = [r for r in recs
                              if not (r.call == 3 and r.parent is None)]
    elif fault == "dropped":
        capture["dropped"] = 1
    elif fault == "twice":
        capture["records"] = recs + [_span("convolve.dispatch", 1130, 1140,
                                           None, 3)]
    elif fault == "top_outside_call":
        # call 3's top span outlives its call's return at 1400
        capture["records"] = [r._replace(end_ns=1500)
                              if r.call == 3 and r.parent is None else r
                              for r in recs]
    else:
        capture["records"] = recs + [_span("routing.select", 500, 510,
                                           "x", 9)]
    r = _readings(device=[(150, 250)])
    assert progspans.calls(r) is None
    for name in ("guard_host_us", "route_host_us", "launch_host_us",
                 "extend_mib_per_call"):
        assert _metric(name).read(r) is None


def test_a_program_without_capture_gives_none(monkeypatch):
    monkeypatch.setattr(progspans, "_OBS", None)
    r = _readings(device=[(150, 250)])
    for name in ("guard_host_us", "route_host_us", "launch_host_us",
                 "extend_mib_per_call"):
        assert _metric(name).read(r) is None


def test_host_metrics_read_the_spans(capture):
    r = _readings()
    # guard: dispatch less its attempt, 180 - 150 and 280 - 150 ns
    assert _metric("guard_host_us").read(r) == pytest.approx(0.08)
    assert _metric("route_host_us").read(r) == pytest.approx(0.02)
    assert _metric("launch_host_us").read(r) == pytest.approx(0.1)
    # no extension count in a convolve call
    assert _metric("extend_mib_per_call").read(r) is None


def test_guard_needs_an_attempt_in_every_call(capture):
    capture["records"] = [r for r in capture["records"]
                          if not (r.call == 3 and r.name == "fault.attempt")]
    assert _metric("guard_host_us").read(_readings()) is None


def test_nested_spans_of_one_kind_count_once(capture):
    capture["records"] = capture["records"] + [
        _span("routing.select", 125, 130, "routing.select", 2),
        _span("routing.select", 1125, 1130, "routing.select", 3)]
    assert _metric("route_host_us").read(_readings()) == pytest.approx(0.02)


def test_extension_bytes_sum_over_calls(capture):
    mib = 1 << 20
    # the counts ride on the spans they were taken in
    capture["records"] = capture["records"] + [
        _span("wavelet_apply.dispatch", 200, 205, "x", 2,
              wavelet_extend_bytes=3 * mib),
        _span("wavelet_apply.dispatch", 210, 215, "x", 2,
              wavelet_extend_bytes=1 * mib),
        _span("wavelet_apply.dispatch", 1200, 1205, "x", 3,
              wavelet_extend_bytes=2 * mib),
        _span("wavelet_apply.dispatch", 20, 25, "x", 1,         # warm-up
              wavelet_extend_bytes=50 * mib)]
    assert _metric("extend_mib_per_call").read(_readings()) == 3.0


@pytest.mark.parametrize("entry, params, top", [
    ("convolve_handle", {"rows": 2, "n": 4096, "taps": 300,
                         "mode": "full"}, "convolve.dispatch"),
    ("wavelet_transform", {"rows": 3, "n": 256, "family": "daub",
                           "order": 8, "ext": "periodic", "levels": 3},
     "wavelet_transform.dispatch")])
def test_a_cpu_window_of_the_program_reads_whole(entry, params, top):
    """The real program's captured spans over a closed loop on the CPU:
    one top span a call, and the extension count equals its formula."""
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.utils.config import get_config, set_config

    old = get_config().device
    set_config(device="cpu")
    try:
        mod = harness.load_module(ROOT / "cellbench" / "entries"
                                  / f"{entry}.py")
        slots, fixed = harness.make_operands(mod.OPERANDS, params, 5, 2,
                                             "cpu")
        call = mod.Entry(params, fixed)
        call(**slots[0])
        obs.configure(max_spans=1 << 12)
        obs.start_capture(counts=progspans.COUNTS)
        w = harness.closed_loop(call, slots, 0.05, lambda: None,
                                harness.Reservoir(5, 1))
        obs.stop_capture()
        cap = obs.captured()
        calls = progspans.group(cap.records, w, cap.dropped)
    finally:
        obs.stop_capture()
        obs.configure(max_spans=32768)
        set_config(device=old)
    assert calls is not None and len(calls) == w.calls >= 1
    assert {c.top.name for c in calls} == {top}
    ext = [s.attrs["wavelet_extend_bytes"] for c in calls for s in c.spans
           if "wavelet_extend_bytes" in s.attrs]
    if entry == "convolve_handle":
        assert [s.name for s in calls[0].spans] == [
            "routing.select", "convolve.os_route", "fault.attempt"]
        assert not ext
    else:
        rows, n = params["rows"], params["n"]
        want = sum(rows * (n // 2 ** lvl + 8) * 4 for lvl in range(3))
        assert sum(ext) == want * len(calls)
        names = [s.name for s in calls[0].spans]
        assert names.count("routing.select") == 3
        assert names.count("wavelet_apply.dispatch") == 3
        # the readers' counts alone are folded in: no "dispatch" count
        assert not any("dispatch" in s.attrs for c in calls
                       for s in c.spans)
