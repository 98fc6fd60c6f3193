"""The 2D filter cells' program-span readers, ``conv2d_runner_host_us``
and ``conv2d_scratch_mib_per_call``, on made-up capture records, and
what they give where the program records no ``convolve2d.route``
span."""

import types
from typing import NamedTuple

import numpy as np
import pytest

from cellbench import harness, progspans

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


NAMES = ("conv2d_runner_host_us", "conv2d_scratch_mib_per_call")

# two calls: call [100, 300), sync [300, 1000), loop [1000, 1100),
# call [1100, 1400), sync [1400, 2000)
WINDOW = (np.array([100, 1100]), np.array([300, 1400]),
          np.array([1000, 2000]))
MIB = 1 << 20


def _call(call, t0, route="fft", runner=100, scratch=0, extend=None,
          with_route=True):
    """A convolve2d call at ``t0``: dispatch 190 ns, an extension span
    of ``extend`` bytes unless None, one attempt and, unless left out,
    a ``convolve2d.route`` span of ``runner`` ns in it."""
    recs = [_span("fault.attempt", t0 + 40, t0 + 170,
                  "convolve2d.dispatch", call, site="convolve2d.dispatch"),
            _span("convolve2d.dispatch", t0, t0 + 190, None, call,
                  algo=route, auto=True)]
    if extend is not None:
        recs.insert(0, _span("convolve2d.extend", t0 + 5, t0 + 35,
                             "convolve2d.dispatch", call, boundary="symm",
                             scratch_bytes=extend))
    if with_route:
        recs.insert(0, _span("convolve2d.route", t0 + 50, t0 + 50 + runner,
                             "fault.attempt", call, route=route,
                             scratch_bytes=scratch))
    return recs


def _readings():
    w = harness.Window(*(a.copy() for a in WINDOW))
    return harness.Readings(w, 1.0, 1000, 0, (1.0, 1.0), None,
                            lambda t: np.asarray(t, float), 0)


@pytest.fixture
def capture(monkeypatch):
    """Point the helper at made-up records instead of the program's."""
    state = {"records": [], "dropped": 0}
    fake = types.SimpleNamespace(captured=lambda: types.SimpleNamespace(
        records=state["records"], dropped=state["dropped"]))
    monkeypatch.setattr(progspans, "_OBS", fake)
    monkeypatch.setattr(progspans, "_LAST", [None, None])
    return state


def test_runner_time_is_the_median_of_the_route_spans(capture):
    capture["records"] = (_call(1, 10, runner=900)            # warm-up
                          + _call(2, 110, runner=100)
                          + _call(3, 1120, runner=130))
    assert _metric("conv2d_runner_host_us").read(_readings()) == \
        pytest.approx(0.115)


def test_scratch_sums_the_route_and_the_extension_over_the_calls(capture):
    capture["records"] = (
        _call(1, 10, scratch=500 * MIB, extend=500 * MIB)    # warm-up
        + _call(2, 110, scratch=3 * MIB, extend=1 * MIB)
        + _call(3, 1120, scratch=5 * MIB, extend=1 * MIB))
    assert _metric("conv2d_scratch_mib_per_call").read(_readings()) == 5.0


def test_the_kernel_route_reads_its_own_scratch_alone(capture):
    capture["records"] = (
        _call(2, 110, route="direct_cuda", scratch=25 * MIB)
        + _call(3, 1120, route="direct_cuda", scratch=25 * MIB))
    assert _metric("conv2d_scratch_mib_per_call").read(_readings()) == 25.0
    assert _metric("conv2d_runner_host_us").read(_readings()) == \
        pytest.approx(0.1)


def test_an_extension_without_a_route_span_gives_none(capture):
    capture["records"] = (_call(2, 110, extend=MIB, with_route=False)
                          + _call(3, 1120, extend=MIB, with_route=False))
    assert _metric("conv2d_scratch_mib_per_call").read(_readings()) is None


def test_a_program_without_the_route_span_gives_none(capture):
    """The parent's calls: one ``convolve2d.dispatch`` a call and no
    ``convolve2d.route`` in it."""
    capture["records"] = (_call(2, 110, with_route=False)
                          + _call(3, 1120, with_route=False))
    assert progspans.calls(_readings()) is not None
    for name in NAMES:
        assert _metric(name).read(_readings()) is None


def test_a_program_without_capture_gives_none(monkeypatch):
    monkeypatch.setattr(progspans, "_OBS", None)
    for name in NAMES:
        assert _metric(name).read(_readings()) is None


@pytest.mark.parametrize("cell,side,names", [
    ("conv2d_512.ssim11", 64, {"convolve2d.route"}),
    ("conv2d_512.blur51", 96, {"convolve2d.extend", "convolve2d.route"})])
def test_a_cpu_window_of_the_program_reads_whole(cell, side, names):
    """The real program's captured spans over a closed loop on the CPU
    at a small size: one ``convolve2d.dispatch`` a call, the route span
    (and the blur's extension span) in it, and the readers read."""
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.utils.config import get_config, set_config

    params = {**harness.load_cell(cell).params, "images": 2, "n0": side,
              "n1": side}
    old = get_config().device
    set_config(device="cpu")
    try:
        mod = harness.load_module(ROOT / "cellbench" / "entries"
                                  / "convolve2d.py")
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
    assert {c.top.name for c in calls} == {"convolve2d.dispatch"}
    for c in calls:
        assert {s.name for s in c.spans} - {"fault.attempt"} == names
        assert all(s.attrs["scratch_bytes"] > 0 for s in c.spans
                   if s.name in names)
