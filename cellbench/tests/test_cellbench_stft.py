"""The STFT cells' program-span readers, ``stft_runner_host_us`` and
``stft_scratch_mib_per_call``, on made-up capture records, and what
they give where the program records no ``stft.route`` span."""

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


# two calls: call [100, 300), sync [300, 1000), loop [1000, 1100),
# call [1100, 1400), sync [1400, 2000)
WINDOW = (np.array([100, 1100]), np.array([300, 1400]),
          np.array([1000, 2000]))
MIB = 1 << 20


def _stft_call(call, t0, route="rdft_matmul", runner=100, scratch=0,
               with_route=True):
    """An stft call at ``t0``: dispatch 180 ns, one attempt of 150 and,
    unless left out, an ``stft.route`` span of ``runner`` ns in it."""
    recs = [_span("fault.attempt", t0 + 10, t0 + 160, "stft.dispatch",
                  call, site="stft.dispatch"),
            _span("stft.dispatch", t0, t0 + 180, None, call, route=route,
                  path="gather")]
    if with_route:
        recs.insert(0, _span("stft.route", t0 + 20, t0 + 20 + runner,
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
    capture["records"] = (_stft_call(1, 10, runner=900)       # warm-up
                          + _stft_call(2, 110, runner=100)
                          + _stft_call(3, 1120, runner=140))
    assert _metric("stft_runner_host_us").read(_readings()) == \
        pytest.approx(0.12)


def test_scratch_sums_over_the_calls(capture):
    capture["records"] = (
        _stft_call(1, 10, scratch=500 * MIB)                  # warm-up
        + _stft_call(2, 110, scratch=3 * MIB)
        + _stft_call(3, 1120, scratch=5 * MIB))
    assert _metric("stft_scratch_mib_per_call").read(_readings()) == 4.0


def test_the_kernel_route_reads_zero_scratch(capture):
    capture["records"] = (_stft_call(2, 110, route="cuda_fused")
                          + _stft_call(3, 1120, route="cuda_fused"))
    assert _metric("stft_scratch_mib_per_call").read(_readings()) == 0.0
    assert _metric("stft_runner_host_us").read(_readings()) == \
        pytest.approx(0.1)


def test_an_uncounted_route_gives_none(capture):
    capture["records"] = (_stft_call(2, 110, scratch=None)
                          + _stft_call(3, 1120, scratch=None))
    assert _metric("stft_scratch_mib_per_call").read(_readings()) is None
    assert _metric("stft_runner_host_us").read(_readings()) is not None


def test_a_program_without_the_route_span_gives_none(capture):
    """The parent's calls: one ``stft.dispatch`` a call and no
    ``stft.route`` in it."""
    capture["records"] = (_stft_call(2, 110, with_route=False)
                          + _stft_call(3, 1120, with_route=False))
    assert progspans.calls(_readings()) is not None
    for name in ("stft_runner_host_us", "stft_scratch_mib_per_call"):
        assert _metric(name).read(_readings()) is None


def test_a_program_without_capture_gives_none(monkeypatch):
    monkeypatch.setattr(progspans, "_OBS", None)
    for name in ("stft_runner_host_us", "stft_scratch_mib_per_call"):
        assert _metric(name).read(_readings()) is None


def test_a_cpu_window_of_the_program_reads_whole():
    """The real program's captured spans over a closed loop on the CPU
    at 400/160: one ``stft.dispatch`` a call, one ``stft.route`` in it,
    and the scratch of the basis matmul."""
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.utils.config import get_config, set_config

    params = {"rows": 2, "n": 8192, "frame_length": 400, "hop": 160}
    old = get_config().device
    set_config(device="cpu")
    try:
        mod = harness.load_module(ROOT / "cellbench" / "entries"
                                  / "stft.py")
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
    assert {c.top.name for c in calls} == {"stft.dispatch"}
    frames = 1 + (8192 - 400) // 160
    for c in calls:
        (route,) = [s for s in c.spans if s.name == "stft.route"]
        assert route.attrs == {"route": "rdft_matmul",
                               "scratch_bytes": 4 * 2 * frames * 802}
