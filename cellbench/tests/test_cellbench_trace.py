"""The arithmetic of a traced run on made-up records: the union of busy
intervals, the idle share, the idle gaps by host span, the metrics that
read them, and CUPTI's record layout."""

import ctypes

import numpy as np
import pytest

from cellbench import devtrace, harness

ROOT = harness.ROOT


def _metric(name):
    return harness.load_module(ROOT / "cellbench" / "metrics" / f"{name}.py")


def test_merge_is_the_union():
    iv = np.array([[5, 7], [0, 2], [1, 3], [6, 9], [10, 11]], float)
    assert harness._merge(iv).tolist() == [[0, 3], [5, 9], [10, 11]]
    assert harness._merge(np.zeros((0, 2))).shape == (0, 2)


def test_attribute_splits_gaps_over_the_spans_they_cross():
    bounds = np.array([0, 10, 30, 35, 45, 65], float)
    labels = np.array([0, 1, 2, 0, 1])
    gaps = np.array([[5, 12], [33, 50], [60, 70]], float)
    got = harness.attribute(gaps, bounds, labels, 3)
    # call: 5-10, 35-45; sync: 10-12, 45-50, 60-65; loop: 33-35
    assert got.tolist() == [15.0, 12.0, 2.0]


def _readings(records):
    # two calls: call [0, 100), sync [100, 1000), loop [1000, 1100),
    # call [1100, 1200), sync [1200, 2000); host ns are CUPTI ns + 50
    w = harness.Window(np.array([50, 1150]), np.array([150, 1250]),
                       np.array([1050, 2050]))
    recs = [devtrace.Record(k, n, s, e) for k, n, s, e in records]
    return harness.Readings(w, 1.0, 1000, 4, (2.0e6, 6.7e3), recs,
                            lambda t: np.asarray(t, float) - 50, 0)


def test_idle_share_gaps_and_per_call_metrics():
    r = _readings([("kernel", "a", 120, 600), ("kernel", "b", 500, 900),
                   ("memset", "Memset", 1300, 1900),
                   ("kernel", "a", 2500, 2600)])
    assert r.busy.tolist() == [[120, 900], [1300, 1900]]
    assert r.busy_s() == pytest.approx(1380e-9)
    idle = r.idle_by_span()
    # gaps: 0-120 (call 0-100, sync 100-120), 900-1300 (sync 900-1000,
    # loop 1000-1100, call 1100-1200, sync 1200-1300), 1900-2000 (sync)
    assert idle == pytest.approx({"call": 200e-9, "sync": 320e-9,
                                  "loop": 100e-9})
    assert _metric("device_idle_pct").read(r) == pytest.approx(31.0)
    assert _metric("kernels_per_call").read(r) == 1.5
    assert _metric("csrc_launches_per_call").read(r) == 2.0
    assert _metric("entry_host_us").read(r) == pytest.approx(0.1)
    # least time max(2e6 / 67e12, 6.7e3 / 3.35e12) s, the operations'
    # 29.85 ns a call, over 1580 ns of records for two calls
    assert _metric("op_roofline").read(r) == pytest.approx(
        100 * 2 * (2e6 / 67e12) / 1580e-9)
    assert r.device_ops() == pytest.approx(
        {"a": 580e-9, "b": 400e-9, "Memset": 600e-9})


def test_untraced_readings_leave_device_metrics_out():
    r = _readings([])
    r.records = None
    for name in ("device_idle_pct", "kernels_per_call", "op_roofline"):
        assert _metric(name).read(r) is None
    assert _metric("msamples_per_s").read(r) == pytest.approx(
        2 * 1000 / 2000e-9 / 1e6)
    assert _metric("call_p95_ms").read(r) == pytest.approx(
        np.percentile([1000, 900], 95) / 1e6)
    assert _metric("setup_s").read(r) == 1.0


def test_host_to_device_is_linear_through_two_anchors():
    f = harness.host_to_device((1000, 5_000_000), (3000, 5_002_004))
    assert f(1000) == 0.0 and f(3000) == pytest.approx(2004.0)
    assert f(np.array([2000])).tolist() == pytest.approx([1002.0])


def test_records_are_read_at_the_header_offsets():
    buf = ctypes.create_string_buffer(256)
    ctypes.c_uint32.from_buffer(buf, 0).value = devtrace.KIND_MEMSET
    ctypes.c_uint64.from_buffer(buf, 16).value = 1000
    ctypes.c_uint64.from_buffer(buf, 24).value = 1750
    rec = devtrace.parse(ctypes.addressof(buf), {})
    assert rec == devtrace.Record("memset", "Memset", 1000, 1750)
    ctypes.c_uint32.from_buffer(buf, 0).value = devtrace.KIND_CONCURRENT_KERNEL
    name = ctypes.create_string_buffer(b"_Z6kernelv")
    ctypes.c_void_p.from_buffer(buf, 104).value = ctypes.addressof(name)
    rec = devtrace.parse(ctypes.addressof(buf), {})
    assert rec.kind == "kernel" and rec.name in ("kernel()", "_Z6kernelv")
    ctypes.c_uint32.from_buffer(buf, 0).value = 99
    assert devtrace.parse(ctypes.addressof(buf), {}) is None
