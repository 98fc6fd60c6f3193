"""``tools/loadgen_torch.py`` against ``tools/loadgen.py``.

The port's load generator must draw, from one seed, exactly the
traffic the JAX tool draws (the schedules, the saturation campaign's
heavy-tailed mix, the overhead probe's single class, the pipeline
leg's declarative chain), emit its bench rows in the JAX tool's shape
(``tests/test_serve.py``'s ``bench_rows`` case), and account for a
small flat-out run through the port's server on the CPU with no lost,
double-answered or wrong answer.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import loadgen  # noqa: E402
import loadgen_torch  # noqa: E402
from veles.simd_tpu_torch import obs, serve  # noqa: E402
from veles.simd_tpu_torch.utils import config  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    prev = config.get_config()
    config.set_config(device="cpu")
    yield
    config.set_config(**dataclasses.asdict(prev))


@pytest.fixture
def telemetry():
    obs.enable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _same_requests(mine, ref):
    assert len(mine) == len(ref)
    for (gap, req), (jgap, jreq) in zip(mine, ref):
        assert isinstance(req, serve.Request)
        assert (gap, req.op, req.tenant, req.deadline_ms) == \
            (jgap, jreq.op, jreq.tenant, jreq.deadline_ms)
        assert req.x.dtype == jreq.x.dtype
        assert np.array_equal(req.x, jreq.x)
        assert req.params.keys() == jreq.params.keys()
        for k in req.params:
            np.testing.assert_array_equal(np.asarray(req.params[k]),
                                          np.asarray(jreq.params[k]))


@pytest.mark.parametrize("n,rate,every,size,deadline", [
    (160, 0.0, 0, 0, None),         # bench config 11's flat-out mix
    (300, 500.0, 40, 16, None),     # the CLI's default bursty mix
    (80, 800.0, 20, 5, 250.0),      # with a deadline on every request
])
def test_schedule_draws_what_the_jax_tool_draws(n, rate, every, size,
                                                deadline):
    mine = loadgen_torch.build_schedule(
        np.random.RandomState(11), n, rate, every, size,
        deadline_ms=deadline)
    ref = loadgen.build_schedule(
        np.random.RandomState(11), n, rate, every, size,
        deadline_ms=deadline)
    _same_requests(mine, ref)


def test_ramp_saturation_and_overhead_schedules_match():
    phases = [(2, 5), (2, 50), (2, 5)]
    _same_requests(
        loadgen_torch.build_ramp_schedule(np.random.RandomState(4),
                                          phases),
        loadgen.build_ramp_schedule(np.random.RandomState(4), phases))
    _same_requests(
        loadgen_torch.saturation_schedule(np.random.RandomState(5), 90),
        loadgen.saturation_schedule(np.random.RandomState(5), 90))
    _same_requests(
        loadgen_torch._overhead_schedule(20, np.random.RandomState(6)),
        loadgen._overhead_schedule(20, np.random.RandomState(6)))


def test_pipeline_leg_and_constants_match():
    assert loadgen_torch.pipeline_spec() == loadgen.pipeline_spec()
    for name in ("TRACE_TOL_S", "TRACE_KEYS", "DEFAULT_TENANTS",
                 "PIPELINE_NAME", "PIPELINE_BLOCK", "SATURATION_FRAME",
                 "SATURATION_HOP", "SATURATION_MAX_LEN", "RECOVERY_MIN",
                 "P99_SLACK", "RPC_P50_BUDGET_MS", "RPC_WINDOW"):
        assert getattr(loadgen_torch, name) == getattr(loadgen, name), \
            name


def test_loadgen_bench_rows_shape(telemetry):
    report = {"throughput_rps": 123.4, "wait_p99_s": 0.02}
    rows = loadgen_torch.bench_rows(report)
    metrics = [r["metric"] for r in rows]
    assert "serve throughput" in metrics
    assert "serve p99 inverse latency" in metrics
    for r in rows:
        assert set(r) >= {"metric", "value", "unit"}
    inv = next(r for r in rows
               if r["metric"] == "serve p99 inverse latency")
    assert inv["value"] == 50.0


def test_bench_rows_are_the_jax_tools_rows():
    # telemetry off in both packages: the rows read the report alone
    report = {"throughput_rps": 321.0, "wait_p99_s": 0.004,
              "fairness_min_max": 0.875, "ok": 30, "degraded": 2,
              "deadline_miss": 3}
    assert loadgen_torch.bench_rows(report) == loadgen.bench_rows(report)


def test_flat_out_run_accounts_for_every_request(telemetry):
    schedule = loadgen_torch.build_schedule(np.random.RandomState(2), 24,
                                            rate_hz=0.0)
    with serve.Server(max_batch=8, max_wait_ms=2.0, workers=2,
                      obs_port=-1) as srv:
        report = loadgen_torch.run_load(srv, schedule, verify=6,
                                        rng=np.random.RandomState(0))
    assert report["requests"] == 24
    assert report["ok"] + report["degraded"] == 24
    for k in ("lost", "double_answered", "parity_failures", "errors",
              "trace_orphans", "trace_phase_err",
              "trace_degraded_missing_edge"):
        assert report[k] == 0, (k, report)
    assert report["trace_checked"] == 24
    assert report["throughput_rps"] > 0
