"""The port's measured autotuner and tune cache against the JAX package.

The autotuner and tune-cache cases of ``tests/test_routing.py`` run
here against ``veles.simd_tpu_torch.runtime.routing`` with the same
deterministic fake timer; the routed op families are driven on the CPU
(``device="cpu"``).  Parity cases drive the JAX package and the port
with the same fake-timer table on the same NumPy inputs and hold them
to the same winner (up to the kernel routes' names), the same tune-key
string and packs that read in either package.  The port's own
decisions are tested too: probe errors by its CUDA fault classes, the
device stamp that follows the routed operand, no probe under capture,
and the ``*_bf16_comp`` candidates each package's tables end with.
"""

import dataclasses
import inspect
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import convolve as jcv
from veles.simd_tpu.ops import convolve2d as jcv2
from veles.simd_tpu.ops import matrix as jmx
from veles.simd_tpu.ops import pallas_kernels as jpk
from veles.simd_tpu.ops import spectral as jsp
from veles.simd_tpu.ops import wavelet as jwv
from veles.simd_tpu.runtime import routing as jr
from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.ops import batched as bt
from veles.simd_tpu_torch.ops import convolve as cv
from veles.simd_tpu_torch.ops import convolve2d as cv2
from veles.simd_tpu_torch.ops import cuda_kernels as ck
from veles.simd_tpu_torch.ops import matrix as mx
from veles.simd_tpu_torch.ops import spectral as sp
from veles.simd_tpu_torch.ops import wavelet as wv
from veles.simd_tpu_torch.runtime import faults, routing
from veles.simd_tpu_torch.runtime import precision as prx
from veles.simd_tpu_torch.utils import config

torch.set_num_threads(1)

RNG = np.random.RandomState(71)
H100 = "NVIDIA H100 80GB HBM3"

# JAX route name -> the port's, over every routed family
ROUTE_NAMES = {**cv.ROUTE_NAMES, **sp.ROUTE_NAMES, "pallas": "cuda"}


def _port_name(route):
    return ROUTE_NAMES.get(route, route)


@pytest.fixture(autouse=True)
def _cpu_and_clean(monkeypatch):
    """CPU device, autotune env unset, a clean engine, telemetry off
    and reset afterwards."""
    prev = config.get_config()
    config.set_config(device="cpu")
    for name in (routing.AUTOTUNE_ENV, routing.AUTOTUNE_CACHE_ENV,
                 routing.AUTOTUNE_ITERS_ENV, faults.FAULT_PLAN_ENV,
                 prx.BF16_COMP_ENV):
        monkeypatch.delenv(name, raising=False)
    routing.set_cache_path(None)
    jr.set_cache_path(None)
    obs.reset()
    yield
    routing.set_cache_path(None)
    jr.set_cache_path(None)
    obs.disable()
    obs.reset()
    config.set_config(**dataclasses.asdict(prev))


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    """A tune cache bound to a temp file (both packages read the same
    env name), torn down after the test."""
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv(routing.AUTOTUNE_CACHE_ENV, path)
    routing.set_cache_path(None)
    yield path
    routing.set_cache_path(None)


@pytest.fixture
def autotune_on(monkeypatch):
    monkeypatch.setenv(routing.AUTOTUNE_ENV, "on")
    yield


@pytest.fixture
def telemetry():
    obs.enable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _fake_timer(table, run=True):
    """Deterministic probe timer: seconds per route from ``table``;
    routes absent from the table raise (the probe-failure path).
    ``run=False`` skips calling the thunk."""
    def timer(thunk, name):
        if run:
            thunk()
        if name not in table:
            raise RuntimeError(f"no timing for {name}")
        return table[name]
    return timer


def _np(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _rel(got, want):
    got = _np(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _family(name="probe_fam", **kw):
    return routing.Family(name, (
        routing.Route("a", predicate=lambda n, **_: True, **kw),
        routing.Route("b"),
    ))


# ---------------------------------------------------------------------------
# the engine's surface
# ---------------------------------------------------------------------------

def test_all_is_the_jax_modules_plus_the_site_map():
    assert routing.__all__ == jr.__all__ + ["SITE_NAMES", "port_plan"]
    for name in routing.__all__:
        assert hasattr(routing, name), name
    for name in ("AUTOTUNE_ENV", "AUTOTUNE_CACHE_ENV", "AUTOTUNE_ITERS_ENV",
                 "AUTOTUNE_MODES", "DEFAULT_PROBE_ITERS",
                 "TUNE_CACHE_VERSION", "TUNE_CACHE_MAX_ENTRIES"):
        assert getattr(routing, name) == getattr(jr, name), name


@pytest.mark.parametrize("name", ["Route", "Family", "family"])
def test_constructors_take_the_jax_packages_arguments(name):
    # F16: Route(roofline=...) and (F|f)amily(decision_op=...) are
    # public in the JAX package; the port refused both
    assert str(inspect.signature(getattr(routing, name))) == \
        str(inspect.signature(getattr(jr, name)))
    fam = routing.family("f16_probe", (
        routing.Route("a", roofline={"kind": "conv"}),),
        decision_op="probe_route")
    assert fam.decision_op == "probe_route"
    assert routing.Family("g", (routing.Route("a"),)).decision_op == \
        "g_route"
    assert fam.route("a").roofline == {"kind": "conv"}


@pytest.mark.parametrize("route", ["sharded_matmul_dft", "local_fft"])
def test_fourier_decision_carries_the_jax_roofline_tag(route):
    # F16: the decision event's roofline tag is read from the route, as
    # the JAX package reads it, and names the same kind
    from veles.simd_tpu import obs as jobs
    from veles.simd_tpu import parallel as jpar
    from veles.simd_tpu.parallel import fourier as jfr
    from veles.simd_tpu_torch import parallel as tpar
    from veles.simd_tpu_torch.parallel import fourier as tfr

    x = RNG.randn(1024).astype(np.float32)
    tags = []
    for o, run in (
            (jobs, lambda: jfr.sharded_rfft(
                x, jpar.make_mesh({"sp": 8}), route=route)),
            (obs, lambda: tfr.sharded_rfft(
                x, tpar.make_mesh({"sp": 8}, devices=["cpu"] * 8),
                route=route))):
        o.enable()
        o.reset()
        try:
            run()
            tags.append([e["roofline"] for e in o.events()
                         if e["op"] == "sharded_rfft"])
        finally:
            o.disable()
            o.reset()
    assert tags[0] == tags[1] == [
        "fft" if route == "local_fft" else "dft_matmul"]
    assert tfr._FOURIER_FAMILY.route(route).roofline == \
        jfr._FOURIER_FAMILY.route(route).roofline


def test_route_rooflines_match_the_jax_tables():
    for port_fam, jax_fam in ((cv._OS_FAMILY, jcv._OS_FAMILY),
                              (mx._GEMM_FAMILY, jmx._GEMM_FAMILY),
                              (sp._STFT_FAMILY, jsp._STFT_FAMILY)):
        for name in port_fam.names():
            jname = {v: k for k, v in ROUTE_NAMES.items()}.get(name, name)
            assert port_fam.route(name).roofline == \
                jax_fam.route(jname).roofline, (port_fam.name, name)


def test_autotune_mode_env(monkeypatch):
    assert routing.autotune_mode() == "off"
    monkeypatch.setenv(routing.AUTOTUNE_ENV, "on")
    assert routing.autotune_mode() == "on"
    monkeypatch.setenv(routing.AUTOTUNE_ENV, "READONLY")
    assert routing.autotune_mode() == "readonly"
    monkeypatch.setenv(routing.AUTOTUNE_ENV, "typo")
    assert routing.autotune_mode() == "off"


def test_mode_override_is_thread_local():
    seen = {}

    def worker():
        with routing.autotune_mode_override("on"):
            seen["worker"] = routing.autotune_mode()

    with routing.autotune_mode_override("readonly"):
        assert routing.autotune_mode() == "readonly"
    assert routing.autotune_mode() == "off"
    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen["worker"] == "on"
    assert routing.autotune_mode() == "off"
    with pytest.raises(ValueError, match="mode"):
        with routing.autotune_mode_override("bogus"):
            pass


@pytest.mark.parametrize("raw, want", [("", 8), ("3", 3), ("0", 8),
                                       ("-2", 8), ("x", 8)])
def test_probe_iters_env(monkeypatch, raw, want):
    monkeypatch.setenv(routing.AUTOTUNE_ITERS_ENV, raw)
    assert routing._probe_iters() == want


def test_armed_plan_outranks_cached_winner(fresh_cache, monkeypatch):
    fam = routing.Family("t4b", (
        routing.Route("doomed", predicate=lambda n, **_: True,
                      fault_site="t4b.doomed"),
        routing.Route("safe"),
    ))
    routing.tune_cache().store("t4b", {"n": 1}, "safe")
    monkeypatch.setenv(routing.AUTOTUNE_ENV, "readonly")
    assert fam.select(n=1) == "safe"
    with faults.fault_plan("t4b.doomed:vmem_oom:1"):
        assert fam.select(n=1) == "doomed"


# ---------------------------------------------------------------------------
# measured autotune (deterministic injected timer)
# ---------------------------------------------------------------------------

class TestMeasuredAutotune:
    def test_measured_winner_beats_static_prior(self, fresh_cache,
                                                autotune_on, telemetry):
        fam = _family()
        calls = []
        runners = {"a": lambda: calls.append("a"),
                   "b": lambda: calls.append("b")}
        with routing.probe_timer(_fake_timer({"a": 9.0, "b": 2.0})):
            assert fam.select(runners=runners, n=8) == "b"
        assert set(calls) == {"a", "b"}
        ev = [e for e in obs.events() if e["op"] == "autotune"]
        assert ev and ev[-1]["decision"] == "b"
        assert ev[-1]["static"] == "a"
        assert ev[-1]["timings"] == "a=9000000.0us,b=2000000.0us"
        assert obs.counter_value("autotune_measured",
                                 family="probe_fam") == 1

    def test_winner_persists_and_reloads_across_processes(
            self, fresh_cache, autotune_on):
        fam = _family()
        with routing.probe_timer(_fake_timer({"a": 9.0, "b": 2.0})):
            assert fam.select(runners={"a": lambda: 1,
                                       "b": lambda: 1}, n=8) == "b"
        data = json.load(open(fresh_cache))
        assert data["version"] == routing.TUNE_CACHE_VERSION
        assert data["device"] == "cpu"
        (key, entry), = data["entries"].items()
        assert key == "probe_fam|n=8" and entry["route"] == "b"
        routing.set_cache_path(None)
        with routing.probe_timer(_fake_timer({})):
            assert fam.select(runners={"a": lambda: 1,
                                       "b": lambda: 1}, n=8) == "b"
        assert routing.tune_cache().info()["hits"] >= 1

    def test_readonly_consults_but_never_probes(self, fresh_cache,
                                                monkeypatch):
        fam = _family()
        routing.TuneCache(fresh_cache).store("probe_fam", {"n": 8}, "b",
                                             source="sweep")
        routing.set_cache_path(None)
        monkeypatch.setenv(routing.AUTOTUNE_ENV, "readonly")

        def never(thunk, name):
            raise AssertionError("readonly mode must not probe")

        with routing.probe_timer(never):
            assert fam.select(runners={"a": lambda: 1,
                                       "b": lambda: 1}, n=8) == "b"
            assert fam.select(runners={"a": lambda: 1,
                                       "b": lambda: 1}, n=9) == "a"

    def test_cached_winner_no_longer_eligible_is_ignored(
            self, fresh_cache, autotune_on):
        rejected = set()
        fam = _family("probe_fam2", rejection_cache=lambda: rejected,
                      rejection_key=lambda n, **_: n)
        routing.TuneCache(fresh_cache).store("probe_fam2", {"n": 8}, "a")
        routing.set_cache_path(None)
        rejected.add(8)
        assert fam.select(runners={"b": lambda: 1}, n=8) == "b"

    def test_probe_failure_skips_candidate(self, fresh_cache,
                                           autotune_on):
        fam = _family()

        def boom():
            raise RuntimeError("candidate cannot run here")

        with routing.probe_timer(_fake_timer({"b": 1.0})):
            assert fam.select(runners={"a": boom, "b": lambda: 1},
                              n=8) == "b"
        entry = routing.tune_cache().entry("probe_fam", {"n": 8})
        assert entry["route"] == "b"
        assert entry["timings_us"]["a"] is None

    def test_all_probes_fail_returns_static(self, fresh_cache,
                                            autotune_on):
        fam = _family()

        def boom():
            raise RuntimeError("nope")

        with routing.probe_timer(_fake_timer({})):
            assert fam.select(runners={"a": boom, "b": boom},
                              n=8) == "a"
        assert routing.tune_cache().entry("probe_fam", {"n": 8}) is None

    def test_transient_probe_failure_is_inconclusive(
            self, fresh_cache, autotune_on, monkeypatch, telemetry):
        monkeypatch.setenv(faults.FAULT_RETRIES_ENV, "1")
        monkeypatch.setenv(faults.FAULT_BACKOFF_ENV, "0")
        fam = _family()
        calls = []

        def lost():
            calls.append("a")
            raise RuntimeError("UNAVAILABLE: socket closed")

        with routing.probe_timer(_fake_timer({"b": 1.0})):
            assert fam.select(runners={"a": lost, "b": lambda: 1},
                              n=8) == "a"
        assert len(calls) == 2
        assert routing.tune_cache().entry("probe_fam", {"n": 8}) is None
        assert obs.counter_value("autotune_probe_transient",
                                 family="probe_fam", route="a") == 1
        assert obs.counter_value("autotune_probe_retry",
                                 family="probe_fam", route="a") == 1
        assert not [e for e in obs.events() if e["op"] == "autotune"]

    def test_transient_probe_retry_then_success_persists(
            self, fresh_cache, autotune_on, monkeypatch):
        monkeypatch.setenv(faults.FAULT_RETRIES_ENV, "2")
        monkeypatch.setenv(faults.FAULT_BACKOFF_ENV, "0")
        fam = _family()
        failures = iter([True, False])

        def flaky():
            if next(failures):
                raise RuntimeError("deadline exceeded")

        with routing.probe_timer(_fake_timer({"a": 9.0, "b": 2.0})):
            assert fam.select(runners={"a": flaky, "b": lambda: 1},
                              n=8) == "b"
        entry = routing.tune_cache().entry("probe_fam", {"n": 8})
        assert entry["route"] == "b"
        assert entry["timings_us"]["a"] is not None

    def test_stale_cached_winner_never_overwritten(self, fresh_cache,
                                                   autotune_on):
        routing.TuneCache(fresh_cache).store("probe_fam5", {"n": 8}, "a")
        routing.set_cache_path(None)
        rejected = {8}
        fam = routing.Family("probe_fam5", (
            routing.Route("a", predicate=lambda n, **_: True,
                          rejection_cache=lambda: rejected,
                          rejection_key=lambda n, **_: n),
            routing.Route("b"),
            routing.Route("c"),
        ))

        def never(thunk, name):
            raise AssertionError("a stale entry must not re-probe")

        runners = {"a": lambda: 1, "b": lambda: 1, "c": lambda: 1}
        with routing.probe_timer(never):
            assert fam.select(runners=runners, n=8) == "b"
        assert routing.TuneCache(fresh_cache).lookup(
            "probe_fam5", {"n": 8}) == "a"
        rejected.clear()
        with routing.probe_timer(never):
            assert fam.select(runners=runners, n=8) == "a"

    def test_off_mode_never_touches_cache(self, fresh_cache,
                                          monkeypatch):
        monkeypatch.setenv(routing.AUTOTUNE_ENV, "off")
        fam = _family()

        def never(thunk, name):
            raise AssertionError("off mode must not probe")

        with routing.probe_timer(never):
            assert fam.select(runners={"a": lambda: 1, "b": lambda: 1},
                              n=8) == "a"
        assert not os.path.exists(fresh_cache)

    def test_default_probe_times_host_operands_on_the_host_clock(
            self, fresh_cache, autotune_on, monkeypatch):
        monkeypatch.setenv(routing.AUTOTUNE_ITERS_ENV, "3")
        fam = _family()
        calls = {"a": 0, "b": 0}

        def bump(name):
            # a call long enough that its marginal time stays well
            # above the pack's 0.1 us rounding on a loaded host
            calls[name] += 1
            time.sleep(2e-4)
            return torch.zeros(4)

        x = torch.zeros(16)
        got = fam.select(runners={"a": lambda: bump("a"),
                                  "b": lambda: bump("b")},
                         probe_operand=x, n=8)
        # one warm-up, then pairs of bursts of 2 and 2 + iters calls:
        # one pair, or more where a pair did not resolve its marginal
        for n in calls.values():
            pairs, rest = divmod(n - 1, 2 + 5)
            assert rest == 0 and 1 <= pairs <= routing.PROBE_PAIRS, calls
        entry = routing.tune_cache().entry("probe_fam", {"n": 8})
        assert entry["route"] == got
        assert all(t > 0 for t in entry["timings_us"].values())

    @pytest.mark.parametrize("stalled_pairs", [1, routing.PROBE_PAIRS])
    def test_host_probe_never_stores_an_unresolved_marginal(
            self, fresh_cache, autotune_on, telemetry, monkeypatch,
            stalled_pairs):
        # an injected clock: every call takes 1 us, but the short burst
        # of a stalled pair also waits 50 us, longer than the long
        # burst, so its difference is negative; the JAX engine's floor
        # would store it as 1e-9 s, 0.0 us in the pack, and it would win
        monkeypatch.setenv(routing.AUTOTUNE_ITERS_ENV, "3")
        fam = _family()
        now = [0.0]
        stalls = {"a": stalled_pairs, "b": 0}
        bursts = {"a": 0, "b": 0}

        def clock():
            return now[0]

        def timer(thunk, name):
            def call():
                now[0] += 1e-6
                return thunk()

            def stalling():
                # four reads a pair: the short burst's start and end,
                # then the long one's; the stall lands inside the short
                bursts[name] += 1
                pair, read = divmod(bursts[name] - 1, 4)
                if read == 1 and pair < stalls[name]:
                    now[0] += 50e-6
                return clock()

            return routing._host_probe(call, clock=stalling)

        with routing.probe_timer(timer):
            got = fam.select(runners={"a": lambda: 1, "b": lambda: 1},
                             probe_operand=torch.zeros(16), n=8)
        entry = routing.tune_cache().entry("probe_fam", {"n": 8})
        if stalled_pairs == routing.PROBE_PAIRS:
            # "a" never resolved: the round is inconclusive, the static
            # prior answers and nothing reaches the tune cache
            assert got == "a" and entry is None
            assert obs.counter_value("autotune_probe_unresolved",
                                     family="probe_fam", route="a") == 1
        else:
            # the second pair resolved: 1 us a call for both routes
            assert entry["timings_us"] == {"a": 1.0, "b": 1.0}
            assert bursts["a"] == 8 and bursts["b"] == 4

    def test_card_probe_never_falls_back_to_the_host_clock(self):
        # a card operand without a usable CUDA runtime: the probe fails
        with pytest.raises(RuntimeError, match="no usable CUDA"):
            routing._cuda_probe(lambda: None, torch.device("cuda", 0))


# ---------------------------------------------------------------------------
# probe errors by the port's fault classes
# ---------------------------------------------------------------------------

class TestProbeErrors:
    def _family(self, rejected):
        return _family("probe_err", rejection_cache=lambda: rejected,
                       rejection_key=lambda n, **_: n)

    @pytest.mark.parametrize("code", [1, 9, 701])
    def test_refused_launch_is_remembered_and_skipped(
            self, fresh_cache, autotune_on, code):
        rejected = set()

        def refused():
            raise ck.CudaError("overlap_save kernel", code, "refused")

        with routing.probe_timer(_fake_timer({"b": 1.0})):
            got = self._family(rejected).select(
                runners={"a": refused, "b": lambda: 1}, n=8)
        assert got == "b" and 8 in rejected
        assert routing.tune_cache().entry("probe_err",
                                          {"n": 8})["route"] == "b"

    @pytest.mark.parametrize("code", [46, 214, 702])
    def test_device_loss_makes_the_round_inconclusive(
            self, fresh_cache, autotune_on, monkeypatch, code,
            telemetry):
        monkeypatch.setenv(faults.FAULT_RETRIES_ENV, "1")
        monkeypatch.setenv(faults.FAULT_BACKOFF_ENV, "0")
        rejected = set()
        calls = []

        def lost():
            calls.append(1)
            raise ck.CudaError("stft kernel", code, "lost")

        # "a" measures, "b" keeps failing: nothing stored, the prior
        with routing.probe_timer(_fake_timer({"a": 9.0, "b": 1.0})):
            got = self._family(rejected).select(
                runners={"a": lambda: 1, "b": lost}, n=8)
        assert got == "a" and len(calls) == 2 and not rejected
        assert routing.tune_cache().entry("probe_err", {"n": 8}) is None
        assert obs.counter_value("autotune_inconclusive",
                                 family="probe_err") == 1
        assert obs.counter_value("autotune_probe_transient",
                                 family="probe_err", route="b") == 1

    @pytest.mark.parametrize("error", [
        ck.CudaError("filter_bank kernel", 700, "illegal address"),
        ck.CudaError("filter_bank kernel", 710, "assert"),
        ck.CudaError("filter_bank kernel", 716, "misaligned"),
        ck.CudaError("filter_bank kernel", 719, "launch failure"),
        RuntimeError("CUDA error: an illegal memory access was "
                     "encountered"),
        torch.cuda.OutOfMemoryError("CUDA out of memory. device "
                                    "unreachable vmem scoped"),
        ck.KernelBuildError("nvcc failed on ['stft.cu']: device "
                            "unreachable timeout"),
    ], ids=["700", "710", "716", "719", "text700", "oom", "build"])
    def test_program_faults_and_build_errors_reraise(
            self, fresh_cache, autotune_on, error):
        rejected = set()

        def broken():
            raise error

        with routing.probe_timer(_fake_timer({"b": 1.0})):
            with pytest.raises(type(error)):
                self._family(rejected).select(
                    runners={"a": broken, "b": lambda: 1}, n=8)
        assert not rejected
        assert routing.tune_cache().entry("probe_err", {"n": 8}) is None

    @pytest.mark.parametrize("error", [
        RuntimeError("candidate cannot run here"),
        ck.CudaError("overlap_save kernel", 98, "invalid device "
                     "function"),
        ck.CudaError("overlap_save kernel", 1, "refused"),
        ck.CudaError("stft kernel", 701, "too many resources"),
    ], ids=["unclassified", "98", "refused1", "refused701"])
    def test_card_operand_probe_errors_raise_unremembered(
            self, fresh_cache, autotune_on, monkeypatch, error,
            telemetry):
        # an operand already on the card never gives way to another
        # route: the error surfaces and nothing lands in the pack or in
        # the rejection cache (card operands modelled on the CPU)
        monkeypatch.setattr(faults, "on_card", lambda *ops: True)
        rejected = set()

        def broken():
            raise error

        with routing.probe_timer(_fake_timer({"b": 1.0})):
            with pytest.raises(type(error)):
                self._family(rejected).select(
                    runners={"a": broken, "b": lambda: 1}, n=8)
        assert not rejected
        assert routing.tune_cache().entry("probe_err", {"n": 8}) is None
        assert not routing.tune_cache().entries()
        assert obs.counter_value("autotune_probe_error",
                                 family="probe_err", route="a") == 1

    def test_card_operand_device_loss_stays_inconclusive(
            self, fresh_cache, autotune_on, monkeypatch):
        monkeypatch.setattr(faults, "on_card", lambda *ops: True)
        monkeypatch.setenv(faults.FAULT_RETRIES_ENV, "0")
        rejected = set()

        def lost():
            raise ck.CudaError("stft kernel", 702, "lost")

        with routing.probe_timer(_fake_timer({"a": 9.0, "b": 1.0})):
            assert self._family(rejected).select(
                runners={"a": lambda: 1, "b": lost}, n=8) == "a"
        assert not rejected
        assert routing.tune_cache().entry("probe_err", {"n": 8}) is None

    def test_a_probe_records_no_fault_and_opens_no_breaker(
            self, fresh_cache, autotune_on):
        from veles.simd_tpu_torch.runtime import breaker

        faults.reset_fault_history()
        before = len(breaker.snapshot())
        with routing.probe_timer(_fake_timer({"a": 2.0, "b": 1.0})):
            _family().select(runners={"a": lambda: 1, "b": lambda: 1},
                             n=8)
        assert faults.fault_history() == []
        assert len(breaker.snapshot()) == before


# ---------------------------------------------------------------------------
# the device stamp follows the routed operand
# ---------------------------------------------------------------------------

@pytest.fixture
def card_process(monkeypatch):
    """A process configured for an H100 (the CUDA queries faked): CPU
    tensors routed in it are the case the stamp rule is about."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: H100)
    monkeypatch.setattr(routing, "_device_names", {})
    config.set_config(device="cuda")
    routing.set_cache_path(None)
    yield
    routing.set_cache_path(None)


class TestDeviceStamp:
    def test_kind_follows_the_operand(self, card_process):
        assert routing.device_kind() == H100
        assert routing.device_kind(np.zeros(4)) == H100
        assert routing.device_kind(torch.zeros(4)) == "cpu"
        assert routing.tune_cache().device == H100

    def test_cpu_kind_in_a_cpu_process(self):
        assert routing.device_kind() == "cpu"
        assert routing.device_kind(torch.zeros(2)) == "cpu"
        assert routing.device_kind(np.zeros(2)) == "cpu"
        assert routing.tune_cache().device == "cpu"

    def test_failed_query_is_not_cached(self, monkeypatch):
        monkeypatch.setattr(routing, "_device_names", {})
        config.set_config(device="cuda")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

        def boom(i=0):
            raise RuntimeError("CUDA runtime not initialized")

        monkeypatch.setattr(torch.cuda, "get_device_name", boom)
        assert routing.device_kind() == "unknown"
        assert routing._device_names == {}
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0: H100)
        assert routing.device_kind() == H100
        assert routing._device_names == {0: H100}

    def test_cpu_operand_in_a_card_process_neither_reads_nor_stores(
            self, card_process, tmp_path, monkeypatch, telemetry):
        path = str(tmp_path / "h100.json")
        routing.TuneCache(path).store("probe_fam", {"n": 8}, "b")
        assert json.load(open(path))["device"] == H100
        routing.set_cache_path(path)
        monkeypatch.setenv(routing.AUTOTUNE_ENV, "on")
        fam = _family()

        def never(thunk, name):
            raise AssertionError("a CPU operand must not be probed "
                                 "under the card's stamp")

        runners = {"a": lambda: 1, "b": lambda: 1}
        with routing.probe_timer(never):
            # the card's winner does not steer a CPU call...
            assert fam.select(runners=runners,
                              probe_operand=torch.zeros(8), n=8) == "a"
            # ...nor is a CPU timing stored under the card's stamp
            assert fam.select(runners=runners,
                              probe_operand=torch.zeros(8), n=9) == "a"
        assert routing.tune_cache().entry("probe_fam", {"n": 9}) is None
        assert set(json.load(open(path))["entries"]) == {"probe_fam|n=8"}
        assert obs.counter_value("autotune_device_skip",
                                 family="probe_fam") == 2
        # a host operand bound for the card reads the card's winner
        assert fam.select(runners=runners, probe_operand=np.zeros(8),
                          n=8) == "b"

    def test_cpu_process_stores_under_the_cpu_stamp(self, fresh_cache,
                                                    autotune_on):
        with routing.probe_timer(_fake_timer({"a": 2.0, "b": 1.0})):
            assert _family().select(runners={"a": lambda: 1,
                                             "b": lambda: 1},
                                    probe_operand=torch.zeros(4),
                                    n=8) == "b"
        assert json.load(open(fresh_cache))["device"] == "cpu"

    def test_probe_refused_under_capture(self, fresh_cache, autotune_on,
                                         monkeypatch):
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)

        def never(thunk, name):
            raise AssertionError("no probe while compiling")

        with routing.probe_timer(never):
            assert _family().select(
                runners=lambda: {"a": lambda: 1, "b": lambda: 1},
                probe_operand=torch.zeros(2), n=7) == "a"
        assert routing.tune_cache().entry("probe_fam", {"n": 7}) is None

    def test_graph_capture_counts_as_under_trace(self, monkeypatch):
        assert not routing._is_traced(None)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        assert routing._is_traced(None)


# ---------------------------------------------------------------------------
# the tune cache itself
# ---------------------------------------------------------------------------

class TestTuneCache:
    def test_round_trip(self, tmp_path):
        path = str(tmp_path / "c.json")
        routing.TuneCache(path).store(
            "fam", {"n": 4, "k": 2}, "fast",
            timings_us={"fast": 10.0, "slow": 20.0})
        c2 = routing.TuneCache(path)
        assert c2.lookup("fam", {"k": 2, "n": 4}) == "fast"
        entry = c2.entry("fam", {"n": 4, "k": 2})
        assert entry["timings_us"] == {"fast": 10.0, "slow": 20.0}
        assert entry["source"] == "measured"

    def test_corrupt_file_degrades_to_empty(self, tmp_path):
        path = str(tmp_path / "c.json")
        with open(path, "w") as f:
            f.write("{not json")
        c = routing.TuneCache(path)
        assert c.lookup("fam", {"n": 4}) is None
        assert c.info()["load_errors"] == 1

    def test_version_mismatch_ignored_and_counted(self, tmp_path):
        path = str(tmp_path / "c.json")
        with open(path, "w") as f:
            json.dump({"version": routing.TUNE_CACHE_VERSION + 1,
                       "entries": {"fam|n=4": {"route": "fast"}}}, f)
        c = routing.TuneCache(path)
        assert c.lookup("fam", {"n": 4}) is None
        assert c.info()["version_mismatch"] == 1

    def test_malformed_entries_are_skipped(self, tmp_path):
        path = str(tmp_path / "c.json")
        with open(path, "w") as f:
            json.dump({"version": routing.TUNE_CACHE_VERSION,
                       "entries": {"fam|n=4": {"route": "ok"},
                                   "fam|n=5": "not a dict",
                                   "fam|n=6": {"no_route": 1}}}, f)
        c = routing.TuneCache(path)
        assert c.lookup("fam", {"n": 4}) == "ok"
        assert c.lookup("fam", {"n": 5}) is None
        assert c.lookup("fam", {"n": 6}) is None

    def test_missing_file_is_empty(self, tmp_path):
        c = routing.TuneCache(str(tmp_path / "absent.json"))
        assert c.lookup("fam", {"n": 4}) is None
        assert c.info()["load_errors"] == 0

    def test_device_mismatch_ignored_and_counted(self, tmp_path):
        path = str(tmp_path / "c.json")
        with open(path, "w") as f:
            json.dump({"version": routing.TUNE_CACHE_VERSION,
                       "device": "TPU v5 lite",
                       "entries": {"fam|n=4": {"route": "fast"}}}, f)
        c = routing.TuneCache(path)
        assert c.lookup("fam", {"n": 4}) is None
        assert c.info()["device_mismatch"] == 1
        with open(path, "w") as f:
            json.dump({"version": routing.TUNE_CACHE_VERSION,
                       "entries": {"fam|n=4": {"route": "fast"}}}, f)
        assert routing.TuneCache(path).lookup("fam", {"n": 4}) == "fast"

    def test_save_stamps_this_device(self, tmp_path, monkeypatch):
        path = str(tmp_path / "c.json")
        routing.TuneCache(path).store("fam", {"n": 1}, "r")
        assert json.load(open(path))["device"] == routing.device_kind()
        path2 = str(tmp_path / "h.json")
        monkeypatch.setattr(routing, "device_kind", lambda o=None: H100)
        routing.TuneCache(path2).store("fam", {"n": 1}, "r")
        assert json.load(open(path2))["device"] == H100

    def test_save_refuses_to_destroy_foreign_pack(self, tmp_path):
        path = str(tmp_path / "c.json")
        foreign = {"version": routing.TUNE_CACHE_VERSION,
                   "device": H100,
                   "entries": {"fam|n=4": {"route": "fast"}}}
        with open(path, "w") as f:
            json.dump(foreign, f)
        c = routing.TuneCache(path)
        c.store("fam", {"n": 8}, "mine")
        assert json.load(open(path)) == foreign
        assert c.info()["save_refused"] >= 1
        assert c.lookup("fam", {"n": 8}) == "mine"
        with open(path, "w") as f:
            json.dump({"version": routing.TUNE_CACHE_VERSION + 1,
                       "entries": {"fam|n=4": {"route": "fast"}}}, f)
        routing.TuneCache(path).store("fam", {"n": 8}, "mine")
        assert json.load(open(path))["version"] == \
            routing.TUNE_CACHE_VERSION + 1
        path3 = str(tmp_path / "fresh.json")
        routing.TuneCache(path3).store("fam", {"n": 1}, "r")
        assert json.load(open(path3))["entries"]

    def test_transient_unknown_device_does_not_pin_rejection(
            self, tmp_path, monkeypatch):
        path = str(tmp_path / "c.json")
        with open(path, "w") as f:
            json.dump({"version": routing.TUNE_CACHE_VERSION,
                       "device": "cpu",
                       "entries": {"fam|n=4": {"route": "fast"}}}, f)
        c = routing.TuneCache(path)
        monkeypatch.setattr(routing, "device_kind", lambda o=None:
                            "unknown")
        assert c.lookup("fam", {"n": 4}) is None
        assert c.lookup("fam", {"n": 4}) is None
        assert c.info()["device_mismatch"] == 0
        monkeypatch.undo()
        config.set_config(device="cpu")
        c._next_load_retry = 0.0
        assert c.lookup("fam", {"n": 4}) == "fast"
        assert c.info()["device_mismatch"] == 0

    def test_eviction_drops_oldest_stamp_not_alphabetical(
            self, tmp_path, monkeypatch):
        entries = {"a_newest": {"route": "r", "unix": 300.0},
                   "b_oldest": {"route": "r", "unix": 100.0},
                   "c_mid": {"route": "r", "unix": 200.0}}
        monkeypatch.setattr(routing, "TUNE_CACHE_MAX_ENTRIES", 2)
        routing._evict_oldest(entries)
        assert set(entries) == {"a_newest", "c_mid"}
        path = str(tmp_path / "c.json")
        c = routing.TuneCache(path)
        c.store("fam", {"n": 1}, "r1")
        c.store("fam", {"n": 2}, "r2")
        c2 = routing.TuneCache(path)
        c2.store("fam", {"n": 0}, "r0")
        assert c2.entry("fam", {"n": 1}) is None
        assert c2.entry("fam", {"n": 0})["route"] == "r0"
        assert c2.entry("fam", {"n": 2})["route"] == "r2"
        assert c2.info()["evictions"] == 1

    def test_concurrent_writers_merge_not_clobber(self, tmp_path):
        path = str(tmp_path / "c.json")
        a = routing.TuneCache(path)
        b = routing.TuneCache(path)
        b.lookup("famb", {"n": 1})
        a.store("fama", {"n": 1}, "ra")
        b.store("famb", {"n": 1}, "rb")
        merged = routing.TuneCache(path)
        assert merged.lookup("fama", {"n": 1}) == "ra"
        assert merged.lookup("famb", {"n": 1}) == "rb"

    def test_threads_storing_at_once_lose_no_entry(self, tmp_path):
        path = str(tmp_path / "c.json")
        cache = routing.TuneCache(path)
        errors = []

        def worker(w):
            try:
                for i in range(10):
                    cache.store("fam", {"w": w, "i": i}, "r")
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors and not any(t.is_alive() for t in threads)
        assert len(routing.TuneCache(path).entries()) == 60

    def test_memory_only_without_path(self):
        c = routing.TuneCache(None)
        c.store("fam", {"n": 1}, "r")
        assert c.lookup("fam", {"n": 1}) == "r"
        assert c.save() is None

    def test_registered_in_obs_caches(self, fresh_cache):
        info = obs.caches()["autotune_cache"]
        assert info["path"] == fresh_cache and info["device"] == "cpu"

    def test_key_format_is_shared(self):
        geom = {"hop": 128, "frame_length": 512}
        assert routing.tune_key_str("stft", geom) == \
            "stft|frame_length=512,hop=128" == jr.tune_key_str("stft",
                                                               geom)

    def test_tune_cache_is_bounded(self):
        c = routing.TuneCache(None)
        for i in range(routing.TUNE_CACHE_MAX_ENTRIES + 5):
            c.store("fam", {"n": i}, "r")
        info = c.info()
        assert info["size"] == routing.TUNE_CACHE_MAX_ENTRIES
        assert info["evictions"] == 5
        assert c.lookup("fam", {"n": 0}) is None

    def test_private_tune_cache_shields_the_bound_pack(
            self, fresh_cache, autotune_on):
        routing.TuneCache(fresh_cache).store("probe_pf", {"n": 1},
                                             "stale")
        routing.set_cache_path(None)
        fam = routing.Family("probe_pf", (
            routing.Route("a", predicate=lambda n, **_: True),
            routing.Route("stale"),
        ))
        with routing.probe_timer(_fake_timer({"a": 1.0, "stale": 9.0})):
            with routing.private_tune_cache() as private:
                assert fam.select(runners={"a": lambda: 1,
                                           "stale": lambda: 1},
                                  n=1) == "a"
                assert private.entry("probe_pf",
                                     {"n": 1})["route"] == "a"
        assert routing.TuneCache(fresh_cache).lookup(
            "probe_pf", {"n": 1}) == "stale"

    def test_tune_geom_decouples_class_from_rejection_key(
            self, fresh_cache, autotune_on):
        rejected = obs.LRUSet(8)
        fam = _family("probe_tg", rejection_cache=lambda: rejected,
                      rejection_key=lambda n, **_: n)
        runners = {"a": lambda: 1, "b": lambda: 1}
        with routing.probe_timer(_fake_timer({"a": 1.0, "b": 9.0})):
            assert fam.select(runners=runners, tune_geom={"n": 128},
                              n=100) == "a"
        cache = routing.tune_cache()
        assert cache.lookup("probe_tg", {"n": 128}) == "a"
        assert cache.lookup("probe_tg", {"n": 100}) is None
        with routing.probe_timer(_fake_timer({})):
            assert fam.select(runners=runners, tune_geom={"n": 128},
                              n=97) == "a"

        def refused():
            raise ck.CudaError("filter_2d kernel", 1, "refused")

        with routing.probe_timer(_fake_timer({"b": 1.0})):
            assert fam.select(runners={"a": refused, "b": lambda: 1},
                              tune_geom={"n": 256}, n=200) == "b"
        assert 200 in rejected and 256 not in rejected

    def test_pow2_bucket(self):
        for v in (0, 1, 2, 3, 1 << 20, (1 << 20) + 1):
            assert routing.pow2_bucket(v) == jr.pow2_bucket(v)
        assert routing.pow2_bucket((1 << 20) + 1) == 1 << 21

    def test_runner_factory_only_invoked_when_probing(
            self, fresh_cache, monkeypatch):
        fam = _family("probe_fam4")

        def factory():
            raise AssertionError("factory must not be invoked")

        monkeypatch.setenv(routing.AUTOTUNE_ENV, "off")
        assert fam.select(runners=factory, n=1) == "a"
        monkeypatch.setenv(routing.AUTOTUNE_ENV, "readonly")
        assert fam.select(runners=factory, n=1) == "a"
        monkeypatch.setenv(routing.AUTOTUNE_ENV, "on")
        assert fam.select(eligible=["b"], runners=factory, n=1) == "b"
        with routing.probe_timer(_fake_timer({"a": 2.0, "b": 1.0})):
            assert fam.select(
                runners=lambda: {"a": lambda: 1, "b": lambda: 1},
                n=1) == "b"


# ---------------------------------------------------------------------------
# mesh-keyed tune classes: a winner measured on one topology never
# steers another
# ---------------------------------------------------------------------------

class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


class TestMeshStamp:
    def test_mesh_class_token(self):
        m = _FakeMesh({"dp": 2, "sp": 4})
        assert routing.mesh_class(m) == "dp2xsp4" == jr.mesh_class(m)
        assert routing.mesh_class(m, "sp") == "dp2xsp4@sp" == \
            jr.mesh_class(m, "sp")

    def test_mesh_token_separates_tune_keys(self):
        g4 = {"op": "rfft", "n": 4096,
              "mesh": routing.mesh_class(_FakeMesh({"sp": 4}), "sp")}
        g8 = {"op": "rfft", "n": 4096,
              "mesh": routing.mesh_class(_FakeMesh({"sp": 8}), "sp")}
        assert routing.tune_key_str("parallel.fourier", g4) != \
            routing.tune_key_str("parallel.fourier", g8)

    def test_lookup_distrusts_other_topology_stamp(self, tmp_path):
        cache = routing.TuneCache(str(tmp_path / "t.json"))
        cache.store("parallel.fourier", {"n": 4096},
                    "sharded_matmul_dft", mesh="sp4@sp")
        assert cache.lookup("parallel.fourier", {"n": 4096},
                            mesh="sp4@sp") == "sharded_matmul_dft"
        assert cache.lookup("parallel.fourier", {"n": 4096},
                            mesh="sp8@sp") is None
        assert cache.info()["mesh_mismatch"] == 1
        cache.store("parallel.fourier", {"n": 512}, "local_fft")
        assert cache.lookup("parallel.fourier", {"n": 512},
                            mesh="sp8@sp") == "local_fft"

    def test_store_refuses_cross_mesh_overwrite(self, tmp_path):
        cache = routing.TuneCache(str(tmp_path / "t.json"))
        cache.store("parallel.fourier", {"n": 4096},
                    "sharded_matmul_dft", mesh="sp8@sp")
        cache.store("parallel.fourier", {"n": 4096}, "local_fft",
                    mesh="sp4@sp")
        assert cache.info()["mesh_refused"] == 1
        assert cache.entry("parallel.fourier",
                           {"n": 4096})["route"] == "sharded_matmul_dft"
        cache.store("parallel.fourier", {"n": 4096}, "local_fft",
                    mesh="sp8@sp")
        assert cache.entry("parallel.fourier",
                           {"n": 4096})["route"] == "local_fft"

    def test_select_threads_mesh_stamp_through(self, fresh_cache,
                                               autotune_on):
        fam = _family("probe_mesh")
        with routing.probe_timer(_fake_timer({"a": 9.0, "b": 1.0})):
            got = fam.select(runners={"a": lambda: 1, "b": lambda: 1},
                             mesh="sp8@sp", n=1)
        assert got == "b"
        assert routing.tune_cache().entry("probe_mesh",
                                          {"n": 1})["mesh"] == "sp8@sp"
        probes = []

        def counting(thunk, name):
            probes.append(name)
            thunk()
            return {"a": 1.0, "b": 9.0}[name]

        with routing.probe_timer(counting):
            got4 = fam.select(runners={"a": lambda: 1, "b": lambda: 1},
                              mesh="sp4@sp", n=1)
        assert probes and got4 == "a"


# ---------------------------------------------------------------------------
# packs written by either package read in the other
# ---------------------------------------------------------------------------

def test_jax_pack_reads_identically_in_the_port(tmp_path):
    path = str(tmp_path / "jax.json")
    jc = jr.TuneCache(path)
    jc.store("stft", {"frame_length": 512, "hop": 128, "rows": 1,
                      "frames_class": 64}, "xla_fft",
             timings_us={"xla_fft": 3.0, "rdft_matmul": 4.25})
    jc.store("convolve.os", {"rows": 1, "x_length": 1 << 20,
                             "h_length": 2047, "step": 512,
                             "precision": "highest"},
             "xla_matmul_bf16_comp", source="sweep")
    assert json.load(open(path))["device"] == jr.device_kind() == "cpu"
    pc = routing.TuneCache(path)
    assert pc.entries() == jc.entries()
    assert pc.lookup("stft", {"hop": 128, "frame_length": 512,
                              "rows": 1, "frames_class": 64}) == "xla_fft"


def test_port_pack_reads_identically_in_jax(tmp_path):
    path = str(tmp_path / "port.json")
    pc = routing.TuneCache(path)
    pc.store("hilbert", {"n": 512, "rows": 1}, "matmul_dft",
             timings_us={"matmul_dft": 1.5, "xla_fft": None})
    pc.store("wavelet", {"rows": 8, "n": 256, "order": 8,
                         "dilation": 1, "stride": 2}, "xla_conv",
             mesh="sp4@sp")
    jc = jr.TuneCache(path)
    assert jc.entries() == pc.entries()
    assert jc.lookup("hilbert", {"n": 512, "rows": 1}) == "matmul_dft"
    assert jc.lookup("wavelet", {"rows": 8, "n": 256, "order": 8,
                                 "dilation": 1, "stride": 2},
                     mesh="sp8@sp") is None


def test_a_card_pack_is_foreign_to_both_packages_on_the_cpu(tmp_path):
    path = str(tmp_path / "h100.json")
    with open(path, "w") as f:
        json.dump({"version": 1, "device": H100,
                   "entries": {"stft|n=1": {"route": "r"}}}, f)
    assert jr.TuneCache(path).lookup("stft", {"n": 1}) is None
    assert routing.TuneCache(path).lookup("stft", {"n": 1}) is None
    assert routing.TuneCache(path).info()["device_mismatch"] == 1


# ---------------------------------------------------------------------------
# parity: the same inputs and fake-timer table through both packages
# ---------------------------------------------------------------------------

def _both(jax_call, port_call, jax_table, run=True):
    """Run each package's call under autotune ``on`` with its own
    private cache and the same timer table (port names mapped);
    returns ``((jax_out, jax_entries), (port_out, port_entries))``."""
    port_table = {_port_name(k): v for k, v in jax_table.items()}
    with routing.autotune_mode_override("on"), \
            jr.autotune_mode_override("on"), \
            jr.private_tune_cache() as jc, \
            routing.private_tune_cache() as pc:
        with jr.probe_timer(_fake_timer(jax_table, run)):
            jout = jax_call()
        with routing.probe_timer(_fake_timer(port_table, run)):
            pout = port_call()
        return (jout, jc.entries()), (pout, pc.entries())


def _same_decisions(jent, pent):
    assert jent and set(jent) == set(pent)
    for key in jent:
        assert _port_name(jent[key]["route"]) == pent[key]["route"], key
        assert ({_port_name(r) for r in jent[key]["timings_us"]}
                == set(pent[key]["timings_us"])), key


_STFT_TABLES = [
    {"rdft_matmul": 5.0, "xla_fft": 1.0, "rdft_matmul_bf16_comp": 9.0},
    {"rdft_matmul": 5.0, "xla_fft": 3.0, "rdft_matmul_bf16_comp": 1.0},
]


@pytest.mark.parametrize("table", _STFT_TABLES)
@pytest.mark.parametrize("shape", [(4096,), (3, 2048)])
def test_stft_parity(shape, table):
    x = RNG.randn(*shape).astype(np.float32)
    (jy, jent), (py, pent) = _both(
        lambda: np.asarray(jsp.stft(x, 256, 128, simd=True)),
        lambda: sp.stft(x, 256, 128), table)
    _same_decisions(jent, pent)
    (key,) = pent
    assert "frames_class=0" in key and "hop=128" in key
    want = jsp.stft_na(x, 256, 128)
    budget = prx.ERROR_BUDGETS["bf16_comp"]
    assert _rel(py, want) <= budget and _rel(jy, want) <= budget


@pytest.mark.parametrize("table", [
    {"rdft_matmul": 5.0, "xla_fft": 1.0, "rdft_matmul_bf16_comp": 9.0},
    {"rdft_matmul": 5.0, "xla_fft": 3.0, "rdft_matmul_bf16_comp": 1.0},
])
def test_istft_parity(table):
    x = RNG.randn(2, 4096).astype(np.float32)
    spec = jsp.stft_na(x, 256, 64).astype(np.complex64)
    (jy, jent), (py, pent) = _both(
        lambda: np.asarray(jsp.istft(spec, 4096, 256, 64, simd=True)),
        lambda: sp.istft(spec, 4096, 256, 64), table)
    _same_decisions(jent, pent)
    core = slice(256 - 64, 4096 - 256 + 64)
    want = jsp.istft_na(spec, 4096, 256, 64)[:, core]
    budget = prx.ERROR_BUDGETS["bf16_comp"]
    assert _rel(_np(py)[:, core], want) <= budget
    assert _rel(jy[:, core], want) <= budget


@pytest.mark.parametrize("table", [
    {"matmul_dft": 2.0, "xla_fft": 1.0, "matmul_dft_bf16_comp": 3.0},
    {"matmul_dft": 2.0, "xla_fft": 3.0, "matmul_dft_bf16_comp": 1.0},
])
def test_hilbert_parity(table):
    x = RNG.randn(2, 300).astype(np.float32)
    (jy, jent), (py, pent) = _both(
        lambda: np.asarray(jsp.hilbert(x, simd=True)),
        lambda: sp.hilbert(x), table)
    _same_decisions(jent, pent)
    assert list(pent) == ["hilbert|n=512,rows=2"]
    assert _rel(py, jsp.hilbert_na(x)) <= prx.ERROR_BUDGETS["bf16_comp"]


@pytest.mark.parametrize("table", [
    {"matmul_dft": 2.0, "xla_fft": 1.0, "matmul_dft_bf16_comp": 3.0},
    {"matmul_dft": 2.0, "xla_fft": 3.0, "matmul_dft_bf16_comp": 1.0},
])
def test_morlet_cwt_parity(table):
    x = RNG.randn(200).astype(np.float32)
    scales = [2.0, 4.0, 8.0]
    (jy, jent), (py, pent) = _both(
        lambda: np.asarray(jsp.morlet_cwt(x, scales, simd=True)),
        lambda: sp.morlet_cwt(x, scales), table)
    _same_decisions(jent, pent)
    assert list(pent) == ["morlet_cwt|n=256,scales=4"]
    assert _rel(py, jsp.morlet_cwt_na(x, scales)) <= \
        prx.ERROR_BUDGETS["bf16_comp"]


@pytest.mark.parametrize("table", [
    {"xla_matmul": 5.0, "xla_matmul_bf16_comp": 1.0},
    {"xla_matmul": 1.0, "xla_matmul_bf16_comp": 5.0},
])
def test_convolve_os_parity(table):
    x = RNG.randn(2, 5000).astype(np.float32)
    h = RNG.randn(300).astype(np.float32)
    jh = jcv.convolve_overlap_save_initialize(5000, 300)
    ph = cv.convolve_overlap_save_initialize(5000, 300)
    (jy, jent), (py, pent) = _both(
        lambda: np.asarray(jcv.convolve(jh, x, h, simd=True)),
        lambda: cv.convolve(ph, x, h), table)
    _same_decisions(jent, pent)
    assert list(pent) == ["convolve.os|h_length=300,precision=highest,"
                          "rows=2,step=256,x_length=8192"]
    want = jcv.convolve_na(x.astype(np.float64), h.astype(np.float64))
    assert _rel(py, want) <= prx.ERROR_BUDGETS["bf16_comp"]


@pytest.mark.parametrize("table", [
    {"direct_pallas": 9.0, "direct_mxu": 1.0},
    {"direct_pallas": 1.0, "direct_mxu": 9.0},
])
def test_convolve_direct_parity(monkeypatch, table):
    monkeypatch.setattr(jcv, "_use_pallas_direct", lambda *a: True)
    monkeypatch.setattr(ck, "should_route", lambda *a: True)
    x = RNG.randn(8, 200).astype(np.float32)
    h = RNG.randn(9).astype(np.float32)
    (jy, jent), (py, pent) = _both(
        lambda: np.asarray(jcv.convolve_simd(x, h, simd=True)),
        lambda: cv.convolve_simd(x, h), table)
    _same_decisions(jent, pent)
    assert list(pent) == ["convolve.direct|k=9,n=256,rows=8"]
    assert _rel(py, jy) <= 1e-5


@pytest.mark.parametrize("table", [{"pallas": 9.0, "xla_conv": 1.0},
                                   {"pallas": 1.0, "xla_conv": 9.0}])
def test_wavelet_parity(monkeypatch, table):
    monkeypatch.setattr(jpk, "should_route", lambda *a: True)
    monkeypatch.setattr(ck, "should_route", lambda *a: True)
    x = RNG.randn(8, 256).astype(np.float32)
    args = (jwv.WaveletType.DAUBECHIES, 8, jwv.ExtensionType.PERIODIC)
    (jy, jent), (py, pent) = _both(
        lambda: [np.asarray(a) for a in jwv.wavelet_apply(*args, x,
                                                          simd=True)],
        lambda: wv.wavelet_apply(wv.WaveletType.DAUBECHIES, 8,
                                 wv.ExtensionType.PERIODIC, x), table)
    _same_decisions(jent, pent)
    assert list(pent) == ["wavelet|dilation=1,n=256,order=8,rows=8,"
                          "stride=2"]
    for a, b in zip(py, jy):
        assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("table", [{"direct": 9.0, "fft": 1.0},
                                   {"direct": 1.0, "fft": 9.0}])
def test_convolve2d_parity(monkeypatch, table):
    monkeypatch.setattr(jcv2, "_use_pallas_direct2d", lambda *a: True)
    monkeypatch.setattr(ck, "on_card", lambda cuda: True)
    x = RNG.randn(3, 20, 30).astype(np.float32)
    h = RNG.randn(3, 3).astype(np.float32)
    # the timer runs no candidate; the winner is dispatched (the JAX
    # kernel in interpret mode, the port's as its plain version)
    (jy, jent), (py, pent) = _both(
        lambda: np.asarray(jcv2.convolve2d(x, h, simd=True)),
        lambda: cv2.convolve2d(x, h), table, run=False)
    _same_decisions(jent, pent)
    assert list(pent) == ["convolve2d|k0=3,k1=3,n0=32,n1=32,rows=4"]
    assert _rel(py, jcv2.convolve2d_na(x, h)) <= 1e-5


@pytest.mark.parametrize("table", [{"fp32": 9.0, "bf16_comp": 1.0},
                                   {"fp32": 1.0, "bf16_comp": 9.0}])
def test_gemm_parity(table):
    a = RNG.randn(40, 24).astype(np.float32)
    b = RNG.randn(24, 33).astype(np.float32)
    (jy, jent), (py, pent) = _both(
        lambda: np.asarray(jmx.matrix_multiply(a, b, simd=True)),
        lambda: mx.matrix_multiply(a, b), table)
    _same_decisions(jent, pent)
    assert list(pent) == ["matrix.gemm|h1=64,rows=1,t=0,w1=32,w2=64"]
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert _rel(py, want) <= prx.ERROR_BUDGETS["bf16_comp"]


def test_stream_route_hooks_consult_the_pack(fresh_cache, monkeypatch):
    monkeypatch.setenv(routing.AUTOTUNE_ENV, "readonly")
    geom = routing.pipeline_tune_geom({"x_length": 4096,
                                       "h_length": 31})
    assert geom == jr.pipeline_tune_geom({"x_length": 4096,
                                          "h_length": 31})
    assert cv.select_stream_route(4096, 31, tune_geom=geom) == \
        "overlap_save"
    routing.tune_cache().store("convolve", geom, "fft")
    assert cv.select_stream_route(4096, 31, tune_geom=geom) == "fft"
    stft_geom = {"frame_length": 256, "hop": 128}
    routing.tune_cache().store("stft", stft_geom,
                               "rdft_matmul_bf16_comp")
    assert sp.select_stft_stream_route(256, 128, 30,
                                       tune_geom=stft_geom) == \
        "rdft_matmul_bf16_comp"
    x = RNG.randn(128 + 1024).astype(np.float32)
    got = sp.stft_stream_step(x, 256, 128, sp.hann_window(256),
                              "rdft_matmul_bf16_comp")
    want = sp.stft_stream_step(x, 256, 128, sp.hann_window(256),
                               "xla_fft")
    assert _rel(got, want) <= prx.ERROR_BUDGETS["bf16_comp"]


# ---------------------------------------------------------------------------
# end to end: the measured winner steers a real op and survives a
# "process restart" (a fresh cache object on the same file)
# ---------------------------------------------------------------------------

class TestAutotunedDispatch:
    def test_stft_measured_winner_selected_persisted_reloaded(
            self, fresh_cache, autotune_on, telemetry):
        x = RNG.randn(4096).astype(np.float32)
        timer = _fake_timer({"rdft_matmul": 5.0, "xla_fft": 1.0,
                             "cuda_fused": 9.0,
                             "rdft_matmul_bf16_comp": 7.0})
        with routing.probe_timer(timer):
            sp.stft(x, 256, 128)
        route_ev = [e for e in obs.events() if e["op"] == "stft_route"]
        assert route_ev[-1]["decision"] == "xla_fft"
        tune_ev = [e for e in obs.events() if e["op"] == "autotune"][-1]
        assert tune_ev["decision"] == "xla_fft"
        assert tune_ev["family"] == "stft"
        assert tune_ev["static"] == "rdft_matmul"
        data = json.load(open(fresh_cache))
        keys = [k for k in data["entries"] if k.startswith("stft|")]
        assert keys and data["entries"][keys[0]]["route"] == "xla_fft"
        routing.set_cache_path(None)
        obs.reset()
        with routing.probe_timer(_fake_timer({})):
            sp.stft(x, 256, 128)
        route_ev = [e for e in obs.events() if e["op"] == "stft_route"]
        assert route_ev[-1]["decision"] == "xla_fft"
        assert not [e for e in obs.events() if e["op"] == "autotune"]
        assert obs.counter_value("autotune_cache_hit",
                                 family="stft") >= 1
        info = obs.caches()["autotune_cache"]
        assert info["hits"] >= 1 and info["path"] == fresh_cache

    def test_stft_geometry_classes_are_finite(self, fresh_cache,
                                              autotune_on):
        timer = _fake_timer({"rdft_matmul": 1.0, "xla_fft": 5.0,
                             "rdft_matmul_bf16_comp": 9.0})
        probes = []

        def counting(thunk, name):
            probes.append(name)
            return timer(thunk, name)

        with routing.probe_timer(counting):
            sp.stft(RNG.randn(4096).astype(np.float32), 256, 128)
            first = len(probes)
            assert first == 3
            sp.stft(RNG.randn(8192).astype(np.float32), 256, 128)
            assert len(probes) == first
        keys = [k for k in routing.tune_cache().entries()
                if k.startswith("stft|")]
        assert len(keys) == 1 and "frames_class=" in keys[0]

    def test_wavelet_measured_winner(self, fresh_cache, autotune_on,
                                     monkeypatch):
        monkeypatch.setattr(ck, "should_route", lambda *a: True)
        x = RNG.randn(8, 256).astype(np.float32)
        with routing.probe_timer(_fake_timer({"cuda": 9.0,
                                              "xla_conv": 1.0})):
            wv.wavelet_apply(wv.WaveletType.DAUBECHIES, 8,
                             wv.ExtensionType.PERIODIC, x)
        entry = routing.tune_cache().entry(
            "wavelet", {"rows": 8, "n": 256, "order": 8,
                        "dilation": 1, "stride": 2})
        assert entry is not None and entry["route"] == "xla_conv"

    def test_swt_probes_its_dilated_class(self, fresh_cache, autotune_on,
                                          monkeypatch):
        monkeypatch.setattr(ck, "should_route", lambda *a: True)
        x = RNG.randn(8, 200).astype(np.float32)
        with routing.probe_timer(_fake_timer({"cuda": 1.0,
                                              "xla_conv": 9.0})):
            hi, lo = wv.stationary_wavelet_apply(
                wv.WaveletType.DAUBECHIES, 4, 3,
                wv.ExtensionType.PERIODIC, x)
        want = wv.stationary_wavelet_apply_na(
            wv.WaveletType.DAUBECHIES, 4, 3, wv.ExtensionType.PERIODIC, x)
        assert _rel(hi, want[0]) <= 1e-5 and _rel(lo, want[1]) <= 1e-5
        assert routing.tune_cache().entry(
            "wavelet", {"rows": 8, "n": 256, "order": 4, "dilation": 4,
                        "stride": 1})["route"] == "cuda"

    def test_off_mode_is_bit_identical_static(self, telemetry):
        x = RNG.randn(4096).astype(np.float32)
        ref = sp.stft(x, 256, 128, route="rdft_matmul")
        got = sp.stft(x, 256, 128)
        ev = [e for e in obs.events() if e["op"] == "stft_route"][-1]
        assert ev["decision"] == sp._STFT_FAMILY.static_select(
            frame_length=256, hop=128,
            frames=sp.frame_count(4096, 256, 128))
        assert not [e for e in obs.events() if e["op"] == "autotune"]
        assert torch.equal(got, ref)

    def test_hilbert_probe_runs_real_candidates(self, fresh_cache,
                                                autotune_on):
        x = RNG.randn(300).astype(np.float32)
        with routing.probe_timer(_fake_timer({"matmul_dft": 2.0,
                                              "xla_fft": 1.0,
                                              "matmul_dft_bf16_comp":
                                                  3.0})):
            got = sp.hilbert(x)
        assert _rel(got, sp.hilbert_na(x)) <= 1e-5
        entry = routing.tune_cache().entry(
            "hilbert", {"n": routing.pow2_bucket(300), "rows": 1})
        assert entry["route"] == "xla_fft"
        with routing.probe_timer(_fake_timer({})):
            sp.hilbert(RNG.randn(400).astype(np.float32))
        keys = [k for k in routing.tune_cache().entries()
                if k.startswith("hilbert|")]
        assert len(keys) == 1

    def test_batched_stft_honors_pack_winner(self, fresh_cache,
                                             monkeypatch):
        frames = sp.frame_count(4096, 512, 128)
        assert sp._STFT_FAMILY.static_select(
            frame_length=512, hop=128, frames=frames) == "rdft_matmul"
        for winner in ("xla_fft", "rdft_matmul_bf16_comp"):
            routing.tune_cache().store(
                "stft", sp._stft_tune_class(512, 128, frames, rows=4),
                winner)
            monkeypatch.setenv(routing.AUTOTUNE_ENV, "readonly")
            assert sp._STFT_FAMILY.select(
                frame_length=512, hop=128, frames=frames,
                tune_geom=sp._stft_tune_class(512, 128, frames, 4)) \
                == winner
            x = RNG.randn(4, 4096).astype(np.float32)
            before = routing.tune_cache().info()["hits"]
            got = bt.batched_stft(x, 512, 128)
            assert routing.tune_cache().info()["hits"] > before
            assert _rel(got, sp.stft_na(x, 512, 128)) <= \
                prx.ERROR_BUDGETS["bf16_comp"]
        monkeypatch.setenv(routing.AUTOTUNE_ENV, "off")
        assert sp._STFT_FAMILY.select(
            frame_length=512, hop=128, frames=frames,
            tune_geom=sp._stft_tune_class(512, 128, frames, 4)) \
            == "rdft_matmul"

    def test_convolve2d_measured_fft_is_recorded(
            self, fresh_cache, autotune_on, monkeypatch, telemetry):
        monkeypatch.setattr(ck, "on_card", lambda cuda: True)
        x = RNG.randn(2, 16, 16).astype(np.float32)
        h = RNG.randn(3, 3).astype(np.float32)
        with routing.probe_timer(_fake_timer({"direct": 9.0,
                                              "fft": 1.0})):
            got = cv2.convolve2d(x, h)
        ev = [e["decision"] for e in obs.events()
              if e["op"] == "convolve2d"]
        assert ev[-2:] == ["autotune_fft", "fft"]
        assert _rel(got, cv2.convolve2d_na(x, h)) <= 1e-5
        # an explicit "direct" is never re-routed by the autotuner
        obs.reset()
        cv2.convolve2d(x, h, algorithm="direct")
        assert [e["decision"] for e in obs.events()
                if e["op"] == "convolve2d"] == ["direct_cuda"]

    def test_gemm_measured_winner(self, fresh_cache, autotune_on,
                                  telemetry):
        a = RNG.randn(16, 8).astype(np.float32)
        b = RNG.randn(8, 4).astype(np.float32)
        with routing.probe_timer(_fake_timer({"fp32": 9.0,
                                              "bf16_comp": 1.0})):
            got = mx.matrix_multiply(a, b)
        ev = [e for e in obs.events()
              if e["op"] == "matrix_precision_route"][-1]
        assert ev["decision"] == "bf16_comp"
        want = a.astype(np.float64) @ b.astype(np.float64)
        assert _rel(got, want) <= prx.ERROR_BUDGETS["bf16_comp"]

    def test_correlation_reaches_the_direct_family(self, fresh_cache,
                                                   autotune_on,
                                                   monkeypatch):
        from veles.simd_tpu_torch.ops import correlate as cr

        monkeypatch.setattr(ck, "should_route", lambda *a: True)
        x = RNG.randn(8, 100).astype(np.float32)
        h = RNG.randn(5).astype(np.float32)
        with routing.probe_timer(_fake_timer({"direct_cuda": 1.0,
                                              "direct_mxu": 9.0})):
            got = cr.cross_correlate_simd(x, h)
        assert _rel(got, cr.cross_correlate_na(x, h)) <= 1e-5
        assert routing.tune_cache().entry(
            "convolve.direct", {"rows": 8, "n": 128,
                                "k": 5})["route"] == "direct_cuda"


# ---------------------------------------------------------------------------
# the *_bf16_comp candidates sit after each table's terminal fallback
# ---------------------------------------------------------------------------

_COMP_TABLES = [
    (cv._OS_FAMILY, jcv._OS_FAMILY, "xla_matmul_bf16_comp"),
    (sp._STFT_FAMILY, jsp._STFT_FAMILY, "rdft_matmul_bf16_comp"),
    (sp._ISTFT_FAMILY, jsp._ISTFT_FAMILY, "rdft_matmul_bf16_comp"),
    (sp._HILBERT_FAMILY, jsp._HILBERT_FAMILY, "matmul_dft_bf16_comp"),
    (sp._CWT_FAMILY, jsp._CWT_FAMILY, "matmul_dft_bf16_comp"),
]


def test_routes_after_the_fallback_join_only_a_tuned_selection(
        fresh_cache, monkeypatch):
    calls = []

    def comp_gate(**_):
        calls.append(1)
        return True

    fam = routing.Family("probe_tail", (
        routing.Route("a", predicate=lambda n, **_: True),
        routing.Route("b"),
        routing.Route("c", predicate=comp_gate),
    ))
    runners = {"a": lambda: 1, "b": lambda: 1, "c": lambda: 1}
    # off: the caller's list is final and the tail's gate is not read
    assert fam.select(eligible=["b"], runners=runners, n=8) == "b"
    assert not calls
    monkeypatch.setenv(routing.AUTOTUNE_ENV, "on")
    with routing.probe_timer(_fake_timer({"a": 3.0, "b": 2.0,
                                          "c": 1.0})):
        assert fam.select(eligible=["a", "b"], runners=runners,
                          n=8) == "c"
    entry = routing.tune_cache().entry("probe_tail", {"n": 8})
    assert set(entry["timings_us"]) == {"a", "b", "c"}


@pytest.mark.parametrize("port, ref, comp", _COMP_TABLES,
                         ids=[t[2] + "@" + t[0].name
                              for t in _COMP_TABLES])
def test_comp_route_is_last_after_the_terminal_fallback(port, ref, comp,
                                                        monkeypatch):
    assert port.names()[-1] == comp == ref.names()[-1]
    assert [_port_name(n) for n in ref.names()] == list(port.names())
    route = port.route(comp)
    assert route.disable_env == prx.BF16_COMP_ENV
    geom = {"h_length": 300, "frame_length": 256, "hop": 128, "n": 256}
    assert comp in port.eligible(**geom)
    assert port.static_select(**geom) != comp
    monkeypatch.setenv(prx.BF16_COMP_ENV, "1")
    assert comp not in port.eligible(**geom)


@pytest.mark.parametrize("jax_env,family,route,geom", [
    ("VELES_SIMD_DISABLE_PALLAS_OS", lambda: cv._OS_FAMILY, "cuda_fused",
     dict(h_length=2047, cuda=True)),
    ("VELES_SIMD_DISABLE_PALLAS2D", lambda: cv2._CONV2D_FAMILY,
     "direct", dict(rows=16, n0=512, n1=512, k0=7, k1=7, cuda=True)),
    ("VELES_SIMD_DISABLE_PALLAS_WAVELET", lambda: wv._WAVELET_FAMILY,
     "cuda", dict(rows=8, n=4096, order=8, stride=2, dilation=1,
                  cuda=True)),
    ("VELES_SIMD_DISABLE_STFT_PALLAS", lambda: sp._STFT_FAMILY,
     "cuda_fused", dict(frame_length=512, hop=128, frames=64,
                        cuda=True)),
], ids=["os", "2d", "wavelet", "stft"])
def test_jax_opt_out_switches_close_the_port_routes(monkeypatch, jax_env,
                                                    family, route, geom):
    # F3: each JAX opt-out switch is an alias of the port's own
    fam = family()
    r = fam.route(route)
    port_env = r.disable_env
    assert routing._JAX_DISABLE_ENVS[port_env] == jax_env
    assert fam.static_select(**geom) == route
    monkeypatch.setenv(jax_env, "1")
    assert fam.static_select(**geom) != route
    monkeypatch.delenv(jax_env)
    monkeypatch.setenv(port_env, "1")
    assert fam.static_select(**geom) != route


@pytest.mark.parametrize("jax_name,port_name,family", [
    ("pallas_fused", "cuda_fused", lambda: cv._OS_FAMILY),
    ("direct_pallas", "direct_cuda", lambda: cv._DIRECT_FAMILY),
    ("pallas", "cuda", lambda: wv._WAVELET_FAMILY),
    ("pallas_fused", "cuda_fused", lambda: sp._STFT_FAMILY),
])
def test_families_accept_the_jax_route_names(jax_name, port_name, family):
    # F3: a family looks a JAX route name up as the port's route
    fam = family()
    assert fam.route(jax_name) is fam.route(port_name)
    assert jax_name in (cv.ROUTE_NAMES | sp.ROUTE_NAMES
                        | wv.ROUTE_NAMES)
    with pytest.raises(ValueError, match="route must be one of"):
        fam.route("nonsense")


# ---------------------------------------------------------------------------
# every routed entry is steered by its tune-cache winner
# ---------------------------------------------------------------------------

def _decisions(op):
    return [e["decision"] for e in obs.events() if e["op"] == op]


def _batched_stft_routes():
    return [k[-1] for k in bt.handle_cache_info()["keys"]
            if k[0] == "stft"]


def _packed_stft(x):
    from veles.simd_tpu_torch.ops import segments as seg

    # four segments of a hop multiple pack one a row: the packed array
    # is [4, 4096], the geometry of the stft cases
    return seg.packed_stft(list(x), 512, 128, simd=True)


_STFT_CLASS = {"frame_length": 512, "hop": 128, "rows": 4,
               "frames_class": 0}

# entry -> (family, the entry's tune class, the static prior as the
# call reports it, planted winner, device term opened on the CPU or
# None, the call, what the call dispatched: its decision event or the
# runner that ran)
_STEERED = {
    "convolve-direct": (
        "convolve.direct", {"rows": 8, "n": 256, "k": 9}, "direct_cuda",
        "direct_mxu", "should_route",
        lambda: cv.convolve_simd(RNG.randn(8, 200).astype(np.float32),
                                 RNG.randn(9).astype(np.float32)),
        lambda: _decisions("convolve_direct_route")[-1]),
    "convolve-os": (
        "convolve.os", {"rows": 2, "x_length": 8192, "h_length": 300,
                        "step": 256, "precision": "highest"},
        "cuda_fused", "xla_matmul", "on_card",
        lambda: cv.convolve(cv.convolve_overlap_save_initialize(5000, 300),
                            RNG.randn(2, 5000).astype(np.float32),
                            RNG.randn(300).astype(np.float32)),
        lambda: _decisions("convolve_os_route")[-1]),
    "wavelet_apply": (
        "wavelet", {"rows": 8, "n": 256, "order": 8, "dilation": 1,
                    "stride": 2}, "cuda", "xla_conv", "should_route",
        lambda: wv.wavelet_apply(wv.WaveletType.DAUBECHIES, 8,
                                 wv.ExtensionType.PERIODIC,
                                 RNG.randn(8, 256).astype(np.float32)),
        lambda: _decisions("wavelet_apply")[-1]),
    "stft": (
        "stft", _STFT_CLASS, "rdft_matmul", "xla_fft", None,
        lambda: sp.stft(RNG.randn(4, 4096).astype(np.float32), 512, 128),
        lambda: _decisions("stft_route")[-1]),
    "batched_stft": (
        "stft", _STFT_CLASS, "rdft_matmul", "xla_fft", None,
        lambda: bt.batched_stft(RNG.randn(4, 4096).astype(np.float32),
                                512, 128),
        lambda: _batched_stft_routes()[-1]),
    "packed_stft": (
        "stft", _STFT_CLASS, "rdft_matmul", "xla_fft", None,
        lambda: _packed_stft(RNG.randn(4, 4096).astype(np.float32)),
        lambda: _batched_stft_routes()[-1]),
    "istft": (
        "istft", {"frame_length": 512, "hop": 128, "rows": 4},
        "rdft_matmul", "xla_fft", None,
        lambda: sp.istft(sp.stft_na(RNG.randn(4, 4096), 512, 128)
                         .astype(np.complex64), 4096, 512, 128),
        lambda: _decisions("istft_route")[-1]),
    "hilbert": (
        "hilbert", {"n": 512, "rows": 4}, "matmul_dft", "xla_fft", None,
        lambda: sp.hilbert(RNG.randn(4, 300).astype(np.float32)),
        lambda: _decisions("hilbert_route")[-1]),
    "morlet_cwt": (
        "morlet_cwt", {"n": 256, "scales": 4}, "matmul_dft", "xla_fft",
        None,
        lambda: sp.morlet_cwt(RNG.randn(2, 256).astype(np.float32),
                              [2.0, 4.0, 8.0]),
        lambda: _decisions("morlet_cwt_route")[-1]),
    "gemm": (
        "matrix.gemm", {"h1": 64, "w1": 32, "w2": 64, "rows": 1, "t": 0},
        "fp32", "bf16_comp", None,
        lambda: mx.matrix_multiply(RNG.randn(40, 24).astype(np.float32),
                                   RNG.randn(24, 33).astype(np.float32)),
        lambda: _decisions("matrix_precision_route")[-1]),
    "convolve2d": (
        "convolve2d", {"rows": 4, "n0": 32, "n1": 32, "k0": 3, "k1": 3},
        "direct_cuda", "fft", "on_card",
        lambda: cv2.convolve2d(RNG.randn(3, 20, 30).astype(np.float32),
                               RNG.randn(3, 3).astype(np.float32)),
        lambda: _decisions("convolve2d")[-1]),
}


@pytest.mark.parametrize("entry", sorted(_STEERED))
def test_every_entry_dispatches_its_pack_winner(entry, fresh_cache,
                                                monkeypatch, telemetry):
    family, tune_class, static, winner, seam, call, dispatched = \
        _STEERED[entry]
    if seam is not None:
        monkeypatch.setattr(ck, seam, lambda *a: True)
    bt.clear_handle_cache()
    # off: the static prior, whatever the pack holds
    routing.tune_cache().store(family, tune_class, winner)
    call()
    assert dispatched() == static
    # readonly: the planted winner, from the entry's own tune key, and
    # nothing probed
    monkeypatch.setenv(routing.AUTOTUNE_ENV, "readonly")
    bt.clear_handle_cache()
    before = obs.counter_value("autotune_cache_hit", family=family)

    def no_probe(thunk, name):
        raise AssertionError(f"{entry} probed {name}")

    with routing.probe_timer(no_probe):
        call()
    assert dispatched() == winner
    assert obs.counter_value("autotune_cache_hit", family=family) \
        > before
    assert not _decisions("autotune")
