"""The port's circuit breakers against the JAX package's.

``veles.simd_tpu_torch.runtime.breaker`` on the CPU: the closed -> open
-> half-open machine (sliding window, call-counted probe cadence,
transition decision events and gauges, the registry in
``obs.caches()``, the env knobs), the ``faults.guarded`` outcome wiring,
and the ``ops/`` dispatch sites' per-class breakers — the cases of
``tests/test_breaker.py`` that need no ``serve`` or ``parallel``.  A
random admit/success/failure sequence gives the same verdicts and
states in both packages.
"""

import dataclasses
import threading

import numpy as np
import pytest

from veles.simd_tpu.runtime import breaker as jbreaker
from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.ops import convolve as cv
from veles.simd_tpu_torch.ops import spectral as sp
from veles.simd_tpu_torch.runtime import breaker, faults
from veles.simd_tpu_torch.utils import config

RNG = np.random.RandomState(77)


@pytest.fixture(autouse=True)
def telemetry(monkeypatch):
    """Telemetry on, zero backoff, fresh breaker registry and plans,
    the CPU device."""
    prev = config.get_config()
    was_on = obs.enabled()
    config.set_config(device="cpu")
    monkeypatch.setenv("VELES_SIMD_FAULT_BACKOFF", "0")
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    obs.enable()
    obs.reset()
    breaker.reset()
    faults.reset_fault_history()
    yield
    if not was_on:
        obs.disable()
    obs.reset()
    breaker.reset()
    faults.reset_fault_history()
    faults.set_fault_plan(None)
    config.set_config(**dataclasses.asdict(prev))


def _br(module=breaker, probe_every=4, **kw):
    return module.Breaker("s", "k", window=kw.get("window", 4),
                          threshold=kw.get("threshold", 0.5),
                          min_events=kw.get("min_events", 2),
                          probe_every=probe_every)


def test_defaults_and_all_match_the_jax_package():
    assert (breaker.DEFAULT_WINDOW, breaker.DEFAULT_THRESHOLD,
            breaker.DEFAULT_MIN_EVENTS, breaker.DEFAULT_PROBE_EVERY) == \
        (8, 0.5, 2, 4) == (
            jbreaker.DEFAULT_WINDOW, jbreaker.DEFAULT_THRESHOLD,
            jbreaker.DEFAULT_MIN_EVENTS, jbreaker.DEFAULT_PROBE_EVERY)
    assert breaker.env_policy() == jbreaker.env_policy()
    assert breaker.__all__ == jbreaker.__all__


def test_opens_at_failure_rate():
    br = _br()
    assert br.admit() == breaker.CLOSED
    br.failure()
    assert br.state == breaker.CLOSED     # 1 < min_events
    br.failure()
    assert br.state == breaker.OPEN       # 2/2 >= 0.5


def test_successes_keep_it_closed():
    br = _br()
    for _ in range(3):
        br.success()
    br.failure()
    assert br.state == breaker.CLOSED     # 1/4 < 0.5
    br.failure()
    assert br.state == breaker.OPEN       # 2/4 >= 0.5


def test_probe_cadence_and_short_circuit():
    br = _br(probe_every=3)
    br.failure()
    br.failure()
    assert [br.admit() for _ in range(6)] == [
        "open", "open", "probe", "open", "open", "probe"]
    assert br.state == breaker.HALF_OPEN


def test_probe_success_closes_and_clears():
    br = _br(probe_every=1)
    br.failure()
    br.failure()
    assert br.admit() == "probe"
    br.success()
    assert br.state == breaker.CLOSED
    br.failure()                          # the window was cleared
    assert br.state == breaker.CLOSED


def test_probe_failure_reopens():
    br = _br(probe_every=1)
    br.failure()
    br.failure()
    assert br.admit() == "probe"
    br.failure()
    assert br.state == breaker.OPEN
    assert obs.counter_value("breaker_reopen", site="s", key="'k'") == 1


def test_force_probe_outranks_the_cadence():
    br = _br(probe_every=100)
    br.failure()
    br.failure()
    assert br.admit(force_probe=True) == "probe"
    assert br.state == breaker.HALF_OPEN


def test_transitions_are_decision_events_and_gauges():
    br = breaker.Breaker("site.x", "cls", window=4, threshold=0.5,
                         min_events=2, probe_every=1)
    br.failure()
    br.failure()
    br.admit()
    br.success()
    decisions = [(e["decision"], e["previous"]) for e in obs.events()
                 if e["op"] == "breaker_transition"]
    assert decisions == [("open", "closed"), ("half_open", "open"),
                         ("closed", "half_open")]
    prom = obs.to_prometheus()
    assert "veles_simd_breaker_state" in prom
    assert "veles_simd_breaker_open_total" in prom


def test_registry_and_caches_introspection():
    br = breaker.breaker_for("site.y", ("op", 512))
    assert breaker.breaker_for("site.y", ("op", 512)) is br
    assert breaker.lookup("site.y", ("op", 512)) is br
    assert breaker.lookup("site.y", ("op", 1024)) is None
    br.failure()
    br.failure()
    assert any(i["state"] == breaker.OPEN for i in breaker.snapshot())
    assert obs.caches()["runtime.breakers"]["states"]["open"] >= 1


def test_env_policy(monkeypatch):
    monkeypatch.setenv(breaker.BREAKER_WINDOW_ENV, "16")
    monkeypatch.setenv(breaker.BREAKER_THRESHOLD_ENV, "0.75")
    monkeypatch.setenv(breaker.BREAKER_MIN_EVENTS_ENV, "4")
    monkeypatch.setenv(breaker.BREAKER_PROBE_EVERY_ENV, "7")
    br = breaker.Breaker("s")
    assert (br.window_size, br.threshold, br.min_events,
            br.probe_every) == (16, 0.75, 4, 7)
    monkeypatch.setenv(breaker.BREAKER_WINDOW_ENV, "zero")
    assert breaker.Breaker("s").window_size == breaker.DEFAULT_WINDOW


@pytest.mark.parametrize("probe_every", [3, 4])
def test_probe_cadence_exact_under_concurrent_dispatchers(probe_every):
    br = breaker.Breaker("race.site", f"cls{probe_every}", window=4,
                         threshold=0.5, min_events=2,
                         probe_every=probe_every)
    br.failure()
    br.failure()
    n_threads, verdicts = 24, []
    lock = threading.Lock()
    barrier = threading.Barrier(n_threads)

    def racer():
        barrier.wait()
        v = br.admit()
        with lock:
            verdicts.append(v)

    threads = [threading.Thread(target=racer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    probes = verdicts.count("probe")
    assert probes == n_threads // probe_every
    assert br.info()["probes"] == probes
    assert [br.admit() for _ in range(probe_every)].count("probe") == 1


@pytest.mark.parametrize("seed", range(4))
def test_random_sequences_match_the_jax_breaker(seed):
    r = np.random.RandomState(seed)
    ours = _br(probe_every=3, window=5, min_events=2, threshold=0.4)
    ref = _br(jbreaker, probe_every=3, window=5, min_events=2,
              threshold=0.4)
    for step in r.randint(0, 3, size=200):
        if step == 0:
            assert ours.admit() == ref.admit()
        elif step == 1:
            ours.success()
            ref.success()
        else:
            ours.failure()
            ref.failure()
        assert ours.state == ref.state
    assert ours.info() == ref.info()


# ---------------------------------------------------------------------------
# guarded() outcome wiring
# ---------------------------------------------------------------------------

def test_exhaustion_marks_failure_success_marks_success():
    br = breaker.Breaker("gw", None, window=4, threshold=0.5,
                         min_events=2, probe_every=4)
    with faults.fault_plan("gw:device_lost:6"):
        for _ in range(2):
            assert faults.guarded("gw", lambda: "dev",
                                  fallback=lambda: "oracle",
                                  breaker=br) == "oracle"
    assert br.state == breaker.OPEN
    assert faults.guarded("gw", lambda: "dev", fallback=lambda: "oracle",
                          retries=0, breaker=br) == "dev"
    assert br.state == breaker.CLOSED


def test_overload_storm_cannot_trip_breaker_or_flightrec(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("VELES_SIMD_FLIGHT_DIR", str(tmp_path))
    br = breaker.Breaker("ov", None, window=4, threshold=0.25,
                         min_events=1, probe_every=4)
    with faults.fault_plan("ov:overload:10"):
        for _ in range(10):
            with pytest.raises(faults.InjectedFault):
                faults.guarded("ov", lambda: "dev",
                               fallback=lambda: "oracle", breaker=br)
    assert br.state == breaker.CLOSED
    assert br.info()["failures"] == 0
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# the ops dispatch sites are breaker-gated per shape class
# ---------------------------------------------------------------------------

def test_convolve_class_opens_stops_retrying_and_recloses():
    x = RNG.randn(2048).astype(np.float32)
    h = RNG.randn(33).astype(np.float32)
    want = np.convolve(x.astype(np.float64), h.astype(np.float64))
    with faults.fault_plan("convolve.dispatch:device_lost:9999"):
        for _ in range(4):
            got = np.asarray(cv.convolve(x, h))
            np.testing.assert_allclose(got, want,
                                       atol=1e-3 * np.abs(want).max())
        opened = [b for b in breaker.snapshot()
                  if b["site"] == "convolve.dispatch"]
        assert opened and opened[0]["state"] != breaker.CLOSED
        retries = obs.counter_value("fault_retry",
                                    site="convolve.dispatch")
        np.asarray(cv.convolve(x, h))
        assert obs.counter_value("fault_retry",
                                 site="convolve.dispatch") == retries
        assert obs.counter_value("fault_breaker_short_circuit",
                                 site="convolve.dispatch") >= 1
    # another shape class is untouched by the open breaker
    x2 = RNG.randn(256).astype(np.float32)
    want2 = np.convolve(x2.astype(np.float64), h.astype(np.float64))
    got = cv.convolve(x2, h)
    assert not isinstance(got, np.ndarray)          # the device answer
    np.testing.assert_allclose(np.asarray(got), want2,
                               atol=1e-5 * np.abs(want2).max())
    # the plan cleared: the cadence's next probe recloses the class
    for _ in range(breaker.DEFAULT_PROBE_EVERY):
        cv.convolve(x, h)
    (b,) = [b for b in breaker.snapshot()
            if b["site"] == "convolve.dispatch"
            and b["key"] == repr(("overlap_save", 33, 2048))]
    assert b["state"] == breaker.CLOSED


def test_forced_stft_route_with_an_open_breaker_makes_a_trial():
    x = RNG.randn(4096).astype(np.float32)
    with faults.fault_plan("stft.dispatch:device_lost:9999"):
        for _ in range(2):
            with pytest.raises(RuntimeError):
                sp.stft(x, 256, 64, route="xla_fft")
        br = breaker.lookup("stft.dispatch", ("xla_fft", 256, 64))
        assert br.state == breaker.OPEN
        # no fallback to shed to: a zero-retry trial, which raises
        retries = obs.counter_value("fault_retry", site="stft.dispatch")
        with pytest.raises(RuntimeError):
            sp.stft(x, 256, 64, route="xla_fft")
        assert obs.counter_value("fault_retry",
                                 site="stft.dispatch") == retries
