"""The port's fault-policy engine against the JAX package's.

``veles.simd_tpu_torch.runtime.faults`` on the CPU: the CUDA
classifiers (rejection codes 1/9/701, device losses 46/214/702,
program faults 700/710/716/719, ``OutOfMemoryError``, build and loader
failures), the plan grammar, phases, subsites and the budget clip, the
demote-and-remember path of each of the three kernel routes (an armed
plan opens the kernel gate on the CPU, as in the JAX package), guarded
retry then degradation, the watchdog, and one plan string driven
through both packages (sites mapped by ``routing.SITE_NAMES``) with the
same ``fault_*`` counters and the same ``fault_policy`` decisions.
Answers agree within 1e-5 of max|y| with the JAX package's (1e-4 for
the STFT).
"""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from veles.simd_tpu import obs as jobs
from veles.simd_tpu.ops import convolve as jcv
from veles.simd_tpu.ops import convolve2d as jcv2
from veles.simd_tpu.ops import segments as jseg
from veles.simd_tpu.ops import spectral as jsp
from veles.simd_tpu.runtime import faults as jfaults
from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.obs import flightrec
from veles.simd_tpu_torch.obs.lru import LRUSet
from veles.simd_tpu_torch.ops import convolve as cv
from veles.simd_tpu_torch.ops import convolve2d as cv2
from veles.simd_tpu_torch.ops import cuda_kernels as ck
from veles.simd_tpu_torch.ops import segments as seg
from veles.simd_tpu_torch.ops import spectral as sp
from veles.simd_tpu_torch.runtime import faults, routing
from veles.simd_tpu_torch.utils import config

torch.set_num_threads(1)

REL_TOL = 1e-5
STFT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu_and_clean(monkeypatch):
    """CPU device, telemetry on, zero backoff, clean engines in both
    packages before and after."""
    prev = config.get_config()
    was_on = obs.enabled(), jobs.enabled()
    config.set_config(device="cpu")
    monkeypatch.setenv("VELES_SIMD_FAULT_BACKOFF", "0")
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    for o, f in ((obs, faults), (jobs, jfaults)):
        f.set_fault_plan(None)
        f.reset_fault_history()
        o.reset()
    obs.enable()
    jobs.enable(compile_listeners=False)
    caches = (cv._CUDA_OS_REJECTED, cv2._CUDA2D_REJECTED,
              sp._CUDA_STFT_REJECTED, jcv._PALLAS_OS_REJECTED,
              jcv2._PALLAS2D_OOM_REJECTED, jsp._STFT_PALLAS_REJECTED)
    for c in caches:
        c.reset()
    yield
    for o, f in ((obs, faults), (jobs, jfaults)):
        f.set_fault_plan(None)
        f.reset_fault_history()
        o.disable()
        o.reset()
    if was_on[0]:
        obs.enable()
    if was_on[1]:
        jobs.enable(compile_listeners=False)
    for c in caches:
        c.reset()
    config.set_config(**dataclasses.asdict(prev))


def _np(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# classifiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code", [1, 9, 701])
def test_cuda_rejection_codes_demote(code):
    e = ck.CudaError("stft kernel", code, "refused")
    assert faults.is_mosaic_vmem_oom(e)
    assert not faults.is_transient(e)
    assert not faults.is_overload(e)


@pytest.mark.parametrize("code", [46, 214, 702])
def test_cuda_device_loss_codes_are_transient(code):
    e = ck.CudaError("overlap_save kernel", code, "lost")
    assert faults.is_device_lost(e) and faults.is_transient(e)
    assert not faults.is_mosaic_vmem_oom(e)


@pytest.mark.parametrize("code", [700, 710, 716, 719])
def test_cuda_program_faults_are_never_classified(code):
    text = faults._PROGRAM_FAULT_CODES[code]
    for e in (ck.CudaError("filter_bank kernel", code, text),
              RuntimeError(f"CUDA error: {text}\nCUDA kernel errors "
                           "might be asynchronously reported at some "
                           "other API call, so the stacktrace below "
                           "might be incorrect.")):
        assert not faults.is_mosaic_vmem_oom(e)
        assert not faults.is_transient(e)


@pytest.mark.parametrize("text", [
    "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
    "CUDA error: uncorrectable ECC error encountered",
    "CUDA error: the launch timed out and was terminated"])
def test_torch_cuda_text_device_losses_are_transient(text):
    # cuFFT and cuDNN routes raise torch's text, not a typed error
    assert faults.is_transient(RuntimeError(text))


def test_rejections_are_classified_by_code_not_text():
    # the text of a rejection without the typed error is an ordinary
    # error: nothing demotes on a message that merely looks alike
    assert not faults.is_mosaic_vmem_oom(
        RuntimeError("CUDA error: invalid argument"))
    assert not faults.is_mosaic_vmem_oom(
        ck.CudaError("k", 2, "vmem ran out of memory scoped"))


def test_out_of_memory_is_neither_rejection_nor_transient():
    e = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB; device "
        "unreachable timeout vmem scoped")
    assert not faults.is_mosaic_vmem_oom(e)
    assert not faults.is_transient(e)


def test_injected_kinds_classify_as_in_the_jax_package():
    for kind in faults.FAULT_KINDS:
        e, je = faults.make_fault(kind), jfaults.make_fault(kind)
        assert str(e) == str(je)
        for name in ("is_mosaic_vmem_oom", "is_device_lost",
                     "is_timeout", "is_transient", "is_overload"):
            assert getattr(faults, name)(e) == getattr(jfaults, name)(je)


class _FakeFn:
    def __call__(self, *args):
        return 0


class _FakeLib:
    """A loaded library whose every getter answers 0: the loader's tile
    cross-check must refuse it."""

    def __getattr__(self, name):
        fn = _FakeFn()
        setattr(self, name, fn)
        return fn


def _build_failure(monkeypatch, tmp_path):
    """Make ``ck.load_library`` fail in its real build path: nvcc is
    /bin/false."""
    monkeypatch.setattr(ck, "_lib", None)
    monkeypatch.setattr(ck, "_build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(ck, "_nvcc", lambda: "/bin/false")


def _loader_mismatch(monkeypatch, tmp_path):
    """Make ``ck.load_library`` fail its tile cross-check."""
    lib = tmp_path / "build" / ck._LIB_NAME
    lib.parent.mkdir()
    lib.write_bytes(b"")
    monkeypatch.setattr(ck, "_lib", None)
    monkeypatch.setattr(ck, "_build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(ck.ctypes, "CDLL", lambda path: _FakeLib())


@pytest.mark.parametrize("failure", [_build_failure, _loader_mismatch])
def test_build_and_loader_failures_propagate(monkeypatch, tmp_path,
                                             failure):
    failure(monkeypatch, tmp_path)
    with pytest.raises(ck.KernelBuildError):
        ck.load_library()
    with pytest.raises(ck.KernelBuildError):
        faults.guarded("convolve.dispatch", ck.load_library,
                       fallback=lambda: "oracle")
    with pytest.raises(ck.KernelBuildError):
        faults.demote_and_remember(
            "convolve.os_cuda", ck.load_library, lambda: "matmul",
            cache=set(), key=1, route="cuda_fused",
            fallback_route="xla_matmul", counter="cuda_os_demotion")
    assert not [c for c in obs.snapshot()["counters"]
                if c["name"].startswith("fault_")]
    assert faults.fault_history() == []


def test_build_error_text_cannot_look_transient():
    e = ck.KernelBuildError("nvcc failed on ['stft.cu']: device "
                            "unreachable, timed out, vmem scoped")
    assert not faults.is_transient(e)
    assert not faults.is_mosaic_vmem_oom(e)


# ---------------------------------------------------------------------------
# the plan: grammar, phases, subsites, budget
# ---------------------------------------------------------------------------

def test_env_plan_counts_down(monkeypatch):
    monkeypatch.setenv(faults.FAULT_PLAN_ENV,
                       "a.site:device_lost:2, b.site:vmem_oom")
    assert faults.armed("a.site")
    assert faults.armed("a.site", kind="device_lost")
    assert not faults.armed("a.site", kind="timeout")
    assert faults.armed("b.site")
    assert faults.plan_snapshot()["a.site"] == {"kind": "device_lost",
                                                "remaining": 2}
    for _ in range(2):
        with pytest.raises(faults.InjectedFault):
            faults.inject("a.site")
    faults.inject("a.site")
    assert not faults.armed("a.site")
    assert obs.counter_value("fault_injected", site="a.site",
                             kind="device_lost") == 2


def test_programmatic_plan_overrides_env(monkeypatch):
    monkeypatch.setenv(faults.FAULT_PLAN_ENV, "env.site:timeout:1")
    with faults.fault_plan("prog.site:device_lost:1"):
        assert faults.armed("prog.site")
        assert not faults.armed("env.site")
    assert faults.armed("env.site")


@pytest.mark.parametrize("spec,match", [
    ("too:many:parts:here", "site:kind"),
    ("site:not_a_kind:1", "unknown kind")])
def test_malformed_plan_raises_in_both_packages(spec, match):
    with pytest.raises(ValueError, match=match):
        faults.set_fault_plan(spec)
    with pytest.raises(ValueError, match=match):
        jfaults.set_fault_plan(spec)


@pytest.mark.parametrize("spec", [
    "baseline=;overload=a:overload:4,b:timeout:2;c:device_lost:1;"
    "recovery=;",
    "p=a:device_lost", "w=s:overload:3;x=s:timeout:1"])
def test_phase_parsing_matches_the_jax_package(spec):
    assert faults.parse_phase_plan(spec) == jfaults.parse_phase_plan(spec)


def test_phase_schedule_advances_and_records():
    faults.set_fault_plan("p1=s:overload:2;p2=;p3=s:timeout:1")
    assert faults.current_phase() == "p1"
    assert faults.plan_snapshot() == {
        "s": {"kind": "overload", "remaining": 2}}
    assert faults.advance_phase() == "p2"
    assert faults.plan_snapshot() == {}
    assert faults.advance_phase() == "p3"
    assert faults.armed("s", "timeout")
    assert faults.advance_phase() is None
    assert faults.current_phase() is None
    labels = [e["decision"] for e in obs.events()
              if e["op"] == "fault_phase"]
    assert labels == ["p1", "p2", "p3", "done"]
    with pytest.raises(RuntimeError, match="no phase schedule"):
        faults.set_fault_plan(None)
        faults.advance_phase()


def test_empty_phase_masks_env_plan(monkeypatch):
    monkeypatch.setenv(faults.FAULT_PLAN_ENV, "s:timeout:5")
    faults.set_fault_plan("quiet=;storm=s:device_lost:1")
    assert not faults.armed("s")
    faults.advance_phase()
    assert faults.armed("s", "device_lost")


def test_subsite_plan_only_fires_for_matching_subsite():
    with faults.fault_plan("sub@stft:device_lost:9999"):
        assert faults.guarded("sub", lambda: "ok",
                              subsite="sosfilt") == "ok"
        assert faults.guarded("sub", lambda: "ok") == "ok"
        assert faults.guarded("sub", lambda: "dev",
                              fallback=lambda: "oracle",
                              subsite="stft") == "oracle"


def test_budget_clips_the_retry_loop():
    t0 = faults.monotonic()
    with faults.fault_plan("clip:device_lost:10000"):
        out = faults.guarded("clip", lambda: "dev",
                             fallback=lambda: "oracle", retries=10000,
                             backoff=0.02, budget_s=0.1)
    assert out == "oracle"
    assert faults.monotonic() - t0 < 0.6
    assert obs.counter_value("fault_budget_clipped", site="clip") == 1
    degrade = [e for e in obs.events() if e["op"] == "fault_policy"
               and e["decision"] == "degrade"]
    assert degrade and degrade[-1]["budget_clipped"] is True


def test_retries_env_knob(monkeypatch):
    monkeypatch.setenv(faults.FAULT_RETRIES_ENV, "0")
    calls = []

    def thunk():
        calls.append(1)
        return "ran"

    with faults.fault_plan("knob.site:device_lost:9"):
        assert faults.guarded("knob.site", thunk,
                              fallback=lambda: "degraded") == "degraded"
    assert calls == []
    monkeypatch.setenv(faults.FAULT_RETRIES_ENV, "4")
    with faults.fault_plan("knob.site:device_lost:3"):
        assert faults.guarded("knob.site", thunk,
                              fallback=lambda: "degraded") == "ran"
    assert obs.counter_value("fault_retry", site="knob.site") == 3


def test_backoff_jitter_bounds(monkeypatch):
    monkeypatch.setenv(faults.FAULT_BACKOFF_ENV, "0.08")
    for attempt in (0, 1, 2):
        d = faults.backoff_delay(attempt)
        assert 0.04 * 2 ** attempt <= d <= 0.08 * 2 ** attempt


def test_non_transient_errors_propagate_immediately():
    calls = []

    def thunk():
        calls.append(1)
        raise ValueError("a plain bug")

    with pytest.raises(ValueError, match="plain bug"):
        faults.guarded("bug.site", thunk, fallback=lambda: "no")
    assert calls == [1]
    assert obs.counter_value("fault_retry", site="bug.site") == 0


def test_overload_is_a_typed_shed_not_a_fault():
    with faults.fault_plan("ov:overload:3"):
        for _ in range(3):
            with pytest.raises(faults.InjectedFault) as ei:
                faults.guarded("ov", lambda: "dev",
                               fallback=lambda: "oracle")
            assert faults.is_overload(ei.value)
    assert obs.counter_value("fault_retry", site="ov") == 0
    assert faults.fault_history() == []


# ---------------------------------------------------------------------------
# demote-and-remember through the three kernel routes
# ---------------------------------------------------------------------------

def _demotes(counter):
    return [e for e in obs.events() if e["op"] == "fault_policy"
            and e["decision"] == "demote"], \
        obs.counter_value(counter, reason="compile_oom")


def test_convolve_os_route_demotes_remembers_and_answers():
    x, h = _x(1, 5000), _x(2, 443)
    handle = cv.convolve_overlap_save_initialize(5000, 443)
    jhandle = jcv.convolve_overlap_save_initialize(5000, 443)
    with jfaults.fault_plan("convolve.os_pallas:vmem_oom:5"):
        want = np.asarray(jcv.convolve_overlap_save(jhandle, x, h))
    with faults.fault_plan("convolve.os_cuda:vmem_oom:5"):
        # armed: gate open
        assert cv._OS_FAMILY.select(h_length=443, cuda=False) \
            == "cuda_fused"
        got = cv.convolve_overlap_save(handle, x, h)
        assert isinstance(got, torch.Tensor)
        assert _rel(got, want) < REL_TOL
        assert 443 in cv._CUDA_OS_REJECTED
        # remembered beats armed: the next call skips the kernel
        assert cv._OS_FAMILY.select(h_length=443, cuda=False) \
            != "cuda_fused"
        assert _rel(cv.convolve_overlap_save(handle, x, h), want) \
            < REL_TOL
        assert faults.plan_snapshot()["convolve.os_cuda"]["remaining"] \
            == 4
    ev, n = _demotes("cuda_os_demotion")
    assert n == 1 and len(ev) == 1
    assert (ev[0]["site"], ev[0]["route"], ev[0]["fallback"]) == (
        "convolve.os_cuda", "cuda_fused", "xla_matmul")
    routes = [e["decision"] for e in obs.events()
              if e["op"] == "convolve_os_route"]
    assert routes == ["xla_matmul", "xla_matmul"]
    info = obs.caches()["cuda_os_rejected"]
    assert info["capacity"] == cv._CUDA_OS_MAXSIZE == 64
    assert isinstance(cv._CUDA_OS_REJECTED, LRUSet)


def test_correlate_rides_the_same_demotion():
    from veles.simd_tpu.ops import correlate as jcr
    from veles.simd_tpu_torch.ops import correlate as cr

    x, h = _x(3, 6000), _x(4, 300)
    with jfaults.fault_plan("convolve.os_pallas:vmem_oom:1"):
        want = jcr.cross_correlate(x, h)
    with faults.fault_plan("convolve.os_cuda:vmem_oom:1"):
        got = cr.cross_correlate(x, h)
    assert _rel(got, want) < REL_TOL
    assert 300 in cv._CUDA_OS_REJECTED


@pytest.mark.parametrize("algorithm,fallback", [(None, "fft"),
                                                ("direct", "direct_mxu")])
def test_convolve2d_route_demotes_remembers_and_answers(algorithm,
                                                        fallback):
    x, h = _x(5, 24, 20), _x(6, 3, 5)
    key = (1, 24, 20, 3, 5)
    with jfaults.fault_plan("convolve2d.direct_pallas:vmem_oom:5"):
        want = np.asarray(jcv2.convolve2d(x, h, algorithm))
    with faults.fault_plan("convolve2d.direct_cuda:vmem_oom:5"):
        assert cv2.select_algorithm2d(3, 5, x.shape) == "direct"
        got = cv2.convolve2d(x, h, algorithm)
        assert _rel(got, want) < REL_TOL
        assert key in cv2._CUDA2D_REJECTED
        assert cv2.select_algorithm2d(3, 5, x.shape) != "direct"
        assert _rel(cv2.convolve2d(x, h, algorithm), want) < REL_TOL
    ev, n = _demotes("cuda2d_demotion")
    assert n == 1 and ev[0]["fallback"] == fallback
    assert ev[0]["key"] == repr(key)
    assert obs.caches()["cuda2d_rejected"]["capacity"] == 256


def test_stft_route_demotes_remembers_and_answers():
    x = _x(7, 16384)
    with jfaults.fault_plan("spectral.stft_pallas:vmem_oom:5"):
        want = np.asarray(jsp.stft(x, 256, 128, simd=True))
    with faults.fault_plan("spectral.stft_cuda:vmem_oom:5"):
        frames = sp.frame_count(16384, 256, 128)
        assert sp._STFT_FAMILY.select(
            frame_length=256, hop=128, frames=frames) == "cuda_fused"
        got = sp.stft(x, 256, 128)
        assert _rel(got, want) < STFT_TOL
        assert (256, 128) in sp._CUDA_STFT_REJECTED
        assert sp._STFT_FAMILY.select(
            frame_length=256, hop=128, frames=1000) != "cuda_fused"
        assert _rel(sp.stft(x, 256, 128), want) < STFT_TOL
    ev, n = _demotes("cuda_stft_demotion")
    assert n == 1 and ev[0]["fallback"] == "rdft_matmul"
    demoted = [e for e in obs.events() if e["op"] == "stft_route"
               and e.get("demoted_from") == "cuda_fused"]
    assert demoted and demoted[-1]["decision"] == "rdft_matmul"
    assert obs.caches()["cuda_stft_rejected"]["capacity"] == 256


def test_batched_stft_reaches_the_stft_demotion():
    from veles.simd_tpu_torch.ops import batched as bt

    x = _x(8, 3, 9000)
    with faults.fault_plan("spectral.stft_cuda:vmem_oom:1"):
        got = bt.batched_stft(x, 256, 128)
    assert _rel(got, sp.stft_na(x, 256, 128)) < STFT_TOL
    assert (256, 128) in sp._CUDA_STFT_REJECTED


def test_forced_kernel_route_remembers_but_reraises():
    x = _x(9, 4096)
    with faults.fault_plan("spectral.stft_cuda:vmem_oom:1"):
        with pytest.raises(RuntimeError, match="vmem"):
            sp.stft(x, 256, 128, route="cuda_fused")
    assert (256, 128) in sp._CUDA_STFT_REJECTED
    # the engine itself: forced remembers, then re-raises
    cache = set()

    def refused():
        raise ck.CudaError("k", 1, "invalid argument")

    with pytest.raises(ck.CudaError):
        faults.demote_and_remember(
            "spectral.stft_cuda", refused, lambda: "fallback",
            cache=cache, key=(1, 2), route="cuda_fused",
            fallback_route="rdft_matmul", counter="c", forced=True)
    assert cache == {(1, 2)}


def test_a_typed_rejection_demotes_without_a_plan():
    # the classifier path of the production error, not the injected
    # text: a CudaError with code 1 from the kernel's wrapper
    cache = set()

    def refused():
        raise ck.CudaError("overlap_save kernel", 1, "invalid argument")

    out = faults.demote_and_remember(
        "convolve.os_cuda", refused, lambda: "matmul", cache=cache,
        key=443, route="cuda_fused", fallback_route="xla_matmul",
        counter="cuda_os_demotion")
    assert out == "matmul" and cache == {443}


def test_program_fault_in_a_kernel_route_propagates():
    def crashed():
        raise ck.CudaError("stft kernel", 700,
                           "an illegal memory access was encountered")

    with pytest.raises(ck.CudaError):
        faults.demote_and_remember(
            "spectral.stft_cuda", crashed, lambda: "fallback",
            cache=set(), key=1, route="cuda_fused",
            fallback_route="rdft_matmul", counter="c")
    with pytest.raises(ck.CudaError):
        faults.guarded("stft.dispatch", crashed,
                       fallback=lambda: "oracle")
    assert obs.counter_value("fault_retry", site="stft.dispatch") == 0


# ---------------------------------------------------------------------------
# operands already on the card: no oracle, no demotion
# ---------------------------------------------------------------------------

def test_getenv_follows_every_write_through_os_environ(monkeypatch):
    name = "VELES_SIMD_TEST_GETENV"
    monkeypatch.delenv(name, raising=False)
    assert faults.getenv(name) is None
    monkeypatch.setenv(name, "a:b é")
    assert faults.getenv(name) == "a:b é"
    monkeypatch.setenv(name, "")
    assert faults.getenv(name) == ""
    monkeypatch.delenv(name)
    assert faults.getenv(name) is None
    monkeypatch.setenv(faults.FAULT_PLAN_ENV, "convolve.os_cuda:vmem_oom:2")
    assert faults.armed("convolve.os_cuda")
    monkeypatch.delenv(faults.FAULT_PLAN_ENV)
    assert not faults.armed("convolve.os_cuda")


def test_on_card_is_false_for_host_data():
    assert not faults.on_card(np.zeros(3), [1.0, 2.0], torch.zeros(2),
                              None)


def _card_calls():
    x, h = _x(30, 5000), _x(31, 443)
    handle = cv.convolve_overlap_save_initialize(5000, 443)
    x2, h2 = _x(32, 24, 20), _x(33, 3, 5)
    xs = _x(34, 16384)
    spec = sp.stft(xs, 256, 128)
    return {
        "convolve": ("convolve.dispatch", "convolve.os_cuda",
                     lambda: cv.convolve(handle, x, h),
                     cv._CUDA_OS_REJECTED),
        "convolve2d": ("convolve2d.dispatch", "convolve2d.direct_cuda",
                       lambda: cv2.convolve2d(x2, h2),
                       cv2._CUDA2D_REJECTED),
        "stft": ("stft.dispatch", "spectral.stft_cuda",
                 lambda: sp.stft(xs, 256, 128), sp._CUDA_STFT_REJECTED),
        "istft": ("istft.dispatch", None,
                  lambda: sp.istft(spec, 16384, 256, 128), None),
    }


@pytest.mark.parametrize("entry", ["convolve", "convolve2d", "stft",
                                   "istft"])
def test_card_operands_retry_then_reraise_recorded(monkeypatch, entry):
    site, _, call, _ = _card_calls()[entry]
    monkeypatch.setattr(faults, "on_card", lambda *a: True)
    with faults.fault_plan(f"{site}:device_lost:9999"):
        with pytest.raises(faults.InjectedFault):
            call()
    assert obs.counter_value("fault_retry", site=site) == 2
    assert obs.counter_value("fault_exhausted", site=site,
                             kind="device_lost") == 1
    assert obs.counter_value("fault_degraded", site=site,
                             to="oracle") == 0
    last = [e for e in obs.events() if e["op"] == "fault_policy"][-1]
    assert (last["decision"], last["fallback"]) == ("exhausted", None)
    assert faults.fault_history()[-1]["action"] == "exhausted"


@pytest.mark.parametrize("entry", ["convolve", "convolve2d", "stft"])
def test_card_operands_refused_launch_raises_unremembered(monkeypatch,
                                                          entry):
    _, site, call, cache = _card_calls()[entry]
    monkeypatch.setattr(faults, "on_card", lambda *a: True)
    with faults.fault_plan(f"{site}:vmem_oom:1"):
        with pytest.raises(faults.InjectedFault, match="vmem"):
            call()
    assert len(cache) == 0
    assert obs.counter_value("fault_demotion", site=site) == 0
    assert not [e for e in obs.events() if e["op"] == "fault_policy"]
    # the plan is spent and nothing was remembered: the kernel route's
    # gate is the card's again, so the CPU takes the other route
    assert _np(call()).size


def test_demotion_without_a_fallback_raises_untouched():
    cache = set()

    def refused():
        raise ck.CudaError("overlap_save kernel", 1, "invalid argument")

    with pytest.raises(ck.CudaError):
        faults.demote_and_remember(
            "convolve.os_cuda", refused, None, cache=cache, key=443,
            route="cuda_fused", fallback_route="xla_matmul",
            counter="cuda_os_demotion")
    assert cache == set()
    assert obs.counter_value("fault_demotion", site="convolve.os_cuda") \
        == 0


# ---------------------------------------------------------------------------
# guarded dispatch: retry, then degrade to the oracle
# ---------------------------------------------------------------------------

def test_transient_fault_retries_then_answers_on_the_device():
    x, h = _x(10, 3000), _x(11, 31)
    with faults.fault_plan("convolve.dispatch:device_lost:1"):
        got = cv.convolve(x, h)
    assert isinstance(got, torch.Tensor)
    assert _rel(got, jcv.convolve(x, h)) < REL_TOL
    assert obs.counter_value("fault_retry", site="convolve.dispatch") == 1


@pytest.mark.parametrize("case", ["convolve", "correlate", "convolve2d",
                                  "stft", "istft"])
def test_exhaustion_degrades_with_parity_to_the_jax_oracle(case):
    from veles.simd_tpu.ops import correlate as jcr
    from veles.simd_tpu_torch.ops import correlate as cr

    x, h, x2, h2 = _x(12, 3000), _x(13, 31), _x(14, 20, 24), _x(15, 5, 3)
    spec = jsp.stft_na(x, 256, 64).astype(np.complex64)
    calls = {
        "convolve": ("convolve.dispatch", lambda m: m.convolve(x, h),
                     (jcv, cv)),
        "correlate": ("convolve.dispatch",
                      lambda m: m.cross_correlate(x, h), (jcr, cr)),
        "convolve2d": ("convolve2d.dispatch",
                       lambda m: m.convolve2d(x2, h2), (jcv2, cv2)),
        "stft": ("stft.dispatch", lambda m: m.stft(x, 256, 64),
                 (jsp, sp)),
        "istft": ("istft.dispatch",
                  lambda m: m.istft(spec, 3000, 256, 64), (jsp, sp)),
    }
    site, call, (jmod, tmod) = calls[case]
    with jfaults.fault_plan(f"{site}:device_lost:9"):
        want = np.asarray(call(jmod))
    with faults.fault_plan(f"{site}:device_lost:9"):
        got = call(tmod)
    # both degrade to their NumPy oracles: NumPy out, same dtype
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))
    assert obs.counter_value("fault_retry", site=site) == 2
    assert obs.counter_value("fault_degraded", site=site,
                             to="oracle") == 1


def test_spectrogram_over_a_degraded_stft():
    x = _x(19, 4096)
    with jfaults.fault_plan("stft.dispatch:device_lost:9"):
        want = np.asarray(jsp.spectrogram(x, 256, 64, simd=True))
    with faults.fault_plan("stft.dispatch:device_lost:9"):
        got = sp.spectrogram(x, 256, 64)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert _rel(got, want) < STFT_TOL


def test_forced_route_retries_but_never_degrades():
    x = _x(16, 4096)
    with faults.fault_plan("stft.dispatch:device_lost:9,"
                           "istft.dispatch:device_lost:9"):
        with pytest.raises(RuntimeError, match="device"):
            sp.stft(x, 256, 64, route="xla_fft")
        with pytest.raises(RuntimeError, match="device"):
            sp.istft(np.zeros((61, 129), np.complex64), 4096, 256, 64,
                     route="xla_fft")
    assert obs.counter_value("fault_degraded", site="stft.dispatch",
                             to="oracle") == 0


def test_exhaustion_writes_one_flight_bundle(tmp_path):
    flightrec._reset_auto_count()
    flightrec.configure_flight_dir(str(tmp_path))
    try:
        x, h = _x(17, 3000), _x(18, 31)
        with faults.fault_plan("convolve.dispatch:device_lost:9"):
            cv.convolve(x, h)
        bundles = list(tmp_path.glob("flight-*.json"))
        assert len(bundles) == 1
        bundle = json.loads(bundles[0].read_text())
        assert bundle["schema"] == flightrec.SCHEMA
        assert bundle["reason"] == "fault_exhausted:convolve.dispatch"
        assert [r["action"] for r in bundle["fault_history"]] == \
            ["retry", "retry", "exhausted"]
        assert bundle["config"]["device"] == "cpu"
        assert bundle["platform"]["torch"] == torch.__version__
        # the span ring, the probe history, the journal and the
        # request axis are ported
        assert isinstance(bundle["trace_events"], list)
        assert isinstance(bundle["device_probes"], list)
        assert set(bundle["journal"]) == {"cursor", "stats", "tail"}
        assert bundle["request_traces"]["summary"]["open"] == 0
        counters = {c["name"] for c in bundle["snapshot"]["counters"]}
        assert {"fault_retry", "fault_exhausted"} <= counters
        prom = obs.to_prometheus()
        assert "veles_simd_fault_retry_total" in prom
        assert "veles_simd_fault_degraded_total" in prom
    finally:
        flightrec.configure_flight_dir(None)
        flightrec._reset_auto_count()


def test_exhaustion_bundles_respect_the_auto_budget(tmp_path):
    flightrec._reset_auto_count()
    flightrec.configure_flight_dir(str(tmp_path))
    try:
        with faults.fault_plan("budget.site:device_lost:99"):
            for _ in range(flightrec.MAX_AUTO_BUNDLES + 3):
                assert faults.guarded("budget.site", lambda: "never",
                                      fallback=lambda: "oracle",
                                      retries=0) == "oracle"
        assert len(list(tmp_path.glob("flight-*.json"))) == \
            flightrec.MAX_AUTO_BUNDLES
    finally:
        flightrec.configure_flight_dir(None)
        flightrec._reset_auto_count()


def test_dump_debug_bundle_on_demand(tmp_path):
    path = flightrec.dump_debug_bundle(str(tmp_path / "b.json"),
                                       exc=ValueError("why"))
    bundle = json.loads(open(path).read())
    assert bundle["exception"]["type"] == "ValueError"
    assert bundle["env"].get("VELES_SIMD_FAULT_BACKOFF") == "0"


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------

def test_deadline_watchdog_times_out_then_degrades():
    release = threading.Event()
    try:
        with pytest.raises(faults.FaultTimeout, match="overran"):
            faults.guarded("slow.site", lambda: release.wait(5.0),
                           retries=0, backoff=0, deadline=0.05)
        assert faults.guarded("slow.site", lambda: release.wait(5.0),
                              fallback=lambda: "oracle", retries=0,
                              backoff=0, deadline=0.05) == "oracle"
    finally:
        release.set()
    assert obs.counter_value("fault_exhausted", site="slow.site",
                             kind="timeout") == 2


def test_watchdog_launches_on_the_callers_device_and_stream(monkeypatch):
    """The worker thread enters the caller's CUDA device and current
    stream (torch keeps both per thread): checked on the CPU through
    recording stand-ins for torch.cuda's calls."""
    stream = object()
    entered = []

    class Recorder:
        def __init__(self, kind, value):
            self.kind, self.value = kind, value

        def __enter__(self):
            entered.append((self.kind, self.value,
                            threading.current_thread().name))

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: stream if device == 3
                        else None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: Recorder("device", d))
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: Recorder("stream", s))
    seen = []
    assert faults.guarded("wd.site",
                          lambda: seen.append(
                              threading.current_thread().name) or "ok",
                          deadline=5.0) == "ok"
    worker = "veles-fault-deadline-wd.site"
    assert seen == [worker]
    assert entered == [("device", 3, worker), ("stream", stream, worker)]
    # no deadline: the caller's own thread, nothing entered
    entered.clear()
    assert faults.guarded("wd.site", lambda: "ok") == "ok"
    assert entered == []


def test_watchdog_without_a_card_captures_nothing():
    assert faults._cuda_context() is None


# ---------------------------------------------------------------------------
# one plan through both packages
# ---------------------------------------------------------------------------

# the JAX package's counter and route names -> the port's
COUNTER_NAMES = {"pallas_os_demotion": "cuda_os_demotion",
                 "pallas2d_demotion": "cuda2d_demotion",
                 "stft_pallas_demotion": "cuda_stft_demotion"}
JAX_ROUTE_NAMES = {"pallas_fused": "cuda_fused",
                   "direct_pallas": "direct_cuda"}


def _counters(o, translate):
    out = {}
    for c in o.snapshot()["counters"]:
        name = c["name"]
        if translate:
            name = COUNTER_NAMES.get(name, name)
        if not (name.startswith(("fault_", "breaker_"))
                or name in COUNTER_NAMES.values()):
            continue
        labels = dict(c["labels"])
        if translate and "site" in labels:
            labels["site"] = routing.SITE_NAMES.get(labels["site"],
                                                    labels["site"])
        key = (name, tuple(sorted(labels.items())))
        out[key] = out.get(key, 0) + c["value"]
    return out


def _decisions(o, translate):
    out = []
    for e in o.events():
        if e["op"] not in ("fault_policy", "fault_phase",
                           "breaker_transition"):
            continue
        e = {k: v for k, v in e.items() if k != "seq"}
        if translate:
            for k, names in (("site", routing.SITE_NAMES),
                             ("route", JAX_ROUTE_NAMES)):
                if k in e:
                    e[k] = names.get(e[k], e[k])
        out.append(e)
    return out


def _scenario(name, m):
    """Run one scenario through package ``m`` (a namespace of the
    package's modules); returns the answers as NumPy."""
    x, h = _x(20, 5000), _x(21, 443)
    x2, h2 = _x(22, 24, 20), _x(23, 3, 5)
    xs = _x(24, 16384)
    segs = [_x(25 + i, n) for i, n in enumerate((200, 128, 300))]
    if name == "os":
        hd = m.cv.convolve_overlap_save_initialize(5000, 443)
        return [m.cv.convolve_overlap_save(hd, x, h) for _ in range(2)]
    if name == "dispatch":
        return [m.cv.convolve(x[:3000], h[:31]) for _ in range(4)]
    if name == "correlate":
        return [m.cr.cross_correlate(x, h) for _ in range(2)]
    if name == "2d":
        return [m.cv2.convolve2d(x2, h2), m.cv2.convolve2d(x2, h2),
                m.cv2.convolve2d(x2, h2, "direct")]
    if name == "stft":
        return [m.sp.stft(xs, 256, 128) for _ in range(2)]
    if name == "istft":
        # one spectrum for both packages: the partial window envelope
        # at the edges amplifies any difference of the inputs
        spec = jsp.stft_na(xs[:4096], 256, 64).astype(np.complex64)
        return [m.sp.istft(spec, 4096, 256, 64) for _ in range(2)]
    if name == "segments":
        outs, flags = m.seg.packed_stft(segs, 128, 64)
        return outs + [np.asarray(flags, np.float32) + 1.0]
    if name == "phases":
        out = [m.cv.convolve(x[:3000], h[:31])]
        for _ in range(2):
            m.faults.advance_phase()
            out.append(m.cv.convolve(x[:3000], h[:31]))
        return out
    raise ValueError(name)


PLANS = [
    ("os", "convolve.os_pallas:vmem_oom:5"),
    ("os", "convolve.os_pallas:vmem_oom:1,convolve.dispatch:device_lost:1"),
    ("dispatch", "convolve.dispatch:device_lost:1"),
    ("dispatch", "convolve.dispatch:device_lost:9"),
    ("dispatch", "convolve.dispatch:device_lost:9999"),
    ("dispatch", "convolve.dispatch:timeout:4"),
    ("correlate", "convolve.dispatch:device_lost:4,"
                  "convolve.os_pallas:vmem_oom:1"),
    ("2d", "convolve2d.direct_pallas:vmem_oom:5"),
    ("2d", "convolve2d.direct_pallas:vmem_oom:1"),
    ("2d", "convolve2d.dispatch:device_lost:9"),
    ("stft", "spectral.stft_pallas:vmem_oom:5"),
    ("stft", "stft.dispatch:device_lost:2"),
    ("stft", "stft.dispatch:device_lost:9"),
    ("istft", "istft.dispatch:device_lost:9"),
    ("segments", "segments.dispatch@stft:device_lost:3,"
                 "segments.segment@1:device_lost:1"),
    ("phases", "warm=convolve.dispatch:device_lost:1;"
               "storm=convolve.dispatch:device_lost:9;calm="),
]


@pytest.mark.parametrize("scenario,plan", PLANS)
def test_same_plan_same_counters_and_decisions(scenario, plan):
    from veles.simd_tpu.ops import correlate as jcr
    from veles.simd_tpu_torch.ops import correlate as tcr

    class J:
        cv, cv2, sp, seg, faults, cr = jcv, jcv2, jsp, jseg, jfaults, jcr

    class T:
        cv, cv2, sp, seg, faults, cr = cv, cv2, sp, seg, faults, tcr

    jfaults.set_fault_plan(plan)
    want = _scenario(scenario, J)
    faults.set_fault_plan(routing.port_plan(plan))
    got = _scenario(scenario, T)
    assert _counters(obs, False) == _counters(jobs, True)
    assert _counters(obs, False), "the plan fired nothing"
    assert _decisions(obs, False) == _decisions(jobs, True)
    for g, w in zip(got, want):
        tol = STFT_TOL if np.iscomplexobj(_np(w)) else REL_TOL
        assert _rel(g, w) <= tol


def test_site_names_cover_every_kernel_route():
    sites = {r["fault_site"] for fam in routing.families().values()
             for r in fam.describe()["routes"] if r["fault_site"]}
    assert sites == set(routing.SITE_NAMES.values())
    assert routing.port_plan(
        "a=convolve2d.direct_pallas@x:vmem_oom:2;b=") == \
        "a=convolve2d.direct_cuda@x:vmem_oom:2;b="
