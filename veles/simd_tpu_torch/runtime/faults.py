"""Fault-policy engine: demote-and-remember, retry/backoff, injection.

The port of ``veles.simd_tpu.runtime.faults``: the same three pieces,
plan grammar, phases, subsites, counters, decision events, env knobs,
``budget_s`` and ``on_fault``, with the classifiers read for CUDA.

* **demote-and-remember** (:func:`demote_and_remember`) — the
  rejection policy of a kernel route.  A launch the card refuses for
  its geometry is *permanent for the geometry* (the same shape is
  refused again): classify it (:func:`is_mosaic_vmem_oom`, the JAX
  name kept), remember the geometry key in a bounded rejection cache
  (:func:`register_rejection_cache` puts every such cache in
  ``obs.caches()``), count and record the demotion, and invoke the
  caller's fallback route.  A *forced* route re-raises after
  remembering — a caller who pinned a kernel must never silently get
  another route's numbers.  The port's three kernel routes demote at
  ``convolve.os_cuda``, ``convolve2d.direct_cuda`` and
  ``spectral.stft_cuda``, for host operands only (:func:`on_card`).

* **guarded dispatch** (:func:`guarded`) — the transient-fault policy
  around the dispatch sites (``convolve.dispatch``,
  ``convolve2d.dispatch``, ``stft.dispatch``, ``istft.dispatch``,
  ``segments.dispatch``, ``segments.segment``).  Device losses and
  watchdog deadline overruns (:func:`is_transient`) get bounded
  jittered-exponential retry (``VELES_SIMD_FAULT_RETRIES`` /
  ``VELES_SIMD_FAULT_BACKOFF``); on exhaustion the op degrades to its
  fallback (the NumPy oracle twin — correct output beats no output)
  and the crash flight recorder is armed with the accumulated fault
  history.  The oracle serves host operands only (:func:`on_card`).
  Every step is a ``fault_*`` counter (``veles_simd_fault_*`` in the
  Prometheus export) and a ``fault_policy`` decision event.

* **deterministic fault injection** (:func:`inject` /
  ``VELES_SIMD_FAULT_PLAN``) — ``site:kind:count,...`` raises
  synthetic faults (``vmem_oom`` / ``device_lost`` / ``timeout`` /
  ``overload``) whose messages match the classifiers at named sites,
  so every demotion and retry path runs on the CPU without a card.
  :func:`armed` lets route *gates* open for a planned site, so the
  doomed route is actually selected and the whole demote path runs
  end to end.  ``site@subsite`` entries poison one class of a shared
  site, and ``label=entries;label=entries;...`` is a phase schedule
  (:func:`advance_phase`).  ``runtime.routing.SITE_NAMES`` maps the
  JAX package's kernel-route sites to the port's, so one chaos plan
  drives both packages.

The CUDA classification (by code where a kernel wrapper raised
``ops.cuda_kernels.CudaError``, by torch's ``"CUDA error: ..."`` text
elsewhere):

* rejections, permanent for the geometry: ``cudaErrorInvalidValue``
  (1, also what ``cudaFuncSetAttribute`` returns for a dynamic
  shared-memory request past the card's limit),
  ``cudaErrorInvalidConfiguration`` (9) and
  ``cudaErrorLaunchOutOfResources`` (701);
* transient device losses: ``cudaErrorDevicesUnavailable`` (46),
  ``cudaErrorECCUncorrectable`` (214) and ``cudaErrorLaunchTimeout``
  (702);
* never classified, so they propagate at once: the program faults
  ``cudaErrorIllegalAddress`` (700), ``cudaErrorAssert`` (710),
  ``cudaErrorMisalignedAddress`` (716) and ``cudaErrorLaunchFailure``
  (719) — retrying or degrading them would hide a kernel bug;
  ``torch.cuda.OutOfMemoryError`` (HBM pressure is not a property of
  the geometry); and ``ops.cuda_kernels.KernelBuildError`` (an
  ``nvcc`` build or link failure, or the loader's tile cross-check).

Operands already on the card are never handed to the CPU or to
another route: for them a dispatch site retries its transient faults
and then re-raises with the fault recorded (the guard gets no
fallback), and a kernel route's refusal re-raises untouched, nothing
remembered — the admission gates are exact arithmetic, so a launch
refused after its gate admitted it is a program fault.  Only host
operands get the oracle and the demotion.

An error in the 700s is sticky: the CUDA context is unusable
afterwards, so retries fail again and the oracle is the only answer
for host operands.  Execution faults surface at the next
synchronisation, outside the guard: the guard sees launch-time
errors, and adds no synchronisation.

Each attempt of :func:`guarded` runs inside an ``obs.span(
"fault.attempt", site=...)``: the guard's own host time is its
caller's dispatch span less its attempts, and a retry shows as a
second attempt.  A fault closes the span before the policy sees it, so
the span never trips the flight recorder's crash hook.
"""

from __future__ import annotations

import collections
import contextlib
import os
import random
import sys
import threading
import time

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.obs._env import getenv
from veles.simd_tpu_torch.runtime import breaker as _breaker

__all__ = [
    "is_mosaic_vmem_oom", "is_device_lost", "is_timeout", "is_transient",
    "is_overload",
    "InjectedFault", "FaultTimeout", "make_fault", "monotonic",
    "inject", "armed", "set_fault_plan", "fault_plan", "plan_snapshot",
    "parse_phase_plan", "advance_phase", "current_phase",
    "demote_and_remember", "guarded", "breaker_guarded",
    "register_rejection_cache",
    "fault_retries", "fault_backoff", "fault_deadline", "backoff_delay",
    "fault_history", "reset_fault_history",
    "FAULT_PLAN_ENV", "FAULT_RETRIES_ENV", "FAULT_BACKOFF_ENV",
    "FAULT_DEADLINE_ENV", "DEFAULT_RETRIES", "DEFAULT_BACKOFF_S",
    "FAULT_KINDS", "FAULT_HISTORY_MAXLEN",
]

FAULT_PLAN_ENV = "VELES_SIMD_FAULT_PLAN"
FAULT_RETRIES_ENV = "VELES_SIMD_FAULT_RETRIES"
FAULT_BACKOFF_ENV = "VELES_SIMD_FAULT_BACKOFF"
FAULT_DEADLINE_ENV = "VELES_SIMD_FAULT_DEADLINE"

# transient-fault retry budget per dispatch (attempts = retries + 1)
# and the base backoff delay; both env-tunable, the JAX package's
# defaults
DEFAULT_RETRIES = 2
DEFAULT_BACKOFF_S = 0.05

# retained fault records for the flight recorder (per process)
FAULT_HISTORY_MAXLEN = 64




# ---------------------------------------------------------------------------
# exception classifiers
# ---------------------------------------------------------------------------

# CUDA runtime error codes (cuda_runtime_api.h) and the strings
# cudaGetErrorString gives them, which torch reports as
# "CUDA error: <string>"
_REJECTION_CODES = frozenset((1, 9, 701))
_DEVICE_LOST_CODES = {
    46: "cuda-capable device(s) is/are busy or unavailable",
    214: "uncorrectable ecc error encountered",
    702: "the launch timed out and was terminated",
}
_PROGRAM_FAULT_CODES = {
    700: "an illegal memory access was encountered",
    710: "device-side assert triggered",
    716: "misaligned address",
    719: "unspecified launch failure",
}


def _cuda_code(e: BaseException):
    """The CUDA error code a kernel wrapper's typed error carries
    (``ops.cuda_kernels.CudaError``), else None."""
    if getattr(e, "code", None) is None:
        return None
    from veles.simd_tpu_torch.ops.cuda_kernels import CudaError

    return e.code if isinstance(e, CudaError) else None


def _torch_cuda_text(e: BaseException, table: dict) -> bool:
    """Does ``e`` carry torch's ``"CUDA error: <string>"`` for one of
    ``table``'s codes?"""
    msg = str(e).lower()
    return "cuda error:" in msg and any(s in msg for s in table.values())


def _never_classified(e: BaseException) -> bool:
    """Errors no policy may catch: a kernel build or loader failure, a
    program fault (retrying or degrading it would hide a kernel bug),
    and HBM exhaustion (not a property of the geometry)."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    ck = sys.modules.get("veles.simd_tpu_torch.ops.cuda_kernels")
    if ck is not None and isinstance(e, ck.KernelBuildError):
        return True
    code = _cuda_code(e)
    if code is not None:
        return code in _PROGRAM_FAULT_CODES
    return _torch_cuda_text(e, _PROGRAM_FAULT_CODES)


def is_mosaic_vmem_oom(e: BaseException) -> bool:
    """A launch the card refuses for its geometry — the JAX name of
    the rejection classifier, kept so the API matches.  On the port:
    a kernel wrapper's ``CudaError`` with code 1
    (``cudaErrorInvalidValue``, the dynamic shared-memory request past
    the limit), 9 (``cudaErrorInvalidConfiguration``) or 701
    (``cudaErrorLaunchOutOfResources``), classified by code; and the
    injected ``vmem_oom`` text (Mosaic's scoped-vmem message), so one
    plan string drives both packages.  Permanent for the geometry:
    the demote-and-remember policy, never retry."""
    if _never_classified(e):
        return False
    code = _cuda_code(e)
    if code is not None:
        return code in _REJECTION_CODES
    msg = str(e).lower()
    return "vmem" in msg and ("ran out of memory" in msg
                              or "scoped" in msg)


# device-lost / unreachable markers (lowercase substrings): the JAX
# package's, plus CUDA's device losses as torch reports them
_DEVICE_LOST_MARKERS = (
    "device unreachable", "device lost", "unavailable:",
    "socket closed", "connection reset", "failed to connect",
    "data_loss", "device or resource busy",
)

_TIMEOUT_MARKERS = (
    "deadline exceeded", "deadline_exceeded", "timed out", "timeout",
)


def is_device_lost(e: BaseException) -> bool:
    """A device loss: the call never computed, the device may come
    back — the retry-then-degrade policy.  The JAX markers, CUDA codes
    46/214/702 from a kernel wrapper and torch's ``"CUDA error: ..."``
    text for them; never a program fault."""
    if _never_classified(e):
        return False
    code = _cuda_code(e)
    if code is not None:
        return code in _DEVICE_LOST_CODES
    if _torch_cuda_text(e, _DEVICE_LOST_CODES):
        return True
    msg = str(e).lower()
    return any(m in msg for m in _DEVICE_LOST_MARKERS)


def is_timeout(e: BaseException) -> bool:
    """A deadline overrun (including :class:`FaultTimeout` from the
    watchdog): same retry-then-degrade policy as device loss."""
    if isinstance(e, FaultTimeout):
        return True
    if _never_classified(e) or _cuda_code(e) is not None:
        return False
    msg = str(e).lower()
    return any(m in msg for m in _TIMEOUT_MARKERS)


def is_transient(e: BaseException) -> bool:
    """Worth retrying?  Device losses and timeouts are; rejections
    (:func:`is_mosaic_vmem_oom`), admission overloads
    (:func:`is_overload`), program faults, build failures and ordinary
    bugs are not."""
    return is_device_lost(e) or is_timeout(e)


_OVERLOAD_MARKERS = (
    "resource_exhausted", "queue full",
)


def is_overload(e: BaseException) -> bool:
    """An admission-capacity rejection (an injected ``overload``
    fault).  Deliberately NOT transient: the caller gets a typed answer
    now instead of a queued timeout later."""
    msg = str(e).lower()
    return any(m in msg for m in _OVERLOAD_MARKERS)


def monotonic() -> float:
    """The engine's deadline clock (monotonic seconds)."""
    return time.monotonic()


def _fault_kind(e: BaseException) -> str:
    return "timeout" if is_timeout(e) else "device_lost"


# ---------------------------------------------------------------------------
# synthetic faults + the deterministic injection plan
# ---------------------------------------------------------------------------

class InjectedFault(RuntimeError):
    """A synthetic fault raised by :func:`inject`.  Its *message* is
    crafted to satisfy the same classifier as the real error it
    imitates, so injection exercises the production classification
    path, not a bypass."""


class FaultTimeout(RuntimeError):
    """Raised by :func:`guarded`'s watchdog when a dispatch overruns
    its deadline (classified transient by :func:`is_timeout`)."""


FAULT_KINDS = ("vmem_oom", "device_lost", "timeout", "overload")

# the JAX package's messages, word for word: one plan string gives the
# same classifications in both packages
_FAULT_MESSAGES = {
    "vmem_oom": ("Ran out of memory in memory space vmem while "
                 "allocating on stack: scoped allocation (injected "
                 "at %s)"),
    "device_lost": "UNAVAILABLE: device unreachable (injected at %s)",
    "timeout": ("DEADLINE_EXCEEDED: dispatch deadline overrun "
                "(injected at %s)"),
    "overload": ("RESOURCE_EXHAUSTED: admission queue full (injected "
                 "at %s)"),
}


def make_fault(kind: str, site: str = "synthetic") -> InjectedFault:
    """A synthetic fault instance of ``kind`` (for tests;
    :func:`inject` raises these per the active plan)."""
    if kind not in _FAULT_MESSAGES:
        raise ValueError(f"unknown fault kind {kind!r} "
                         f"(known: {sorted(_FAULT_MESSAGES)})")
    return InjectedFault(_FAULT_MESSAGES[kind] % site)


_plan_lock = threading.Lock()
_plan_override: str | None = None       # set_fault_plan() programmatic
_plan_src: str | None = None            # spec the cache was parsed from
_plan_cache: dict | None = None         # {site: [kind, remaining]}
_phase_list: list | None = None         # [(label, body|None), ...]
_phase_idx: int = 0


def _is_phased(spec: str) -> bool:
    """Phase-schedule syntax?  Plain plans are ``site:kind:count,...``
    and never contain ``;`` or ``=``; a phase schedule is
    ``label=entries;label=entries;...``."""
    return ";" in spec or "=" in spec


def parse_phase_plan(spec: str) -> list:
    """``label=entries;label=entries;...`` ->
    ``[(label, entries_or_None), ...]`` — the chaos-campaign phase
    schedule.  ``entries`` is an ordinary plan body (validated
    eagerly); an EMPTY body (``recovery=``) means *no injection*
    during that phase.  Labels are optional (``phaseN`` is minted);
    empty segments (a trailing ``;``) are skipped."""
    phases = []
    for i, part in enumerate(spec.split(";")):
        part = part.strip()
        if not part:
            continue
        head, sep, rest = part.partition("=")
        if sep:
            label, body = head.strip(), rest.strip()
        else:
            label, body = "", part
        if body:
            _parse_plan(body)       # validate eagerly
        phases.append((label or f"phase{i}", body or None))
    if not phases:
        raise ValueError(f"phase plan {spec!r} holds no phases")
    return phases


def _parse_plan(spec: str) -> dict:
    """``site:kind:count,...`` -> ``{site: [kind, remaining]}``.
    ``count`` defaults to 1; a malformed entry raises (a typo'd plan
    silently injecting nothing would defeat the harness)."""
    plan = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) == 2:
            site, kind, count = parts[0], parts[1], "1"
        elif len(parts) == 3:
            site, kind, count = parts
        else:
            raise ValueError(
                f"fault-plan entry {entry!r} is not site:kind[:count]")
        if kind not in _FAULT_MESSAGES:
            raise ValueError(
                f"fault-plan entry {entry!r}: unknown kind {kind!r} "
                f"(known: {sorted(_FAULT_MESSAGES)})")
        plan[site.strip()] = [kind.strip(), int(count)]
    return plan


def _active_plan() -> dict | None:
    """The live plan (reparsed only when the env var or override
    changed; None when no plan is set).  An env-supplied phase
    schedule activates its FIRST phase.  With no plan set and none
    parsed last, the answer is None without the lock: the steady
    state costs one env lookup."""
    global _plan_src, _plan_cache
    spec = _plan_override
    if spec is None:
        spec = getenv(FAULT_PLAN_ENV) or None
    if spec is None and _plan_src is None:
        return None
    with _plan_lock:
        if spec != _plan_src:
            _plan_src = spec
            body = spec
            if spec and _is_phased(spec):
                body = parse_phase_plan(spec)[0][1]
            _plan_cache = _parse_plan(body) if body else None
        return _plan_cache


def set_fault_plan(spec: str | None) -> None:
    """Programmatic plan override (None restores the env lookup).
    Validates eagerly so a bad spec fails at the set, not mid-run.
    A phase schedule (``label=entries;...``) activates its first
    phase and arms :func:`advance_phase`; any other set clears the
    schedule."""
    global _plan_override, _plan_src, _plan_cache
    global _phase_list, _phase_idx
    phases = None
    if spec is not None:
        if _is_phased(spec):
            phases = parse_phase_plan(spec)
        else:
            _parse_plan(spec)
    with _plan_lock:
        _phase_list = phases
        _phase_idx = 0
        if phases is not None:
            # "" (not None) when the phase body is empty: an explicit
            # no-injection phase must not fall through to the env plan
            _plan_override = phases[0][1] or ""
        else:
            _plan_override = spec
        _plan_src = None        # force reparse on next lookup
        _plan_cache = None
    if phases is not None:
        obs.record_decision("fault_phase", phases[0][0], index=0,
                            plan=phases[0][1] or "")


def advance_phase() -> str | None:
    """Step the active phase schedule to its next phase.  Returns the
    new phase's label, or None when the schedule is exhausted
    (injection cleared).  Each step records a ``fault_phase`` decision
    event.  Raises RuntimeError when no phase schedule is active."""
    global _plan_override, _plan_src, _plan_cache, _phase_idx
    with _plan_lock:
        phases = _phase_list
        if phases is None:
            raise RuntimeError(
                "no phase schedule active — set_fault_plan with "
                "'label=entries;label=entries;...' first")
        _phase_idx += 1
        idx = _phase_idx
        if idx < len(phases):
            label, body = phases[idx]
        else:
            label, body = None, None
        _plan_override = body or ""
        _plan_src = None
        _plan_cache = None
    obs.record_decision("fault_phase", label or "done", index=idx,
                        plan=body or "")
    return label


def current_phase() -> str | None:
    """The active phase's label (None when no schedule is active or
    the schedule is exhausted)."""
    with _plan_lock:
        if _phase_list is None or _phase_idx >= len(_phase_list):
            return None
        return _phase_list[_phase_idx][0]


@contextlib.contextmanager
def fault_plan(spec: str):
    """Scoped :func:`set_fault_plan` — the test-suite idiom.  Restores
    the previous plan AND phase schedule (if any) on exit."""
    global _plan_override, _plan_src, _plan_cache
    global _phase_list, _phase_idx
    with _plan_lock:
        prev_override = _plan_override
        prev_phases = _phase_list
        prev_idx = _phase_idx
    set_fault_plan(spec)
    try:
        yield
    finally:
        with _plan_lock:
            _plan_override = prev_override
            _phase_list = prev_phases
            _phase_idx = prev_idx
            _plan_src = None
            _plan_cache = None


def armed(site: str, kind: str | None = None) -> bool:
    """Does the active plan still hold injections for ``site``?  Route
    *gates* consult this so a planned site's route is actually
    selected on the CPU (where the card gates would refuse it) and the
    full demote/retry path runs — deterministic, no monkeypatching."""
    plan = _active_plan()
    if plan is None:
        return False
    with _plan_lock:
        entry = plan.get(site)
        return bool(entry and entry[1] > 0
                    and (kind is None or entry[0] == kind))


def inject(site: str) -> None:
    """Raise the planned synthetic fault for ``site``, if any remain
    (decrementing the plan's count); no-op otherwise.  Called at every
    policy site, so a plan drives the production paths themselves."""
    plan = _active_plan()
    if plan is None:
        return
    with _plan_lock:
        entry = plan.get(site)
        if not entry or entry[1] <= 0:
            return
        entry[1] -= 1
        kind = entry[0]
    obs.count("fault_injected", site=site, kind=kind)
    raise make_fault(kind, site)


def plan_snapshot() -> dict:
    """JSON-native view of the remaining plan (for bundles/tests)."""
    plan = _active_plan()
    if plan is None:
        return {}
    with _plan_lock:
        return {site: {"kind": kind, "remaining": n}
                for site, (kind, n) in sorted(plan.items())}


# ---------------------------------------------------------------------------
# fault history (what the flight recorder carries)
# ---------------------------------------------------------------------------

_history_lock = threading.Lock()
_FAULT_HISTORY: collections.deque = collections.deque(
    maxlen=FAULT_HISTORY_MAXLEN)


def _note_fault(site: str, kind: str, action: str, attempt: int,
                error: BaseException) -> dict:
    rec = {"site": site, "kind": kind, "action": action,
           "attempt": attempt, "error": str(error)[:300],
           "unix": time.time()}
    with _history_lock:
        _FAULT_HISTORY.append(rec)
    return rec


def fault_history() -> list:
    """Oldest-first copy of the retained fault records (embedded in
    every flight-recorder bundle)."""
    with _history_lock:
        return [dict(r) for r in _FAULT_HISTORY]


def reset_fault_history() -> None:
    """Clear the retained fault records AND the per-class circuit
    breakers — the one-call engine reset every fault-injection test
    fixture uses (a breaker opened by one scenario's exhaustions must
    not short-circuit the next scenario's dispatches)."""
    with _history_lock:
        _FAULT_HISTORY.clear()
    _breaker.reset()


def _arm_flightrec(site: str, exc: BaseException) -> str | None:
    """Write a flight-recorder bundle on retry exhaustion, when a
    flight dir is armed — through the recorder's shared
    ``MAX_AUTO_BUNDLES`` budget, so a service that permanently lost
    its device and keeps degrading per call cannot fill the disk with
    one bundle per dispatch.  Never raises — the policy's answer
    (degrade or re-raise) must win over recorder trouble."""
    try:
        from veles.simd_tpu_torch.obs import flightrec

        return flightrec.maybe_record(f"fault_exhausted:{site}", exc)
    except Exception:  # noqa: BLE001
        return None


# ---------------------------------------------------------------------------
# env knobs
# ---------------------------------------------------------------------------

def _env_number(name: str, default, cast):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = cast(raw)
    except ValueError:
        return default
    return value if value >= 0 else default


def fault_retries() -> int:
    """Transient-fault retries per dispatch
    (``$VELES_SIMD_FAULT_RETRIES``, default 2)."""
    return _env_number(FAULT_RETRIES_ENV, DEFAULT_RETRIES, int)


def fault_backoff() -> float:
    """Base backoff seconds (``$VELES_SIMD_FAULT_BACKOFF``, default
    0.05; 0 disables sleeping — the deterministic-test setting)."""
    return _env_number(FAULT_BACKOFF_ENV, DEFAULT_BACKOFF_S, float)


_deadline_memo: tuple = (None, 0.0)


def fault_deadline() -> float:
    """Watchdog deadline seconds for :func:`guarded` dispatches
    (``$VELES_SIMD_FAULT_DEADLINE``, default 0 = no watchdog), parsed
    once for each change of the variable: every guarded call reads
    it."""
    global _deadline_memo
    raw = getenv(FAULT_DEADLINE_ENV)
    if raw != _deadline_memo[0]:
        _deadline_memo = (raw, _env_number(FAULT_DEADLINE_ENV, 0.0,
                                           float))
    return _deadline_memo[1]


def backoff_delay(attempt: int, base: float | None = None) -> float:
    """Jittered exponential backoff: ``base * 2^attempt`` scaled by a
    uniform [0.5, 1.0) jitter so retry storms decorrelate."""
    if base is None:
        base = fault_backoff()
    if base <= 0:
        return 0.0
    return base * (2 ** attempt) * (0.5 + random.random() / 2)


# ---------------------------------------------------------------------------
# the demote-and-remember policy (permanent geometry rejections)
# ---------------------------------------------------------------------------

def register_rejection_cache(name: str, getter, capacity: int) -> None:
    """Put a rejection cache in ``obs.caches()`` under ``name``.

    ``getter`` is a zero-arg callable returning the cache *currently
    bound* in the owning module (tests substitute plain ``set``s
    through the module global, so the provider must re-read it per
    snapshot).  An :class:`~veles.simd_tpu_torch.obs.lru.LRUSet`
    reports its own hit/miss/eviction counters; a plain set reports
    size against the intended capacity."""
    def provider():
        cache = getter()
        if hasattr(cache, "info"):
            return cache.info()
        return {"size": len(cache), "capacity": capacity}
    obs.register_cache(name, provider)


def on_card(*operands) -> bool:
    """Does any operand already lie on a CUDA card?  For such a call
    the dispatch sites pass no oracle fallback and the kernel routes no
    demotion (the module docstring); host data (NumPy, lists, CPU
    tensors) gets both."""
    torch = sys.modules.get("torch")
    if torch is not None:
        for a in operands:
            if isinstance(a, torch.Tensor) and a.is_cuda:
                return True
    return False


def demote_and_remember(site: str, run, fallback=None, *, cache, key,
                        route: str, fallback_route: str, counter: str,
                        forced: bool = False, reason: str = "compile_oom",
                        classify=None):
    """THE demote-and-remember implementation (one home, three users).

    Runs ``run()`` (the doomed-candidate route) after giving the
    injection plan its shot at ``site``.  An exception ``classify``
    accepts — by default a launch the card refuses for its geometry
    (:func:`is_mosaic_vmem_oom`), which is permanent — adds ``key`` to
    ``cache`` (the bounded rejection set the route's *gate* consults,
    so the next call skips the route without re-raising), bumps
    ``counter`` (the family's demotion counter) plus the engine's
    ``fault_demotion`` counter, records a ``fault_policy`` decision
    event, and answers via ``fallback()``.  ``forced=True`` (a caller
    who pinned the route) still remembers but re-raises; any other
    exception propagates untouched.  ``fallback=None`` (operands
    already on the card, :func:`on_card`) demotes nothing: a refusal
    propagates untouched too and nothing is remembered.  ``reason``
    keeps the JAX package's ``compile_oom`` label so counters compare
    across the two packages.
    """
    if classify is None:
        classify = is_mosaic_vmem_oom
    try:
        if _active_plan() is not None:
            inject(site)
        return run()
    except Exception as e:
        if (fallback is None and not forced) or not classify(e):
            raise
        cache.add(key)
        kind = "vmem_oom" if classify is is_mosaic_vmem_oom \
            else _fault_kind(e)
        _note_fault(site, kind, "demote", 0, e)
        obs.count(counter, reason=reason)
        obs.count("fault_demotion", site=site)
        obs.record_decision(
            "fault_policy", "demote", site=site, route=route,
            fallback=fallback_route, reason=reason, key=repr(key),
            forced=bool(forced))
        if forced:
            raise
        return fallback()


# ---------------------------------------------------------------------------
# the guarded-dispatch policy (transient device faults)
# ---------------------------------------------------------------------------

def _cuda_context():
    """The caller's CUDA device and current stream, or None where no
    card is in use.  Torch keeps both per thread, so a watchdog worker
    must enter them to launch where its caller would have."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() \
            or not torch.cuda.is_initialized():
        return None
    device = torch.cuda.current_device()
    return device, torch.cuda.current_stream(device)


@contextlib.contextmanager
def _entered(ctx):
    """Enter a :func:`_cuda_context` (device, stream) in this thread;
    a no-op for None."""
    if ctx is None:
        yield
        return
    import torch

    device, stream = ctx
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def _call_with_deadline(thunk, deadline: float, site: str):
    """Run ``thunk`` under a watchdog: past ``deadline`` seconds the
    worker is abandoned (daemon thread — a wedged in-flight device
    call blocks in native code and cannot be cancelled) and a
    :class:`FaultTimeout` is raised for the retry policy to handle.
    The worker launches on the caller's CUDA device and current
    stream."""
    if not deadline or deadline <= 0:
        return thunk()
    box = {}
    done = threading.Event()
    ctx = _cuda_context()

    def work():
        try:
            with _entered(ctx):
                box["result"] = thunk()
        except BaseException as e:  # noqa: BLE001 — relayed below
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=work, daemon=True,
                         name=f"veles-fault-deadline-{site}")
    t.start()
    if not done.wait(deadline):
        raise FaultTimeout(
            f"DEADLINE_EXCEEDED: dispatch at {site} overran the "
            f"{deadline:.3f}s fault-policy watchdog")
    if "error" in box:
        raise box["error"]
    return box.get("result")


def guarded(site: str, thunk, *, fallback=None, retries: int | None = None,
            backoff: float | None = None, deadline: float | None = None,
            fallback_name: str = "oracle", budget_s: float | None = None,
            breaker=None, subsite: str | None = None, on_fault=None):
    """Dispatch ``thunk()`` under the transient-fault policy.

    Per attempt the injection plan fires first (:func:`inject` at
    ``site``, then at ``site@subsite`` when a ``subsite`` is given, so
    a chaos plan can poison one class of a shared site), then the call
    runs under the optional watchdog ``deadline``.  A transient fault
    (:func:`is_transient`) is retried up to ``retries`` times with
    jittered exponential ``backoff``; on exhaustion the flight
    recorder is armed with the fault history and the call degrades to
    ``fallback()`` (typically the op's NumPy oracle twin) or re-raises
    when no fallback exists.  Non-transient exceptions propagate
    immediately — and typed admission sheds (:func:`is_overload`)
    propagate before ANY accounting.

    ``budget_s`` clips the whole retry loop to the caller's remaining
    end-to-end budget: a retry whose backoff would overrun the budget
    is skipped and the call degrades immediately
    (``fault_budget_clipped`` counter, ``budget_clipped`` decision
    field).

    ``breaker`` is an optional
    :class:`veles.simd_tpu_torch.runtime.breaker.Breaker` the caller
    already admitted through: ``guarded`` records the outcome
    (success, or failure on retry exhaustion).

    ``on_fault`` is an optional per-caller fault observer, called
    best-effort (exceptions swallowed) as ``on_fault("retry", kind,
    attempt)`` per retry, ``on_fault("degrade", kind, attempt)`` when
    the call degrades, and ``on_fault("exhausted", kind, attempt)``
    when it re-raises.

    ``retries`` / ``backoff`` / ``deadline`` default to the env knobs
    (``VELES_SIMD_FAULT_RETRIES`` / ``_BACKOFF`` / ``_DEADLINE``);
    the first two are read at the first fault, so a healthy call reads
    only the deadline.
    """

    def _observe_fault(action: str, kind: str, attempt: int) -> None:
        if on_fault is None:
            return
        try:
            on_fault(action, kind, attempt)
        except Exception:  # noqa: BLE001 — observers never change policy
            pass
    if deadline is None:
        deadline = fault_deadline()
    t0 = monotonic() if budget_s is not None else 0.0
    attempt = 0
    while True:
        try:
            if _active_plan() is not None:
                inject(site)
                if subsite is not None:
                    inject(f"{site}@{subsite}")
            # the attempt's span ends before the policy sees a fault:
            # it never carries the exception, so even one opened outside
            # every dispatch span never trips the crash hook
            with obs.span("fault.attempt", site=site):
                try:
                    result, fault = (
                        _call_with_deadline(thunk, deadline, site)
                        if deadline > 0 else thunk()), None
                except Exception as e:  # noqa: BLE001 — raised below
                    fault = e
            if fault is not None:
                raise fault
        except Exception as e:
            if is_overload(e):
                # typed shed: a policy outcome, not a fault — no
                # retry, no breaker mark, no flight recorder
                raise
            if not is_transient(e):
                raise
            if retries is None:
                retries = fault_retries()
            if backoff is None:
                backoff = fault_backoff()
            kind = _fault_kind(e)
            obs.count("fault_transient", site=site, kind=kind)
            delay = backoff_delay(attempt, backoff)
            within_budget = (budget_s is None
                             or monotonic() - t0 + delay <= budget_s)
            if attempt < retries and within_budget:
                _note_fault(site, kind, "retry", attempt + 1, e)
                obs.count("fault_retry", site=site)
                obs.record_decision(
                    "fault_policy", "retry", site=site, kind=kind,
                    attempt=attempt + 1, retries=retries,
                    delay_s=delay)
                _observe_fault("retry", kind, attempt + 1)
                if delay > 0:
                    time.sleep(delay)
                attempt += 1
                continue
            clipped = attempt < retries and not within_budget
            if clipped:
                obs.count("fault_budget_clipped", site=site)
            _note_fault(site, kind, "exhausted", attempt, e)
            obs.count("fault_exhausted", site=site, kind=kind)
            if breaker is not None:
                breaker.failure()
            bundle = _arm_flightrec(site, e)
            obs.record_decision(
                "fault_policy",
                "degrade" if fallback is not None else "exhausted",
                site=site, kind=kind, attempt=attempt,
                retries=retries,
                flight_bundle=bundle, budget_clipped=clipped,
                fallback=fallback_name if fallback is not None
                else None)
            if fallback is None:
                _observe_fault("exhausted", kind, attempt)
                raise
            obs.count("fault_degraded", site=site, to=fallback_name)
            _observe_fault("degrade", kind, attempt)
            return fallback()
        else:
            if breaker is not None:
                breaker.success()
            return result


def breaker_guarded(site: str, key, thunk, *, fallback=None,
                    fallback_name: str = "oracle",
                    breaker_site: str | None = None, **kwargs):
    """:func:`guarded` behind the ``(site, key)`` circuit breaker —
    the standard composition for a dispatch site whose shape classes
    can fail independently.

    The class's breaker (minted at ``breaker_site`` or ``site``) is
    admitted first: **open** answers straight from ``fallback()``
    (``fault_breaker_short_circuit`` counter + ``short_circuit``
    decision — zero retry latency for a known-bad class), a half-open
    **probe** (and an open class with no fallback, e.g. a forced
    route) dispatches with a zero-retry budget, and **closed** runs
    the full policy.  Outcomes flow back into the breaker through
    :func:`guarded`'s ``breaker=`` wiring.  Remaining ``kwargs``
    (``budget_s``, ``subsite``, ``backoff``, ...) pass through."""
    br = _breaker.breaker_for(breaker_site or site, key)
    verdict = br.admit()
    if verdict == _breaker.OPEN:
        if fallback is not None:
            obs.count("fault_breaker_short_circuit", site=site)
            obs.record_decision(
                "fault_policy", "short_circuit", site=site,
                key=repr(key), fallback=fallback_name)
            on_fault = kwargs.get("on_fault")
            if on_fault is not None:
                try:    # observer only — never changes the answer
                    on_fault("degrade", "breaker_open", 0)
                except Exception:  # noqa: BLE001
                    pass
            return fallback()
        verdict = "probe"   # no fallback to shed to: zero-retry trial
    if verdict != _breaker.CLOSED:
        kwargs["retries"] = 0
    return guarded(site, thunk, fallback=fallback,
                   fallback_name=fallback_name, breaker=br, **kwargs)
