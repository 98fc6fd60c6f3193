"""Device resolution, card identity and device reachability (the
port's ``veles.simd_tpu.utils.platform``).

The device rule: entry points compute on ``Config.device`` (``"cuda"``
by default).  NumPy inputs go to that device; a torch tensor stays on
its own device.  When the configured device is CUDA and no card is
present, :func:`device` raises — the port never carries on silently on
the CPU.

The reachability half guards entry points against a card that hangs or
is missing: :func:`probe_device_count` counts ``torch.cuda.
device_count()`` in a killable subprocess with a hard timeout (a crash
or a timeout counts as 0), :func:`require_reachable_device` exits with
code 2 when no card answers (re-probing for
``$VELES_SIMD_DEVICE_WAIT`` seconds), :func:`init_deadline` hard-exits
a process whose first device touch outlives its deadline
(``$VELES_SIMD_INIT_DEADLINE``), and every probe is kept in
:func:`probe_history` for the flight recorder.  :func:`to_host` and
:func:`to_device` are the thin tensor/NumPy moves on the configured
device.  The JAX package's CPU pinning (``pin_cpu``, ``set_cpu_env``,
``cpu_devices``, ``maybe_override_platform`` and the backend snapshot
helpers) exists for JAX's platform plugins only and has no counterpart
here.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from veles.simd_tpu_torch.utils.config import get_config

__all__ = ["probe_device_count", "require_reachable_device",
           "init_deadline", "to_host", "to_device", "probe_history",
           "reset_probe_history",
           "device", "on_cuda", "as_tensor", "as_f32", "as_c64",
           "lead_rows", "smi_line", "device_line"]

# Device-reachability probe records (require_reachable_device's retry
# loop), retained for the flight recorder regardless of telemetry.
_PROBE_HISTORY_MAXLEN = 64
_PROBE_HISTORY: list = []


def probe_history() -> list:
    """Oldest-first copy of the retained device-probe records."""
    return [dict(r) for r in _PROBE_HISTORY]


def reset_probe_history() -> None:
    del _PROBE_HISTORY[:]


def _note_probe(attempt: int, count: int, detail: str,
                waited_s: float) -> None:
    """Record one reachability probe (history + obs, never raises)."""
    rec = {"attempt": int(attempt), "ok": count >= 1,
           "devices": int(count), "detail": str(detail)[:300],
           "waited_s": round(float(waited_s), 3),
           "unix": time.time()}
    _PROBE_HISTORY.append(rec)
    del _PROBE_HISTORY[:-_PROBE_HISTORY_MAXLEN]
    try:
        from veles.simd_tpu_torch import obs

        outcome = "ok" if rec["ok"] else "unreachable"
        obs.count("device_probe", outcome=outcome)
        obs.record_decision("device_probe", outcome,
                            attempt=rec["attempt"],
                            devices=rec["devices"],
                            detail=rec["detail"] or None,
                            waited_s=rec["waited_s"])
    except Exception:  # noqa: BLE001 — telemetry must not break probing
        pass


def to_host(x) -> np.ndarray:
    """``x`` as a NumPy array: a tensor (complex ones included) is
    detached and copied off its device, anything else goes through
    ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_device(x, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on the configured device (:func:`device`), of
    ``dtype`` (a NumPy or torch dtype) if given: the upload twin of
    :func:`to_host`.  A tensor without ``dtype`` stays as it is."""
    if isinstance(x, torch.Tensor):
        if dtype is None:
            return x
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        return x.to(device=device(), dtype=dtype)
    arr = np.asarray(x) if dtype is None else np.asarray(x, dtype)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr).copy()
    return torch.as_tensor(arr, device=device())


def _probe_subprocess(timeout: float) -> tuple[int, str]:
    """(device count, failure detail) from a killable probe subprocess
    that counts ``torch.cuda.device_count()``."""
    code = "import torch\nprint(torch.cuda.device_count())"

    def _tail(*chunks) -> str:
        for c in chunks:
            if isinstance(c, bytes):
                c = c.decode(errors="replace")
            if c and c.strip():
                return c.strip()[-500:]
        return ""

    proc = None
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              timeout=timeout)
        return int(proc.stdout.strip().splitlines()[-1]), ""
    except subprocess.TimeoutExpired as e:
        detail = _tail(e.stderr, e.stdout)
        return 0, (f"device probe timed out after {timeout:.0f}s"
                   + (f"; child output: {detail}" if detail else ""))
    except Exception:  # noqa: BLE001 — a crash counts as no card
        tail = _tail(proc.stderr, proc.stdout) if proc is not None else ""
        return 0, f"device probe failed: {tail or 'no output'}"


def probe_device_count(timeout: float = 90.0) -> int:
    """Count the CUDA cards in a subprocess (``torch.cuda.
    device_count()``).  A driver that hangs in its init would hang an
    in-process probe with no recourse; a subprocess is killable, and on
    a timeout or a crash the count is 0."""
    return _probe_subprocess(timeout)[0]


def require_reachable_device(timeout: float = 120.0,
                             wait: float | None = None) -> None:
    """Fail fast (``SystemExit(2)``) when no card answers a probe.

    ``wait`` seconds keeps re-probing until a card appears or the
    budget runs out; ``$VELES_SIMD_DEVICE_WAIT`` overrides the caller's
    ``wait`` (a malformed value warns and keeps it).  Every attempt is
    recorded (:func:`probe_history`, the ``device_probe`` counter and
    decision event)."""
    env = os.environ.get("VELES_SIMD_DEVICE_WAIT", "").strip()
    if env:
        try:
            wait = float(env)
        except ValueError:
            print(f"ignoring malformed VELES_SIMD_DEVICE_WAIT={env!r} "
                  "(want seconds)", file=sys.stderr)
    if wait is None:
        wait = 0.0
    t0 = time.monotonic()
    deadline = t0 + max(wait, 0.0)
    attempt = 0
    while True:
        attempt += 1
        # the first probe always gets the full timeout (the wait=0
        # fail-fast contract); retries are clamped to the remaining
        # window so the budget is never overshot by more than a floor
        remaining = deadline - time.monotonic()
        probe_timeout = timeout if attempt == 1 \
            else min(timeout, max(remaining, 15.0))
        count, detail = _probe_subprocess(probe_timeout)
        _note_probe(attempt, count, detail, time.monotonic() - t0)
        if count >= 1:
            return
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            print(f"no CUDA card reachable: {detail or 'count 0'}",
                  file=sys.stderr)
            raise SystemExit(2)
        hint = (" (VELES_SIMD_DEVICE_WAIT=0 restores fail-fast)"
                if attempt == 1 and not env else "")
        print(f"no CUDA card reachable (attempt {attempt}: "
              f"{detail or 'count 0'}); retrying for another "
              f"{remaining:.0f}s{hint}", file=sys.stderr)
        time.sleep(min(30.0, remaining))


PLATFORM_ENV = "VELES_SIMD_PLATFORM"


def requested_device() -> str:
    """The device a process's caller asked for: ``"cpu"`` when
    ``$VELES_SIMD_PLATFORM`` is ``cpu``, else ``"cuda"``."""
    if os.environ.get(PLATFORM_ENV, "").strip().lower() == "cpu":
        return "cpu"
    return "cuda"


def select_device(wait: float | None = None) -> str:
    """Set ``Config.device`` to :func:`requested_device` for an entry
    point (a tool, ``bench_torch.py``) and return it; for the card,
    :func:`require_reachable_device` exits with code 2 when none
    answers (``wait`` as there)."""
    from veles.simd_tpu_torch.utils.config import set_config

    device = requested_device()
    set_config(device=device)
    if device == "cuda":
        require_reachable_device(wait=wait)
    return device


@contextlib.contextmanager
def init_deadline(seconds: float | None = None,
                  what: str = "CUDA init"):
    """Hard-exit (``os._exit(2)``) with a diagnosis if the guarded block
    outlives ``seconds``.

    A driver init that hangs blocks inside native code, where no Python
    exception or signal handler reaches it; a watchdog thread that
    exits the whole process is the only recourse.  Wrap the *first
    device touch* (e.g. ``torch.cuda.get_device_name(0)``), not
    long-running work.  ``$VELES_SIMD_INIT_DEADLINE`` overrides
    ``seconds``; 0 disables; the default is 180 s."""
    env = os.environ.get("VELES_SIMD_INIT_DEADLINE", "").strip()
    if env:
        try:
            seconds = float(env)
        except ValueError:
            print(f"ignoring malformed VELES_SIMD_INIT_DEADLINE={env!r}"
                  " (want seconds)", file=sys.stderr)
    if seconds is None:
        seconds = 180.0
    if seconds <= 0:
        yield
        return
    done = threading.Event()

    def _watch():
        if not done.wait(seconds):
            print(f"{what} did not complete within {seconds:.0f}s — the "
                  "card or its driver is presumed wedged in native "
                  "code.  VELES_SIMD_INIT_DEADLINE=0 disables this "
                  "guard.", file=sys.stderr)
            sys.stderr.flush()
            os._exit(2)

    t = threading.Thread(target=_watch, daemon=True,
                         name="veles-init-deadline")
    t.start()
    try:
        yield
    finally:
        done.set()

# JAX (x64 off) computes 64-bit NumPy input in its 32-bit twin
_X32 = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
        np.dtype(np.uint64): np.uint32,
        np.dtype(np.complex128): np.complex64}


def device() -> torch.device:
    """The configured compute device; raises when it is CUDA and no
    card is present."""
    name = get_config().device
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "veles.simd_tpu_torch: Config.device is 'cuda' but "
            "torch.cuda.is_available() is False; call "
            "set_config(device='cpu') to compute on the CPU")
    return torch.device(name)


def on_cuda() -> bool:
    """Is the configured device a CUDA card that is present?"""
    return get_config().device == "cuda" and torch.cuda.is_available()


def _sharable(arr: np.ndarray) -> np.ndarray:
    """``arr``, or a copy of it where torch cannot share its memory: a
    read-only array, or a view with a negative stride (``x[::-1]``,
    which NumPy callers of the JAX package pass)."""
    if not arr.flags.writeable or any(st < 0 for st in arr.strides):
        return arr.copy()
    return arr


def as_tensor(x) -> torch.Tensor:
    """``x`` as a tensor of its own dtype, 64-bit NumPy types narrowed
    to 32 bits as ``jnp.asarray`` narrows them: a tensor stays as it
    is, anything else goes to :func:`device`."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    arr = arr.astype(_X32.get(arr.dtype, arr.dtype), copy=False)
    return torch.as_tensor(_sharable(arr), device=device())


def as_f32(x) -> torch.Tensor:
    """``x`` as a float32 tensor: a tensor keeps its device, anything
    else goes to :func:`device`.  The cast is explicit because
    ``torch.as_tensor`` keeps float64, where JAX (x64 off) computes in
    float32."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    arr = np.asarray(x, np.float32)
    return torch.as_tensor(_sharable(arr), device=device())


def as_c64(x) -> torch.Tensor:
    """``x`` as a complex64 tensor, real input included: a tensor keeps
    its device, anything else goes to :func:`device` (the port's
    counterpart of the JAX package's ``to_device(x, complex64)``; the
    card takes complex buffers directly)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.complex64)
    arr = np.asarray(x, np.complex64)
    return torch.as_tensor(_sharable(arr), device=device())


def lead_rows(shape, core_dims: int = 1) -> int:
    """The row count of an operand of ``shape``: the product of its
    dims before the last ``core_dims`` (1 for a single row).  The
    routes' gates, tune classes and work counts all read it.
    ``math.prod``, not ``np.prod``: that builds an array of a
    ``torch.Size`` first, which was most of a route gate's host
    time."""
    return int(math.prod(shape[:-core_dims]))


def smi_line() -> str:
    """The first line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``, or ``"not measured"`` without nvidia-smi."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "not measured"
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def device_line() -> str:
    """What an entry point computes on, for its ``device:`` line: the
    card's name and power limit (:func:`smi_line`, else
    ``torch.cuda.get_device_name``) when the configured device is a
    card, else ``"cpu"``."""
    if not on_cuda():
        return "cpu"
    smi = smi_line()
    return smi if smi != "not measured" else torch.cuda.get_device_name(0)
