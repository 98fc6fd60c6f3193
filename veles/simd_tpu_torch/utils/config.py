"""Backend selection & typed configuration (the port's
``veles.simd_tpu.utils.config``).

Every public op takes the reference-compatible boolean ``simd=``
keyword: truthy runs the PyTorch path (``Backend.TORCH``), falsy the
NumPy oracle twin (``Backend.ORACLE``); ``None`` defers to the
thread-local default set with :func:`set_backend`.
:func:`resolve_simd` is the single gate every public op passes
through, and counts ``dispatch{op, backend}`` in
:mod:`veles.simd_tpu_torch.obs`.

:class:`Config` adds the ``device`` field the JAX package has no need
for: the port's entry points compute on ``"cuda"`` unless the caller
asks for ``"cpu"``.  The JAX config's ``interleaved_complex`` and
``dtype`` fields come with the slices that read them.
"""

from __future__ import annotations

import dataclasses
import enum
import threading

from veles.simd_tpu_torch import obs as _obs

__all__ = ["Backend", "get_backend", "set_backend", "resolve_simd",
           "Config", "get_config", "set_config"]


class Backend(enum.Enum):
    """Which implementation services an op call."""

    TORCH = "torch"    # PyTorch on the configured device (CUDA kernels)
    ORACLE = "oracle"  # NumPy reference twin (the reference's *_na path)


_state = threading.local()


def get_backend() -> Backend:
    """Current default backend (thread-local, default
    ``Backend.TORCH``)."""
    return getattr(_state, "backend", Backend.TORCH)


def set_backend(backend: Backend) -> Backend:
    """Set the thread-local default backend; returns the previous
    one."""
    prev = get_backend()
    _state.backend = Backend(backend)
    return prev


def resolve_simd(simd, op: str | None = None) -> bool:
    """Resolve the reference-style ``simd`` flag to "use the PyTorch
    path?".  ``None`` defers to the thread default; any other value is
    truthiness (the reference's ``int simd`` C flag).  With ``op``,
    the resolved backend is counted under ``dispatch{op=...,
    backend=torch|oracle}``."""
    use = get_backend() is Backend.TORCH if simd is None else bool(simd)
    if op is not None:
        _obs.count("dispatch", op=op,
                   backend="torch" if use else "oracle")
    return use


@dataclasses.dataclass(frozen=True)
class Config:
    """Typed run-time configuration."""

    # Interpret complex arrays as interleaved re/im float pairs (the
    # reference's FFTF layout); nothing reads it yet, as in the JAX
    # package.
    interleaved_complex: bool = True
    # Validate op arguments eagerly (the reference library's assert()
    # contract, src/matrix.c:257-261).
    check_arguments: bool = True
    # Default float dtype for compute; nothing reads it yet, as in the
    # JAX package.
    dtype: str = "float32"
    # Precision of the overlap-save block matmul.  Both values compute
    # in full fp32 in this port: TF32 is held off for the product, and
    # the kernels accumulate with fp32 FFMA.  "high" is accepted so
    # configurations carry over from the JAX package unchanged.
    conv_precision: str = "highest"
    # Where entry points compute: "cuda" (the default) or "cpu".
    # NumPy inputs go to this device; a torch tensor stays on its own.
    device: str = "cuda"

    def __post_init__(self):
        allowed = ("highest", "high")
        if self.conv_precision not in allowed:
            raise ValueError(
                f"conv_precision must be one of {allowed}, got "
                f"{self.conv_precision!r}")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(
                f"device must be 'cuda' or 'cpu', got {self.device!r}")


_config = Config()


def get_config() -> Config:
    return _config


def set_config(**updates) -> Config:
    global _config
    _config = dataclasses.replace(_config, **updates)
    return _config
