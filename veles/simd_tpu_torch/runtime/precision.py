"""Matmul precision layer, fp32 part (the port's
``veles.simd_tpu.runtime.precision``).

``"highest"`` and ``"high"`` both compute a full float32 product in
this port: :func:`fp32_matmul` holds TF32 off for the call
(``torch.set_float32_matmul_precision("highest")``, saved and restored
around it, so neither the caller's setting is trusted nor is it
changed).  The JAX package's ``"high"`` is a 3-pass bf16 product on the
TPU; here it is the same fp32 product as ``"highest"``.

Not ported yet: the compensated ``bf16_comp`` and quantized ``int8``
routes.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["PRECISIONS", "fp32_matmul", "fp32_conv", "p_einsum",
           "p_matmul"]

PRECISIONS = ("highest", "high")


def _check(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {sorted(PRECISIONS)}, got "
            f"{precision!r}")
    return precision


@contextlib.contextmanager
def fp32_matmul():
    """Scope in which float32 matmuls run in full fp32 (no TF32)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def fp32_conv(device):
    """Scope in which a float32 convolution on ``device`` runs in full
    fp32: on CUDA, cuDNN enabled with TF32 off (the installed torch
    defaults cuDNN convolutions to TF32); elsewhere nothing to pin."""
    if torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def p_einsum(spec: str, a, b, precision: str = "highest"):
    """Two-operand einsum at a named precision (fp32 output)."""
    _check(precision)
    with fp32_matmul():
        return torch.einsum(spec, a, b)


def p_matmul(a, b, precision: str = "highest"):
    """``torch.matmul`` at a named precision."""
    _check(precision)
    with fp32_matmul():
        return torch.matmul(a, b)
