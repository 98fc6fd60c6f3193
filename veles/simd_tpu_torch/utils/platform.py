"""Device resolution and card identity (the port's
``veles.simd_tpu.utils.platform``, reduced to what the port needs).

The device rule: entry points compute on ``Config.device`` (``"cuda"``
by default).  NumPy inputs go to that device; a torch tensor stays on
its own device.  When the configured device is CUDA and no card is
present, :func:`device` raises — the port never carries on silently on
the CPU.  The JAX version's CPU pinning and relay probing have no
counterpart here.
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np
import torch

from veles.simd_tpu_torch.utils.config import get_config

__all__ = ["device", "on_cuda", "as_tensor", "as_f32", "as_c64",
           "smi_line"]

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


def as_tensor(x) -> torch.Tensor:
    """``x`` as a tensor of its own dtype, 64-bit NumPy types narrowed
    to 32 bits as ``jnp.asarray`` narrows them: a tensor stays as it
    is, anything else goes to :func:`device`."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    arr = arr.astype(_X32.get(arr.dtype, arr.dtype), copy=False)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.as_tensor(arr, device=device())


def as_f32(x) -> torch.Tensor:
    """``x`` as a float32 tensor: a tensor keeps its device, anything
    else goes to :func:`device`.  The cast is explicit because
    ``torch.as_tensor`` keeps float64, where JAX (x64 off) computes in
    float32."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    arr = np.asarray(x, np.float32)
    if not arr.flags.writeable:     # torch cannot share read-only memory
        arr = arr.copy()
    return torch.as_tensor(arr, device=device())


def as_c64(x) -> torch.Tensor:
    """``x`` as a complex64 tensor, real input included: a tensor keeps
    its device, anything else goes to :func:`device` (the port's
    counterpart of the JAX package's ``to_device(x, complex64)``; the
    card takes complex buffers directly)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.complex64)
    arr = np.asarray(x, np.complex64)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.as_tensor(arr, device=device())


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
