"""Platform layer of the port: configuration, device resolution,
buffer helpers and device timing (counterpart of
``veles.simd_tpu.utils``)."""

from veles.simd_tpu_torch.utils.config import (
    Backend, get_backend, set_backend)
from veles.simd_tpu_torch.utils.memory import (
    next_highest_power_of_2, zeropadding, zeropadding_ex, rmemcpyf,
    crmemcpyf, align_complement, malloc_aligned, mallocf)

__all__ = [
    "Backend",
    "get_backend",
    "set_backend",
    "next_highest_power_of_2",
    "zeropadding",
    "zeropadding_ex",
    "rmemcpyf",
    "crmemcpyf",
    "align_complement",
    "malloc_aligned",
    "mallocf",
]
