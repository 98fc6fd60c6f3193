"""veles.simd_tpu_torch.runtime — cross-op runtime policies of the port:
the static routing engine (:mod:`.routing`) and the matmul precision
layer (:mod:`.precision`: fp32, TF32, bf16, compensated bf16, int8).
Faults, breakers, the autotuner and the artifact store are not ported
yet."""

from veles.simd_tpu_torch.runtime import precision
from veles.simd_tpu_torch.runtime import routing

__all__ = ["precision", "routing"]
