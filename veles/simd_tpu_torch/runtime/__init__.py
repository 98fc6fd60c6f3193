"""veles.simd_tpu_torch.runtime — cross-op runtime policies of the port:
the fault-policy engine (:mod:`.faults`: demote-and-remember for a
kernel route the card refuses for its geometry, bounded retry then
degradation to the NumPy oracle for device losses and timeouts, or to
the single-card twin for a sharded dispatch, and the deterministic
fault-injection harness), the per-``(site, shape-class)`` circuit
breakers (:mod:`.breaker`; ``parallel.dispatch`` keys them per
``(op, mesh class)``), the routing engine with its measured autotuner
and tune cache (:mod:`.routing`; mesh-stamped entries for the sharded
Fourier families), the matmul precision layer (:mod:`.precision`:
fp32, TF32, bf16, compensated bf16, int8) and the artifact store
(:mod:`.artifacts`: the nvcc-built kernel library shipped as a stamped
warm pack, placed under the build root before the first load so a
fresh process runs no nvcc)."""

from veles.simd_tpu_torch.runtime import artifacts
from veles.simd_tpu_torch.runtime import breaker
from veles.simd_tpu_torch.runtime import faults
from veles.simd_tpu_torch.runtime import precision
from veles.simd_tpu_torch.runtime import routing

__all__ = ["artifacts", "breaker", "faults", "precision", "routing"]
