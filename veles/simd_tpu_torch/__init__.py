"""veles.simd_tpu_torch — the PyTorch/CUDA port of ``veles.simd_tpu``.

The JAX package stays the reference; this package computes the same
functions with PyTorch on an NVIDIA H100, module for module at the same
relative paths.  Every Pallas kernel of the JAX package on a ported
path is a CUDA C++ kernel written for Hopper (``csrc/``), built with
``nvcc`` at first use and loaded with ``ctypes``
(:mod:`veles.simd_tpu_torch.ops.cuda_kernels`).

Ported so far: 1D and 2D convolution and cross-correlation, the
wavelet and spectral families, waveforms, and the reference-header
surface (matrix, arithmetic, mathfun, normalize, detect_peaks) with
the filters, the IIR and resampling families and the ragged segment
packing (:mod:`veles.simd_tpu_torch.ops`), over the routing,
precision, fault-policy, circuit-breaker, config and telemetry core
they need; the pipeline compiler, the serving loop and its fleet; and
the sharded families on a mesh of devices
(:mod:`veles.simd_tpu_torch.parallel`).

Entry points compute on ``Config.device`` (``"cuda"`` by default;
``utils.config.set_config(device="cpu")`` for the CPU).  The package
imports ``torch`` and never JAX.
"""

from veles.simd_tpu_torch.utils.config import (
    Backend, get_backend, set_backend)

__version__ = "0.1.0"

__all__ = ["Backend", "get_backend", "set_backend", "__version__"]
