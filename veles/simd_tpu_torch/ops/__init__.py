"""The port's op library (counterpart of ``veles.simd_tpu.ops``).

* :mod:`.convolve`     — 1D convolution (brute / FFT / overlap-save,
  auto-select)
* :mod:`.correlate`    — 1D cross-correlation (reversed-h reuse of
  convolve)
* :mod:`.convolve2d`   — 2D convolution and cross-correlation (direct
  kernel / FFT, auto-select)
* :mod:`.wavelet`      — DWT, SWT, cascades, synthesis, packets and the
  separable 2D transforms
* :mod:`.wavelet_coeffs` — the wavelet filter tables
* :mod:`.cuda_kernels` — the hand-written Hopper kernels, their
  wrappers, plain versions, gates and launch counters

Every public op takes the reference-compatible ``simd=`` flag: truthy
(the default) runs PyTorch on ``Config.device``; falsy runs the NumPy
oracle twin.
"""
