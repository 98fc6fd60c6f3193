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
* :mod:`.spectral`     — STFT / ISTFT, spectrogram, Hilbert envelope,
  Morlet CWT, PSD estimation (welch, periodogram, csd, coherence,
  detrend), chirp-Z / zoom FFT and Lomb-Scargle
* :mod:`.iir`          — IIR design (Butterworth, Chebyshev I/II,
  Bessel, elliptic, notch/peak, order estimation, ba/zpk/sos) and the
  doubling-scan runtime (``sosfilt``, ``sosfiltfilt``, ``lfilter``,
  streaming)
* :mod:`.resample`     — polyphase rational resampling, ``upfirdn``,
  decimation, Fourier resampling and the streaming resample step
* :mod:`.batched`      — many short signals in one dispatch
  (``batched_resample_poly``, ``batched_sosfilt``, ``batched_lfilter``,
  ``batched_stft``), route handles in a bounded LRU
* :mod:`.segments`     — ragged segment packing: variable-length
  signals packed along the sample axis into shared rows
  (``packed_stft``, ``packed_convolve``), one guarded dispatch with a
  per-segment salvage
* :mod:`.waveforms`    — chirps, square/sawtooth waves, pulses,
  maximum-length sequences and analysis windows
* :mod:`.matrix`       — GEMM / gemv / add / sub with engine-selected
  precision routes (fp32, bf16_comp, int8, bf16)
* :mod:`.arithmetic`   — saturating conversions, float16 bits, real and
  interleaved-complex multiplies, sums
* :mod:`.mathfun`      — sin / cos / log / exp / pow / sqrt
* :mod:`.normalize`    — u8 plane normalization and min/max scans
* :mod:`.detect_peaks` — local extrema, scipy-style ``find_peaks`` with
  prominences and widths
* :mod:`.filters`      — median / rank, Savitzky-Golay, Wiener, and the
  host-side FIR designs (firwin, firwin2, remez, kaiserord)
* :mod:`.cuda_kernels` — the hand-written Hopper kernels, their
  wrappers, plain versions, gates and launch counters

Every public op takes the reference-compatible ``simd=`` flag: truthy
(the default) runs PyTorch on ``Config.device``; falsy runs the NumPy
oracle twin.  The routed dispatch sites run behind the fault policy of
:mod:`veles.simd_tpu_torch.runtime.faults`.
"""
