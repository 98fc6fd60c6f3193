"""Sharded ops over a mesh of devices (the port's
``veles.simd_tpu.parallel``).

The JAX package expresses the reference's decompositions as
``shard_map`` programs over a ``jax.sharding.Mesh``.  The port keeps
every function, its signature, its errors and its results, over an
in-process mesh (:mod:`.mesh`): an array of ``torch.device`` shards,
where a device may repeat, so eight shards run on one card (or on the
CPU in the tests) as the JAX tests' eight virtual devices run on one
host.  The shard runner (``_spmd``) runs a body once per shard, each in
its own thread, and the collectives (``ppermute``, ``psum``,
``all_gather``, ``all_to_all``) are explicit copies between shards;
axes that span processes go through ``torch.distributed``
(:mod:`.distributed`).

* :func:`make_mesh` / :func:`default_mesh` — mesh construction helpers.
* :func:`sharded_convolve` — sequence-parallel long-signal convolution
  after a one-hop **halo exchange** of the h−1 samples each shard
  needs from its left neighbour; :func:`sharded_convolve_ring` for
  filters longer than a shard block (x blocks stream around the ring);
  :func:`sharded_convolve_batch` — dp×sp over a 2D mesh;
  :func:`sharded_convolve2d` / :func:`sharded_convolve2d_ring` — 2D
  tiles with a two-phase halo, or the per-axis ring.
* :func:`sharded_swt` / :func:`sharded_swt_reconstruct`,
  :func:`sharded_wavelet_apply` / :func:`sharded_wavelet_transform` /
  :func:`sharded_wavelet_reconstruct` /
  :func:`sharded_wavelet_inverse_transform` — wavelet cascades with
  ring halos (periodic extension = the last→first hop).
* :func:`sharded_wavelet_apply2d` / :func:`sharded_wavelet_reconstruct2d`,
  :func:`sharded_swt_apply2d`, :func:`sharded_wavelet_packet_transform2d`
  — the **all-to-all** pattern: rows transform locally, an
  ``all_to_all`` re-shards to columns, columns transform locally; the
  row and column passes run the single-card ``wavelet_apply``, so on
  the card they reach the filter-bank kernel (K2).
* :func:`sharded_stft` / :func:`sharded_istft` / :func:`sharded_welch`
  — time-frequency analysis with frame ownership following sample
  ownership; :func:`sharded_sosfilt` — a two-level IIR scan;
  :func:`sharded_resample_poly`, :func:`sharded_medfilt` /
  :func:`sharded_order_filter` / :func:`sharded_savgol_filter`,
  :func:`sharded_lombscargle`, :func:`sharded_normalize2d`.
* :func:`sharded_dft` / :func:`sharded_rfft` / :func:`sharded_irfft` —
  the Cooley-Tukey ``N = N1*N2`` factorization as per-factor DFT-basis
  matmuls with ``all_to_all`` transposes (:mod:`.fourier`), routed
  against one ``torch.fft`` call.
* :func:`sharded_matmul` — tensor-parallel GEMM (contracting dim
  sharded, ``psum``); :func:`data_parallel` — batch sharding for any
  batched op.
* :mod:`.distributed` — multi-process bootstrap on ``torch.distributed``
  and hybrid meshes (process-spanning axes outermost).

Every instrumented sharded dispatch runs under the mesh-loss guard
(``ops._sharded_guard``): a per-``(op, mesh-class)`` breaker and a
degrade path to the single-card twin, counted as ``mesh_degrade``.
"""

from veles.simd_tpu_torch.parallel import distributed
from veles.simd_tpu_torch.parallel.fourier import (
    sharded_dft, sharded_irfft, sharded_rfft)
from veles.simd_tpu_torch.parallel.mesh import default_mesh, make_mesh
from veles.simd_tpu_torch.parallel.ops import (
    data_parallel, halo_exchange_left, halo_exchange_right,
    sharded_convolve, sharded_convolve2d, sharded_convolve2d_ring,
    sharded_convolve_batch, sharded_convolve_ring, sharded_istft,
    sharded_lombscargle, sharded_matmul, sharded_medfilt,
    sharded_normalize2d,
    sharded_order_filter, sharded_resample_poly, sharded_savgol_filter,
    sharded_sosfilt, sharded_stft, sharded_welch,
    sharded_swt, sharded_swt_apply2d, sharded_swt_reconstruct,
    sharded_wavelet_apply,
    sharded_wavelet_apply2d, sharded_wavelet_inverse_transform,
    sharded_wavelet_packet_transform2d,
    sharded_wavelet_reconstruct, sharded_wavelet_reconstruct2d,
    sharded_wavelet_transform)

__all__ = ["make_mesh", "default_mesh", "sharded_convolve",
           "sharded_convolve_ring",
           "sharded_convolve_batch", "sharded_convolve2d",
           "sharded_convolve2d_ring",
           "sharded_swt", "sharded_swt_reconstruct",
           "sharded_wavelet_apply", "sharded_wavelet_transform",
           "sharded_wavelet_inverse_transform",
           "sharded_wavelet_reconstruct",
           "sharded_wavelet_apply2d",
           "sharded_wavelet_reconstruct2d",
           "sharded_swt_apply2d", "sharded_wavelet_packet_transform2d",
           "sharded_order_filter", "sharded_medfilt",
           "sharded_savgol_filter", "sharded_lombscargle",
           "sharded_matmul",
           "sharded_stft", "sharded_istft", "sharded_sosfilt",
           "sharded_welch", "sharded_resample_poly",
           "sharded_normalize2d",
           "sharded_dft", "sharded_rfft", "sharded_irfft",
           "data_parallel", "halo_exchange_left", "halo_exchange_right",
           "distributed"]
