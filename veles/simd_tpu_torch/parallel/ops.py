"""Sharded ops: sequence-parallel convolution, TP GEMM, DP batching
(the port's ``veles.simd_tpu.parallel.ops``).

The distributed re-expression of the reference's hot paths: overlap-save
block filtering becomes a shard body over a sequence axis with a
``ppermute`` halo exchange; the GEMM column loop becomes a
contracting-dim-sharded matmul + ``psum``.  Every body runs once per
shard under the shard runner (:mod:`veles.simd_tpu_torch.parallel.
_spmd`, the port's ``shard_map``), and each local step calls the
port's single-card op helper that the JAX body calls, so on the card a
shard reaches the same routes (the 2D wavelet rows reach the
filter-bank kernel, K2) the single-card op does.  Every matmul runs in
full fp32 (``runtime.precision``'s ``p_einsum``/``p_matmul``) and every
convolution through ``p_conv`` (cuDNN with TF32 off).

Operands are global: host NumPy or a tensor on the mesh's kind of
device (a CUDA operand on a CPU mesh, or the reverse, raises).  Results
are global tensors on the mesh's first device.

**Mesh-loss degradation**: every instrumented sharded dispatch runs
through :func:`_sharded_guard` — the transient-fault policy
(:func:`veles.simd_tpu_torch.runtime.faults.guarded`) with a degrade
path to the op's single-card ``ops/`` twin on device loss (recorded as
a ``mesh_degrade`` decision event with the mesh geometry), gated by a
per-``(op, mesh-class)`` circuit breaker
(:mod:`veles.simd_tpu_torch.runtime.breaker`) so a dead mesh answers
via the twin immediately, with call-counted half-open probes that
re-enable sharded dispatch when the mesh comes back.  The degrade path
runs nowhere else.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.parallel import _spmd
from veles.simd_tpu_torch.parallel._spmd import P
from veles.simd_tpu_torch.runtime import faults, routing
from veles.simd_tpu_torch.runtime import precision as prx
from veles.simd_tpu_torch.utils.memory import next_highest_power_of_2

__all__ = ["sharded_convolve", "sharded_convolve_ring",
           "sharded_convolve_batch",
           "sharded_convolve2d", "sharded_convolve2d_ring",
           "sharded_matmul",
           "sharded_swt", "sharded_swt_reconstruct",
           "sharded_wavelet_apply", "sharded_wavelet_transform",
           "sharded_wavelet_inverse_transform",
           "sharded_wavelet_reconstruct",
           "sharded_wavelet_apply2d",
           "sharded_wavelet_reconstruct2d",
           "sharded_swt_apply2d",
           "sharded_wavelet_packet_transform2d",
           "sharded_order_filter", "sharded_medfilt",
           "sharded_savgol_filter", "sharded_lombscargle",
           "sharded_stft", "sharded_istft", "sharded_sosfilt",
           "sharded_welch", "sharded_resample_poly", "data_parallel",
           "halo_exchange_left", "halo_exchange_right"]


_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.complex128: torch.complex64}
_NP_NARROW = {np.dtype(np.float64): np.float32,
              np.dtype(np.int64): np.int32,
              np.dtype(np.uint64): np.uint32,
              np.dtype(np.complex128): np.complex64}


def _place(x, mesh, dtype=torch.float32):
    """The global operand as a tensor on the mesh's first device, of
    ``dtype`` (None: its own, 64-bit types narrowed to 32 bits as
    ``jnp.asarray`` narrows them).  A tensor on another kind of device
    than the mesh's raises: nothing moves between the CPU and a card
    behind the caller's back."""
    dev = mesh.first_device(_spmd._rank(mesh))
    if isinstance(x, torch.Tensor):
        if x.device.type != dev.type:
            raise ValueError(f"operand on {x.device} for a mesh of "
                             f"{dev.type} devices")
        if dtype is None:
            dtype = _NARROW.get(x.dtype, x.dtype)
        return x.to(device=dev, dtype=dtype)
    arr = np.asarray(x)
    if dtype is None:
        arr = arr.astype(_NP_NARROW.get(arr.dtype, arr.dtype), copy=False)
    else:
        arr = arr.astype(torch.empty(0, dtype=dtype).numpy().dtype,
                         copy=False)
    # a copy: torch cannot share read-only or foreign memory
    return torch.as_tensor(np.array(arr), device=dev)


def _const(a, like):
    """A host constant as a float32 tensor on ``like``'s device."""
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device)


def _instrumented(op: str, run_fn):
    """Route one shard_map program through the instrumented call
    (:func:`veles.simd_tpu_torch.obs.instrumented_jit`) so sharded
    programs land in the resource axis under ``("shard_map", op)``,
    like every single-card call site; with telemetry off it costs one
    flag check per call."""
    return obs.instrumented_jit(run_fn, op=op, route="shard_map")


def _sharded_guard(op: str, thunk, fallback, mesh, axis: str):
    """One sharded dispatch under the mesh-loss policy.

    ``thunk`` runs the instrumented shard_map program (including any
    output slicing); ``fallback`` computes the SAME answer on the
    single-card ``ops/`` twin.  The dispatch is breaker-gated per
    ``(op, mesh-class)``: transient mesh faults ride the bounded
    retry of :func:`veles.simd_tpu_torch.runtime.faults.guarded` and
    degrade to the twin (a ``mesh_degrade`` decision event carrying
    the mesh geometry); once the class's breaker opens, calls go
    straight to the twin, and every ``probe_every``-th call probes the
    mesh with a zero-retry budget, re-enabling sharded dispatch on the
    first success."""
    site = f"parallel.{op}"
    geom = routing.mesh_class(mesh, axis)

    def degrade():
        obs.count("mesh_degrade", op=op)
        obs.record_decision("mesh_degrade", op, site=site, mesh=geom,
                            fallback="single_chip")
        return fallback()

    return faults.breaker_guarded(
        site, (op, geom), thunk, fallback=degrade,
        fallback_name="single_chip", breaker_site="parallel.dispatch")


def halo_exchange_left(x_local, halo_len: int, axis_name: str,
                       periodic: bool = False):
    """Bring the last ``halo_len`` samples of the left neighbour's shard.

    By default the first shard receives zeros (``ppermute`` drops absent
    sources) — exactly the zero history the overlap-save formulation
    wants.  With ``periodic=True`` the first shard receives the LAST
    shard's tail (a ring) — the synthesis-side mirror of
    ``halo_exchange_right(..., periodic=True)``.  Called inside a
    shard body.
    """
    n_shards = _spmd.axis_size(axis_name)
    block = x_local.shape[-1]
    tail = x_local[..., block - halo_len:]  # empty when halo_len == 0
    perm = [(i, i + 1) for i in range(n_shards - 1)]
    if periodic:
        perm.append((n_shards - 1, 0))
    return _spmd.ppermute(tail, axis_name, perm)


def halo_exchange_right(x_local, halo_len: int, axis_name: str,
                        periodic: bool = False):
    """Bring the first ``halo_len`` samples of the right neighbour's shard.

    With ``periodic=True`` the last shard receives the first shard's head
    (a ring) — the sharded form of the reference's PERIODIC boundary
    extension; otherwise the last shard receives zeros.  Called inside
    a shard body.
    """
    n_shards = _spmd.axis_size(axis_name)
    head = x_local[..., :halo_len]
    perm = [(i, i - 1) for i in range(1, n_shards)]
    if periodic:
        perm.append((0, n_shards - 1))
    return _spmd.ppermute(head, axis_name, perm)


def _local_block_conv(x_ext, h):
    """The local overlap-save block step: FULL convolution of the
    halo-extended block, sliced to the block's span of the global result.

    The single-card overlap-save helpers the JAX body calls — the fp32
    block-matmul form for short/medium filters, batched-frames FFT for
    long ones."""
    from veles.simd_tpu_torch.ops import convolve as cv

    k = h.shape[-1]
    n_local = x_ext.shape[-1] - (k - 1)
    if k <= cv.AUTO_OS_MATMUL_MAX_H:
        full = cv._conv_os_matmul(x_ext, h, cv.overlap_save_step(k),
                                  precision=cv.os_precision())
    else:
        full = cv._conv_overlap_save(
            x_ext, h, cv.tpu_block_length(k, x_ext.shape[-1]))
    # y_local[j] = full[j + k - 1]: the VALID span of this block
    return full[..., k - 1:k - 1 + n_local]


def sharded_convolve(x, h, mesh, axis: str = "sp"):
    """Sequence-parallel full linear convolution over ``mesh[axis]``.

    The signal is sharded along its length; each shard convolves its
    block after a one-hop left-halo exchange of ``h−1`` samples.  Returns
    the full ``n + h - 1`` result (same semantics as
    :func:`veles.simd_tpu_torch.ops.convolve.convolve`).
    """
    x = _place(x, mesh)
    h = _place(h, mesh)
    if x.dim() < 1:
        raise ValueError("sharded_convolve needs [..., n]")
    n, k = x.shape[-1], h.shape[-1]
    n_shards = mesh.shape[axis]
    out_len = n + k - 1
    pad_to = -(-out_len // n_shards) * n_shards
    if k - 1 > pad_to // n_shards:
        # filter halo exceeds one block: auto-select the multi-hop ring
        return sharded_convolve_ring(x, h, mesh, axis=axis)
    obs.record_decision(
        "sharded_convolve", "one_hop_halo", n_shards=int(n_shards),
        axis=axis, x_length=int(n), h_length=int(k),
        block=int(pad_to // n_shards), halo=int(k - 1))
    with obs.span("sharded_convolve.dispatch", route="one_hop_halo",
                  n_shards=int(n_shards)):
        x_pad = F.pad(x, (0, pad_to - n))
        # leading batch dims (if any) stay replicated; shard the length
        spec = P(*([None] * (x.dim() - 1) + [axis]))

        @functools.partial(
            _spmd.shard_map, mesh=mesh,
            in_specs=(spec, P()), out_specs=spec)
        def _run(x_local, h_full):
            halo = halo_exchange_left(x_local, k - 1, axis)
            x_ext = torch.cat([halo, x_local], dim=-1)
            return _local_block_conv(x_ext, h_full)

        from veles.simd_tpu_torch.ops import convolve as cv

        jfn = _instrumented("sharded_convolve", _run)
        return _sharded_guard(
            "sharded_convolve",
            lambda: jfn(x_pad, h)[..., :out_len],
            lambda: cv.convolve_simd(x, h),
            mesh, axis)


def sharded_convolve_ring(x, h, mesh, axis: str = "sp",
                          batch_axis: str | None = None):
    """Sequence-parallel convolution for filters LONGER than a shard
    block — the ring-attention communication pattern applied to
    convolution.

    x blocks stream around the ring (``ppermute``, one block per hop)
    while every shard accumulates each arriving block against the
    static segment of the (replicated) filter that lands in its output
    window:

        y_s[j] = Σ_m Σ_i B_{s-m}[i] · h[m·blk + j - i]

    — ``M = min(ceil((k-1)/blk), S-1)`` hops.  Blocks that ring-wrapped
    (from shards right of ``s``) are acausal for this window and
    skipped.  Works for ANY filter length — even ``h`` longer than
    ``x``.  With ``batch_axis`` set, a leading ``[batch, n]`` dimension
    is sharded over that mesh axis too (the dp×sp form).
    """
    x = _place(x, mesh)
    h = _place(h, mesh)
    if x.dim() < 1:
        raise ValueError("sharded_convolve_ring needs [..., n]")
    n, k = x.shape[-1], h.shape[-1]
    if batch_axis is not None and x.dim() != 2:
        raise ValueError("batch_axis needs x of shape [batch, n]")
    n_shards = mesh.shape[axis]
    out_len = n + k - 1
    blk = -(-out_len // n_shards)
    pad_to = blk * n_shards
    batch_pad = 0
    if batch_axis is not None:
        batch_pad = (-x.shape[0]) % mesh.shape[batch_axis]
    x_pad = F.pad(x, (0, pad_to - n) + ((0, batch_pad)
                                       if batch_axis is not None else ()))
    hops = min(-(-(k - 1) // blk), n_shards - 1)
    obs.record_decision(
        "sharded_convolve", "ring", n_shards=int(n_shards), axis=axis,
        x_length=int(n), h_length=int(k), block=int(blk),
        hops=int(hops))
    # h segments: seg_m = h_pp[m·blk : m·blk + 2·blk - 1] with h_pp
    # left-padded blk-1 and right-padded so the last slice is in range
    h_pp = F.pad(h, (blk - 1, (hops + 2) * blk))
    lead = ([batch_axis] + [None] * (x.dim() - 2) if batch_axis is not None
            else [None] * (x.dim() - 1))
    spec = P(*(lead + [axis]))

    @functools.partial(
        _spmd.shard_map, mesh=mesh,
        in_specs=(spec, P()), out_specs=spec)
    def _run(x_local, h_padded):
        s = _spmd.axis_index(axis)
        y = torch.zeros_like(x_local)
        block = x_local
        for m in range(hops + 1):
            # blocks that ring-wrapped (from shards right of s) are
            # acausal for this window
            if s - m >= 0:
                seg = h_padded[..., m * blk:m * blk + 2 * blk - 1]
                y = y + _ring_block_conv(block, seg)
            if m < hops:
                perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
                block = _spmd.ppermute(block, axis, perm)
        return y

    from veles.simd_tpu_torch.ops import convolve as cv

    def _ring_thunk():
        out = _instrumented("sharded_convolve_ring",
                            _run)(x_pad, h_pp)[..., :out_len]
        if batch_pad:
            out = out[:x.shape[0]]
        return out

    return _sharded_guard("sharded_convolve_ring", _ring_thunk,
                          lambda: cv.convolve_simd(x, h), mesh, axis)


def _ring_block_conv(block, seg):
    """Samples ``[blk-1, 2·blk-1)`` of the full linear convolution of a
    [..., blk] block with a [2·blk-1] filter segment — exactly the
    shard's output window for one ring hop.  Direct fp32 conv for small
    products, spectral beyond the 1D crossover
    (``ops/convolve.py AUTO_FFT_MIN_PRODUCT``)."""
    from veles.simd_tpu_torch.ops import convolve as cv

    blk = block.shape[-1]
    ks = seg.shape[-1]
    if blk * ks < cv.AUTO_FFT_MIN_PRODUCT:
        lhs = block.reshape(-1, 1, blk)
        rhs = seg.flip(-1).reshape(1, 1, ks)
        # pad (blk-1, blk-1): output index o == full-conv index o + blk-1,
        # so the blk outputs are precisely the shard's window
        out = prx.p_conv(lhs, rhs, padding=blk - 1)
        return out.reshape(tuple(block.shape[:-1]) + (blk,))
    m = next_highest_power_of_2(blk + ks - 1)
    spec = torch.fft.rfft(block, m) * torch.fft.rfft(seg, m)
    return torch.fft.irfft(spec, m)[..., blk - 1:2 * blk - 1]


def sharded_convolve_batch(x, h, mesh, batch_axis: str = "dp",
                           seq_axis: str = "sp"):
    """dp×sp convolution: a batch of signals sharded over ``batch_axis``
    *and* each signal's length over ``seq_axis``.

    Every (dp, sp) shard holds a [batch/dp, n/sp] tile, halo-exchanges
    ``h−1`` samples along sp, and convolves its tile with the shared
    filter.  Returns the full ``[batch, n + h - 1]`` result.
    """
    x = _place(x, mesh)
    h = _place(h, mesh)
    if x.dim() != 2:
        raise ValueError("sharded_convolve_batch expects [batch, n]")
    batch, n = x.shape
    k = h.shape[-1]
    dp = mesh.shape[batch_axis]
    sp = mesh.shape[seq_axis]
    out_len = n + k - 1
    # pad-and-slice an indivisible batch (zero rows convolve to zeros)
    batch_pad = (-batch) % dp
    pad_to = -(-out_len // sp) * sp
    if k - 1 > pad_to // sp:
        # same auto-select as sharded_convolve: the multi-hop ring
        return sharded_convolve_ring(x, h, mesh, axis=seq_axis,
                                     batch_axis=batch_axis)
    x_pad = F.pad(x, (0, pad_to - n, 0, batch_pad))

    @functools.partial(
        _spmd.shard_map, mesh=mesh,
        in_specs=(P(batch_axis, seq_axis), P()),
        out_specs=P(batch_axis, seq_axis))
    def _run(x_local, h_full):
        halo = halo_exchange_left(x_local, k - 1, seq_axis)
        x_ext = torch.cat([halo, x_local], dim=-1)
        return _local_block_conv(x_ext, h_full)

    from veles.simd_tpu_torch.ops import convolve as cv

    jfn = _instrumented("sharded_convolve_batch", _run)
    return _sharded_guard(
        "sharded_convolve_batch",
        lambda: jfn(x_pad, h)[:batch, :out_len],
        lambda: cv.convolve_simd(x, h),
        mesh, seq_axis)


def sharded_convolve2d(x, h, mesh, axes=("dp", "sp")):
    """Full 2D convolution of one image sharded over a 2D shard grid.

    The image is tiled over ``mesh[axes[0]] x mesh[axes[1]]``; each tile
    needs a top halo of ``k0-1`` rows and a left halo of ``k1-1``
    columns.  Rows are exchanged first, then columns of the
    *row-extended* tile — the second hop carries the corner without any
    diagonal communication.  Returns the full
    ``[n0 + k0 - 1, n1 + k1 - 1]`` result.  The local tile step is the
    batched-FFT form, as in the JAX package.
    """
    from veles.simd_tpu_torch.ops import convolve2d as cv2

    x = _place(x, mesh)
    h = _place(h, mesh)
    if x.dim() != 2 or h.dim() != 2:
        raise ValueError("sharded_convolve2d shards one [n0, n1] image "
                         "with an [k0, k1] kernel")
    a0, a1 = axes
    s0, s1 = mesh.shape[a0], mesh.shape[a1]
    n0, n1 = x.shape
    k0, k1 = h.shape
    out0, out1 = n0 + k0 - 1, n1 + k1 - 1
    pad0 = -(-out0 // s0) * s0
    pad1 = -(-out1 // s1) * s1
    if k0 - 1 > pad0 // s0 or k1 - 1 > pad1 // s1:
        # kernel halo exceeds one tile: auto-select the 2D ring pipeline
        return sharded_convolve2d_ring(x, h, mesh, axes=axes)
    x_pad = F.pad(x, (0, pad1 - n1, 0, pad0 - n0))

    @functools.partial(
        _spmd.shard_map, mesh=mesh,
        in_specs=(P(a0, a1), P()), out_specs=P(a0, a1))
    def _run(x_local, h_full):
        # phase 1: top halo rows over axes[0]
        top = halo_exchange_left(x_local.transpose(-1, -2), k0 - 1, a0)
        ext0 = torch.cat([top.transpose(-1, -2), x_local], dim=-2)
        # phase 2: left halo columns of the row-extended tile over
        # axes[1] — carries the diagonal corner for free
        left = halo_exchange_left(ext0, k1 - 1, a1)
        ext = torch.cat([left, ext0], dim=-1)
        full = cv2._conv2d_fft(ext, h_full)
        # VALID span of this tile in the global result: the halo shifts
        # the tile origin by (k0-1, k1-1)
        return full[..., k0 - 1:k0 - 1 + x_local.shape[-2],
                    k1 - 1:k1 - 1 + x_local.shape[-1]]

    jfn = _instrumented("sharded_convolve2d", _run)
    return _sharded_guard(
        "sharded_convolve2d",
        lambda: jfn(x_pad, h)[:out0, :out1],
        lambda: cv2.convolve2d(x, h),
        mesh, a1)


def sharded_convolve2d_ring(x, h, mesh, axes=("dp", "sp")):
    """2D convolution for kernels LARGER than a shard tile: the 2D ring
    pipeline.

    The 1D ring's index algebra separates per axis, so the tile for
    shard (s0, s1) accumulates

        y[j0, j1] = Σ_{m0, m1} Σ_{i0, i1}
            B_{s0-m0, s1-m1}[i0, i1] · h[m0·blk0 + j0 - i0,
                                         m1·blk1 + j1 - i1]

    with tiles streaming along ``axes[1]`` (inner ring) inside a stream
    along ``axes[0]`` (outer ring), causality-masked per axis.  Works
    for ANY kernel size, even larger than the image on either axis.
    """
    x = _place(x, mesh)
    h = _place(h, mesh)
    if x.dim() != 2 or h.dim() != 2:
        raise ValueError("sharded_convolve2d_ring shards one [n0, n1] "
                         "image with an [k0, k1] kernel")
    n0, n1 = x.shape
    k0, k1 = h.shape
    a0, a1 = axes
    s0, s1 = mesh.shape[a0], mesh.shape[a1]
    out0, out1 = n0 + k0 - 1, n1 + k1 - 1
    blk0, blk1 = -(-out0 // s0), -(-out1 // s1)
    x_pad = F.pad(x, (0, blk1 * s1 - n1, 0, blk0 * s0 - n0))
    hops0 = min(-(-(k0 - 1) // blk0), s0 - 1)
    hops1 = min(-(-(k1 - 1) // blk1), s1 - 1)
    h_pp = F.pad(h, (blk1 - 1, (hops1 + 2) * blk1,
                     blk0 - 1, (hops0 + 2) * blk0))

    perm0 = [(i, (i + 1) % s0) for i in range(s0)]
    perm1 = [(i, (i + 1) % s1) for i in range(s1)]

    @functools.partial(
        _spmd.shard_map, mesh=mesh,
        in_specs=(P(a0, a1), P()), out_specs=P(a0, a1))
    def _run(x_local, h_padded):
        i0 = _spmd.axis_index(a0)
        i1 = _spmd.axis_index(a1)
        y = torch.zeros_like(x_local)
        row = x_local
        for m0 in range(hops0 + 1):
            tile = row
            for m1 in range(hops1 + 1):
                if i0 - m0 >= 0 and i1 - m1 >= 0:
                    seg = h_padded[m0 * blk0:m0 * blk0 + 2 * blk0 - 1,
                                   m1 * blk1:m1 * blk1 + 2 * blk1 - 1]
                    y = y + _ring_tile_conv2d(tile, seg)
                if m1 < hops1:
                    tile = _spmd.ppermute(tile, a1, perm1)
            if m0 < hops0:
                row = _spmd.ppermute(row, a0, perm0)
        return y

    from veles.simd_tpu_torch.ops import convolve2d as cv2

    jfn = _instrumented("sharded_convolve2d_ring", _run)
    return _sharded_guard(
        "sharded_convolve2d_ring",
        lambda: jfn(x_pad, h_pp)[:out0, :out1],
        lambda: cv2.convolve2d(x, h),
        mesh, a1)


def _ring_tile_conv2d(tile, seg):
    """The [blk0-1, 2·blk0-1) × [blk1-1, 2·blk1-1) window of the full 2D
    convolution of a [blk0, blk1] tile with a [2·blk0-1, 2·blk1-1]
    kernel segment — one 2D ring hop's contribution.  Direct fp32
    conv below the (1D-measured) spectral crossover, rFFT2 above."""
    from veles.simd_tpu_torch.ops import convolve as cv

    b0, b1 = tile.shape[-2:]
    g0, g1 = seg.shape[-2:]
    if b0 * b1 * g0 * g1 < cv.AUTO_FFT_MIN_PRODUCT ** 2:
        lhs = tile.reshape(1, 1, b0, b1)
        rhs = seg.flip((-2, -1)).reshape(1, 1, g0, g1)
        out = prx.p_conv(lhs, rhs, padding=(b0 - 1, b1 - 1))
        return out.reshape(tuple(tile.shape[:-2]) + (b0, b1))
    m0 = next_highest_power_of_2(b0 + g0 - 1)
    m1 = next_highest_power_of_2(b1 + g1 - 1)
    spec = (torch.fft.rfft2(tile, s=(m0, m1))
            * torch.fft.rfft2(seg, s=(m0, m1)))
    full = torch.fft.irfft2(spec, s=(m0, m1))
    return full[..., b0 - 1:2 * b0 - 1, b1 - 1:2 * b1 - 1]


def _a2a_quad2d(row_fn, imgs, mesh, axis: str):
    """Shared all-to-all separable-2D choreography for a BATCH of
    row-sharded images ``[m, n0, n1]``: row pass on complete local
    rows, tiled ``all_to_all`` to column-split, column pass, transpose
    back.  ``row_fn(x) -> (hi, lo)`` is the 1D analysis along the last
    axis (decimating or not).  Returns ``(ll, lh, hl, hh)``, each
    ``[m, n0', n1']``.  One shard program / two collective rounds
    regardless of ``m``."""
    from veles.simd_tpu_torch.ops import wavelet as wv

    @functools.partial(
        _spmd.shard_map, mesh=mesh,
        in_specs=P(None, axis, None),
        out_specs=(P(None, axis, None),) * 4)
    def _run(x_local):
        hi_r, lo_r = row_fn(x_local)                 # [m, n0/S, n1']
        both = torch.stack([hi_r, lo_r])             # [2, m, n0/S, n1']
        cols = _spmd.all_to_all(both, axis, split_axis=3,
                                concat_axis=2, tiled=True)
        bands, lows = wv._apply_last(row_fn, cols)   # [2, m, n0', n1'/S]
        quad = torch.stack([bands, lows])            # [2, 2, m, ...]
        quad = _spmd.all_to_all(quad, axis, split_axis=3,
                                concat_axis=4, tiled=True)
        (hh, lh), (hl, ll) = quad[0], quad[1]
        return ll, lh, hl, hh

    return _run(imgs)


def sharded_wavelet_apply2d(type, order, ext, img, mesh,
                            axis: str = "sp"):
    """Separable 2D DWT of one image with rows sharded over
    ``mesh[axis]`` — the **all-to-all** (Ulysses-style) layout pattern,
    complementing the halo/ring family.

    Each shard transforms its complete rows locally, an ``all_to_all``
    re-shards from row-split to column-split, the column pass runs
    locally on complete columns, and a second ``all_to_all`` restores
    the row sharding.  Because every 1D pass sees whole rows/columns,
    **all four boundary extensions are exact**.  Returns
    ``(ll, lh, hl, hh)``, each ``[n0/2, n1/2]``, matching
    :func:`veles.simd_tpu_torch.ops.wavelet.wavelet_apply2d`.

    Requires ``n0 % (2·S) == 0`` and ``n1 % (2·S) == 0``.
    """
    from veles.simd_tpu_torch.ops import wavelet as wv

    img = _place(img, mesh)
    if img.dim() != 2:
        raise ValueError("sharded_wavelet_apply2d shards one [n0, n1] "
                         "image")
    n0, n1 = img.shape
    s = mesh.shape[axis]
    if n0 % (2 * s) or n1 % (2 * s):
        raise ValueError(
            f"image {tuple(img.shape)} must have both dims divisible by "
            f"2*{axis}={2 * s} (each pass halves a dim that re-splits "
            f"{s} ways)")

    quad = _a2a_quad2d(
        lambda v: wv.wavelet_apply(type, order, ext, v, simd=True),
        img[None], mesh, axis)
    return tuple(b[0] for b in quad)


def sharded_wavelet_reconstruct2d(type, order, ll, lh, hl, hh, mesh,
                                  axis: str = "sp"):
    """Exact inverse of :func:`sharded_wavelet_apply2d` for the PERIODIC
    extension: the same all-to-all choreography in reverse (column
    synthesis on complete columns, transpose, row synthesis).
    """
    from veles.simd_tpu_torch.ops import wavelet as wv

    bands = [_place(b, mesh) for b in (ll, lh, hl, hh)]
    if any(b.shape != bands[0].shape or b.dim() != 2 for b in bands):
        raise ValueError("need four equal [m0, m1] bands")
    m0, m1 = bands[0].shape
    s = mesh.shape[axis]
    if m0 % s or m1 % s:
        raise ValueError(
            f"band dims {tuple(bands[0].shape)} must be divisible by "
            f"{axis}={s}")

    @functools.partial(
        _spmd.shard_map, mesh=mesh,
        in_specs=(P(axis, None),) * 4, out_specs=P(axis, None))
    def _run(ll_b, lh_b, hl_b, hh_b):
        quad = torch.stack([torch.stack([hh_b, lh_b]),
                            torch.stack([hl_b, ll_b])])  # [2, 2, m0/S, m1]
        # row-split -> column-split
        quad = _spmd.all_to_all(quad, axis, split_axis=3, concat_axis=2,
                                tiled=True)         # [2, 2, m0, m1/S]
        # column synthesis on complete columns
        rec = wv.wavelet_reconstruct(
            type, order, quad[0].transpose(-1, -2),
            quad[1].transpose(-1, -2), simd=True)     # [2, m1/S, 2*m0]
        rec = rec.transpose(-1, -2)                  # [2, 2*m0, m1/S]
        # column-split -> row-split
        rec = _spmd.all_to_all(rec, axis, split_axis=1, concat_axis=2,
                               tiled=True)          # [2, 2*m0/S, m1]
        # row synthesis on complete rows
        return wv.wavelet_reconstruct(type, order, rec[0], rec[1],
                                      simd=True)     # [2*m0/S, 2*m1]

    return _run(*bands)


def sharded_swt(type, order, levels, x, mesh, axis: str = "sp"):
    """Sequence-parallel stationary-wavelet cascade (periodic extension).

    Level ℓ needs a right halo of ``(order-1)·2^(ℓ-1)`` samples, fetched
    with a ring ``ppermute`` (periodic extension wraps the global
    signal, which on a ring is exactly the last→first hop).  All
    ``levels`` levels run in ONE shard program.  Returns
    ``[hi_1, ..., hi_levels, lo_levels]``, every band of the input length
    — matching :func:`stationary_wavelet_transform` with PERIODIC.
    """
    from veles.simd_tpu_torch.ops import wavelet as wv

    x = _place(x, mesh)
    if x.dim() < 1:
        raise ValueError("sharded_swt needs [..., n]")
    n = x.shape[-1]
    order = int(order)
    levels = int(levels)
    if levels < 1:
        raise ValueError("levels must be >= 1")
    n_shards = mesh.shape[axis]
    if n % n_shards:
        raise ValueError(f"signal length {n} not divisible by {axis}="
                         f"{n_shards} (SWT keeps length; pad first)")
    max_halo = order * (1 << (levels - 1))
    if max_halo > n // n_shards:
        raise ValueError(
            f"level-{levels} halo {max_halo} exceeds the per-shard block "
            f"({n // n_shards}); fewer shards or fewer levels")
    rhs = _const(np.stack(wv._filters(type, order)), x).reshape(
        2, 1, order)
    spec = P(*([None] * (x.dim() - 1) + [axis]))

    def _level(cur, dilation):
        # reference right-extension is order*dilation; VALID windows only
        # reach (order-1)*dilation past the last start, but keep the full
        # ext for parity with the single-card kernel's slice
        halo_len = order * dilation
        halo = halo_exchange_right(cur, halo_len, axis, periodic=True)
        cur_ext = torch.cat([cur, halo], dim=-1)
        batch_shape = tuple(cur.shape[:-1])
        lhs = cur_ext.reshape(-1, 1, cur_ext.shape[-1])
        out = prx.p_conv(lhs, rhs.to(cur.device), dilation=dilation)
        out = out[..., :cur.shape[-1]].reshape(
            batch_shape + (2, cur.shape[-1]))
        return out[..., 0, :], out[..., 1, :]

    @functools.partial(
        _spmd.shard_map, mesh=mesh,
        in_specs=spec, out_specs=spec)
    def _run(x_local):
        outs = []
        cur = x_local
        for lvl in range(1, levels + 1):
            hi, cur = _level(cur, 1 << (lvl - 1))
            outs.append(hi)
        return tuple(outs) + (cur,)

    return list(_run(x))


def sharded_swt_reconstruct(type, order, levels, coeffs, mesh,
                            axis: str = "sp"):
    """Sequence-parallel inverse of :func:`sharded_swt` (PERIODIC).

    Synthesis is the frame adjoint over ``2c²``: a dilated *convolution*
    with the unflipped filters, whose windows reach ``(order−1)·2^(ℓ−1)``
    samples to the **left** — so each level does one left-halo ring
    ``ppermute`` and a local dilated conv.  All levels run in one shard
    program.  Returns the reconstructed ``[..., n]`` signal matching
    :func:`stationary_wavelet_inverse_transform`.
    """
    from veles.simd_tpu_torch.ops import wavelet as wv

    coeffs = [_place(c, mesh) for c in coeffs]
    levels = int(levels)
    order = int(order)
    if levels < 1 or len(coeffs) != levels + 1:
        raise ValueError("need [hi_1, ..., hi_L, lo_L] matching levels")
    n = coeffs[0].shape[-1]
    n_shards = mesh.shape[axis]
    if n % n_shards:
        raise ValueError(f"band length {n} not divisible by {axis}="
                         f"{n_shards}")
    max_halo = (order - 1) * (1 << (levels - 1))
    if max_halo > n // n_shards:
        raise ValueError(
            f"level-{levels} synthesis halo {max_halo} exceeds the "
            f"per-shard block ({n // n_shards}); fewer shards or levels")
    hi_f, lo_f = wv._filters(type, order)
    c2 = float(wv._c2(lo_f))
    # convolution = correlation with flipped taps
    rhs = _const(np.stack([hi_f[::-1], lo_f[::-1]]),
                 coeffs[0]).reshape(1, 2, order)
    nd = coeffs[0].dim()
    spec = P(*([None] * (nd - 1) + [axis]))

    def _inv_level(hi_b, lo_b, dilation):
        halo_len = (order - 1) * dilation
        # left halo: x[t] sums y[(t − j·dil) mod n] — periodic ring
        h_hi = halo_exchange_left(hi_b, halo_len, axis, periodic=True)
        h_lo = halo_exchange_left(lo_b, halo_len, axis, periodic=True)
        ext = torch.stack(
            [torch.cat([h_hi, hi_b], dim=-1),
             torch.cat([h_lo, lo_b], dim=-1)], dim=-2)
        batch_shape = tuple(hi_b.shape[:-1])
        lhs = ext.reshape(-1, 2, ext.shape[-1])
        out = prx.p_conv(lhs, rhs.to(lhs.device),
                         dilation=dilation)[:, 0]
        return (out / (2.0 * c2)).reshape(batch_shape + (hi_b.shape[-1],))

    @functools.partial(
        _spmd.shard_map, mesh=mesh,
        in_specs=tuple([spec] * (levels + 1)), out_specs=spec)
    def _run(*bands):
        cur = bands[-1]
        for lvl in range(levels, 0, -1):
            cur = _inv_level(bands[lvl - 1], cur, 1 << (lvl - 1))
        return cur

    return _run(*coeffs)


def sharded_wavelet_apply(type, order, x, mesh, axis: str = "sp"):
    """Sequence-parallel single-level DWT analysis (PERIODIC): signal
    ``[..., n]`` sharded along length → ``(hi, lo)`` bands ``[..., n/2]``
    sharded the same way.

    Each shard's stride-2 windows reach ``order − 2`` samples past its
    block, so one right-halo ring ``ppermute`` (periodic wrap) feeds a
    local strided conv — the analysis-side mirror of
    :func:`sharded_wavelet_reconstruct`.
    """
    from veles.simd_tpu_torch.ops import wavelet as wv

    x = _place(x, mesh)
    order = int(order)
    n = x.shape[-1]
    n_shards = mesh.shape[axis]
    if n % (2 * n_shards):
        raise ValueError(f"signal length {n} must be divisible by "
                         f"2*{axis}={2 * n_shards}")
    # stride-2 windows reach (order-2) samples past the block: the last
    # window starts at block-2 and spans order taps
    halo = order - 2
    if halo > n // n_shards:
        raise ValueError(
            f"analysis halo {halo} exceeds the per-shard block "
            f"({n // n_shards}); fewer shards")
    rhs = _const(np.stack(wv._filters(type, order)), x).reshape(
        2, 1, order)
    spec = P(*([None] * (x.dim() - 1) + [axis]))

    @functools.partial(
        _spmd.shard_map, mesh=mesh,
        in_specs=spec, out_specs=(spec, spec))
    def _run(x_local):
        h = halo_exchange_right(x_local, halo, axis, periodic=True)
        ext = torch.cat([x_local, h], dim=-1)
        batch_shape = tuple(x_local.shape[:-1])
        m_loc = x_local.shape[-1] // 2
        lhs = ext.reshape(-1, 1, ext.shape[-1])
        out = prx.p_conv(lhs, rhs.to(lhs.device), stride=2)
        out = out[..., :m_loc].reshape(batch_shape + (2, m_loc))
        return out[..., 0, :], out[..., 1, :]

    return _run(x)


def sharded_wavelet_transform(type, order, x, levels, mesh,
                              axis: str = "sp"):
    """Multi-level sequence-parallel DWT cascade (PERIODIC): repeatedly
    split the length-sharded lowpass band.  Returns
    ``[hi_1, ..., hi_L, lo_L]`` like the single-card
    :func:`veles.simd_tpu_torch.ops.wavelet.wavelet_transform`.  The
    per-shard block halves each level, so depth is bounded by
    ``n / (S · 2^(L-1)) >= order - 2``."""
    coeffs = []
    cur = x
    for _ in range(int(levels)):
        hi, cur = sharded_wavelet_apply(type, order, cur, mesh, axis=axis)
        coeffs.append(hi)
    coeffs.append(cur)
    return coeffs


def sharded_wavelet_inverse_transform(type, order, coeffs, mesh,
                                      axis: str = "sp"):
    """Invert :func:`sharded_wavelet_transform` on the mesh (PERIODIC)."""
    coeffs = list(coeffs)
    if len(coeffs) < 2:
        raise ValueError("need [hi_1, ..., hi_L, lo_L] with L >= 1")
    cur = coeffs[-1]
    for hi in reversed(coeffs[:-1]):
        cur = sharded_wavelet_reconstruct(type, order, hi, cur, mesh,
                                          axis=axis)
    return cur


def sharded_wavelet_reconstruct(type, order, desthi, destlo, mesh,
                                axis: str = "sp"):
    """Sequence-parallel exact inverse of the PERIODIC DWT analysis:
    bands ``[..., m]`` sharded along length → signal ``[..., 2m]``.

    The adjoint upsamples by 2 and convolves: output sample ``t`` sums
    band samples down to ``⌈(t−order+1)/2⌉``, i.e. a left halo of
    ``order/2`` band samples per shard (ring ``ppermute``), then a local
    convolution of the 2-upsampled block sliced to the shard's span.
    """
    from veles.simd_tpu_torch.ops import wavelet as wv

    desthi = _place(desthi, mesh)
    destlo = _place(destlo, mesh)
    if desthi.shape != destlo.shape:
        raise ValueError(
            f"band shapes differ: {tuple(desthi.shape)} vs "
            f"{tuple(destlo.shape)}")
    order = int(order)
    m = desthi.shape[-1]
    n_shards = mesh.shape[axis]
    if m % n_shards:
        raise ValueError(f"band length {m} not divisible by {axis}="
                         f"{n_shards}")
    halo = order // 2
    if halo > m // n_shards:
        raise ValueError(
            f"synthesis halo {halo} exceeds the per-shard band block "
            f"({m // n_shards}); fewer shards")
    hi_f, lo_f = wv._filters(type, order)
    c2 = float(wv._c2(lo_f))
    rhs = _const(np.stack([hi_f[::-1], lo_f[::-1]]), desthi).reshape(
        1, 2, order)
    nd = desthi.dim()
    spec = P(*([None] * (nd - 1) + [axis]))

    @functools.partial(
        _spmd.shard_map, mesh=mesh,
        in_specs=(spec, spec), out_specs=spec)
    def _run(hi_b, lo_b):
        h_hi = halo_exchange_left(hi_b, halo, axis, periodic=True)
        h_lo = halo_exchange_left(lo_b, halo, axis, periodic=True)
        ext = torch.stack(
            [torch.cat([h_hi, hi_b], dim=-1),
             torch.cat([h_lo, lo_b], dim=-1)], dim=-2)
        batch_shape = tuple(hi_b.shape[:-1])
        m_loc = hi_b.shape[-1]
        lhs = ext.reshape(-1, 2, ext.shape[-1])
        # the 2-upsampled block (lax's lhs_dilation=2), then the full
        # conv: out_local[τ] = full[τ + 2H]
        up = lhs.new_zeros(lhs.shape[:-1] + (2 * lhs.shape[-1] - 1,))
        up[..., ::2] = lhs
        pad = order - 1
        full = prx.p_conv(up, rhs.to(up.device), padding=pad)[:, 0]
        out = full[..., 2 * halo:2 * halo + 2 * m_loc]
        return (out / c2).reshape(batch_shape + (2 * m_loc,))

    return _run(desthi, destlo)


def sharded_matmul(a, b, mesh, axis: str = "tp"):
    """Tensor-parallel GEMM: contracting dim sharded, ``psum`` across
    the shards.

    ``a [m, K] @ b [K, n]`` with K split across ``mesh[axis]``; each
    shard computes a partial ``[m, n]`` in full fp32 and the partials
    are all-reduced.  K is zero-padded up to a multiple of the axis size
    (zeros contribute nothing to the contraction).
    """
    a = _place(a, mesh, dtype=None)
    b = _place(b, mesh, dtype=None)
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"contracting dims differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    shards = mesh.shape[axis]
    obs.record_decision(
        "sharded_matmul", "contracting_dim", n_shards=int(shards),
        axis=axis, m=int(a.shape[-2]), k=int(a.shape[-1]),
        n=int(b.shape[-1]))
    with obs.span("sharded_matmul.dispatch", n_shards=int(shards)):
        a0, b0 = a, b
        rem = a.shape[-1] % shards
        if rem:
            pad = shards - rem
            a = F.pad(a, (0, pad))
            b = F.pad(b, (0, 0, 0, pad))

        @functools.partial(
            _spmd.shard_map, mesh=mesh,
            in_specs=(P(None, axis), P(axis, None)),
            out_specs=P(None, None))
        def _run(a_local, b_local):
            partial = prx.p_matmul(a_local, b_local)
            return _spmd.psum(partial, axis)

        from veles.simd_tpu_torch.ops import matrix as mx

        jfn = _instrumented("sharded_matmul", _run)
        return _sharded_guard(
            "sharded_matmul",
            lambda: jfn(a, b),
            lambda: mx.matrix_multiply(a0, b0),
            mesh, axis)


def _check_stft_sharding(n, frame_length, hop, n_shards):
    from veles.simd_tpu_torch.ops import spectral as sp

    sp._check_stft_args(n, frame_length, hop)
    if n % n_shards:
        raise ValueError(f"signal length {n} not divisible into "
                         f"{n_shards} shards (pad first)")
    block = n // n_shards
    if block % hop:
        raise ValueError(
            f"per-shard block {block} not a multiple of hop {hop} — "
            "frame starts would straddle shard ownership; choose a hop "
            "that divides the block (or fewer shards)")
    halo = frame_length - hop
    if halo > block:
        raise ValueError(
            f"frame overlap {halo} (frame_length - hop) exceeds the "
            f"per-shard block {block}; fewer shards or a larger hop")
    return block, halo


def sharded_stft(x, frame_length: int, hop: int, mesh,
                 axis: str = "sp", window=None):
    """Sequence-parallel STFT: the signal sharded along time, one
    ``ppermute`` right-halo of ``frame_length - hop`` samples per shard.

    Frame ownership follows sample ownership (``block % hop == 0`` keeps
    ``block // hop`` frames per shard), so the frame axis comes back
    sharded over the SAME mesh axis.  Matches the single-card
    :func:`veles.simd_tpu_torch.ops.spectral.stft`: the per-shard frame
    count includes up to ``(frame_length - hop) / hop`` trailing frames
    that overhang the global signal end (computed against the zero halo
    ``ppermute`` feeds the last shard), sliced off before returning.
    """
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.parallel import fourier as _fr

    x = _place(x, mesh)
    n = x.shape[-1]
    n_shards = mesh.shape[axis]
    block, halo = _check_stft_sharding(n, frame_length, hop, n_shards)
    obs.record_decision(
        "sharded_stft", "right_halo", n_shards=int(n_shards), axis=axis,
        n=int(n), frame_length=int(frame_length), hop=int(hop),
        block=int(block), halo=int(halo))
    window_np = sp._resolve_window(window, frame_length)
    # the LOCAL per-frame transform goes through the engine's
    # parallel.frame_dft table: the rdft-basis matmul within the
    # single-card cutoff, the Cooley-Tukey factorized matmul above it,
    # xla_fft terminal — recorded either way
    local_route = _fr.select_frame_route(frame_length)
    obs.record_decision(
        "sharded_stft_local", local_route, n_shards=int(n_shards),
        frame_length=int(frame_length), hop=int(hop))
    frame_fn = _fr.frame_rfft_fn(local_route, frame_length, window_np,
                                 x.device)
    # per-shard framing layout == the single-card layout on block + halo
    # samples (frame_count(block + halo, fl, hop) == block // hop)
    frames_local = sp.frame_count(block + halo, frame_length, hop)
    in_spec = P(*([None] * (x.dim() - 1) + [axis]))
    out_spec = P(*([None] * (x.dim() - 1) + [axis, None]))

    @functools.partial(_spmd.shard_map, mesh=mesh,
                       in_specs=in_spec, out_specs=out_spec)
    def _run(x_local):
        halo_part = halo_exchange_right(x_local, halo, axis)
        x_ext = torch.cat([x_local, halo_part], dim=-1)
        frames = sp._take_frames(x_ext, frame_length, hop)
        return frame_fn(frames[..., :frames_local, :])

    with obs.span("sharded_stft.dispatch", n_shards=int(n_shards)):
        fc = sp.frame_count(n, frame_length, hop)
        jfn = _instrumented("sharded_stft", _run)
        return _sharded_guard(
            "sharded_stft",
            lambda: jfn(x)[..., :fc, :],
            lambda: sp.stft(x, frame_length, hop, window=window),
            mesh, axis)


def sharded_istft(spec, n: int, frame_length: int, hop: int, mesh,
                  axis: str = "sp", window=None):
    """Sequence-parallel inverse STFT (windowed overlap-add).

    Each shard overlap-adds its own frames into a ``block +
    (frame_length - hop)`` local buffer, and the overhang — the samples
    its last frames wrote into the RIGHT neighbour's territory — rides
    one ``ppermute`` to be added onto that neighbour's head.  COLA
    normalization (division by the global window-overlap envelope)
    happens after the shard program as an elementwise multiply.
    Matches the single-card :func:`veles.simd_tpu_torch.ops.spectral.
    istft`.
    """
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.parallel import fourier as _fr

    n_shards = mesh.shape[axis]
    block, halo = _check_stft_sharding(n, frame_length, hop, n_shards)
    window_np = sp._resolve_window(window, frame_length)
    spec = _place(spec, mesh, dtype=torch.complex64)
    spec0 = spec
    # engine-selected local synthesis transform
    local_route = _fr.select_frame_route(frame_length)
    obs.record_decision(
        "sharded_istft_local", local_route, n_shards=int(n_shards),
        frame_length=int(frame_length), hop=int(hop))
    frame_fn = _fr.frame_irfft_fn(local_route, frame_length,
                                  window_np, spec.device)
    frames_total = sp.frame_count(n, frame_length, hop)
    if tuple(spec.shape[-2:]) != (frames_total, frame_length // 2 + 1):
        raise ValueError(
            f"spec shape {tuple(spec.shape[-2:])} inconsistent with "
            f"n={n}, frame_length={frame_length}, hop={hop} (expect "
            f"{(frames_total, frame_length // 2 + 1)})")
    # pad the frame axis back out to the uniform n // hop per-shard count
    # with zero frames — zeros contribute nothing to the overlap-add
    pad_frames = n // hop - frames_total
    if pad_frames:
        spec = torch.cat([spec, spec.new_zeros(
            tuple(spec.shape[:-2]) + (pad_frames, spec.shape[-1]))],
            dim=-2)
    in_spec = P(*([None] * (spec.dim() - 2) + [axis, None]))
    out_spec = P(*([None] * (spec.dim() - 2) + [axis]))

    @functools.partial(_spmd.shard_map, mesh=mesh,
                       in_specs=in_spec, out_specs=out_spec)
    def _run(spec_local):
        frames = frame_fn(spec_local)
        buf = sp._overlap_add(frames, block + halo, frame_length, hop)
        overflow = buf[..., block:]  # [..., halo] — right neighbour's head
        n_sh = _spmd.axis_size(axis)
        recv = _spmd.ppermute(overflow, axis,
                              [(i, i + 1) for i in range(n_sh - 1)])
        head = buf[..., :halo] + recv
        return torch.cat([head, buf[..., halo:block]], dim=-1)

    env_inv = _const(sp._env_inv(n, frame_length, hop, window_np), spec)
    jfn = _instrumented("sharded_istft", _run)
    return _sharded_guard(
        "sharded_istft",
        lambda: jfn(spec) * env_inv,
        lambda: sp.istft(spec0, n, frame_length, hop, window=window),
        mesh, axis)


def sharded_sosfilt(sos, x, mesh, axis: str = "sp"):
    """Sequence-parallel IIR cascade — the recurrence crosses shard
    boundaries, and still never runs sequentially.

    Each shard scans its own block from a zero incoming state (the
    port's doubling scan, ``iir._biquad_affine_scan``); the per-shard
    exit states ride ONE ``all_gather`` of a ``[2]`` vector per shard,
    and every shard combines its predecessors' summaries through
    host-precomputed powers of the block transition matrix ``A^B`` to
    get its true incoming state; the exact global result is then
    ``s_local[t] + A^(t+1) @ s_in``, with the cumulative powers from
    the same scan.  Collective traffic per section and shard: a 2-float
    exit state (all_gather) plus a 2-sample x halo (ppermute).

    ``x`` is ``[..., n]`` with the last axis sharded; sections run in
    cascade order.  Matches ``iir.sosfilt(sos, gathered_x)``.
    """
    from veles.simd_tpu_torch.ops import iir as _iir

    sos = _iir._check_sos(sos)
    x = _place(x, mesh)
    n = x.shape[-1]
    n_shards = mesh.shape[axis]
    if n % n_shards:
        raise ValueError(f"signal length {n} not divisible into "
                         f"{n_shards} shards (pad first)")
    block = n // n_shards
    if block < 2:
        raise ValueError("per-shard block must be >= 2")
    spec = P(*([None] * (x.dim() - 1) + [axis]))

    # host-side constants per section: A, A^B, and the prefix-combine
    # weights W[i, j] = (A^B)^(i-1-j) for j < i (zero otherwise), so
    # s_in[i] = sum_j W[i, j] @ s_exit[j]
    sections = []
    for b0, b1, b2, _, a1, a2 in sos:
        a_np = np.array([[-a1, -a2], [1.0, 0.0]])
        a_blk = np.linalg.matrix_power(a_np, block)
        pows = [np.eye(2)]
        for _ in range(n_shards - 1):
            pows.append(a_blk @ pows[-1])
        w = np.zeros((n_shards, n_shards, 2, 2))
        for i in range(n_shards):
            for j in range(i):
                w[i, j] = pows[i - 1 - j]
        sections.append((float(np.float32(b0)), float(np.float32(b1)),
                         float(np.float32(b2)), np.float32(a1),
                         np.float32(a2), _const(w, x)))

    def _section(x_local, sec):
        b0, b1, b2, a1, a2, w = sec
        # FIR drive with the 2-sample x halo from the left neighbour
        halo = halo_exchange_left(x_local, 2, axis)
        x_ext = torch.cat([halo, x_local], dim=-1)
        u = (b0 * x_ext[..., 2:] + b1 * x_ext[..., 1:-1]
             + b2 * x_ext[..., :-2])
        # level 1: ONE local scan from a zero incoming state; the same
        # scan's cumulative products cum_a[t] = A^(t+1) come out free
        drive = torch.stack([u, torch.zeros_like(u)], dim=-1)
        cum_a, states0 = _iir._biquad_affine_scan(a1, a2, drive)
        s_exit = states0[..., -1, :]                     # [..., 2]
        # level 2: gather every shard's exit state, combine prefixes
        gathered = _spmd.all_gather(s_exit, axis)        # [S, ..., 2]
        s_in_all = prx.p_einsum("ijkl,j...l->i...k",
                                w.to(gathered.device), gathered)
        s_in = s_in_all[_spmd.axis_index(axis)]          # [..., 2]
        # exact correction, no second scan:
        # s_true[t] = s_local[t] + A^(t+1) @ s_in
        return (states0 + prx.p_einsum("...tij,...j->...ti", cum_a,
                                        s_in))[..., 0]

    @functools.partial(_spmd.shard_map, mesh=mesh, in_specs=spec,
                       out_specs=spec)
    def _run(x_local):
        cur = x_local
        for sec in sections:
            cur = _section(cur, sec)
        return cur

    jfn = _instrumented("sharded_sosfilt", _run)
    return _sharded_guard(
        "sharded_sosfilt",
        lambda: jfn(x),
        lambda: _iir.sosfilt(sos, x),
        mesh, axis)


def sharded_welch(x, mesh, axis: str = "sp", fs: float = 1.0,
                  nperseg: int = 256, noverlap=None, window=None):
    """Sequence-parallel Welch PSD: segments are framed per shard with
    the :func:`sharded_stft` halo pattern, each shard accumulates its
    own masked ``|fft|^2`` sum, and ONE ``psum`` of a ``[bins]`` vector
    per shard produces the global average — the signal is never
    gathered.

    Matches the single-card :func:`veles.simd_tpu_torch.ops.spectral.
    welch` (Hann window, constant per-segment detrend, density
    scaling).  Returns ``(freqs, Pxx)``.
    """
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.parallel import fourier as _fr

    x = _place(x, mesh)
    n = x.shape[-1]
    n_shards = mesh.shape[axis]
    nperseg_c, hop, window_np = sp._welch_args(n, nperseg, noverlap,
                                               window)
    block, halo = _check_stft_sharding(n, nperseg_c, hop, n_shards)
    frames_total = sp.frame_count(n, nperseg_c, hop)
    frames_per_shard = block // hop
    # engine-selected local segment transform (parallel.frame_dft,
    # window folded into the basis on the rdft route)
    local_route = _fr.select_frame_route(nperseg_c)
    obs.record_decision(
        "sharded_welch_local", local_route, n_shards=int(n_shards),
        nperseg=int(nperseg_c), hop=int(hop))
    frame_fn = _fr.frame_rfft_fn(
        local_route, nperseg_c, np.asarray(window_np, np.float32),
        x.device)
    scale_mult = _const(
        sp._onesided_scale(nperseg_c, fs, window_np, "density"), x)
    freqs = np.fft.rfftfreq(nperseg_c, 1.0 / fs)
    in_spec = P(*([None] * (x.dim() - 1) + [axis]))
    out_spec = P(*([None] * (x.dim() - 1) + [None]))

    @functools.partial(_spmd.shard_map, mesh=mesh,
                       in_specs=in_spec, out_specs=out_spec)
    def _run(x_local):
        halo_part = halo_exchange_right(x_local, halo, axis)
        x_ext = torch.cat([x_local, halo_part], dim=-1)
        segs = sp._take_frames(x_ext, nperseg_c,
                               hop)[..., :frames_per_shard, :]
        segs = segs - segs.mean(dim=-1, keepdim=True)
        fx = frame_fn(segs)
        # mask the trailing frames that overhang the global signal end
        # (they exist only so every shard has a uniform frame count)
        gidx = (_spmd.axis_index(axis) * frames_per_shard
                + torch.arange(frames_per_shard, device=fx.device))
        mask = (gidx < frames_total).to(torch.float32)
        local = torch.sum((fx.abs() ** 2) * mask[:, None], dim=-2)
        return _spmd.psum(local, axis) / frames_total

    jfn = _instrumented("sharded_welch", _run)
    pxx = _sharded_guard(
        "sharded_welch",
        lambda: jfn(x) * scale_mult,
        lambda: sp.welch(x, fs=fs, nperseg=nperseg,
                         noverlap=noverlap, window=window)[1],
        mesh, axis)
    return freqs, pxx


def sharded_resample_poly(x, up: int, down: int, mesh,
                          axis: str = "sp", taps=None):
    """Sequence-parallel rational-rate resampling: each shard runs the
    SAME polyphase conv the single card runs
    (``ops.resample._resample_conv``) on its halo-extended block.

    Output ownership follows input ownership: with ``block * up``
    divisible by ``down``, every shard produces exactly
    ``block * up / down`` output samples.  Halos are the filter's
    group-delay reach divided by the upsampling factor (left
    ``ceil(pad_l / up)``, right ``ceil((k - 1 - pad_l) / up)``); a
    negative left padding crops the local window start into alignment,
    so edge shards reproduce the single-card zero-padding exactly.
    Matches :func:`veles.simd_tpu_torch.ops.resample.resample_poly`.
    """
    from veles.simd_tpu_torch.ops import resample as _rs

    x = _place(x, mesh)
    n = x.shape[-1]
    up, down, taps = _rs._normalize_resample_args(n, up, down, taps)
    n_shards = mesh.shape[axis]
    if n % n_shards:
        raise ValueError(f"signal length {n} not divisible into "
                         f"{n_shards} shards (pad first)")
    block = n // n_shards
    if (block * up) % down:
        raise ValueError(
            f"block {block} * up {up} not divisible by down {down} — "
            "output ownership would straddle shards; choose a length "
            "whose per-shard block * up is a multiple of down")
    if up == 1 and down == 1:
        return x
    k = len(taps)
    pad_l = (k - 1) // 2
    hl = -(-pad_l // up)
    hr = -(-max(k - 1 - pad_l, 0) // up)
    if max(hl, hr) > block:
        raise ValueError(
            f"filter halo ({hl} left / {hr} right input samples) "
            f"exceeds the per-shard block ({block}); fewer shards or "
            "shorter taps")
    out_block = block * up // down
    spec = P(*([None] * (x.dim() - 1) + [axis]))

    # negative left padding crops hl*up - pad_l dilated positions,
    # aligning local output 0 with global output s * out_block
    p_lo = pad_l - hl * up
    ext_len = block + hl + hr
    dil = (ext_len - 1) * up + 1
    p_hi = max(0, (out_block - 1) * down + k - (dil + p_lo))

    @functools.partial(_spmd.shard_map, mesh=mesh, in_specs=spec,
                       out_specs=spec)
    def _run(x_local):
        left = halo_exchange_left(x_local, hl, axis)
        right = halo_exchange_right(x_local, hr, axis)
        x_ext = torch.cat([left, x_local, right], dim=-1)
        # the single-card polyphase kernel, padding overridden to the
        # halo-cropping alignment
        return _rs._resample_conv(x_ext, taps, up, down, out_block,
                                  pad=(p_lo, p_hi))

    jfn = _instrumented("sharded_resample_poly", _run)
    return _sharded_guard(
        "sharded_resample_poly",
        lambda: jfn(x),
        lambda: _rs.resample_poly(x, up, down, taps=taps),
        mesh, axis)


def sharded_swt_apply2d(type, order, level, ext, img, mesh,
                        axis: str = "sp"):
    """Undecimated 2D SWT of one row-sharded image — the same
    all-to-all choreography as :func:`sharded_wavelet_apply2d`, without
    the decimation.  All four extensions are exact.  Returns
    ``(ll, lh, hl, hh)``, each full ``[n0, n1]`` — matching
    :func:`veles.simd_tpu_torch.ops.wavelet.stationary_wavelet_apply2d`.

    Requires both dims divisible by ``S``.
    """
    from veles.simd_tpu_torch.ops import wavelet as wv

    img = _place(img, mesh)
    if img.dim() != 2:
        raise ValueError("sharded_swt_apply2d shards one [n0, n1] image")
    n0, n1 = img.shape
    s = mesh.shape[axis]
    if n0 % s or n1 % s:
        raise ValueError(f"image {tuple(img.shape)} must have both dims "
                         f"divisible by {axis}={s}")

    quad = _a2a_quad2d(
        lambda v: wv.stationary_wavelet_apply(type, order, level, ext,
                                              v, simd=True),
        img[None], mesh, axis)
    return tuple(b[0] for b in quad)


def sharded_wavelet_packet_transform2d(type, order, ext, img, levels,
                                       mesh, axis: str = "sp"):
    """2D quad-tree wavelet packets of a row-sharded image: every band
    re-split at every level, all bands batched through ONE shard
    program (two all-to-all rounds) per LEVEL.  Returns the
    ``4^levels`` leaves in the natural ``(ll, lh, hl, hh)`` order of
    :func:`veles.simd_tpu_torch.ops.wavelet.wavelet_packet_transform2d`,
    each ``[n0/2^levels, n1/2^levels]``.

    Requires both dims divisible by ``2^levels * S``.
    """
    from veles.simd_tpu_torch.ops import wavelet as wv

    levels = int(levels)
    if levels < 1:
        raise ValueError("levels must be >= 1")
    img = _place(img, mesh)
    if img.dim() != 2:
        raise ValueError("sharded_wavelet_packet_transform2d shards one "
                         "[n0, n1] image")
    s = mesh.shape[axis]
    n0, n1 = img.shape
    need = (1 << levels) * s
    if n0 % need or n1 % need:
        raise ValueError(
            f"image {tuple(img.shape)} must have both dims divisible by "
            f"2^levels * S = {need}")

    def row_fn(v):
        return wv.wavelet_apply(type, order, ext, v, simd=True)

    stack = img[None]                                # [m, n0, n1]
    for _ in range(levels):
        ll, lh, hl, hh = _a2a_quad2d(row_fn, stack, mesh, axis)
        # leaf index grows a base-4 digit per level, natural
        # (ll, lh, hl, hh) order
        stack = torch.stack([ll, lh, hl, hh], dim=1).reshape(
            (4 * stack.shape[0],) + tuple(ll.shape[1:]))
    return [stack[i] for i in range(stack.shape[0])]


def sharded_order_filter(x, rank: int, kernel_size: int, mesh,
                         axis: str = "sp"):
    """Sequence-parallel rank-order filter: pure halo exchange — each
    shard fetches ``k // 2`` neighbour samples per side and runs the
    single-card rank kernel on its extended block.  Global edge shards
    receive zeros from the open ``ppermute``, which is exactly the
    single-card zero-padding, so the result is the single-card
    :func:`veles.simd_tpu_torch.ops.filters.order_filter`.
    """
    from veles.simd_tpu_torch.ops import filters as fl

    k = fl._check_kernel(kernel_size)
    rank = int(rank)
    if not 0 <= rank < k:
        raise ValueError(f"rank {rank} outside [0, {k})")
    x = _place(x, mesh)
    n = x.shape[-1]
    n_shards = mesh.shape[axis]
    if n % n_shards:
        raise ValueError(f"signal length {n} not divisible into "
                         f"{n_shards} shards (pad first)")
    block = n // n_shards
    half = k // 2
    if half > block:
        raise ValueError(f"kernel halo {half} exceeds the per-shard "
                         f"block {block}")
    spec = P(*([None] * (x.dim() - 1) + [axis]))

    @functools.partial(_spmd.shard_map, mesh=mesh, in_specs=spec,
                       out_specs=spec)
    def _run(x_local):
        left = halo_exchange_left(x_local, half, axis)
        right = halo_exchange_right(x_local, half, axis)
        x_ext = torch.cat([left, x_local, right], dim=-1)
        y = fl._rank_filter(x_ext, k, rank)
        return y[..., half:half + block]

    return _run(x)


def sharded_medfilt(x, kernel_size: int, mesh, axis: str = "sp"):
    """Sequence-parallel median filter (scipy ``medfilt`` semantics) —
    :func:`sharded_order_filter` at the median rank."""
    from veles.simd_tpu_torch.ops import filters as fl

    k = fl._check_kernel(kernel_size)
    return sharded_order_filter(x, k // 2, k, mesh, axis)


def sharded_savgol_filter(x, window_length: int, polyorder: int,
                          mesh, deriv: int = 0, delta: float = 1.0,
                          mode: str = "interp", axis: str = "sp"):
    """Sequence-parallel Savitzky-Golay: the smoothing itself is one
    halo exchange + the local FIR correlation; the edge semantics run
    on the shards that own the edges — ``'constant'`` needs nothing
    (the open halo IS zero padding), ``'nearest'`` substitutes the
    edge shards' halos with replicated end samples, ``'interp'``
    replaces each edge half-window with the polynomial edge fit as a
    precomputed ``[half, window]`` matrix applied to the local end
    window.  Matches the single-card
    :func:`veles.simd_tpu_torch.ops.filters.savgol_filter`.
    """
    from veles.simd_tpu_torch.ops import filters as fl

    w = fl._check_kernel(window_length, "window_length")
    if mode not in ("interp", "constant", "nearest"):
        raise ValueError(f"unknown mode {mode!r}")
    x = _place(x, mesh)
    n = x.shape[-1]
    n_shards = mesh.shape[axis]
    if n % n_shards:
        raise ValueError(f"signal length {n} not divisible into "
                         f"{n_shards} shards (pad first)")
    block = n // n_shards
    half = w // 2
    need = w if mode == "interp" else half
    if need > block:
        raise ValueError(f"window reach {need} exceeds the per-shard "
                         f"block {block}; fewer shards or a shorter "
                         "window")
    taps = _const(fl._savgol_corr_taps(w, polyorder, deriv, delta), x)
    if mode == "interp":
        head_mat, tail_mat = (_const(m, x) for m in
                              fl._savgol_edge_mats(w, polyorder,
                                                   int(deriv),
                                                   float(delta)))
    spec = P(*([None] * (x.dim() - 1) + [axis]))

    @functools.partial(_spmd.shard_map, mesh=mesh, in_specs=spec,
                       out_specs=spec)
    def _run(x_local):
        idx = _spmd.axis_index(axis)
        left = halo_exchange_left(x_local, half, axis)
        right = halo_exchange_right(x_local, half, axis)
        if mode == "nearest":
            if idx == 0:
                left = x_local[..., :1].expand(
                    tuple(x_local.shape[:-1]) + (half,))
            if idx == n_shards - 1:
                right = x_local[..., -1:].expand(
                    tuple(x_local.shape[:-1]) + (half,))
        x_ext = torch.cat([left, x_local, right], dim=-1)
        lhs = x_ext.reshape(-1, 1, x_ext.shape[-1])
        rhs = taps.to(lhs.device)[None, None, :]
        y = prx.p_conv(lhs, rhs)
        y = y.reshape(tuple(x_local.shape[:-1]) + (block,))
        if mode == "interp":
            head = prx.p_einsum("hw,...w->...h", head_mat.to(y.device),
                                x_local[..., :w])
            tail = prx.p_einsum("hw,...w->...h", tail_mat.to(y.device),
                                x_local[..., -w:])
            y = torch.cat(
                [head if idx == 0 else y[..., :half],
                 y[..., half:block - half],
                 tail if idx == n_shards - 1 else y[..., block - half:]],
                dim=-1)
        return y

    return _run(x)


def sharded_lombscargle(t, x, freqs, mesh, axis: str = "sp",
                        weights=None):
    """Sequence-parallel Lomb-Scargle periodogram: the sample axis is
    sharded; each shard evaluates its trig grid slab and TWO ``psum``
    rounds of ``[m]``-vectors produce the global sums (first the tau
    phase sums, then the four projection sums), so the samples are
    never gathered.  Power comes back replicated, matching the
    single-card :func:`veles.simd_tpu_torch.ops.spectral.lombscargle`.

    Any sample count is accepted: indivisible lengths are padded to the
    next shard multiple with ZERO-weighted samples, which drop out of
    every weighted Scargle sum exactly.  ``weights`` is also a public
    argument for per-sample confidence, mirroring the single-card op.
    """
    from veles.simd_tpu_torch.ops.spectral import _check_lombscargle_args

    t, x_np, freqs_np, w_np = _check_lombscargle_args(t, x, freqs,
                                                      weights)
    n_shards = mesh.shape[axis]
    # center in float64 before the f32 cast; the weighted mean ignores
    # padding by construction
    t = t - (w_np @ t) / w_np.sum()
    pad = (-len(t)) % n_shards
    if pad:
        t = np.concatenate([t, np.zeros(pad)])
        x_np = np.concatenate([x_np, np.zeros(pad)])
        w_np = np.concatenate([w_np, np.zeros(pad)])
    tj, xj, fj, wj = (_place(a, mesh) for a in (t, x_np, freqs_np, w_np))

    @functools.partial(_spmd.shard_map, mesh=mesh,
                       in_specs=(P(axis), P(axis), P(), P(axis)),
                       out_specs=P())
    def _run(t_local, x_local, w, wt_local):
        wt = w[:, None] * t_local[None, :]
        sin2 = _spmd.psum(
            torch.sum(wt_local * torch.sin(2 * wt), dim=-1), axis)
        cos2 = _spmd.psum(
            torch.sum(wt_local * torch.cos(2 * wt), dim=-1), axis)
        tau = torch.atan2(sin2, cos2) / 2.0
        arg = wt - tau[:, None]
        c, s = torch.cos(arg), torch.sin(arg)
        xw = wt_local * x_local
        sums = torch.stack([
            torch.sum(xw[None, :] * c, dim=-1),
            torch.sum(xw[None, :] * s, dim=-1),
            torch.sum(wt_local * c * c, dim=-1),
            torch.sum(wt_local * s * s, dim=-1)])
        xc, xs, cc, ss = _spmd.psum(sums, axis)
        return 0.5 * (xc * xc / cc + xs * xs / ss)

    return _run(tj, xj, fj, wj)


def sharded_normalize2d(src, mesh, axis: str = "sp"):
    """Row-sharded u8 plane → f32 [-1, 1] normalization — the
    distributed form of the reference's ``normalize2D``.

    Each shard reduces its row block, ONE ``pmin``/``pmax`` pair of
    scalars rides the collective, and the normalize stays local.
    Preserves the reference's max==min → all-zeros rule, and (like the
    single-card op) accepts any numeric dtype.  Rows are padded to a
    shard multiple internally with wrapped copies of real rows, which
    cannot perturb the global min/max — wrap also covers fewer rows
    than shards.
    """
    src = _place(src, mesh, dtype=None)
    if src.dim() != 2:
        raise ValueError("sharded_normalize2d shards one [h, w] plane")
    h, w = src.shape
    n_shards = mesh.shape[axis]
    pad = (-h) % n_shards
    srcj = src
    if pad:
        srcj = src[torch.arange(h + pad, device=src.device) % h]

    @functools.partial(_spmd.shard_map, mesh=mesh, in_specs=P(axis, None),
                       out_specs=P(axis, None))
    def _run(block):
        v = block.to(torch.float32)
        mn = _spmd.pmin(v.min(), axis)
        mx = _spmd.pmax(v.max(), axis)
        # guard the denominator BEFORE dividing: a flat plane would
        # otherwise manufacture inf/nan that the final where() hides
        diff = torch.where(mx == mn, torch.ones_like(mx), (mx - mn) / 2.0)
        out = (v - mn) / diff - 1.0
        return torch.where(mx == mn, torch.zeros_like(out), out)

    from veles.simd_tpu_torch.ops import normalize as _nm

    jfn = _instrumented("sharded_normalize2d", _run)
    return _sharded_guard(
        "sharded_normalize2d",
        lambda: jfn(srcj)[:h],
        lambda: _nm.normalize2D(src),
        mesh, axis)


def data_parallel(fn, mesh, axis: str = "dp"):
    """Wrap a batched op so its leading batch axis is sharded over
    ``mesh[axis]``: each shard runs ``fn`` on its slice of the batch
    (which must divide by the axis size) and the results are
    concatenated back.

    >>> dwt = data_parallel(lambda x: wavelet_apply(DAUB, 8, PERIODIC, x),
    ...                     mesh)
    >>> hi, lo = dwt(batch_of_signals)   # batch split across shards
    """
    jfn = obs.instrumented_jit(fn, op="data_parallel", route="jit")

    def wrapper(batch, *args, **kwargs):
        batch = _place(batch, mesh, dtype=None)
        spec = P(axis, *([None] * (batch.dim() - 1)))
        # guarded (bounded retry on transient mesh faults); no
        # single-card fallback exists for a user-supplied fn, so
        # exhaustion re-raises typed
        return faults.guarded(
            "parallel.data_parallel",
            lambda: _spmd.shard_map(
                lambda b: jfn(b, *args, **kwargs), mesh,
                in_specs=spec, out_specs=spec)(batch))

    return wrapper
