"""Ragged segment packing: many short signals in one padded dispatch.

The port of ``veles.simd_tpu.ops.segments``.  Padding every request up
to a pow-of-two bucket wastes device time under mixed-length traffic;
this module recovers it along the **sample axis**: several short
signals are concatenated into one packed row with a segment plan
(offsets + per-segment extents — the flat representation of a
segment-ID mask), dispatched as ONE batched call, and sliced back per
segment.

Two ops are naturally segment-parallel:

* **stft** — frame ``f`` of segment ``i`` at packed offset ``off_i`` is
  packed frame ``off_i/hop + f`` with identical contents, provided
  offsets are hop multiples (each segment's packed stride is
  ``ceil(n_i/hop)*hop``).  Frames that straddle into a neighbour are
  computed and discarded.  The packed rows take the fused STFT kernel
  (K4) where its gate admits the geometry, else
  :func:`veles.simd_tpu_torch.ops.batched.batched_stft`'s basis matmul
  or FFT — never through ``stft``'s own guard, so that a fault reaches
  this module's policy.
* **convolve** — direct-form outputs are per-sample windows of width
  ``m``: a guard gap of ``m-1`` zeros between segments makes output
  slice ``[off_i, off_i+n_i+m-1)`` depend on segment ``i``'s samples
  (plus exact zeros) only.  The packed rows go through
  ``convolve._direct``: the filter-bank kernel (K2) from 8 rows and up
  to 256 taps on the card, else ``conv1d``.

The extra terms are exact zeros, so a packed result equals the
unpacked dispatch of the same route up to the route's own summation
order; a segment alone (one row) may take another route than the
packed rows (below K2's 8 rows, ``conv1d``), so the two agree to
rounding, not bit for bit.

Fault semantics per packed batch: the whole dispatch runs behind
``faults.breaker_guarded`` on the ``segments.dispatch`` site.  When
the packed dispatch exhausts its retries the fallback is NOT a whole-
batch oracle — it re-dispatches **per segment** (``segments.segment``
site, zero retries), so one poisoned segment degrades to its oracle
alone while co-packed neighbours still get device answers.

Route selection goes through the ``segments`` candidate table
(:func:`veles.simd_tpu_torch.runtime.routing.family`).  Results are
NumPy lists, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.ops import batched
from veles.simd_tpu_torch.ops import convolve as cv
from veles.simd_tpu_torch.ops import spectral as sp
from veles.simd_tpu_torch.runtime import faults, routing
from veles.simd_tpu_torch.utils.config import resolve_simd
from veles.simd_tpu_torch.utils.platform import as_f32

__all__ = [
    "plan_pack", "stft_stride", "convolve_stride",
    "packed_stft", "packed_convolve",
]


# Candidate table for the segment-packed dispatch shapes.  Routes key
# which packing geometry applies (frame-aligned for the frame-DFT ops,
# guard-gapped for MAC-window ops); the terminal route doubles as the
# table's fallback so selection never dead-ends.
_SEG_FAMILY = routing.family("segments", (
    routing.Route(
        "stft_pack",
        predicate=lambda op, **_: op == "stft",
        doc="hop-aligned concatenation, straddle frames discarded "
            "(per-frame DFT routes need no guard samples)"),
    routing.Route(
        "convolve_pack",
        doc="guard gap of m-1 zeros between segments; direct-form "
            "MAC windows never cross a gap"),
))

_PACK_OPS = ("stft", "convolve")


def _select_pack_route(op: str) -> str:
    """The packing-geometry route for ``op``, from the ``segments``
    candidate table (single home of the packing layouts)."""
    if op not in _PACK_OPS:
        raise ValueError(f"op must be one of {_PACK_OPS}, got {op!r}")
    return _SEG_FAMILY.static_select(op=str(op))


def stft_stride(n: int, hop: int) -> int:
    """Packed stride of a length-``n`` stft segment: ``n`` rounded up
    to a hop multiple, so every segment offset is a hop multiple and
    packed frame ``off/hop + f`` is exactly local frame ``f``."""
    n, hop = int(n), int(hop)
    return -(-n // hop) * hop


def convolve_stride(n: int, m: int) -> int:
    """Packed stride of a length-``n`` convolve segment against an
    ``m``-tap filter: the segment plus its ``m-1``-zero guard gap (a
    full-convolution output window never reaches past it)."""
    return int(n) + int(m) - 1


def plan_pack(strides, width: int | None = None) -> tuple:
    """First-fit-decreasing packing of segment ``strides`` into rows
    of a common ``width``; returns ``(width, rows, placements)`` with
    ``placements[i] = (row, offset)`` in segment order.

    ``width`` defaults to the pow-of-two bucket of the largest stride
    (:func:`~veles.simd_tpu_torch.runtime.routing.pow2_bucket`), so the
    set of dispatched geometries stays logarithmic: short segments
    co-pack several to a row while the longest still fits.  Placement
    order is largest-first (the classic FFD fill bound) but ties and
    the returned placements stay in segment order, so the plan is
    deterministic."""
    strides = [int(s) for s in strides]
    if any(s < 1 for s in strides):
        raise ValueError("strides must be positive")
    if not strides:
        return 0, 0, []
    need = max(strides)
    width = routing.pow2_bucket(need) if width is None else int(width)
    if width < need:
        raise ValueError(
            f"width {width} < largest segment stride {need}")
    order = sorted(range(len(strides)), key=lambda i: -strides[i])
    fill: list = []
    placements: list = [None] * len(strides)
    for i in order:
        s = strides[i]
        for row, used in enumerate(fill):
            if used + s <= width:
                placements[i] = (row, used)
                fill[row] = used + s
                break
        else:
            placements[i] = (len(fill), 0)
            fill.append(s)
    return width, len(fill), placements


def _as_segments(segments) -> list:
    segs = []
    segments = list(segments)
    if not segments:
        raise ValueError("need at least one segment to pack")
    for i, s in enumerate(segments):
        s = cv._host(s).astype(np.float32, copy=False)
        if s.ndim != 1 or s.shape[0] < 1:
            raise ValueError(
                f"segment {i} must be a nonempty 1-D signal, got "
                f"shape {s.shape}")
        segs.append(s)
    return segs


def _pack(segs, width, rows, placements) -> np.ndarray:
    # EXACT rows, no pow2 row padding: the whole point of packing is a
    # truthful dispatched footprint (rows x width IS what runs)
    packed = np.zeros((rows, width), np.float32)
    for s, (row, off) in zip(segs, placements):
        packed[row, off:off + s.shape[0]] = s
    return packed


def _stft_rows(x, frame_length: int, hop: int, window):
    """STFT of the host rows ``x[rows, n]`` with no guard of its own,
    so that the ``segments`` sites are the only guards on the path:
    the ``cuda_fused`` route runs the kernel route itself (with its
    demotion), where ``batched_stft`` would hand it to ``stft``, whose
    guard answers a device loss from the oracle unseen by the
    ``degraded`` flags; the other routes run ``batched_stft``'s
    unguarded handles."""
    rows, n = x.shape
    frames = sp.frame_count(n, frame_length, hop)
    route = sp._STFT_FAMILY.select(
        frame_length=int(frame_length), hop=int(hop), frames=int(frames),
        cuda=sp._operand_on_cuda(x), probe_operand=x,
        tune_geom=lambda: sp._stft_tune_class(frame_length, hop, frames,
                                              rows))
    if route == "cuda_fused":
        return sp._run_stft_cuda(as_f32(x), window, frame_length, hop)
    return batched.batched_stft(x, frame_length, hop, window=window,
                                simd=True)


def _salvage_per_segment(segs, device_one, oracle_one):
    """The packed dispatch's degradation path: re-dispatch each
    segment ALONE on the device (``segments.segment`` site, zero
    retries — the packed attempt already spent the retry budget), each
    falling to its own oracle independently.  Returns ``(outputs,
    degraded_flags)`` — only the segments that actually landed on the
    oracle are flagged."""
    outs, flags = [], []
    for i, seg in enumerate(segs):
        box = {"degraded": False}

        def oracle(seg=seg, box=box):
            box["degraded"] = True
            return oracle_one(seg)

        out = faults.guarded(
            "segments.segment",
            lambda seg=seg: device_one(seg),
            fallback=oracle, fallback_name="oracle",
            retries=0, subsite=str(i))
        outs.append(cv._host(out))
        flags.append(box["degraded"])
    return outs, flags


def packed_stft(segments, frame_length: int, hop: int, window=None,
                simd=None, *, key=None, budget_s=None, on_fault=None,
                width: int | None = None) -> tuple:
    """STFT of variable-length ``segments`` packed along the sample
    axis into shared rows — ONE batched dispatch for the whole ragged
    set.  Returns ``(outputs, degraded)``: ``outputs[i]`` is complex64
    NumPy ``[frames_i, bins]`` (the unpacked
    :func:`~veles.simd_tpu_torch.ops.batched.batched_stft` of segment
    ``i`` up to the route's rounding), ``degraded[i]`` True iff segment
    ``i`` was answered by its oracle after the fault policy gave up on
    it.

    ``key`` namespaces the ``segments.dispatch`` circuit breaker;
    ``budget_s`` bounds the retry loop; ``on_fault`` observes
    retry/degrade decisions.
    """
    frame_length, hop = int(frame_length), int(hop)
    segs = _as_segments(segments)
    for s in segs:
        sp._check_stft_args(s.shape[0], frame_length, hop)
    window = sp._resolve_window(window, frame_length)
    route = _select_pack_route("stft")
    if not resolve_simd(simd, op="packed_stft"):
        return ([sp.stft_na(s, frame_length, hop, window)
                 .astype(np.complex64) for s in segs],
                [False] * len(segs))
    strides = [stft_stride(s.shape[0], hop) for s in segs]
    width, rows, placements = plan_pack(strides, width=width)
    packed = _pack(segs, width, rows, placements)
    fcounts = [sp.frame_count(s.shape[0], frame_length, hop)
               for s in segs]

    def device():
        with obs.span("segments.pack.dispatch", op="stft",
                      route=route, rows=rows, width=width,
                      segments=len(segs)):
            ys = cv._host(_stft_rows(packed, frame_length, hop, window))
        return ([np.ascontiguousarray(
                    ys[row, off // hop: off // hop + fc])
                 for (row, off), fc in zip(placements, fcounts)],
                [False] * len(segs))

    def salvage():
        return _salvage_per_segment(
            segs,
            device_one=lambda seg: _stft_rows(
                seg[None, :], frame_length, hop, window)[0],
            oracle_one=lambda seg: sp.stft_na(
                seg, frame_length, hop, window).astype(np.complex64))

    return faults.breaker_guarded(
        "segments.dispatch",
        key if key is not None else ("stft", frame_length, hop, width),
        device, fallback=salvage, fallback_name="per_segment",
        subsite="stft", budget_s=budget_s, on_fault=on_fault)


def packed_convolve(segments, h, simd=None, *, key=None, budget_s=None,
                    on_fault=None, width: int | None = None) -> tuple:
    """Full convolution of variable-length ``segments`` against one
    filter ``h``, packed along the sample axis with ``m-1``-zero guard
    gaps — ONE direct-form dispatch for the whole ragged set.  Returns
    ``(outputs, degraded)``: ``outputs[i]`` is float32 NumPy
    ``[n_i + m - 1]``, ``degraded`` as in :func:`packed_stft`.

    The packed rows always run the direct form (per-output windows
    respect the guard gaps exactly; an FFT is global over a row and
    would leak a neighbour's rounding into a segment's samples, so it
    is never used here)."""
    h = cv._host(h).astype(np.float32, copy=False)
    if h.ndim != 1 or h.shape[0] < 1:
        raise ValueError(f"h must be a nonempty 1-D filter, got "
                         f"shape {h.shape}")
    m = int(h.shape[0])
    segs = _as_segments(segments)
    route = _select_pack_route("convolve")
    if not resolve_simd(simd, op="packed_convolve"):
        return ([cv.convolve_na(s, h) for s in segs],
                [False] * len(segs))
    strides = [convolve_stride(s.shape[0], m) for s in segs]
    width, rows, placements = plan_pack(strides, width=width)
    packed = _pack(segs, width, rows, placements)

    def device():
        with obs.span("segments.pack.dispatch", op="convolve",
                      route=route, rows=rows, width=width,
                      segments=len(segs)):
            ys = cv._host(cv._direct(*cv._operands(packed, h)))
        return ([np.ascontiguousarray(
                    ys[row, off:off + s.shape[0] + m - 1])
                 for s, (row, off) in zip(segs, placements)],
                [False] * len(segs))

    def salvage():
        return _salvage_per_segment(
            segs,
            device_one=lambda seg: cv._direct(
                *cv._operands(seg[None, :], h))[0],
            oracle_one=lambda seg: cv.convolve_na(seg, h))

    return faults.breaker_guarded(
        "segments.dispatch",
        key if key is not None else ("convolve", m, width),
        device, fallback=salvage, fallback_name="per_segment",
        subsite="convolve", budget_s=budget_s, on_fault=on_fault)
