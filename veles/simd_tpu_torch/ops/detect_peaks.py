"""1D local-extrema extraction and scipy-style peak analysis.

The port of ``veles.simd_tpu.ops.detect_peaks`` (rebuild of the
reference's ``src/detect_peaks.c`` + ``inc/simd/detect_peaks.h``).
Semantics kept exactly from ``check_peak`` (``src/detect_peaks.c:41-56``):
an interior sample ``c`` at index ``i ∈ [1, size-2]`` is an extremum
iff ``(c - prev)·(c - next) > 0`` (strict — plateaus are never peaks),
reported as a maximum when ``c > prev`` and a minimum when ``c <
prev``, filtered by the ``ExtremumType`` bitmask (MAXIMUM=1,
MINIMUM=2, BOTH=3).

* :func:`detect_peaks` — the user-facing API: mask and compaction on
  the device, the host slices the compacted prefix; returns
  ``(positions, values)`` NumPy arrays like the C API.
* :func:`detect_peaks_fixed` — the fixed-shape form: ``(positions,
  values, count)`` tensors with a static ``max_peaks`` bound,
  positions beyond ``count`` filled with -1.  Compaction by
  ``torch.topk`` of the peak indices while ``max_peaks`` is at most a
  quarter of the signal, else by a rank scatter (the JAX package's two
  routes and crossover).
* :func:`find_peaks`, :func:`peak_prominences`, :func:`peak_widths` —
  scipy's semantics, the saddle searches as vectorized binary descents
  over log2(n) doubling tables on the device (indices int64).
"""

from __future__ import annotations

import enum

import numpy as np
import torch
import torch.nn.functional as F

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.utils import benchmark as bm
from veles.simd_tpu_torch.utils.config import resolve_simd
from veles.simd_tpu_torch.utils.platform import as_f32, as_tensor

__all__ = ["ExtremumType", "detect_peaks", "detect_peaks_na",
           "detect_peaks_fixed", "find_peaks", "peak_prominences",
           "peak_prominences_na", "peak_widths", "peak_widths_na"]


class ExtremumType(enum.IntFlag):
    """``ExtremumType`` (``inc/simd/detect_peaks.h:41-45``)."""

    MAXIMUM = 1
    MINIMUM = 2
    BOTH = 3


# the instrumented cores, under the JAX package's names; their work
# counts the operations a sample of the least pass (two differences,
# a product and a compare for the mask; two nearest-greater searches
# and two range minima for a prominence) and 4 bytes an output value
def _per_sample(ops, out_values):
    return lambda x, *_: bm.elementwise_work(ops, 4 * out_values, x)


@obs.instrumented_jit(work=lambda data, type: (
    4.0 * data.numel(), float(data.nbytes) + data.numel()))
def _peak_mask(data, type):
    """Boolean mask over the full signal (interior-only can be True)."""
    prev = data[..., :-2]
    curr = data[..., 1:-1]
    nxt = data[..., 2:]
    d1 = curr - prev
    d2 = curr - nxt
    is_ext = d1 * d2 > 0
    want = torch.zeros_like(is_ext)
    if type & ExtremumType.MAXIMUM:
        want = want | (d1 > 0)
    if type & ExtremumType.MINIMUM:
        want = want | (d1 < 0)
    return F.pad(is_ext & want, (1, 1))


# compaction-route crossover (the JAX package's): top-k while
# max_peaks <= n/4, the rank scatter at larger capacities
_TOPK_CAP_FRACTION = 4


def _compact_topk(mask, data, max_peaks):
    """Small-capacity compaction: peak indices are the top
    ``max_peaks`` of ``n - idx`` over peaks only, which yields them in
    ascending order."""
    n = mask.shape[-1]
    idx = torch.arange(n, device=data.device)
    keys = torch.where(mask, idx, n)              # non-peaks sort last
    vals_k = torch.topk(n - keys, max_peaks, dim=-1).values
    pos = n - vals_k                              # ascending indices
    count = torch.sum(mask, dim=-1, dtype=torch.int32)
    valid = torch.arange(max_peaks, device=data.device) < count[..., None]
    positions = torch.where(valid, pos, -1).to(torch.int32)
    values = torch.where(
        valid, torch.take_along_dim(data, pos.clamp(0, n - 1), dim=-1),
        torch.zeros((), dtype=data.dtype, device=data.device))
    return positions, values, count


def _compact_scatter(mask, data, max_peaks):
    """Rank-scatter compaction: each peak's slot is its rank among
    peaks (a cumsum of the mask); everything else lands in a trash
    slot that is sliced off, so the ranks never collide."""
    n = mask.shape[-1]
    rows_mask = mask.reshape(-1, n)
    rows_data = data.reshape(-1, n)
    idx = torch.arange(n, device=data.device).expand_as(rows_mask)
    rank = torch.cumsum(rows_mask, dim=-1) - 1
    dest = torch.where(rows_mask & (rank < max_peaks), rank, max_peaks)
    positions = torch.full((rows_mask.shape[0], max_peaks + 1), -1,
                           dtype=torch.int64, device=data.device)
    positions.scatter_(-1, dest, idx)
    values = torch.zeros((rows_mask.shape[0], max_peaks + 1),
                         dtype=data.dtype, device=data.device)
    values.scatter_(-1, dest, rows_data)
    out_shape = data.shape[:-1] + (max_peaks,)
    return (positions[:, :max_peaks].to(torch.int32).reshape(out_shape),
            values[:, :max_peaks].reshape(out_shape),
            torch.sum(mask, dim=-1, dtype=torch.int32))


@obs.instrumented_jit(work=lambda data, type, max_peaks: (
    5.0 * data.numel(),
    float(data.nbytes) + (8.0 * max_peaks + 4.0) * (
        data.numel() // max(1, data.shape[-1]))))
def _peaks_fixed(data, type, max_peaks):
    mask = _peak_mask(data, type)
    if max_peaks * _TOPK_CAP_FRACTION <= data.shape[-1]:
        return _compact_topk(mask, data, max_peaks)
    return _compact_scatter(mask, data, max_peaks)


def detect_peaks_fixed(data, type=ExtremumType.BOTH, max_peaks=None):
    """Fixed-capacity peak extraction.

    Returns ``(positions[int32, ..., max_peaks], values[...,
    max_peaks], count[...])``; unused slots hold position -1 / value 0.
    ``max_peaks`` defaults to the worst case ``n - 2`` (an alternating
    signal makes every interior point an extremum).  A caller-supplied
    ``max_peaks`` is honored exactly — slots beyond ``n - 2`` are
    simply always empty.
    """
    data = as_tensor(data)
    n = data.shape[-1]
    if n < 3:
        raise ValueError("size must be > 2 (src/detect_peaks.c:64 contract)")
    if max_peaks is None:
        # worst case: every interior point (alternating signal)
        max_peaks = n - 2
    return _peaks_fixed(data, ExtremumType(int(type)), int(max_peaks))


def detect_peaks_na(data, type=ExtremumType.BOTH):
    """NumPy oracle (``src/detect_peaks.c:128-139`` scalar loop).

    Returns ``(positions, values)`` 1D arrays (1D input only, like the C
    API)."""
    data = np.asarray(data, np.float32)
    if data.ndim != 1:
        raise ValueError("oracle path is 1D like the C API")
    if data.shape[-1] < 3:
        raise ValueError("size must be > 2 (src/detect_peaks.c:64 contract)")
    positions, values = [], []
    t = ExtremumType(int(type))
    for i in range(1, len(data) - 1):
        d1 = data[i] - data[i - 1]
        d2 = data[i] - data[i + 1]
        if d1 * d2 > 0:
            if (d1 > 0 and t & ExtremumType.MAXIMUM) or \
                    (d1 < 0 and t & ExtremumType.MINIMUM):
                positions.append(i)
                values.append(data[i])
    return (np.asarray(positions, np.int32), np.asarray(values, np.float32))


def detect_peaks(data, type=ExtremumType.BOTH, simd=None):
    """User-facing API (``detect_peaks``, ``inc/simd/detect_peaks.h:47-60``):
    returns variable-length ``(positions, values)``."""
    if not resolve_simd(simd, op="detect_peaks"):
        return detect_peaks_na(data, type)
    data = as_tensor(data)
    if data.ndim != 1:
        raise ValueError("detect_peaks is 1D; use detect_peaks_fixed for "
                         "batched fixed-shape extraction")
    if data.shape[-1] < 3:
        raise ValueError("size must be > 2 (src/detect_peaks.c:64 contract)")
    # compaction happens on the device; the host only slices the
    # already-compacted prefix
    positions, values, count = _peaks_fixed(
        data, ExtremumType(int(type)), data.shape[-1] - 2)
    k = int(count)
    return (positions[:k].cpu().numpy().astype(np.int32),
            values[:k].cpu().numpy().astype(np.float32))


# ---------------------------------------------------------------------------
# scipy-style peak analysis (prominences + filtered find_peaks)
# ---------------------------------------------------------------------------


def _build_sparse_tables(x):
    """Doubling tables ``t[k][i] = op(x[i : i + 2^k])`` for max and
    min, built with shifted elementwise ops."""
    n = x.shape[-1]
    levels = max(1, int(np.ceil(np.log2(max(n, 2)))))
    maxes, mins = [x], [x]
    for k in range(1, levels + 1):
        half = 1 << (k - 1)
        prev_max, prev_min = maxes[-1], mins[-1]
        shifted_max = F.pad(prev_max[half:], (0, half), value=-np.inf)
        shifted_min = F.pad(prev_min[half:], (0, half), value=np.inf)
        maxes.append(torch.maximum(prev_max, shifted_max))
        mins.append(torch.minimum(prev_min, shifted_min))
    return maxes, mins


def _scan_while(tables, thresh, side, op):
    """For every i, the length of the maximal run adjacent to i on
    ``side`` whose windowed aggregate satisfies ``op(agg, thresh[i])``:
    a vectorized binary descent over the doubling tables, log2(n)
    gather passes.

    ``op(window_max, x[i]) = max <= x[i]`` finds the nearest strictly
    greater sample (prominence); ``op(window_min, h[i]) = min > h[i]``
    finds the nearest sample at-or-below an evaluation height (widths).
    """
    n = tables[0].shape[-1]
    idx = torch.arange(n, device=thresh.device)
    span = torch.zeros(n, dtype=torch.int64, device=thresh.device)
    for k in range(len(tables) - 1, -1, -1):
        width = 1 << k
        if side == "left":
            start = idx - span - width
            ok = start >= 0
        else:
            start = idx + span + 1
            ok = start + width <= n
        agg = tables[k][start.clamp(0, n - 1)]
        grow = ok & op(agg, thresh)
        span = span + torch.where(grow, width, 0)
    return span  # first violating sample at distance span+1 (or edge)


def _nearest_greater(x, maxes, side):
    """Distance to the nearest strictly-greater sample on ``side`` (or
    to the signal edge when none exists)."""
    return _scan_while(maxes, x, side, lambda agg, t: agg <= t)


def _range_min(mins, a, b):
    """Range minimum over [a, b) (b > a) with the two-window
    sparse-table query."""
    n = mins[0].shape[-1]
    m = torch.clamp(b - a, min=1)
    # floor(log2(m)) via the float exponent (exact for m < 2^24)
    k = torch.frexp(m.to(torch.float32))[1].to(torch.int64) - 1
    k = k.clamp(0, len(mins) - 1)
    stacked = torch.stack(mins)  # [levels+1, n]
    left = stacked[k, a.clamp(0, n - 1)]
    right = stacked[k, (b - (1 << k)).clamp(0, n - 1)]
    return torch.minimum(left, right)


def _prom_core(x):
    """Shared saddle search: ``(mins, lspan, rspan, prom)`` for every
    index treated as a peak (garbage at non-peaks — callers gather at
    real peak positions)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    maxes, mins = _build_sparse_tables(x)
    lspan = _nearest_greater(x, maxes, "left")
    rspan = _nearest_greater(x, maxes, "right")
    # min over the open interval between the peak and its higher
    # neighbour (clamped at the signal edges)
    lmin = _range_min(mins, idx - lspan, idx)
    rmin = _range_min(mins, idx + 1, idx + rspan + 1)
    return mins, lspan, rspan, x - torch.maximum(lmin, rmin)


@obs.instrumented_jit(work=_per_sample(4, 1))
def _prominences_xla(x):
    return _prom_core(x)[3]


@obs.instrumented_jit(work=_per_sample(4, 3))
def _prom_spans_xla(x):
    """``(lspan, rspan, prom)`` for every index: the spans bound the
    saddle intervals so the host can recover scipy's base positions."""
    return _prom_core(x)[1:]


def _bases_from_spans(x_np, peaks, lspan, rspan):
    """scipy's ``left_bases``/``right_bases`` from the device-computed
    saddle spans: the min of each side interval, ties resolved to the
    position nearest the peak (scipy walks outward updating on strict
    ``<``, so the closest occurrence of the minimum wins)."""
    lb = np.empty(len(peaks), np.int64)
    rb = np.empty(len(peaks), np.int64)
    for j, p in enumerate(np.asarray(peaks, np.int64)):
        a = p - int(lspan[j])
        if a < p:
            seg = x_np[a:p]
            lb[j] = a + (len(seg) - 1 - int(np.argmin(seg[::-1])))
        else:
            lb[j] = p
        b = p + int(rspan[j])
        if b > p:
            rb[j] = p + 1 + int(np.argmin(x_np[p + 1:b + 1]))
        else:
            rb[j] = p
    return lb, rb


def _prominences_bases_na(x, peaks):
    """Float64 oracle: (prominences, left_bases, right_bases) with
    scipy's outward-walk tie semantics (closest minimum wins)."""
    x = np.asarray(x, np.float64)
    n = len(x)
    prom = np.empty(len(peaks))
    lb = np.empty(len(peaks), np.int64)
    rb = np.empty(len(peaks), np.int64)
    for j, p in enumerate(np.asarray(peaks, np.int64)):
        v = x[p]
        i, lmin, lbase = p - 1, v, p
        while i >= 0 and x[i] <= v:
            if x[i] < lmin:
                lmin, lbase = x[i], i
            i -= 1
        i, rmin, rbase = p + 1, v, p
        while i < n and x[i] <= v:
            if x[i] < rmin:
                rmin, rbase = x[i], i
            i += 1
        prom[j] = v - max(lmin, rmin)
        lb[j], rb[j] = lbase, rbase
    return prom, lb, rb


def _check_peaks(x, peaks):
    peaks = np.asarray(peaks, np.int64)
    n = np.shape(x)[-1]
    if peaks.size and (peaks.min() < 0 or peaks.max() >= n):
        raise ValueError("peak index out of range")
    return peaks


def peak_prominences(x, peaks, simd=None):
    """Prominence of each peak (scipy's ``peak_prominences`` wlen=None
    semantics): height above the higher of the two key saddles — the
    lowest points separating the peak from its nearest higher samples
    (or the signal edges).  On the device every peak's saddle search
    runs in parallel as a binary descent over doubling tables.
    """
    peaks = _check_peaks(x, peaks)
    if resolve_simd(simd, op="detect_peaks"):
        prom = _prominences_xla(as_f32(x))
        return prom[torch.as_tensor(peaks, device=prom.device)]
    return peak_prominences_na(x, peaks).astype(np.float32)


def peak_prominences_na(x, peaks):
    """NumPy float64 oracle twin (textbook per-peak saddle walk).

    Saddles start at the peak's own value: an empty walk (the
    neighbour is already higher) gives prominence 0, matching scipy
    and the device path for non-peak indices.
    """
    return _prominences_bases_na(x, peaks)[0]


@obs.instrumented_jit(work=_per_sample(10, 7))
def _widths_xla(x, rel_height):
    """(widths, h_eval, left_ip, right_ip, prom, lspan, rspan) for
    every index treated as a peak (garbage at non-peaks — callers
    gather at peak positions)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    mins, lspan, rspan, prom = _prom_core(x)
    h_eval = x - np.float32(rel_height) * prom
    # nearest sample at-or-below h_eval on each side, clamped to the
    # prominence span: the crossing lies inside it for rel_height < 1,
    # and the clamp bounds the damage if f32 rounding ever pushes
    # h_eval below the saddle value
    lrun = torch.minimum(
        _scan_while(mins, h_eval, "left", lambda agg, t: agg > t), lspan)
    rrun = torch.minimum(
        _scan_while(mins, h_eval, "right", lambda agg, t: agg > t),
        rspan)
    li = (idx - lrun - 1).clamp(0, n - 1)   # x[li] <= h_eval
    ri = (idx + rrun + 1).clamp(0, n - 1)
    xl, xl1 = x[li], x[(li + 1).clamp(0, n - 1)]
    xr, xr1 = x[ri], x[(ri - 1).clamp(0, n - 1)]
    # linear interpolation of the crossing (scipy's formula); guarded
    # where the stop sample already sits exactly at h_eval or the run
    # hit the signal edge
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    lfrac = torch.where(xl1 != xl, (h_eval - xl) / (xl1 - xl), zero)
    rfrac = torch.where(xr1 != xr, (h_eval - xr) / (xr1 - xr), zero)
    hit_edge_l = (idx - lrun) <= 0
    hit_edge_r = (idx + rrun) >= n - 1
    crossed_l = (xl < h_eval) & ~hit_edge_l
    crossed_r = (xr < h_eval) & ~hit_edge_r
    left_ip = torch.where(crossed_l, li + lfrac,
                          torch.where(hit_edge_l, zero, li.to(x.dtype)))
    right_ip = torch.where(crossed_r, ri - rfrac,
                           torch.where(hit_edge_r, zero + (n - 1),
                                       ri.to(x.dtype)))
    # the width as the sum of the crossings' distances from the peak:
    # small numbers, so it keeps float32's relative precision at any n
    # (right_ip - left_ip near index 2^20 keeps only 1/16 of a sample)
    dl = (idx - li).to(x.dtype)
    dr = (ri - idx).to(x.dtype)
    width = (torch.where(crossed_l, dl - lfrac,
                         torch.where(hit_edge_l, idx.to(x.dtype), dl))
             + torch.where(crossed_r, dr - rfrac,
                           torch.where(hit_edge_r,
                                       (n - 1 - idx).to(x.dtype), dr)))
    # prom + spans ride along: find_peaks with prominence and width
    # conditions then needs only this one device pass
    return (width, h_eval, left_ip, right_ip, prom, lspan, rspan)


def _check_rel_height(rel_height) -> float:
    rel_height = float(rel_height)
    if not 0.0 <= rel_height < 1.0:
        raise ValueError("rel_height must be in [0, 1) "
                         "(1.0 and above are not supported)")
    return rel_height


def peak_widths(x, peaks, rel_height: float = 0.5, simd=None):
    """Width of each peak at ``rel_height`` of its prominence (scipy's
    ``peak_widths`` with wlen=None): the distance between the linearly
    interpolated crossings of ``x[peak] - rel_height * prominence`` on
    either side.  Returns ``(widths, width_heights, left_ips,
    right_ips)``.  ``rel_height`` must be in [0, 1), so the crossings
    lie inside the peak's prominence interval and the search runs as
    parallel table descents.
    """
    rel_height = _check_rel_height(rel_height)
    peaks = _check_peaks(x, peaks)
    if resolve_simd(simd, op="detect_peaks"):
        w, h, li, ri = _widths_xla(as_f32(x), rel_height)[:4]
        pk = torch.as_tensor(peaks, device=w.device)
        return w[pk], h[pk], li[pk], ri[pk]
    return tuple(a.astype(np.float32)
                 for a in peak_widths_na(x, peaks, rel_height))


def peak_widths_na(x, peaks, rel_height: float = 0.5, prom=None):
    """NumPy float64 oracle twin (sequential crossing walk), with the
    same ``rel_height`` in [0, 1) contract as the device path.
    ``prom`` accepts already-computed prominences."""
    rel_height = _check_rel_height(rel_height)
    x = np.asarray(x, np.float64)
    n = len(x)
    if prom is None:
        prom = peak_prominences_na(x, peaks)
    out = np.zeros((4, len(peaks)))
    for j, p in enumerate(np.asarray(peaks, np.int64)):
        h = x[p] - float(rel_height) * prom[j]
        i = p
        while i > 0 and x[i] > h:
            i -= 1
        lip = float(i)
        if x[i] < h:
            lip += (h - x[i]) / (x[i + 1] - x[i])
        i = p
        while i < n - 1 and x[i] > h:
            i += 1
        rip = float(i)
        if x[i] < h:
            rip -= (h - x[i]) / (x[i - 1] - x[i])
        out[:, j] = (rip - lip, h, lip, rip)
    return tuple(out)


def _minmax(spec):
    if isinstance(spec, np.ndarray):
        if spec.shape == (2,):
            return float(spec[0]), float(spec[1])
        raise ValueError(
            "array conditions must have shape (2,) = (min, max); "
            "scipy's per-peak condition arrays are not supported")
    if isinstance(spec, (tuple, list)):
        return spec[0], spec[1] if len(spec) > 1 else None
    return spec, None


def _interval_keep(values, spec):
    lo, hi = _minmax(spec)
    keep = np.ones(len(values), bool)
    if lo is not None:
        keep &= values >= lo
    if hi is not None:
        keep &= values <= hi
    return keep


def find_peaks(x, height=None, threshold=None, distance=None,
               prominence=None, width=None, rel_height: float = 0.5,
               simd=None):
    """Local maxima filtered by properties (scipy's ``find_peaks`` for
    the height/threshold/distance/prominence/width conditions).

    Returns ``(peaks, properties)`` — ``peaks`` a host int array of
    indices, ``properties`` holding ``peak_heights`` /
    ``left_thresholds`` / ``right_thresholds`` / ``prominences`` /
    ``left_bases`` / ``right_bases`` for whichever filters were
    requested (``width`` adds ``widths`` / ``width_heights`` /
    ``left_ips`` / ``right_ips``, measured at ``rel_height`` of the
    prominence; ``prominences`` is attached whenever either the
    prominence or width condition is given, as in scipy).  Deviations
    from scipy: plateau peaks are excluded (the reference's strict
    ``check_peak`` rule); ``wlen`` and per-peak condition arrays are
    not offered (a length-2 array/tuple is a ``(min, max)`` interval).
    The peak mask and the prominence pass run on the device; the cheap
    per-peak bookkeeping runs on the host, mirroring scipy's algorithm.
    """
    x_np = (x.cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x)).astype(np.float32)
    if x_np.ndim != 1:
        raise ValueError("find_peaks needs a 1D signal")
    use = resolve_simd(simd, op="detect_peaks")
    if use:
        x_dev = as_f32(x) if isinstance(x, torch.Tensor) else as_f32(x_np)
        # _peak_mask is already full-length (borders padded False)
        mask = _peak_mask(x_dev, ExtremumType.MAXIMUM)
        peaks = torch.nonzero(mask).view(-1).cpu().numpy()
    else:
        d1 = x_np[1:-1] - x_np[:-2]
        d2 = x_np[1:-1] - x_np[2:]
        mask = (d1 * d2 > 0) & (d1 > 0)
        peaks = np.nonzero(mask)[0] + 1
    props = {}

    heights = x_np[peaks]
    if height is not None:
        keep = _interval_keep(heights, height)
        peaks, heights = peaks[keep], heights[keep]
        props["peak_heights"] = heights
    if threshold is not None:
        lo, hi = _minmax(threshold)
        lt = x_np[peaks] - x_np[peaks - 1]
        rt = x_np[peaks] - x_np[peaks + 1]
        keep = np.ones(len(peaks), bool)
        if lo is not None:
            keep &= np.minimum(lt, rt) >= lo
        if hi is not None:
            keep &= np.maximum(lt, rt) <= hi
        peaks = peaks[keep]
        # refilter properties attached by earlier conditions, as scipy
        # does at each condition
        for k in props:
            props[k] = props[k][keep]
        props["left_thresholds"] = lt[keep]
        props["right_thresholds"] = rt[keep]
    if distance is not None:
        distance = int(np.ceil(distance))
        if distance < 1:
            raise ValueError("distance must be >= 1")
        # scipy's greedy: highest peaks claim their neighbourhood
        # first, equal heights resolved later-index-first; peaks are
        # position-sorted, so each suppression is one searchsorted
        # window
        order = np.argsort(x_np[peaks], kind="stable")[::-1]
        keep = np.ones(len(peaks), bool)
        for j in order:
            if not keep[j]:
                continue
            lo = np.searchsorted(peaks, peaks[j] - distance + 1)
            hi = np.searchsorted(peaks, peaks[j] + distance)
            keep[lo:hi] = False
            keep[j] = True
        peaks = peaks[keep]
        for k in props:
            props[k] = props[k][keep]
    if prominence is not None or width is not None:
        # one device pass covers both conditions: _widths_xla already
        # computes the prominences it evaluates widths against
        if use:
            pk = torch.as_tensor(peaks, device=x_dev.device)
            if width is not None:
                out = _widths_xla(x_dev, _check_rel_height(rel_height))
                w, wh, li, ri, prom, lsp, rsp = (
                    a[pk].cpu().numpy() for a in out)
            else:
                lsp, rsp, prom = (a[pk].cpu().numpy() for a in
                                  _prom_spans_xla(x_dev))
        else:
            prom, lbase, rbase = _prominences_bases_na(x_np, peaks)
            prom = prom.astype(np.float32)
            if width is not None:
                w, wh, li, ri = (np.asarray(a) for a in
                                 peak_widths_na(x_np, peaks, rel_height,
                                                prom=prom))
        if prominence is not None:
            keep = _interval_keep(prom, prominence)
            peaks, prom = peaks[keep], prom[keep]
            if use:
                lsp, rsp = lsp[keep], rsp[keep]
            else:
                lbase, rbase = lbase[keep], rbase[keep]
            for k in props:
                props[k] = props[k][keep]
            if width is not None:
                w, wh, li, ri = w[keep], wh[keep], li[keep], ri[keep]
        if use:
            # the bases of the peaks kept only: the host walk over each
            # saddle span then runs once a reported peak
            lbase, rbase = _bases_from_spans(x_np, peaks, lsp, rsp)
        props["prominences"] = prom
        props["left_bases"] = lbase
        props["right_bases"] = rbase
        if width is not None:
            keep = _interval_keep(w, width)
            peaks = peaks[keep]
            for k in props:
                props[k] = props[k][keep]
            props.update(widths=w[keep], width_heights=wh[keep],
                         left_ips=li[keep], right_ips=ri[keep])
    return peaks, props
