"""2D plane / 1D array normalization and min-max scans.

The port of ``veles.simd_tpu.ops.normalize`` (rebuild of the
reference's ``src/normalize.c`` + ``inc/simd/normalize.h``): one
reduction and one elementwise pass in PyTorch on ``Config.device``.

Semantics kept:

* ``normalize2D_minmax``: u8 plane -> f32 via ``(v - min)/((max -
  min)/2) - 1`` mapping [min, max] -> [-1, 1]; all zeros when max ==
  min (``src/normalize.c:382-400``), the denominator guarded before
  the divide so no inf or NaN is made and masked.
* ``minmax2D`` (u8) / ``minmax1D`` (f32) return (min, max) in the
  input's dtype (``src/normalize.c:402-443``).
* ``normalize2D`` = minmax2D + normalize2D_minmax
  (``src/normalize.c:445-451``).

All ops accept leading batch dimensions (the reduction is over the
trailing 2 axes for 2D ops, trailing 1 for 1D).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.utils import benchmark as bm
from veles.simd_tpu_torch.utils.config import resolve_simd
from veles.simd_tpu_torch.utils.platform import as_tensor

__all__ = [
    "normalize2D", "normalize2D_minmax", "minmax2D", "minmax1D",
    "normalize2D_novec", "normalize2D_minmax_novec", "minmax2D_novec",
    "minmax1D_novec",
]


def _scale(v, mn, mx):
    """``(v - mn) / ((mx - mn) / 2) - 1``, zeros where ``mx == mn``;
    the denominator is guarded before the divide."""
    flat = mx == mn
    diff = torch.where(flat, torch.ones_like(mx), (mx - mn) / 2.0)
    out = (v - mn) / diff - 1.0
    return torch.where(flat, torch.zeros_like(out), out)


def _reduced(src, axes: int) -> int:
    """Planes (``axes`` 2) or rows (1) of ``src``: one min and one max
    each."""
    return src.numel() // max(1, math.prod(src.shape[-axes:]))


# the instrumented cores, under the JAX package's names: a min and a
# max are an operation a sample each, the scale (subtract, multiply)
# two more
@obs.instrumented_jit(work=lambda src: bm.elementwise_work(4, 4, src))
def _normalize2d(src):
    v = src.to(torch.float32)
    mn = torch.amin(v, dim=(-2, -1), keepdim=True)
    mx = torch.amax(v, dim=(-2, -1), keepdim=True)
    return _scale(v, mn, mx)


@obs.instrumented_jit(work=lambda mn, mx, src: bm.elementwise_work(
    2, 4, mn, mx, src, out_elems=src.numel()))
def _normalize2d_minmax(mn, mx, src):
    v = src.to(torch.float32)
    mn = torch.as_tensor(mn, dtype=torch.float32, device=v.device)
    mx = torch.as_tensor(mx, dtype=torch.float32, device=v.device)
    if mn.dim():  # per-plane values from a batched minmax2D
        mn = mn[..., None, None]
        mx = mx[..., None, None]
    return _scale(v, mn, mx)


@obs.instrumented_jit(work=lambda src: (
    2.0 * src.numel(),
    float(src.nbytes) + 2.0 * src.element_size() * _reduced(src, 2)))
def _minmax2d(src):
    return (torch.amin(src, dim=(-2, -1)), torch.amax(src, dim=(-2, -1)))


@obs.instrumented_jit(work=lambda src: (
    2.0 * src.numel(),
    float(src.nbytes) + 2.0 * src.element_size() * _reduced(src, 1)))
def _minmax1d(src):
    return torch.amin(src, dim=-1), torch.amax(src, dim=-1)


# ---- NumPy oracles (reference *_novec, src/normalize.c:382-443) ----------

def _host(value):
    """A tensor argument (a min or max from the PyTorch path) as
    NumPy; anything else as it is."""
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return value


def normalize2D_minmax_novec(mn, mx, src):
    src = np.asarray(_host(src))
    # mn/mx may be scalars or per-plane arrays (batched input)
    mn = np.asarray(_host(mn), np.float32)
    mx = np.asarray(_host(mx), np.float32)
    if mn.ndim:
        mn = mn[..., None, None]
        mx = mx[..., None, None]
    diff = (mx - mn) / np.float32(2.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = (src.astype(np.float32) - mn) / diff - 1.0
    return np.where(mx == mn, np.float32(0), out).astype(np.float32)


def minmax2D_novec(src):
    src = np.asarray(src)
    return (src.min(axis=(-2, -1)), src.max(axis=(-2, -1)))


def minmax1D_novec(src):
    src = np.asarray(src, np.float32)
    return (src.min(axis=-1), src.max(axis=-1))


def normalize2D_novec(src):
    mn, mx = minmax2D_novec(src)
    return normalize2D_minmax_novec(mn, mx, src)


# ---- public dispatching API ----------------------------------------------

def _check_2d(src):
    if np.ndim(src) < 2:
        raise ValueError("normalize2D/minmax2D expect a >=2D plane")
    _check_reducible(src, 2)


def _check_reducible(src, axes: int):
    """The JAX package's error for an empty reduction (torch would
    raise ``IndexError``): checked on the shape, before any torch
    call."""
    if 0 in tuple(np.shape(src))[-axes:]:
        raise ValueError("zero-size array to reduction operation min "
                         "which has no identity")


def normalize2D(src, simd=None):
    """u8 (or any numeric) plane -> f32 in [-1, 1]
    (``inc/simd/normalize.h:48-57``)."""
    _check_2d(src)
    if resolve_simd(simd, op="normalize"):
        with obs.span("normalize2d.dispatch"):
            return _normalize2d(as_tensor(src))
    return normalize2D_novec(np.asarray(src))


def normalize2D_minmax(mn, mx, src, simd=None):
    """Normalization with precomputed min/max
    (``inc/simd/normalize.h:66-79``)."""
    if resolve_simd(simd, op="normalize"):
        with obs.span("normalize2d_minmax.dispatch"):
            return _normalize2d_minmax(mn, mx, as_tensor(src))
    return normalize2D_minmax_novec(mn, mx, _host(src))


def minmax2D(src, simd=None):
    """(min, max) of a plane (``inc/simd/normalize.h:59-64``)."""
    _check_2d(src)
    if resolve_simd(simd, op="normalize"):
        return _minmax2d(as_tensor(src))
    return minmax2D_novec(np.asarray(src))


def minmax1D(src, simd=None):
    """(min, max) of a float array (``inc/simd/normalize.h:81-90``)."""
    _check_reducible(src, 1)
    if resolve_simd(simd, op="normalize"):
        return _minmax1d(as_tensor(src))
    return minmax1D_novec(np.asarray(src))
