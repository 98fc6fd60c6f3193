"""2D linear convolution and cross-correlation.

The port of ``veles.simd_tpu.ops.convolve2d``: the full linear
convolution ``[..., n0 + k0 - 1, n1 + k1 - 1]`` of every image of ``x``
with one 2D kernel, computed with PyTorch on ``Config.device``; leading
batch dimensions pass through, and cross-correlation is convolution
with the kernel reversed along both axes.  ``mode`` and ``boundary``
follow ``scipy.signal.convolve2d``.

Routes (the ``convolve2d`` candidate table):

* ``direct``: the 2D shifted-MAC kernel (``csrc/filter_2d.cu``, the
  JAX package's ``direct_pallas``) on the card for kernels of area
  <= 256 whose tile fits shared memory;
  ``VELES_SIMD_DISABLE_CUDA2D`` closes it.  An explicit
  ``algorithm="direct"`` that the kernel does not take runs
  ``conv2d`` (cuDNN pinned to fp32), the JAX package's
  ``direct_mxu``.
* ``fft``: one batched ``torch.fft.rfft2`` product, padded to powers of
  two — every shape the kernel route refuses.

On auto dispatch the measured autotuner (``VELES_SIMD_AUTOTUNE``,
``runtime/routing.py``) may pick ``fft`` over the kernel per geometry
class; an ``autotune_fft`` decision event marks the flip.

The area cap is the JAX package's static prior; it has not been
measured on the H100.  Faults, as in the JAX package: the dispatch runs
behind ``faults.breaker_guarded("convolve2d.dispatch", ...)`` keyed by
``(algorithm, kernel shape, pow2-bucketed image shape)`` (retry on a
device loss or timeout, then the float64 oracle, which returns NumPy),
and the kernel route under ``faults.demote_and_remember`` at
``convolve2d.direct_cuda``: a launch the card refuses for the shape
(``cuda2d_demotion``) is remembered in ``cuda2d_rejected`` (256
entries, keyed ``(images, n0, n1, k0, k1)``) and demotes auto dispatch
to ``fft``, an explicit ``"direct"`` to ``direct_mxu``.  The oracle
and the demotion serve host operands only (``faults.on_card``).  Not
ported:
the JAX package's compile-time stack model for traced calls, which
belongs to the TPU's compiler; the kernel's shared-memory admission
here is exact arithmetic.  Results are float32 tensors;
``simd=False`` runs the float64 NumPy oracle and returns NumPy.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.ops import cuda_kernels as _ck
from veles.simd_tpu_torch.ops.convolve import _check_mode, _host, _operands
from veles.simd_tpu_torch.runtime import faults, routing
from veles.simd_tpu_torch.runtime import precision as prx
from veles.simd_tpu_torch.utils import benchmark as _bm
from veles.simd_tpu_torch.utils.config import resolve_simd
from veles.simd_tpu_torch.utils.memory import next_highest_power_of_2
from veles.simd_tpu_torch.utils.platform import as_f32, on_cuda

__all__ = ["convolve2d", "convolve2d_na",
           "cross_correlate2d", "cross_correlate2d_na",
           "select_algorithm2d"]


def _direct2d_gate(k0, k1, cuda=False, **_):
    """The ``direct`` (2D kernel) gate, the one home of the 2D route
    constants: on the card, kernel area <= MAX_AREA_2D, and the
    kernel's tile fits shared memory (which depends on the kernel
    only, not on the image)."""
    return (_ck.on_card(cuda) and k0 * k1 <= _ck.MAX_AREA_2D
            and _ck.fits_smem_f2d(k0, k1))


# Shape classes whose 2D kernel launch the card refused
# (demote-and-remember, runtime/faults.py), keyed (images, n0, n1, k0,
# k1) as in the JAX package; a bounded LRU in obs.caches().  Tests may
# substitute a plain set; the provider re-reads the module global.
_CUDA2D_MAXSIZE = 256
_CUDA2D_REJECTED = obs.LRUSet(_CUDA2D_MAXSIZE)
faults.register_rejection_cache(
    "cuda2d_rejected", lambda: _CUDA2D_REJECTED, _CUDA2D_MAXSIZE)


_CONV2D_FAMILY = routing.family("convolve2d", (
    routing.Route(
        "direct",
        predicate=_direct2d_gate,
        disable_env="VELES_SIMD_DISABLE_CUDA2D",
        fault_site="convolve2d.direct_cuda",
        rejection_cache=lambda: _CUDA2D_REJECTED,
        rejection_key=lambda rows, n0, n1, k0, k1, **_:
            (rows, n0, n1, k0, k1),
        doc="2D shifted-MAC kernel (VELES_SIMD_DISABLE_CUDA2D opts "
            "out)"),
    routing.Route(
        "fft",
        doc="batched rfft2 . multiply . irfft2 — every shape the "
            "kernel gate refuses"),
))


def _direct2d_geom(x_shape, k0: int, k1: int, cuda: bool) -> dict:
    """The ``convolve2d`` table's geometry of a call."""
    return dict(k0=int(k0), k1=int(k1), rows=_images(x_shape),
                n0=int(x_shape[-2]), n1=int(x_shape[-1]), cuda=bool(cuda))


def select_algorithm2d(k0: int, k1: int, x_shape=None) -> str:
    """``'direct'`` when the 2D kernel will take the shape on the
    configured device, else ``'fft'`` — the JAX package's rule, with the
    card in place of the TPU.  It is the ``convolve2d`` table's static
    choice (rejection memory first, so a demoted shape skips the
    kernel, then an armed fault plan, which opens the gate on the CPU,
    then the env opt-out and the kernel gates), which a call's auto
    algorithm makes for its operand's device."""
    shape = x_shape if x_shape is not None else (1, 1)
    return _CONV2D_FAMILY.static_select(
        **_direct2d_geom(shape, k0, k1, on_cuda()))


def _images(x_shape) -> int:
    return math.prod(x_shape[:-2])


def _crop(full, crop):
    """``full[..., c0:c0 + m0, c1:c1 + m1]``, the full output of an
    input extended by ``crop`` per side cut back to the unextended
    input's full size."""
    c0, c1 = crop
    if not (c0 or c1):
        return full
    m0, m1 = full.shape[-2] - 2 * c0, full.shape[-1] - 2 * c1
    return full[..., c0:c0 + m0, c1:c1 + m1]


def _conv2d_direct_cuda(x, h, reverse=False, crop=(0, 0)):
    """Direct form as the 2D kernel: it reads the zero halo (k-1 on
    each side, less the ``crop`` of an already extended input) and, for
    convolution, the taps flipped, so nothing is padded, flipped or
    sliced here."""
    n0, n1 = x.shape[-2:]
    k0, k1 = h.shape[-2:]
    c0, c1 = crop
    return _ck.filter_2d_cuda(x, h, n0 - 2 * c0 + k0 - 1,
                              n1 - 2 * c1 + k1 - 1,
                              pad=(k0 - 1 - c0, k1 - 1 - c1),
                              reverse_taps=not reverse)


def _conv2d_core_work(x, h, reverse=False, crop=(0, 0)):
    """``work=`` of the two XLA-route cores: the full 2D convolution's
    least work (:func:`utils.benchmark.conv2d_work`); for an extended
    input cut back by ``crop``, the smaller of the direct form over the
    kept outputs and the FFT form, and the kept outputs' bytes."""
    imgs, (n0, n1), (k0, k1) = _images(x.shape), x.shape[-2:], h.shape[-2:]
    full = _bm.conv2d_work(imgs, n0, n1, k0, k1)
    if not any(crop):
        return full
    flops, nbytes = _bm.filter_2d_work(
        imgs, n0, n1, k0, k1, n0 - 2 * crop[0] + k0 - 1,
        n1 - 2 * crop[1] + k1 - 1)
    return min(flops, full[0]), nbytes


# the XLA-route cores are instrumented calls keyed ("convolve2d",
# route) as the JAX package's are; the kernel route is not, the 2D
# kernel wrapper's ("cuda", "filter_2d") row stands for it
@obs.instrumented_jit(op="convolve2d", route="direct_mxu",
                      work=_conv2d_core_work)
def _conv2d_direct(x, h, reverse=False, crop=(0, 0)):
    """Direct form as ``conv2d`` (which correlates), cuDNN pinned to
    fp32."""
    n0, n1 = x.shape[-2:]
    k0, k1 = h.shape[-2:]
    kernel = h if reverse else h.flip((-2, -1))
    with prx.fp32_conv(x.device):
        out = F.conv2d(x.reshape(-1, 1, n0, n1),
                       kernel.reshape(1, 1, k0, k1),
                       padding=(k0 - 1, k1 - 1))
    return _crop(out.reshape(tuple(x.shape[:-2])
                             + (n0 + k0 - 1, n1 + k1 - 1)), crop)


@obs.instrumented_jit(op="convolve2d", route="fft",
                      work=_conv2d_core_work)
def _conv2d_fft(x, h, reverse=False, crop=(0, 0)):
    """Both axes padded to powers of two >= n+k-1, one batched
    ``rfft2 · multiply · irfft2``."""
    n0, n1 = x.shape[-2:]
    k0, k1 = h.shape[-2:]
    m = (next_highest_power_of_2(n0 + k0 - 1),
         next_highest_power_of_2(n1 + k1 - 1))
    kernel = h.flip((-2, -1)) if reverse else h
    spec = torch.fft.rfft2(x, s=m) * torch.fft.rfft2(kernel, s=m)
    return _crop(torch.fft.irfft2(spec, s=m)[..., :n0 + k0 - 1,
                                             :n1 + k1 - 1], crop)


_RUNNERS = {"direct_cuda": _conv2d_direct_cuda,
            "direct_mxu": _conv2d_direct,
            "fft": _conv2d_fft}


def _check2d(x, h):
    if np.ndim(x) < 2 or np.ndim(h) != 2:
        raise ValueError(
            f"need x[..., n0, n1] and h[k0, k1]; got "
            f"{tuple(np.shape(x))} and {tuple(np.shape(h))}")


def _run2d(x, h, reverse, algorithm, simd, crop=(0, 0)):
    """Full convolution (or correlation) with ``algorithm`` None (auto),
    ``'direct'`` or ``'fft'``; of an input extended by ``crop`` per side,
    the part that is the unextended input's full output."""
    _check2d(x, h)
    if algorithm not in (None, "direct", "fft"):
        raise ValueError(f"algorithm must be 'direct' or 'fft', "
                         f"got {algorithm!r}")
    if not resolve_simd(simd, op="convolve2d"):
        return _run2d_oracle(x, h, reverse, crop)
    x_shape, h_shape = tuple(np.shape(x)), tuple(np.shape(h))
    k0, k1 = h_shape
    cuda = x.is_cuda if isinstance(x, torch.Tensor) else on_cuda()
    auto = algorithm is None
    # the kernel gate, evaluated once for the call: it picks the auto
    # algorithm and the direct route alike
    kernel = algorithm != "fft" and _CONV2D_FAMILY.static_select(
        **_direct2d_geom(x_shape, k0, k1, cuda)) == "direct"
    if auto:
        algorithm = "direct" if kernel else "fft"
    with obs.span("convolve2d.dispatch", algo=algorithm, auto=auto):
        # transient device faults: bounded retry, then the float64
        # oracle for host operands, behind the shape class's circuit
        # breaker (image dims pow2-bucketed, kernel dims exact)
        return faults.breaker_guarded(
            "convolve2d.dispatch",
            (algorithm, h_shape,
             tuple(routing.pow2_bucket(d) for d in x_shape)),
            lambda: _run2d_torch(x, h, reverse, algorithm, auto, kernel,
                                 crop),
            fallback=None if faults.on_card(x, h)
            else lambda: _run2d_oracle(x, h, reverse, crop))


def _run2d_oracle(x, h, reverse, crop):
    """The NumPy-oracle side of :func:`_run2d` (also the fault
    policy's degradation target)."""
    h = _host(h).astype(np.float32)
    return _crop(convolve2d_na(_host(x), h[::-1, ::-1] if reverse else h),
                 crop)


def _run2d_torch(x, h, reverse, algorithm, auto, kernel, crop):
    """The PyTorch side of :func:`_run2d`: operands to the device, the
    route (``kernel``: the 2D kernel's gate admitted the call), and the
    kernel route's demotion."""
    host = not faults.on_card(x, h)
    x, h = _operands(x, h)
    k0, k1 = h.shape
    geom = dict(auto=auto, images=_images(x.shape), n0=int(x.shape[-2]),
                n1=int(x.shape[-1]), k0=int(k0), k1=int(k1))

    def run(route):
        obs.record_decision("convolve2d", route, **geom)
        return _RUNNERS[route](x, h, reverse=reverse, crop=crop)

    if kernel and auto:
        # the measured autotuner may flip the static "direct" to the
        # batched fft, once per geometry class.  The table reads the
        # exact dims (a probe's refused launch feeds the rejection
        # cache under the demotion key); the tune class pow2-buckets
        # the image dims, kernel dims exact — the JAX package's key
        chosen = _CONV2D_FAMILY.select(
            runners=lambda: {
                "direct": lambda: _RUNNERS["direct_cuda"](
                    x, h, reverse=reverse, crop=crop),
                "fft": lambda: _RUNNERS["fft"](
                    x, h, reverse=reverse, crop=crop)},
            probe_operand=x,
            tune_geom=lambda: {
                "rows": routing.pow2_bucket(geom["images"]),
                "n0": routing.pow2_bucket(geom["n0"]),
                "n1": routing.pow2_bucket(geom["n1"]),
                "k0": int(k0), "k1": int(k1)},
            **_direct2d_geom(x.shape, k0, k1, x.is_cuda))
        if chosen == "fft":
            # the flip away from the static "direct" must be
            # attributable (the dispatch span still says direct)
            obs.record_decision(
                "convolve2d", "autotune_fft", rows=geom["images"],
                n0=geom["n0"], n1=geom["n1"], k0=int(k0), k1=int(k1),
                mode=routing.autotune_mode())
            kernel = False
    if not kernel:
        return run("fft" if auto or algorithm == "fft" else "direct_mxu")
    fallback = "fft" if auto else "direct_mxu"

    def direct_cuda():
        out = _RUNNERS["direct_cuda"](x, h, reverse=reverse, crop=crop)
        # recorded after the launch: a demotion records its own route
        obs.record_decision("convolve2d", "direct_cuda", **geom)
        return out

    # a launch the card refuses for this shape demotes (auto to fft,
    # an explicit "direct" to conv2d) and is remembered, for host
    # operands only
    return faults.demote_and_remember(
        "convolve2d.direct_cuda", direct_cuda,
        (lambda: run(fallback)) if host else None,
        cache=_CUDA2D_REJECTED,
        key=(geom["images"], geom["n0"], geom["n1"], int(k0), int(k1)),
        route="direct_cuda", fallback_route=fallback,
        counter="cuda2d_demotion")


def _sym_index(n, p, mode):
    """Indices of an axis of length ``n`` padded by ``p`` per side
    under NumPy's ``mode`` ('wrap', 'symmetric')."""
    return np.pad(np.arange(n), (p, p), mode=mode)


def _pad2d(x, p0, p1, boundary, fillvalue):
    """Extend the last two axes by ``(p0, p1)`` per side: constant
    ``fillvalue``, ``wrap`` or ``symm`` (NumPy's 'symmetric', the edge
    sample repeated), for arrays or tensors."""
    if not isinstance(x, torch.Tensor):
        pad = [(0, 0)] * (x.ndim - 2) + [(p0, p0), (p1, p1)]
        if boundary == "fill":
            return np.pad(x, pad, constant_values=fillvalue)
        return np.pad(x, pad, mode=_BOUNDARY_PAD[boundary])
    if boundary == "fill":
        return F.pad(x, (p1, p1, p0, p0), value=float(fillvalue))
    mode = _BOUNDARY_PAD[boundary]
    i0 = torch.as_tensor(_sym_index(x.shape[-2], p0, mode),
                         device=x.device)
    i1 = torch.as_tensor(_sym_index(x.shape[-1], p1, mode),
                         device=x.device)
    return x.index_select(-2, i0).index_select(-1, i1)


_BOUNDARY_PAD = {"fill": "constant", "wrap": "wrap", "symm": "symmetric"}


def _mode_boundary_2d(x, h, reverse, algorithm, simd, mode, boundary,
                      fillvalue):
    """scipy ``convolve2d``/``correlate2d`` semantics on top of the
    full-output core: ``boundary`` extends the input by ``k-1`` per
    side before the full convolution, and ``mode`` slices the result
    per axis (``correlate2d``'s 'same' starts at ``k//2`` where
    ``convolve2d``'s starts at ``(k-1)//2``; 'valid' is
    orientation-independent)."""
    _check_mode(mode)
    if boundary not in _BOUNDARY_PAD:
        raise ValueError(f"boundary must be one of "
                         f"{sorted(_BOUNDARY_PAD)}, got {boundary!r}")
    _check2d(x, h)
    k0, k1 = np.shape(h)[-2:]
    n0, n1 = np.shape(x)[-2:]
    swapped = False
    if mode == "valid":
        # scipy's 'valid' contract: one operand must contain the other
        # in every dimension; when only the kernel contains the input
        # the operands swap, and a swapped correlation flips the result
        x_holds = n0 >= k0 and n1 >= k1
        h_holds = k0 >= n0 and k1 >= n1
        if not (x_holds or h_holds):
            raise ValueError(
                "for mode='valid' one input must be at least as large "
                f"as the other in every dimension; got {(n0, n1)} vs "
                f"{(k0, k1)}")
        if h_holds and not x_holds:
            if np.ndim(x) != 2:
                raise ValueError(
                    "mode='valid' with a kernel larger than the input "
                    "supports unbatched [n0, n1] inputs only (the "
                    "operand swap would move the batch axes)")
            x, h = h, x
            n0, n1, k0, k1 = k0, k1, n0, n1
            swapped = True
        # the fully-overlapped region never sees the boundary
        boundary, fillvalue = "fill", 0.0
    plain = boundary == "fill" and fillvalue == 0.0
    # 'full' border outputs reach k-1 extension samples, 'same' ones
    # only k//2
    p0, p1 = (k0 - 1, k1 - 1) if mode == "full" else (k0 // 2, k1 // 2)
    if not plain:
        if resolve_simd(simd, op="convolve2d"):
            x = as_f32(x)
        else:
            x = np.asarray(x)
        x = _pad2d(x, p0, p1, boundary, fillvalue)
    # an extended input's full output, cut to the unextended one's: the
    # kernel route computes only that part
    out = _run2d(x, h, reverse, algorithm, simd,
                 crop=(0, 0) if plain else (p0, p1))
    if mode == "full":
        return out

    def span(n, k):
        if mode == "same":
            start = k // 2 if reverse else (k - 1) // 2
            return start, n
        lo, hi = min(n, k), max(n, k)
        return lo - 1, hi - lo + 1
    s0, l0 = span(n0, k0)
    s1, l1 = span(n1, k1)
    out = out[..., s0:s0 + l0, s1:s1 + l1]
    if swapped and reverse:
        out = (out.flip((-2, -1)) if isinstance(out, torch.Tensor)
               else out[..., ::-1, ::-1])
    return out


def convolve2d(x, h, algorithm=None, simd=None, *, mode="full",
               boundary="fill", fillvalue=0.0):
    """2D linear convolution: ``y[..., i, j] = Σ x[..., i-p, j-q]
    h[p, q]``.

    ``algorithm`` is None (auto: the 2D kernel where its gate admits
    the shape, else fft), ``'direct'`` or ``'fft'``.  ``mode`` ('full'
    default, 'same', 'valid') and ``boundary`` ('fill' with
    ``fillvalue``, 'wrap', 'symm') follow ``scipy.signal.convolve2d``.
    'full' output is ``[..., n0+k0-1, n1+k1-1]``."""
    return _mode_boundary_2d(x, h, False, algorithm, simd, mode,
                             boundary, fillvalue)


def cross_correlate2d(x, h, algorithm=None, simd=None, *, mode="full",
                      boundary="fill", fillvalue=0.0):
    """2D cross-correlation (convolution with ``h`` reversed along both
    axes).  ``mode`` / ``boundary`` / ``fillvalue`` as in
    :func:`convolve2d` (scipy's ``correlate2d``)."""
    return _mode_boundary_2d(x, h, True, algorithm, simd, mode,
                             boundary, fillvalue)


def convolve2d_na(x, h):
    """NumPy oracle: float64 spectral convolution (exact to f32
    round-off), algorithm-independent."""
    x = np.asarray(x, np.float32)
    h = np.asarray(h, np.float32)
    _check2d(x, h)
    n0, n1 = x.shape[-2:]
    k0, k1 = h.shape[-2:]
    m0, m1 = n0 + k0 - 1, n1 + k1 - 1
    spec = (np.fft.rfft2(x.astype(np.float64), (m0, m1))
            * np.fft.rfft2(h.astype(np.float64), (m0, m1)))
    return np.fft.irfft2(spec, (m0, m1)).astype(np.float32)


def cross_correlate2d_na(x, h):
    """NumPy oracle twin of :func:`cross_correlate2d`."""
    h = np.asarray(h, np.float32)
    _check2d(np.asarray(x, np.float32), h)
    return convolve2d_na(x, h[::-1, ::-1])
