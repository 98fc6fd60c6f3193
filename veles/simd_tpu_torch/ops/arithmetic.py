"""Conversions, complex/real multiplies, and reductions.

The port of ``veles.simd_tpu.ops.arithmetic`` (rebuild of the
reference's header-only ``inc/simd/arithmetic.h``): each op is one or a
few PyTorch elementwise or reduction calls on ``Config.device``.

Semantics kept from the JAX package:

* ``float_to_int16`` / ``float_to_int32`` truncate toward zero and
  saturate on overflow, and map NaN to 0 — what XLA's convert does.
  The saturation and the NaN are explicit here: torch's cast of an
  out-of-range or NaN float is undefined (``2**31 - 1`` rounds to
  ``2**31`` in float32, so a clamp alone overflows the cast).  The
  JAX package's own ``float_to_int32_na`` oracle maps NaN to
  ``-2**31``; the port's ``_na`` copies it as it is.
* ``int32_to_int16`` saturates (the AVX ``_mm_packs_epi32`` path).
* ``float16_to_float`` reads raw IEEE binary16 bits (``uint16``) by a
  ``view(torch.float16)`` of their int16 tensor: subnormals, inf, NaN
  and signed zero come out exact.
* complex arrays are interleaved re/im float pairs, the FFTF layout.

Oracle twins (NumPy) carry the reference's ``*_na`` names.  Results
of the PyTorch path are tensors; 64-bit NumPy input computes in its
32-bit twin, as ``jnp.asarray`` does with x64 off.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.utils import benchmark as bm
from veles.simd_tpu_torch.utils.config import resolve_simd
from veles.simd_tpu_torch.utils.platform import as_tensor, device

__all__ = [
    "int16_to_float", "float_to_int16", "int32_to_float", "float_to_int32",
    "int16_to_int32", "int32_to_int16", "float16_to_float", "int16_multiply",
    "real_multiply", "real_multiply_array", "real_multiply_scalar",
    "complex_multiply",
    "complex_multiply_conjugate", "complex_conjugate", "sum_elements",
    "add_to_all", "interleave_complex", "deinterleave_complex",
]

_I16_MIN, _I16_MAX = -32768, 32767
_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1
# the largest float32 below 2**31
_F32_BELOW_2_31 = 2147483520.0


# --------------------------------------------------------------------------
# PyTorch paths: each an instrumented call under the JAX core's name
# (``obs.resources()`` keys it ``(name, "default")``), whose work is
# one operation an output element, or six a complex product
# --------------------------------------------------------------------------

def _ew(ops, out_itemsize=4):
    """``work=`` of an elementwise core: ``ops`` operations an output
    element of ``out_itemsize`` bytes (:func:`utils.benchmark.
    elementwise_work`)."""
    return lambda *args: bm.elementwise_work(ops, out_itemsize, *args)


def _interleaved_work(*args):
    """``work=`` of a complex product of interleaved arrays: six
    operations a complex output, three a float."""
    halves = [tuple(a.shape[:-1]) + (a.shape[-1] // 2,) for a in args]
    out = 2 * math.prod(torch.broadcast_shapes(*halves))
    return bm.elementwise_work(3, 4, *args, out_elems=out)


@obs.instrumented_jit(work=_ew(1))
def _int16_to_float(x):
    return x.to(torch.float32)


@obs.instrumented_jit(work=_ew(1, 2))
def _float_to_int16(x):
    # trunc-toward-zero + saturate: mirrors cvttps+packs
    # (arithmetic.h:262-270); NaN -> 0 as XLA's convert gives
    t = torch.nan_to_num(torch.trunc(x.to(torch.float32)), nan=0.0)
    return torch.clamp(t, _I16_MIN, _I16_MAX).to(torch.int16)


@obs.instrumented_jit(work=_ew(1))
def _int32_to_float(x):
    return x.to(torch.float32)


@obs.instrumented_jit(work=_ew(1))
def _float_to_int32(x):
    t = torch.trunc(x.to(torch.float32))
    # every value the cast sees is in range: NaN -> 0, and the top
    # saturates after the cast (2**31 - 1 is not a float32)
    q = torch.clamp(torch.nan_to_num(t, nan=0.0), _I32_MIN,
                    _F32_BELOW_2_31).to(torch.int32)
    return torch.where(t >= 2.0 ** 31, torch.full_like(q, _I32_MAX), q)


@obs.instrumented_jit(work=_ew(1))
def _int16_to_int32(x):
    return x.to(torch.int32)


@obs.instrumented_jit(work=_ew(1, 2))
def _int32_to_int16(x):
    return torch.clamp(x, _I16_MIN, _I16_MAX).to(torch.int16)


@obs.instrumented_jit(work=_ew(1))
def _float16_to_float(bits):
    return bits.view(torch.float16).to(torch.float32)


@obs.instrumented_jit(work=_ew(1))
def _int16_multiply(a, b):
    return a.to(torch.int32) * b.to(torch.int32)


@obs.instrumented_jit(work=_ew(1))
def _real_multiply(a, b):
    return a * b


@obs.instrumented_jit(work=_ew(1))
def _real_multiply_scalar(x, value):
    return x * value


def _interleave(re, im):
    return torch.stack([re, im], dim=-1).reshape(*re.shape[:-1], -1)


@obs.instrumented_jit(work=_interleaved_work)
def _complex_multiply(a, b):
    ar, ai = a[..., 0::2], a[..., 1::2]
    br, bi = b[..., 0::2], b[..., 1::2]
    return _interleave(ar * br - ai * bi, ar * bi + br * ai)


@obs.instrumented_jit(work=_interleaved_work)
def _complex_multiply_conjugate(a, b):
    ar, ai = a[..., 0::2], a[..., 1::2]
    br, bi = b[..., 0::2], -b[..., 1::2]
    return _interleave(ar * br - ai * bi, ar * bi + br * ai)


@obs.instrumented_jit(work=_ew(1))
def _complex_conjugate(a):
    return _interleave(a[..., 0::2], -a[..., 1::2])


@obs.instrumented_jit(
    work=lambda x: bm.elementwise_work(1, 4, x, out_elems=x.numel()))
def _sum_elements(x):
    return torch.sum(x, dim=-1)


@obs.instrumented_jit(work=_ew(1))
def _add_to_all(x, value):
    return x + value


# --------------------------------------------------------------------------
# NumPy oracle twins (reference *_na semantics)
# --------------------------------------------------------------------------

def int16_to_float_na(x):
    """``arithmetic.h:43-48``."""
    return np.asarray(x, np.int16).astype(np.float32)


def float_to_int16_na(x):
    """``arithmetic.h:51-57`` — C truncation; saturate instead of UB."""
    return np.clip(np.trunc(np.asarray(x, np.float32)),
                   _I16_MIN, _I16_MAX).astype(np.int16)


def int32_to_float_na(x):
    """``arithmetic.h:59-64``."""
    return np.asarray(x, np.int32).astype(np.float32)


def float_to_int32_na(x):
    """``arithmetic.h:66-71``."""
    return np.clip(np.trunc(np.asarray(x, np.float64)),
                   _I32_MIN, _I32_MAX).astype(np.int32)


def int16_to_int32_na(x):
    """``arithmetic.h:80-85``."""
    return np.asarray(x, np.int16).astype(np.int32)


def int32_to_int16_na(x):
    """``arithmetic.h:73-78`` is a wrapping C cast; the vector path
    saturates (``:334``).  The oracle follows the vector (saturating)
    contract so both backends agree."""
    return np.clip(np.asarray(x, np.int32), _I16_MIN,
                   _I16_MAX).astype(np.int16)


def float16_to_float_na(bits):
    """``arithmetic.h:92-127`` — IEEE binary16 -> binary32 incl.
    subnormals, inf, nan, signed zero.  NumPy's float16 implements
    exactly this."""
    return np.asarray(bits, np.uint16).view(np.float16).astype(np.float32)


def int16_multiply_na(a, b):
    """Widening i16×i16→i32 (``arithmetic.h:211-221`` AVX2 path)."""
    return np.asarray(a, np.int16).astype(np.int32) * \
        np.asarray(b, np.int16).astype(np.int32)


def real_multiply_array_na(a, b):
    """``arithmetic.h:135-140``."""
    return np.asarray(a, np.float32) * np.asarray(b, np.float32)


def real_multiply_scalar_na(x, value):
    """``arithmetic.h:170-176``."""
    return np.asarray(x, np.float32) * np.float32(value)


def complex_multiply_na(a, b):
    """``arithmetic.h:142-152`` on whole interleaved arrays."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    ar, ai = a[..., 0::2], a[..., 1::2]
    br, bi = b[..., 0::2], b[..., 1::2]
    out = np.empty_like(a)
    out[..., 0::2] = ar * br - ai * bi
    out[..., 1::2] = ar * bi + br * ai
    return out


def complex_multiply_conjugate_na(a, b):
    """``arithmetic.h:154-163``: a × conj(b)."""
    b = np.asarray(b, np.float32).copy()
    b[..., 1::2] = -b[..., 1::2]
    return complex_multiply_na(a, b)


def complex_conjugate_na(a):
    """``arithmetic.h:165-168``."""
    out = np.asarray(a, np.float32).copy()
    out[..., 1::2] = -out[..., 1::2]
    return out


def sum_elements_na(x):
    """``arithmetic.h:178-184``."""
    return np.float32(np.sum(np.asarray(x, np.float32), axis=-1,
                             dtype=np.float32))


def add_to_all_na(x, value):
    """``arithmetic.h:186-191`` (scalar/AVX semantics)."""
    return np.asarray(x, np.float32) + np.float32(value)


# --------------------------------------------------------------------------
# public dispatching API
# --------------------------------------------------------------------------

def _dispatch(simd, torch_fn, na_fn, *args):
    if resolve_simd(simd, op="arithmetic"):
        return torch_fn(*[as_tensor(a) for a in args])
    return na_fn(*[np.asarray(a) for a in args])


def _check_broadcast(name, a, b, interleaved=False):
    """The JAX package's ``TypeError`` for operands that do not
    broadcast (torch would raise ``RuntimeError``), checked on the
    shapes before any torch call; interleaved complex arrays broadcast
    as their complex halves."""
    shapes = [tuple(np.shape(v)) for v in (a, b)]
    if interleaved:
        shapes = [s[:-1] + (s[-1] // 2,) if s else s for s in shapes]
    try:
        np.broadcast_shapes(*shapes)
    except ValueError:
        raise TypeError(f"{name} got incompatible shapes for "
                        f"broadcasting: {shapes[0]}, {shapes[1]}.") \
            from None


def _binary(simd, torch_fn, na_fn, a, b, interleaved=False):
    """A two-operand op: the shapes checked as the JAX package checks
    them on its device path, then :func:`_dispatch`."""
    if resolve_simd(simd, op="arithmetic"):
        _check_broadcast("mul", a, b, interleaved)
        return torch_fn(as_tensor(a), as_tensor(b))
    return na_fn(np.asarray(a), np.asarray(b))


def int16_to_float(data, simd=None):
    return _dispatch(simd, _int16_to_float, int16_to_float_na, data)


def float_to_int16(data, simd=None):
    return _dispatch(simd, _float_to_int16, float_to_int16_na, data)


def int32_to_float(data, simd=None):
    return _dispatch(simd, _int32_to_float, int32_to_float_na, data)


def float_to_int32(data, simd=None):
    return _dispatch(simd, _float_to_int32, float_to_int32_na, data)


def int16_to_int32(data, simd=None):
    return _dispatch(simd, _int16_to_int32, int16_to_int32_na, data)


def int32_to_int16(data, simd=None):
    return _dispatch(simd, _int32_to_int16, int32_to_int16_na, data)


def float16_to_float(bits, simd=None):
    """Convert raw IEEE binary16 bit patterns (uint16) to float32.  A
    float16 array or tensor is read as its bits; an int16 tensor is
    taken as the bits."""
    if isinstance(bits, torch.Tensor):
        if bits.dtype == torch.float16:
            bits = bits.view(torch.int16)
        if not resolve_simd(simd, op="arithmetic"):
            return float16_to_float_na(
                bits.cpu().numpy().view(np.uint16))
        return _float16_to_float(bits.to(torch.int16))
    bits = np.asarray(bits)
    if bits.dtype == np.float16:
        bits = bits.view(np.uint16)
    if not resolve_simd(simd, op="arithmetic"):
        return float16_to_float_na(bits)
    # torch has no full uint16: the same 16 bits as int16
    i16 = np.ascontiguousarray(bits.astype(np.uint16)).view(np.int16)
    return _float16_to_float(torch.as_tensor(i16, device=device()))


def int16_multiply(a, b, simd=None):
    return _binary(simd, _int16_multiply, int16_multiply_na, a, b)


def real_multiply(a, b, simd=None):
    """Elementwise f32 multiply (``real_multiply_array``)."""
    return _binary(simd, _real_multiply, real_multiply_array_na, a, b)


# the reference publishes both spellings (inc/simd/arithmetic.h:170-176);
# they are the same elementwise product here
real_multiply_array = real_multiply


def real_multiply_scalar(data, value, simd=None):
    if resolve_simd(simd, op="arithmetic"):
        return _real_multiply_scalar(as_tensor(data), float(value))
    return real_multiply_scalar_na(data, value)


def _check_interleaved(*arrays):
    for a in arrays:
        if np.shape(a)[-1] % 2:
            raise ValueError(
                "interleaved complex array must have even last-dim length")


def complex_multiply(a, b, simd=None):
    _check_interleaved(a, b)
    return _binary(simd, _complex_multiply, complex_multiply_na, a, b,
                   interleaved=True)


def complex_multiply_conjugate(a, b, simd=None):
    _check_interleaved(a, b)
    return _binary(simd, _complex_multiply_conjugate,
                   complex_multiply_conjugate_na, a, b, interleaved=True)


def complex_conjugate(data, simd=None):
    _check_interleaved(data)
    return _dispatch(simd, _complex_conjugate, complex_conjugate_na, data)


def sum_elements(data, simd=None):
    return _dispatch(simd, _sum_elements, sum_elements_na, data)


def add_to_all(data, value, simd=None):
    if resolve_simd(simd, op="arithmetic"):
        return _add_to_all(as_tensor(data), float(value))
    return add_to_all_na(data, value)


# --------------------------------------------------------------------------
# interleaved-complex layout helpers
# --------------------------------------------------------------------------

def interleave_complex(z):
    """complex64 array -> interleaved re/im float32 (FFTF layout).  A
    NumPy array stays NumPy; anything else is a tensor."""
    if isinstance(z, np.ndarray):
        out = np.stack([z.real, z.imag], axis=-1)
        return out.reshape(*z.shape[:-1], -1).astype(np.float32)
    z = as_tensor(z).to(torch.complex64)
    return torch.view_as_real(z).reshape(*z.shape[:-1], -1)


def deinterleave_complex(data):
    """Interleaved re/im float32 -> complex64."""
    if isinstance(data, np.ndarray):
        return (data[..., 0::2] + 1j * data[..., 1::2]).astype(
            np.complex64)
    data = as_tensor(data).to(torch.float32)
    return torch.complex(data[..., 0::2], data[..., 1::2])
