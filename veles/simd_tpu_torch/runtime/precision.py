"""Matmul precision layer (the port's
``veles.simd_tpu.runtime.precision``): the named precisions every
contraction of the port goes through, with their error budgets.

* ``highest`` / ``high`` — a full float32 product: :func:`fp32_matmul`
  holds TF32 off for the call (``torch.set_float32_matmul_precision
  ("highest")``, saved and restored around it, so neither the
  caller's setting is trusted nor is it changed).  The JAX package's
  ``"high"`` is a 3-pass bf16 product on the TPU; here it is the same
  fp32 product as ``"highest"``.
* ``default`` — the card's one-pass reduced precision: TF32 on for the
  call (scoped like :func:`fp32_matmul`).
* ``bf16`` — one pass on the bf16-rounded operands, fp32 accumulate
  and fp32 output; forceable, never engine-eligible.
* ``bf16_comp`` — each operand splits into a bf16 high part and a bf16
  residual (:func:`split_bf16`), and the product is the three-term sum
  ``hi@hi + lo@hi + hi@lo`` accumulated in fp32 (arXiv:2112.09017).
* ``int8`` — symmetric per-tensor int8 quantization with a dynamic
  scale, int32 accumulators, rescale; engine-eligible only under
  ``VELES_SIMD_ENABLE_INT8``.

A bf16 pass is the float32 contraction of operands whose values are
bf16 (the split's parts widened back to float32) with TF32 on: a bf16
value is exact in TF32, so every product is exact and the sums are
fp32, the JAX package's ``preferred_element_type=float32`` pass.  (A
plain matmul of two bf16 tensors in torch returns bf16 and would round
the ``lo`` terms away.)  The ``int8`` route of :func:`p_matmul` and
:func:`p_dot` runs ``torch._int_mm`` (the card's int8 tensor cores),
zero-padded to the shapes it accepts, which is exact; :func:`p_einsum`
and :func:`p_conv` accumulate the quantized values in float64, exact
for any realistic contraction length.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from veles.simd_tpu_torch.runtime.faults import getenv

__all__ = [
    "HIGHEST", "PRECISIONS", "JAX_PRECISIONS", "COMP_PRECISIONS",
    "ERROR_BUDGETS", "BF16_COMP_ENV", "INT8_ENV",
    "precision_allowed", "comp_route", "base_route", "split_bf16",
    "p_einsum", "p_matmul", "p_dot", "p_conv",
    "fp32_matmul", "fp32_conv",
]

# the JAX package's jax.lax.Precision.HIGHEST, as this layer names it
HIGHEST = "highest"

# the plain knobs: full fp32 ("highest", "high") or TF32 ("default")
JAX_PRECISIONS = ("highest", "high", "default")
# the split/quantized routes this layer implements
COMP_PRECISIONS = ("bf16", "bf16_comp", "int8")
PRECISIONS = JAX_PRECISIONS + COMP_PRECISIONS

# family-wide escape hatch for the compensated routes
BF16_COMP_ENV = "VELES_SIMD_DISABLE_BF16_COMP"
# int8 is opt-in: its ~1.6e-2 rel err exceeds every oracle gate, so
# engine eligibility requires an explicit operator decision; forced
# dispatch (precision="int8") stays available
INT8_ENV = "VELES_SIMD_ENABLE_INT8"

# per-precision relative-error budgets vs the float64 oracles
# (max-normalized), the JAX package's table
ERROR_BUDGETS = {
    "highest": 1e-6,
    "high": 5e-5,
    "default": 5e-2,
    "bf16_comp": 1e-4,
    "bf16": 5e-2,
    "int8": 5e-2,
}

_COMP_SUFFIX = "_bf16_comp"


def _env_truthy(name: str) -> bool:
    # routing.env_truthy's parser, inlined: this module sits below the
    # routing engine.  getenv is os.environ.get at a dict lookup's
    # cost: the *_bf16_comp gates read it on every dispatch
    return (getenv(name) or "0").strip().lower() in (
        "1", "true", "yes", "on")


def precision_allowed(precision: str) -> bool:
    """May implicit routing (engine eligibility) use ``precision``?

    ``bf16_comp`` unless ``VELES_SIMD_DISABLE_BF16_COMP`` is truthy;
    ``int8`` only when ``VELES_SIMD_ENABLE_INT8`` is truthy; plain
    ``bf16`` never (forced dispatch only); the plain knobs always."""
    if precision == "bf16_comp":
        return not _env_truthy(BF16_COMP_ENV)
    if precision == "int8":
        return _env_truthy(INT8_ENV)
    if precision == "bf16":
        return False
    return precision in JAX_PRECISIONS


def comp_route(base: str) -> str:
    """The ``bf16_comp`` variant's route name for a base route:
    ``rdft_matmul`` -> ``rdft_matmul_bf16_comp``."""
    return base + _COMP_SUFFIX


def base_route(name: str) -> str:
    """Inverse of :func:`comp_route` (identity for plain routes)."""
    return name[:-len(_COMP_SUFFIX)] if name.endswith(_COMP_SUFFIX) \
        else name


@contextlib.contextmanager
def _matmul_precision(setting: str):
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(setting)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def fp32_matmul():
    """Scope in which float32 matmuls run in full fp32 (no TF32)."""
    return _matmul_precision("highest")


def _tf32_matmul():
    """Scope in which float32 matmuls may run on the TF32 tensor
    cores."""
    return _matmul_precision("high")


def fp32_conv(device):
    """Scope in which a float32 convolution on ``device`` runs in full
    fp32: on CUDA, cuDNN enabled with TF32 off (the installed torch
    defaults cuDNN convolutions to TF32); elsewhere nothing to pin."""
    if torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def _tf32_conv(device):
    if torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=True)


def split_bf16(x):
    """``(hi, lo)`` bf16 split of a float operand: ``hi = bf16(x)``,
    ``lo = bf16(x - f32(hi))``.  ``f32(hi) + f32(lo)`` reconstructs x
    to ~2^-16 relative."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _quantize_int8(x):
    """Symmetric per-tensor int8 quantization with a dynamic scale.  A
    zero tensor gets scale 1 so the rescale never divides by zero.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    x = x.to(torch.float32)
    scale = torch.amax(torch.abs(x)) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _check(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {sorted(PRECISIONS)}, got "
            f"{precision!r}")
    return precision


def _contract(fn, a, b, precision, scope, int_fn=None):
    """Shared body: the float32 contraction ``fn(a, b)`` under one
    precision scheme; ``scope(tf32)`` pins the precision of ``fn``'s
    float32 passes.  ``int_fn(qa, qb)`` gives the int32 accumulators
    of the int8 operands (default: ``fn`` on their float64 values)."""
    if precision in JAX_PRECISIONS:
        with scope(precision == "default"):
            return fn(a, b)
    if precision in ("bf16", "bf16_comp"):
        ahi, alo = (p.to(torch.float32) for p in split_bf16(a))
        bhi, blo = (p.to(torch.float32) for p in split_bf16(b))
        with scope(True):
            if precision == "bf16":
                return fn(ahi, bhi)
            return fn(ahi, bhi) + fn(alo, bhi) + fn(ahi, blo)
    qa, sa = _quantize_int8(a)
    qb, sb = _quantize_int8(b)
    if int_fn is None:
        acc = fn(qa.to(torch.float64), qb.to(torch.float64))
    else:
        acc = int_fn(qa, qb)
    return acc.to(torch.float32) * (sa * sb)


def _matmul_scope(tf32: bool):
    return _tf32_matmul() if tf32 else fp32_matmul()


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _int_mm_2d(qa, qb):
    """``[m, k] @ [k, n]`` int8 -> int32 through ``torch._int_mm``,
    zero-padded to the shapes the card's kernel accepts (more than 16
    rows, k and n multiples of 8); zeros add nothing to an integer
    sum."""
    m, k = qa.shape
    n = qb.shape[1]
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(k, 8), \
        _round_up(n, 8)
    if (mp, kp) != (m, k):
        qa = F.pad(qa, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        qb = F.pad(qb, (0, np_ - n, 0, kp - k))
    return torch._int_mm(qa.contiguous(), qb.contiguous())[:m, :n]


def _int_matmul(qa, qb):
    """``torch.matmul`` semantics (1D operands, broadcast batch dims)
    for int8 operands with int32 accumulators."""
    a2 = qa.unsqueeze(0) if qa.dim() == 1 else qa
    b2 = qb.unsqueeze(-1) if qb.dim() == 1 else qb
    if b2.dim() == 2:
        # one product: a's batch dims fold into its rows
        out = _int_mm_2d(a2.reshape(-1, a2.shape[-1]), b2)
        out = out.reshape(a2.shape[:-1] + (b2.shape[-1],))
    else:
        batch = torch.broadcast_shapes(a2.shape[:-2], b2.shape[:-2])
        af = a2.expand(batch + a2.shape[-2:]).reshape(
            (-1,) + a2.shape[-2:])
        bf = b2.expand(batch + b2.shape[-2:]).reshape(
            (-1,) + b2.shape[-2:])
        out = torch.stack([_int_mm_2d(x, y) for x, y in zip(af, bf)])
        out = out.reshape(batch + out.shape[-2:])
    if qb.dim() == 1:
        out = out.squeeze(-1)
    if qa.dim() == 1:
        out = out.squeeze(-2)
    return out


def p_einsum(spec: str, a, b, precision: str = "highest"):
    """Two-operand einsum at a named precision (fp32 output for every
    scheme)."""
    _check(precision)
    return _contract(lambda x, y: torch.einsum(spec, x, y), a, b,
                     precision, _matmul_scope)


def p_matmul(a, b, precision: str = "highest"):
    """``torch.matmul`` at a named precision (batch dims broadcast as
    matmul does)."""
    _check(precision)
    return _contract(torch.matmul, a, b, precision, _matmul_scope,
                     _int_matmul)


def p_dot(m, v, precision: str = "highest"):
    """``m @ v`` at a named precision, the gemv form (``v`` 1D, or 2D
    where ``jnp.dot`` and ``matmul`` agree)."""
    _check(precision)
    if v.dim() > 2:
        raise ValueError(f"p_dot: v must be 1D or 2D, got {v.dim()}D")
    return _contract(torch.matmul, m, v, precision, _matmul_scope,
                     _int_matmul)


def p_conv(lhs, rhs, precision: str = "highest", **conv_kwargs):
    """``F.conv1d`` (3D ``rhs``) or ``F.conv2d`` (4D ``rhs``) at a named
    precision; ``stride``/``padding``/``dilation``/``groups`` pass
    through.  The compensated scheme applies the same three-term split
    as the matmuls: convolution is bilinear, so ``hi*hi + lo*hi +
    hi*lo`` recovers ~fp32 accuracy from bf16 passes."""
    _check(precision)
    conv = {3: F.conv1d, 4: F.conv2d}.get(rhs.dim())
    if conv is None:
        raise ValueError(f"p_conv: rhs must be 3D or 4D, got "
                         f"{rhs.dim()}D")

    def scope(tf32):
        return (_tf32_conv if tf32 else fp32_conv)(lhs.device)

    return _contract(lambda x, y: conv(x, y, **conv_kwargs), lhs, rhs,
                     precision, scope)
