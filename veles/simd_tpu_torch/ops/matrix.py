"""BLAS L1/L2/L3 subset with engine-selected precisions.

The port of ``veles.simd_tpu.ops.matrix`` (rebuild of the reference's
``inc/simd/matrix.h`` + ``src/matrix.c``): one ``torch.matmul`` per
call on ``Config.device``, at the precision of a route of the
``matrix.gemm`` candidate table (:mod:`..runtime.routing` +
:mod:`..runtime.precision`).

* ``matrix_add(m1, m2)`` / ``matrix_sub(m1, m2)``      (``matrix.h:40-59``)
* ``matrix_multiply(m1, m2)``: ``[h1,w1] @ [h2=w1,w2] -> [h1,w2]``
  (``matrix.h:60-72``, oracle ``src/matrix.c:53-65``)
* ``matrix_multiply_transposed(m1, m2t)``: B supplied transposed,
  ``[h1,w1] @ [h2,w1]^T -> [h1,h2]`` (``matrix.h:74-89``)
* ``matrix_vector_multiply(m, v)`` — BLAS-L2 gemv (BASELINE.md
  config 3).

Routes: ``fp32`` (the static prior and the oracle-parity contract:
the product and its sums in float64, rounded once to float32; no TF32
anywhere), ``bf16_comp`` (three bf16 passes, fp32
accumulate; ``VELES_SIMD_DISABLE_BF16_COMP`` closes it), ``int8``
(scaled int8 on ``torch._int_mm``; eligible only under
``VELES_SIMD_ENABLE_INT8``) and ``bf16`` (one bf16 pass, forced only).
The engine's pick is the static prior ``fp32``, or under
``VELES_SIMD_AUTOTUNE`` the measured or cached winner among the
eligible routes (``runtime/routing.py``); ``precision=`` forces any
route, and ``fast=True`` is
the deprecated spelling of ``precision='bf16'``.  Every resolution is a
``matrix_precision_route`` decision event.  Leading batch dims
broadcast as ``torch.matmul`` does, for every route.

Why the ``fp32`` route sums in float64: an fp32 SGEMM accumulates each
output over K in float32, and at 2048^3 on the H100 that misses the
route's 1e-6 budget (``ERROR_BUDGETS["highest"]``) at 1.99e-6 of
max|y|.  The card's FP64 tensor cores peak at 67 TFLOP/s, the fp32
CUDA cores' rate, so the float64 GEMM costs no more than the SGEMM
and leaves only the output's rounding.
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.runtime import precision as prx
from veles.simd_tpu_torch.runtime import routing
from veles.simd_tpu_torch.utils import benchmark as bm
from veles.simd_tpu_torch.utils.config import get_config, resolve_simd
from veles.simd_tpu_torch.utils.platform import as_f32, as_tensor, lead_rows

__all__ = [
    "matrix_add", "matrix_sub", "matrix_multiply",
    "matrix_multiply_transposed", "matrix_vector_multiply",
    "GEMM_PRECISIONS",
]


def _contraction_work(a, b, w2):
    """``(flops, bytes)`` of ``a[..., h1, w]`` contracted with ``b``
    into ``w2`` columns a row: two operations a multiply-add, each
    operand read once and the float32 output written once."""
    lead = torch.broadcast_shapes(tuple(a.shape[:-2]), tuple(b.shape[:-2]))
    out = math.prod(lead) * int(a.shape[-2]) * int(w2)
    return (2.0 * out * int(a.shape[-1]),
            float(a.nbytes + b.nbytes + 4 * out))


def _ew_work(a, b):
    return bm.elementwise_work(1, 4, a, b)


@obs.instrumented_jit(work=_ew_work)
def _add(a, b):
    return a + b


@obs.instrumented_jit(work=_ew_work)
def _sub(a, b):
    return a - b


def _matmul(a, b, precision="highest"):
    if precision == "highest":
        # the fp32 route: float64 products and sums, rounded once
        return torch.matmul(a.to(torch.float64),
                            b.to(torch.float64)).to(torch.float32)
    return prx.p_matmul(a, b, precision=precision)


_matmul_p = obs.instrumented_jit(
    _matmul, op="matrix", route="gemm",
    work=lambda a, b, precision="highest": _contraction_work(
        a, b, b.shape[-1]))


@obs.instrumented_jit(
    op="matrix", route="gemm_t",
    work=lambda a, bt, precision="highest": _contraction_work(
        a, bt, bt.shape[-2]))
def _matmul_t_p(a, bt, precision="highest"):
    # batched "[..., h1, w] @ [..., h2, w]^T": contract the last dims
    return _matmul(a, bt.transpose(-1, -2), precision=precision)


_matvec_p = obs.instrumented_jit(
    _matmul, op="matrix", route="gemv",
    work=lambda m, v, precision="highest": _contraction_work(
        m, v, v.shape[-1] if v.dim() > 1 else 1))


# ---- the precision candidate table ----------------------------------------
# Route name -> the precision the cores contract at.  Table order is
# the static prior: fp32 first (oracle parity), the budget-gated
# bf16_comp and the opt-in int8 after it, forced-only bf16 last.
GEMM_PRECISIONS = {
    "fp32": "highest",
    "bf16_comp": "bf16_comp",
    "int8": "int8",
    "bf16": "bf16",
}

_GEMM_FAMILY = routing.family("matrix.gemm", (
    routing.Route(
        "fp32",
        roofline={"kind": "gemm"},
        doc="float64 products and sums rounded once to float32 (no "
            "TF32) — the oracle-parity static prior"),
    routing.Route(
        "bf16_comp",
        predicate=lambda **_: prx.precision_allowed("bf16_comp"),
        disable_env=prx.BF16_COMP_ENV,
        roofline={"kind": "gemm"},
        doc="split/compensated bf16 (3 passes, ~5e-6 rel err, inside "
            "the 1e-4 budget); VELES_SIMD_DISABLE_BF16_COMP opts out"),
    routing.Route(
        "int8",
        predicate=lambda **_: prx.precision_allowed("int8"),
        roofline={"kind": "gemm"},
        doc="dynamically scaled symmetric int8 (int32 accumulate, "
            "~1.6e-2 rel err) — refused unless VELES_SIMD_ENABLE_INT8"),
    routing.Route(
        "bf16",
        predicate=lambda **_: False,
        roofline={"kind": "gemm"},
        doc="plain 1-pass bf16 — forced-only (the fast=True shim): "
            "fails every oracle error budget, never engine-selected"),
))


def _resolve_precision_route(precision, fast: bool) -> str | None:
    """The forced-route half of the shim: an explicit ``precision=``
    names a route (or ``'highest'``); ``fast=True`` is the deprecated
    spelling of ``precision='bf16'``.  None = engine."""
    if fast and precision is None:
        # stacklevel 4: _resolve_precision_route <- _gemm_dispatch <-
        # matrix_multiply[_transposed] <- the caller's line
        warnings.warn(
            "matrix_multiply(fast=True) is deprecated: pass "
            "precision='bf16' (or let the engine pick — bf16_comp "
            "recovers fp32-class accuracy at the fast rate)",
            DeprecationWarning, stacklevel=4)
        precision = "bf16"
    if precision is None:
        return None
    if precision == "highest":
        precision = "fp32"
    if precision not in GEMM_PRECISIONS:
        raise ValueError(
            f"precision must be one of "
            f"{sorted(GEMM_PRECISIONS) + ['highest']}, got "
            f"{precision!r}")
    return precision


def _gemm_dispatch(core, a, b, geom: dict, precision, fast: bool):
    """Shared route resolution + decision event + in-span dispatch for
    the two GEMM entry points.  The engine's pick is the static prior
    ``fp32``, or the tune-cache winner or measured probe under
    ``VELES_SIMD_AUTOTUNE`` — precision as the candidate axis, as in
    the JAX package; it probes only the eligible names."""
    forced = _resolve_precision_route(precision, fast)
    chosen = _GEMM_FAMILY.select(
        route=forced,
        runners=lambda: {name: functools.partial(core, a, b, precision=p)
                         for name, p in GEMM_PRECISIONS.items()},
        probe_operand=a, **geom)
    obs.record_decision(
        "matrix_precision_route", chosen, forced=forced is not None,
        **geom)
    with obs.span("matrix.dispatch", route=chosen):
        return core(a, b, precision=GEMM_PRECISIONS[chosen])


def _gemm_tune_class(a, b, t: int) -> dict:
    """The ``matrix.gemm`` geometry class: every dim pow2-bucketed,
    plus the transposed-B flag."""
    rows = lead_rows(a.shape, 2)
    return {"h1": routing.pow2_bucket(int(a.shape[-2])),
            "w1": routing.pow2_bucket(int(a.shape[-1])),
            "w2": routing.pow2_bucket(int(b.shape[-2] if t
                                          else b.shape[-1])),
            "rows": routing.pow2_bucket(rows), "t": int(t)}


# ---- NumPy oracle twins (reference *_novec, src/matrix.c:37-80) ----------

def matrix_add_novec(m1, m2):
    """``src/matrix.c:37-43``."""
    return np.asarray(m1, np.float32) + np.asarray(m2, np.float32)


def matrix_sub_novec(m1, m2):
    """``src/matrix.c:45-51``."""
    return np.asarray(m1, np.float32) - np.asarray(m2, np.float32)


def matrix_multiply_novec(m1, m2):
    """``src/matrix.c:53-65`` triple loop, f32 accumulate."""
    return np.matmul(np.asarray(m1, np.float32), np.asarray(m2, np.float32))


def matrix_multiply_transposed_novec(m1, m2t):
    """``src/matrix.c:67-80``."""
    return np.einsum("...ij,...kj->...ik", np.asarray(m1, np.float32),
                     np.asarray(m2t, np.float32))


def matrix_vector_multiply_novec(m, v):
    return np.asarray(m, np.float32) @ np.asarray(v, np.float32)


# ---- public dispatching API ----------------------------------------------

def _check_2d(name, *ms):
    if not get_config().check_arguments:
        return
    for m in ms:
        if m.ndim < 2:
            raise ValueError(f"{name}: expected >=2D matrices, got {m.ndim}D")


def _check_contraction(m, v):
    """The JAX package's ``TypeError`` for a gemv whose vector does
    not match the matrix's width (torch would raise ``RuntimeError``),
    checked on the shapes before any torch call."""
    ms, vs = tuple(np.shape(m)), tuple(np.shape(v))
    if not ms or not vs:
        return
    w = vs[-2] if len(vs) >= 2 else vs[0]   # jnp.dot's contraction
    if ms[-1] != w:
        raise TypeError(
            "dot_general requires contracting dimensions to have the "
            f"same shape, got ({ms[-1]},) and ({w},).")


def _check_broadcast(name, m1, m2):
    """The JAX package's ``TypeError`` for operands that do not
    broadcast (torch would raise ``RuntimeError``), checked on the
    shapes before any torch call."""
    s1, s2 = tuple(np.shape(m1)), tuple(np.shape(m2))
    try:
        np.broadcast_shapes(s1, s2)
    except ValueError:
        raise TypeError(f"{name} got incompatible shapes for "
                        f"broadcasting: {s1}, {s2}.") from None


def matrix_add(m1, m2, simd=None):
    if resolve_simd(simd, op="matrix"):
        _check_broadcast("add", m1, m2)
        return _add(as_tensor(m1), as_tensor(m2))
    return matrix_add_novec(m1, m2)


def matrix_sub(m1, m2, simd=None):
    if resolve_simd(simd, op="matrix"):
        _check_broadcast("sub", m1, m2)
        return _sub(as_tensor(m1), as_tensor(m2))
    return matrix_sub_novec(m1, m2)


def matrix_multiply(m1, m2, simd=None, fast=False, precision=None):
    """``res[h1, w2] = m1[h1, w1] · m2[h2, w2]``, requires ``w1 == h2``
    (``matrix.h:71`` precondition, asserted at ``src/matrix.c:257-261``).

    ``precision`` forces a route of the ``matrix.gemm`` table
    (``fp32``/``bf16_comp``/``int8``/``bf16``); ``None`` lets the
    engine pick (the static prior ``fp32``).  ``fast=True`` is a
    deprecation shim for ``precision="bf16"``."""
    use = resolve_simd(simd, op="matrix")
    m1 = as_f32(m1) if use else np.asarray(m1)
    m2 = as_f32(m2) if use else np.asarray(m2)
    _check_2d("matrix_multiply", m1, m2)
    if m1.shape[-1] != m2.shape[-2]:
        raise ValueError(
            f"matrix_multiply: w1 ({m1.shape[-1]}) != h2 ({m2.shape[-2]})")
    if use:
        return _gemm_dispatch(_matmul_p, m1, m2,
                              _gemm_tune_class(m1, m2, t=0),
                              precision, fast)
    return matrix_multiply_novec(m1, m2)


def matrix_multiply_transposed(m1, m2t, simd=None, fast=False,
                               precision=None):
    """``res[h1, h2] = m1[h1, w1] · m2t[h2, w2=w1]^T``, requires ``w1 == w2``
    (``matrix.h:87`` precondition).  ``precision``/``fast`` as in
    :func:`matrix_multiply`."""
    use = resolve_simd(simd, op="matrix")
    m1 = as_f32(m1) if use else np.asarray(m1)
    m2t = as_f32(m2t) if use else np.asarray(m2t)
    _check_2d("matrix_multiply_transposed", m1, m2t)
    if m1.shape[-1] != m2t.shape[-1]:
        raise ValueError(
            f"matrix_multiply_transposed: w1 ({m1.shape[-1]}) != "
            f"w2 ({m2t.shape[-1]})")
    if use:
        return _gemm_dispatch(_matmul_t_p, m1, m2t,
                              _gemm_tune_class(m1, m2t, t=1),
                              precision, fast)
    return matrix_multiply_transposed_novec(m1, m2t)


def matrix_vector_multiply(m, v, simd=None, precision=None):
    """BLAS-L2 gemv: ``res[h] = m[h, w] · v[w]``.  ``precision``
    forces a named route (the gemv is bandwidth-bound, so the engine
    does not pick one: fp32 is the default)."""
    if resolve_simd(simd, op="matrix"):
        _check_contraction(m, v)
        route = _resolve_precision_route(precision, fast=False)
        return _matvec_p(as_f32(m), as_f32(v),
                         precision=GEMM_PRECISIONS[route or "fp32"])
    return matrix_vector_multiply_novec(m, v)
