"""Vectorized transcendental functions: sin / cos / log / exp (+ pow, sqrt).

The port of ``veles.simd_tpu.ops.mathfun`` (rebuild of the reference's
``inc/simd/mathfun.h`` and the cephes-style kernels it vendors): each
is one PyTorch elementwise call on ``Config.device``.

``log_psv`` is ``torch.log`` with the JAX package's special values
made explicit: the JAX package's range-reduced ``_log_f32`` exists
only because XLA's TPU ``log`` lost ~350 ulp, and it returns ``-inf``
for a subnormal input because XLA flushes subnormals to zero, where
``torch.log`` returns their true logarithm (-92.1 for 1e-40).  So here
a subnormal or a zero gives ``-inf``; x < 0 and NaN give NaN; +inf
gives +inf.

Naming keeps the reference's ``*_psv`` suffix ("packed single
vector").  Oracle twins use NumPy's libm-backed ufuncs, matching the
reference tests' use of libm as the oracle (``tests/mathfun.cc:59-84``).
"""

from __future__ import annotations

import numpy as np
import torch

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.utils import benchmark as bm
from veles.simd_tpu_torch.utils.config import resolve_simd
from veles.simd_tpu_torch.utils.platform import as_f32

__all__ = ["sin_psv", "cos_psv", "log_psv", "exp_psv", "pow_psv", "sqrt_psv"]

# the smallest normal float32
_F32_TINY = float(np.finfo(np.float32).tiny)


def _log(x):
    """Natural log, with subnormals flushed as the JAX package's XLA
    lowering flushes them: |x| below the smallest normal is a zero."""
    return torch.where(torch.abs(x) < _F32_TINY,
                       torch.full_like(x, -np.inf), torch.log(x))


def _one_op(*args):
    """``work=``: one operation an output element."""
    return bm.elementwise_work(1, 4, *args)


# each function an instrumented call, keyed ("mathfun", name) as the
# JAX package keys its cores
_TORCH = {name: obs.instrumented_jit(fn, op="mathfun", route=name,
                                     work=_one_op)
          for name, fn in (("sin", torch.sin), ("cos", torch.cos),
                           ("log", _log), ("exp", torch.exp),
                           ("sqrt", torch.sqrt))}
_POW = obs.instrumented_jit(torch.pow, op="mathfun", route="pow",
                            work=_one_op)

_NA = {"sin": np.sin, "cos": np.cos, "log": np.log, "exp": np.exp,
       "sqrt": np.sqrt}


def _psv(name, data, simd):
    if resolve_simd(simd, op="mathfun"):
        return _TORCH[name](as_f32(data))
    return _NA[name](np.asarray(data, dtype=np.float32))


def sin_psv(data, simd=None):
    """``mathfun.h:142-156``."""
    return _psv("sin", data, simd)


def cos_psv(data, simd=None):
    """``mathfun.h:158-172``."""
    return _psv("cos", data, simd)


def log_psv(data, simd=None):
    """``mathfun.h:174-188``."""
    return _psv("log", data, simd)


def exp_psv(data, simd=None):
    """``mathfun.h:190-204``."""
    return _psv("exp", data, simd)


def pow_psv(base, exponent, simd=None):
    """``avx_mathfun.h:720`` / ``neon_mathfun.h:307`` pow_ps."""
    if resolve_simd(simd, op="mathfun"):
        return _POW(as_f32(base), as_f32(exponent))
    return np.power(np.asarray(base, np.float32),
                    np.asarray(exponent, np.float32))


def sqrt_psv(data, simd=None):
    """``neon_mathfun.h:314`` sqrt_ps."""
    return _psv("sqrt", data, simd)


# reference-compatible oracle names (mathfun.h PsvStdFunc scalar path,
# mathfun.h:42-65) — f32 in/out like the dispatched oracle branch
def sin_psv_na(data):
    return np.sin(np.asarray(data, np.float32))


def cos_psv_na(data):
    return np.cos(np.asarray(data, np.float32))


def log_psv_na(data):
    return np.log(np.asarray(data, np.float32))


def exp_psv_na(data):
    return np.exp(np.asarray(data, np.float32))
