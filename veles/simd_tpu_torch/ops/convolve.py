"""1D linear convolution: direct / FFT / overlap-save with auto-selection.

The port of ``veles.simd_tpu.ops.convolve`` (rebuild of the reference's
``src/convolve.c`` + ``inc/simd/convolve.h``): the same three
algorithms behind the same handle API, the same selection thresholds
and route tables, computed with PyTorch on ``Config.device``.

Routes, JAX name → port name where they differ:

* direct: ``direct_pallas`` → ``direct_cuda``, the filter-bank kernel
  (``csrc/filter_bank.cu``) for batched signals and short filters;
  ``direct_mxu`` → ``torch.nn.functional.conv1d`` with cuDNN pinned to
  fp32;
* overlap-save: ``pallas_fused`` → ``cuda_fused``, the overlap-save
  kernel (``csrc/overlap_save.cu``) for filters of 256 taps and more;
  ``xla_matmul``, the frames × Toeplitz block matmul in fp32;
  ``os_fft``, batched-frames ``torch.fft`` for filters beyond 16384
  taps;
* ``fft``: one padded ``torch.fft.rfft`` product.

:data:`ROUTE_NAMES` maps the JAX names to the port's.  There is no
fault or breaker wrapping yet: a kernel failure raises.

Result length is always ``x_length + h_length - 1`` (full linear
convolution); ``mode=`` slices it numpy's way.  All entry points accept
leading batch dimensions.  Results are float32 torch tensors on the
device; the ``simd=False`` oracle path returns NumPy.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch
import torch.nn.functional as F

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.ops import cuda_kernels as _ck
from veles.simd_tpu_torch.runtime import precision as prx
from veles.simd_tpu_torch.runtime import routing
from veles.simd_tpu_torch.utils.config import get_config, resolve_simd
from veles.simd_tpu_torch.utils.memory import (
    next_highest_power_of_2, zeropadding_length)
from veles.simd_tpu_torch.utils.platform import as_f32

__all__ = [
    "ConvolutionAlgorithm", "ConvolutionHandle", "handle_from_fields",
    "convolve_simd", "convolve_na",
    "convolve_fft", "convolve_fft_initialize", "convolve_fft_finalize",
    "convolve_overlap_save", "convolve_overlap_save_initialize",
    "convolve_overlap_save_finalize",
    "convolve", "convolve_initialize", "convolve_finalize",
    "fftconvolve", "oaconvolve",
    "overlap_save_block_length", "tpu_block_length", "select_algorithm",
    "os_precision", "StreamingConvolution",
    "streaming_carry_len", "select_stream_route", "causal_stream_block",
    "causal_stream_block_na", "ROUTE_NAMES",
]

# JAX package route name -> the port's name for the same route
ROUTE_NAMES = {"direct_pallas": "direct_cuda",
               "pallas_fused": "cuda_fused"}


class ConvolutionAlgorithm(enum.Enum):
    """Mirrors ``ConvolutionAlgorithm`` at the reference library's
    ``inc/simd/convolve_structs.h:39-46``."""

    BRUTE_FORCE = "brute_force"
    FFT = "fft"
    OVERLAP_SAVE = "overlap_save"


# Auto-select thresholds, as the JAX package has them, so routing
# matches the reference.  They were chosen from sweeps on a TPU and
# have not been measured on the H100.
AUTO_OVERLAP_SAVE_MIN_RATIO = 8     # x >= ratio*h -> overlap-save
AUTO_FFT_MIN_PRODUCT = 1 << 13      # x*h beyond which spectral wins
# within overlap-save: block matmul / kernel up to this many taps,
# batched-frames FFT beyond
AUTO_OS_MATMUL_MAX_H = 1 << 14


def overlap_save_step(h_length: int) -> int:
    """Output-block size of the block-matmul overlap-save route: a
    quarter of the filter's padded length, clamped to [256, 512] — the
    JAX package's rule, not yet measured on the H100."""
    return max(256, min(next_highest_power_of_2(int(h_length)) // 4, 512))


def overlap_save_block_length(h_length: int) -> int:
    """Reference block size: L = 2^(⌊log2 h⌋ + 2)
    (``src/convolve.c:115-121``)."""
    h_length = int(h_length)
    if h_length < 1:
        raise ValueError("h_length must be positive")
    return zeropadding_length(h_length)


def tpu_block_length(h_length: int, x_length: int) -> int:
    """Block size of the batched-frames FFT route: 8× the reference
    length, capped so a block never exceeds the whole problem — the
    JAX package's rule, not yet measured on the H100."""
    base = overlap_save_block_length(h_length)
    cap = next_highest_power_of_2(x_length + h_length - 1)
    return max(base, min(base * 8, cap))


def _fft_length(x_length: int, h_length: int) -> int:
    """Pad target for the full-FFT method: next pow2 ≥ x+h−1
    (``src/convolve.c:237-244``)."""
    return next_highest_power_of_2(x_length + h_length - 1)


# Algorithm-level candidate table: the JAX package's re-derivation of
# the reference heuristic src/convolve.c:328-364.  x >= 8h implies
# h < x//2, the overlap-save handle contract.
_ALGO_FAMILY = routing.family("convolve", (
    routing.Route(
        "brute_force",
        predicate=lambda x_length, h_length, **_:
            x_length * h_length < AUTO_FFT_MIN_PRODUCT,
        doc="latency floor"),
    routing.Route(
        "overlap_save",
        predicate=lambda x_length, h_length, **_:
            x_length >= AUTO_OVERLAP_SAVE_MIN_RATIO * h_length,
        doc="long signal, comparatively short filter: halo amortized"),
    routing.Route(
        "fft",
        doc="large balanced problems above the latency floor"),
))


def select_algorithm(x_length: int, h_length: int) -> ConvolutionAlgorithm:
    """Long signal with comparatively short filter → overlap-save;
    large balanced problem → FFT; otherwise direct."""
    return ConvolutionAlgorithm(_ALGO_FAMILY.static_select(
        x_length=int(x_length), h_length=int(h_length)))


# ---- operands --------------------------------------------------------------

def _length(a) -> int:
    return int(a.shape[-1]) if hasattr(a, "shape") else np.shape(a)[-1]


def _operands(x, h):
    """float32 tensors on one device: x's own when x is a tensor, else
    ``Config.device``; a non-tensor h follows x."""
    x = as_f32(x).contiguous()
    if isinstance(h, torch.Tensor):
        h = h.to(torch.float32)
        if h.device != x.device:
            raise ValueError(f"x on {x.device} but h on {h.device}")
    else:
        h = torch.as_tensor(np.asarray(h, np.float32), device=x.device)
    return x, h.contiguous()


# ---- direct form -----------------------------------------------------------

# Direct-form candidate table: the filter-bank kernel for batched
# signals with <= 256-tap filters, conv1d otherwise.
_DIRECT_FAMILY = routing.family("convolve.direct", (
    routing.Route(
        "direct_cuda",
        predicate=lambda rows, n, k, cuda=False, **_: (
            cuda and k <= _ck.DIRECT_MAX_H and rows >= _ck.MIN_ROWS
            and _ck.fits_smem_fb(1, k, 1, 1)),
        doc="shifted-MAC filter-bank kernel (batched, short filters)"),
    routing.Route("direct_mxu",
                  doc="conv1d, cuDNN pinned to fp32"),
))


def _use_cuda_direct(x, k: int) -> bool:
    """Route batched direct convolution through the filter-bank kernel
    — a thin delegate into the ``convolve.direct`` table.  Tests
    monkeypatch this gate."""
    rows = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1
    return _DIRECT_FAMILY.gate("direct_cuda", rows=rows,
                               n=int(x.shape[-1]), k=int(k),
                               cuda=x.is_cuda)


def _conv_direct_cuda(x, h, reverse=False):
    """Direct-form full convolution as the filter-bank kernel (its
    C=1 instance): the kernel reads the k-1 zero halo on each side and,
    for convolution, the taps reversed, so nothing is padded or flipped
    here."""
    n, k = x.shape[-1], h.shape[-1]
    (y,) = _ck.filter_bank_cuda(x, h.reshape(1, k), 1, 1, n + k - 1,
                                pad_left=k - 1, reverse_taps=not reverse)
    return y


def _conv_direct(x, h, reverse=False):
    """Direct-form full convolution with conv1d (which correlates, so
    convolution flips ``h``; ``reverse=True`` correlates)."""
    n, k = x.shape[-1], h.shape[-1]
    lhs = x.reshape(-1, 1, n)
    kernel = h if reverse else h.flip(-1)
    with prx.fp32_conv(x.device):
        out = F.conv1d(lhs, kernel.reshape(1, 1, k), padding=k - 1)
    return out.reshape(tuple(x.shape[:-1]) + (n + k - 1,))


_DIRECT_RUNNERS = {"direct_cuda": _conv_direct_cuda,
                   "direct_mxu": _conv_direct}


def _direct(x, h, reverse=False):
    """Direct-form dispatch — used by ``convolve_simd``, the
    BRUTE_FORCE handle path and ``correlate.cross_correlate_simd``."""
    eligible = (["direct_cuda", "direct_mxu"]
                if _use_cuda_direct(x, h.shape[-1]) else ["direct_mxu"])
    chosen = _DIRECT_FAMILY.select(eligible=eligible)
    return _DIRECT_RUNNERS[chosen](x, h, reverse=reverse)


# ---- FFT and overlap-save --------------------------------------------------

def _conv_fft(x, h, m, reverse=False):
    """Full-FFT method (``src/convolve.c:289-326``) with real FFTs."""
    n, k = x.shape[-1], h.shape[-1]
    kernel = h.flip(-1) if reverse else h
    spec = torch.fft.rfft(x, m) * torch.fft.rfft(kernel, m)
    return torch.fft.irfft(spec, m)[..., : n + k - 1]


def os_precision() -> str:
    """The block-matmul precision (``Config.conv_precision``); both
    values compute in fp32 in the port."""
    return get_config().conv_precision


# Overlap-save candidate table: the overlap-save kernel vs the fp32
# block matmul.  The static priors of the JAX table stay: the kernel
# for filters of 256 taps and more.
_OS_FAMILY = routing.family("convolve.os", (
    routing.Route(
        "cuda_fused",
        predicate=lambda h_length, cuda=False, **_: (
            cuda and h_length >= _ck.OS_MIN_H
            and _ck.fits_smem_os(h_length)),
        disable_env="VELES_SIMD_DISABLE_CUDA_OS",
        doc="overlap-save kernel: an FFT segment per block in shared "
            "memory, halo reloaded (VELES_SIMD_DISABLE_CUDA_OS opts "
            "out)"),
    routing.Route(
        "xla_matmul",
        doc="fp32 block matmul over gather-free shifted frames"),
))


def _use_cuda_os(h_length: int, x) -> bool:
    """Route the overlap-save handle through the overlap-save kernel
    — a thin delegate into the ``convolve.os`` table.  Tests
    monkeypatch this gate."""
    return _OS_FAMILY.gate("cuda_fused", h_length=int(h_length),
                           cuda=x.is_cuda)


def _conv_os_cuda(x, h, reverse=False):
    """Overlap-save as the overlap-save kernel."""
    kernel = h.flip(-1) if reverse else h
    return _ck.overlap_save_cuda(x, kernel.contiguous())


def _conv_os_matmul(x, h, step, reverse=False, precision=None):
    """Overlap-save with the per-block filter as one fp32 matmul.

    Outputs are computed in blocks of ``step`` samples; block i needs
    input samples ``[i*step - (k-1), i*step + step)``, so the signal is
    framed into overlapping rows ``frames[i, a] = x_ext[i*step + a]``
    and each block is ``frames @ M`` with ``M[a, t] = h[t + k - 1 - a]``.
    Both operands are built gather-free, as in the JAX package: frames
    are J shifted row-blocks of the padded signal, and the Toeplitz
    transpose MT comes from tiling ``[flip(h), zeros(step+1)]`` ``step``
    times, because ``t*(k+step) ≡ -t (mod k+step+1)``."""
    n, k, s = x.shape[-1], h.shape[-1], step
    out_len = n + k - 1
    n_blocks = -(-out_len // s)
    J = -(-(s + k - 1) // s)
    kernel = h.flip(-1) if reverse else h
    pad_tail = (n_blocks + J) * s - (n + k - 1)
    x_ext = F.pad(x, (k - 1, pad_tail))
    Z = x_ext.reshape(tuple(x.shape[:-1]) + (n_blocks + J, s))
    frames = torch.cat([Z[..., j:j + n_blocks, :] for j in range(J)],
                       dim=-1)[..., : s + k - 1]
    w = F.pad(kernel.flip(-1), (0, s + 1))                  # len k+s+1
    MT = w.repeat(s)[: s * (k + s)].reshape(s, k + s)[:, : s + k - 1]
    y = prx.p_einsum("...ba,ta->...bt", frames, MT,
                     precision=precision or "highest")
    y = y.reshape(tuple(y.shape[:-2]) + (n_blocks * s,))
    return y[..., :out_len]


def _conv_overlap_save(x, h, block_len, reverse=False):
    """Overlap-save as one batched-frames FFT (the long-filter path):
    every block is a row of a ``[n_blocks, L]`` frames view
    (``Tensor.unfold``) and one batched rfft/irfft covers them all."""
    n, k, L = x.shape[-1], h.shape[-1], block_len
    step = L - (k - 1)
    out_len = n + k - 1
    n_blocks = -(-out_len // step)
    kernel = h.flip(-1) if reverse else h
    H = torch.fft.rfft(kernel, L)
    pad_tail = (n_blocks - 1) * step + L - (k - 1) - n
    frames = F.pad(x, (k - 1, pad_tail)).unfold(-1, L, step)
    blocks = torch.fft.irfft(torch.fft.rfft(frames, L) * H, L)[..., k - 1:]
    flat = blocks.reshape(tuple(blocks.shape[:-2]) + (n_blocks * step,))
    return flat[..., :out_len]


# ---- NumPy oracles (reference scalar semantics) ---------------------------

def convolve_na(x, h):
    """Direct-form oracle (``src/convolve.c:49-100`` scalar branch)."""
    x = np.asarray(x, np.float32)
    h = np.asarray(h, np.float32)
    if x.ndim == 1:
        return np.convolve(x, h, mode="full").astype(np.float32)
    flat = x.reshape(-1, x.shape[-1])
    out = np.stack([np.convolve(row, h, mode="full") for row in flat])
    return out.reshape(x.shape[:-1] + (x.shape[-1] + h.shape[-1] - 1,)
                       ).astype(np.float32)


def _conv_fft_na(x, h, m, reverse=False):
    x = np.asarray(x, np.float32)
    h = np.asarray(h, np.float32)
    if reverse:
        h = h[..., ::-1]
    n, k = x.shape[-1], h.shape[-1]
    spec = np.fft.rfft(x, m, axis=-1) * np.fft.rfft(h, m, axis=-1)
    return np.fft.irfft(spec, m, axis=-1)[..., : n + k - 1].astype(np.float32)


def _conv_overlap_save_na(x, h, block_len, reverse=False):
    x = np.asarray(x, np.float32)
    h = np.asarray(h, np.float32)
    if reverse:
        h = h[..., ::-1]
    n, k = x.shape[-1], h.shape[-1]
    L = block_len
    step = L - (k - 1)
    out_len = n + k - 1
    n_blocks = -(-out_len // step)
    H = np.fft.rfft(h, L, axis=-1)
    pad_tail = (n_blocks - 1) * step + L - (k - 1) - n
    x_ext = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(k - 1, pad_tail)])
    idx = np.arange(n_blocks)[:, None] * step + np.arange(L)[None, :]
    frames = np.take(x_ext, idx, axis=-1)
    blocks = np.fft.irfft(np.fft.rfft(frames, L, axis=-1) * H[..., None, :],
                          L, axis=-1)[..., k - 1:]
    flat = blocks.reshape(blocks.shape[:-2] + (n_blocks * step,))
    return flat[..., :out_len].astype(np.float32)


# ---- handle API (parity with inc/simd/convolve.h:41-126) ------------------

@dataclasses.dataclass(frozen=True)
class ConvolutionHandle:
    """Plan handle (``inc/simd/convolve_structs.h:39-74``): the problem
    geometry and the chosen algorithm, field for field the JAX
    package's handle."""

    x_length: int
    h_length: int
    algorithm: ConvolutionAlgorithm
    reverse: bool = False
    fft_length: int | None = None
    block_length: int | None = None
    os_matmul: bool = False
    step: int | None = None

    @property
    def result_length(self) -> int:
        return self.x_length + self.h_length - 1


def handle_from_fields(d: dict) -> ConvolutionHandle:
    """The port's handle from the field dict of a JAX package handle
    (``dataclasses.asdict``); the algorithm may be either package's
    enum member or its string value."""
    d = dict(d)
    algo = d["algorithm"]
    d["algorithm"] = ConvolutionAlgorithm(getattr(algo, "value", algo))
    return ConvolutionHandle(**d)


def _make_handle(x_length, h_length, algorithm, reverse):
    x_length, h_length = int(x_length), int(h_length)
    if x_length < 1 or h_length < 1:
        raise ValueError("convolve: lengths must be positive "
                         "(src/convolve.c:44-48 assert contract)")
    forced = algorithm is not None
    if algorithm is None:
        algorithm = select_algorithm(x_length, h_length)
    algorithm = ConvolutionAlgorithm(algorithm)
    fft_len = block_len = step = None
    os_matmul = False
    if algorithm is ConvolutionAlgorithm.FFT:
        fft_len = _fft_length(x_length, h_length)
    elif algorithm is ConvolutionAlgorithm.OVERLAP_SAVE:
        if not h_length < x_length // 2:
            raise ValueError(
                "overlap-save requires h_length < x_length / 2 "
                "(src/convolve.c:105 assert contract, integer division)")
        block_len = tpu_block_length(h_length, x_length)
        os_matmul = h_length <= AUTO_OS_MATMUL_MAX_H
        step = overlap_save_step(h_length)
    obs.record_decision(
        "convolve", algorithm.value, x_length=x_length,
        h_length=h_length, forced=forced, fft_length=fft_len,
        block_length=block_len, os_matmul=os_matmul, step=step,
        reverse=bool(reverse))
    return ConvolutionHandle(x_length, h_length, algorithm, reverse,
                             fft_len, block_len, os_matmul, step)


def _check_lengths(handle, x, h):
    if not get_config().check_arguments:
        return
    if x.shape[-1] != handle.x_length or h.shape[-1] != handle.h_length:
        raise ValueError(
            f"handle is for x_length={handle.x_length}, "
            f"h_length={handle.h_length}; got {x.shape[-1]}, {h.shape[-1]}")


def _run(handle: ConvolutionHandle, x, h, simd=None):
    if resolve_simd(simd, op="convolve"):
        with obs.span("convolve.dispatch",
                      algo=handle.algorithm.value,
                      os_matmul=handle.os_matmul):
            return _run_torch(handle, x, h)
    return _run_oracle(handle, x, h)


def _run_oracle(handle: ConvolutionHandle, x, h):
    """The NumPy-oracle side of :func:`_run`."""
    x, h = np.asarray(x), np.asarray(h)
    _check_lengths(handle, x, h)
    if handle.reverse:
        h = h[..., ::-1]
    if handle.algorithm is ConvolutionAlgorithm.BRUTE_FORCE:
        return convolve_na(x, h)
    if handle.algorithm is ConvolutionAlgorithm.FFT:
        return _conv_fft_na(x, h, handle.fft_length)
    return _conv_overlap_save_na(x, h, handle.block_length)


_OS_RUNNERS = {
    "cuda_fused": lambda x, h, hd: _conv_os_cuda(x, h, reverse=hd.reverse),
    "xla_matmul": lambda x, h, hd: _conv_os_matmul(
        x, h, hd.step, reverse=hd.reverse, precision=os_precision()),
}


def _run_torch(handle: ConvolutionHandle, x, h):
    """The PyTorch side of :func:`_run`."""
    x, h = _operands(x, h)
    _check_lengths(handle, x, h)
    if handle.algorithm is ConvolutionAlgorithm.BRUTE_FORCE:
        return _direct(x, h, reverse=handle.reverse)
    if handle.algorithm is ConvolutionAlgorithm.FFT:
        return _conv_fft(x, h, handle.fft_length, reverse=handle.reverse)
    if handle.os_matmul:
        eligible = (["cuda_fused", "xla_matmul"]
                    if _use_cuda_os(handle.h_length, x)
                    else ["xla_matmul"])
        route = _OS_FAMILY.select(eligible=eligible)
        obs.record_decision(
            "convolve_os_route", route, x_length=handle.x_length,
            h_length=handle.h_length,
            step=(_ck.os_step(handle.h_length, handle.x_length)
                  if route == "cuda_fused" else handle.step))
        with obs.span("convolve.os_route", route=route):
            return _OS_RUNNERS[route](x, h, handle)
    return _conv_overlap_save(x, h, handle.block_length,
                              reverse=handle.reverse)


# ---- brute force -----------------------------------------------------------

def convolve_simd(x, h, simd=None):
    """Direct-form full convolution (``convolve_simd``,
    ``inc/simd/convolve.h:41-56``)."""
    if resolve_simd(simd, op="convolve_simd"):
        return _direct(*_operands(x, h))
    return convolve_na(x, h)


# ---- FFT method ------------------------------------------------------------

def convolve_fft_initialize(x_length, h_length, *, reverse=False):
    """``inc/simd/convolve.h:58-76`` — plan handle for the full-FFT
    method."""
    return _make_handle(x_length, h_length, ConvolutionAlgorithm.FFT, reverse)


def convolve_fft(handle, x, h, simd=None):
    return _run(handle, x, h, simd)


def convolve_fft_finalize(handle):
    """No-op (``convolve_fft_finalize``, ``src/convolve.c:280-287``)."""


# ---- overlap-save ----------------------------------------------------------

def convolve_overlap_save_initialize(x_length, h_length, *, reverse=False):
    """``inc/simd/convolve.h:78-96``."""
    return _make_handle(x_length, h_length,
                        ConvolutionAlgorithm.OVERLAP_SAVE, reverse)


def convolve_overlap_save(handle, x, h, simd=None):
    return _run(handle, x, h, simd)


def convolve_overlap_save_finalize(handle):
    """No-op (``src/convolve.c:148-154``)."""


# ---- auto-select -----------------------------------------------------------

def convolve_initialize(x_length, h_length, algorithm=None, *,
                        reverse=False):
    """``inc/simd/convolve.h:98-115`` — picks the algorithm via
    :func:`select_algorithm` unless forced.  ``reverse=True`` makes the
    handle cross-correlate (``src/correlate.c:128-143``)."""
    return _make_handle(x_length, h_length, algorithm, reverse=reverse)


def _check_mode(mode):
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"mode must be 'full', 'same' or 'valid', "
                         f"got {mode!r}")
    return mode


def _mode_slice(out, n, k, mode, correlate=False):
    """Slice a FULL conv/correlation result to numpy's ``mode``
    (correlation's 'same' window lands one sample later when
    ``n < k``, numpy's swap-and-reverse evaluation)."""
    if mode == "full":
        return out
    lo, hi = min(n, k), max(n, k)
    if mode == "same":
        start = lo // 2 if (correlate and n < k) else (lo - 1) // 2
        return out[..., start:start + hi]
    return out[..., lo - 1: hi]  # valid


def convolve(handle_or_x, x_or_h, h=None, simd=None, *, mode="full"):
    """Linear convolution: ``convolve(handle, x, h)`` (the handle API,
    ``inc/simd/convolve.h:117-126``) or ``convolve(x, h)`` (auto-select
    per call).  ``mode`` ('full', 'same', 'valid') slices the full
    result."""
    _check_mode(mode)
    if isinstance(handle_or_x, ConvolutionHandle):
        out = _run(handle_or_x, x_or_h, h, simd)
        return _mode_slice(out, handle_or_x.x_length,
                           handle_or_x.h_length, mode,
                           correlate=handle_or_x.reverse)
    x, h_ = handle_or_x, x_or_h
    if h is not None:       # convolve(x, h, simd) positional form
        simd = h
    handle = convolve_initialize(_length(x), _length(h_))
    return _mode_slice(_run(handle, x, h_, simd),
                       _length(x), _length(h_), mode)


def convolve_finalize(handle):
    """No-op (``src/convolve.c:368-379``)."""


def fftconvolve(x, h, mode: str = "full", simd=None):
    """scipy's ``fftconvolve`` by name: 1D taps (leading batch dims on
    ``x`` ride along) take the padded-rfft handle; a 2D kernel routes
    to :func:`veles.simd_tpu_torch.ops.convolve2d.convolve2d` with the
    fft algorithm; higher ranks are rejected as in the JAX package."""
    ndim = len(h.shape) if hasattr(h, "shape") else np.ndim(h)
    if ndim > 2:
        raise ValueError(
            f"kernels of rank {ndim} are not supported (1D taps "
            "or a 2D kernel; scipy's N-d fftconvolve has no equivalent "
            "here)")
    if ndim == 2:
        from veles.simd_tpu_torch.ops import convolve2d as cv2

        return cv2.convolve2d(x, h, algorithm="fft", simd=simd, mode=mode)
    handle = convolve_fft_initialize(_length(x), _length(h))
    return convolve(handle, x, h, simd=simd, mode=mode)


def oaconvolve(x, h, mode: str = "full", simd=None):
    """scipy's ``oaconvolve`` by name: the overlap-save handle, or
    :func:`fftconvolve` for sizes outside its contract (as scipy's
    oaconvolve falls back internally); a 2D kernel takes the 2D fft
    path like :func:`fftconvolve`."""
    ndim = len(h.shape) if hasattr(h, "shape") else np.ndim(h)
    if ndim == 1:
        try:
            handle = convolve_overlap_save_initialize(_length(x),
                                                      _length(h))
        except ValueError:
            return fftconvolve(x, h, mode=mode, simd=simd)
        return convolve(handle, x, h, simd=simd, mode=mode)
    return fftconvolve(x, h, mode=mode, simd=simd)


# ---- streaming convolution -------------------------------------------------

def streaming_carry_len(h_length: int) -> int:
    """Input-history samples a causal streaming FIR carries between
    blocks: ``h_length - 1``."""
    return max(int(h_length) - 1, 0)


def select_stream_route(x_length: int, h_length: int) -> str:
    """Route for one causal streaming-FIR block, from the ``convolve``
    candidate table."""
    return _ALGO_FAMILY.select(x_length=int(x_length),
                               h_length=int(h_length))


def causal_stream_block(x_ext, h, route: str, reverse: bool = False):
    """Causal-FIR block over a halo-extended signal: ``x_ext[...,
    carry + b]`` is the previous block's ``h_length - 1`` trailing
    input samples followed by the new block; returns the ``b`` causal
    outputs.  ``route`` comes from :func:`select_stream_route`."""
    x_ext, h = _operands(x_ext, h)
    k, n = int(h.shape[-1]), int(x_ext.shape[-1])
    if route == "fft":
        full = _conv_fft(x_ext, h, _fft_length(n, k), reverse=reverse)
    elif route == "overlap_save" and k <= AUTO_OS_MATMUL_MAX_H:
        full = _conv_os_matmul(x_ext, h, overlap_save_step(k),
                               reverse=reverse, precision=os_precision())
    else:
        full = _conv_direct(x_ext, h, reverse=reverse)
    return full[..., k - 1:n]


def causal_stream_block_na(x_ext, h, reverse: bool = False):
    """NumPy float64 oracle twin of :func:`causal_stream_block`."""
    x_ext = np.asarray(x_ext, np.float64)
    h = np.asarray(h, np.float64)
    if reverse:
        h = h[..., ::-1]
    k = h.shape[-1]
    n = x_ext.shape[-1]
    full = convolve_na(x_ext, h)
    return full[..., k - 1:n]


class StreamingConvolution:
    """Chunked streaming convolution with carried overlap state.

    The state between calls is the last ``h_length - 1`` input
    samples, and the concatenated outputs equal the one-shot full
    convolution::

        sc = StreamingConvolution(h, chunk_length=4096)
        ys = [sc.process(c) for c in chunks]   # len(c) == chunk_length
        ys.append(sc.flush())                  # final h_length-1 samples

    Chunks may carry leading batch dims, fixed across calls.
    ``reverse=True`` streams cross-correlation.  :meth:`carry` and
    :meth:`load_carry` move the carry in and out as NumPy, so a stream
    can continue in the JAX package or come over from it.
    """

    def __init__(self, h, chunk_length: int, *, reverse: bool = False,
                 simd=None):
        self._h = np.asarray(h, np.float32)
        if self._h.ndim != 1:
            raise ValueError("h must be 1D")
        self._k = int(self._h.shape[-1])
        self._chunk_length = int(chunk_length)
        if self._chunk_length < 1:
            raise ValueError("chunk_length must be positive")
        self._reverse = bool(reverse)
        # backend resolved ONCE: a stateful stream must not switch
        # backends mid-flight
        self._use_torch = resolve_simd(simd, op="streaming_convolve")
        k = self._k
        self._chunk_handle = convolve_initialize(
            self._chunk_length + k - 1, k, reverse=reverse)
        self._flush_handle = convolve_initialize(k - 1, k, reverse=reverse) \
            if k > 1 else None
        self._carry = None          # [..., k-1] trailing input samples
        self._done = False

    @property
    def h_length(self) -> int:
        return self._k

    @property
    def chunk_length(self) -> int:
        return self._chunk_length

    def carry(self):
        """The carried ``[..., h_length - 1]`` input samples as a NumPy
        float32 array, or None before the first chunk."""
        if self._carry is None:
            return None
        if self._use_torch:
            return self._carry.cpu().numpy().copy()
        return np.array(self._carry, np.float32)

    def load_carry(self, carry) -> None:
        """Continue from a carry taken from another stream (this
        package's or the JAX package's ``StreamingConvolution``) over
        the same filter: the next chunk sees ``carry`` as its
        history."""
        if self._done:
            raise ValueError("stream already flushed")
        carry = np.array(carry, np.float32)
        if carry.ndim < 1 or carry.shape[-1] != self._k - 1:
            raise ValueError(f"carry must be [..., {self._k - 1}], got "
                             f"{carry.shape}")
        self._carry = as_f32(carry) if self._use_torch else carry

    def process(self, chunk):
        """Feed the next ``chunk_length`` samples; returns the same
        count of output samples (causal: output t depends on inputs
        ≤ t)."""
        if self._done:
            raise ValueError("stream already flushed")
        if self._use_torch:
            chunk = as_f32(chunk)
            if self._carry is not None:
                chunk = chunk.to(self._carry.device)
        else:
            chunk = np.asarray(chunk, np.float32)
        if chunk.shape[-1] != self._chunk_length:
            raise ValueError(
                f"chunk length {chunk.shape[-1]} != {self._chunk_length} "
                "(fixed per stream)")
        k = self._k
        batch = tuple(chunk.shape[:-1])
        if self._carry is None:
            self._carry = (chunk.new_zeros(batch + (k - 1,))
                           if self._use_torch
                           else np.zeros(batch + (k - 1,), np.float32))
        if tuple(self._carry.shape[:-1]) != batch:
            raise ValueError(
                f"batch shape changed mid-stream: {batch} vs "
                f"{tuple(self._carry.shape[:-1])}")
        if k == 1:
            return _run(self._chunk_handle, chunk, self._h,
                        simd=self._use_torch)
        if self._use_torch:
            x_ext = torch.cat([self._carry, chunk], -1)
        else:
            x_ext = np.concatenate([self._carry, chunk], -1)
        full = _run(self._chunk_handle, x_ext, self._h,
                    simd=self._use_torch)
        self._carry = x_ext[..., -(k - 1):]
        return full[..., k - 1:k - 1 + self._chunk_length]

    def flush(self):
        """Emit the final ``h_length - 1`` output samples.  The stream
        cannot be used afterwards.  A stream that never saw a chunk,
        or ``h_length == 1``, returns an empty array."""
        if self._done:
            raise ValueError("stream already flushed")
        self._done = True
        k = self._k
        if self._carry is None or k == 1:
            shape = ((0,) if self._carry is None
                     else tuple(self._carry.shape[:-1]) + (0,))
            empty = np.zeros(shape, np.float32)
            if not self._use_torch:
                return empty
            if self._carry is None:
                return as_f32(empty)
            return self._carry.new_zeros(shape)
        full = _run(self._flush_handle, self._carry, self._h,
                    simd=self._use_torch)
        return full[..., k - 1:]
