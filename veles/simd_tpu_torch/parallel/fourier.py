"""Sharded Fourier: the Cooley-Tukey N = N1*N2 sharded DFT as matmul
stages, with mesh-aware routing (the port's
``veles.simd_tpu.parallel.fourier``).

* :func:`sharded_dft` / :func:`sharded_rfft` / :func:`sharded_irfft` —
  the signal viewed ``[N2, N1]`` (row-major, so the natural
  length-sharding IS the ``n1``-column sharding), a per-factor DFT
  basis matmul (length-N2 stage on complete local columns, fp32), the
  twiddle multiply, ONE tiled ``all_to_all`` transpose, the length-N1
  stage, and a second ``all_to_all`` that lands the spectrum back in
  natural order — all inside the shard runner
  (:mod:`veles.simd_tpu_torch.parallel._spmd`) through the
  ``_instrumented()`` wrapper, so the resource axis sees each program.
  The collective payloads are stacked real pairs, as in the JAX
  package.

* **mesh-aware routing** — the ``parallel.fourier`` candidate table
  (:mod:`veles.simd_tpu_torch.runtime.routing`) holds
  ``sharded_matmul_dft``, the ``local_fft`` fallback (one
  ``torch.fft`` call on the mesh's first device) and the
  ``sharded_matmul_dft_bf16_comp`` variant.  The static predicate
  models both sides with the H100's rates
  (:mod:`veles.simd_tpu_torch.utils.benchmark`): the matmul side at
  the fp32 (or bf16) peak plus the two all-to-alls at the copy rate
  between the mesh's shards (half of HBM's on one card), the FFT side
  at the larger of its operations over the fp32 peak and its bytes
  over HBM.  On one card the local FFT wins every geometry (the FFT
  is bound by bytes; a dense stage costs 2·sqrt(N) FLOPs a sample),
  where the JAX package's TPU model picks the matmul route from
  2^17 samples on.  The measured autotuner probes the real sharded
  dispatch; the tune-cache geometry class embeds
  ``routing.mesh_class(mesh, axis)``.

* **local frame transforms** — ``parallel.frame_dft``: the per-frame
  transform the sharded STFT/ISTFT/Welch bodies run on complete
  frames: the ``rdft_matmul`` basis matmul within the single-card
  cutoff, the Cooley-Tukey ``ct_matmul`` factorization above it,
  ``xla_fft`` (``torch.fft``) terminal.  :func:`frame_rfft_fn` /
  :func:`frame_irfft_fn` build the bodies; ``parallel/ops.py``
  consumes them.
"""

from __future__ import annotations

import collections
import functools
import threading

import numpy as np
import torch

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.ops import spectral as sp
from veles.simd_tpu_torch.parallel import _spmd
from veles.simd_tpu_torch.parallel._spmd import P
from veles.simd_tpu_torch.runtime import faults, routing
from veles.simd_tpu_torch.runtime import precision as prx
from veles.simd_tpu_torch.utils.benchmark import (
    GEMM_PEAK_TFLOPS, H100_FP32_TFLOPS, H100_HBM_TBPS, a2a_bytes,
    ct_dft_flops, mesh_copy_gbps, rfft_flops)
from veles.simd_tpu_torch.utils.platform import device as _config_device
from veles.simd_tpu_torch.utils.platform import lead_rows

__all__ = ["sharded_dft", "sharded_rfft", "sharded_irfft",
           "frame_rfft_fn", "frame_irfft_fn", "select_frame_route",
           "SHARDED_DFT_MIN_N", "SHARDED_DFT_ENV"]


# below this length the factorized route is never eligible: the two
# collective rounds' dispatch latency swamps any matmul win long
# before the bandwidth model below can see it
SHARDED_DFT_MIN_N = 4096
# family-wide escape hatch, mirroring VELES_SIMD_DISABLE_DFT_MATMUL
# for the single-card matmul-DFT routes
SHARDED_DFT_ENV = "VELES_SIMD_DISABLE_SHARDED_DFT"


def _instrumented(op: str, run_fn):
    """Route one shard_map program through the instrumented call —
    same contract as ``parallel/ops.py``: sharded programs land in the
    resource axis like every single-card call site."""
    return obs.instrumented_jit(run_fn, op=op, route="shard_map")


# ---------------------------------------------------------------------------
# the mesh-aware cost model + candidate table
# ---------------------------------------------------------------------------

# all_to_all payload bytes per complex sample at each precision: the
# f32 (re, im) pair, but for the forced-only "bf16" route (the JAX
# package's table; a bf16 payload misses the bf16_comp budget)
A2A_PAYLOAD_BYTES = {"highest": 8, "high": 8, "bf16_comp": 8,
                     "bf16": 4}


def _modeled_costs(n, n1, n2, rows, n_shards, precision="highest",
                   cards=1):
    """``(t_matmul_s, t_local_fft_s, bytes_per_a2a)`` — the static
    prior's two sides on the H100.  The matmul side is a shard's share
    of the two dense stages at the GEMM peak of ``precision``
    (``utils.benchmark.GEMM_PEAK_TFLOPS``) plus a shard's share of the
    two all-to-alls at the copy rate between shards
    (:func:`~veles.simd_tpu_torch.utils.benchmark.mesh_copy_gbps` over
    ``cards`` distinct cards); the FFT side is the whole transform on
    one card, the larger of its operations over the fp32 peak and its
    bytes (fp32 in, complex64 out) over HBM."""
    rows, n = int(rows), int(n)
    s = max(1, int(n_shards))
    bytes_a2a = a2a_bytes(rows * n, A2A_PAYLOAD_BYTES[precision],
                          n_shards)
    t_mm = (ct_dft_flops(n, n1, n2) * rows / s
            / (GEMM_PEAK_TFLOPS[precision] * 1e12)
            + 2.0 * (bytes_a2a / s) / (mesh_copy_gbps(cards) * 1e9))
    fft_bytes = rows * (4.0 * n + 8.0 * (n // 2 + 1))
    t_fft = max(rfft_flops(n) * rows / (H100_FP32_TFLOPS * 1e12),
                fft_bytes / (H100_HBM_TBPS * 1e12))
    return t_mm, t_fft, bytes_a2a


def _matmul_dft_viable(n, n_shards, rows=1, n1=0, n2=0, cards=1, **_):
    """The ``sharded_matmul_dft`` geometry gate: a factorization with
    both factors mesh-divisible must exist, the transform must be
    large enough that two collective rounds can pay for themselves,
    and the cost model must favor the matmul formulation."""
    if not n1 or not n2 or n_shards < 2 or n < SHARDED_DFT_MIN_N:
        return False
    t_mm, t_fft, _ = _modeled_costs(n, n1, n2, rows, n_shards,
                                    cards=cards)
    return t_mm < t_fft


def _matmul_dft_comp_viable(n, n_shards, rows=1, n1=0, n2=0, cards=1,
                            **_):
    """The ``sharded_matmul_dft_bf16_comp`` gate: the factorized
    pipeline must be structurally available AND the compensated
    precision allowed; viability reuses the cost model at the comp
    route's own peak."""
    if not prx.precision_allowed("bf16_comp"):
        return False
    if not n1 or not n2 or n_shards < 2 or n < SHARDED_DFT_MIN_N:
        return False
    t_mm, t_fft, _ = _modeled_costs(n, n1, n2, rows, n_shards,
                                    precision="bf16_comp", cards=cards)
    return t_mm < t_fft


_FOURIER_FAMILY = routing.family("parallel.fourier", (
    routing.Route(
        "sharded_matmul_dft",
        predicate=_matmul_dft_viable,
        disable_env=SHARDED_DFT_ENV,
        roofline={"kind": "dft_matmul"},
        doc="Cooley-Tukey N=N1*N2: per-factor DFT-basis matmul stages "
            "+ twiddle, all_to_all transposes between stages; the "
            "bytes between shards in the selector and the decision "
            "event"),
    routing.Route(
        "local_fft",
        roofline={"kind": "fft"},
        doc="one torch.fft call on the gathered operand — the "
            "terminal fallback when the mesh or the size cannot pay "
            "for the transposes"),
    # precision-variant candidate AFTER the terminal fallback (the
    # cross-family convention, runtime/precision.py): never the
    # static prior, probed and crowned per geometry by the autotuner
    routing.Route(
        "sharded_matmul_dft_bf16_comp",
        predicate=_matmul_dft_comp_viable,
        disable_env=prx.BF16_COMP_ENV,
        roofline={"kind": "dft_matmul"},
        doc="the factorized pipeline with bf16_comp stage matmuls "
            "over the exact f32 all_to_all payload"),
))

def _select_fourier_route(op, n, n_shards, rows, n1, n2, cards=1) -> str:
    """The STATIC route decision for one sharded transform, in table
    priority order — thin delegate into the ``parallel.fourier``
    candidate table."""
    return _FOURIER_FAMILY.static_select(
        op=str(op), n=int(n), n_shards=int(n_shards), rows=int(rows),
        n1=int(n1), n2=int(n2), cards=int(cards))


def _fourier_tune_class(op, n, rows, mesh, axis) -> dict:
    """The tune-cache geometry CLASS: pow2-bucketed churning dims plus
    the MESH CLASS token, so a pack built on one mesh shape is never
    looked up for another."""
    return {"op": str(op), "n": routing.pow2_bucket(int(n)),
            "rows": routing.pow2_bucket(int(rows)),
            "mesh": routing.mesh_class(mesh, axis)}


def _cards(mesh) -> int:
    """Distinct cards among the mesh's shards (0 on the CPU)."""
    return len({d for d in mesh.devices.flat if d.type == "cuda"})


# ---------------------------------------------------------------------------
# the sharded Cooley-Tukey program
# ---------------------------------------------------------------------------

def _mesh_device(mesh, x) -> torch.device:
    """The mesh's first device, after checking that a tensor operand
    lies on the mesh's kind of device (a CUDA operand on a CPU mesh,
    or the reverse, raises)."""
    dev = mesh.first_device(_spmd._rank(mesh))
    if isinstance(x, torch.Tensor) and x.device.type != dev.type:
        raise ValueError(f"operand on {x.device} for a mesh of "
                         f"{dev.type} devices")
    return dev


def _split_complex(x, dev):
    """``(re, im)`` float32 tensors on ``dev`` of a possibly-complex
    operand: host complex splits on the host, tensors on the device,
    real operands get ``im=None``."""
    if isinstance(x, torch.Tensor):
        x = x.to(dev)
        if torch.is_complex(x):
            return x.real.to(torch.float32), x.imag.to(torch.float32)
        return x.to(torch.float32), None
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return (torch.as_tensor(np.ascontiguousarray(x.real, np.float32),
                                device=dev),
                torch.as_tensor(np.ascontiguousarray(x.imag, np.float32),
                                device=dev))
    return torch.as_tensor(np.array(x, np.float32), device=dev), None


def _hermitian_parts(re, im, n):
    """Full length-``n`` spectrum parts from one-sided bins (real
    signal symmetry), all-real arithmetic."""
    bins = n // 2 + 1
    tr = re[..., 1:n - bins + 1].flip(-1)
    ti = -im[..., 1:n - bins + 1].flip(-1)
    return torch.cat([re, tr], dim=-1), torch.cat([im, ti], dim=-1)


# one built sharded CT program per (op, mesh, layout, direction)
# class: the shard_map closure and its instrumented wrapper are built
# ONCE and reused, so the resource axis records each class once and
# the autotuner's probe bursts time dispatch, not construction
_PROGRAM_CACHE_MAXSIZE = 64
_program_cache: "collections.OrderedDict[tuple, object]" = \
    collections.OrderedDict()
_program_lock = threading.Lock()
_program_stats = {"hits": 0, "misses": 0, "evictions": 0}
obs.register_cache("fourier_program_lru", lambda: {
    "size": len(_program_cache), "capacity": _PROGRAM_CACHE_MAXSIZE,
    **_program_stats})


def _ct_program(op, mesh, axis, nd, real_in, complex_out, sign,
                scale, precision="highest"):
    """The cached instrumented program for one CT dispatch class
    (factor sizes flow in through the operand shapes); ``precision``
    keys the class."""
    key = (op, mesh, axis, nd, real_in, complex_out, sign, scale,
           precision)
    with _program_lock:
        prog = _program_cache.get(key)
        if prog is not None:
            _program_stats["hits"] += 1
            _program_cache.move_to_end(key)
            return prog
        _program_stats["misses"] += 1
    built = _build_ct_program(op, mesh, axis, nd, real_in,
                              complex_out, sign, scale, precision)
    with _program_lock:
        prog = _program_cache.setdefault(key, built)
        _program_cache.move_to_end(key)
        while len(_program_cache) > _PROGRAM_CACHE_MAXSIZE:
            _program_cache.popitem(last=False)
            _program_stats["evictions"] += 1
    return prog


def _build_ct_program(op, mesh, axis, nd, real_in, complex_out, sign,
                      scale, precision="highest"):
    lead = [None] * (nd - 2)
    spec_v = P(*(lead + [None, axis]))
    spec_tw = P(None, axis)
    spec_out = P(*(lead + [axis]))
    sgn = float(np.float32(sign))
    scl = float(np.float32(scale)) if scale is not None else None

    in_specs = ((spec_v,) if real_in else (spec_v, spec_v)) + \
        (P(), P(), P(), P(), spec_tw, spec_tw)

    def _a2a(parts, split_axis_off, concat_axis_off):
        """ONE tiled collective over the stacked real parts — f32 at
        every precision (A2A_PAYLOAD_BYTES)."""
        st = torch.stack(parts)
        st = _spmd.all_to_all(
            st, axis, split_axis=st.dim() - split_axis_off,
            concat_axis=st.dim() - concat_axis_off, tiled=True)
        return tuple(st[i] for i in range(len(parts)))

    def _run(*args):
        if real_in:
            xre, b_ca, b_sa, b_cb, b_sb, twc_l, tws_l = args
            xim = None
        else:
            xre, xim, b_ca, b_sa, b_cb, b_sb, twc_l, tws_l = args
        e1 = functools.partial(prx.p_einsum, "...gf,gh->...hf",
                               precision=precision)
        e2 = functools.partial(prx.p_einsum, "...hf,fk->...hk",
                               precision=precision)
        # stage 1: length-ga DFT on complete local columns
        if xim is None:
            yre, yim = e1(xre, b_ca), sgn * e1(xre, b_sa)
        else:
            yre = e1(xre, b_ca) - sgn * e1(xim, b_sa)
            yim = sgn * e1(xre, b_sa) + e1(xim, b_ca)
        # twiddle (the local [ga, gb/S] slice rides the same sharding)
        tim = sgn * tws_l
        zre = yre * twc_l - yim * tim
        zim = yre * tim + yim * twc_l
        # all_to_all transpose #1: ga-split so stage 2 sees complete
        # rows; stacked real parts = ONE collective
        zre, zim = _a2a((zre, zim), split_axis_off=2, concat_axis_off=1)
        # stage 2: length-gb DFT along the now-complete last axis
        wre = e2(zre, b_cb) - sgn * e2(zim, b_sb)
        wim = sgn * e2(zre, b_sb) + e2(zim, b_cb)
        # all_to_all transpose #2: back to natural contiguous
        # sharding of k = k_b * ga + g_a
        wre, wim = _a2a((wre, wim), split_axis_off=1, concat_axis_off=2)
        wre = wre.transpose(-1, -2)
        wre = wre.reshape(tuple(wre.shape[:-2]) + (-1,))
        if scl is not None:
            wre = wre * scl
        if not complex_out:
            return wre
        wim = wim.transpose(-1, -2)
        wim = wim.reshape(tuple(wim.shape[:-2]) + (-1,))
        if scl is not None:
            wim = wim * scl
        return torch.complex(wre, wim)

    return _instrumented(op, _spmd.shard_map(
        _run, mesh, in_specs=in_specs, out_specs=spec_out))


def _ct_sharded(op, vre, vim, mesh, axis, ga, gb, sign, scale,
                out_kind, precision="highest"):
    """Dispatch one factorized transform: ``v`` viewed ``[..., ga,
    gb]`` with ``gb`` sharded over ``mesh[axis]``; stage 1 is the
    length-``ga`` DFT on complete local columns, stage 2 the
    length-``gb`` DFT after the ``all_to_all`` transpose, and a second
    ``all_to_all`` restores natural contiguous sharding of the output
    index ``k_b * ga + g_a``."""
    s = mesh.shape[axis]
    if ga % s or gb % s:
        raise ValueError(
            f"factors ({ga}, {gb}) must both be divisible by "
            f"{axis}={s} for the all_to_all transposes")
    # ct_basis_device is keyed (larger, smaller); map the (ga, gb)
    # stage roles onto its three grids ([smaller, smaller] basis,
    # [larger, larger] basis, [smaller, larger] twiddle)
    c_lo, s_lo, c_hi, s_hi, twc, tws = sp.ct_basis_device(
        max(ga, gb), min(ga, gb), vre.device)
    if ga == min(ga, gb):
        ca, sa, cb, sb = c_lo, s_lo, c_hi, s_hi
        twc_g, tws_g = twc, tws          # [ga, gb] already
    else:
        ca, sa, cb, sb = c_hi, s_hi, c_lo, s_lo
        twc_g, tws_g = twc.T, tws.T      # symmetric angle grid
    real_in = vim is None
    run = _ct_program(op, mesh, axis, vre.dim(), real_in,
                      out_kind == "complex", float(sign),
                      None if scale is None else float(scale),
                      precision)
    args = (vre,) if real_in else (vre, vim)
    return run(*args, ca, sa, cb, sb, twc_g, tws_g)


# ---------------------------------------------------------------------------
# route runners (the *_ROUTES tables the dispatchers index in-span)
# ---------------------------------------------------------------------------

@functools.partial(obs.instrumented_jit, op="sharded_rfft",
                   route="local_fft")
def _rfft_local_core(x):
    return torch.fft.rfft(x, dim=-1)


@functools.partial(obs.instrumented_jit, op="sharded_dft",
                   route="local_fft")
def _dft_local_core(re, im):
    return torch.fft.fft(torch.complex(re, im), dim=-1)


@functools.partial(obs.instrumented_jit, op="sharded_irfft",
                   route="local_fft")
def _irfft_local_core(re, im, n):
    return torch.fft.irfft(torch.complex(re, im), n, dim=-1)


def _run_rfft_matmul(x, mesh, axis, n1, n2, forced=False,
                     precision="highest"):
    del forced
    n = n1 * n2
    vre, _ = _split_complex(x, _mesh_device(mesh, x))
    vre = vre.reshape(tuple(vre.shape[:-1]) + (n2, n1))
    full = _ct_sharded("sharded_rfft", vre, None, mesh, axis,
                       ga=n2, gb=n1, sign=-1.0, scale=None,
                       out_kind="complex", precision=precision)
    return full[..., :n // 2 + 1]


def _run_rfft_matmul_comp(x, mesh, axis, n1, n2, forced=False):
    return _run_rfft_matmul(x, mesh, axis, n1, n2, forced=forced,
                            precision="bf16_comp")


def _run_rfft_local(x, mesh, axis, n1, n2, forced=False):
    del axis, n1, n2, forced
    re, _ = _split_complex(x, _mesh_device(mesh, x))
    return _rfft_local_core(re)


def _run_dft_matmul(x, mesh, axis, n1, n2, forced=False,
                    precision="highest"):
    del forced
    vre, vim = _split_complex(x, _mesh_device(mesh, x))
    if vim is None:
        vim = torch.zeros_like(vre)
    vre = vre.reshape(tuple(vre.shape[:-1]) + (n2, n1))
    vim = vim.reshape(tuple(vim.shape[:-1]) + (n2, n1))
    return _ct_sharded("sharded_dft", vre, vim, mesh, axis,
                       ga=n2, gb=n1, sign=-1.0, scale=None,
                       out_kind="complex", precision=precision)


def _run_dft_matmul_comp(x, mesh, axis, n1, n2, forced=False):
    return _run_dft_matmul(x, mesh, axis, n1, n2, forced=forced,
                           precision="bf16_comp")


def _run_dft_local(x, mesh, axis, n1, n2, forced=False):
    del axis, n1, n2, forced
    re, im = _split_complex(x, _mesh_device(mesh, x))
    if im is None:
        im = torch.zeros_like(re)
    return _dft_local_core(re, im)


def _run_irfft_matmul(spec, mesh, axis, n1, n2, forced=False,
                      precision="highest"):
    del forced
    n = n1 * n2
    re, im = _split_complex(spec, _mesh_device(mesh, spec))
    if im is None:
        im = torch.zeros_like(re)
    fre, fim = _hermitian_parts(re, im, n)
    # inverse: stage roles swap — input viewed [n1, n2], n2 sharded
    fre = fre.reshape(tuple(fre.shape[:-1]) + (n1, n2))
    fim = fim.reshape(tuple(fim.shape[:-1]) + (n1, n2))
    return _ct_sharded("sharded_irfft", fre, fim, mesh, axis,
                       ga=n1, gb=n2, sign=1.0, scale=1.0 / n,
                       out_kind="real", precision=precision)


def _run_irfft_matmul_comp(spec, mesh, axis, n1, n2, forced=False):
    return _run_irfft_matmul(spec, mesh, axis, n1, n2, forced=forced,
                             precision="bf16_comp")


def _run_irfft_local(spec, mesh, axis, n1, n2, forced=False):
    del axis, forced
    re, im = _split_complex(spec, _mesh_device(mesh, spec))
    if im is None:
        im = torch.zeros_like(re)
    return _irfft_local_core(re, im, int(n1 * n2))


_RFFT_ROUTES = {"sharded_matmul_dft": _run_rfft_matmul,
                "local_fft": _run_rfft_local,
                "sharded_matmul_dft_bf16_comp": _run_rfft_matmul_comp}
_DFT_ROUTES = {"sharded_matmul_dft": _run_dft_matmul,
               "local_fft": _run_dft_local,
               "sharded_matmul_dft_bf16_comp": _run_dft_matmul_comp}
_IRFFT_ROUTES = {"sharded_matmul_dft": _run_irfft_matmul,
                 "local_fft": _run_irfft_local,
                 "sharded_matmul_dft_bf16_comp":
                     _run_irfft_matmul_comp}


# ---------------------------------------------------------------------------
# public dispatchers
# ---------------------------------------------------------------------------

def _dispatch(op, table, operand, n, mesh, axis, route, oracle):
    """Shared selection + decision event + in-span guarded dispatch
    for the three public transforms."""
    s = int(mesh.shape[axis])
    shape = operand.shape if hasattr(operand, "shape") \
        else np.shape(operand)
    rows = lead_rows(shape)
    _mesh_device(mesh, operand)
    cards = _cards(mesh)
    factor = sp.ct_factor(n, multiple=s)
    n1, n2 = factor if factor else (0, 0)
    forced = route is not None
    chosen = _FOURIER_FAMILY.select(
        route=route,
        runners=lambda: {name: (lambda fn=fn: fn(operand, mesh, axis,
                                                 n1, n2, forced=True))
                         for name, fn in table.items()
                         if not name.startswith("sharded_matmul_dft")
                         or factor},
        probe_operand=operand,
        tune_geom=lambda: _fourier_tune_class(op, n, rows, mesh, axis),
        mesh=routing.mesh_class(mesh, axis),
        op=op, n=int(n), n_shards=s, rows=rows, n1=n1, n2=n2,
        cards=cards)
    if forced and chosen.startswith("sharded_matmul_dft") \
            and not factor:
        raise ValueError(
            f"n={n} has no Cooley-Tukey split with both factors "
            f"divisible by {axis}={s} (and <= "
            f"{sp.AUTO_DFT_MATMUL_MAX_FRAME})")
    is_mm = chosen.startswith("sharded_matmul_dft")
    mm_precision = ("bf16_comp" if chosen.endswith("_bf16_comp")
                    else "highest")
    _, _, bytes_a2a = _modeled_costs(n, n1, n2, rows, s,
                                     precision=mm_precision, cards=cards)
    obs.record_decision(
        op, chosen, n=int(n), n_shards=s, axis=axis, rows=rows,
        n1=n1 if is_mm else 0, n2=n2 if is_mm else 0,
        a2a=2 if is_mm else 0,
        a2a_bytes=int(bytes_a2a) if is_mm else 0,
        precision=mm_precision if is_mm else "highest",
        roofline=_FOURIER_FAMILY.route(chosen).roofline["kind"],
        forced=forced)
    with obs.span(f"{op}.dispatch", route=chosen, n_shards=s):
        return faults.guarded(
            f"{op}.dispatch",
            lambda: table[chosen](operand, mesh, axis, n1, n2,
                                  forced=forced),
            fallback=(None if forced or faults.on_card(operand)
                      else oracle))


def sharded_rfft(x, mesh, axis: str = "sp", route=None):
    """Sharded real DFT: ``x[..., n] -> complex64 [..., n//2 + 1]``.

    ``route`` forces ``sharded_matmul_dft`` (the factorized pipeline)
    or ``local_fft`` (one ``torch.fft.rfft`` on the mesh's first
    device); None lets the engine decide — static predicate, tune-cache
    winner, or measured probe per ``VELES_SIMD_AUTOTUNE``.  The chosen
    route, factorization and bytes a transpose moves are recorded as a
    ``sharded_rfft`` decision event.
    """
    x_np = x if hasattr(x, "shape") else np.asarray(x)
    n = int(x_np.shape[-1])
    if n < 1:
        raise ValueError("empty signal")
    return _dispatch(
        "sharded_rfft", _RFFT_ROUTES, x_np, n, mesh, axis, route,
        lambda: np.fft.rfft(
            _host64(x_np, np.float64)).astype(np.complex64))


def _host64(x, dtype):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def sharded_dft(x, mesh, axis: str = "sp", route=None):
    """Sharded complex DFT: ``x[..., n] -> complex64 [..., n]`` (real
    or complex input).  Same routing surface as
    :func:`sharded_rfft`."""
    x_np = x if hasattr(x, "shape") else np.asarray(x)
    n = int(x_np.shape[-1])
    if n < 1:
        raise ValueError("empty signal")

    def oracle():
        host = _host64(x_np, None)
        return np.fft.fft(host.astype(
            np.complex128 if np.iscomplexobj(host) else np.float64
        )).astype(np.complex64)

    return _dispatch("sharded_dft", _DFT_ROUTES, x_np, n, mesh, axis,
                     route, oracle)


def sharded_irfft(spec, n: int, mesh, axis: str = "sp", route=None):
    """Sharded inverse real DFT: one-sided ``[..., n//2 + 1]`` bins
    back to the length-``n`` real signal (float32).  Exact inverse of
    :func:`sharded_rfft` for Hermitian-consistent input."""
    n = int(n)
    spec_np = spec if hasattr(spec, "shape") else np.asarray(spec)
    if spec_np.shape[-1] != n // 2 + 1:
        raise ValueError(
            f"spec has {spec_np.shape[-1]} bins, expected "
            f"{n // 2 + 1} for n={n}")

    def oracle():
        return np.fft.irfft(_host64(spec_np, np.complex128),
                            n).astype(np.float32)

    return _dispatch("sharded_irfft", _IRFFT_ROUTES, spec_np, n,
                     mesh, axis, route, oracle)


# ---------------------------------------------------------------------------
# the local frame-transform family (sharded stft/istft/welch bodies
# run these on complete frames — no collectives)
# ---------------------------------------------------------------------------

_FRAME_FAMILY = routing.family("parallel.frame_dft", (
    routing.Route(
        "rdft_matmul",
        predicate=lambda frame_length, **_:
            frame_length <= sp.AUTO_DFT_MATMUL_MAX_FRAME,
        disable_env=sp._DFT_MATMUL_ENV,
        doc="precomputed real-DFT basis matmul (window folded in) — "
            "the single-card rdft route run per shard"),
    routing.Route(
        "ct_matmul",
        predicate=lambda frame_length, **_:
            sp.ct_factor(frame_length) is not None,
        disable_env=sp._DFT_MATMUL_ENV,
        doc="Cooley-Tukey factorized matmul DFT for frames past the "
            "dense basis-residency cutoff"),
    routing.Route("xla_fft", doc="torch.fft inside the shard"),
    routing.Route(
        "rdft_matmul_bf16_comp",
        predicate=lambda frame_length, **_: (
            frame_length <= sp.AUTO_DFT_MATMUL_MAX_FRAME
            and sp.dft_matmul_allowed()
            and prx.precision_allowed("bf16_comp")),
        disable_env=prx.BF16_COMP_ENV,
        doc="the per-shard basis matmul at bf16_comp "
            "(split/compensated accumulation — runtime/precision.py)"),
))


def select_frame_route(frame_length: int) -> str:
    """Engine-selected local transform for one ``frame_length``-sized
    frame inside a shard body — first eligible row of the
    ``parallel.frame_dft`` table (``rdft_matmul`` within the matmul
    cutoff, ``ct_matmul`` above it when a factorization exists,
    ``xla_fft`` terminal)."""
    return _FRAME_FAMILY.static_select(frame_length=int(frame_length))


def frame_rfft_fn(route: str, frame_length: int, window, device=None):
    """A ``frames[..., frame_length] -> complex spectrum`` body for
    the given frame route, window applied inside (folded into the
    basis on the ``rdft_matmul`` route).  Device constants are built
    HERE, on ``device`` (default ``Config.device``), deduped by the
    spectral host/device LRUs, and follow each shard's frames to its
    device."""
    L = int(frame_length)
    window = np.asarray(window, np.float32)
    dev = _config_device() if device is None else torch.device(device)
    bins = L // 2 + 1
    if route in ("rdft_matmul", "rdft_matmul_bf16_comp"):
        basis = sp._device_basis("rdft_fwd", L, window,
                                 lambda: sp._rdft_basis(L, window), dev)
        p = ("bf16_comp" if route == "rdft_matmul_bf16_comp"
             else "highest")

        def fn(frames):
            out = prx.p_einsum("...fl,lb->...fb", frames,
                               basis.to(frames.device), precision=p)
            return torch.complex(out[..., :bins], out[..., bins:])
        return fn
    if route == "ct_matmul":
        n1, n2 = sp.ct_factor(L)
        parts = sp.ct_basis_device(n1, n2, dev)
        wj = torch.as_tensor(window, device=dev)

        def fn(frames):
            here = tuple(p.to(frames.device) for p in parts)
            re, im = sp.ct_apply(frames * wj.to(frames.device), n1, n2,
                                 here)
            return torch.complex(re[..., :bins], im[..., :bins])
        return fn
    if route == "xla_fft":
        wj = torch.as_tensor(window, device=dev)
        return lambda frames: torch.fft.rfft(
            frames * wj.to(frames.device), dim=-1)
    raise ValueError(f"unknown frame route {route!r}")


def frame_irfft_fn(route: str, frame_length: int, window, device=None):
    """The synthesis twin: ``spec[..., bins] -> windowed time frames
    [..., frame_length]`` (the ``irfft(spec) * window`` step of the
    sharded ISTFT) for the given frame route."""
    L = int(frame_length)
    window = np.asarray(window, np.float32)
    dev = _config_device() if device is None else torch.device(device)
    if route in ("rdft_matmul", "rdft_matmul_bf16_comp"):
        inv = sp._device_basis("rdft_inv", L, window,
                               lambda: sp._rdft_inv_basis(L, window), dev)
        p = ("bf16_comp" if route == "rdft_matmul_bf16_comp"
             else "highest")

        def fn(spec):
            parts = torch.cat([spec.real, spec.imag], dim=-1)
            return prx.p_einsum("...fb,bl->...fl", parts,
                                inv.to(spec.device), precision=p)
        return fn
    if route == "ct_matmul":
        n1, n2 = sp.ct_factor(L)
        parts = sp.ct_basis_device(n1, n2, dev)
        wj = torch.as_tensor(window, device=dev)

        def fn(spec):
            here = tuple(p.to(spec.device) for p in parts)
            full = sp.hermitian_extend(spec, L)
            re, _ = sp.ct_apply(full, n1, n2, here, inverse=True)
            return re * wj.to(spec.device)
        return fn
    if route == "xla_fft":
        wj = torch.as_tensor(window, device=dev)
        return lambda spec: torch.fft.irfft(spec, L, dim=-1) * wj.to(
            spec.device)
    raise ValueError(f"unknown frame route {route!r}")
