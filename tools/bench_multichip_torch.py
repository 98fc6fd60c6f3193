#!/usr/bin/env python3
"""MULTICHIP bench family of the port: the sharded Fourier rows.

The twin of ``tools/bench_multichip.py`` over the PyTorch/CUDA port.  It
measures the ``parallel/fourier.py`` routes on a mesh of ``--devices``
shards (default 8) of the configured device — ``cuda:0`` on one card
(the cards in turn where there are more), ``cpu`` with
``VELES_SIMD_PLATFORM=cpu``:

* ``sharded_rfft``: the engine's pick against the factorized matmul
  DFT (``sharded_matmul_dft``) and the local FFT (``local_fft``) on the
  same geometry, then the factorized pipeline at ``bf16_comp`` against
  it at ``highest``;
* ``sharded_stft`` at a frame past the single-card matmul cutoff (the
  Cooley-Tukey local frame transform, ``ct_matmul``) against the
  ``torch.fft`` body (``VELES_SIMD_DISABLE_DFT_MATMUL``).

Before a row is timed its answer is held to ``np.fft`` in float64
(``sharded_rfft`` within 1e-4 of max|X|, ``bf16_comp`` within its
``ERROR_BUDGETS`` entry, the STFT within 1e-4); a wrong row exits 1.
Each row carries the burst rate (``utils.benchmark.device_time``: the
host clock around bursts of calls, each burst waited for) beside the
device busy ms of one call (CUPTI's records, ``device_busy_ms``; "not
measured" off the card), each route's roofline against the H100's
peaks (``dft_matmul_roofline``, ``stft_roofline``, and ``rfft_flops``
over the fp32 peak for a local FFT), and the bytes between shards:
``a2a_bytes`` a transpose and the copy rate ``mesh_copy_gbps`` in
place of the TPU's ICI bytes and rate.

It writes ``MULTICHIP_DETAILS_torch.json`` in ``BENCH_DETAILS.json``'s
row format (one row a metric, then a tail entry with the mesh), so
``tools/bench_regress.py --details MULTICHIP_DETAILS_torch.json`` reads
it unchanged.  On one card every shard shares the card: the rows
measure the mesh's cost, not a speed-up across cards (the tail entry
says so).  Without a card and without ``VELES_SIMD_PLATFORM=cpu`` it
exits 2.

Run:  python3 tools/bench_multichip_torch.py [--devices 8] [--quick]
          [--out MULTICHIP_DETAILS_torch.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))

from veles.simd_tpu_torch import obs  # noqa: E402
from veles.simd_tpu_torch.utils.benchmark import (  # noqa: E402
    H100_FP32_TFLOPS, a2a_bytes, device_busy_ms, device_time,
    dft_matmul_roofline, mesh_copy_gbps, rfft_flops, stft_roofline)

TOL = 1e-4      # of max|X| against np.fft in float64


class MultichipCheckError(RuntimeError):
    """A row's answer disagrees with ``np.fft``."""


def _decisions(ops) -> list:
    """The last event of each distinct (op, decision, forced): a raw
    tail would repeat whichever route was timed last."""
    last = {}
    for e in obs.events():
        if e.get("op") in ops:
            last[(e.get("op"), e.get("decision"), e.get("forced"))] = e
    return [{k: v for k, v in e.items() if v is not None}
            for e in last.values()]


def _fft_roofline(samples_per_s: float, n: int) -> dict:
    """A local FFT's rate against the fp32 peak (``rfft_flops`` a
    transform), on the scale of :func:`dft_matmul_roofline`."""
    eff = rfft_flops(n) / n * samples_per_s / 1e12
    return {"tflops_effective": eff,
            "roofline_bound_tflops": H100_FP32_TFLOPS,
            "pct_of_roofline": 100.0 * eff / H100_FP32_TFLOPS,
            "precision": "highest"}


def _busy(fn):
    """Device busy ms of one call on the card, else None."""
    from veles.simd_tpu_torch.utils.platform import on_cuda

    return device_busy_ms(fn, calls=10) if on_cuda() else None


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _check(label, got, want, tol, emit):
    rel = _rel(got, want)
    if not rel <= tol:
        raise MultichipCheckError(f"{label}: rel err {rel:.2e} against "
                                  f"np.fft in float64 > {tol:.0e}")
    emit(f"MULTICHIP-CHECK {label}: ok (rel {rel:.1e})")
    return rel


def bench_sharded_rfft(mesh, axis, n, rows_out, emit=print):
    """Row 1: ``sharded_rfft``, the engine's pick against the matmul DFT
    and the local FFT on one geometry (``value`` the pick's rate,
    ``baseline`` the local FFT's); row 2, where a factorization exists:
    the pipeline at ``bf16_comp`` against it at ``highest``."""
    import torch

    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.parallel import fourier as fr
    from veles.simd_tpu_torch.runtime import precision as prx
    from veles.simd_tpu_torch.utils.platform import to_device, to_host

    s = mesh.shape[axis]
    rng = np.random.RandomState(7)
    x_np = rng.randn(n).astype(np.float32)
    x = to_device(x_np)
    factor = sp.ct_factor(n, multiple=s)
    sel = fr._select_fourier_route("rfft", n, s, 1, *(factor or (0, 0)),
                                   cards=fr._cards(mesh))
    want = np.fft.rfft(x_np.astype(np.float64))

    obs.reset()
    times, busy, errs = {}, {}, {}
    for route in dict.fromkeys([sel, "sharded_matmul_dft", "local_fft"]):
        if route == "sharded_matmul_dft" and not factor:
            continue

        def call(r=route):
            return fr.sharded_rfft(x, mesh, axis=axis, route=r)

        errs[route] = _check(f"sharded_rfft[{route}] n={n}",
                             to_host(call()), want, TOL, emit)
        times[route] = device_time(lambda c=call: torch.abs(c()).mean())
        busy[route] = _busy(call)
    decisions = _decisions({"sharded_rfft", "autotune"})

    bytes_a2a = a2a_bytes(n, fr.A2A_PAYLOAD_BYTES["highest"], s)
    roofs = {}
    for route, t in times.items():
        if not np.isfinite(t):
            continue
        roofs[route] = (dft_matmul_roofline(n / t, *factor)
                        if route == "sharded_matmul_dft"
                        else _fft_roofline(n / t, n))
    row = {
        "metric": f"sharded rfft {n // 1024}k x{s}",
        "unit": "Msamples/s",
        "value": n / times[sel] / 1e6,
        "baseline": n / times["local_fft"] / 1e6,
        "vs_baseline": times["local_fft"] / times[sel],
        "route": sel,
        "rel_err": errs[sel],
        "busy_ms": busy,
        "roofline_routes": roofs,
        "mesh_copy": {"a2a_per_dispatch": 2 if factor else 0,
                      "a2a_bytes": bytes_a2a,
                      "total_a2a_bytes": 2 * bytes_a2a if factor else 0,
                      "mesh_copy_gbps": mesh_copy_gbps(fr._cards(mesh)),
                      "n1": factor[0] if factor else 0,
                      "n2": factor[1] if factor else 0},
        "decisions": decisions[-8:],
    }
    rows_out.append(row)
    emit(f"MULTICHIP sharded_rfft[{sel}]: {row['value']:.1f} Ms/s vs "
         f"local_fft {row['baseline']:.1f} Ms/s "
         f"({row['vs_baseline']:.2f}x) | busy ms "
         + ", ".join(f"{r} {_fmt(b)}" for r, b in busy.items())
         + f" | {2 * bytes_a2a / 1e6:.1f} MB between shards a dispatch "
         f"at {mesh_copy_gbps(fr._cards(mesh)):.0f} GB/s")

    if not factor:
        return
    comp = "sharded_matmul_dft_bf16_comp"

    def call_comp():
        return fr.sharded_rfft(x, mesh, axis=axis, route=comp)

    rel = _check(f"sharded_rfft[{comp}] n={n}", to_host(call_comp()),
                 want, prx.ERROR_BUDGETS["bf16_comp"], emit)
    t_comp = device_time(lambda: torch.abs(call_comp()).mean())
    t_hi = times.get("sharded_matmul_dft")
    if t_hi is None or not (np.isfinite(t_comp) and np.isfinite(t_hi)):
        return
    b_comp = _busy(call_comp)
    comp_row = {
        "metric": f"sharded rfft bf16_comp {n // 1024}k x{s}",
        "unit": "Msamples/s",
        "value": n / t_comp / 1e6,
        "baseline": n / t_hi / 1e6,
        "vs_baseline": t_hi / t_comp,
        "route": comp,
        "rel_err": rel,
        "busy_ms": {comp: b_comp,
                    "sharded_matmul_dft": busy["sharded_matmul_dft"]},
        "roofline_precisions": {
            "bf16_comp": dft_matmul_roofline(n / t_comp, *factor,
                                             precision="bf16_comp"),
            "highest": roofs.get("sharded_matmul_dft")},
        "mesh_copy": {"a2a_per_dispatch": 2,
                      "a2a_bytes": a2a_bytes(
                          n, fr.A2A_PAYLOAD_BYTES["bf16_comp"], s)},
    }
    rows_out.append(comp_row)
    emit(f"MULTICHIP sharded_rfft[{comp}]: {comp_row['value']:.1f} Ms/s "
         f"vs highest {comp_row['baseline']:.1f} Ms/s "
         f"({comp_row['vs_baseline']:.2f}x) | busy ms {_fmt(b_comp)}")


def _stft64(x, frame, hop):
    """The STFT oracle in float64: periodic Hann frames (the port's
    default window) through ``np.fft.rfft``."""
    from veles.simd_tpu_torch.ops import spectral as sp

    window = np.asarray(sp._resolve_window(None, frame), np.float64)
    frames = sp.frame_count(len(x), frame, hop)
    idx = np.arange(frame)[None, :] + hop * np.arange(frames)[:, None]
    return np.fft.rfft(x.astype(np.float64)[idx] * window, axis=-1)


def bench_sharded_stft_above_cutoff(mesh, axis, n, frame, hop, rows_out,
                                    emit=print):
    """Row 3: ``sharded_stft`` at a frame past the single-card matmul
    cutoff, the engine's local transform (``ct_matmul``) against the
    ``torch.fft`` body forced by the family's opt-out env."""
    import torch

    from veles.simd_tpu_torch import parallel as par
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.parallel import fourier as fr
    from veles.simd_tpu_torch.utils.platform import to_device, to_host

    s = mesh.shape[axis]
    rng = np.random.RandomState(8)
    x_np = rng.randn(n).astype(np.float32)
    x = to_device(x_np)
    sel = fr.select_frame_route(frame)
    frames = sp.frame_count(n, frame, hop)
    want = _stft64(x_np, frame, hop)

    def call():
        return par.sharded_stft(x, frame, hop, mesh, axis=axis)

    def run():
        return torch.abs(call()).mean()

    obs.reset()
    rel = {sel: _check(f"sharded_stft[{sel}] frame={frame}",
                       to_host(call()), want, TOL, emit)}
    t_sel = device_time(run)
    busy = {sel: _busy(call)}
    decisions = _decisions({"sharded_stft_local", "sharded_stft"})
    env = sp._DFT_MATMUL_ENV
    prev = os.environ.get(env)
    os.environ[env] = "1"
    try:
        fft_route = fr.select_frame_route(frame)
        rel[fft_route] = _check(f"sharded_stft[{fft_route}] frame="
                                f"{frame}", to_host(call()), want, TOL,
                                emit)
        t_fft = device_time(run)
        busy[fft_route] = _busy(call)
    finally:
        if prev is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = prev

    roofs = {}
    if np.isfinite(t_sel):
        if sel == "ct_matmul":
            n1, n2 = sp.ct_factor(frame)
            roofs[sel] = dft_matmul_roofline(frames * frame / t_sel, n1,
                                             n2)
        else:
            roofs[sel] = stft_roofline(frames / t_sel, frame, route=sel)
    if np.isfinite(t_fft):
        roofs[fft_route] = _fft_roofline(frames * frame / t_fft, frame)
    row = {
        "metric": f"sharded stft {frame}/{hop} x{s} above-cutoff",
        "unit": "Msamples/s",
        "value": n / t_sel / 1e6,
        "baseline": n / t_fft / 1e6,
        "vs_baseline": t_fft / t_sel,
        "route": sel,
        "rel_err": rel,
        "busy_ms": busy,
        "roofline_routes": roofs,
        # the sharded STFT's collective is the halo copy, not an
        # all-to-all: frames are shard-local
        "mesh_copy": {"a2a_per_dispatch": 0, "a2a_bytes": 0,
                      "halo_bytes": 4 * (frame - hop) * s},
        "decisions": decisions[-8:],
    }
    rows_out.append(row)
    emit(f"MULTICHIP sharded_stft[{sel}] frame={frame}: "
         f"{row['value']:.1f} Ms/s vs {fft_route} {row['baseline']:.1f} "
         f"Ms/s ({row['vs_baseline']:.2f}x) | busy ms "
         + ", ".join(f"{r} {_fmt(b)}" for r, b in busy.items()))


def _fmt(busy) -> str:
    return "not measured" if busy is None else f"{busy:.4f}"


def run_bench(n_devices: int, out_path: str | None, quick: bool,
              emit=print) -> list:
    """Every row on a mesh of ``n_devices`` shards; writes the details
    file to ``out_path`` (unless None) and returns the rows and the
    tail entry.  Raises :class:`MultichipCheckError` on a wrong row."""
    from veles.simd_tpu_torch import parallel as par
    from veles.simd_tpu_torch.parallel.fourier import _cards
    from veles.simd_tpu_torch.parallel.mesh import local_devices
    from veles.simd_tpu_torch.utils.platform import device_line

    obs.enable()
    obs.reset()
    rows: list = []
    devices = local_devices(n_devices)
    mesh = par.make_mesh({"sp": len(devices)}, devices=devices)
    s = len(devices)
    bench_sharded_rfft(mesh, "sp", (1 << 14) if quick else (1 << 18),
                       rows, emit)
    frame, hop = 8192, 2048
    n_stft = max(s * 16384, frame * 2) if quick else s * 65536
    bench_sharded_stft_above_cutoff(mesh, "sp", n_stft, frame, hop, rows,
                                    emit)
    cards = _cards(mesh)
    tail = {"n_devices": s,
            "mesh": {k: int(v) for k, v in mesh.shape.items()},
            "device": str(devices[0]), "card": device_line(),
            "distinct_cards": cards,
            "note": (f"{s} shards on {cards} card(s): the rows measure "
                     "the mesh's cost on the card, not a speed-up across "
                     "cards" if cards == 1 else
                     f"{s} shards over {cards} cards" if cards else
                     f"{s} shards of the CPU: plumbing only")}
    for r in rows:
        # a timer that did not resolve gives NaN: null the numbers
        # (strict JSON) and flag the row, as BENCH_DETAILS.json does
        if not all(isinstance(r.get(k), (int, float))
                   and np.isfinite(r[k])
                   for k in ("value", "baseline", "vs_baseline")):
            r["flagged"] = "unresolved measurement"
            for k in ("value", "baseline", "vs_baseline"):
                if isinstance(r.get(k), float) and not np.isfinite(r[k]):
                    r[k] = None
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rows + [tail], f, indent=2, allow_nan=False)
        emit(f"wrote {out_path} ({len(rows)} rows)")
    return rows + [tail]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n", 1)[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--out", default="MULTICHIP_DETAILS_torch.json")
    ap.add_argument("--quick", action="store_true",
                    help="small shapes (CI smoke)")
    args = ap.parse_args(argv)
    from veles.simd_tpu_torch.utils.platform import select_device

    # the card, or the CPU when VELES_SIMD_PLATFORM=cpu asks for it
    # (rc 2 when no card answers)
    select_device()
    try:
        run_bench(args.devices, args.out, args.quick,
                  emit=lambda line: print(line, file=sys.stderr))
    except MultichipCheckError as e:
        print(f"bench_multichip: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
