#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (veles.simd_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one line each (any failure raises, and the script exits non-zero
without printing a result):

1. card   — the card's name, power limit and count; no CUDA card is a
            failure (the port is never smoke-run on the CPU);
2. build  — builds the CUDA kernels from csrc/ with nvcc (sm_90a);
3. parity — each kernel against its plain PyTorch version on the card,
            at the main path's shapes and at the edge cases;
4. main   — the main path through the user entry points, launch
            counters reset just before each call and read just after:
            ``convolve_initialize(1<<20, 2047)`` + ``convolve`` (the
            overlap-save kernel), a matched filter through
            ``cross_correlate_initialize`` (peak at pos + k - 1), and
            ``convolve_simd`` on 512 x 16384 with 129 taps (the
            filter-bank kernel); each within 1e-4 of a float64 oracle;
5. times  — the headline convolve call (CUDA events, device-resident
            operands; and host clock from NumPy operands), then each
            kernel, its plain version and ``conv1d`` (cuDNN, fp32) at
            the main-path shapes, timed with CUDA events, beside the
            fp32 bound; printed as one ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
PARITY_TOL = 1e-5        # kernel vs plain, relative to max|plain|
ORACLE_TOL = 1e-4        # vs float64 oracle (tools/tpu_smoke.py's bound)
N_HEAD, K_HEAD = 1 << 20, 2047          # the bench headline
ROWS_FB, N_FB, K_FB = 512, 16384, 129   # batched direct convolution
DAUB8_LO = np.array([-0.010597401784997278, 0.032883011666982945,
                     0.030841381835986965, -0.18703481171888114,
                     -0.02798376941698385, 0.6308807679295904,
                     0.7148465705525415, 0.23037781330885523])


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    check(np.all(np.isfinite(got)), "non-finite output")
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def fft_conv64(x, h):
    """float64 full convolution of every row of x with h."""
    n, k = x.shape[-1], h.shape[-1]
    m = 1 << (n + k - 2).bit_length()
    spec = (np.fft.rfft(x.astype(np.float64), m, axis=-1)
            * np.fft.rfft(h.astype(np.float64), m))
    return np.fft.irfft(spec, m, axis=-1)[..., : n + k - 1]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port "
              "is smoke-run on a CUDA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.ops import correlate as cr
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import smi_line

    set_config(device="cuda")
    obs.enable()
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)

    def cuda(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # 1. card
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {kind} | count {count} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    ck.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in ck.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {build_s:.1f} s | " + " | ".join(ptxas))

    # 3. parity: kernel vs plain version, same inputs on the card
    parity = {}

    def os_case(name, rows, n, k):
        x = cuda(rng.randn(rows, n) if rows > 1 else rng.randn(n))
        t = cuda(rng.randn(k))
        got = ck.overlap_save_cuda(x, t)
        want = ck.overlap_save_plain(x, t)
        torch.cuda.synchronize()
        diff = (got - want).abs().max().item()
        parity[name] = (diff, diff / want.abs().max().item())

    def fb_case(name, rows, n_ext, filt, stride, dilation, n_out):
        x = cuda(rng.randn(rows, n_ext))
        f = cuda(filt)
        got = ck.filter_bank_cuda(x, f, stride, dilation, n_out)
        want = ck.filter_bank_plain(x, f, stride, dilation, n_out)
        torch.cuda.synchronize()
        diff = max((g - w).abs().max().item() for g, w in zip(got, want))
        scale = max(w.abs().max().item() for w in want)
        parity[name] = (diff, diff / scale)

    os_case("os 1048576x2047", 1, N_HEAD, K_HEAD)
    os_case("os 3x200000x2047", 3, 200000, K_HEAD)
    os_case("os 100000x2", 1, 100000, 2)
    os_case("os 100000x257", 1, 100000, 257)
    fb_case("fb C1 512x16384x129", ROWS_FB, N_FB + 2 * (K_FB - 1),
            rng.randn(1, K_FB), 1, 1, N_FB + K_FB - 1)
    daub = np.stack([DAUB8_LO[::-1] * (-1.0) ** np.arange(8), DAUB8_LO])
    fb_case("fb C2 s2 512x4096 daub8", 512, 4096 + 6, daub, 2, 1, 2048)
    fb_case("fb C2 d4 512x4096 daub8", 512, 4096 + 7 * 4, daub, 1, 4,
            4096)
    for name, (diff, rel) in parity.items():
        check(rel <= PARITY_TOL, f"{name}: rel err {rel:.3e} > "
              f"{PARITY_TOL}")
    print("parity: " + " | ".join(f"{k} rel {v[1]:.2e}"
                                  for k, v in parity.items()))

    # 4. main path through the entry points
    launches = {}
    x_head = rng.randn(N_HEAD).astype(np.float32)
    h_head = rng.randn(K_HEAD).astype(np.float32)
    ck.reset_launches()
    handle = cv.convolve_initialize(N_HEAD, K_HEAD)
    y = cv.convolve(handle, x_head, h_head)
    torch.cuda.synchronize()
    launches["overlap_save"] = ck.LAUNCHES["overlap_save"]
    check(handle.algorithm is cv.ConvolutionAlgorithm.OVERLAP_SAVE
          and handle.os_matmul, f"headline handle is {handle}")
    check(launches["overlap_save"] >= 1,
          "convolve did not launch the overlap-save kernel")
    check(tuple(y.shape) == (N_HEAD + K_HEAD - 1,), f"shape {y.shape}")
    err_conv = rel_err(y.cpu().numpy(), fft_conv64(x_head, h_head))
    check(err_conv <= ORACLE_TOL, f"convolve rel err {err_conv:.3e}")

    pos = 300007
    x_mf = 0.1 * rng.randn(N_HEAD).astype(np.float32)
    x_mf[pos:pos + K_HEAD] += h_head
    ck.reset_launches()
    corr = cr.cross_correlate_initialize(N_HEAD, K_HEAD)
    y_mf = cr.cross_correlate(corr, x_mf, h_head)
    torch.cuda.synchronize()
    mf_launches = ck.LAUNCHES["overlap_save"]
    peak = int(torch.argmax(y_mf).item())
    check(mf_launches >= 1, "cross_correlate did not launch the kernel")
    check(peak == pos + K_HEAD - 1, f"matched-filter peak at {peak}, "
          f"want {pos + K_HEAD - 1}")

    x_fb = rng.randn(ROWS_FB, N_FB).astype(np.float32)
    h_fb = rng.randn(K_FB).astype(np.float32)
    ck.reset_launches()
    y_fb = cv.convolve_simd(x_fb, h_fb)
    torch.cuda.synchronize()
    launches["filter_bank"] = ck.LAUNCHES["filter_bank"]
    check(launches["filter_bank"] >= 1,
          "convolve_simd did not launch the filter-bank kernel")
    err_simd = rel_err(y_fb.cpu().numpy(), fft_conv64(x_fb, h_fb))
    check(err_simd <= ORACLE_TOL, f"convolve_simd rel err {err_simd:.3e}")
    routes = [e["decision"] for e in obs.events()
              if e["op"] == "convolve_os_route"]
    print(f"main: convolve {N_HEAD}x{K_HEAD} rel {err_conv:.2e} "
          f"(os launches {launches['overlap_save']}, routes {routes}) | "
          f"matched filter peak {peak} (os launches {mf_launches}) | "
          f"convolve_simd {ROWS_FB}x{N_FB}x{K_FB} rel {err_simd:.2e} "
          f"(fb launches {launches['filter_bank']})")

    # 5. times at the main-path shapes
    obs.disable()
    F = torch.nn.functional
    xh, th = cuda(x_head), cuda(h_head)
    head_ms = bm.device_time_ms(lambda: cv.convolve(handle, xh, th))

    def from_numpy():
        cv.convolve(handle, x_head, h_head)
        torch.cuda.synchronize()

    host_ms = bm.host_time(from_numpy, repeats=5) * 1e3
    print(f"headline: convolve {N_HEAD}x{K_HEAD} on the card "
          f"{head_ms:.4f} ms = {N_HEAD / head_ms / 1e3:.1f} Msamples/s | "
          f"from NumPy input, host clock {host_ms:.3f} ms")
    print("breakdown convolve (from NumPy input, device us per call): "
          + bm.device_breakdown(from_numpy, calls=5))
    xs_t, hs_t = cuda(x_fb), cuda(h_fb)
    simd_ms = bm.device_time_ms(lambda: cv.convolve_simd(xs_t, hs_t))

    def simd_from_numpy():
        cv.convolve_simd(x_fb, h_fb)
        torch.cuda.synchronize()

    print(f"direct: convolve_simd {ROWS_FB}x{N_FB}x{K_FB} on the card "
          f"{simd_ms:.4f} ms = "
          f"{ROWS_FB * N_FB / simd_ms / 1e3:.1f} Msamples/s")
    print("breakdown convolve_simd (from NumPy input, device us per "
          "call): " + bm.device_breakdown(simd_from_numpy, calls=5))
    xf = F.pad(cuda(x_fb), (K_FB - 1, K_FB - 1))
    ff = cuda(h_fb[::-1].copy()).reshape(1, K_FB)
    n_out_fb = N_FB + K_FB - 1

    def conv1d_head():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv1d(xh.view(1, 1, -1), th.flip(0).view(1, 1, -1),
                            padding=K_HEAD - 1)

    def conv1d_fb():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv1d(xf.view(ROWS_FB, 1, -1), ff.view(1, 1, -1))

    lib_err = {
        "overlap_save": rel_err(conv1d_head().view(-1).cpu().numpy(),
                                fft_conv64(x_head, h_head)),
        "filter_bank": rel_err(
            conv1d_fb().view(ROWS_FB, -1).cpu().numpy(),
            fft_conv64(x_fb, h_fb)),
    }
    work = {
        "overlap_save": bm.conv_work(1, N_HEAD, K_HEAD),
        "filter_bank": (2.0 * K_FB * ROWS_FB * n_out_fb,
                        4.0 * (xf.numel() + K_FB + ROWS_FB * n_out_fb)),
    }
    timed = {
        "overlap_save": (
            lambda: ck.overlap_save_cuda(xh, th),
            lambda: ck.overlap_save_plain(xh, th), conv1d_head),
        "filter_bank": (
            lambda: ck.filter_bank_cuda(xf, ff, 1, 1, n_out_fb),
            lambda: ck.filter_bank_plain(xf, ff, 1, 1, n_out_fb),
            conv1d_fb),
    }
    meta = {
        "overlap_save": (
            "veles/simd_tpu_torch/csrc/overlap_save.cu",
            "veles/simd_tpu/ops/pallas_kernels.py:679",
            f"{N_HEAD}x{K_HEAD}", parity["os 1048576x2047"]),
        "filter_bank": (
            "veles/simd_tpu_torch/csrc/filter_bank.cu",
            "veles/simd_tpu/ops/pallas_kernels.py:326",
            f"{ROWS_FB}x{N_FB}x{K_FB}", parity["fb C1 512x16384x129"]),
    }
    rows = []
    for name, (kern, plain, lib) in timed.items():
        ms = bm.device_time_ms(kern, iters=50)
        plain_ms = bm.device_time_ms(plain, iters=3, warmup=1)
        lib_ms = bm.device_time_ms(lib, iters=50)
        bound_ms, bound_by = bm.fp32_bound(*work[name])
        source, replaces, shape, (diff, rel) = meta[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape,
            "launches": launches[name], "max_abs_err": diff,
            "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "library_rel_err_vs_f64": lib_err[name],
        })
    print(f"times: card {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
