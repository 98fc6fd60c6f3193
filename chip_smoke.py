#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (veles.simd_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one line each (any failure raises, and the script exits non-zero
without printing a result):

1. card   — the card's name, power limit and count; no CUDA card is a
            failure (the port is never smoke-run on the CPU);
2. build  — builds the CUDA kernels from csrc/ with nvcc (sm_90a);
3. parity — each kernel against its plain PyTorch version run in
            float64 on the card, at the main path's shapes and at the
            edge cases (K2 and K5 also through their padded entries, the
            halo read in the kernel, as the direct routes call them; K3
            in both forms: the contract on an extended input, and the
            periodic form that reads the wrap and writes natural order,
            as the fused cascade calls it);
4. main   — the main path through the user entry points, launch
            counters reset just before each call and read just after:
            ``convolve_initialize(1<<20, 2047)`` + ``convolve`` (the
            overlap-save kernel), a matched filter through
            ``cross_correlate_initialize`` (peak at pos + k - 1), and
            ``convolve_simd`` on 512 x 16384 with 129 taps (the
            filter-bank kernel); the wavelet slice on 512 x 4096 daub8
            (``wavelet_apply`` and ``stationary_wavelet_apply`` through
            the filter-bank kernel, ``wavelet_transform`` at 3 levels
            as the level loop and, with VELES_SIMD_FORCE_FUSED_CASCADE,
            through the cascade-bank kernel, a DWT round trip); and
            ``convolve2d`` on 16 x 512 x 512 with 7 x 7 (the 2D
            kernel; also ``mode='same'`` and ``boundary='wrap'``),
            ``cross_correlate2d`` and a 2D ``fftconvolve``;
            the spectral slice: ``stft`` on 2^20 samples at 512/128
            through the auto route (the fused STFT kernel) and the
            forced ``rdft_matmul`` and ``xla_fft`` routes,
            ``batched_stft`` (the STFT kernel), ``spectrogram``, the
            ``istft(stft(x))`` round trip and ``welch`` on 64 x 16384,
            ``hilbert``/``envelope`` at n = 1024 and 65536, and
            ``morlet_cwt`` on 8 x 4096 with 32 scales (``ct_matmul``);
            each within 1e-4 of a float64 oracle;
5. times  — the headline convolve call (CUDA events, device-resident
            operands; and host clock from NumPy operands), the
            handle's own cuFFT overlap-save route beside it, the DWT,
            the fused cascade against the level loop, convolve2d, and
            ``stft`` (auto and forced routes) and ``batched_stft``;
            the breakdowns (``convolve_simd`` and ``convolve2d`` must
            run no pad or flip kernel, the fused cascade nothing but
            K3); the ``k-sweep`` line, K2's two
            variants at 512 x 16384 for 4..256 taps in turns; then each
            kernel, its plain version and its library yardstick (cuDNN
            ``conv1d``/``conv2d`` in fp32, ``torch.stft``) at the
            main-path shapes, as device time per call from
            ``torch.profiler`` (the kernel also as chained CUDA events),
            beside the fp32 bound (each counts the function's least
            work, ``utils.benchmark.conv_work``/``conv2d_work``/
            ``stft_work``, so the bytes set them); printed as one
            ``{"kernels": [...]}`` line.

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
K_PARITY = (1, 2, 3, 8, 16, 33, 129, 255, 256)   # K2 parity taps
K_SWEEP = (4, 8, 16, 33, 64, 129, 160, 192, 256)  # K2 variant sweep
ROWS_WV, N_WV, LEVELS = 512, 4096, 3    # BASELINE config 5: daub8 DWT
IMGS_2D, N_2D, K_2D = 16, 512, 7        # batched 2D convolution
N_ST, L_ST, HOP_ST = 1 << 20, 512, 128  # STFT acceptance (bench.py:640)
ROWS_BS, N_BS = 64, 16384               # bench configs 7-8 (bench.py:684)
ROWS_CWT, N_CWT, SCALES_CWT = 8, 4096, 32
STFT_TRIP_TOL = 1e-3     # istft(stft(x)) interior (bench.py:699-701)
CASCADE_TOL = 5e-4       # fused vs level loop (tests/test_pallas.py)
ROUND_TRIP_TOL = 2e-4    # DWT round trip (test_wavelet_synthesis.py)
FORCE_FUSED = "VELES_SIMD_FORCE_FUSED_CASCADE"
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


def crel_err(got, want):
    """Relative error of a complex (or real) result against its
    float64 oracle, relative to max|want|."""
    got = np.asarray(got)
    want = np.asarray(want)
    check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    check(np.all(np.isfinite(got)), "non-finite output")
    return float(np.max(np.abs(got.astype(np.complex128) - want))
                 / np.max(np.abs(want)))


def fft_conv64(x, h):
    """float64 full convolution of every row of x with h."""
    n, k = x.shape[-1], h.shape[-1]
    m = 1 << (n + k - 2).bit_length()
    spec = (np.fft.rfft(x.astype(np.float64), m, axis=-1)
            * np.fft.rfft(h.astype(np.float64), m))
    return np.fft.irfft(spec, m, axis=-1)[..., : n + k - 1]


def conv2d64(x, h):
    """float64 full 2D convolution of every image of x with h."""
    m = (x.shape[-2] + h.shape[0] - 1, x.shape[-1] + h.shape[1] - 1)
    spec = (np.fft.rfft2(x.astype(np.float64), m)
            * np.fft.rfft2(h.astype(np.float64), m))
    return np.fft.irfft2(spec, m)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port "
              "is smoke-run on a CUDA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.ops import convolve as cv
    from veles.simd_tpu_torch.ops import convolve2d as cv2
    from veles.simd_tpu_torch.ops import correlate as cr
    from veles.simd_tpu_torch.ops import batched as bt
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.ops import spectral as sp
    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.config import set_config
    from veles.simd_tpu_torch.utils.platform import smi_line

    t_start = time.perf_counter()
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
    lib = ck.load_library()
    print("persistent kernels, blocks resident per SM: filter_bank mma "
          f"(1 x {K_FB} taps) {lib.veles_fb_mma_resident(1, K_FB)}, "
          f"filter_2d ({K_2D} x {K_2D}) {lib.veles_f2d_resident(K_2D, K_2D)}")

    # 3. parity: kernel vs plain version, same inputs on the card
    parity = {}

    # the FFT kernels (K1, K4) against their plain versions run in
    # float64: a float32 direct sum of 16384 terms drifts by about 5e-6
    # of its max on its own, half the tolerance
    def os_case(name, rows, n, k):
        x = cuda(rng.randn(rows, n) if rows > 1 else rng.randn(n))
        t = cuda(rng.randn(k))
        got = ck.overlap_save_cuda(x, t)
        want = ck.overlap_save_plain(x.double(), t.double())
        torch.cuda.synchronize()
        diff = (got - want).abs().max().item()
        parity[name] = (diff, diff / want.abs().max().item())

    # K2 and K5 against their plain versions run in float64 too: the
    # mma variant's split TF32 drops the lo.lo terms, and both read
    # the zero halo (pad_left=, pad=) that the plain versions F.pad
    def fb_case(name, rows, n, filt, stride, dilation, n_out, pad_left=0,
                reverse=False, variant=None):
        x = cuda(rng.randn(rows, n))
        f = cuda(filt)
        got = ck.filter_bank_cuda(x, f, stride, dilation, n_out,
                                  pad_left=pad_left, reverse_taps=reverse,
                                  variant=variant)
        want = ck.filter_bank_plain(x.double(), f.double(), stride,
                                    dilation, n_out, pad_left, reverse)
        torch.cuda.synchronize()
        diff = max((g - w).abs().max().item() for g, w in zip(got, want))
        scale = max(w.abs().max().item() for w in want)
        parity[name] = (diff, diff / scale)

    os_case("os 1048576x2047", 1, N_HEAD, K_HEAD)
    os_case("os 3x200000x2047", 3, 200000, K_HEAD)
    os_case("os 100000x2", 1, 100000, 2)
    os_case("os 100000x257", 1, 100000, 257)
    os_case("os 3x50000x256", 3, 50000, 256)
    os_case("os 3x50000x16384", 3, 50000, 16384)
    os_case("os 512x4096x300", 512, 4096, 300)      # one segment a row
    os_case("os 64x1000x300", 64, 1000, 300)        # N = 4096
    fb_case("fb C1 512x16384x129", ROWS_FB, N_FB, rng.randn(1, K_FB), 1,
            1, N_FB + K_FB - 1, K_FB - 1, True)
    # both variants at the main shape, whichever FB_MMA_MIN_K picks
    for v in ("ffma", "mma"):
        fb_case(f"fb C1 512x16384x129 {v}", ROWS_FB, N_FB,
                rng.randn(1, K_FB), 1, 1, N_FB + K_FB - 1, K_FB - 1, True, v)
    # unit stride, C = 1: the padded entry on the unpadded rows at every
    # k of the sweep's range, and an explicit x_ext
    for k in K_PARITY:
        for rows, n in ((1, 1), (8, 1663), (512, 16384)):
            if (rows, n, k) != (ROWS_FB, N_FB, K_FB):
                fb_case(f"fb C1 {rows}x{n}x{k} pad", rows, n,
                        rng.randn(1, k), 1, 1, n + k - 1, k - 1)
        fb_case(f"fb C1 8x{1663 + 2 * (k - 1)}x{k} ext", 8,
                1663 + 2 * (k - 1), rng.randn(1, k), 1, 1, 1663 + k - 1)
    for k in (3, 16, 129):      # rows beyond a grid dimension (65535)
        fb_case(f"fb C1 70000x20x{k} pad", 70000, 20, rng.randn(1, k), 1,
                1, 20 + k - 1, k - 1, True)
    for c, k in ((2, 8), (2, 40), (3, 5), (3, 100)):   # C = 2: SWT level 1
        fb_case(f"fb C{c} 64x4096x{k} ext", 64, 4096 + k - 1,
                rng.randn(c, k), 1, 1, 4096)
    daub = np.stack([DAUB8_LO[::-1] * (-1.0) ** np.arange(8), DAUB8_LO])
    fb_case("fb C2 s2 512x4096 daub8", 512, 4096 + 6, daub, 2, 1, 2048)
    fb_case("fb C2 d4 512x4096 daub8", 512, 4096 + 7 * 4, daub, 1, 4,
            4096)
    P = wv.ExtensionType.PERIODIC

    # K3 in both call forms against its plain versions run in float64:
    # the contract form on the periodically extended input, the
    # periodic form (wrap read in place, natural-order levels) on the
    # signal itself
    def cb_case(name, rows, n, type, order, levels):
        plans, taps, reach = wv._cascade_plan_for(
            wv.WaveletType(type), order, levels)
        ns = 1 << levels
        x = cuda(rng.randn(rows, n))
        x_ext = x[:, np.arange(n + reach + ns) % n].contiguous()
        got = ck.cascade_bank_cuda(x_ext, taps, plans, ns, n // ns)
        want = ck.cascade_bank_plain(x_ext.double(), taps, plans, ns,
                                     n // ns)
        torch.cuda.synchronize()
        diff = max((g - w).abs().max().item() for g, w in zip(got, want))
        scale = max(w.abs().max().item() for w in want)
        parity[f"{name} contract"] = (diff, diff / scale)
        got = ck.cascade_bank_periodic_cuda(x, taps, plans, levels)
        want = ck.cascade_bank_periodic_plain(x.double(), taps, plans,
                                              levels)
        torch.cuda.synchronize()
        diff = max((g - w).abs().max().item() for g, w in zip(got, want))
        scale = max(w.abs().max().item() for w in want)
        parity[f"{name} periodic"] = (diff, diff / scale)

    def f2d_case(name, imgs, n0, n1, k0, k1, padded=False):
        # padded: the direct route's call (unpadded images, the halo and
        # the flip read in the kernel); else an explicit x_ext
        p = (k0 - 1, k1 - 1) if padded else (0, 0)
        x = cuda(rng.randn(imgs, n0 + 2 * (k0 - 1 - p[0]),
                           n1 + 2 * (k1 - 1 - p[1])))
        k = cuda(rng.randn(k0, k1))
        shape = (n0 + k0 - 1, n1 + k1 - 1)
        got = ck.filter_2d_cuda(x, k, *shape, pad=p, reverse_taps=padded)
        want = ck.filter_2d_plain(x.double(), k.double(), *shape, p,
                                  padded)
        torch.cuda.synchronize()
        diff = (got - want).abs().max().item()
        parity[name] = (diff, diff / want.abs().max().item())

    cb_case("cb daub8 L3 512x4096", ROWS_WV, N_WV, "daub", 8, LEVELS)
    cb_case("cb daub4 L4 8x1024", 8, 1024, "daub", 4, 4)
    cb_case("cb coif12 L2 8x512", 8, 512, "coif", 12, 2)
    cb_case("cb daub8 L3 37x1000", 37, 1000, "daub", 8, 3)
    cb_case("cb sym16 L3 3x2048", 3, 2048, "sym", 16, 3)
    cb_case("cb daub2 L2 70000x4", 70000, 4, "daub", 2, 2)  # wrap > n
    # the contract form on a plan of its own: 3 phases, odd rows off
    # 16-byte alignment (4-byte staging), more channels than a pass
    cb_plans = tuple(tuple((int(rng.randint(3)), int(rng.randint(3)))
                           for _ in range(5)) for _ in range(6))
    cb_taps = [rng.randn(5) for _ in cb_plans]
    x_odd = cuda(rng.randn(7 * 1001 + 1))[1:].view(7, 1001)
    got = ck.cascade_bank_cuda(x_odd, cb_taps, cb_plans, 3, 331)
    want = ck.cascade_bank_plain(x_odd.double(), cb_taps, cb_plans, 3, 331)
    torch.cuda.synchronize()
    diff = max((g - w).abs().max().item() for g, w in zip(got, want))
    parity["cb 3-phase 7x1001 contract"] = (
        diff, diff / max(w.abs().max().item() for w in want))
    f2d_case("f2d 16x512x512 7x7", IMGS_2D, N_2D, N_2D, K_2D, K_2D, True)
    f2d_case("f2d 16x512x512 7x7 ext", IMGS_2D, N_2D, N_2D, K_2D, K_2D)
    f2d_case("f2d 1x128x128 3x3", 1, 128, 128, 3, 3)
    f2d_case("f2d 4x100x77 16x16", 4, 100, 77, 16, 16)
    f2d_case("f2d 3x64x300 1x256", 3, 64, 300, 1, 256)
    f2d_case("f2d 4x100x77 16x16 pad", 4, 100, 77, 16, 16, True)
    f2d_case("f2d 3x64x300 1x256 pad", 3, 64, 300, 1, 256, True)
    f2d_case("f2d 2x300x20 256x1 pad", 2, 300, 20, 256, 1, True)

    def stft_case(name, rows, n, L, hop):
        x = cuda(rng.randn(rows, n))
        w = sp.hann_window(L)
        got = torch.view_as_real(ck.stft_cuda(x, cuda(w), L, hop))
        want = torch.view_as_real(ck.stft_plain(x.double(), w, L, hop))
        torch.cuda.synchronize()
        diff = (got - want).abs().max().item()
        parity[name] = (diff, diff / want.abs().max().item())

    stft_case("stft 1x1048576 512/128", 1, N_ST, L_ST, HOP_ST)
    stft_case("stft 64x16384 512/128", ROWS_BS, N_BS, L_ST, HOP_ST)
    stft_case("stft 3x5000 256/128", 3, 5000, 256, 128)
    stft_case("stft 2x8192 1024/128", 2, 8192, 1024, 128)
    stft_case("stft 4x4096 384/128", 4, 4096, 384, 128)
    stft_case("stft 2x700 512/128", 2, 700, 512, 128)   # < one block
    stft_case("stft 3x2000 255/85", 3, 2000, 255, 85)   # odd: complex FFT
    stft_case("stft 2x5000 640/128", 2, 5000, 640, 128)
    stft_case("stft 2x20000 4096/128", 2, 20000, 4096, 128)
    stft_case("stft 2x40000 16384/128", 2, 40000, 16384, 128)
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

    # the wavelet slice: 512 x 4096 daub8 (BASELINE config 5)
    x_wv = rng.randn(ROWS_WV, N_WV).astype(np.float32)
    ck.reset_launches()
    hi, lo = wv.wavelet_apply("daub", 8, P, x_wv)
    torch.cuda.synchronize()
    launches["filter_bank_dwt"] = ck.LAUNCHES["filter_bank"]
    check(launches["filter_bank_dwt"] >= 1,
          "wavelet_apply did not launch the filter-bank kernel")
    want_hi, want_lo = wv.wavelet_apply_na("daub", 8, P, x_wv)
    err_dwt = max(rel_err(hi.cpu().numpy(), want_hi),
                  rel_err(lo.cpu().numpy(), want_lo))
    check(err_dwt <= ORACLE_TOL, f"wavelet_apply rel err {err_dwt:.3e}")

    ck.reset_launches()
    shi, slo = wv.stationary_wavelet_apply("daub", 8, 3, P, x_wv)
    torch.cuda.synchronize()
    swt_launches = ck.LAUNCHES["filter_bank"]
    check(swt_launches >= 1, "stationary_wavelet_apply did not launch "
          "the filter-bank kernel")
    want_shi, want_slo = wv.stationary_wavelet_apply_na("daub", 8, 3, P,
                                                        x_wv)
    err_swt = max(rel_err(shi.cpu().numpy(), want_shi),
                  rel_err(slo.cpu().numpy(), want_slo))
    check(err_swt <= ORACLE_TOL, f"stationary_wavelet_apply rel err "
          f"{err_swt:.3e}")

    want_c, cur = [], x_wv
    for _ in range(LEVELS):
        h_, cur = wv.wavelet_apply_na("daub", 8, P, cur)
        want_c.append(h_)
    want_c.append(cur)
    check(FORCE_FUSED not in os.environ, f"{FORCE_FUSED} is set")
    ck.reset_launches()
    loop = wv.wavelet_transform("daub", 8, P, x_wv, LEVELS)
    torch.cuda.synchronize()
    loop_launches = dict(ck.LAUNCHES)
    check(loop_launches["filter_bank"] == LEVELS
          and loop_launches["cascade_bank"] == 0,
          f"level loop launches {loop_launches}")
    err_loop = max(rel_err(g.cpu().numpy(), w)
                   for g, w in zip(loop, want_c))
    check(err_loop <= ORACLE_TOL, f"level loop rel err {err_loop:.3e}")
    os.environ[FORCE_FUSED] = "1"
    try:
        ck.reset_launches()
        fused = wv.wavelet_transform("daub", 8, P, x_wv, LEVELS)
        torch.cuda.synchronize()
        fused_launches = dict(ck.LAUNCHES)
        launches["cascade_bank"] = ck.LAUNCHES["cascade_bank"]
    finally:
        del os.environ[FORCE_FUSED]
    # one launch of the periodic form and nothing else of the port's
    check(launches["cascade_bank"] == 1
          and sum(fused_launches.values()) == 1,
          f"the forced fused cascade launched {fused_launches}")
    fused_gap = max(
        float((f - g).abs().max().item())
        / max(1.0, float(g.abs().max().item()))
        for f, g in zip(fused, loop))
    check(fused_gap <= CASCADE_TOL, f"fused vs level loop {fused_gap:.3e}")
    err_fused = max(rel_err(g.cpu().numpy(), w)
                    for g, w in zip(fused, want_c))
    check(err_fused <= ORACLE_TOL, f"fused cascade rel err "
          f"{err_fused:.3e}")
    rec = wv.wavelet_reconstruct("daub", 8, hi, lo)
    trip = float(np.max(np.abs(rec.cpu().numpy() - x_wv)))
    check(trip <= ROUND_TRIP_TOL, f"DWT round trip {trip:.3e}")
    print(f"main: wavelet_apply {ROWS_WV}x{N_WV} daub8 rel {err_dwt:.2e} "
          f"(fb launches {launches['filter_bank_dwt']}) | "
          f"stationary_wavelet_apply level 3 rel {err_swt:.2e} "
          f"(fb launches {swt_launches}) | wavelet_transform L{LEVELS} "
          f"level loop rel {err_loop:.2e} (launches {loop_launches}) | "
          f"fused rel {err_fused:.2e}, vs loop {fused_gap:.2e} "
          f"(cb launches {launches['cascade_bank']}) | round trip max "
          f"abs {trip:.2e}")

    # 2D convolution: 16 x 512 x 512 with 7 x 7
    x_2d = rng.randn(IMGS_2D, N_2D, N_2D).astype(np.float32)
    h_2d = rng.randn(K_2D, K_2D).astype(np.float32)
    ck.reset_launches()
    y_2d = cv2.convolve2d(x_2d, h_2d)
    torch.cuda.synchronize()
    launches["filter_2d"] = ck.LAUNCHES["filter_2d"]
    check(launches["filter_2d"] >= 1,
          "convolve2d did not launch the 2D kernel")
    err_2d = rel_err(y_2d.cpu().numpy(), conv2d64(x_2d, h_2d))
    check(err_2d <= ORACLE_TOL, f"convolve2d rel err {err_2d:.3e}")
    ck.reset_launches()
    yc_2d = cv2.cross_correlate2d(x_2d, h_2d, mode="same")
    torch.cuda.synchronize()
    xc_launches = ck.LAUNCHES["filter_2d"]
    check(xc_launches >= 1, "cross_correlate2d did not launch the 2D "
          "kernel")
    s0 = K_2D // 2
    want_xc = conv2d64(x_2d, h_2d[::-1, ::-1])[:, s0:s0 + N_2D,
                                               s0:s0 + N_2D]
    err_xc = rel_err(yc_2d.cpu().numpy(), want_xc)
    check(err_xc <= ORACLE_TOL, f"cross_correlate2d rel err {err_xc:.3e}")
    y_fc = cv.fftconvolve(x_2d[:2], h_2d)
    err_fc = rel_err(y_fc.cpu().numpy(), conv2d64(x_2d[:2], h_2d))
    check(err_fc <= ORACLE_TOL, f"2D fftconvolve rel err {err_fc:.3e}")
    # 'same' reads the halo in the kernel; 'wrap' extends first and the
    # kernel computes only the kept part of the full output
    s1 = (K_2D - 1) // 2
    x_wrap = np.pad(x_2d, ((0, 0), (K_2D - 1,) * 2, (K_2D - 1,) * 2),
                    mode="wrap")
    mb_err, mb_launches = {}, {}
    for label, kw, want in (
            ("same", {"mode": "same"},
             lambda: conv2d64(x_2d, h_2d)[:, s1:s1 + N_2D, s1:s1 + N_2D]),
            ("wrap", {"boundary": "wrap"},
             lambda: conv2d64(x_wrap, h_2d)[
                 :, K_2D - 1:K_2D - 1 + N_2D + K_2D - 1,
                 K_2D - 1:K_2D - 1 + N_2D + K_2D - 1])):
        ck.reset_launches()
        y_mb = cv2.convolve2d(x_2d, h_2d, **kw)
        torch.cuda.synchronize()
        mb_launches[label] = ck.LAUNCHES["filter_2d"]
        check(mb_launches[label] == 1, f"convolve2d {label} launches "
              f"{mb_launches[label]}")
        mb_err[label] = rel_err(y_mb.cpu().numpy(), want())
        check(mb_err[label] <= ORACLE_TOL, f"convolve2d {label} rel err "
              f"{mb_err[label]:.3e}")
    print(f"main: convolve2d {IMGS_2D}x{N_2D}x{N_2D} k {K_2D}x{K_2D} rel "
          f"{err_2d:.2e} (f2d launches {launches['filter_2d']}) | "
          f"cross_correlate2d same rel {err_xc:.2e} (f2d launches "
          f"{xc_launches}) | fftconvolve 2D rel {err_fc:.2e} | "
          + " | ".join(f"convolve2d {k} rel {v:.2e} (f2d launches "
                       f"{mb_launches[k]})" for k, v in mb_err.items()))

    # the spectral slice: stft on 2^20 samples at 512/128
    x_st = rng.randn(N_ST).astype(np.float32)
    want_st = sp.stft_na(x_st, L_ST, HOP_ST)
    obs.reset()
    ck.reset_launches()
    y_st = sp.stft(x_st, L_ST, HOP_ST)
    torch.cuda.synchronize()
    launches["stft"] = ck.LAUNCHES["stft"]
    st_routes = [e["decision"] for e in obs.events()
                 if e["op"] == "stft_route"]
    check(st_routes == ["cuda_fused"], f"stft routes {st_routes}")
    check(launches["stft"] >= 1, "stft did not launch the STFT kernel")
    err_st = crel_err(y_st.cpu().numpy(), want_st)
    check(err_st <= ORACLE_TOL, f"stft rel err {err_st:.3e}")
    forced_err = {}
    for route in ("rdft_matmul", "xla_fft"):
        ck.reset_launches()
        y_r = sp.stft(x_st, L_ST, HOP_ST, route=route)
        torch.cuda.synchronize()
        check(ck.LAUNCHES["stft"] == 0, f"forced {route} launched K4")
        forced_err[route] = crel_err(y_r.cpu().numpy(), want_st)
        check(forced_err[route] <= ORACLE_TOL,
              f"stft {route} rel err {forced_err[route]:.3e}")
    x_bs = rng.randn(ROWS_BS, N_BS).astype(np.float32)
    want_bs = sp.stft_na(x_bs, L_ST, HOP_ST)
    ck.reset_launches()
    y_bs = bt.batched_stft(x_bs, L_ST, HOP_ST)
    torch.cuda.synchronize()
    launches["stft_batched"] = ck.LAUNCHES["stft"]
    check(launches["stft_batched"] >= 1,
          "batched_stft did not launch the STFT kernel")
    err_bs = crel_err(y_bs.cpu().numpy(), want_bs)
    check(err_bs <= ORACLE_TOL, f"batched_stft rel err {err_bs:.3e}")
    ck.reset_launches()
    y_sg = sp.spectrogram(x_bs, L_ST, HOP_ST)
    torch.cuda.synchronize()
    sg_launches = ck.LAUNCHES["stft"]
    err_sg = rel_err(y_sg.cpu().numpy(), np.abs(want_bs) ** 2)
    check(sg_launches >= 1 and err_sg <= ORACLE_TOL,
          f"spectrogram rel err {err_sg:.3e}, launches {sg_launches}")
    rec = sp.istft(sp.stft(x_bs, L_ST, HOP_ST), N_BS, L_ST, HOP_ST)
    core = slice(L_ST, N_BS - L_ST)
    trip_st = float(np.max(np.abs(rec.cpu().numpy()[:, core]
                                  - x_bs[:, core])))
    check(trip_st <= STFT_TRIP_TOL, f"istft round trip {trip_st:.3e}")
    f_w, p_w = sp.welch(x_bs, nperseg=L_ST)
    err_w = rel_err(p_w.cpu().numpy(), sp.welch_na(x_bs, nperseg=L_ST)[1])
    check(err_w <= ORACLE_TOL, f"welch rel err {err_w:.3e}")
    print(f"main: stft {N_ST} {L_ST}/{HOP_ST} routes {st_routes} rel "
          f"{err_st:.2e} (stft launches {launches['stft']}) | forced "
          + " | ".join(f"{k} rel {v:.2e}" for k, v in forced_err.items())
          + f" | batched_stft {ROWS_BS}x{N_BS} rel {err_bs:.2e} (stft "
          f"launches {launches['stft_batched']}) | spectrogram rel "
          f"{err_sg:.2e} (launches {sg_launches}) | istft round trip "
          f"interior max abs {trip_st:.2e} | welch nperseg {L_ST} rel "
          f"{err_w:.2e}")

    an_parts = []
    for rows, n, route in ((8, 1024, "matmul_dft"),
                           (4, 65536, "xla_fft")):
        x_h = rng.randn(rows, n).astype(np.float32)
        obs.reset()
        y_h = sp.hilbert(x_h)
        env = sp.envelope(x_h)
        torch.cuda.synchronize()
        h_routes = {e["decision"] for e in obs.events()
                    if e["op"] == "hilbert_route"}
        check(h_routes == {route}, f"hilbert n={n} routes {h_routes}")
        want_h = sp.hilbert_na(x_h)
        err_h = max(crel_err(y_h.cpu().numpy(), want_h),
                    rel_err(env.cpu().numpy(), np.abs(want_h)))
        check(err_h <= ORACLE_TOL, f"hilbert n={n} rel err {err_h:.3e}")
        an_parts.append(f"hilbert/envelope {rows}x{n} {route} rel "
                        f"{err_h:.2e}")
    x_cw = rng.randn(ROWS_CWT, N_CWT).astype(np.float32)
    scales = np.geomspace(2.0, 512.0, SCALES_CWT)
    obs.reset()
    y_cw = sp.morlet_cwt(x_cw, scales)
    torch.cuda.synchronize()
    cw_routes = [e["decision"] for e in obs.events()
                 if e["op"] == "morlet_cwt_route"]
    check(cw_routes == ["ct_matmul"], f"morlet_cwt routes {cw_routes}")
    err_cw = crel_err(y_cw.cpu().numpy(), sp.morlet_cwt_na(x_cw, scales))
    check(err_cw <= ORACLE_TOL, f"morlet_cwt rel err {err_cw:.3e}")
    print("main: " + " | ".join(an_parts) + f" | morlet_cwt {ROWS_CWT}x"
          f"{N_CWT} {SCALES_CWT} scales {cw_routes[0]} rel {err_cw:.2e}")

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
    # the handle's own cuFFT overlap-save route (the os_fft path) at the
    # same shape, K1's yardstick for the convolve.os route prior
    y_osf = cv._conv_overlap_save(xh, th, handle.block_length)
    err_osf = rel_err(y_osf.cpu().numpy(), fft_conv64(x_head, h_head))
    check(err_osf <= ORACLE_TOL, f"cuFFT overlap-save rel err "
          f"{err_osf:.3e}")

    def os_fft():
        return cv._conv_overlap_save(xh, th, handle.block_length)

    print(f"os_fft: convolve._conv_overlap_save {N_HEAD}x{K_HEAD} (cuFFT, "
          f"block {handle.block_length}) on the card "
          f"{bm.device_time_ms(os_fft):.4f} ms chained, device busy "
          f"{bm.device_busy_ms(os_fft):.4f} ms, rel {err_osf:.2e} | "
          "breakdown (device us per call): "
          + bm.device_breakdown(os_fft, calls=5))
    xs_t, hs_t = cuda(x_fb), cuda(h_fb)
    simd_ms = bm.device_time_ms(lambda: cv.convolve_simd(xs_t, hs_t))

    def simd_from_numpy():
        cv.convolve_simd(x_fb, h_fb)
        torch.cuda.synchronize()

    print(f"direct: convolve_simd {ROWS_FB}x{N_FB}x{K_FB} on the card "
          f"{simd_ms:.4f} ms = "
          f"{ROWS_FB * N_FB / simd_ms / 1e3:.1f} Msamples/s")
    bd_simd = bm.device_breakdown(simd_from_numpy, calls=5)
    print("breakdown convolve_simd (from NumPy input, device us per "
          "call): " + bd_simd)
    # the halo and the reversal are read in the kernel: no pad (an
    # elementwise copy and fill) and no flip (an index kernel) runs
    check("elementwise" not in bd_simd,
          f"convolve_simd runs a pad or flip kernel: {bd_simd}")

    # the wavelet slice and 2D convolution, operands on the card
    xw_t = cuda(x_wv)
    def dwt():
        return wv.wavelet_apply("daub", 8, P, xw_t)

    dwt_ms = bm.device_time_ms(dwt)
    print(f"dwt: wavelet_apply {ROWS_WV}x{N_WV} daub8 on the card "
          f"{dwt_ms:.4f} ms = {ROWS_WV * N_WV / dwt_ms / 1e3:.1f} "
          "Msamples/s (chained)")
    print("breakdown dwt (device us per call): "
          + bm.device_breakdown(dwt, calls=5))

    def cascade():
        return wv.wavelet_transform("daub", 8, P, xw_t, LEVELS)

    def fused_cascade():
        os.environ[FORCE_FUSED] = "1"
        try:
            return cascade()
        finally:
            del os.environ[FORCE_FUSED]

    # in turns: loop, fused, fused, loop (one card, one call); the
    # chained time (CUDA events) and the device's busy time per call
    casc = [("level_loop", cascade), ("fused", fused_cascade),
            ("fused", fused_cascade), ("level_loop", cascade)]
    casc_ms = [(name, bm.device_time_ms(fn), bm.device_busy_ms(fn))
               for name, fn in casc]
    print(f"cascade: wavelet_transform daub8 L{LEVELS} {ROWS_WV}x{N_WV} "
          "ms per call (chained / device busy), in turns: " + " | ".join(
              f"{name} {ms:.4f} = {ROWS_WV * N_WV / ms / 1e3:.1f} "
              f"Msamples/s / {busy:.4f}" for name, ms, busy in casc_ms))
    print("breakdown cascade level loop (device us per call): "
          + bm.device_breakdown(cascade, calls=5))
    bd_fused = bm.device_breakdown(fused_cascade, calls=5)
    print("breakdown cascade fused (device us per call): " + bd_fused)
    # the route's device work is the one cascade-bank launch: no
    # extension copy (cat), no interleaving stack
    fused_kernels = bm.device_kernels(fused_cascade, calls=5)
    check(fused_kernels and all("cb_frames" in k for k in fused_kernels),
          f"the fused cascade runs more than K3: {fused_kernels}")
    x2_t, h2_t = cuda(x_2d), cuda(h_2d)
    c2d_ms = bm.device_time_ms(lambda: cv2.convolve2d(x2_t, h2_t))
    print(f"conv2d: convolve2d {IMGS_2D}x{N_2D}x{N_2D} k {K_2D}x{K_2D} on "
          f"the card {c2d_ms:.4f} ms = "
          f"{IMGS_2D * N_2D * N_2D / c2d_ms / 1e3:.1f} Msamples/s")
    bd_2d = bm.device_breakdown(lambda: cv2.convolve2d(x2_t, h2_t),
                                calls=5)
    print("breakdown convolve2d (device us per call): " + bd_2d)
    check("elementwise" not in bd_2d,
          f"convolve2d runs a pad or flip kernel: {bd_2d}")

    # the spectral slice, operands on the card
    xst_t = cuda(x_st)
    xbs_t = cuda(x_bs)

    def stft_numpy():
        sp.stft(x_st, L_ST, HOP_ST)
        torch.cuda.synchronize()

    def batched_numpy():
        bt.batched_stft(x_bs, L_ST, HOP_ST)
        torch.cuda.synchronize()

    spectral_calls = [
        ("stft auto", lambda: sp.stft(xst_t, L_ST, HOP_ST), stft_numpy,
         N_ST),
        ("stft rdft_matmul",
         lambda: sp.stft(xst_t, L_ST, HOP_ST, route="rdft_matmul"), None,
         N_ST),
        ("stft xla_fft",
         lambda: sp.stft(xst_t, L_ST, HOP_ST, route="xla_fft"), None,
         N_ST),
        ("batched_stft", lambda: bt.batched_stft(xbs_t, L_ST, HOP_ST),
         batched_numpy, ROWS_BS * N_BS),
    ]
    for name, fn, from_np, samples in spectral_calls:
        chained = bm.device_time_ms(fn)
        busy = bm.device_busy_ms(fn)
        line = (f"spectral: {name} {L_ST}/{HOP_ST} on {samples} samples, "
                f"on the card {chained:.4f} ms chained = "
                f"{samples / chained / 1e3:.1f} Msamples/s, device busy "
                f"{busy:.4f} ms")
        if from_np is not None:
            line += (f" | from NumPy input, host clock "
                     f"{bm.host_time(from_np, repeats=5) * 1e3:.3f} ms")
        print(line)
        print(f"breakdown {name} (device us per call): "
              + bm.device_breakdown(fn, calls=5))

    # K2 and K5 through the direct routes' own calls: the unpadded
    # input, the halo and (for convolution) the reversed taps read in
    # the kernel
    xf = cuda(x_fb)
    ff = cuda(h_fb).reshape(1, K_FB)
    ff_flip = cuda(h_fb[::-1].copy()).view(1, 1, K_FB)
    n_out_fb = N_FB + K_FB - 1

    # the K2 variants at 512 x 16384 across k, in turns (ffma, mma, mma,
    # ffma): the data for FB_MMA_MIN_K and the convolve.direct gate
    sweep = []
    for k in K_SWEEP:
        fk = cuda(rng.randn(1, k))

        def sweep_call(v, fk=fk, k=k):
            return lambda: ck.filter_bank_cuda(
                xf, fk, 1, 1, N_FB + k - 1, pad_left=k - 1, variant=v)

        turns = [(v, bm.device_busy_ms(sweep_call(v), calls=10))
                 for v in ("ffma", "mma", "mma", "ffma")]
        bound = bm.fp32_bound(*bm.conv_work(ROWS_FB, N_FB, k))[0]
        sweep.append((k, turns, bound))
    # each variant's mean at the main shape, for the kernels line
    fb_variant_ms = {v: float(np.mean([ms for v_, ms in turns if v_ == v]))
                     for k, turns, _ in sweep if k == K_FB
                     for v in ("ffma", "mma")}
    print(f"k-sweep: K2 at {ROWS_FB}x{N_FB}, profiled ms per call in turns "
          "(picked by FB_MMA_MIN_K = " f"{ck.FB_MMA_MIN_K}): " + " | ".join(
              f"k {k} " + " ".join(f"{v} {ms:.4f}" for v, ms in turns)
              + f" bound {bound:.4f}" for k, turns, bound in sweep))
    # K2 at the DWT shape, K3 at the cascade shape, K5 at the 2D shape
    xw_ext = wv._extend(xw_t, P, 8).contiguous()
    fw = wv._filter_tensor(wv.WaveletType("daub"), 8, dev)
    n_dwt = N_WV // 2
    plans, taps, reach = wv._cascade_plan_for(
        wv.WaveletType("daub"), 8, LEVELS)
    ns = 1 << LEVELS
    n_cb = N_WV // ns
    xc_ext = wv._extend(xw_t, P, reach + ns).contiguous()
    n_slots = sum(len(plan) for plan in plans)
    max_off = max(o for plan in plans for _, o in plan)
    w_cb = np.zeros((len(plans), (max_off + 1) * ns), np.float32)
    for c, (plan, t) in enumerate(zip(plans, taps)):
        for (p_, o_), tap in zip(plan, t):
            w_cb[c, o_ * ns + p_] += tap
    w_cb_t = cuda(w_cb).unsqueeze(1)
    k2f = x2_t.new_tensor(h_2d[::-1, ::-1].copy())
    n_2d = N_2D + K_2D - 1

    def conv1d_head():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv1d(xh.view(1, 1, -1), th.flip(0).view(1, 1, -1),
                            padding=K_HEAD - 1)

    def conv1d_fb():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv1d(xf.view(ROWS_FB, 1, -1), ff_flip,
                            padding=K_FB - 1)

    def conv1d_dwt():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv1d(xw_ext.unsqueeze(1), fw.unsqueeze(1),
                            stride=2)[..., :n_dwt]

    def conv1d_cb():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv1d(xc_ext.unsqueeze(1), w_cb_t,
                            stride=ns)[..., :n_cb]

    def conv2d_2d():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv2d(x2_t.unsqueeze(1), k2f.view(1, 1, K_2D, K_2D),
                            padding=K_2D - 1)

    win_st = cuda(sp.hann_window(L_ST))

    def torch_stft():
        return torch.stft(xst_t, L_ST, HOP_ST, window=win_st, center=False,
                          return_complex=True)

    # float64 references of the kernels' own functions
    xc64 = xc_ext.cpu().numpy().astype(np.float64)
    want_cb = np.zeros((len(plans), ROWS_WV, n_cb))
    for c, (plan, t) in enumerate(zip(plans, taps)):
        for (p_, o_), tap in zip(plan, t):
            start = o_ * ns + p_
            want_cb[c] += float(tap) * xc64[:, start:start
                                            + (n_cb - 1) * ns + 1:ns]
    lib_err = {
        "filter_bank_dwt": rel_err(
            conv1d_dwt().transpose(0, 1).cpu().numpy(),
            np.stack([want_hi, want_lo])),
        "cascade_bank": rel_err(conv1d_cb().transpose(0, 1).cpu().numpy(),
                                want_cb),
        "filter_2d": rel_err(conv2d_2d().squeeze(1).cpu().numpy(),
                             conv2d64(x_2d, h_2d)),
        "overlap_save": rel_err(conv1d_head().view(-1).cpu().numpy(),
                                fft_conv64(x_head, h_head)),
        "filter_bank": rel_err(
            conv1d_fb().view(ROWS_FB, -1).cpu().numpy(),
            fft_conv64(x_fb, h_fb)),
        "stft": crel_err(torch_stft().T.cpu().numpy(), want_st),
    }
    work = {
        "filter_bank_dwt": (2.0 * 2 * 8 * ROWS_WV * n_dwt,
                            4.0 * (xw_ext.numel() + 16
                                   + 2 * ROWS_WV * n_dwt)),
        # the unextended signal read once, its n coefficients a row
        # written once: the periodic form's own traffic
        "cascade_bank": (2.0 * n_slots * ROWS_WV * n_cb,
                         4.0 * (xw_t.numel() + n_slots + ROWS_WV * N_WV)),
        "filter_2d": bm.conv2d_work(IMGS_2D, N_2D, N_2D, K_2D, K_2D),
        "overlap_save": bm.conv_work(1, N_HEAD, K_HEAD),
        # the functions' least work (FFT form where it is less)
        "filter_bank": bm.conv_work(ROWS_FB, N_FB, K_FB),
        "stft": bm.stft_work(1, N_ST, L_ST, HOP_ST),
    }
    timed = {
        "filter_bank_dwt": (
            lambda: ck.filter_bank_cuda(xw_ext, fw, 2, 1, n_dwt),
            lambda: ck.filter_bank_plain(xw_ext, fw, 2, 1, n_dwt),
            conv1d_dwt),
        # the periodic form, as the fused route calls it
        "cascade_bank": (
            lambda: ck.cascade_bank_periodic_cuda(xw_t, taps, plans,
                                                  LEVELS),
            lambda: ck.cascade_bank_periodic_plain(xw_t, taps, plans,
                                                   LEVELS),
            conv1d_cb),
        "filter_2d": (
            lambda: ck.filter_2d_cuda(x2_t, h2_t, n_2d, n_2d,
                                      pad=(K_2D - 1,) * 2,
                                      reverse_taps=True),
            lambda: ck.filter_2d_plain(x2_t, h2_t, n_2d, n_2d,
                                       (K_2D - 1,) * 2, True),
            conv2d_2d),
        "overlap_save": (
            lambda: ck.overlap_save_cuda(xh, th),
            lambda: ck.overlap_save_plain(xh, th), conv1d_head),
        "filter_bank": (
            lambda: ck.filter_bank_cuda(xf, ff, 1, 1, n_out_fb,
                                        pad_left=K_FB - 1,
                                        reverse_taps=True),
            lambda: ck.filter_bank_plain(xf, ff, 1, 1, n_out_fb,
                                         K_FB - 1, True),
            conv1d_fb),
        "stft": (
            lambda: ck.stft_cuda(xst_t, win_st, L_ST, HOP_ST),
            lambda: ck.stft_plain(xst_t, sp.hann_window(L_ST), L_ST,
                                  HOP_ST),
            torch_stft),
    }
    meta = {
        "filter_bank_dwt": (
            "veles/simd_tpu_torch/csrc/filter_bank.cu",
            "veles/simd_tpu/ops/pallas_kernels.py:326",
            f"{ROWS_WV}x{N_WV} daub8 DWT", parity["fb C2 s2 512x4096 daub8"]),
        "cascade_bank": (
            "veles/simd_tpu_torch/csrc/cascade_bank.cu",
            "veles/simd_tpu/ops/pallas_kernels.py:387",
            f"{ROWS_WV}x{N_WV} daub8 L{LEVELS}",
            parity["cb daub8 L3 512x4096 periodic"]),
        "filter_2d": (
            "veles/simd_tpu_torch/csrc/filter_2d.cu",
            "veles/simd_tpu/ops/pallas_kernels.py:515",
            f"{IMGS_2D}x{N_2D}x{N_2D} k {K_2D}x{K_2D}",
            parity["f2d 16x512x512 7x7"]),
        "overlap_save": (
            "veles/simd_tpu_torch/csrc/overlap_save.cu",
            "veles/simd_tpu/ops/pallas_kernels.py:679",
            f"{N_HEAD}x{K_HEAD}", parity["os 1048576x2047"]),
        "filter_bank": (
            "veles/simd_tpu_torch/csrc/filter_bank.cu",
            "veles/simd_tpu/ops/pallas_kernels.py:326",
            f"{ROWS_FB}x{N_FB}x{K_FB}", parity["fb C1 512x16384x129"]),
        "stft": (
            "veles/simd_tpu_torch/csrc/stft.cu",
            "veles/simd_tpu/ops/pallas_kernels.py:831",
            f"{N_ST} samples, {L_ST}/{HOP_ST}",
            parity["stft 1x1048576 512/128"]),
    }
    rows = []
    for name, (kern, plain, lib) in timed.items():
        # device time per call (torch.profiler): the kernels of the
        # wavelet and 2D shapes are shorter than their wrappers' host
        # dispatch, so chained CUDA events would time the host
        ms = bm.device_busy_ms(kern, calls=20)
        chained_ms = bm.device_time_ms(kern, iters=50)
        plain_ms = bm.device_busy_ms(plain, calls=3)
        lib_ms = bm.device_busy_ms(lib, calls=20)
        bound_ms, bound_by = bm.fp32_bound(*work[name])
        source, replaces, shape, (diff, rel) = meta[name]
        variant = {"filter_bank": ck.fb_variant(K_FB, 1, 1),
                   "filter_bank_dwt": ck.fb_variant(8, 2, 1)}.get(name)
        rows.append({
            "name": name.replace("_dwt", ""), "route": "cuda",
            "source": source,
            "replaces": replaces, "shape": shape,
            "launches": launches[name], "max_abs_err": diff,
            "max_rel_err": rel, "ms": ms, "chained_ms": chained_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "library_rel_err_vs_f64": lib_err[name],
        })
        if variant is not None:
            rows[-1]["variant"] = variant
        if name == "filter_bank":
            # both variants at this shape (k-sweep, profiled, in turns)
            rows[-1]["variant_ms"] = fb_variant_ms
        if name == "cascade_bank":
            # the contract form on the extended input, as the parity
            # and the library yardstick read it
            rows[-1]["form"] = "periodic"
            rows[-1]["contract_ms"] = bm.device_busy_ms(
                lambda: ck.cascade_bank_cuda(xc_ext, taps, plans, ns, n_cb),
                calls=20)
    elapsed = time.perf_counter() - t_start
    print(f"times: card {smi} | chip_smoke {elapsed:.1f} s so far")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
