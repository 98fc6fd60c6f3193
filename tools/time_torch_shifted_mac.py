#!/usr/bin/env python3
"""Take apart the time of the port's shifted-MAC kernels (K2's mma
variant, ``csrc/filter_bank.cu``, and K5, ``csrc/filter_2d.cu``) on one
CUDA card.

    python3 tools/time_torch_shifted_mac.py

Builds copies of the two sources with one part of the work switched
off (``no_compute``: no multiply-adds; ``no_staging``: no input copies,
the kernel computes on whatever shared memory holds; ``no_stores``: no
output writes) into ``build/shifted_mac/``, and times each, with the
intact kernels, at the main path's shapes: K5 on 16 x 512 x 512 with 7 x
7 through the padded entry, K2 on 512 x 16,384 at 4 and 129 taps (both
variants for the intact build).  Then times two throughput loops on
every SM: ``mma.sync.m16n8k8`` in TF32 and fp32 FFMA.  Prints the card's
name and power limit, then one JSON line per build and per loop, device
time per call from ``torch.profiler``.  Exits non-zero without a card.
The copies are diagnostics only; their outputs are not checked.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "veles", "simd_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "shifted_mac")
SOURCES = ("async_copy.cuh", "filter_2d.cu", "filter_bank.cu")
# (source, text, replacement) of each build; every text must be found
BUILDS = {
    "intact": (),
    "no_compute": (
        ("filter_2d.cu", "for (int r = 0; r < F2D_RY + k0 - 1; ++r) {",
         "for (int r = 0; r < 0; ++r) {"),
        ("filter_bank.cu", "for (int s = 0; s < steps; s += 2) {",
         "for (int s = 0; s < 0; s += 2) {")),
    "no_staging": (
        ("filter_2d.cu", "        if (t < tiles) {", "        if (false) {"),
        ("filter_bank.cu", "        if (t < tiles) {",
         "        if (false) {")),
    "no_stores": (
        ("filter_2d.cu", "if (j0 + c < n_out1) orow[j0 + c] = acc[ry][c];",
         "if (j0 + c < n_out1 && acc[ry][c] == 1234.5f) "
         "orow[j0 + c] = acc[ry][c];"),
        ("filter_bank.cu", "for (int m = lane; m < lim; m += 32) oc[m] = wo[m];",
         "for (int m = lane; m < lim; m += 32) "
         "if (wo[m] == 1234.5f) oc[m] = wo[m];")),
}
LOOPS = r'''
#include <cuda_runtime.h>
#include <stdint.h>
// 8 independent accumulator chains a warp, `iters` times
__global__ void mma_loop(float* out, int iters) {
  const uint32_t a = 0x3f800000u + threadIdx.x;
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%4,%4}, {%0,%1,%2,%3};\n"
                   : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
                     "+f"(acc[c][3]) : "r"(a));
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// 16 independent FFMA chains a thread, `iters` times
__global__ void ffma_loop(float* out, int iters) {
  float acc[16];
  for (int i = 0; i < 16; ++i) acc[i] = threadIdx.x * 1e-3f + i;
  const float t = out[0] * 0.f + 1.0001f;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = fmaf(acc[i], t, 1e-7f);
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_loop(int mma, float* out, int iters, int blocks,
                        int threads, void* stream) {
  if (mma) mma_loop<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  else ffma_loop<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
'''
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared")


def build(nvcc):
    """One shared library per build and one for the loops, compiled in
    parallel; returns their paths."""
    procs, libs = [], {}
    for name, edits in BUILDS.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for src in SOURCES:
            text = open(os.path.join(CSRC, src)).read()
            for where, old, new in edits:
                if where == src:
                    if old not in text:
                        raise RuntimeError(f"{name}: {old!r} not in {src}")
                    text = text.replace(old, new)
            open(os.path.join(d, src), "w").write(text)
        libs[name] = os.path.join(d, "lib.so")
        procs.append(subprocess.Popen(
            [nvcc, *FLAGS, "-o", libs[name], os.path.join(d, "filter_2d.cu"),
             os.path.join(d, "filter_bank.cu")]))
    loops = os.path.join(OUT, "loops.cu")
    open(loops, "w").write(LOOPS)
    libs["loops"] = os.path.join(OUT, "loops.so")
    procs.append(subprocess.Popen([nvcc, *FLAGS, "-o", libs["loops"], loops]))
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("nvcc failed")
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        print("time_torch_shifted_mac: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.utils import benchmark as bm
    from veles.simd_tpu_torch.utils.platform import smi_line

    print(smi_line())
    libs = build(ck._nvcc())
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dev = torch.device("cuda")
    rng = np.random.RandomState(20261016)

    def cuda(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device=dev)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    x2, k2 = cuda(16, 512, 512), cuda(7, 7)
    y2 = torch.empty(16, 518, 518, device=dev)
    x1 = cuda(512, 16384)
    taps = {k: cuda(1, k) for k in (4, 129)}
    y1 = {k: torch.empty(1, 512, 16384 + k - 1, device=dev) for k in taps}
    for name in BUILDS:
        lib = ctypes.CDLL(libs[name])
        lib.veles_f2d_f32.argtypes = [P, P, P, L, L, L, I, I, L, L, L, L, I,
                                      P]
        lib.veles_fb_f32.argtypes = [P, P, P, L, L, I, I, I, I, L, L, I, I,
                                     P]

        def f2d(lib=lib):
            err = lib.veles_f2d_f32(x2.data_ptr(), k2.data_ptr(),
                                    y2.data_ptr(), 16, 512, 512, 7, 7, 518,
                                    518, 6, 6, 1, stream())
            if err:
                raise RuntimeError(f"filter_2d: CUDA error {err}")

        def fb(k, variant, lib=lib):
            err = lib.veles_fb_f32(x1.data_ptr(), taps[k].data_ptr(),
                                   y1[k].data_ptr(), 512, 16384, 1, k, 1, 1,
                                   16384 + k - 1, k - 1, 1, variant,
                                   stream())
            if err:
                raise RuntimeError(f"filter_bank: CUDA error {err}")

        row = {"build": name, "filter_2d_ms": bm.device_busy_ms(f2d)}
        for k in taps:
            row[f"filter_bank_mma_k{k}_ms"] = bm.device_busy_ms(
                lambda k=k: fb(k, 2))
            if name == "intact":
                row[f"filter_bank_ffma_k{k}_ms"] = bm.device_busy_ms(
                    lambda k=k: fb(k, 1))
        print(json.dumps(row), flush=True)
    loops = ctypes.CDLL(libs["loops"])
    loops.run_loop.argtypes = [I, P, I, I, I, P]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(sms * 8 * 256, device=dev)
    iters = 4096
    for mma in (1, 0):
        blocks, threads = sms * 8, 256
        ms = bm.device_busy_ms(
            lambda: loops.run_loop(mma, out.data_ptr(), iters, blocks,
                                   threads, stream()), calls=5)
        warps = blocks * threads // 32
        flops = (2.0 * warps * iters * 8 * 1024 if mma
                 else 2.0 * blocks * threads * iters * 16)
        print(json.dumps({"loop": "mma.sync.m16n8k8 tf32" if mma
                          else "ffma fp32", "blocks": blocks,
                          "threads": threads, "ms": ms,
                          "tflops": flops / ms / 1e9}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
