// Short-time Fourier transform of float32 signals, one kernel launch.
//
// Replaces the fused STFT Pallas kernel of the JAX package
// (veles/simd_tpu/ops/pallas_kernels.py: stft_pallas, _stft_call,
// _stft_kernel).  It computes the same function, the windowed real DFT
// of every frame,
//
//     out[b, f, k] = sum_{n < L} w[n] x[b, f*hop + n] e^{-2 pi i n k / L},
//
// k < L/2 + 1, stored as interleaved (re, im) float32, so each output
// row is one frame's complex64 spectrum and the wrapper views it as
// complex with no copy.
//
// Bound on the H100: the bytes.  At 2^20 samples, L = 512, hop = 128 the
// function reads 4.2 MB of signal and writes 16.8 MB of spectrum (6.3
// us at 3.35 TB/s); an FFT needs about 0.1 GFLOP (1.5 us at 67 TFLOP/s).
// The DFT form, an implicit GEMM against an [L, 2*bins] basis, does 4.31
// GFLOP of FFMA, 64 us at the fp32 peak, so it cannot come within 10x of
// the bound: hence an FFT per frame.
//
// Design.  The TPU kernel walks each row's hop-blocks in grid order and
// carries the L - hop sample overlap in VMEM, so it needs hop | L and
// 128-lane hops.  Hopper runs blocks in parallel, so each block takes
// F consecutive frames of one row and loads the samples they share,
// (F-1)*hop + L of them, into shared memory once, with 16-byte loads
// where the span is 16-byte aligned (scalar loads where it is not): the
// block's frames read device memory once, where the DFT-form kernel
// read each sample L/hop times.  Frame f of the block starts at f * hop
// in the span, so any hop < L serves, dividing L or not (Whisper's
// 400/160 stages 16 frames in 2800 samples).  The block's 512 threads
// form F groups of G = 512 / F, one frame each (smem_fft.cuh): G is the
// least power of two >= M/8 (M = L/2, the FFT length) from a warp up, so at
// L = 512 a warp transforms a frame of 256 complex values with 8 values
// a thread and synchronises with __syncwarp alone (radix 8, 8, 4).  A
// group windows and real-packs its frame (z[m] = w[2m] x[2m] + i
// w[2m+1] x[2m+1]) from the staged span, transforms it, unpacks its
// L/2 + 1 bins and writes them once, coalesced, as one contiguous run
// of float2.  An odd L (255/85) goes through the complex path: L points
// with a zero imaginary part.  From L = 8192 on a frame takes the whole
// block (F = 1), with up to 32 values a thread.  Shared memory, the
// span and F padded FFT buffers, grows with L: 44.7 KB at 512/128,
// 135 KB at 16384/128, 204 KB at 16383 (one frame a block, whatever
// the hop), so every L up to 16384 with any hop < L fits.  Twiddles
// come from the wrapper's float64-built table of e^{-2 pi i t / L},
// t < L.
//
// Accuracy: fp32 throughout, within 1e-5 of max|X| of the plain version
// (ops/cuda_kernels.py: stft_plain, the basis sum), not bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_fft.cuh"

namespace {

using veles_fft::Plan;
using veles_fft::padded;
using veles_fft::pad;

constexpr int ST_THREADS = 512;
constexpr long long MAX_GRID_Y = 65535;

int fft_len(int L) { return L % 2 == 0 ? L / 2 : L; }

// threads that share one frame's FFT: a power of two >= M / 8, from a
// warp to the whole block
int group_size(int L)
{
    const int M = fft_len(L);
    int g = 32;
    while (g < ST_THREADS && 8 * g < M) g *= 2;
    return g;
}

int frames_per_block(int L) { return ST_THREADS / group_size(L); }

// floats of the staged span, rounded up to 16 bytes
long long span_floats(int L, int hop, int F)
{
    const long long span = (long long)(F - 1) * hop + L;
    return (span + 3) / 4 * 4;
}

long long smem_bytes(int L, int hop)
{
    const int F = frames_per_block(L);
    return 4 * span_floats(L, hop, F)
        + 8LL * F * padded(fft_len(L));
}

template <int G, int VPT>
__global__ void __launch_bounds__(ST_THREADS)
stft_kernel(const float* __restrict__ x, const float* __restrict__ win,
            const float2* __restrict__ tw, float2* __restrict__ out,
            long long n, int L, int hop, long long frames, int span_alloc,
            Plan plan)
{
    constexpr int F = ST_THREADS / G;
    extern __shared__ __align__(16) float smem[];
    float* s_x = smem;
    const int M = plan.M;
    const bool real = (L % 2) == 0;
    const int tid = threadIdx.x;
    const int grp = tid / G;
    const int lane = tid & (G - 1);
    const long long f0 = (long long)blockIdx.x * F;
    const int nf = (int)(frames - f0 < F ? frames - f0 : F);
    const float* xr = x + (long long)blockIdx.y * n + f0 * hop;
    // the span of the block's nf frames lies in [0, n): the last frame
    // ends at (frames - 1) * hop + L <= n, so nothing past the row is
    // read; the groups past nf transform zeros and store nothing
    const int span = (nf - 1) * hop + L;

    if ((reinterpret_cast<uintptr_t>(xr) & 15) == 0) {
        const int n4 = span >> 2;
        const float4* x4 = reinterpret_cast<const float4*>(xr);
        float4* s4 = reinterpret_cast<float4*>(s_x);
        for (int i = tid; i < n4; i += ST_THREADS) s4[i] = __ldg(x4 + i);
        for (int i = 4 * n4 + tid; i < span; i += ST_THREADS)
            s_x[i] = __ldg(xr + i);
    } else {
        for (int i = tid; i < span; i += ST_THREADS) s_x[i] = __ldg(xr + i);
    }
    __syncthreads();

    // window and pack this group's frame: z[m] at z[pad(m)]
    const bool live = grp < nf;
    float2* z = reinterpret_cast<float2*>(smem + span_alloc)
        + grp * padded(M);
    const float* s = s_x + grp * hop;
    for (int m = lane; m < M; m += G) {
        float2 v = make_float2(0.f, 0.f);
        if (live && real)
            v = make_float2(__ldg(win + 2 * m) * s[2 * m],
                            __ldg(win + 2 * m + 1) * s[2 * m + 1]);
        else if (live)
            v.x = __ldg(win + m) * s[m];
        z[pad(m)] = v;
    }
    veles_fft::group_sync<G>();
    veles_fft::group_fft<G, VPT>(z, lane, plan, tw, real ? 2 : 1, 1.f);
    if (!live) return;

    // unpack and store: the frame's bins are one contiguous run
    const int bins = L / 2 + 1;
    float2* orow = out + ((long long)blockIdx.y * frames + f0 + grp) * bins;
    for (int k = lane; k < bins; k += G) {
        float2 X;
        if (real) {
            X = veles_fft::unpack_real(z, M, k, __ldg(tw + k));
            X.x *= 0.5f;
            X.y *= 0.5f;
        } else {
            X = z[pad(k)];
        }
        __stcs(orow + k, X);
    }
}

template <int G, int VPT>
int launch(const float* x, const float* win, const float2* tw, float2* out,
           long long rows, long long n, int L, int hop, long long frames,
           cudaStream_t stream)
{
    constexpr int F = ST_THREADS / G;
    const Plan plan = veles_fft::make_plan(fft_len(L));
    const int span_alloc = (int)span_floats(L, hop, F);
    const long long bytes = smem_bytes(L, hop);
    cudaError_t err = cudaFuncSetAttribute(
        stft_kernel<G, VPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((frames + F - 1) / F);
    const int bins = L / 2 + 1;
    for (long long r0 = 0; r0 < rows; r0 += MAX_GRID_Y) {
        const long long nr = rows - r0 < MAX_GRID_Y ? rows - r0 : MAX_GRID_Y;
        dim3 grid(blocks, (unsigned)nr);
        stft_kernel<G, VPT><<<grid, ST_THREADS, bytes, stream>>>(
            x + r0 * n, win, tw, out + r0 * frames * bins, n, L, hop,
            frames, span_alloc, plan);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int veles_stft_frames_per_block(int L)
{
    return frames_per_block(L);
}

extern "C" long long veles_stft_smem_bytes(int L, int hop)
{
    return smem_bytes(L, hop);
}

// x [rows, n], win [L], tw [L] complex (e^{-2 pi i t / L}), out [rows,
// frames, L/2 + 1] complex; all on the device, contiguous; frames = 1 +
// (n - L) / hop >= 1, 1 <= hop < L.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a geometry the kernel
// does not admit: the wrapper checks first).
extern "C" int veles_stft_f32(const float* x, const float* win,
                              const float* tw, float* out, long long rows,
                              long long n, int L, int hop, long long frames,
                              void* stream)
{
    if (L < 2 || hop < 1 || L <= hop || frames < 1
            || smem_bytes(L, hop) > 232448)
        return (int)cudaErrorInvalidValue;
    const float2* tw2 = reinterpret_cast<const float2*>(tw);
    float2* out2 = reinterpret_cast<float2*>(out);
    const cudaStream_t s = (cudaStream_t)stream;
    const int M = fft_len(L);
    switch (group_size(L)) {
    case 32:
        return launch<32, 8>(x, win, tw2, out2, rows, n, L, hop, frames, s);
    case 64:
        return launch<64, 8>(x, win, tw2, out2, rows, n, L, hop, frames, s);
    case 128:
        return launch<128, 8>(x, win, tw2, out2, rows, n, L, hop, frames, s);
    case 256:
        return launch<256, 8>(x, win, tw2, out2, rows, n, L, hop, frames, s);
    }
    if (M <= 8 * ST_THREADS)
        return launch<512, 8>(x, win, tw2, out2, rows, n, L, hop, frames, s);
    if (M <= 16 * ST_THREADS)
        return launch<512, 16>(x, win, tw2, out2, rows, n, L, hop, frames, s);
    if (M <= 32 * ST_THREADS)
        return launch<512, 32>(x, win, tw2, out2, rows, n, L, hop, frames, s);
    return (int)cudaErrorInvalidValue;
}
