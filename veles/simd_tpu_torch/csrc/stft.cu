// Short-time Fourier transform of float32 signals, one kernel launch.
//
// Replaces the fused STFT Pallas kernel of the JAX package
// (veles/simd_tpu/ops/pallas_kernels.py: stft_pallas, _stft_call,
// _stft_kernel, _stft_basis_blocks).  It computes the same function, the
// windowed real DFT of every frame, as an implicit GEMM against the
// window-folded real-DFT basis:
//
//     out[b, f, c] = sum_{n < L} x[b, f*hop + n] * B[n, c]
//
// B is [L, 2*bins] (bins = L/2 + 1) with interleaved columns,
// B[n, 2k] = w[n] cos(2 pi n k / L) and B[n, 2k+1] = -w[n] sin(...), so
// each output row of 2*bins floats is one frame's complex64 spectrum
// and the wrapper views it as complex with no copy.  The [frames, L]
// frames matrix never exists: each block reads its frames' samples
// straight from x.
//
// Bound on the H100: the bytes.  At 2^20 samples, L = 512, hop = 128
// the function moves 22.1 MB of signal, basis and spectrum (6.6 us at
// 3.35 TB/s) and needs about 0.1 GFLOP in FFT form.  This kernel's DFT
// form does 2*frames*L*2*bins = 4.31 GFLOP of fp32 FFMA instead (64 us
// at 67 TFLOP/s), so it cannot come within 10x of the bound; an
// O(L log L) form, or the tensor cores, are later work.  The Pallas
// kernel runs its dots at "highest", and fp32 FFMA keeps that accuracy.
//
// Design.  The TPU kernel walks each row's hop-blocks in grid order and
// carries the L - hop sample overlap in VMEM; Hopper runs blocks in
// parallel, so nothing is carried: each block re-reads its frames'
// samples from global memory (the signal stays in L2; each sample is
// read L/hop times).  The 128-lane padding of the bins and the r =
// L/hop shift-dot split are TPU layout and are not carried over.
//
// A block computes ST_TF frames x ST_TC basis columns with ST_THREADS
// threads, 4 x 4 outputs a thread.  The K loop runs over the frame's
// samples in chunks of ST_KC.  Per chunk the block stages the frames'
// samples, transposed to [sample][frame], and the basis rows in shared
// memory.  A warp stages 8 samples of 4 frames per step: 32-byte
// sectors from global memory, and with the row pitch of 68 floats its
// 32 stores hit 32 banks.  Each thread then reads one float4 of
// samples and one of basis per sample index and does 16 FFMAs.  Each
// output accumulates over n in increasing order, the order of the
// plain version (stft_plain in ops/cuda_kernels.py).  Shared memory is
// fixed (16.5 KB) whatever L and hop are, so every geometry is
// admitted.  The grid is (frame tiles, column tiles, rows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ST_THREADS = 256;
constexpr int ST_TF = 64;              // frames per block
constexpr int ST_TC = 64;              // basis columns per block
constexpr int ST_KC = 32;              // samples per K chunk
constexpr int ST_APITCH = ST_TF + 4;   // staged-sample row pitch
constexpr long long MAX_GRID_Z = 65535;

__global__ void __launch_bounds__(ST_THREADS)
stft_kernel(const float* __restrict__ x, const float* __restrict__ basis,
            float* __restrict__ out, long long n, int L, int hop,
            long long frames, int cols)
{
    __shared__ __align__(16) float s_a[ST_KC][ST_APITCH];
    __shared__ __align__(16) float s_b[ST_KC][ST_TC];
    const long long f0 = (long long)blockIdx.x * ST_TF;
    const int c0 = blockIdx.y * ST_TC;
    const float* xr = x + (long long)blockIdx.z * n;
    float* orow = out + (long long)blockIdx.z * frames * cols;
    const int tid = threadIdx.x;
    const int tx = tid % 16;           // 4 columns each
    const int ty = tid / 16;           // 4 frames each
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int an = lane % 8;           // staging: sample within 8
    const int af = lane / 8;           // staging: frame within 4

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < L; k0 += ST_KC) {
        __syncthreads();
        // samples: 64 steps of 8 samples x 4 frames, 8 per warp
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int id = warp + 8 * i;
            const int nn = (id % 4) * 8 + an;
            const int ff = (id / 4) * 4 + af;
            const long long f = f0 + ff;
            const int s = k0 + nn;
            s_a[nn][ff] = (f < frames && s < L) ? xr[f * hop + s] : 0.f;
        }
        // basis rows k0 .. k0 + ST_KC, columns c0 .. c0 + ST_TC
#pragma unroll
        for (int i = 0; i < (ST_KC * ST_TC) / ST_THREADS; ++i) {
            const int e = tid + ST_THREADS * i;
            const int kk = e / ST_TC;
            const int cc = e % ST_TC;
            const int s = k0 + kk;
            const int c = c0 + cc;
            s_b[kk][cc] = (s < L && c < cols)
                ? basis[(long long)s * cols + c] : 0.f;
        }
        __syncthreads();
        const int kmax = L - k0 < ST_KC ? L - k0 : ST_KC;
#pragma unroll 8
        for (int kk = 0; kk < kmax; ++kk) {
            const float4 a =
                *reinterpret_cast<const float4*>(&s_a[kk][ty * 4]);
            const float4 b =
                *reinterpret_cast<const float4*>(&s_b[kk][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const long long f = f0 + ty * 4 + i;
        if (f >= frames) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = c0 + tx * 4 + j;
            if (c < cols) orow[f * cols + c] = acc[i][j];
        }
    }
}

}  // namespace

extern "C" int veles_stft_tile_frames(void) { return ST_TF; }
extern "C" int veles_stft_tile_cols(void) { return ST_TC; }
extern "C" long long veles_stft_smem_bytes(void)
{
    return (long long)sizeof(float) * ST_KC * (ST_APITCH + ST_TC);
}

// x [rows, n], basis [L, cols], out [rows, frames, cols]; all float32,
// contiguous, on the device; frames = 1 + (n - L) / hop >= 1.  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int veles_stft_f32(const float* x, const float* basis,
                              float* out, long long rows, long long n,
                              int L, int hop, long long frames, int cols,
                              void* stream)
{
    const unsigned ftiles = (unsigned)((frames + ST_TF - 1) / ST_TF);
    const unsigned ctiles = (unsigned)((cols + ST_TC - 1) / ST_TC);
    for (long long r0 = 0; r0 < rows; r0 += MAX_GRID_Z) {
        const long long nr =
            rows - r0 < MAX_GRID_Z ? rows - r0 : MAX_GRID_Z;
        dim3 grid(ftiles, ctiles, (unsigned)nr);
        stft_kernel<<<grid, ST_THREADS, 0, (cudaStream_t)stream>>>(
            x + r0 * n, basis, out + r0 * frames * cols, n, L, hop,
            frames, cols);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}
