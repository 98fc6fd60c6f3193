// Full linear convolution y = x * taps in float32, one kernel launch.
//
// Replaces the fused overlap-save Pallas kernel of the JAX package
// (veles/simd_tpu/ops/pallas_kernels.py: overlap_save_pallas, _os_call,
// _os_kernel).  It computes the same function, full length n + k - 1,
// each batch row on its own with zero history:
//
//     y[b, t] = sum_j taps[j] * x[b, t - j],   x[b, s] = 0 off [0, n)
//
// Bound on the H100: fp32 FFMA.  The work is 2*k*n FLOPs per row
// (4.29 GFLOP at n = 2^20, k = 2047: 64 us at 67 TFLOP/s), against
// 8.4 MB of signal in and out (2.5 us at 3.35 TB/s).  No tensor cores
// in this kernel: the Pallas kernel runs at "highest", and plain FFMA
// accumulation in fp32 registers keeps that accuracy; a split-TF32
// wgmma redesign is later work.
//
// Design.  The TPU kernel walks each row's output blocks in grid order
// and carries the k-1 sample halo in VMEM; Hopper runs blocks in
// parallel, so nothing is carried.  Each block owns OS_TILE consecutive
// outputs of one row and loops over chunks of OS_KC taps.  Per chunk it
// stages the taps and the input window those taps need (halo included,
// read again from global memory; the signal is small next to L2) in
// shared memory, zero outside [0, n), which is the per-row restart.
// Each thread keeps OS_R consecutive outputs in registers; per group of
// OS_R taps it loads 2*OS_R-1 window samples and does OS_R^2 FFMAs, so
// shared-memory loads stay under a quarter of the FFMAs (the H100 SM
// issues four FFMA warp instructions per shared-memory wavefront).
// OS_R is odd, so the lanes' window reads (stride OS_R) hit 32 distinct
// banks.  Outputs go back through shared memory for coalesced stores.
// Shared memory is fixed (about 8.7 KB) whatever k is, so every
// k >= 1 is admitted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OS_THREADS = 128;
constexpr int OS_R = 13;
constexpr int OS_TILE = OS_THREADS * OS_R;
constexpr int OS_KC = 20 * OS_R;
constexpr int OS_WIN = OS_TILE + OS_KC - 1;
constexpr long long MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(OS_THREADS)
os_conv_kernel(const float* __restrict__ x, const float* __restrict__ taps,
               float* __restrict__ y, long long n, int k,
               long long out_len)
{
    __shared__ float s_taps[OS_KC];
    __shared__ float s_x[OS_WIN];
    const float* xr = x + (long long)blockIdx.y * n;
    float* yr = y + (long long)blockIdx.y * out_len;
    const long long t0 = (long long)blockIdx.x * OS_TILE;
    const int tid = threadIdx.x;
    const int base = tid * OS_R;

    float acc[OS_R];
#pragma unroll
    for (int r = 0; r < OS_R; ++r) acc[r] = 0.f;

    for (int c0 = 0; c0 < k; c0 += OS_KC) {
        __syncthreads();
        for (int i = tid; i < OS_KC; i += OS_THREADS) {
            const int j = c0 + i;
            s_taps[i] = j < k ? taps[j] : 0.f;
        }
        // s_x[m] = x[t0 - c0 - (OS_KC - 1) + m]
        const long long src0 = t0 - c0 - (OS_KC - 1);
        for (int m = tid; m < OS_WIN; m += OS_THREADS) {
            const long long s = src0 + m;
            s_x[m] = (s >= 0 && s < n) ? xr[s] : 0.f;
        }
        __syncthreads();
        // tap c0 + g + u, output t0 + base + r reads
        // s_x[base + r - g - u + OS_KC - 1] = p[r - u + OS_R - 1]
#pragma unroll 1
        for (int g = 0; g < OS_KC; g += OS_R) {
            const float* p = s_x + base + OS_KC - 1 - g - (OS_R - 1);
            float xv[2 * OS_R - 1];
#pragma unroll
            for (int d = 0; d < 2 * OS_R - 1; ++d) xv[d] = p[d];
#pragma unroll
            for (int u = 0; u < OS_R; ++u) {
                const float t = s_taps[g + u];
#pragma unroll
                for (int r = 0; r < OS_R; ++r)
                    acc[r] = fmaf(t, xv[r - u + OS_R - 1], acc[r]);
            }
        }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < OS_R; ++r) s_x[base + r] = acc[r];
    __syncthreads();
    for (int m = tid; m < OS_TILE; m += OS_THREADS) {
        const long long t = t0 + m;
        if (t < out_len) yr[t] = s_x[m];
    }
}

}  // namespace

extern "C" int veles_os_tile(void) { return OS_TILE; }

// The library's one error formatter, for every kernel's wrapper.
extern "C" const char* veles_cuda_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}

// x [rows, n], taps [k], y [rows, n + k - 1]; all float32, contiguous,
// on the device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int veles_os_conv_f32(const float* x, const float* taps,
                                 float* y, long long rows, long long n,
                                 int k, void* stream)
{
    const long long out_len = n + k - 1;
    const unsigned tiles = (unsigned)((out_len + OS_TILE - 1) / OS_TILE);
    for (long long r0 = 0; r0 < rows; r0 += MAX_GRID_Y) {
        const long long nr =
            rows - r0 < MAX_GRID_Y ? rows - r0 : MAX_GRID_Y;
        dim3 grid(tiles, (unsigned)nr);
        os_conv_kernel<<<grid, OS_THREADS, 0, (cudaStream_t)stream>>>(
            x + r0 * n, taps, y + r0 * out_len, n, k, out_len);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}
