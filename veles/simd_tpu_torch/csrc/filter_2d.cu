// 2D FIR correlation (shifted multiply-add) in float32, one kernel
// launch.
//
// Replaces the 2D shifted-MAC Pallas kernel of the JAX package
// (veles/simd_tpu/ops/pallas_kernels.py: filter_2d_pallas, _f2d_call,
// _f2d_kernel), with its whole contract:
//
//     out[b, i, j] = sum_{p, q} k[p, q] * x_ext[b, i + p, j + q]
//
// for any k0 x k1 kernel (the route admits areas up to 256 taps, 1 x 256
// and 256 x 1 included) and any number of leading images, where x_ext is
// x zero-padded by (pad0, pad1) on each side of its two axes and the
// taps may be read flipped on both axes.  The direct route of convolve2d
// and cross_correlate2d passes the unpadded image, pad = (k0-1, k1-1)
// and, for convolution, the flip: the kernel reads the zero halo and the
// flipped taps itself, so neither a padded nor a flipped copy is made.
//
// Bound on the H100: bytes.  On the main path (16 images of 512 x 512,
// 7 x 7, full output 518 x 518) the function reads 16.8 MB and writes
// 17.2 MB: 10.1 us at 3.35 TB/s, against 6.3 us for its 0.42 GFLOP at
// the 67 TFLOP/s fp32 peak.
//
// Design: stream every input byte in about once, overlapped with the
// compute, and keep the FFMA loop fed from registers.  A persistent
// block of 16 x 8 threads walks output tiles of F2D_TY x F2D_TX = 64 x 64
// of all images.  Each tile's input, the tile plus its halo (k0 - 1 rows,
// k1 rounded up to 4 columns), is staged by 4-byte cp.async (any width;
// the zero-fill form, source size 0, writes the zero halo) into one of
// two buffers, so the next tile loads while this one computes.  The taps
// sit in shared memory, flipped or not as they are staged, each row
// zero-padded to a multiple of 4.  A thread owns F2D_RY x F2D_RX = 8 x 4
// outputs (8 rows, 4 adjacent columns).  For each staged input row it
// slides one window along the row, 128-bit loads of 4 new samples per 4
// kernel columns, and applies it to every output row that input row
// feeds (kernel row p = input row - output row), with the 4 taps of
// (p, 4 columns) in one broadcast 128-bit load: at 7 x 7, 42 window
// loads and 112 tap loads for 1,792 FFMAs a thread and tile.  Each
// output sums its taps in row-major order (p, then q), as the plain
// version in cuda_kernels.py does.  Shared memory grows with the kernel;
// the wrapper admits a kernel only when veles_f2d_smem_bytes fits the
// 227 KB a block may use, and every kernel of area <= 256 does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int F2D_BX = 16;
constexpr int F2D_BY = 8;
constexpr int F2D_RX = 4;
constexpr int F2D_RY = 8;
constexpr int F2D_TX = F2D_BX * F2D_RX;
constexpr int F2D_TY = F2D_BY * F2D_RY;
constexpr int F2D_THREADS = F2D_BX * F2D_BY;
constexpr long long SMEM_MAX = 232448;   // 227 KB, opt-in above 48 KB

struct Geometry {
    int k1_pad;   // taps a kernel row holds in shared memory
    int rows;     // staged input rows: the tile and its halo
    int cols;     // staged input columns: the tile, its halo, the pad
};

Geometry geometry(int k0, int k1)
{
    Geometry g;
    g.k1_pad = (k1 + 3) / 4 * 4;
    g.rows = F2D_TY + k0 - 1;
    g.cols = F2D_TX + g.k1_pad;
    return g;
}

long long smem_bytes(int k0, int k1)
{
    const Geometry g = geometry(k0, k1);
    return 4LL * ((long long)k0 * g.k1_pad
                  + 2LL * g.rows * g.cols);
}

__global__ void __launch_bounds__(F2D_THREADS)
f2d_kernel(const float* __restrict__ x, const float* __restrict__ k,
           float* __restrict__ out, long long n0, long long n1, int k0,
           int k1, int k1_pad, int rows, int cols, long long n_out0,
           long long n_out1, long long pad0, long long pad1, int reverse,
           long long tiles_x, long long tiles_img, long long tiles)
{
    extern __shared__ float4 smem4[];
    float* s_k = reinterpret_cast<float*>(smem4);
    float* s_x = s_k + k0 * k1_pad;
    const int stage_len = rows * cols;
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const int tid = ty * F2D_BX + tx;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    // tile t's input into dst: x_ext[img, i0 + r, j0 + c], zeros outside
    // the image; one commit group per call, empty past the end
    auto stage = [&](long long t, float* dst) {
        if (t < tiles) {
            const long long img = t / tiles_img;
            const long long u = t - img * tiles_img;
            const long long ty_ = u / tiles_x;
            const long long r0 = ty_ * F2D_TY - pad0;
            const long long c0 = (u - ty_ * tiles_x) * F2D_TX - pad1;
            const float* xi = x + img * n0 * n1;
            for (int r = warp; r < rows; r += F2D_THREADS / 32) {
                const long long gi = r0 + r;
                const bool row_ok = gi >= 0 && gi < n0;
                const float* xr = xi + (row_ok ? gi : 0) * n1;
                for (int c = lane; c < cols; c += 32) {
                    const long long gj = c0 + c;
                    const bool ok = row_ok && gj >= 0 && gj < n1;
                    veles_async::copy4(dst + r * cols + c,
                                       ok ? xr + gj : x, ok);
                }
            }
        }
        veles_async::commit();
    };
    long long t = blockIdx.x;
    stage(t, s_x);
    stage(t + gridDim.x, s_x + stage_len);

    for (int m = tid; m < k0 * k1_pad; m += F2D_THREADS) {
        const int p = m / k1_pad;
        const int q = m - p * k1_pad;
        float v = 0.f;
        if (q < k1)
            v = reverse ? k[(k0 - 1 - p) * k1 + (k1 - 1 - q)]
                        : k[p * k1 + q];
        s_k[m] = v;
    }

    const int rbase = ty * F2D_RY;
    const int cbase = tx * F2D_RX;
    for (int it = 0; t < tiles; t += gridDim.x, ++it) {
        const float* sx = s_x + (it & 1) * stage_len;
        veles_async::wait_pending<1>();
        __syncthreads();   // tile t staged (and the taps, at first)

        float acc[F2D_RY][F2D_RX];
#pragma unroll
        for (int ry = 0; ry < F2D_RY; ++ry)
#pragma unroll
            for (int c = 0; c < F2D_RX; ++c) acc[ry][c] = 0.f;
#pragma unroll 1
        for (int r = 0; r < F2D_RY + k0 - 1; ++r) {
            const float* row = sx + (rbase + r) * cols + cbase;
            float4 w0 = *reinterpret_cast<const float4*>(row);
#pragma unroll 1
            for (int q0 = 0; q0 < k1_pad; q0 += 4) {
                const float4 w1 =
                    *reinterpret_cast<const float4*>(row + q0 + 4);
                const float w[8] = {w0.x, w0.y, w0.z, w0.w,
                                    w1.x, w1.y, w1.z, w1.w};
#pragma unroll
                for (int ry = 0; ry < F2D_RY; ++ry) {
                    const int p = r - ry;
                    if (p >= 0 && p < k0) {
                        const float4 t4 = *reinterpret_cast<const float4*>(
                            s_k + p * k1_pad + q0);
                        const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
                        for (int qq = 0; qq < 4; ++qq)
#pragma unroll
                            for (int c = 0; c < F2D_RX; ++c)
                                acc[ry][c] = fmaf(tv[qq], w[qq + c],
                                                  acc[ry][c]);
                    }
                }
                w0 = w1;
            }
        }
        __syncthreads();   // every thread is done reading this stage
        stage(t + 2LL * gridDim.x, s_x + (it & 1) * stage_len);

        const long long img = t / tiles_img;
        const long long u = t - img * tiles_img;
        const long long ty_ = u / tiles_x;
        const long long i0 = ty_ * F2D_TY + rbase;
        const long long j0 = (u - ty_ * tiles_x) * F2D_TX + cbase;
        float* oi = out + img * n_out0 * n_out1;
#pragma unroll
        for (int ry = 0; ry < F2D_RY; ++ry) {
            const long long i = i0 + ry;
            if (i >= n_out0) break;
            float* orow = oi + i * n_out1;
#pragma unroll
            for (int c = 0; c < F2D_RX; ++c)
                if (j0 + c < n_out1) orow[j0 + c] = acc[ry][c];
        }
    }
    veles_async::wait_pending<0>();
}

}  // namespace

// blocks resident on one SM (the persistent grid is this times the SM
// count, at most one a tile), or -1 on a CUDA error
extern "C" int veles_f2d_resident(int k0, int k1)
{
    int per_sm = 0, sms = 0;
    const long long smem = smem_bytes(k0, k1);
    if (smem > SMEM_MAX
        || veles_async::resident_blocks(f2d_kernel, F2D_THREADS,
                                        (size_t)smem, &per_sm, &sms)
           != cudaSuccess)
        return -1;
    return per_sm;
}

extern "C" int veles_f2d_tile_x(void) { return F2D_TX; }
extern "C" int veles_f2d_tile_y(void) { return F2D_TY; }

extern "C" long long veles_f2d_smem_bytes(int k0, int k1)
{
    return smem_bytes(k0, k1);
}

// x [imgs, n0, n1], k [k0, k1], out [imgs, n_out0, n_out1]; all float32,
// contiguous, on the device; the kernel reads x zero-padded by (pad0,
// pad1) on each side and the taps flipped on both axes if `reverse`; the
// caller has checked that the padded input covers every output.
// Launches once on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue when the kernel's shared memory exceeds what a
// block may use).
extern "C" int veles_f2d_f32(const float* x, const float* k, float* out,
                             long long imgs, long long n0, long long n1,
                             int k0, int k1, long long n_out0,
                             long long n_out1, long long pad0,
                             long long pad1, int reverse, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    const long long smem = smem_bytes(k0, k1);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    const Geometry g = geometry(k0, k1);
    const long long tiles_x = (n_out1 + F2D_TX - 1) / F2D_TX;
    const long long tiles_img = tiles_x * ((n_out0 + F2D_TY - 1) / F2D_TY);
    const long long tiles = imgs * tiles_img;
    unsigned grid = 1;
    const cudaError_t err = veles_async::persistent_blocks(
        f2d_kernel, F2D_THREADS, (size_t)smem, tiles, &grid);
    if (err != cudaSuccess) return (int)err;
    const dim3 block(F2D_BX, F2D_BY);
    f2d_kernel<<<grid, block, (size_t)smem, st>>>(
        x, k, out, n0, n1, k0, k1, g.k1_pad, g.rows, g.cols, n_out0,
        n_out1, pad0, pad1, reverse, tiles_x, tiles_img, tiles);
    return (int)cudaGetLastError();
}
