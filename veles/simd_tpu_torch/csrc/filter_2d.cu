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
// and 256 x 1 included) and any number of leading images.  The direct
// route of convolve2d and cross_correlate2d pads and flips around it.
//
// Bound on the H100: bytes.  On the main path (16 images of 512 x 512,
// 7 x 7, full convolution: x_ext 524 x 524, out 518 x 518) the kernel
// reads 17.6 MB and writes 17.2 MB (10.4 us at 3.35 TB/s) for 2 x 49 x
// 16 x 518^2 = 421 MFLOP (6.3 us at 67 TFLOP/s).  The design reads each
// input sample from device memory about once (the halos of neighbouring
// tiles come from L2) and keeps the FFMA loop fed from shared memory
// and registers.
//
// Design.  One block of 32 x 8 threads owns a tile of F2D_TY x F2D_TX =
// 32 x 64 outputs of one image: it stages the tile's input, the tile
// plus its (k0 - 1, k1 - 1) halo, and the k0 x k1 taps in shared memory
// once.  Each thread keeps F2D_RY x F2D_RX = 4 x 2 outputs in registers:
// rows ty*4 .. ty*4+3, columns tx and tx + 32.  For each group of four
// kernel rows and each kernel column it loads the 7 x 2 input samples
// that group needs and does up to 32 FFMAs with them (register reuse
// down the kernel's rows); a warp is one row of threads, so its loads
// are unit-stride and conflict-free.  Taps run in the order: group of
// four kernel rows, kernel column, row within the group (the plain
// version in cuda_kernels.py follows the same order).  Shared memory
// grows with the kernel; the wrapper admits a kernel only when
// veles_f2d_smem_bytes fits the 227 KB a block may use, and every
// kernel of area <= 256 does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F2D_BX = 32;
constexpr int F2D_BY = 8;
constexpr int F2D_RX = 2;
constexpr int F2D_RY = 4;
constexpr int F2D_TX = F2D_BX * F2D_RX;
constexpr int F2D_TY = F2D_BY * F2D_RY;
constexpr int F2D_THREADS = F2D_BX * F2D_BY;
constexpr long long MAX_GRID_Z = 65535;
constexpr long long SMEM_MAX = 232448;   // 227 KB, opt-in above 48 KB

struct Geometry {
    int rows;   // staged input rows: the tile, its halo, the group pad
    int cols;   // staged input columns: the tile and its halo
};

Geometry geometry(int k0, int k1)
{
    Geometry g;
    const int k0_pad = (k0 + F2D_RY - 1) / F2D_RY * F2D_RY;
    g.rows = F2D_TY + k0_pad - 1;
    g.cols = F2D_TX + k1 - 1;
    return g;
}

long long smem_bytes(int k0, int k1)
{
    const Geometry g = geometry(k0, k1);
    return 4LL * ((long long)g.rows * g.cols + (long long)k0 * k1);
}

__global__ void __launch_bounds__(F2D_THREADS)
f2d_kernel(const float* __restrict__ x, const float* __restrict__ k,
           float* __restrict__ out, long long n0e, long long n1e, int k0,
           int k1, long long n_out0, long long n_out1, int rows, int cols,
           long long img0)
{
    extern __shared__ float smem[];
    float* s_k = smem;
    float* s_x = smem + k0 * k1;
    const long long img = img0 + blockIdx.z;
    const float* xi = x + img * n0e * n1e;
    const long long i0 = (long long)blockIdx.y * F2D_TY;
    const long long j0 = (long long)blockIdx.x * F2D_TX;
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const int tid = ty * F2D_BX + tx;

    for (int m = tid; m < k0 * k1; m += F2D_THREADS) s_k[m] = k[m];
    for (int r = ty; r < rows; r += F2D_BY) {
        const long long gi = i0 + r;
        const float* xrow = xi + gi * n1e;
        for (int c = tx; c < cols; c += F2D_BX) {
            const long long gj = j0 + c;
            s_x[r * cols + c] = (gi < n0e && gj < n1e) ? xrow[gj] : 0.f;
        }
    }
    __syncthreads();

    float acc[F2D_RY][F2D_RX];
#pragma unroll
    for (int r = 0; r < F2D_RY; ++r)
#pragma unroll
        for (int c = 0; c < F2D_RX; ++c) acc[r][c] = 0.f;
    const int rbase = ty * F2D_RY;
#pragma unroll 1
    for (int g = 0; g < k0; g += F2D_RY) {
#pragma unroll 1
        for (int q = 0; q < k1; ++q) {
            float xv[2 * F2D_RY - 1][F2D_RX];
            const float* p = s_x + (rbase + g) * cols + tx + q;
#pragma unroll
            for (int d = 0; d < 2 * F2D_RY - 1; ++d)
#pragma unroll
                for (int c = 0; c < F2D_RX; ++c)
                    xv[d][c] = p[d * cols + c * F2D_BX];
#pragma unroll
            for (int u = 0; u < F2D_RY; ++u) {
                if (g + u < k0) {
                    const float t = s_k[(g + u) * k1 + q];
#pragma unroll
                    for (int r = 0; r < F2D_RY; ++r)
#pragma unroll
                        for (int c = 0; c < F2D_RX; ++c)
                            acc[r][c] = fmaf(t, xv[r + u][c], acc[r][c]);
                }
            }
        }
    }

    float* oi = out + img * n_out0 * n_out1;
#pragma unroll
    for (int r = 0; r < F2D_RY; ++r) {
        const long long i = i0 + rbase + r;
#pragma unroll
        for (int c = 0; c < F2D_RX; ++c) {
            const long long j = j0 + tx + c * F2D_BX;
            if (i < n_out0 && j < n_out1) oi[i * n_out1 + j] = acc[r][c];
        }
    }
}

}  // namespace

extern "C" int veles_f2d_tile_x(void) { return F2D_TX; }
extern "C" int veles_f2d_tile_y(void) { return F2D_TY; }

extern "C" long long veles_f2d_smem_bytes(int k0, int k1)
{
    return smem_bytes(k0, k1);
}

// x_ext [imgs, n0e, n1e], k [k0, k1], out [imgs, n_out0, n_out1]; all
// float32, contiguous, on the device; the caller has checked that x_ext
// covers every output.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue when the kernel's shared
// memory exceeds what a block may use).
extern "C" int veles_f2d_f32(const float* x, const float* k, float* out,
                             long long imgs, long long n0e, long long n1e,
                             int k0, int k1, long long n_out0,
                             long long n_out1, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    const long long smem = smem_bytes(k0, k1);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            f2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const Geometry g = geometry(k0, k1);
    const unsigned tiles_x = (unsigned)((n_out1 + F2D_TX - 1) / F2D_TX);
    const long long tiles_y_ll = (n_out0 + F2D_TY - 1) / F2D_TY;
    if (tiles_y_ll > 65535) return (int)cudaErrorInvalidValue;
    const unsigned tiles_y = (unsigned)tiles_y_ll;
    const dim3 block(F2D_BX, F2D_BY);
    for (long long b0 = 0; b0 < imgs; b0 += MAX_GRID_Z) {
        const long long nb = imgs - b0 < MAX_GRID_Z ? imgs - b0 : MAX_GRID_Z;
        dim3 grid(tiles_x, tiles_y, (unsigned)nb);
        f2d_kernel<<<grid, block, (size_t)smem, st>>>(
            x, k, out, n0e, n1e, k0, k1, n_out0, n_out1, g.rows, g.cols,
            b0);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}
