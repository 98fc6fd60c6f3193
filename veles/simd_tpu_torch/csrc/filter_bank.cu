// Multi-channel FIR filter bank in float32, one kernel launch.
//
// Replaces the shifted-MAC filter-bank Pallas kernel of the JAX package
// (veles/simd_tpu/ops/pallas_kernels.py: filter_bank_pallas, _fb_call,
// _fb_kernel, _phase_plan), with its whole contract:
//
//     out[c][b, i] = sum_j f[c, j] * x_ext[b, i*stride + j*dilation]
//
// for C channels.  Direct convolution and correlation use C = 1, stride
// 1, dilation 1; the DWT uses C = 2, stride 2; the SWT C = 2, dilation
// 2^(level-1).
//
// Bound on the H100: near the balance point.  On the direct-convolution
// path (512 rows x 16,384 samples, 129 taps) the work is 2.18 GFLOP
// (33 us at 67 TFLOP/s fp32) against 67 MB in and out (20 us at
// 3.35 TB/s).  The design reads each input sample from device memory
// about once and keeps the FFMA loop fed from shared memory.
//
// Design.  Mosaic cannot slice with a stride, so the TPU kernel takes
// the stride-s input as s deinterleaved phase arrays built outside the
// kernel; a GPU loads strided addresses directly, so the phase split
// goes away and the kernel reads x_ext as it is.  Each block owns
// FB_TILE consecutive outputs of one row: it stages the input span those
// outputs need and the [C, order] taps in shared memory once, then
// writes all C channels from the one staged span.  Each thread keeps
// FB_R consecutive outputs in registers.  For stride 1 and dilation 1
// it loads 2*FB_R-1 span samples per group of FB_R taps and does FB_R^2
// FFMAs (register reuse across taps); otherwise it loads one sample per
// output and tap.  FB_R is odd, so the lanes' unit-stride reads hit 32
// distinct banks.  Outputs go back through shared memory for coalesced
// stores.  Shared memory grows with the span and the taps; the wrapper
// admits a shape only when veles_fb_smem_bytes fits the 227 KB a block
// may use.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FB_THREADS = 128;
constexpr int FB_R = 13;
constexpr int FB_TILE = FB_THREADS * FB_R;
constexpr long long MAX_GRID_Y = 65535;
constexpr long long SMEM_MAX = 232448;   // 227 KB, opt-in above 48 KB

struct Geometry {
    int order_pad;    // taps per channel in shared memory
    long long span;   // input samples a tile reads
};

Geometry geometry(int order, int stride, int dilation)
{
    Geometry g;
    if (stride == 1 && dilation == 1) {
        g.order_pad = (order + FB_R - 1) / FB_R * FB_R;
        g.span = FB_TILE + g.order_pad - 1;
    } else {
        g.order_pad = order;
        g.span = (long long)(FB_TILE - 1) * stride
            + (long long)(order - 1) * dilation + 1;
    }
    return g;
}

long long smem_bytes(int channels, int order, int stride, int dilation)
{
    const Geometry g = geometry(order, stride, dilation);
    return 4LL * (g.span + (long long)channels * g.order_pad + FB_TILE);
}

template <bool UNIT>
__global__ void __launch_bounds__(FB_THREADS)
fb_kernel(const float* __restrict__ x, const float* __restrict__ f,
          float* __restrict__ out, long long n_ext, int channels,
          int order, int order_pad, int stride, int dilation,
          long long n_out, long long span, long long row0,
          long long rows)
{
    extern __shared__ float smem[];
    float* s_x = smem;
    float* s_f = s_x + span;
    float* s_o = s_f + channels * order_pad;
    const long long row = row0 + blockIdx.y;
    const float* xr = x + row * n_ext;
    const long long i0 = (long long)blockIdx.x * FB_TILE;
    const long long src0 = i0 * stride;
    const int tid = threadIdx.x;
    const int base = tid * FB_R;

    for (long long m = tid; m < span; m += FB_THREADS) {
        const long long s = src0 + m;
        s_x[m] = s < n_ext ? xr[s] : 0.f;
    }
    for (int m = tid; m < channels * order_pad; m += FB_THREADS) {
        const int c = m / order_pad;
        const int j = m - c * order_pad;
        s_f[m] = j < order ? f[c * order + j] : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < channels; ++c) {
        const float* fc = s_f + c * order_pad;
        float acc[FB_R];
#pragma unroll
        for (int r = 0; r < FB_R; ++r) acc[r] = 0.f;
        if (UNIT) {
            // tap g + u, output base + r reads s_x[base + g + r + u]
#pragma unroll 1
            for (int g = 0; g < order_pad; g += FB_R) {
                const float* p = s_x + base + g;
                float xv[2 * FB_R - 1];
#pragma unroll
                for (int d = 0; d < 2 * FB_R - 1; ++d) xv[d] = p[d];
#pragma unroll
                for (int u = 0; u < FB_R; ++u) {
                    const float t = fc[g + u];
#pragma unroll
                    for (int r = 0; r < FB_R; ++r)
                        acc[r] = fmaf(t, xv[r + u], acc[r]);
                }
            }
        } else {
#pragma unroll 1
            for (int j = 0; j < order; ++j) {
                const float t = fc[j];
                const float* p = s_x + (long long)j * dilation
                    + (long long)base * stride;
#pragma unroll
                for (int r = 0; r < FB_R; ++r)
                    acc[r] = fmaf(t, p[(long long)r * stride], acc[r]);
            }
        }
        __syncthreads();   // the previous channel's stores are done
#pragma unroll
        for (int r = 0; r < FB_R; ++r) s_o[base + r] = acc[r];
        __syncthreads();
        float* oc = out + ((long long)c * rows + row) * n_out;
        for (int m = tid; m < FB_TILE; m += FB_THREADS) {
            const long long i = i0 + m;
            if (i < n_out) oc[i] = s_o[m];
        }
    }
}

template <bool UNIT>
int launch(const float* x, const float* f, float* out, long long rows,
           long long n_ext, int channels, int order, int stride,
           int dilation, long long n_out, cudaStream_t stream)
{
    const Geometry g = geometry(order, stride, dilation);
    const long long smem = smem_bytes(channels, order, stride, dilation);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            fb_kernel<UNIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const unsigned tiles = (unsigned)((n_out + FB_TILE - 1) / FB_TILE);
    for (long long r0 = 0; r0 < rows; r0 += MAX_GRID_Y) {
        const long long nr =
            rows - r0 < MAX_GRID_Y ? rows - r0 : MAX_GRID_Y;
        dim3 grid(tiles, (unsigned)nr);
        fb_kernel<UNIT><<<grid, FB_THREADS, (size_t)smem, stream>>>(
            x, f, out, n_ext, channels, order, g.order_pad, stride,
            dilation, n_out, g.span, r0, rows);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int veles_fb_tile(void) { return FB_TILE; }

extern "C" long long veles_fb_smem_bytes(int channels, int order,
                                         int stride, int dilation)
{
    return smem_bytes(channels, order, stride, dilation);
}

// x_ext [rows, n_ext], f [channels, order], out [channels, rows, n_out];
// all float32, contiguous, on the device.  Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue when the shape's
// shared memory exceeds what a block may use).
extern "C" int veles_fb_f32(const float* x, const float* f, float* out,
                            long long rows, long long n_ext,
                            int channels, int order, int stride,
                            int dilation, long long n_out, void* stream)
{
    cudaStream_t s = (cudaStream_t)stream;
    if (stride == 1 && dilation == 1)
        return launch<true>(x, f, out, rows, n_ext, channels, order,
                            stride, dilation, n_out, s);
    return launch<false>(x, f, out, rows, n_ext, channels, order,
                         stride, dilation, n_out, s);
}
