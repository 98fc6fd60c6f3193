// Full linear convolution y = x * taps in float32: an FFT overlap-save,
// one launch for the taps' spectrum and one per 65535 rows.
//
// Replaces the fused overlap-save Pallas kernel of the JAX package
// (veles/simd_tpu/ops/pallas_kernels.py: overlap_save_pallas, _os_call,
// _os_kernel).  It computes the same function, full length n + k - 1,
// each batch row on its own with zero history:
//
//     y[b, t] = sum_j taps[j] * x[b, t - j],   x[b, s] = 0 off [0, n)
//
// Bound on the H100: the bytes.  At n = 2^20, k = 2047 the function
// moves 8.4 MB of signal in and out (2.5 us at 3.35 TB/s); an FFT
// overlap-save needs about 0.1 GFLOP, under that.  The direct form does
// 2*k*n = 4.29 GFLOP of fp32 FFMA (64 us at 67 TFLOP/s): no tuning of it
// comes within 25x of the bytes, hence an FFT per segment.
//
// Design.  The TPU kernel walks each row's output blocks in grid order
// and carries the k-1 sample halo in VMEM; Hopper runs blocks in
// parallel, so each block owns one segment of one row and reloads its
// halo.  The segment length N is the least power of two >= 4096 and
// >= 2k that also holds 8192 samples or, if shorter, the row's whole
// output n + k - 1 (fft_length below, mirrored by
// cuda_kernels.os_fft_length), so a segment gives step = N - k + 1
// outputs and a short row pays one short transform.
//
// 1. os_taps_kernel, one block: H = rFFT_N(taps) into the wrapper's
//    scratch [N/2 + 1] complex, scaled by 1/(2N) for the inverse below.
// 2. os_conv_kernel, grid (segments, rows): block (s, b) loads its
//    window x[b, s*step - (k-1) + t], t < N, masked to [0, n), packed
//    as N/2 complex values (z[m] = x[2m] + i x[2m+1]); transforms it
//    with the group FFT of smem_fft.cuh (the whole block is the group:
//    N/16 threads, at most 512, a radix-8 butterfly each); unpacks each
//    pair of bins (j, N/2 - j), multiplies them by H and packs them back
//    for the inverse, in place; transforms back; and writes the
//    segment's last `step` samples (the first k - 1 are wrapped)
//    coalesced.  It is launched as a programmatic dependent of the taps
//    kernel: its blocks load and transform their windows while the taps
//    kernel runs, and wait for H (griddepcontrol.wait) only before the
//    product.
//
// One shared-memory buffer of N/2 padded complex values: 139 KB at
// k = 16384 (N = 32768), the route's longest filter, so every k in
// 2..16384 fits; 35 KB at N = 8192.  Twiddles come from the wrapper's
// float64-built table of e^{-2 pi i t / N}, t < N.
//
// Accuracy: fp32 throughout, within 1e-5 of max|y| of the plain version
// (ops/cuda_kernels.py: overlap_save_plain, the direct sum), not
// bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_fft.cuh"

namespace {

using veles_fft::Plan;
using veles_fft::padded;
using veles_fft::pad;

constexpr int OS_MIN_FFT = 4096;    // the shortest segment
constexpr int OS_LONG_FFT = 8192;   // the shortest of a long row
constexpr int OS_MAX_FFT = 32768;
constexpr long long MAX_GRID_Y = 65535;

int fft_length(int k, long long n)
{
    const long long out_len = n + k - 1;
    const long long want = out_len < OS_LONG_FFT ? out_len : OS_LONG_FFT;
    int N = OS_MIN_FFT;
    while (N < 2 * k || N < want) N *= 2;
    return N;
}

long long smem_bytes(int N) { return 8LL * padded(N / 2); }

template <int G, int VPT>
__global__ void __launch_bounds__(G)
os_taps_kernel(const float* __restrict__ taps, int k,
               const float2* __restrict__ tw, float2* __restrict__ H,
               Plan plan, float scale)
{
    extern __shared__ __align__(16) float2 buf[];
    // let the segments' grid start now: it waits for H only after its
    // own forward transform
    asm volatile("griddepcontrol.launch_dependents;");
    const int M = plan.M;
    for (int m = threadIdx.x; m < M; m += G)
        buf[pad(m)] = make_float2(2 * m < k ? taps[2 * m] : 0.f,
                                  2 * m + 1 < k ? taps[2 * m + 1] : 0.f);
    __syncthreads();
    veles_fft::group_fft<G, VPT>(buf, threadIdx.x, plan, tw, 2, 1.f);
    for (int j = threadIdx.x; j <= M; j += G) {
        const float2 X = veles_fft::unpack_real(buf, M, j, __ldg(tw + j));
        H[j] = make_float2(X.x * scale, X.y * scale);
    }
}

template <int G, int VPT>
__global__ void __launch_bounds__(G)
os_conv_kernel(const float* __restrict__ x, const float2* __restrict__ H,
               const float2* __restrict__ tw, float* __restrict__ y,
               long long n, int k, long long out_len, int step, Plan plan)
{
    extern __shared__ __align__(16) float2 buf[];
    const int M = plan.M;
    const int tid = threadIdx.x;
    const float* xr = x + (long long)blockIdx.y * n;
    const long long t0 = (long long)blockIdx.x * step;
    const long long base = t0 - (k - 1);

    // the window x[base + t], t < 2M, zero off [0, n)
    const float* src = xr + base;
    if (base >= 0 && base + 2 * M <= n
            && (reinterpret_cast<uintptr_t>(src) & 7) == 0) {
        const float2* s2 = reinterpret_cast<const float2*>(src);
        for (int m = tid; m < M; m += G) buf[pad(m)] = __ldg(s2 + m);
    } else {
        for (int m = tid; m < M; m += G) {
            const long long t = base + 2 * m;
            buf[pad(m)] = make_float2(
                t >= 0 && t < n ? __ldg(xr + t) : 0.f,
                t + 1 >= 0 && t + 1 < n ? __ldg(xr + t + 1) : 0.f);
        }
    }
    __syncthreads();
    veles_fft::group_fft<G, VPT>(buf, tid, plan, tw, 2, 1.f);

    // H is written by the taps kernel launched just before this grid
    asm volatile("griddepcontrol.wait;" ::: "memory");
    // bins (j, M - j): unpack, multiply by H, pack for the inverse
    for (int j = tid; j <= M / 2; j += G) {
        if (j == 0) {
            const float2 z = buf[0];
            const float y0 = 2.f * (z.x + z.y) * __ldg(&H[0].x);
            const float ym = 2.f * (z.x - z.y) * __ldg(&H[M].x);
            buf[0] = make_float2(y0 + ym, y0 - ym);
            continue;
        }
        const int mj = M - j;
        const float2 a = buf[pad(j)], b = buf[pad(mj)];
        const float2 wj = __ldg(tw + j), wm = __ldg(tw + mj);
        const float2 yj = veles_fft::cmul(veles_fft::unpack_pair(a, b, wj),
                                          __ldg(H + j));
        const float2 ym = veles_fft::cmul(veles_fft::unpack_pair(b, a, wm),
                                          __ldg(H + mj));
        buf[pad(j)] = veles_fft::pack_real_inverse(yj, ym, wj);
        buf[pad(mj)] = veles_fft::pack_real_inverse(ym, yj, wm);
    }
    __syncthreads();
    veles_fft::group_fft<G, VPT>(buf, tid, plan, tw, 2, -1.f);

    // c[t] for t >= k - 1 is y[t0 + t - (k - 1)]
    float* yr = y + (long long)blockIdx.y * out_len;
    for (int u = tid; u < step; u += G) {
        const long long t = t0 + u;
        if (t >= out_len) break;
        const int c = u + k - 1;
        const float2 z = buf[pad(c >> 1)];
        yr[t] = (c & 1) ? z.y : z.x;
    }
}

template <int G, int VPT>
int launch(const float* x, const float* taps, float2* H, const float2* tw,
           float* y, long long rows, long long n, int k, int N,
           cudaStream_t stream)
{
    const Plan plan = veles_fft::make_plan(N / 2);
    const long long bytes = smem_bytes(N);
    cudaError_t err = cudaFuncSetAttribute(
        os_taps_kernel<G, VPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            os_conv_kernel<G, VPT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    os_taps_kernel<G, VPT><<<1, G, bytes, stream>>>(
        taps, k, tw, H, plan, 1.f / (4.f * (float)N));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long out_len = n + k - 1;
    const int step = N - k + 1;
    const unsigned segs = (unsigned)((out_len + step - 1) / step);
    // programmatic dependent launch: the segments' blocks load and
    // transform their windows while the taps kernel runs
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.blockDim = dim3(G);
    cfg.dynamicSmemBytes = (size_t)bytes;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    for (long long r0 = 0; r0 < rows; r0 += MAX_GRID_Y) {
        const long long nr = rows - r0 < MAX_GRID_Y ? rows - r0 : MAX_GRID_Y;
        cfg.gridDim = dim3(segs, (unsigned)nr);
        err = cudaLaunchKernelEx(&cfg, os_conv_kernel<G, VPT>, x + r0 * n,
                                 (const float2*)H, tw, y + r0 * out_len, n,
                                 k, out_len, step, plan);
        if (err == cudaSuccess) err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int veles_os_fft_length(int k, long long n)
{
    return fft_length(k, n);
}

extern "C" long long veles_os_smem_bytes(int N) { return smem_bytes(N); }

// The library's one error formatter, for every kernel's wrapper.
extern "C" const char* veles_cuda_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}

// x [rows, n], taps [k], H [N/2 + 1] complex scratch, tw [N] complex
// (e^{-2 pi i t / N}), y [rows, n + k - 1]; all on the device,
// contiguous, with N = veles_os_fft_length(k, n).  Launches the taps
// kernel and the segments on `stream` and returns the first CUDA error
// (cudaErrorInvalidValue for a k the kernel does not take, above 16384
// or below 2: the wrapper checks first).
extern "C" int veles_os_conv_f32(const float* x, const float* taps,
                                 float* H, const float* tw, float* y,
                                 long long rows, long long n, int k,
                                 void* stream)
{
    if (k < 2 || k > OS_MAX_FFT / 2) return (int)cudaErrorInvalidValue;
    const int N = fft_length(k, n);
    float2* H2 = reinterpret_cast<float2*>(H);
    const float2* tw2 = reinterpret_cast<const float2*>(tw);
    const cudaStream_t s = (cudaStream_t)stream;
    // a thread a radix-8 butterfly: M / 8 threads, at most 512
    switch (N) {
    case 4096:
        return launch<256, 8>(x, taps, H2, tw2, y, rows, n, k, N, s);
    case 8192:
        return launch<512, 8>(x, taps, H2, tw2, y, rows, n, k, N, s);
    case 16384:
        return launch<512, 16>(x, taps, H2, tw2, y, rows, n, k, N, s);
    case 32768:
        return launch<512, 32>(x, taps, H2, tw2, y, rows, n, k, N, s);
    }
    return (int)cudaErrorInvalidValue;
}
