// Multi-channel FIR filter bank in float32, one kernel launch.
//
// Replaces the shifted-MAC filter-bank Pallas kernel of the JAX package
// (veles/simd_tpu/ops/pallas_kernels.py: filter_bank_pallas, _fb_call,
// _fb_kernel, _phase_plan), with its whole contract:
//
//     out[c][b, i] = sum_j f[c, j] * x_ext[b, i*stride + j*dilation]
//
// for C channels, where x_ext is x zero-padded by pad_left samples on
// each side (pad_left = 0: x_ext is x itself) and the taps may be read
// reversed.  Direct convolution and correlation use C = 1, stride 1,
// dilation 1 and pad_left = k - 1; the DWT uses C = 2, stride 2; the SWT
// C = 2, dilation 2^(level-1).  The zero halo is read in the kernel, so
// no caller builds a padded copy.
//
// Bound on the H100: bytes.  On the direct-convolution path (512 rows x
// 16,384 samples, 129 taps, full output) the function reads 33.6 MB and
// writes 33.8 MB: 20.1 us at 3.35 TB/s.  Its 2.16 GFLOP of direct-form
// multiply-adds take 32 us at the 67 TFLOP/s fp32 FFMA peak by
// themselves, so no FFMA kernel reaches the bound; the tensor cores
// reach 495 TFLOP/s in TF32.
//
// Design, unit stride and dilation ("mma" variant, k >= MMA_MIN_K): a
// Toeplitz product on the tensor cores in split TF32, with wgmma.  For
// a tile of 2048 consecutive outputs write A[g, m] = x_ext[i0 + 32g + m]
// (64 rows g, m < 8 * steps) and B[m, r] = f[m - r] (0 <= m - r < k,
// else 0; r < 32), so Y[g, r] = sum_m A[g, m] B[m, r] = out[i0 + 32g +
// r]: steps = ceil((k + 31) / 8) k-steps of wgmma.m64n32k8, A from
// registers, B from shared memory.  B depends on m - r only, so every
// tile uses the same B, and n-block i of step s (8 columns) is n-block 0
// of step s - i: a block stores n-block 0 of each step once (hi and lo
// parts), in reverse step order, and step s's descriptor starts at its
// own block with the next n-blocks 256 bytes on.  Each sample is split
// once when it is staged, hi = tf32(x) and lo = tf32(x - hi), and each
// k-step runs three wgmmas (lo.hi, hi.lo, hi.hi) into fp32
// accumulators: fp32 accuracy less the lo.lo term (about 2^-22 of each
// product).  The A rows are 32 floats apart, so the span is stored
// XOR-swizzled (m ^ (((m >> 5) & 7) << 2)) and the eight row groups of a
// fragment load meet in distinct banks.  A persistent block of one
// warpgroup walks the tiles; each tile's span is staged by 4-byte
// cp.async into one of two raw buffers, zero-filled outside the row,
// while earlier tiles multiply, and each step's A fragment loads while
// the last step's wgmmas run.  Outputs go back through shared memory
// for coalesced stores.  (A first form on mma.sync.m16n8k8, the same product in
// 16 x 16 tiles, was slower than the FFMA loop at every k: PERF.md.)
//
// Design, strided or dilated, and short unit-stride filters ("ffma"):
// each block owns FB_TILE consecutive outputs of one row, stages the
// input span and the [C, order] taps in shared memory once, and keeps
// FB_R outputs a thread in registers.  For stride 1 and dilation 1 it
// loads 2*FB_R-1 span samples per group of FB_R taps and does FB_R^2
// FFMAs; otherwise one sample per output and tap.  The variant
// threshold MMA_MIN_K comes from chip_smoke.py's k-sweep (PERF.md).
// Shared memory grows with the span and the taps; the wrapper admits a
// shape only when veles_fb_smem_bytes fits the 227 KB a block may use.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int FB_THREADS = 128;
constexpr int FB_R = 13;
constexpr int FB_TILE = FB_THREADS * FB_R;
constexpr long long MAX_GRID_Y = 65535;
constexpr long long SMEM_MAX = 232448;   // 227 KB, opt-in above 48 KB

constexpr int MMA_THREADS = 128;                   // one warpgroup
constexpr int MMA_TILE = 64 * 32;                   // outputs a block tile
// unit-stride filters of at least this many taps take the mma variant:
// the least tap count of chip_smoke.py's k-sweep at which it ran ahead
// of the ffma loop at 512 x 16,384 on an H100 (PERF.md, 2026-10-17)
constexpr int MMA_MIN_K = 160;

enum Variant { AUTO = 0, FFMA = 1, MMA = 2 };

int pick(int order, int stride, int dilation, int variant)
{
    if (stride != 1 || dilation != 1) return variant == MMA ? -1 : FFMA;
    if (variant != AUTO) return variant;
    return order >= MMA_MIN_K ? MMA : FFMA;
}

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

int mma_steps(int order) { return (order + 31 + 7) / 8; }

// staged samples of one mma tile, a multiple of the swizzle's 32
int mma_span(int order)
{
    const int s = MMA_TILE - 32 + 8 * mma_steps(order);
    return (s + 31) / 32 * 32;
}

long long smem_bytes(int channels, int order, int stride, int dilation,
                     int variant)
{
    if (pick(order, stride, dilation, variant) == MMA)
        return 4LL * channels * 2 * (mma_steps(order) + 3) * 64
            + 4LL * 4 * mma_span(order) + 4LL * MMA_TILE;
    const Geometry g = geometry(order, stride, dilation);
    return 4LL * (g.span + (long long)channels * g.order_pad + FB_TILE);
}

__device__ __forceinline__ float tap(const float* f, int c, int order,
                                     int j, int reverse)
{
    if (j < 0 || j >= order) return 0.f;
    return f[c * order + (reverse ? order - 1 - j : j)];
}

// ---- ffma variant ----------------------------------------------------------

template <bool UNIT>
__global__ void __launch_bounds__(FB_THREADS)
fb_kernel(const float* __restrict__ x, const float* __restrict__ f,
          float* __restrict__ out, long long n, int channels,
          int order, int order_pad, int stride, int dilation,
          long long n_out, long long span, long long pad_left,
          int reverse, long long row0, long long rows)
{
    extern __shared__ float smem[];
    float* s_x = smem;
    float* s_f = s_x + span;
    float* s_o = s_f + channels * order_pad;
    const long long row = row0 + blockIdx.y;
    const float* xr = x + row * n;
    const long long i0 = (long long)blockIdx.x * FB_TILE;
    const long long src0 = i0 * stride - pad_left;
    const int tid = threadIdx.x;
    const int base = tid * FB_R;

    for (long long m = tid; m < span; m += FB_THREADS) {
        const long long s = src0 + m;
        s_x[m] = (s >= 0 && s < n) ? xr[s] : 0.f;
    }
    for (int m = tid; m < channels * order_pad; m += FB_THREADS) {
        const int c = m / order_pad;
        s_f[m] = tap(f, c, order, m - c * order_pad, reverse);
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
int launch_ffma(const float* x, const float* f, float* out, long long rows,
                long long n, int channels, int order, int stride,
                int dilation, long long n_out, long long pad_left,
                int reverse, cudaStream_t stream)
{
    const Geometry g = geometry(order, stride, dilation);
    const long long smem = smem_bytes(channels, order, stride, dilation,
                                      FFMA);
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
            x, f, out, n, channels, order, g.order_pad, stride, dilation,
            n_out, g.span, pad_left, reverse, r0, rows);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

// ---- mma variant -----------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float v)
{
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
    return r;
}

// the span's bank swizzle: A rows are 32 samples apart, so bits 5-7 flip
// bits 2-4, within 32 samples
__device__ __forceinline__ int swz(int m) { return m ^ (((m >> 5) & 7) << 2); }

// wgmma descriptor of a K-major B tile without swizzle: 8 x 16-byte core
// matrices, the two k halves 128 bytes apart (leading byte offset), the
// 8-row n blocks 256 bytes apart (stride byte offset)
__device__ __forceinline__ uint64_t b_desc(const float* p)
{
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16)
        | ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N groups are in flight; the accumulators are
// operands so that no read of them moves above the wait
template <int N>
__device__ __forceinline__ void wg_wait(float (&d)[16])
{
    asm volatile("wgmma.wait_group.sync.aligned %16;\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                 : "n"(N) : "memory");
}

// an A fragment stays live (its registers unreused) until here: the
// wgmma that reads it runs asynchronously
__device__ __forceinline__ void keep(const uint32_t (&a)[4])
{
    asm volatile("" :: "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]));
}

// d[64 x 32] += A[64 x 8] (registers) * B[8 x 32] (shared memory)
__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4],
                                      uint64_t b)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
        "{%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the hi and lo A fragments of k-step s: rows m0 (+ 8 rows), columns
// tig (+ 4), in the m16n8k8 register layout wgmma takes from each warp
__device__ __forceinline__ void load_a(const float* s_hi, const float* s_lo,
                                       int m0, int s, uint32_t (&ah)[4],
                                       uint32_t (&al)[4])
{
    const int u = swz(m0 + 8 * s);
    const int v = swz(m0 + 8 * s + 4);
    ah[0] = __float_as_uint(s_hi[u]);
    ah[1] = __float_as_uint(s_hi[u + 256]);
    ah[2] = __float_as_uint(s_hi[v]);
    ah[3] = __float_as_uint(s_hi[v + 256]);
    al[0] = __float_as_uint(s_lo[u]);
    al[1] = __float_as_uint(s_lo[u + 256]);
    al[2] = __float_as_uint(s_lo[v]);
    al[3] = __float_as_uint(s_lo[v + 256]);
}

// one k-step in three passes: lo.hi, hi.lo, hi.hi
__device__ __forceinline__ void step3(float (&d)[16], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint64_t bh,
                                      uint64_t bl)
{
    wg_fence();
    wgmma(d, al, bh);
    wgmma(d, ah, bl);
    wgmma(d, ah, bh);
    wg_commit();
}

__global__ void __launch_bounds__(MMA_THREADS)
fb_mma_kernel(const float* __restrict__ x, const float* __restrict__ f,
              float* __restrict__ out, long long rows, long long n,
              int channels, int order, int steps, int span,
              long long pad_left, int reverse, long long n_out,
              long long tiles_per_row)
{
    extern __shared__ float4 smem4[];
    float* s_b = reinterpret_cast<float*>(smem4);
    const int nb = steps + 3;                 // B blocks per (channel, part)
    float* s_raw = s_b + channels * 2 * nb * 64;   // two raw spans
    float* s_hi = s_raw + 2 * span;
    float* s_lo = s_hi + span;
    float* s_out = s_lo + span;                     // 512 a warp
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long tiles = rows * tiles_per_row;

    // tile t's span into dst: x_ext[row, i0 + m] for m < span, zeros
    // outside the row; one commit group per call, empty past the end
    auto stage = [&](long long t, float* dst) {
        if (t < tiles) {
            const long long row = t / tiles_per_row;
            const long long src0 =
                (t - row * tiles_per_row) * MMA_TILE - pad_left;
            const float* xr = x + row * n;
            for (int m = tid; m < span; m += MMA_THREADS) {
                const long long s = src0 + m;
                const bool ok = s >= 0 && s < n;
                veles_async::copy4(dst + m, ok ? xr + s : x, ok);
            }
        }
        veles_async::commit();
    };
    long long t = blockIdx.x;
    stage(t, s_raw);
    stage(t + gridDim.x, s_raw + span);

    // B blocks, once per block: block p of (channel, hi or lo) holds the
    // first n-tile of k-step q = steps - 1 - p, element (r, kk) at float
    // (kk / 4) * 32 + r * 4 + kk % 4, value f[8q + kk - r] (zero for q <
    // 0).  Step s's B, n-blocks i = 0..3, is the blocks of steps s - i,
    // which lie 256 bytes apart from block steps - 1 - s on.
    for (int e = tid; e < channels * nb * 64; e += MMA_THREADS) {
        const int c = e / (nb * 64);
        const int rem = e - c * nb * 64;
        const int w = rem & 63;
        const int kk = (w >> 5) * 4 + (w & 3);
        const int q = steps - 1 - (rem >> 6);
        const float v =
            q < 0 ? 0.f : tap(f, c, order, 8 * q + kk - ((w >> 2) & 7),
                              reverse);
        const float h = __uint_as_float(to_tf32(v));
        s_b[(2 * c) * nb * 64 + rem] = h;
        s_b[(2 * c + 1) * nb * 64 + rem] = __uint_as_float(to_tf32(v - h));
    }
    // the tensor cores read B through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

    const int gid = lane >> 2;
    const int tig = lane & 3;
    // row 16 warp + gid of the tile's 64: A[g, m] = x_ext[i0 + 32g + m]
    const int m0 = 32 * (16 * warp + gid) + tig;
    float* wo = s_out + warp * 512;
    for (int it = 0; t < tiles; t += gridDim.x, ++it) {
        float* raw = s_raw + (it & 1) * span;
        veles_async::wait_pending<1>();
        __syncthreads();   // tile t staged; the last tile's A reads done
        for (int m = tid; m < span; m += MMA_THREADS) {
            const float v = raw[m];
            const float h = __uint_as_float(to_tf32(v));
            const int p = swz(m);
            s_hi[p] = h;
            s_lo[p] = __uint_as_float(to_tf32(v - h));
        }
        __syncthreads();
        stage(t + 2LL * gridDim.x, raw);   // lands while later tiles run

        const long long row = t / tiles_per_row;
        // this warp's 16 rows of the tile: outputs i0 .. i0 + 511
        const long long i0 = (t - row * tiles_per_row) * MMA_TILE
            + 512LL * warp;
        const long long left = n_out - i0;
        for (int c = 0; c < channels; ++c) {
            // step s's descriptors: the start moves back one 256-byte
            // block (16 units of the >> 4 address field) a step
            const uint64_t dh = b_desc(s_b + (2 * c) * nb * 64
                                       + (steps - 1) * 64);
            const uint64_t dl = b_desc(s_b + (2 * c + 1) * nb * 64
                                       + (steps - 1) * 64);
            float d[16];
#pragma unroll
            for (int i = 0; i < 16; ++i) d[i] = 0.f;
            uint32_t ah0[4], al0[4], ah1[4] = {}, al1[4] = {};
            load_a(s_hi, s_lo, m0, 0, ah0, al0);
            // two steps an iteration, from register sets 0 and 1: the
            // next step's fragment loads while this step's group runs
#pragma unroll 1
            for (int s = 0; s < steps; s += 2) {
                const uint64_t back = 16ull * s;
                step3(d, ah0, al0, dh - back, dl - back);
                wg_wait<1>(d);        // step s - 1 done: set 1 is free
                keep(ah1);
                keep(al1);
                if (s + 1 < steps) {
                    load_a(s_hi, s_lo, m0, s + 1, ah1, al1);
                    step3(d, ah1, al1, dh - back - 16, dl - back - 16);
                    wg_wait<1>(d);    // step s done: set 0 is free
                    keep(ah0);
                    keep(al0);
                    if (s + 2 < steps)
                        load_a(s_hi, s_lo, m0, s + 2, ah0, al0);
                }
            }
            wg_wait<0>(d);
            keep(ah0);
            keep(al0);
            keep(ah1);
            keep(al1);
            // d[4j + h] is row gid (+ 8 for h >= 2), column 8j + 2tig
            // (+ 1 for odd h) of the warp's 16 rows; out through shared
            // memory, for coalesced stores
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int o = 32 * gid + 8 * j + 2 * tig;
                wo[o] = d[4 * j];
                wo[o + 1] = d[4 * j + 1];
                wo[o + 256] = d[4 * j + 2];
                wo[o + 257] = d[4 * j + 3];
            }
            __syncwarp();
            if (left > 0) {
                const int lim = left < 512 ? (int)left : 512;
                float* oc = out + ((long long)c * rows + row) * n_out + i0;
                for (int m = lane; m < lim; m += 32) oc[m] = wo[m];
            }
            __syncwarp();
        }
    }
    veles_async::wait_pending<0>();
}

int launch_mma(const float* x, const float* f, float* out, long long rows,
               long long n, int channels, int order, long long n_out,
               long long pad_left, int reverse, cudaStream_t stream)
{
    const long long smem = smem_bytes(channels, order, 1, 1, MMA);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    const long long per_row = (n_out + MMA_TILE - 1) / MMA_TILE;
    unsigned grid = 1;
    const cudaError_t err = veles_async::persistent_blocks(
        fb_mma_kernel, MMA_THREADS, (size_t)smem, rows * per_row, &grid);
    if (err != cudaSuccess) return (int)err;
    fb_mma_kernel<<<grid, MMA_THREADS, (size_t)smem, stream>>>(
        x, f, out, rows, n, channels, order, mma_steps(order),
        mma_span(order), pad_left, reverse, n_out, per_row);
    return (int)cudaGetLastError();
}

}  // namespace

// blocks of the mma variant resident on one SM (the persistent grid is
// this times the SM count, at most one a tile), or -1 on a CUDA error
extern "C" int veles_fb_mma_resident(int channels, int order)
{
    int per_sm = 0, sms = 0;
    const long long smem = smem_bytes(channels, order, 1, 1, MMA);
    if (smem > SMEM_MAX
        || veles_async::resident_blocks(fb_mma_kernel, MMA_THREADS,
                                        (size_t)smem, &per_sm, &sms)
           != cudaSuccess)
        return -1;
    return per_sm;
}

extern "C" int veles_fb_tile(void) { return FB_TILE; }
extern "C" int veles_fb_mma_tile(void) { return MMA_TILE; }
extern "C" int veles_fb_mma_min_k(void) { return MMA_MIN_K; }

// the variant veles_fb_f32 runs with variant 0: 1 ffma, 2 mma
extern "C" int veles_fb_variant(int order, int stride, int dilation)
{
    return pick(order, stride, dilation, AUTO);
}

extern "C" long long veles_fb_smem_bytes(int channels, int order,
                                         int stride, int dilation,
                                         int variant)
{
    return smem_bytes(channels, order, stride, dilation, variant);
}

// x [rows, n], f [channels, order], out [channels, rows, n_out]; all
// float32, contiguous, on the device; the kernel reads x zero-padded by
// pad_left samples on each side, and the taps reversed if `reverse`.
// `variant`: 0 picks by MMA_MIN_K, 1 forces ffma, 2 forces mma (unit
// stride and dilation only).  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue when the shape's shared
// memory exceeds what a block may use or the variant does not apply).
extern "C" int veles_fb_f32(const float* x, const float* f, float* out,
                            long long rows, long long n, int channels,
                            int order, int stride, int dilation,
                            long long n_out, long long pad_left,
                            int reverse, int variant, void* stream)
{
    cudaStream_t s = (cudaStream_t)stream;
    const int v = pick(order, stride, dilation, variant);
    if (v == MMA)
        return launch_mma(x, f, out, rows, n, channels, order, n_out,
                          pad_left, reverse, s);
    if (v != FFMA) return (int)cudaErrorInvalidValue;
    if (stride == 1 && dilation == 1)
        return launch_ffma<true>(x, f, out, rows, n, channels, order,
                                 stride, dilation, n_out, pad_left,
                                 reverse, s);
    return launch_ffma<false>(x, f, out, rows, n, channels, order, stride,
                              dilation, n_out, pad_left, reverse, s);
}
