// Multi-channel cascade bank in float32, one kernel launch.
//
// Replaces the cascade-bank Pallas kernel of the JAX package
// (veles/simd_tpu/ops/pallas_kernels.py: cascade_bank_pallas, _cb_call,
// _cb_kernel), with its whole contract: for each channel c with a plan
// of (phase p, offset o) slots and one tap per slot,
//
//     out[c][b, i] = sum_slot tap[slot] * x[b, (i + o) * n_split + p]
//
// i.e. arbitrary FIR channels at stride n_split, all computed from one
// pass over the input.  The fused multi-level DWT cascade uses it with
// n_split = 2^L and the composed per-level filters: one channel per
// output phase of each level's highpass, plus the final lowpass.  Two
// call forms share the kernel:
//
// * contract (periodic = 0): x is the caller's x_ext; samples past its
//   end read as zeros (the wrapper has checked that no slot needs one)
//   and channel c writes out[c, b, :];
// * periodic (periodic = 1): x is the unextended signal of n = n_out *
//   n_split samples and sample s reads x[b, s mod n], so no extended
//   copy is made; the channels are the cascade's, in the order of the
//   port's _cascade_plan (the 2^(L-l) output phases of level l for l =
//   1..L, then the lowpass), and each level is written in natural
//   order: channel (l, r) output i goes to hi_l[b, i * 2^(L-l) + r].
//   out holds hi_1 .. hi_L, lo_L one after the other, each [rows, n /
//   2^l], so the caller interleaves nothing.
//
// Bound on the H100: bytes.  On the main path (512 rows x 4096 samples,
// daub8, 3 levels: 8 channels, 176 slots) the function reads 4096 and
// writes 4096 floats per row, 16.8 MB in all (5.0 us at 3.35 TB/s),
// against 2 x 176 x 512 x 512 = 92 MFLOP (1.4 us at 67 TFLOP/s).
//
// Design.  The n_split phases of output index j are the contiguous
// samples of frame j, x[j * n_split .. (j + 1) * n_split), so nothing is
// deinterleaved.  NSP, the least of 4, 8, 16, 32 >= n_split, is the
// width of a frame in registers and the number of channels a pass
// computes.  A warp owns a tile of 32 R consecutive output indices of
// one row (R = min(4, 32 / NSP)), a lane R consecutive indices for the
// NSP channels of a pass.  The warp stages its tile's span, frames i0
// .. i0 + 32 R + max_off - 1 (with room for one more, which the last
// offset prefetches and does not use), with 16-byte cp.async where the
// rows are 16-byte aligned (4-byte copies elsewhere), wrapping
// (periodic) or zero-filling (contract) only the chunks past the row's
// end, i.e. in a row's last tiles; four floats of padding after every
// 32 keep a quarter-warp's 128-bit frame loads on distinct banks.  Each
// warp walks its tiles persistently through a two-stage cp.async ring.
// The plan becomes a dense tap table W[pass][o][c][NSP] (zero where a
// channel has no slot) and one word of bits a pass and offset (bit c:
// channel c has a slot there), which the block copies into shared
// memory once.  For each offset o the lane reads its window of R
// frames from a ring of R + 1 in registers (the offset loop unrolled
// R + 1 times, so every index is static) while the next frame, the
// next offset's bits and the next (channel, offset)'s taps load; for
// each channel whose bit is set it does R NSP FMAs on 128-bit broadcast
// tap loads: at daub8 L3, 224 multiply-adds an index (the plan has 176
// slots, a channel's unused phases at an offset are zeros), 2 frame
// loads an offset, 2 tap loads for 32 FMAs.  A zero tap still multiplies
// its sample, so a non-finite input sample can reach the outputs beside
// its support.  The contract form stores each channel's R outputs of a
// lane as one float4 / float2 run where aligned.  The periodic form
// writes the tile's coefficients in natural order into the span it has
// just read (a lane's R x 2^(L-l) coefficients of level l are one run)
// and then copies each level's run of the tile out whole, float4 by
// float4: written straight from the lanes, each 32-byte sector of a
// level went out in two halves.  The plan is runtime data (the table
// and the bits are tensors the wrapper caches per plan), so one build
// serves every plan of n_split <= 32 whose table and spans fit shared
// memory.
//
// What holds it back (tools/time_torch_cascade_bank.py, PERF.md): the
// memory alone takes more than the bytes bound, a warp holding one or
// two tiles at the main shape, and the compute is bound by latency;
// fewer warps an SM, or more outputs a lane with the registers that
// takes, ran slower.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int CB_WARPS = 4;
constexpr int CB_THREADS = 32 * CB_WARPS;
constexpr int CB_STAGES = 2;
constexpr int CB_MAX_SPLIT = 32;
// output indices a lane owns: CB_R, or 32 / NSP where that is fewer
constexpr int CB_R = 4;
// registers are capped so that 4 blocks (16 warps) fit one SM: the
// compute is bound by latency, and fewer warps ran slower
constexpr int CB_MIN_BLOCKS = 4;
constexpr long long SMEM_MAX = 232448;   // 227 KB, opt-in above 48 KB

// phases a frame holds in registers: the least of 4, 8, 16, 32 that is
// >= n_split (0 above 32)
int phase_pad(int n_split)
{
    if (n_split < 1 || n_split > CB_MAX_SPLIT) return 0;
    int p = 4;
    while (p < n_split) p *= 2;
    return p;
}

// output indices a lane owns at NSP phases a frame
__host__ __device__ constexpr int lane_frames(int nsp)
{
    return 32 / nsp < CB_R ? 32 / nsp : CB_R;
}

// output indices of a warp tile: 32 lanes of lane_frames
int tile_of(int n_split)
{
    const int nsp = phase_pad(n_split);
    return nsp ? 32 * lane_frames(nsp) : 0;
}

// floats of one staged span: (tile + max_off + 1) frames (the last one
// only prefetched) rounded up to 4, and 4 floats of padding after
// every 32
long long stage_floats(int n_split, int max_off)
{
    const long long s =
        ((long long)(tile_of(n_split) + max_off + 1) * n_split + 3) / 4 * 4;
    return s + 4 * ((s + 31) / 32);
}

// floats of the tap table and its channel bits in shared memory: NSP
// channels x NSP phases a pass and offset, then one 32-bit word a pass
// and offset, rounded up to 4
long long table_floats(int n_split, int max_off, int channels)
{
    const int nsp = phase_pad(n_split);
    const long long cells = (long long)((channels + nsp - 1) / nsp)
        * (max_off + 1);
    return cells * nsp * nsp + (cells + 3) / 4 * 4;
}

long long smem_bytes(int n_split, int max_off, int channels)
{
    if (!phase_pad(n_split) || max_off < 0 || channels < 1)
        return SMEM_MAX + 1;
    return 4LL * (table_floats(n_split, max_off, channels)
                  + CB_WARPS * CB_STAGES * stage_floats(n_split, max_off));
}

__device__ __forceinline__ int padded(int s) { return s + 4 * (s >> 5); }

// Stage the span of warp tile t: samples [s0, s0 + span) of its row,
// where sample g past the row's end reads g mod n_row (periodic) or 0.
__device__ __forceinline__ void stage_tile(
    float* dst, const float* __restrict__ x, long long t,
    int tiles_per_row, int tile, long long n_row, int n_split, int span,
    bool periodic, bool vec_copy, int lane)
{
    const long long row = t / tiles_per_row;
    const long long j = t - row * tiles_per_row;
    const float* xr = x + row * n_row;
    const long long s0 = j * tile * n_split;
    if (vec_copy) {
        const int chunks = (span + 3) >> 2;
        for (int k = lane; k < chunks; k += 32) {
            long long g = s0 + 4LL * k;
            bool ok = true;
            if (g >= n_row) {
                ok = periodic;
                g = periodic ? g % n_row : 0;
            }
            veles_async::copy16(dst + padded(4 * k), xr + g, ok);
        }
    } else {
        for (int k = lane; k < span; k += 32) {
            long long g = s0 + k;
            bool ok = true;
            if (g >= n_row) {
                ok = periodic;
                g = periodic ? g % n_row : 0;
            }
            veles_async::copy4(dst + padded(k), xr + g, ok);
        }
    }
}

// frame F of the staged span into f[0 .. NSP): 128-bit loads when the
// frame is NSP samples wide, else one load a phase (zeros past n_split)
template <int NSP>
__device__ __forceinline__ void load_frame(float (&f)[NSP],
                                           const float* buf, int F,
                                           int n_split, bool vec_frames)
{
    if (vec_frames) {
        const float4* p =
            reinterpret_cast<const float4*>(buf + padded(F * NSP));
#pragma unroll
        for (int q = 0; q < NSP / 4; ++q) {
            const float4 v = p[q];
            f[4 * q] = v.x;
            f[4 * q + 1] = v.y;
            f[4 * q + 2] = v.z;
            f[4 * q + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int p = 0; p < NSP; ++p)
            f[p] = p < n_split ? buf[padded(F * n_split + p)] : 0.f;
    }
}

// the first `valid` of v[0 .. K) to dst, as float4 or float2 runs where
// dst is aligned for them and the run is whole
template <int K>
__device__ __forceinline__ void store_run(float* dst, const float (&v)[K],
                                          int valid)
{
    if (valid <= 0) return;
    const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
    if (valid == K) {
        if constexpr (K % 4 == 0) {
            if (a % 16 == 0) {
#pragma unroll
                for (int q = 0; q < K / 4; ++q)
                    reinterpret_cast<float4*>(dst)[q] = make_float4(
                        v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
                return;
            }
        }
        if constexpr (K % 2 == 0) {
            if (a % 8 == 0) {
#pragma unroll
                for (int q = 0; q < K / 2; ++q)
                    reinterpret_cast<float2*>(dst)[q] =
                        make_float2(v[2 * q], v[2 * q + 1]);
                return;
            }
        }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
        if (k < valid) dst[k] = v[k];
}

__host__ __device__ constexpr int log2_of(int v)
{
    return v <= 1 ? 0 : 1 + log2_of(v / 2);
}

// The periodic form stages a tile's coefficients in natural order in
// the span it has just read, then writes each level's run whole.  Level
// l's 2^(L-l) phase channels start at C0 = NSP - NSP / 2^(l-1) (the
// lowpass, channel NSP - 1, after level L); its run holds the tile's
// indices times those phases and starts TILE * C0 floats into the span,
// and its block of out rows * n_out * C0 floats in.
template <int NSP, int R, int LVL>
__device__ __forceinline__ void stage_levels(float* buf,
                                             const float (&acc)[NSP][R],
                                             int lane)
{
    constexpr int L = log2_of(NSP);
    constexpr int S = LVL <= L ? NSP >> LVL : 1;
    constexpr int C0 = LVL <= L ? NSP - (NSP >> (LVL - 1)) : NSP - 1;
    constexpr int K = R * S;
    float v[K];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int ph = 0; ph < S; ++ph) v[r * S + ph] = acc[C0 + ph][r];
    const int base = 32 * R * C0 + lane * K;
    if constexpr (K % 4 == 0) {
#pragma unroll
        for (int q = 0; q < K / 4; ++q)
            *reinterpret_cast<float4*>(buf + padded(base + 4 * q)) =
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                            v[4 * q + 3]);
    } else {
#pragma unroll
        for (int k = 0; k < K; ++k) buf[padded(base + k)] = v[k];
    }
    if constexpr (LVL <= L) stage_levels<NSP, R, LVL + 1>(buf, acc, lane);
}

// Each level's run of the tile (first index t0, n_valid indices) from
// the span to out: float4 where the destination is 16-byte aligned and
// the run a multiple of 4 floats, else one float a lane.
template <int NSP, int R>
__device__ __forceinline__ void copy_levels(
    const float* buf, float* __restrict__ out, long long rows,
    long long row, long long n_out, long long t0, int n_valid, int lane)
{
    constexpr int L = log2_of(NSP);
    if (n_valid <= 0) return;
#pragma unroll
    for (int lvl = 1; lvl <= L + 1; ++lvl) {
        const int S = lvl <= L ? NSP >> lvl : 1;
        const int C0 = lvl <= L ? NSP - (NSP >> (lvl - 1)) : NSP - 1;
        const float* src = buf + padded(32 * R * C0);
        float* dst = out + rows * n_out * C0 + (row * n_out + t0) * S;
        const int count = n_valid * S;
        if (reinterpret_cast<uintptr_t>(dst) % 16 == 0 && count % 4 == 0) {
            for (int k = lane; k < count / 4; k += 32)
                reinterpret_cast<float4*>(dst)[k] =
                    *reinterpret_cast<const float4*>(src + 4 * k
                                                     + 4 * (k >> 3));
        } else {
            for (int k = lane; k < count; k += 32)
                dst[k] = src[k + 4 * (k >> 5)];
        }
    }
}

template <int NSP>
__global__ void __launch_bounds__(CB_THREADS, CB_MIN_BLOCKS)
cb_frames(const float* __restrict__ x, const float4* __restrict__ w,
          const uint32_t* __restrict__ bits, float* __restrict__ out,
          long long rows, long long n_row, int n_split, int channels,
          int max_off, long long n_out, int table_len, int stage_len,
          int periodic, int vec_copy)
{
    constexpr int R = lane_frames(NSP);  // outputs a lane
    constexpr int C = NSP;               // channels a pass
    constexpr int G = NSP / 4;           // 4-phase groups of a frame
    constexpr int TILE = 32 * R;
    extern __shared__ float4 smem4[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int passes = (channels + C - 1) / C;
    const int offs = max_off + 1;
    const int cells = passes * offs;
    // the tap table [pass][offset][channel][phase], then the bits
    // [pass][offset] (bit c: channel c has a slot there), staged once
    float4* const s_w = smem4;
    uint32_t* const s_bits =
        reinterpret_cast<uint32_t*>(smem4 + cells * C * G);
    for (int i = threadIdx.x; i < cells * C * G; i += CB_THREADS)
        s_w[i] = w[i];
    for (int i = threadIdx.x; i < cells; i += CB_THREADS)
        s_bits[i] = bits[i];
    __syncthreads();
    float* const mine = reinterpret_cast<float*>(smem4) + table_len
        + (long long)warp * CB_STAGES * stage_len;
    const int tiles_per_row = (int)((n_out + TILE - 1) / TILE);
    const long long tiles = rows * tiles_per_row;
    const long long step = (long long)gridDim.x * CB_WARPS;
    const int span = (TILE + max_off) * n_split;
    const bool vec_frames = n_split == NSP;

    // a ring of CB_STAGES spans: tile k + CB_STAGES - 1 loads while
    // tile k computes
    long long t = (long long)blockIdx.x * CB_WARPS + warp;
#pragma unroll
    for (int q = 0; q + 1 < CB_STAGES; ++q) {
        if (t + q * step < tiles)
            stage_tile(mine + q * stage_len, x, t + q * step, tiles_per_row,
                       TILE, n_row, n_split, span, periodic, vec_copy, lane);
        veles_async::commit();
    }
    for (int k = 0; t < tiles; ++k, t += step) {
        const long long ahead = t + (CB_STAGES - 1) * step;
        if (ahead < tiles)
            stage_tile(mine + (k + CB_STAGES - 1) % CB_STAGES * stage_len,
                       x, ahead, tiles_per_row, TILE, n_row, n_split, span,
                       periodic, vec_copy, lane);
        veles_async::commit();
        veles_async::wait_pending<CB_STAGES - 1>();
        __syncwarp();
        float* const buf = mine + k % CB_STAGES * stage_len;
        const long long row = t / tiles_per_row;
        const long long i0 = (t - row * tiles_per_row) * TILE + lane * R;
        const int valid = n_out - i0 < R ? (int)(n_out - i0) : R;
        const int F0 = lane * R;
        for (int pass = 0; pass < passes; ++pass) {
            const float4* wp = s_w + pass * offs * C * G;
            const uint32_t* bp = s_bits + pass * offs;
            float acc[C][R];
#pragma unroll
            for (int c = 0; c < C; ++c)
#pragma unroll
                for (int r = 0; r < R; ++r) acc[c][r] = 0.f;
            // a ring of R + 1 frames: frame F0 + j sits in slot
            // j % (R + 1), so offset o reads the window F0 + o .. F0 + o
            // + R - 1 while frame F0 + o + R loads into the free slot;
            // the offset loop is unrolled by R + 1 so that every slot
            // index is static.  The next offset's bits and the next
            // (channel, offset)'s taps load while this one computes (the
            // table's order puts (0, o + 1) right after (C - 1, o);
            // whatever lies past its end is read and not used)
            float f[R + 1][NSP];
#pragma unroll
            for (int q = 0; q < R; ++q)
                load_frame<NSP>(f[q], buf, F0 + q, n_split, vec_frames);
            uint32_t m = bp[0];
            float4 tn[G];
#pragma unroll
            for (int g = 0; g < G; ++g) tn[g] = wp[g];
#pragma unroll 1
            for (int o0 = 0; o0 < offs; o0 += R + 1) {
#pragma unroll
                for (int u = 0; u <= R; ++u) {
                    const int o = o0 + u;
                    if (o >= offs) break;
                    load_frame<NSP>(f[(u + R) % (R + 1)], buf, F0 + o + R,
                                    n_split, vec_frames);
                    const uint32_t mn = bp[o + 1];
                    const float4* wo = wp + o * C * G;
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        float4 tp[G];
#pragma unroll
                        for (int g = 0; g < G; ++g) {
                            tp[g] = tn[g];
                            tn[g] = wo[(c + 1) * G + g];
                        }
                        if ((m >> c) & 1u) {
#pragma unroll
                            for (int r = 0; r < R; ++r) {
                                const float* fr = f[(u + r) % (R + 1)];
                                float a = acc[c][r];
#pragma unroll
                                for (int g = 0; g < G; ++g) {
                                    a = fmaf(tp[g].x, fr[4 * g], a);
                                    a = fmaf(tp[g].y, fr[4 * g + 1], a);
                                    a = fmaf(tp[g].z, fr[4 * g + 2], a);
                                    a = fmaf(tp[g].w, fr[4 * g + 3], a);
                                }
                                acc[c][r] = a;
                            }
                        }
                    }
                    m = mn;
                }
            }
            if (periodic) {
                __syncwarp();
                stage_levels<NSP, R, 1>(buf, acc, lane);
                __syncwarp();
                const long long t0 = i0 - lane * R;
                copy_levels<NSP, R>(buf, out, rows, row, n_out, t0,
                                    n_out - t0 < TILE ? (int)(n_out - t0)
                                                      : TILE,
                                    lane);
            } else {
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const int cg = pass * C + c;
                    if (cg < channels)
                        store_run<R>(out + ((long long)cg * rows + row)
                                     * n_out + i0, acc[c], valid);
                }
            }
        }
        __syncwarp();
    }
    veles_async::wait_pending<0>();
}

template <int NSP>
int launch(const float* x, const float* w, const uint32_t* bits,
           float* out, long long rows, long long n_row, int n_split,
           int channels, int max_off, long long n_out, int periodic,
           cudaStream_t st)
{
    const long long smem = smem_bytes(n_split, max_off, channels);
    const int tile = tile_of(n_split);
    const long long tiles = rows * ((n_out + tile - 1) / tile);
    unsigned blocks = 1;
    const cudaError_t err = veles_async::persistent_blocks(
        cb_frames<NSP>, CB_THREADS, (size_t)smem,
        (tiles + CB_WARPS - 1) / CB_WARPS, &blocks);
    if (err != cudaSuccess) return (int)err;
    const bool vec_copy = reinterpret_cast<uintptr_t>(x) % 16 == 0
        && n_row % 4 == 0;
    cb_frames<NSP><<<blocks, CB_THREADS, (size_t)smem, st>>>(
        x, reinterpret_cast<const float4*>(w), bits, out, rows, n_row,
        n_split, channels, max_off, n_out,
        (int)table_floats(n_split, max_off, channels),
        (int)stage_floats(n_split, max_off), periodic, (int)vec_copy);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int veles_cb_phase_pad(int n_split) { return phase_pad(n_split); }

extern "C" int veles_cb_tile(int n_split) { return tile_of(n_split); }

extern "C" long long veles_cb_smem_bytes(int n_split, int max_off,
                                         int channels)
{
    return smem_bytes(n_split, max_off, channels);
}

// x [rows, n_row]; w float32 [passes, max_off + 1, NSP, NSP] (pass,
// offset, channel of the pass, phase; NSP = veles_cb_phase_pad) and
// bits uint32 [passes, max_off + 1, ceil(NSP * NSP / 4 / 32)] (bit c *
// NSP / 4 + g set where channel c has a slot in phases 4g .. 4g + 3 at
// that offset); contract: out [channels, rows, n_out]; periodic: out
// [rows * n_out * n_split] holding hi_1 .. hi_L, lo_L.  All contiguous,
// on the device; rows >= 1, n_out >= 1.  The caller has checked the
// plan and, for the contract form, that x covers every slot.  One
// launch on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take (n_split
// outside 1..32, shared memory beyond a block's, a periodic call that
// is not 2^L channels at n_split = 2^L, L = 2..4, over n_out * n_split
// samples a row).
extern "C" int veles_cb_f32(const float* x, const float* w,
                            const unsigned* bits, float* out,
                            long long rows, long long n_row, int n_split,
                            int channels, int max_off, long long n_out,
                            int periodic, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    if (smem_bytes(n_split, max_off, channels) > SMEM_MAX || rows < 1
        || n_out < 1)
        return (int)cudaErrorInvalidValue;
    if (periodic && (channels != n_split || n_row != n_out * n_split
                     || (n_split != 4 && n_split != 8 && n_split != 16)))
        return (int)cudaErrorInvalidValue;
    const uint32_t* b = reinterpret_cast<const uint32_t*>(bits);
    switch (phase_pad(n_split)) {
    case 4:
        return launch<4>(x, w, b, out, rows, n_row, n_split, channels,
                         max_off, n_out, periodic, st);
    case 8:
        return launch<8>(x, w, b, out, rows, n_row, n_split, channels,
                         max_off, n_out, periodic, st);
    case 16:
        return launch<16>(x, w, b, out, rows, n_row, n_split, channels,
                          max_off, n_out, periodic, st);
    default:
        return launch<32>(x, w, b, out, rows, n_row, n_split, channels,
                          max_off, n_out, periodic, st);
    }
}
