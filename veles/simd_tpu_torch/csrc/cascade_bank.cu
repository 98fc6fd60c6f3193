// Multi-channel cascade bank in float32, one kernel launch.
//
// Replaces the cascade-bank Pallas kernel of the JAX package
// (veles/simd_tpu/ops/pallas_kernels.py: cascade_bank_pallas, _cb_call,
// _cb_kernel), with its whole contract: for each channel c with a plan
// of (phase p, offset o) slots and one tap per slot,
//
//     out[c][b, i] = sum_slot tap[slot] * x_ext[b, (i + o) * n_split + p]
//
// i.e. arbitrary FIR channels at stride n_split, all computed from one
// pass over the input.  The fused multi-level DWT cascade uses it with
// n_split = 2^L and the composed per-level filters: one channel per
// output phase of each level's highpass, plus the final lowpass.
//
// Bound on the H100: bytes.  On the main path (512 rows x 4096 samples,
// daub8, 3 levels: 8 channels, 176 slots) the kernel reads 4153 and
// writes 4096 floats per row, 16.9 MB in all (5.0 us at 3.35 TB/s),
// against 2 x 176 x 512 x 512 = 92 MFLOP (1.4 us at 67 TFLOP/s).  The
// design reads each input sample from device memory once for the whole
// cascade, where a level loop reads and writes every level's lowpass.
//
// Design.  Mosaic cannot slice with a stride, so the TPU kernel takes
// n_split phase arrays deinterleaved outside the kernel; here each block
// owns CB_TILE consecutive outputs of one row, reads the input span they
// need, [i0 * n_split, (i0 + CB_TILE + max_off) * n_split), once and
// coalesced, and deinterleaves it into shared memory itself: phase p
// lands in row p of a [n_split, pitch] array.  The pitch is chosen so
// that the deinterleaving stores of one warp hit 32 distinct banks when
// n_split divides 32.  Every channel then reads the staged span: a slot
// is one broadcast (tap, phase * pitch + offset) pair and CB_R
// unit-stride, conflict-free loads, each feeding one FFMA.  The plan is
// runtime data (per-slot tap, phase and offset, a per-channel start
// index), so one build serves every plan; the wrapper keeps each plan's
// device copy.  Each thread owns CB_R outputs CB_THREADS apart, so the
// stores are coalesced too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CB_THREADS = 128;
constexpr int CB_R = 4;
constexpr int CB_TILE = CB_THREADS * CB_R;
constexpr long long MAX_GRID_Y = 65535;
constexpr long long SMEM_MAX = 232448;   // 227 KB, opt-in above 48 KB

struct Slot {
    float tap;
    int delta;   // phase * pitch + offset
};

// Row pitch of the staged phases: at least CB_TILE + max_off, and
// congruent to 32 / n_split mod 32 when n_split divides 32, so that a
// warp's 32 consecutive samples land on 32 distinct banks.
int pitch_of(int n_split, int max_off)
{
    const int len = CB_TILE + max_off;
    if (n_split > 32 || 32 % n_split != 0) return len;
    const int want = (32 / n_split) % 32;
    return len + ((want - len % 32) % 32 + 32) % 32;
}

long long smem_bytes(int n_split, int max_off, int n_slots, int channels)
{
    return 8LL * n_slots + 4LL * (channels + 1)
        + 4LL * n_split * pitch_of(n_split, max_off);
}

__global__ void __launch_bounds__(CB_THREADS)
cb_kernel(const float* __restrict__ x, const float* __restrict__ taps,
          const int* __restrict__ meta, float* __restrict__ out,
          long long n_ext, int n_split, int channels, int n_slots,
          int pitch, int max_off, long long n_out, long long row0,
          long long rows)
{
    extern __shared__ float smem[];
    Slot* s_slot = reinterpret_cast<Slot*>(smem);
    int* s_start = reinterpret_cast<int*>(s_slot + n_slots);
    float* s_x = reinterpret_cast<float*>(s_start + channels + 1);
    const long long row = row0 + blockIdx.y;
    const float* xr = x + row * n_ext;
    const long long i0 = (long long)blockIdx.x * CB_TILE;
    const long long src0 = i0 * n_split;
    const int tid = threadIdx.x;

    // meta = [channel starts (channels + 1) | phases (n_slots) |
    //         offsets (n_slots)]
    for (int s = tid; s < n_slots; s += CB_THREADS) {
        Slot sl;
        sl.tap = taps[s];
        sl.delta = meta[channels + 1 + s] * pitch
            + meta[channels + 1 + n_slots + s];
        s_slot[s] = sl;
    }
    for (int c = tid; c <= channels; c += CB_THREADS) s_start[c] = meta[c];
    const int span = (CB_TILE + max_off) * n_split;
    for (int m = tid; m < span; m += CB_THREADS) {
        const long long s = src0 + m;
        s_x[(m % n_split) * pitch + m / n_split] = s < n_ext ? xr[s] : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < channels; ++c) {
        float acc[CB_R];
#pragma unroll
        for (int r = 0; r < CB_R; ++r) acc[r] = 0.f;
        const int end = s_start[c + 1];
#pragma unroll 1
        for (int s = s_start[c]; s < end; ++s) {
            const Slot sl = s_slot[s];
            const float* p = s_x + sl.delta + tid;
#pragma unroll
            for (int r = 0; r < CB_R; ++r)
                acc[r] = fmaf(sl.tap, p[r * CB_THREADS], acc[r]);
        }
        float* oc = out + ((long long)c * rows + row) * n_out;
#pragma unroll
        for (int r = 0; r < CB_R; ++r) {
            const long long i = i0 + tid + r * CB_THREADS;
            if (i < n_out) oc[i] = acc[r];
        }
    }
}

}  // namespace

extern "C" int veles_cb_tile(void) { return CB_TILE; }

extern "C" long long veles_cb_smem_bytes(int n_split, int max_off,
                                         int n_slots, int channels)
{
    return smem_bytes(n_split, max_off, n_slots, channels);
}

// x_ext [rows, n_ext]; taps [n_slots]; meta int32 [channels + 1 +
// 2 * n_slots] (channel starts, then each slot's phase, then its
// offset); out [channels, rows, n_out]; all contiguous, on the device.
// The caller has checked the plan and that x_ext covers every output.
// Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue when the shared memory exceeds what a block
// may use).
extern "C" int veles_cb_f32(const float* x, const float* taps,
                            const int* meta, float* out, long long rows,
                            long long n_ext, int n_split, int channels,
                            int n_slots, int max_off, long long n_out,
                            void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    const long long smem = smem_bytes(n_split, max_off, n_slots, channels);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            cb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int pitch = pitch_of(n_split, max_off);
    const unsigned tiles = (unsigned)((n_out + CB_TILE - 1) / CB_TILE);
    for (long long r0 = 0; r0 < rows; r0 += MAX_GRID_Y) {
        const long long nr =
            rows - r0 < MAX_GRID_Y ? rows - r0 : MAX_GRID_Y;
        dim3 grid(tiles, (unsigned)nr);
        cb_kernel<<<grid, CB_THREADS, (size_t)smem, st>>>(
            x, taps, meta, out, n_ext, n_split, channels, n_slots, pitch,
            max_off, n_out, r0, rows);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}
