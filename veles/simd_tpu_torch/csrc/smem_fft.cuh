// Complex FFT in shared memory by a group of threads, shared by the
// STFT kernel (stft.cu) and the overlap-save kernel (overlap_save.cu).
//
// A group of G threads (a warp or less, or the whole block) transforms
// one complex fp32 sequence of length M that lies in shared memory,
// element i at index pad(i); a block holds T / G such groups.  The
// transform is a Stockham autosort FFT, so the result comes back in
// natural order and needs no bit reversal:
//
//   for each stage of radix R, Ns = the product of the radices so far:
//     butterfly j (k = j mod Ns) reads in[j + r*M/R], r < R, twiddles
//     input r by W_{Ns*R}^{r*k}, takes the R-point DFT, and writes
//     out[(j - k)*R + k + r*Ns]
//
// Thread `lane` of the group takes butterflies j = lane, lane + G, ...:
// no division in the power-of-two stages, and a group of one warp
// synchronises with __syncwarp alone.
//
// Radix-8 stages run first (a radix-2 step and two 4-point DFTs in
// registers), then at most one radix-4 or radix-2 stage, then one stage
// per odd prime factor of M.  An odd stage computes each output as a
// direct sum over its p inputs, so every M is right and M = 2^a * 3 or
// 2^a * 5 is fast.
//
// One buffer.  Every thread reads all of its stage's inputs into
// registers, the group synchronises, then every thread writes its
// outputs: the registers are the second buffer of the Stockham
// exchange.  That halves the shared memory of a two-buffer Stockham,
// which the overlap-save kernel's largest segment (N = 32768 samples,
// 16384 complex values, 139 KB padded) needs.  A thread holds at most
// VPT values a stage, so M <= G * VPT.
//
// Bank conflicts.  A float2 takes two of the 32 banks; the first
// stage writes at a stride of 8 elements.  pad(i) = i + i/16 shifts
// every 16 elements by one, so those stride-8 writes of a half-warp
// hit 32 distinct banks; reads at unit stride stay conflict-free.
//
// Twiddles come from a float32 table tw[t] = exp(-2 pi i t / n) that the
// wrapper builds in float64 on the host and caches on the device per n
// (cuda_kernels.fft_twiddles).  A transform of size M reads W_M^e =
// tw[e * (n / M)]: n = 2M for the real-input path (whose unpack needs
// W_{2M}^k), n = M for the complex path.  The inverse conjugates them.
//
// Real input.  A real sequence of even length 2M is transformed as the
// length-M complex sequence z[m] = x[2m] + i x[2m+1]; with Z = FFT_M(z),
//
//   2 X[k] = (Z[k] + conj Z[M-k]) - i W_{2M}^k (Z[k] - conj Z[M-k]),
//
// for k = 0..M (Z[M] = Z[0]): `unpack_real` returns 2 X[k], the caller
// scales.  `pack_real_inverse` is the reverse step, for a real inverse
// transform (overlap_save.cu).

#pragma once

#include <cuda_runtime.h>

namespace veles_fft {

constexpr int MAX_ODD = 8;     // odd prime factors of M <= 2^14: 3^8 < 2^14

struct Plan {
    int M;                     // transform length
    int n8;                    // radix-8 stages
    int n4;                    // radix-4 stages (0 or 1)
    int n2;                    // radix-2 stages (0 or 1)
    int nodd;                  // odd stages
    int odd[MAX_ODD];          // their primes, increasing
};

inline Plan make_plan(int M)
{
    Plan p{};
    p.M = M;
    int m = M;
    while (m % 8 == 0) { m /= 8; ++p.n8; }
    if (m % 4 == 0) { m /= 4; p.n4 = 1; }
    if (m % 2 == 0) { m /= 2; p.n2 = 1; }
    for (int f = 3; m > 1 && p.nodd < MAX_ODD; f += 2) {
        if ((long long)f * f > m) f = m;          // m is prime
        while (m % f == 0 && p.nodd < MAX_ODD) {
            p.odd[p.nodd++] = f;
            m /= f;
        }
    }
    return p;
}

// Elements of one padded transform of length m (pitch between batched
// transforms, in float2).
__host__ __device__ constexpr int padded(int m) { return m + (m >> 4) + 1; }

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b)
{
    return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b)
{
    return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b)
{
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 acc)
{
    acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
    acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
    return acc;
}

// tw[t], conjugated when s = -1 (the inverse)
__device__ __forceinline__ float2 twid(const float2* __restrict__ tw, int t,
                                       float s)
{
    float2 w = __ldg(tw + t);
    w.y *= s;
    return w;
}

// Synchronises the G threads that share one transform: a warp or less
// needs only __syncwarp (the groups tile whole warps, and every lane of
// a warp runs the same stages), a larger group the whole block.
template <int G>
__device__ __forceinline__ void group_sync()
{
    if constexpr (G <= 32) __syncwarp(); else __syncthreads();
}

// The 4-point DFT of u (s = +1 forward, -1 inverse), in place.
__device__ __forceinline__ void dft4(float2& u0, float2& u1, float2& u2,
                                     float2& u3, float s)
{
    const float2 t0 = cadd(u0, u2), t1 = csub(u0, u2);
    const float2 t2 = cadd(u1, u3), d = csub(u1, u3);
    const float2 t3 = make_float2(s * d.y, -s * d.x);      // d * -is
    u0 = cadd(t0, t2);
    u1 = cadd(t1, t3);
    u2 = csub(t0, t2);
    u3 = csub(t1, t3);
}

// The 8-point DFT of v, in place: radix 2, then two 4-point DFTs.
__device__ __forceinline__ void dft8(float2 (&v)[8], float s)
{
    constexpr float h = 0.70710678118654752f;               // sqrt(1/2)
    float2 b[4], c[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        b[r] = cadd(v[r], v[r + 4]);
        c[r] = csub(v[r], v[r + 4]);
    }
    // c[r] *= W_8^r = e^{-s 2 pi i r / 8}
    c[1] = make_float2(h * (c[1].x + s * c[1].y), h * (c[1].y - s * c[1].x));
    c[2] = make_float2(s * c[2].y, -s * c[2].x);
    c[3] = make_float2(h * (s * c[3].y - c[3].x), -h * (c[3].y + s * c[3].x));
    dft4(b[0], b[1], b[2], b[3], s);
    dft4(c[0], c[1], c[2], c[3], s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        v[2 * r] = b[r];
        v[2 * r + 1] = c[r];
    }
}

template <int G, int VPT>
__device__ __forceinline__ void radix8_stage(
    float2* buf, int lane, int M, int Ns, const float2* __restrict__ tw,
    int tws, float s)
{
    constexpr int NB = VPT / 8;
    const int q = M >> 3;
    const int tstep = (M / (8 * Ns)) * tws;
    float2 v[NB][8];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
        const int j = lane + i * G;
        if (j < q) {
            const int k = j & (Ns - 1);
#pragma unroll
            for (int r = 0; r < 8; ++r) v[i][r] = buf[pad(j + r * q)];
            if (k) {
#pragma unroll
                for (int r = 1; r < 8; ++r)
                    v[i][r] = cmul(v[i][r], twid(tw, r * k * tstep, s));
            }
            dft8(v[i], s);
        }
    }
    group_sync<G>();
#pragma unroll
    for (int i = 0; i < NB; ++i) {
        const int j = lane + i * G;
        if (j < q) {
            const int k = j & (Ns - 1);
            const int o = (j - k) * 8 + k;
#pragma unroll
            for (int r = 0; r < 8; ++r) buf[pad(o + r * Ns)] = v[i][r];
        }
    }
    group_sync<G>();
}

template <int G, int VPT>
__device__ __forceinline__ void radix4_stage(
    float2* buf, int lane, int M, int Ns, const float2* __restrict__ tw,
    int tws, float s)
{
    constexpr int NB = VPT / 4;
    const int q = M >> 2;
    const int tstep = (M / (4 * Ns)) * tws;
    float2 v[NB][4];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
        const int j = lane + i * G;
        if (j < q) {
            const int k = j & (Ns - 1);
            float2 a0 = buf[pad(j)];
            float2 a1 = buf[pad(j + q)];
            float2 a2 = buf[pad(j + 2 * q)];
            float2 a3 = buf[pad(j + 3 * q)];
            if (k) {
                a1 = cmul(a1, twid(tw, k * tstep, s));
                a2 = cmul(a2, twid(tw, 2 * k * tstep, s));
                a3 = cmul(a3, twid(tw, 3 * k * tstep, s));
            }
            dft4(a0, a1, a2, a3, s);
            v[i][0] = a0;
            v[i][1] = a1;
            v[i][2] = a2;
            v[i][3] = a3;
        }
    }
    group_sync<G>();
#pragma unroll
    for (int i = 0; i < NB; ++i) {
        const int j = lane + i * G;
        if (j < q) {
            const int k = j & (Ns - 1);
            const int o = (j - k) * 4 + k;
#pragma unroll
            for (int r = 0; r < 4; ++r) buf[pad(o + r * Ns)] = v[i][r];
        }
    }
    group_sync<G>();
}

template <int G, int VPT>
__device__ __forceinline__ void radix2_stage(
    float2* buf, int lane, int M, int Ns, const float2* __restrict__ tw,
    int tws, float s)
{
    constexpr int NB = VPT / 2;
    const int q = M >> 1;
    const int tstep = (M / (2 * Ns)) * tws;
    float2 v[NB][2];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
        const int j = lane + i * G;
        if (j < q) {
            const int k = j & (Ns - 1);
            const float2 a0 = buf[pad(j)];
            float2 a1 = buf[pad(j + q)];
            if (k) a1 = cmul(a1, twid(tw, k * tstep, s));
            v[i][0] = cadd(a0, a1);
            v[i][1] = csub(a0, a1);
        }
    }
    group_sync<G>();
#pragma unroll
    for (int i = 0; i < NB; ++i) {
        const int j = lane + i * G;
        if (j < q) {
            const int k = j & (Ns - 1);
            const int o = (j - k) * 2 + k;
            buf[pad(o)] = v[i][0];
            buf[pad(o + Ns)] = v[i][1];
        }
    }
    group_sync<G>();
}

// One odd stage of radix p: output (j, r) is the direct sum
// sum_u in[j + u*M/p] W_{Ns*p}^{u*(k + r*Ns)}.
template <int G, int VPT>
__device__ __forceinline__ void odd_stage(
    float2* buf, int lane, int M, int Ns, int p,
    const float2* __restrict__ tw, int tws, float s)
{
    const int q = M / p;
    const int span = Ns * p;
    const int tstep = (M / span) * tws;
    float2 v[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
        const int o = lane + i * G;
        if (o < M) {
            const int r = o / q;
            const int j = o - r * q;
            const int de = j % Ns + r * Ns;        // < span
            float2 acc = buf[pad(j)];
            int e = de;
            for (int u = 1; u < p; ++u) {
                acc = cfma(buf[pad(j + u * q)], twid(tw, e * tstep, s), acc);
                e += de;
                if (e >= span) e -= span;
            }
            v[i] = acc;
        }
    }
    group_sync<G>();
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
        const int o = lane + i * G;
        if (o < M) {
            const int r = o / q;
            const int j = o - r * q;
            const int k = j % Ns;
            buf[pad((j - k) * p + k + r * Ns)] = v[i];
        }
    }
    group_sync<G>();
}

// In-place FFT of the plan.M values at buf (padded) by a group of G
// threads, `lane` = this thread's index in the group (s = +1 forward,
// e^{-2 pi i nk/M}; s = -1 inverse, unnormalised).  Every thread of the
// group calls it after a group_sync<G> (or __syncthreads) that follows
// the buffer's fill, and it returns after a final group_sync<G>.
// M <= G * VPT.
template <int G, int VPT>
__device__ void group_fft(float2* buf, int lane, const Plan& plan,
                          const float2* __restrict__ tw, int tws, float s)
{
    const int M = plan.M;
    int Ns = 1;
    for (int i = 0; i < plan.n8; ++i, Ns *= 8)
        radix8_stage<G, VPT>(buf, lane, M, Ns, tw, tws, s);
    if (plan.n4) {
        radix4_stage<G, VPT>(buf, lane, M, Ns, tw, tws, s);
        Ns *= 4;
    }
    if (plan.n2) {
        radix2_stage<G, VPT>(buf, lane, M, Ns, tw, tws, s);
        Ns *= 2;
    }
    for (int i = 0; i < plan.nodd; ++i) {
        odd_stage<G, VPT>(buf, lane, M, Ns, plan.odd[i], tw, tws, s);
        Ns *= plan.odd[i];
    }
}

// 2 X[k] of a real sequence of length 2M, from a = Z[k] and b = Z[M-k]
// of Z = FFT_M(x[2m] + i x[2m+1]), with w = W_{2M}^k.
__device__ __forceinline__ float2 unpack_pair(float2 a, float2 b, float2 w)
{
    b.y = -b.y;                                   // conj Z[M-k]
    const float2 e = cadd(a, b);
    const float2 d = cmul(w, csub(a, b));         // W (Z - conj Z')
    return make_float2(e.x + d.y, e.y - d.x);     // e - i d
}

// 2 X[k], k in [0, M], from the padded transform z (Z[M] = Z[0]).
__device__ __forceinline__ float2 unpack_real(const float2* z, int M, int k,
                                              float2 w)
{
    return unpack_pair(z[pad(k == M ? 0 : k)], z[pad(k == 0 ? 0 : M - k)],
                       w);
}

// The reverse step of an inverse real transform: from the half
// spectrum a = Y[k], b = Y[M-k] of a real y of length 2M, with w =
// W_{2M}^k, the value (Y[k] + conj Y[M-k]) + i conj(w) (Y[k] - conj
// Y[M-k]).  The unnormalised inverse FFT_M of these values is
// 2M (y[2m] + i y[2m+1]); the caller folds 1/(2M) into its filter.
__device__ __forceinline__ float2 pack_real_inverse(float2 a, float2 b,
                                                    float2 w)
{
    b.y = -b.y;                                   // conj Y[M-k]
    const float2 e = cadd(a, b);
    w.y = -w.y;                                   // conj W
    const float2 d = cmul(w, csub(a, b));
    return make_float2(e.x - d.y, e.y + d.x);     // e + i d
}

}  // namespace veles_fft
