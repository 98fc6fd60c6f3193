// Asynchronous staging helpers shared by the shifted-MAC kernels
// (filter_bank.cu, filter_2d.cu) and the cascade bank (cascade_bank.cu):
// 4- and 16-byte cp.async with their zero-fill form, group commit and
// wait, and the size of a persistent grid.
//
// A 4-byte cp.async works at any alignment, so rows of any width stage
// the same way; with a source size of 0 it writes a zero and reads
// nothing, which is how the kernels read their zero halo in place of a
// padded copy of the input.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace veles_async {

// dst[0] = ok ? *src : 0.f, asynchronously.  `src` must be a valid
// address even when `ok` is false (nothing is read from it then).
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool ok)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const int bytes = ok ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// dst[0..4) = ok ? src[0..4) : 0.f, asynchronously, both 16-byte
// aligned; bypasses L1 (every staged sample is read once)
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool ok)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const int bytes = ok ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void wait_pending()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Prepare a persistent kernel for `smem` bytes of dynamic shared memory
// a block and return how many of its blocks stay resident on one SM and
// how many SMs there are.  The carveout asks for the most shared memory:
// left to itself CUDA may pick a smaller one that fits fewer
// blocks than the occupancy count assumes, and the blocks beyond it
// would run as a second wave behind their statically assigned tiles.
template <typename Kernel>
inline cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                                   int* per_sm, int* sms)
{
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        threads, smem);
    if (err == cudaSuccess && *per_sm < 1) *per_sm = 1;
    return err;
}

// Blocks of a persistent grid: every resident block on every SM, never
// more than there are tiles.
template <typename Kernel>
inline cudaError_t persistent_blocks(Kernel kernel, int threads,
                                     size_t smem, long long tiles,
                                     unsigned* grid)
{
    int per_sm = 1, sms = 1;
    const cudaError_t err = resident_blocks(kernel, threads, smem, &per_sm,
                                            &sms);
    if (err != cudaSuccess) return err;
    long long g = (long long)sms * per_sm;
    if (g > tiles) g = tiles;
    *grid = (unsigned)(g > 0 ? g : 1);
    return cudaSuccess;
}

}  // namespace veles_async
