/* veles_simd_memory.c — native memory/layout helpers.
 *
 * Rebuild of reference src/memory.c semantics in pure C (no Python):
 * 64-byte aligned allocation, float fill, FFT zero-padding sizes, reversed
 * (complex-pairwise) copies, power-of-2 helper.  On the device side PyTorch
 * owns layout, so align_complement_f32 is always 0; these helpers serve
 * host-side staging buffers for the C ABI.
 */

#define _POSIX_C_SOURCE 200112L

#include "veles_simd.h"

#include <stdlib.h>
#include <string.h>

#define VELES_ALIGNMENT 64

void *malloc_aligned(size_t size) {
  void *ptr = NULL;
  if (posix_memalign(&ptr, VELES_ALIGNMENT, size) != 0) {
    return NULL;
  }
  return ptr;
}

void *malloc_aligned_offset(size_t size, int offset) {
  /* reference semantics (src/memory.c:71-75): aligned base, returned
   * pointer shifted by offset; caller frees (ptr - offset). */
  char *base = malloc_aligned(size + (size_t)offset);
  if (base == NULL) {
    return NULL;
  }
  return base + offset;
}

float *mallocf(size_t length) {
  return malloc_aligned(length * sizeof(float));
}

void memsetf(float *ptr, float value, size_t length) {
  for (size_t i = 0; i < length; i++) {
    ptr[i] = value;
  }
}

int next_highest_power_of_2(int value) {
  /* inc/simd/arithmetic.h:1227-1235 bit-smear */
  if (value <= 1) {
    return 1;
  }
  value--;
  value |= value >> 1;
  value |= value >> 2;
  value |= value >> 4;
  value |= value >> 8;
  value |= value >> 16;
  return value + 1;
}

static size_t zeropadding_length(size_t length) {
  /* src/memory.c:131-137: 2 x the next power of 2 > length */
  size_t nl = length;
  int log = 2;
  while (nl) {
    nl >>= 1;
    log++;
  }
  return (size_t)1 << (log - 1);
}

float *zeropadding(const float *data, size_t length, size_t *new_length) {
  return zeropaddingex(data, length, new_length, 0);
}

float *zeropaddingex(const float *data, size_t length, size_t *new_length,
                     size_t additional_length) {
  size_t nl = zeropadding_length(length);
  float *res = mallocf(nl + additional_length);
  if (res == NULL) {
    return NULL;
  }
  memcpy(res, data, length * sizeof(float));
  memsetf(res + length, 0.f, nl + additional_length - length);
  *new_length = nl;
  return res;
}

float *rmemcpyf(float *dest, const float *src, size_t length) {
  for (size_t i = 0; i < length; i++) {
    dest[i] = src[length - i - 1];
  }
  return dest;
}

float *crmemcpyf(float *dest, const float *src, size_t length) {
  /* complex-pairwise reverse: flip sample order, keep (re, im) intact
   * (src/memory.c:178-183); length counts floats, must be even. */
  size_t pairs = length / 2;
  for (size_t i = 0; i < pairs; i++) {
    dest[2 * i] = src[2 * (pairs - i - 1)];
    dest[2 * i + 1] = src[2 * (pairs - i - 1) + 1];
  }
  return dest;
}

/* Elements from ptr to the next 64-byte boundary (src/memory.c:42-68
 * pattern; the reference divides its 32-byte AVX alignment, this build the
 * 64-byte host staging alignment used by malloc_aligned). */
static int align_offset_bytes(const void *ptr) {
  uintptr_t addr = (uintptr_t)ptr;
  if ((addr & (VELES_ALIGNMENT - 1)) != 0) {
    return (int)(VELES_ALIGNMENT - (addr % VELES_ALIGNMENT));
  }
  return 0;
}

int align_complement_f32(const float *ptr) {
  return align_offset_bytes(ptr) / 4;
}

int align_complement_i16(const int16_t *ptr) {
  return align_offset_bytes(ptr) / 2;
}

int align_complement_u16(const uint16_t *ptr) {
  return align_offset_bytes(ptr) / 2;
}

int align_complement_i32(const int32_t *ptr) {
  return align_offset_bytes(ptr) / 4;
}

int align_complement_u32(const uint32_t *ptr) {
  return align_offset_bytes(ptr) / 4;
}

/* ---- wavelet layout helpers (inc/simd/wavelet.h:55-88) ----------------
 * The reference's AVX build interleaves shifted copies for aligned
 * dp_ps loads (src/wavelet.c:100-165); PyTorch owns device layout, so these
 * follow the reference's non-AVX semantics: plain copy / plain halves. */

float *wavelet_prepare_array(int order, const float *src, size_t length) {
  (void)order;
  float *res = mallocf(length);
  if (res != NULL) {
    memcpy(res, src, length * sizeof(*src));
  }
  return res;
}

float *wavelet_allocate_destination(int order, size_t source_length) {
  (void)order;
  if (source_length < 2 || source_length % 2 != 0) {
    return NULL;
  }
  return mallocf(source_length / 2);
}

void wavelet_recycle_source(int order, float *src, size_t length,
                            float **desthihi, float **desthilo,
                            float **destlohi, float **destlolo) {
  (void)order;
  if (length == 0 || length % 4 != 0) {
    *desthihi = NULL;
    *desthilo = NULL;
    *destlohi = NULL;
    *destlolo = NULL;
    return;
  }
  size_t lq = length / 4;
  *desthihi = src;
  *desthilo = src + lq;
  *destlohi = src + lq * 2;
  *destlolo = src + lq * 3;
}
