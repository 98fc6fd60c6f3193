/* veles_simd_arithmetic.c — the inline multiply/reduce family of the
 * reference's arithmetic header, as linkable C symbols.
 *
 * The reference publishes these as header-only inline primitives
 * (reference inc/simd/arithmetic.h): fixed-width vector blocks on the
 * SIMD build (8 floats wide on AVX, res[i] = a[i]*b[i] for i = 0..7 —
 * arithmetic.h:624-651; 16 int16 lanes on AVX2 — :211-221), scalar `_na`
 * twins (:129-191), and whole-array forms.  FFT-multiply pipelines like the
 * reference's overlap-save hot loop (src/convolve.c:202-219) are written
 * against exactly this surface, so the port ships the same names with
 * the same semantics.  These are *host staging* primitives — plain C99 the
 * compiler auto-vectorizes; the device-side equivalents live in
 * veles/simd_tpu_torch/ops/arithmetic.py and are what the big compute paths use.
 * Block width is fixed at the reference's AVX widths (VELES_SIMD_FLOAT_STEP
 * = 8 floats, VELES_SIMD_INT16MUL_STEP = 16 lanes) on every host.
 *
 * No Python involvement, like veles_simd_memory.c.
 */

#include <stddef.h>
#include <stdint.h>

#include "veles_simd.h"

/* ---- fixed-width block primitives ------------------------------------- */

/* arithmetic.h:624-630 (AVX): res[i] = a[i] * b[i], i = 0..7. */
void real_multiply(const float *a, const float *b, float *res) {
  for (int i = 0; i < VELES_SIMD_FLOAT_STEP; i++) {
    res[i] = a[i] * b[i];
  }
}

/* arithmetic.h:129-132: single-element scalar twin. */
void real_multiply_na(const float *a, const float *b, float *res) {
  *res = *a * *b;
}

/* arithmetic.h:653-672 (AVX): 4 interleaved complex products
 * res[i]   = a[i]*b[i]   - a[i+1]*b[i+1],  i = 0, 2, 4, 6
 * res[i+1] = a[i]*b[i+1] + a[i+1]*b[i]. */
void complex_multiply(const float *a, const float *b, float *res) {
  for (int i = 0; i < VELES_SIMD_FLOAT_STEP; i += 2) {
    float re1 = a[i], im1 = a[i + 1];
    float re2 = b[i], im2 = b[i + 1];
    res[i] = re1 * re2 - im1 * im2;
    res[i + 1] = re1 * im2 + re2 * im1;
  }
}

/* arithmetic.h:142-150: one complex product. */
void complex_multiply_na(const float *a, const float *b, float *res) {
  float re1 = a[0], im1 = a[1];
  float re2 = b[0], im2 = b[1];
  res[0] = re1 * re2 - im1 * im2;
  res[1] = re1 * im2 + re2 * im1;
}

/* arithmetic.h:674-693 (AVX): conjugate(b) variant, 4 complex products. */
void complex_multiply_conjugate(const float *a, const float *b, float *res) {
  for (int i = 0; i < VELES_SIMD_FLOAT_STEP; i += 2) {
    float re1 = a[i], im1 = a[i + 1];
    float re2 = b[i], im2 = -b[i + 1];
    res[i] = re1 * re2 - im1 * im2;
    res[i + 1] = re1 * im2 + re2 * im1;
  }
}

/* arithmetic.h:152-160. */
void complex_multiply_conjugate_na(const float *a, const float *b,
                                   float *res) {
  float re1 = a[0], im1 = a[1];
  float re2 = b[0], im2 = -b[1];
  res[0] = re1 * re2 - im1 * im2;
  res[1] = re1 * im2 + re2 * im1;
}

/* arithmetic.h:211-221 (AVX2): res[i] = a[i] * b[i] widened, i = 0..15. */
void int16_multiply(const int16_t *a, const int16_t *b, int32_t *res) {
  for (int i = 0; i < VELES_SIMD_INT16MUL_STEP; i++) {
    res[i] = (int32_t)a[i] * (int32_t)b[i];
  }
}

/* ---- whole-array forms ------------------------------------------------- */

/* arithmetic.h:638-651 (AVX) / :134-140 (na): res[j] = a[j] * b[j]. */
void real_multiply_array(const float *a, const float *b, size_t length,
                         float *res) {
  for (size_t j = 0; j < length; j++) {
    res[j] = a[j] * b[j];
  }
}

void real_multiply_array_na(const float *a, const float *b, size_t length,
                            float *res) {
  real_multiply_array(a, b, length, res);
}

/* arithmetic.h:747-785 (AVX) / :170-176 (na): res[i] = array[i] * value. */
void real_multiply_scalar(const float *array, size_t length, float value,
                          float *res) {
  for (size_t i = 0; i < length; i++) {
    res[i] = array[i] * value;
  }
}

void real_multiply_scalar_na(const float *array, size_t length, float value,
                             float *res) {
  real_multiply_scalar(array, length, value, res);
}

/* arithmetic.h:695-740 (AVX) / :162-168 (na): negate every imaginary lane.
 * Walks in (re, im) pairs like the reference; a trailing unpaired float is
 * copied through (the reference's loop never touches it). */
void complex_conjugate(const float *array, size_t length, float *res) {
  size_t i;
  for (i = 1; i < length; i += 2) {
    res[i - 1] = array[i - 1];
    res[i] = -array[i];
  }
  if (length % 2 != 0) {
    res[length - 1] = array[length - 1];
  }
}

void complex_conjugate_na(const float *array, size_t length, float *res) {
  complex_conjugate(array, length, res);
}

/* arithmetic.h:787-808 (AVX) / :178-184 (na): horizontal sum. */
float sum_elements(const float *input, size_t length) {
  float res = 0.f;
  for (size_t j = 0; j < length; j++) {
    res += input[j];
  }
  return res;
}

float sum_elements_na(const float *input, size_t length) {
  return sum_elements(input, length);
}

/* arithmetic.h:810-830 (AVX) / :186-191 (na): output[j] = input[j] + value.
 * (The reference's NEON variant has a store-offset bug at :1196; the scalar
 * semantics are the contract.) */
void add_to_all(const float *input, size_t length, float value,
                float *output) {
  for (size_t j = 0; j < length; j++) {
    output[j] = input[j] + value;
  }
}

void add_to_all_na(const float *input, size_t length, float value,
                   float *output) {
  add_to_all(input, length, value, output);
}
