/* veles_simd.c — embedded-CPython bridge to the PyTorch/CUDA port
 * (veles.simd_tpu_torch).
 *
 * The compute path lives in Python (PyTorch, and the port's CUDA kernels
 * on an NVIDIA card); this translation unit provides the
 * reference-compatible C ABI (reference inc/simd headers) by embedding an
 * interpreter and calling veles/simd_tpu_torch/cshim.py with raw
 * pointers.  It is csrc/veles_simd.c with the port's module name.  Works
 * both as a standalone embedder (C program links libveles_simd.so) and
 * when loaded inside an existing Python process (dlopen from ctypes):
 * PyGILState handles both.
 */

#include "veles_simd.h"

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <Python.h>

static PyObject *g_mod = NULL;        /* veles.simd_tpu_torch.cshim */
static int g_we_initialized = 0;
static char g_last_error[4096] = "";
static char g_backend[64] = "uninitialized";

const char *veles_simd_last_error(void) { return g_last_error; }

static void set_error_from_python(void) {
  PyObject *type = NULL, *value = NULL, *tb = NULL;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  if (value != NULL) {
    PyObject *s = PyObject_Str(value);
    if (s != NULL) {
      const char *msg = PyUnicode_AsUTF8(s);
      if (msg != NULL) {
        snprintf(g_last_error, sizeof(g_last_error), "%s", msg);
      }
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

int veles_simd_init(const char *repo_root) {
  if (g_mod != NULL) {
    return 0;
  }
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = 1;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = -1;
  const char *root = repo_root;
  if (root == NULL) {
    root = getenv("VELES_SIMD_PYROOT");
  }
  if (root != NULL) {
    PyObject *sys_path = PySys_GetObject("path"); /* borrowed */
    PyObject *p = sys_path ? PyUnicode_FromString(root) : NULL;
    if (p != NULL) {
      PyList_Insert(sys_path, 0, p);
      Py_DECREF(p);
    }
  }
  g_mod = PyImport_ImportModule("veles.simd_tpu_torch.cshim");
  if (g_mod == NULL) {
    set_error_from_python();
    goto done;
  }
  {
    PyObject *desc = PyObject_CallMethod(g_mod, "backend_description", NULL);
    if (desc != NULL) {
      const char *s = PyUnicode_AsUTF8(desc);
      if (s != NULL) {
        snprintf(g_backend, sizeof(g_backend), "%s", s);
      }
      Py_DECREF(desc);
    } else {
      PyErr_Clear();
    }
  }
  rc = 0;
done:
  PyGILState_Release(gil);
  return rc;
}

void veles_simd_shutdown(void) {
  if (g_mod != NULL) {
    PyGILState_STATE gil = PyGILState_Ensure();
    Py_CLEAR(g_mod);
    PyGILState_Release(gil);
  }
  if (g_we_initialized && Py_IsInitialized()) {
    Py_Finalize();
    g_we_initialized = 0;
  }
}

const char *veles_simd_backend(void) { return g_backend; }

/* Call cshim.<method>(<args per format>).  The returned object is parsed
 * into plain C data by `parse` BEFORE the GIL is released: callers may be
 * foreign threads (ctypes drops the GIL around foreign calls), so no
 * CPython API may touch the result object after PyGILState_Release.
 * Returns 0 when the call and the parse both succeeded. */
typedef int (*shim_parse_fn)(PyObject *result, void *out);

static int shim_call_parse(const char *method, shim_parse_fn parse, void *out,
                           const char *format, ...) {
  if (g_mod == NULL && veles_simd_init(NULL) != 0) {
    return -1;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *result = NULL;
  int rc = -1;
  va_list va;
  va_start(va, format);
  PyObject *args = Py_VaBuildValue(format, va);
  va_end(va);
  if (args != NULL) {
    PyObject *fn = PyObject_GetAttrString(g_mod, method);
    if (fn != NULL) {
      result = PyObject_CallObject(fn, args);
      Py_DECREF(fn);
    }
    Py_DECREF(args);
  }
  if (result != NULL) {
    rc = parse == NULL ? 0 : parse(result, out);
    Py_DECREF(result);
  }
  if (rc != 0) {
    if (PyErr_Occurred()) {
      set_error_from_python();
    } else {
      /* non-Python failure (e.g. malloc in a parse callback): don't leave
       * a stale unrelated message in g_last_error */
      snprintf(g_last_error, sizeof(g_last_error),
               "%s: result parse failed", method);
    }
  }
  PyGILState_Release(gil);
  return rc;
}

/* Run a void-ish shim method; 0 on success. */
static int shim_run(const char *method, const char *format, ...) {
  if (g_mod == NULL && veles_simd_init(NULL) != 0) {
    return -1;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = -1;
  va_list va;
  va_start(va, format);
  PyObject *args = Py_VaBuildValue(format, va);
  va_end(va);
  if (args != NULL) {
    PyObject *fn = PyObject_GetAttrString(g_mod, method);
    if (fn != NULL) {
      PyObject *result = PyObject_CallObject(fn, args);
      if (result != NULL) {
        rc = 0;
        Py_DECREF(result);
      }
      Py_DECREF(fn);
    }
    Py_DECREF(args);
  }
  if (rc != 0) {
    set_error_from_python();
  }
  PyGILState_Release(gil);
  return rc;
}

#define PTR(p) ((unsigned long long)(uintptr_t)(p))

/* ---- matrix ----------------------------------------------------------- */

int matrix_add(int simd, const float *m1, const float *m2,
               size_t w, size_t h, float *res) {
  return shim_run("matrix_add", "(iKKKkk)", simd, PTR(m1), PTR(m2), PTR(res),
                  (unsigned long)w, (unsigned long)h);
}

int matrix_sub(int simd, const float *m1, const float *m2,
               size_t w, size_t h, float *res) {
  return shim_run("matrix_sub", "(iKKKkk)", simd, PTR(m1), PTR(m2), PTR(res),
                  (unsigned long)w, (unsigned long)h);
}

int matrix_multiply(int simd, const float *m1, const float *m2,
                    size_t w1, size_t h1, size_t w2, size_t h2, float *res) {
  return shim_run("matrix_multiply", "(iKKKkkkk)", simd, PTR(m1), PTR(m2),
                  PTR(res), (unsigned long)w1, (unsigned long)h1,
                  (unsigned long)w2, (unsigned long)h2);
}

int matrix_multiply_transposed(int simd, const float *m1, const float *m2,
                               size_t w1, size_t h1, size_t w2, size_t h2,
                               float *res) {
  return shim_run("matrix_multiply_transposed", "(iKKKkkkk)", simd, PTR(m1),
                  PTR(m2), PTR(res), (unsigned long)w1, (unsigned long)h1,
                  (unsigned long)w2, (unsigned long)h2);
}

/* ---- convolve / correlate --------------------------------------------- */

struct VelesConvolutionHandle {
  long id;
  size_t x_length;
  size_t h_length;
};

static int parse_long(PyObject *r, void *out) {
  long v = PyLong_AsLong(r);
  if (v == -1 && PyErr_Occurred()) {
    return -1;
  }
  *(long *)out = v;
  return 0;
}

static VelesConvolutionHandle *conv_init(size_t x_length, size_t h_length,
                                         int algorithm, int reverse) {
  long id = 0;
  if (shim_call_parse("convolve_initialize", parse_long, &id, "(kkii)",
                      (unsigned long)x_length, (unsigned long)h_length,
                      algorithm, reverse) != 0 ||
      id <= 0) {
    return NULL;
  }
  VelesConvolutionHandle *handle = malloc(sizeof(*handle));
  if (handle == NULL) {
    return NULL;
  }
  handle->id = id;
  handle->x_length = x_length;
  handle->h_length = h_length;
  return handle;
}

VelesConvolutionHandle *convolve_initialize(size_t x_length, size_t h_length,
                                            int algorithm) {
  return conv_init(x_length, h_length, algorithm, 0);
}

VelesConvolutionHandle *cross_correlate_initialize(size_t x_length,
                                                   size_t h_length,
                                                   int algorithm) {
  return conv_init(x_length, h_length, algorithm, 1);
}

int convolve(VelesConvolutionHandle *handle, const float *x, const float *h,
             float *result) {
  if (handle == NULL) {
    return -1;
  }
  return shim_run("convolve_run", "(lKKK)", handle->id, PTR(x), PTR(h),
                  PTR(result));
}

int cross_correlate(VelesConvolutionHandle *handle, const float *x,
                    const float *h, float *result) {
  return convolve(handle, x, h, result);
}

void convolve_finalize(VelesConvolutionHandle *handle) {
  if (handle != NULL) {
    shim_run("convolve_finalize", "(l)", handle->id);
    free(handle);
  }
}

void cross_correlate_finalize(VelesConvolutionHandle *handle) {
  convolve_finalize(handle);
}

static int conv2d_run(int simd, int reverse, const float *x, size_t n0,
                      size_t n1, const float *h, size_t k0, size_t k1,
                      float *result) {
  return shim_run("convolve2d", "(iiKkkKkkK)", simd, reverse, PTR(x),
                  (unsigned long)n0, (unsigned long)n1, PTR(h),
                  (unsigned long)k0, (unsigned long)k1, PTR(result));
}

int convolve2d(int simd, const float *x, size_t n0, size_t n1,
               const float *h, size_t k0, size_t k1, float *result) {
  return conv2d_run(simd, 0, x, n0, n1, h, k0, k1, result);
}

int convolve2d_mb(int simd, int reverse, const float *x, size_t n0,
                  size_t n1, const float *h, size_t k0, size_t k1,
                  int mode, int boundary, float fillvalue,
                  float *result) {
  return shim_run("convolve2d_mb", "(iiKkkKkkiifK)", simd, reverse,
                  PTR(x), (unsigned long)n0, (unsigned long)n1, PTR(h),
                  (unsigned long)k0, (unsigned long)k1, mode, boundary,
                  (double)fillvalue, PTR(result));
}

int cross_correlate2d(int simd, const float *x, size_t n0, size_t n1,
                      const float *h, size_t k0, size_t k1, float *result) {
  return conv2d_run(simd, 1, x, n0, n1, h, k0, k1, result);
}

struct VelesStreamingConvolution {
  long id;
  size_t h_length;
  size_t chunk_length;
};

VelesStreamingConvolution *streaming_convolve_initialize(
    const float *h, size_t h_length, size_t chunk_length, int reverse,
    int simd) {
  long id = 0;
  if (shim_call_parse("streaming_convolve_initialize", parse_long, &id,
                      "(Kkkii)", PTR(h), (unsigned long)h_length,
                      (unsigned long)chunk_length, reverse, simd) != 0 ||
      id <= 0) {
    return NULL;
  }
  VelesStreamingConvolution *stream = malloc(sizeof(*stream));
  if (stream == NULL) {
    return NULL;
  }
  stream->id = id;
  stream->h_length = h_length;
  stream->chunk_length = chunk_length;
  return stream;
}

int streaming_convolve_process(VelesStreamingConvolution *stream,
                               const float *chunk, float *result) {
  if (stream == NULL) {
    return -1;
  }
  return shim_run("streaming_convolve_process", "(lKK)", stream->id,
                  PTR(chunk), PTR(result));
}

int streaming_convolve_flush(VelesStreamingConvolution *stream,
                             float *tail) {
  if (stream == NULL) {
    return -1;
  }
  return shim_run("streaming_convolve_flush", "(lK)", stream->id,
                  PTR(tail));
}

void streaming_convolve_finalize(VelesStreamingConvolution *stream) {
  if (stream != NULL) {
    shim_run("streaming_convolve_finalize", "(l)", stream->id);
    free(stream);
  }
}

/* Named per-algorithm entry points (inc/simd/convolve.h:58-96,
 * inc/simd/correlate.h:57-105): same registry, forced algorithm. */

VelesConvolutionHandle *convolve_fft_initialize(size_t x_length,
                                                size_t h_length) {
  return conv_init(x_length, h_length, VELES_CONV_ALGORITHM_FFT, 0);
}

int convolve_fft(VelesConvolutionHandle *handle, const float *x,
                 const float *h, float *result) {
  return convolve(handle, x, h, result);
}

void convolve_fft_finalize(VelesConvolutionHandle *handle) {
  convolve_finalize(handle);
}

VelesConvolutionHandle *convolve_overlap_save_initialize(size_t x_length,
                                                         size_t h_length) {
  return conv_init(x_length, h_length, VELES_CONV_ALGORITHM_OVERLAP_SAVE, 0);
}

int convolve_overlap_save(VelesConvolutionHandle *handle, const float *x,
                          const float *h, float *result) {
  return convolve(handle, x, h, result);
}

void convolve_overlap_save_finalize(VelesConvolutionHandle *handle) {
  convolve_finalize(handle);
}

/* Legacy doc-comment name (inc/simd/convolve.h:123-124). */
VelesConvolutionHandle *convolve_overlap_initialize(size_t x_length,
                                                    size_t h_length) {
  return convolve_overlap_save_initialize(x_length, h_length);
}

VelesConvolutionHandle *cross_correlate_fft_initialize(size_t x_length,
                                                       size_t h_length) {
  return conv_init(x_length, h_length, VELES_CONV_ALGORITHM_FFT, 1);
}

int cross_correlate_fft(VelesConvolutionHandle *handle, const float *x,
                        const float *h, float *result) {
  return convolve(handle, x, h, result);
}

void cross_correlate_fft_finalize(VelesConvolutionHandle *handle) {
  convolve_finalize(handle);
}

VelesConvolutionHandle *cross_correlate_overlap_save_initialize(
    size_t x_length, size_t h_length) {
  return conv_init(x_length, h_length, VELES_CONV_ALGORITHM_OVERLAP_SAVE, 1);
}

int cross_correlate_overlap_save(VelesConvolutionHandle *handle,
                                 const float *x, const float *h,
                                 float *result) {
  return convolve(handle, x, h, result);
}

void cross_correlate_overlap_save_finalize(VelesConvolutionHandle *handle) {
  convolve_finalize(handle);
}

/* Legacy doc-comment name (inc/simd/correlate.h:132-134). */
VelesConvolutionHandle *cross_correlate_overlap_initialize(size_t x_length,
                                                           size_t h_length) {
  return cross_correlate_overlap_save_initialize(x_length, h_length);
}

int convolve_simd(int simd, const float *x, size_t x_length,
                  const float *h, size_t h_length, float *result) {
  return shim_run("convolve_simd", "(iKkKkK)", simd, PTR(x),
                  (unsigned long)x_length, PTR(h), (unsigned long)h_length,
                  PTR(result));
}

int cross_correlate_simd(int simd, const float *x, size_t x_length,
                         const float *h, size_t h_length, float *result) {
  return shim_run("cross_correlate_simd", "(iKkKkK)", simd, PTR(x),
                  (unsigned long)x_length, PTR(h), (unsigned long)h_length,
                  PTR(result));
}

/* ---- wavelet ---------------------------------------------------------- */

static int parse_truth(PyObject *r, void *out) {
  int v = PyObject_IsTrue(r);
  if (v < 0) {
    return -1;
  }
  *(int *)out = v;
  return 0;
}

int wavelet_validate_order(WaveletType type, int order) {
  int valid = 0;
  if (shim_call_parse("wavelet_validate_order", parse_truth, &valid, "(ii)",
                      (int)type, order) != 0) {
    return 0;
  }
  return valid == 1;
}

int wavelet_apply(int simd, WaveletType type, int order, ExtensionType ext,
                  const float *src, size_t length,
                  float *desthi, float *destlo) {
  return shim_run("wavelet_apply", "(iiiiKkKK)", simd, (int)type, order,
                  (int)ext, PTR(src), (unsigned long)length, PTR(desthi),
                  PTR(destlo));
}

int stationary_wavelet_apply(int simd, WaveletType type, int order, int level,
                             ExtensionType ext, const float *src,
                             size_t length, float *desthi, float *destlo) {
  return shim_run("stationary_wavelet_apply", "(iiiiiKkKK)", simd, (int)type,
                  order, level, (int)ext, PTR(src), (unsigned long)length,
                  PTR(desthi), PTR(destlo));
}

int wavelet_apply_na(WaveletType type, int order, ExtensionType ext,
                     const float *src, size_t length,
                     float *desthi, float *destlo) {
  return wavelet_apply(0, type, order, ext, src, length, desthi, destlo);
}

int stationary_wavelet_apply_na(WaveletType type, int order, int level,
                                ExtensionType ext, const float *src,
                                size_t length, float *desthi,
                                float *destlo) {
  return stationary_wavelet_apply(0, type, order, level, ext, src, length,
                                  desthi, destlo);
}

int wavelet_reconstruct(int simd, WaveletType type, int order,
                        ExtensionType ext, const float *desthi,
                        const float *destlo, size_t length, float *result) {
  return shim_run("wavelet_reconstruct", "(iiiiKKkK)", simd, (int)type,
                  order, (int)ext, PTR(desthi), PTR(destlo),
                  (unsigned long)length, PTR(result));
}

int stationary_wavelet_reconstruct(int simd, WaveletType type, int order,
                                   int level, ExtensionType ext,
                                   const float *desthi, const float *destlo,
                                   size_t length, float *result) {
  return shim_run("stationary_wavelet_reconstruct", "(iiiiiKKkK)", simd,
                  (int)type, order, level, (int)ext, PTR(desthi),
                  PTR(destlo), (unsigned long)length, PTR(result));
}

int wavelet_apply2d(int simd, WaveletType type, int order,
                    ExtensionType ext, const float *src, size_t n0,
                    size_t n1, float *ll, float *lh, float *hl,
                    float *hh) {
  return shim_run("wavelet_apply2d", "(iiiiKkkKKKK)", simd, (int)type,
                  order, (int)ext, PTR(src), (unsigned long)n0,
                  (unsigned long)n1, PTR(ll), PTR(lh), PTR(hl), PTR(hh));
}

int wavelet_reconstruct2d(int simd, WaveletType type, int order,
                          ExtensionType ext, const float *ll,
                          const float *lh, const float *hl,
                          const float *hh, size_t m0, size_t m1,
                          float *result) {
  return shim_run("wavelet_reconstruct2d", "(iiiiKKKKkkK)", simd,
                  (int)type, order, (int)ext, PTR(ll), PTR(lh), PTR(hl),
                  PTR(hh), (unsigned long)m0, (unsigned long)m1,
                  PTR(result));
}

int stationary_wavelet_apply2d(int simd, WaveletType type, int order,
                               int level, ExtensionType ext,
                               const float *src, size_t n0, size_t n1,
                               float *ll, float *lh, float *hl,
                               float *hh) {
  return shim_run("stationary_wavelet_apply2d", "(iiiiiKkkKKKK)", simd,
                  (int)type, order, level, (int)ext, PTR(src),
                  (unsigned long)n0, (unsigned long)n1, PTR(ll), PTR(lh),
                  PTR(hl), PTR(hh));
}

int stationary_wavelet_reconstruct2d(int simd, WaveletType type, int order,
                                     int level, ExtensionType ext,
                                     const float *ll, const float *lh,
                                     const float *hl, const float *hh,
                                     size_t m0, size_t m1, float *result) {
  return shim_run("stationary_wavelet_reconstruct2d", "(iiiiiKKKKkkK)",
                  simd, (int)type, order, level, (int)ext, PTR(ll),
                  PTR(lh), PTR(hl), PTR(hh), (unsigned long)m0,
                  (unsigned long)m1, PTR(result));
}

int wavelet_packet_transform(int simd, WaveletType type, int order,
                             ExtensionType ext, const float *src,
                             size_t length, int levels, float *leaves) {
  return shim_run("wavelet_packet_transform", "(iiiiKkiK)", simd,
                  (int)type, order, (int)ext, PTR(src),
                  (unsigned long)length, levels, PTR(leaves));
}

int wavelet_packet_inverse_transform(int simd, WaveletType type, int order,
                                     ExtensionType ext, const float *leaves,
                                     size_t length, int levels,
                                     float *result) {
  return shim_run("wavelet_packet_inverse_transform", "(iiiiKkiK)", simd,
                  (int)type, order, (int)ext, PTR(leaves),
                  (unsigned long)length, levels, PTR(result));
}

int wavelet_packet_transform2d(int simd, WaveletType type, int order,
                               ExtensionType ext, const float *src,
                               size_t m0, size_t m1, int levels,
                               float *leaves) {
  return shim_run("wavelet_packet_transform2d", "(iiiiKkkiK)", simd,
                  (int)type, order, (int)ext, PTR(src),
                  (unsigned long)m0, (unsigned long)m1, levels,
                  PTR(leaves));
}

int wavelet_packet_inverse_transform2d(int simd, WaveletType type,
                                       int order, ExtensionType ext,
                                       const float *leaves, size_t m0,
                                       size_t m1, int levels,
                                       float *result) {
  return shim_run("wavelet_packet_inverse_transform2d", "(iiiiKkkiK)",
                  simd, (int)type, order, (int)ext, PTR(leaves),
                  (unsigned long)m0, (unsigned long)m1, levels,
                  PTR(result));
}

/* ---- mathfun ---------------------------------------------------------- */

static int psv(const char *name, int simd, const float *src, size_t length,
               float *res) {
  return shim_run("mathfun", "(siKkK)", name, simd, PTR(src),
                  (unsigned long)length, PTR(res));
}

int sin_psv(int simd, const float *src, size_t length, float *res) {
  return psv("sin", simd, src, length, res);
}
int cos_psv(int simd, const float *src, size_t length, float *res) {
  return psv("cos", simd, src, length, res);
}
int log_psv(int simd, const float *src, size_t length, float *res) {
  return psv("log", simd, src, length, res);
}
int exp_psv(int simd, const float *src, size_t length, float *res) {
  return psv("exp", simd, src, length, res);
}
int sqrt_psv(int simd, const float *src, size_t length, float *res) {
  return psv("sqrt", simd, src, length, res);
}

int pow_psv(int simd, const float *base, const float *exponent,
            size_t length, float *res) {
  return shim_run("pow_psv", "(iKKkK)", simd, PTR(base), PTR(exponent),
                  (unsigned long)length, PTR(res));
}

/* ---- correlate extras ------------------------------------------------- */

size_t correlation_lags_length(size_t in_len, size_t in2_len,
                               VelesCorrMode mode) {
  size_t lo = in_len < in2_len ? in_len : in2_len;
  size_t hi = in_len < in2_len ? in2_len : in_len;
  if (lo == 0) return 0; /* empty input: no lags (avoids 0+0-1 wrap) */
  switch (mode) {
    case VELES_MODE_FULL: return in_len + in2_len - 1;
    case VELES_MODE_SAME: return hi;
    case VELES_MODE_VALID: return hi - lo + 1;
  }
  return 0;
}

int correlation_lags(size_t in_len, size_t in2_len, VelesCorrMode mode,
                     long *lags) {
  return shim_run("correlation_lags", "(kkiK)", (unsigned long)in_len,
                  (unsigned long)in2_len, (int)mode, PTR(lags));
}

int deconvolve(const double *signal, size_t sig_len,
               const double *divisor, size_t div_len,
               double *quotient, double *remainder) {
  return shim_run("deconvolve", "(KkKkKK)", PTR(signal),
                  (unsigned long)sig_len, PTR(divisor),
                  (unsigned long)div_len, PTR(quotient), PTR(remainder));
}

/* ---- waveforms -------------------------------------------------------- */

int wave_chirp(int simd, const float *t, size_t length, double f0,
               double t1, double f1, VelesChirpMethod method, double phi,
               float *result) {
  return shim_run("wave_chirp", "(iKkdddidK)", simd, PTR(t),
                  (unsigned long)length, f0, t1, f1, (int)method, phi,
                  PTR(result));
}

int wave_square(int simd, const float *t, size_t length, double duty,
                float *result) {
  return shim_run("wave_square", "(iKkdK)", simd, PTR(t),
                  (unsigned long)length, duty, PTR(result));
}

int wave_sawtooth(int simd, const float *t, size_t length, double width,
                  float *result) {
  return shim_run("wave_sawtooth", "(iKkdK)", simd, PTR(t),
                  (unsigned long)length, width, PTR(result));
}

int wave_gausspulse(int simd, const float *t, size_t length, double fc,
                    double bw, double bwr, float *result) {
  return shim_run("wave_gausspulse", "(iKkdddK)", simd, PTR(t),
                  (unsigned long)length, fc, bw, bwr, PTR(result));
}

int wave_unit_impulse(int simd, size_t n, size_t idx, float *result) {
  return shim_run("wave_unit_impulse", "(ikkK)", simd, (unsigned long)n,
                  (unsigned long)idx, PTR(result));
}

int wave_max_len_seq(int nbits, uint8_t *state_io, size_t length,
                     uint8_t *seq) {
  return shim_run("wave_max_len_seq", "(iKkK)", nbits, PTR(state_io),
                  (unsigned long)length, PTR(seq));
}

int wave_get_window(VelesWindowKind window, size_t n, double beta,
                    double *result) {
  return shim_run("wave_get_window", "(ikdK)", (int)window,
                  (unsigned long)n, beta, PTR(result));
}

/* ---- spectral --------------------------------------------------------- */

size_t stft_frame_count(size_t length, size_t frame_length, size_t hop) {
  if (frame_length == 0 || hop == 0 || length < frame_length) {
    return 0;
  }
  return 1 + (length - frame_length) / hop;
}

int stft(int simd, const float *x, size_t length, size_t frame_length,
         size_t hop, const float *window, float *spec) {
  return shim_run("stft", "(iKkkkKK)", simd, PTR(x), (unsigned long)length,
                  (unsigned long)frame_length, (unsigned long)hop,
                  PTR(window), PTR(spec));
}

int istft(int simd, const float *spec, size_t length, size_t frame_length,
          size_t hop, const float *window, float *result) {
  return shim_run("istft", "(iKkkkKK)", simd, PTR(spec),
                  (unsigned long)length, (unsigned long)frame_length,
                  (unsigned long)hop, PTR(window), PTR(result));
}

int spectrogram(int simd, const float *x, size_t length,
                size_t frame_length, size_t hop, const float *window,
                float *power) {
  return shim_run("spectrogram", "(iKkkkKK)", simd, PTR(x),
                  (unsigned long)length, (unsigned long)frame_length,
                  (unsigned long)hop, PTR(window), PTR(power));
}

int hilbert(int simd, const float *x, size_t length, float *analytic) {
  return shim_run("hilbert", "(iKkK)", simd, PTR(x), (unsigned long)length,
                  PTR(analytic));
}

int envelope(int simd, const float *x, size_t length, float *env) {
  return shim_run("envelope", "(iKkK)", simd, PTR(x), (unsigned long)length,
                  PTR(env));
}

int morlet_cwt(int simd, const float *x, size_t length,
               const double *scales, size_t n_scales, double w0,
               float *result) {
  return shim_run("morlet_cwt", "(iKkKkdK)", simd, PTR(x),
                  (unsigned long)length, PTR(scales),
                  (unsigned long)n_scales, w0, PTR(result));
}

/* ---- resample --------------------------------------------------------- */

size_t resample_length(size_t length, size_t up, size_t down) {
  if (up == 0 || down == 0) {
    return 0;
  }
  return (length * up + down - 1) / down;
}

size_t upfirdn_length(size_t length, size_t h_len, size_t up,
                      size_t down) {
  if (length == 0 || h_len == 0 || up == 0 || down == 0) {
    return 0;
  }
  return ((length - 1) * up + h_len - 1) / down + 1;
}

int upfirdn(int simd, const double *h, size_t h_len, const float *x,
            size_t length, size_t up, size_t down, float *result) {
  return shim_run("upfirdn", "(iKkKkkkK)", simd, PTR(h),
                  (unsigned long)h_len, PTR(x), (unsigned long)length,
                  (unsigned long)up, (unsigned long)down, PTR(result));
}

int spectral_czt(int simd, const float *x, size_t length, size_t m,
                 double w_re, double w_im, double a_re, double a_im,
                 float *result) {
  return shim_run("spectral_czt", "(iKkkddddK)", simd, PTR(x),
                  (unsigned long)length, (unsigned long)m, w_re, w_im,
                  a_re, a_im, PTR(result));
}

int spectral_zoom_fft(int simd, const float *x, size_t length, double f1,
                      double f2, size_t m, double fs, double *freqs,
                      float *result) {
  return shim_run("spectral_zoom_fft", "(iKkddkdKK)", simd, PTR(x),
                  (unsigned long)length, f1, f2, (unsigned long)m, fs,
                  PTR(freqs), PTR(result));
}

int spectral_lombscargle(int simd, const double *t, const float *x,
                         size_t length, const double *freqs,
                         size_t n_freqs, float *power) {
  return shim_run("spectral_lombscargle", "(iKKkKkK)", simd, PTR(t),
                  PTR(x), (unsigned long)length, PTR(freqs),
                  (unsigned long)n_freqs, PTR(power));
}

size_t welch_bins(size_t length, size_t nperseg) {
  size_t seg = nperseg < length ? nperseg : length;
  return seg / 2 + 1;
}

int spectral_detrend(int simd, const float *x, size_t length, int kind,
                     float *result) {
  return shim_run("spectral_detrend", "(iKkiK)", simd, PTR(x),
                  (unsigned long)length, kind, PTR(result));
}

int spectral_welch(int simd, const float *x, size_t length, double fs,
                   size_t nperseg, long noverlap, double *freqs,
                   float *psd) {
  return shim_run("spectral_welch", "(iKkdklKK)", simd, PTR(x),
                  (unsigned long)length, fs, (unsigned long)nperseg,
                  noverlap, PTR(freqs), PTR(psd));
}

int spectral_periodogram(int simd, const float *x, size_t length,
                         double fs, double *freqs, float *psd) {
  return shim_run("spectral_periodogram", "(iKkdKK)", simd, PTR(x),
                  (unsigned long)length, fs, PTR(freqs), PTR(psd));
}

int spectral_csd(int simd, const float *x, const float *y, size_t length,
                 double fs, size_t nperseg, long noverlap, double *freqs,
                 float *pxy) {
  return shim_run("spectral_csd", "(iKKkdklKK)", simd, PTR(x), PTR(y),
                  (unsigned long)length, fs, (unsigned long)nperseg,
                  noverlap, PTR(freqs), PTR(pxy));
}

int spectral_coherence(int simd, const float *x, const float *y,
                       size_t length, double fs, size_t nperseg,
                       long noverlap, double *freqs, float *coh) {
  return shim_run("spectral_coherence", "(iKKkdklKK)", simd, PTR(x),
                  PTR(y), (unsigned long)length, fs,
                  (unsigned long)nperseg, noverlap, PTR(freqs),
                  PTR(coh));
}

int resample_poly(int simd, const float *x, size_t length, size_t up,
                  size_t down, const float *taps, size_t num_taps,
                  float *result) {
  return shim_run("resample_poly", "(iKkkkKkK)", simd, PTR(x),
                  (unsigned long)length, (unsigned long)up,
                  (unsigned long)down, PTR(taps), (unsigned long)num_taps,
                  PTR(result));
}

int resample_fourier(int simd, const float *x, size_t length, size_t num,
                     float *result) {
  return shim_run("resample_fourier", "(iKkkK)", simd, PTR(x),
                  (unsigned long)length, (unsigned long)num, PTR(result));
}

/* ---- iir -------------------------------------------------------------- */

int iir_butterworth(size_t order, double low, double high,
                    VelesIirBandType btype, double *sos) {
  long sections = -1;
  if (shim_call_parse("iir_butterworth", parse_long, &sections, "(kddiK)",
                      (unsigned long)order, low, high, (int)btype,
                      PTR(sos)) != 0) {
    return -1;
  }
  return (int)sections;
}

int iir_bessel(size_t order, double low, double high,
               VelesIirBandType btype, double *sos) {
  long sections = -1;
  if (shim_call_parse("iir_bessel", parse_long, &sections, "(kddiK)",
                      (unsigned long)order, low, high, (int)btype,
                      PTR(sos)) != 0) {
    return -1;
  }
  return (int)sections;
}

int iir_cheby1(size_t order, double rp, double low, double high,
               VelesIirBandType btype, double *sos) {
  long sections = -1;
  if (shim_call_parse("iir_cheby1", parse_long, &sections, "(kdddiK)",
                      (unsigned long)order, rp, low, high, (int)btype,
                      PTR(sos)) != 0) {
    return -1;
  }
  return (int)sections;
}

int iir_cheby2(size_t order, double rs, double low, double high,
               VelesIirBandType btype, double *sos) {
  long sections = -1;
  if (shim_call_parse("iir_cheby2", parse_long, &sections, "(kdddiK)",
                      (unsigned long)order, rs, low, high, (int)btype,
                      PTR(sos)) != 0) {
    return -1;
  }
  return (int)sections;
}

int iir_ellip(size_t order, double rp, double rs, double low, double high,
              VelesIirBandType btype, double *sos) {
  long sections = -1;
  if (shim_call_parse("iir_ellip", parse_long, &sections, "(kddddiK)",
                      (unsigned long)order, rp, rs, low, high, (int)btype,
                      PTR(sos)) != 0) {
    return -1;
  }
  return (int)sections;
}

static int iir_ord(const char *method, const double *wp, const double *ws,
                   size_t n_edges, double gpass, double gstop,
                   double *wn_out) {
  long order = -1;
  if (shim_call_parse("iir_ord", parse_long, &order, "(sKKkddK)", method,
                      PTR(wp), PTR(ws), (unsigned long)n_edges, gpass,
                      gstop, PTR(wn_out)) != 0) {
    return -1;
  }
  return (int)order;
}

int iir_buttord(const double *wp, const double *ws, size_t n_edges,
                double gpass, double gstop, double *wn_out) {
  return iir_ord("buttord", wp, ws, n_edges, gpass, gstop, wn_out);
}

int iir_cheb1ord(const double *wp, const double *ws, size_t n_edges,
                 double gpass, double gstop, double *wn_out) {
  return iir_ord("cheb1ord", wp, ws, n_edges, gpass, gstop, wn_out);
}

int iir_cheb2ord(const double *wp, const double *ws, size_t n_edges,
                 double gpass, double gstop, double *wn_out) {
  return iir_ord("cheb2ord", wp, ws, n_edges, gpass, gstop, wn_out);
}

int iir_ellipord(const double *wp, const double *ws, size_t n_edges,
                 double gpass, double gstop, double *wn_out) {
  return iir_ord("ellipord", wp, ws, n_edges, gpass, gstop, wn_out);
}

int iir_notch(double w0, double q, double *sos) {
  long sections = -1;
  if (shim_call_parse("iir_notch", parse_long, &sections, "(ddK)", w0, q,
                      PTR(sos)) != 0) {
    return -1;
  }
  return (int)sections;
}

int iir_peak(double w0, double q, double *sos) {
  long sections = -1;
  if (shim_call_parse("iir_peak", parse_long, &sections, "(ddK)", w0, q,
                      PTR(sos)) != 0) {
    return -1;
  }
  return (int)sections;
}

int iir_sosfilt_stream(int simd, const double *sos, size_t n_sections,
                       const float *x, size_t length, double *zi_inout,
                       float *result) {
  return shim_run("iir_sosfilt_stream", "(iKkKkKK)", simd, PTR(sos),
                  (unsigned long)n_sections, PTR(x),
                  (unsigned long)length, PTR(zi_inout), PTR(result));
}

int iir_sosfilt(int simd, const double *sos, size_t n_sections,
                const float *x, size_t length, const double *zi,
                float *result) {
  return shim_run("iir_sosfilt", "(iKkKkKK)", simd, PTR(sos),
                  (unsigned long)n_sections, PTR(x),
                  (unsigned long)length, PTR(zi), PTR(result));
}

int iir_sosfiltfilt(int simd, const double *sos, size_t n_sections,
                    const float *x, size_t length, long padlen,
                    float *result) {
  return shim_run("iir_sosfiltfilt", "(iKkKklK)", simd, PTR(sos),
                  (unsigned long)n_sections, PTR(x),
                  (unsigned long)length, padlen, PTR(result));
}

int iir_sosfilt_zi(const double *sos, size_t n_sections, double *zi_out) {
  return shim_run("iir_sosfilt_zi", "(KkK)", PTR(sos),
                  (unsigned long)n_sections, PTR(zi_out));
}

int iir_lfilter(int simd, const double *b, size_t nb, const double *a,
                size_t na, const float *x, size_t length, float *result) {
  return shim_run("iir_lfilter", "(iKkKkKkK)", simd, PTR(b),
                  (unsigned long)nb, PTR(a), (unsigned long)na, PTR(x),
                  (unsigned long)length, PTR(result));
}

/* ---- filters ---------------------------------------------------------- */

int filt_medfilt(int simd, const float *x, size_t length,
                 size_t kernel_size, float *result) {
  return shim_run("filt_medfilt", "(iKkkK)", simd, PTR(x),
                  (unsigned long)length, (unsigned long)kernel_size,
                  PTR(result));
}

int filt_order_filter(int simd, const float *x, size_t length,
                      size_t rank, size_t kernel_size, float *result) {
  return shim_run("filt_order_filter", "(iKkkkK)", simd, PTR(x),
                  (unsigned long)length, (unsigned long)rank,
                  (unsigned long)kernel_size, PTR(result));
}

int filt_medfilt2d(int simd, const float *img, size_t height,
                   size_t width, size_t kh, size_t kw, float *result) {
  return shim_run("filt_medfilt2d", "(iKkkkkK)", simd, PTR(img),
                  (unsigned long)height, (unsigned long)width,
                  (unsigned long)kh, (unsigned long)kw, PTR(result));
}

int filt_savgol(int simd, const float *x, size_t length,
                size_t window_length, size_t polyorder, size_t deriv,
                double delta, VelesSavgolMode mode, float *result) {
  return shim_run("filt_savgol", "(iKkkkkdiK)", simd, PTR(x),
                  (unsigned long)length, (unsigned long)window_length,
                  (unsigned long)polyorder, (unsigned long)deriv, delta,
                  (int)mode, PTR(result));
}

int filt_wiener(int simd, const float *x, size_t length, size_t mysize,
                double noise, float *result) {
  return shim_run("filt_wiener", "(iKkkdK)", simd, PTR(x),
                  (unsigned long)length, (unsigned long)mysize, noise,
                  PTR(result));
}

int filt_savgol_coeffs(size_t window_length, size_t polyorder,
                       size_t deriv, double delta, double *taps) {
  return shim_run("filt_savgol_coeffs", "(kkkdK)",
                  (unsigned long)window_length,
                  (unsigned long)polyorder, (unsigned long)deriv, delta,
                  PTR(taps));
}

int filt_firwin(size_t numtaps, const double *cutoffs, size_t n_cutoffs,
                int pass_zero, int window, double *taps) {
  return shim_run("filt_firwin", "(kKkiiK)", (unsigned long)numtaps,
                  PTR(cutoffs), (unsigned long)n_cutoffs, pass_zero,
                  window, PTR(taps));
}

int filt_firwin_w(size_t numtaps, const double *cutoffs,
                  size_t n_cutoffs, int pass_zero, int window,
                  double beta, double *taps) {
  return shim_run("filt_firwin_w", "(kKkiidK)", (unsigned long)numtaps,
                  PTR(cutoffs), (unsigned long)n_cutoffs, pass_zero,
                  window, beta, PTR(taps));
}

int filt_kaiserord(double ripple, double width, size_t *numtaps,
                   double *beta) {
  return shim_run("filt_kaiserord", "(ddKK)", ripple, width,
                  PTR(numtaps), PTR(beta));
}

int filt_firwin2(size_t numtaps, const double *freq, const double *gain,
                 size_t n_freq, size_t nfreqs, int window, double *taps) {
  return shim_run("filt_firwin2", "(kKKkkiK)", (unsigned long)numtaps,
                  PTR(freq), PTR(gain), (unsigned long)n_freq,
                  (unsigned long)nfreqs, window, PTR(taps));
}

int filt_remez(size_t numtaps, const double *bands, size_t n_bands,
               const double *desired, const double *weight, double fs,
               double *taps) {
  return shim_run("filt_remez", "(kKkKKdK)", (unsigned long)numtaps,
                  PTR(bands), (unsigned long)n_bands, PTR(desired),
                  PTR(weight), fs, PTR(taps));
}

/* ---- normalize -------------------------------------------------------- */

int normalize2D(int simd, const uint8_t *src, size_t src_stride,
                size_t width, size_t height, float *dst, size_t dst_stride) {
  return shim_run("normalize2D", "(iKkkkKk)", simd, PTR(src),
                  (unsigned long)src_stride, (unsigned long)width,
                  (unsigned long)height, PTR(dst),
                  (unsigned long)dst_stride);
}

static int parse_long_pair(PyObject *r, void *out) {
  long *pair = (long *)out;
  return PyArg_ParseTuple(r, "ll", &pair[0], &pair[1]) ? 0 : -1;
}

static int parse_double_pair(PyObject *r, void *out) {
  double *pair = (double *)out;
  return PyArg_ParseTuple(r, "dd", &pair[0], &pair[1]) ? 0 : -1;
}

int minmax2D(int simd, const uint8_t *src, size_t src_stride,
             size_t width, size_t height, uint8_t *min, uint8_t *max) {
  long pair[2];
  if (shim_call_parse("minmax2D", parse_long_pair, pair, "(iKkkk)", simd,
                      PTR(src), (unsigned long)src_stride,
                      (unsigned long)width, (unsigned long)height) != 0) {
    return -1;
  }
  if (min != NULL) {
    *min = (uint8_t)pair[0];
  }
  if (max != NULL) {
    *max = (uint8_t)pair[1];
  }
  return 0;
}

int minmax1D(int simd, const float *src, size_t length,
             float *min, float *max) {
  double pair[2];
  if (shim_call_parse("minmax1D", parse_double_pair, pair, "(iKk)", simd,
                      PTR(src), (unsigned long)length) != 0) {
    return -1;
  }
  if (min != NULL) {
    *min = (float)pair[0];
  }
  if (max != NULL) {
    *max = (float)pair[1];
  }
  return 0;
}

int normalize2D_minmax(int simd, uint8_t min, uint8_t max,
                       const uint8_t *src, size_t src_stride,
                       size_t width, size_t height,
                       float *dst, size_t dst_stride) {
  return shim_run("normalize2D_minmax", "(iiiKkkkKk)", simd, (int)min,
                  (int)max, PTR(src), (unsigned long)src_stride,
                  (unsigned long)width, (unsigned long)height, PTR(dst),
                  (unsigned long)dst_stride);
}

/* ---- detect_peaks ----------------------------------------------------- */

struct peaks_out {
  ExtremumPoint *pts;
  size_t n;
};

static int parse_peaks(PyObject *r, void *out) {
  struct peaks_out *po = (struct peaks_out *)out;
  PyObject *pos = NULL, *vals = NULL;
  if (!PyArg_ParseTuple(r, "OO", &pos, &vals)) {
    return -1;
  }
  Py_ssize_t n = PyList_Size(pos);
  if (n < 0) {
    return -1;
  }
  if (n == 0) {
    return 0; /* no peaks: NULL + 0, reference behavior */
  }
  ExtremumPoint *pts = malloc((size_t)n * sizeof(*pts));
  if (pts == NULL) {
    return -1;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    pts[i].position = (int)PyLong_AsLong(PyList_GetItem(pos, i));
    pts[i].value = (float)PyFloat_AsDouble(PyList_GetItem(vals, i));
  }
  if (PyErr_Occurred()) {
    free(pts);
    return -1;
  }
  po->pts = pts;
  po->n = (size_t)n;
  return 0;
}

int detect_peaks(int simd, const float *data, size_t size, ExtremumType type,
                 ExtremumPoint **results, size_t *results_length) {
  if (results == NULL || results_length == NULL) {
    return -1;
  }
  *results = NULL;
  *results_length = 0;
  struct peaks_out po = {NULL, 0};
  if (shim_call_parse("detect_peaks", parse_peaks, &po, "(iKki)", simd,
                      PTR(data), (unsigned long)size, (int)type) != 0) {
    return -1;
  }
  *results = po.pts;
  *results_length = po.n;
  return 0;
}

int peak_prominences(int simd, const float *x, size_t length,
                     const int64_t *peaks, size_t n_peaks,
                     float *prom_out) {
  return shim_run("peak_prominences", "(iKkKkK)", simd, PTR(x),
                  (unsigned long)length, PTR(peaks),
                  (unsigned long)n_peaks, PTR(prom_out));
}

int peak_widths(int simd, const float *x, size_t length,
                const int64_t *peaks, size_t n_peaks, double rel_height,
                float *widths, float *width_heights, float *left_ips,
                float *right_ips) {
  return shim_run("peak_widths", "(iKkKkdKKKK)", simd, PTR(x),
                  (unsigned long)length, PTR(peaks),
                  (unsigned long)n_peaks, rel_height, PTR(widths),
                  PTR(width_heights), PTR(left_ips), PTR(right_ips));
}

long find_peaks(int simd, const float *x, size_t length,
                double height_min, double height_max,
                double threshold_min, double threshold_max,
                size_t distance, double prom_min, double prom_max,
                int64_t *peaks_out, size_t max_out) {
  long count = -1;
  if (shim_call_parse("find_peaks", parse_long, &count, "(iKkddddkddKk)",
                      simd, PTR(x), (unsigned long)length, height_min,
                      height_max, threshold_min, threshold_max,
                      (unsigned long)distance, prom_min, prom_max,
                      PTR(peaks_out), (unsigned long)max_out) != 0) {
    return -1;
  }
  return count;
}

/* ---- conversions ------------------------------------------------------ */

static int convert(const char *name, int simd, const void *src, size_t length,
                   void *dst) {
  return shim_run("convert", "(siKkK)", name, simd, PTR(src),
                  (unsigned long)length, PTR(dst));
}

int int16_to_float(int simd, const int16_t *src, size_t length, float *dst) {
  return convert("int16_to_float", simd, src, length, dst);
}
int float_to_int16(int simd, const float *src, size_t length, int16_t *dst) {
  return convert("float_to_int16", simd, src, length, dst);
}
int int32_to_float(int simd, const int32_t *src, size_t length, float *dst) {
  return convert("int32_to_float", simd, src, length, dst);
}
int float_to_int32(int simd, const float *src, size_t length, int32_t *dst) {
  return convert("float_to_int32", simd, src, length, dst);
}
int int16_to_int32(int simd, const int16_t *src, size_t length,
                   int32_t *dst) {
  return convert("int16_to_int32", simd, src, length, dst);
}
int int32_to_int16(int simd, const int32_t *src, size_t length,
                   int16_t *dst) {
  return convert("int32_to_int16", simd, src, length, dst);
}
int float16_to_float(int simd, const uint16_t *src, size_t length,
                     float *dst) {
  return convert("float16_to_float", simd, src, length, dst);
}
