"""Hand-written CUDA kernels for Hopper, their wrappers and plain
versions (the port's counterpart of ``veles.simd_tpu.ops.
pallas_kernels``).

All five of the JAX package's Pallas kernels are ported here:

* :func:`overlap_save_cuda` (``csrc/overlap_save.cu``) replaces
  ``overlap_save_pallas``: the full linear convolution of every batch
  row with one filter, the overlap-save route of the convolve handles,
  as an FFT overlap-save (one block a segment of :func:`os_fft_length`
  samples, forward and inverse transform in shared memory).
* :func:`filter_bank_cuda` (``csrc/filter_bank.cu``) replaces
  ``filter_bank_pallas``: the multi-channel shifted-MAC FIR bank
  (``out[c][b, i] = sum_j f[c, j] x_ext[b, i*stride + j*dilation]``),
  the direct route of the convolve and correlate entry points and the
  ``cuda`` route of the DWT and SWT.  Unit stride and dilation from
  :data:`FB_MMA_MIN_K` taps on is a Toeplitz product on the tensor cores
  in split TF32 (the ``mma`` variant); the strided and dilated forms and
  shorter filters run an FFMA loop (``ffma``).
* :func:`cascade_bank_cuda` (``csrc/cascade_bank.cu``) replaces
  ``cascade_bank_pallas``: FIR channels at stride ``n_split`` over a
  runtime plan of (phase, offset) slots.  Its periodic form,
  :func:`cascade_bank_periodic_cuda`, is the fused PERIODIC DWT
  cascade: it reads the wrap of the unextended signal and writes each
  level's coefficients in natural order, so the route makes no copy.
* :func:`filter_2d_cuda` (``csrc/filter_2d.cu``) replaces
  ``filter_2d_pallas``: the 2D shifted-MAC correlation, the direct
  route of ``convolve2d`` and ``cross_correlate2d``, a persistent
  streaming kernel.
* :func:`stft_cuda` (``csrc/stft.cu``) replaces ``stft_pallas``: the
  windowed real-DFT STFT, a shared-memory FFT per frame over a span of
  frames staged once, the ``cuda_fused`` route of ``spectral.stft`` and
  ``batched.batched_stft``.

K1 and K4 share the block-level FFT of ``csrc/smem_fft.cuh``, with
twiddles from :func:`fft_twiddles`; K2 and K5 share the asynchronous
staging of ``csrc/async_copy.cuh`` and read their zero halo in the
kernel (``pad_left=``, ``pad=``), so their callers pad nothing.  Each
source note says what bounds its kernel on the H100 and what the design
does about it: every one is bound by its bytes.

Wrappers take float32 torch tensors.  On a CPU tensor a wrapper
computes the kernel's plain PyTorch version (:func:`overlap_save_plain`,
:func:`filter_bank_plain`, ...) — the tests' path.  On a CUDA tensor it
launches the kernel on the current stream, without synchronising, or
raises; nothing falls back.  Every launch adds one to
``LAUNCHES[<kernel>]``, and only a launch does.

The kernels are built at first use: one ``nvcc`` per source, all
started together, for ``sm_90a``, linked into one shared library with a
plain C interface and loaded with ``ctypes``.  The build lands in
``build/simd_tpu_torch/<hash of sources and flags>/`` under the
checkout (listed in ``.gitignore``), so a changed source rebuilds and an
unchanged one is reused within a checkout.  ``$CUDA_HOME`` (default
``/usr/local/cuda``) or ``nvcc`` on ``$PATH`` names the compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.utils.cache import ConstantCache

__all__ = [
    "overlap_save_cuda", "overlap_save_plain",
    "filter_bank_cuda", "filter_bank_plain",
    "cascade_bank_cuda", "cascade_bank_plain",
    "cascade_bank_periodic_cuda", "cascade_bank_periodic_plain",
    "filter_2d_cuda", "filter_2d_plain",
    "stft_cuda", "stft_plain", "stft_basis", "fft_twiddles",
    "fb_smem_bytes", "fits_smem_fb", "fb_variant",
    "os_fft_length", "os_step", "os_smem_bytes", "fits_smem_os",
    "cb_phase_pad", "cb_tile", "cb_smem_bytes", "fits_smem_cb",
    "f2d_smem_bytes", "fits_smem_f2d",
    "stft_fft_length", "stft_frames_per_block", "stft_smem_bytes",
    "fits_smem_stft",
    "should_route", "on_card",
    "LAUNCHES", "reset_launches", "load_library", "build_log",
    "OS_MIN_H", "DIRECT_MAX_H", "MIN_ROWS", "MAX_AREA_2D", "OS_MAX_FFT",
    "FB_TILE", "FB_MMA_TILE", "FB_MMA_MIN_K", "CB_MAX_SPLIT", "F2D_TILE",
    "STFT_MIN_FRAMES",
    "STFT_DISABLE_ENV", "SMEM_MAX_BYTES",
]

# ---- admission constants ---------------------------------------------------
# The shape terms of the JAX gates stay as static priors, so routing
# matches the reference; none has been measured on the H100 yet.
# PALLAS_MIN_ROWS: below 8 batch rows the direct route stays on conv1d
MIN_ROWS = 8
# PALLAS_DIRECT_MAX_H: the direct kernel serves filters up to 256 taps
DIRECT_MAX_H = 256
# PALLAS_OS_MIN_H: the fused overlap-save kernel serves 256 taps and up
OS_MIN_H = 256
# PALLAS_2D_MAX_KERNEL_AREA: the 2D kernel serves kernels up to 16 x 16
MAX_AREA_2D = 256
# PALLAS_STFT_MIN_FRAMES: below 64 frames the STFT stays on the basis
# matmul, where the frames tensor is small traffic anyway
STFT_MIN_FRAMES = 64
# the fused STFT route's opt-out (VELES_SIMD_DISABLE_STFT_PALLAS there)
STFT_DISABLE_ENV = "VELES_SIMD_DISABLE_STFT_CUDA"

# Tile geometry of the kernels.  The loader checks these mirrors
# against the built library (veles_*_tile, veles_*_smem_bytes, ...), so
# the admission arithmetic below cannot drift from csrc/.
_R = 13
FB_TILE = 128 * _R                    # outputs of an ffma block
FB_MMA_TILE = 64 * 32                 # outputs of an mma block tile
# unit-stride filters of at least this many taps take the mma variant
# (MMA_MIN_K in csrc/filter_bank.cu): the least tap count of
# chip_smoke.py's k-sweep at which it ran ahead of the ffma loop at 512 x
# 16,384 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, 2026-10-17)
FB_MMA_MIN_K = 160
# the cascade bank's phases a frame: n_split up to 32
CB_MAX_SPLIT = 32
_CB_WARPS, _CB_STAGES = 4, 2           # warps a block, staged spans a warp
_CB_R = 4                              # output indices a lane owns (at most)
F2D_TILE = (8 * 8, 16 * 4)            # (rows, columns) of outputs
# shared memory a block may use on Hopper (227 KB, opt-in above 48 KB)
SMEM_MAX_BYTES = 232448
# the block-level FFT (csrc/smem_fft.cuh): 512 threads, at most 32
# values a thread per stage, transforms padded by one float2 in 16
_FFT_THREADS = 512
_FFT_VPT_MAX = 32


def _fft_padded(m: int) -> int:
    """float2 slots of one padded transform of ``m`` values
    (``padded`` in csrc/smem_fft.cuh)."""
    return m + (m >> 4) + 1


# overlap-save segments: powers of two from 4096 (the shortest the
# block FFT takes) to 32768 samples; a long row takes 8192 and up
_OS_MIN_FFT = 4096
_OS_LONG_FFT = 8192
OS_MAX_FFT = 32768


def os_fft_length(h_length: int, n: int) -> int:
    """Segment length N of the overlap-save kernel for a ``h_length``-tap
    filter over rows of ``n`` samples (``fft_length`` in
    csrc/overlap_save.cu): the least power of two >= 4096 and >= 2
    h_length that also holds 8192 samples or, if shorter, the row's
    whole output of n + h_length - 1, so a short row pays one short
    transform.  A segment gives :func:`os_step` outputs.  Above 16384
    taps N exceeds OS_MAX_FFT and :func:`fits_smem_os` refuses the
    filter."""
    k = int(h_length)
    want = min(_OS_LONG_FFT, int(n) + k - 1)
    N = _OS_MIN_FFT
    while N < 2 * k or N < want:
        N *= 2
    return N


def os_step(h_length: int, n: int) -> int:
    """Outputs of one overlap-save segment: N - h_length + 1."""
    return os_fft_length(h_length, n) - int(h_length) + 1


def os_smem_bytes(fft_length: int) -> int:
    """Dynamic shared memory of one overlap-save block: N/2 packed
    complex values, padded (``smem_bytes`` in csrc/overlap_save.cu)."""
    return 8 * _fft_padded(int(fft_length) // 2)


def fits_smem_os(h_length: int) -> bool:
    """Admission of the overlap-save kernel: 2 <= h_length and its
    longest segment (the one of a long row) fits one block (N <=
    32768, 139 KB at the most), which holds for every filter of
    2..16384 taps."""
    k = int(h_length)
    if k < 2:
        return False
    N = os_fft_length(k, _OS_LONG_FFT)
    return N <= OS_MAX_FFT and os_smem_bytes(N) <= SMEM_MAX_BYTES


def fb_variant(order: int, stride: int, dilation: int) -> str:
    """The filter-bank variant ``veles_fb_f32`` picks: ``"mma"`` (the
    tensor-core Toeplitz product) for unit stride and dilation with at
    least FB_MMA_MIN_K taps, else ``"ffma"``."""
    if int(stride) == 1 and int(dilation) == 1 \
            and int(order) >= FB_MMA_MIN_K:
        return "mma"
    return "ffma"


def _mma_steps(order: int) -> int:
    """k-steps of the mma variant's wgmma.m64n32k8 product: ceil((order
    + 31) / 8)."""
    return (int(order) + 31 + 7) // 8


def fb_smem_bytes(channels: int, order: int, stride: int,
                  dilation: int, variant: str | None = None) -> int:
    """Dynamic shared memory of one filter-bank block (``smem_bytes`` in
    csrc/filter_bank.cu).  ``mma``: per channel the hi and lo B blocks
    (steps + 3 of 64 floats each), then two raw spans and the hi and lo
    parts of one (FB_MMA_TILE - 32 + 8 steps samples, rounded up to 32),
    and the output tile.  ``ffma``: the input span of FB_TILE outputs, the
    [channels, order] taps (padded to a multiple of 13 on the
    unit-stride path) and the output tile.  ``variant`` None is the one
    :func:`fb_variant` picks."""
    channels, order = int(channels), int(order)
    stride, dilation = int(stride), int(dilation)
    unit = stride == 1 and dilation == 1
    if variant is None:
        variant = fb_variant(order, stride, dilation)
    if variant == "mma" and unit:
        steps = _mma_steps(order)
        span = -(-(FB_MMA_TILE - 32 + 8 * steps) // 32) * 32
        return (4 * channels * 2 * (steps + 3) * 64 + 16 * span
                + 4 * FB_MMA_TILE)
    if unit:
        order_pad = -(-order // _R) * _R
        span = FB_TILE + order_pad - 1
    else:
        order_pad = order
        span = (FB_TILE - 1) * stride + (order - 1) * dilation + 1
    return 4 * (span + channels * order_pad + FB_TILE)


def fits_smem_fb(channels: int, order: int, stride: int,
                 dilation: int, variant: str | None = None) -> bool:
    """Shared-memory admission of the filter-bank kernel."""
    return fb_smem_bytes(channels, order, stride, dilation,
                         variant) <= SMEM_MAX_BYTES


def cb_phase_pad(n_split: int) -> int:
    """Phases a cascade-bank frame holds in registers: the least of 4,
    8, 16, 32 that is >= ``n_split``, 0 above CB_MAX_SPLIT
    (``phase_pad`` in csrc/cascade_bank.cu).  A pass of the kernel
    computes this many channels."""
    n_split = int(n_split)
    if not 1 <= n_split <= CB_MAX_SPLIT:
        return 0
    p = 4
    while p < n_split:
        p *= 2
    return p


def cb_tile(n_split: int) -> int:
    """Output indices of a cascade-bank warp tile: 32 lanes of
    ``min(4, 32 / NSP)`` consecutive indices, NSP = :func:`cb_phase_pad`
    (``tile_of``)."""
    nsp = cb_phase_pad(n_split)
    return 32 * min(_CB_R, 32 // nsp) if nsp else 0


def cb_smem_bytes(n_split: int, max_off: int, channels: int) -> int:
    """Dynamic shared memory of one cascade-bank block (``smem_bytes``
    in csrc/cascade_bank.cu): the dense tap table, NSP =
    :func:`cb_phase_pad` channels by NSP phases a pass and offset, and
    one word of channel bits a pass and offset (rounded up to 4), then
    two staged spans a warp, each the tile's frames and ``max_off``
    more and the one prefetched, rounded up to 4 floats, with 4 floats
    of padding after every 32; beyond SMEM_MAX_BYTES where the kernel
    takes no such ``n_split``."""
    n_split, max_off, channels = int(n_split), int(max_off), int(channels)
    nsp = cb_phase_pad(n_split)
    if not nsp or max_off < 0 or channels < 1:
        return SMEM_MAX_BYTES + 1
    cells = -(-channels // nsp) * (max_off + 1)
    table = cells * nsp * nsp + -(-cells // 4) * 4
    span = -(-(cb_tile(n_split) + max_off + 1) * n_split // 4) * 4
    return 4 * (table + _CB_WARPS * _CB_STAGES
                * (span + 4 * (-(-span // 32))))


def fits_smem_cb(n_split: int, max_off: int, channels: int) -> bool:
    """Admission of the cascade-bank kernel: ``n_split`` <= 32 and a
    block's tap table and staged spans fit shared memory (the fused
    cascade's 2^L channels fit at every offset its gate admits)."""
    return cb_smem_bytes(n_split, max_off, channels) <= SMEM_MAX_BYTES


def f2d_smem_bytes(k0: int, k1: int) -> int:
    """Dynamic shared memory of one 2D block: the taps (rows padded to
    a multiple of 4) and two staged input tiles with their halo,
    ``(F2D_TILE[0] + k0 - 1) x (F2D_TILE[1] + k1 rounded up to 4)``
    (``smem_bytes`` in csrc/filter_2d.cu)."""
    k0, k1 = int(k0), int(k1)
    k1_pad = -(-k1 // 4) * 4
    rows = F2D_TILE[0] + k0 - 1
    cols = F2D_TILE[1] + k1_pad
    return 4 * (k0 * k1_pad + 2 * rows * cols)


def fits_smem_f2d(k0: int, k1: int) -> bool:
    """Shared-memory admission of the 2D kernel (every kernel of area
    <= MAX_AREA_2D fits: 256 x 1 needs the most, 177,632 bytes)."""
    return f2d_smem_bytes(k0, k1) <= SMEM_MAX_BYTES


def stft_fft_length(frame_length: int) -> int:
    """FFT length of one STFT frame: L/2 for an even L (real-packed),
    L for an odd L (the complex path)."""
    L = int(frame_length)
    return L // 2 if L % 2 == 0 else L


def stft_frames_per_block(frame_length: int) -> int:
    """Frames one STFT block transforms, one per group of threads: a
    group is the least power of two >= M / 8 threads, from a warp to
    the whole block (``frames_per_block`` in csrc/stft.cu), so 16
    frames at L = 512 and one from L = 8192 on."""
    m, g = stft_fft_length(frame_length), 32
    while g < _FFT_THREADS and 8 * g < m:
        g *= 2
    return _FFT_THREADS // g


def stft_smem_bytes(frame_length: int, hop: int) -> int:
    """Dynamic shared memory of one STFT block: the staged span of its
    frames, ``(F - 1) * hop + L`` floats rounded up to 16 bytes, and F
    padded FFT buffers (``smem_bytes`` in csrc/stft.cu)."""
    L, hop = int(frame_length), int(hop)
    f = stft_frames_per_block(L)
    span = -(-((f - 1) * hop + L) // 4) * 4
    return 4 * span + 8 * f * _fft_padded(stft_fft_length(L))


def fits_smem_stft(frame_length: int, hop: int) -> bool:
    """Admission of the STFT kernel: a geometry of its contract (hop |
    L, L > hop) whose block fits the block-level FFT (F * M <= 512 *
    32 values) and shared memory.  Every L <= 16384 fits (135 KB at
    16384/128, 204 KB at 16383/43)."""
    L, hop = int(frame_length), int(hop)
    if L < 2 or hop < 1 or L % hop or L <= hop:
        return False
    vals = stft_frames_per_block(L) * stft_fft_length(L)
    return (vals <= _FFT_THREADS * _FFT_VPT_MAX
            and stft_smem_bytes(L, hop) <= SMEM_MAX_BYTES)


def on_card(cuda: bool) -> bool:
    """The device term of the fused STFT route: the operand lies on a
    CUDA card (the JAX package's ``pallas_available``).  Tests
    monkeypatch it to open the gate on the CPU."""
    return bool(cuda)


def should_route(rows: int, cuda: bool) -> bool:
    """The device terms the 1D wavelet routes share: operands on a CUDA
    card and at least MIN_ROWS batch rows (the JAX package's
    ``should_route``, whose VMEM term becomes each route's own
    shared-memory admission here).  Tests monkeypatch it to open the
    gates on the CPU."""
    return bool(cuda) and int(rows) >= MIN_ROWS


# ---- launch counters -------------------------------------------------------

LAUNCHES = {"overlap_save": 0, "filter_bank": 0, "cascade_bank": 0,
            "filter_2d": 0, "stft": 0}

# the y and z grid dimensions stop at 65535, so each kernel's C entry
# point launches once per 65535 rows (images for the 2D kernel)
_MAX_GRID_ROWS = 65535


def _launches(rows: int) -> int:
    """Kernel launches one C entry-point call makes for ``rows`` rows."""
    return -(-int(rows) // _MAX_GRID_ROWS)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---- the built library -----------------------------------------------------

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("overlap_save.cu", "filter_bank.cu", "cascade_bank.cu",
            "filter_2d.cu", "stft.cu")
_HEADERS = ("smem_fft.cuh", "async_copy.cuh")
_BUILD_ROOT = (Path(__file__).resolve().parents[3] / "build"
               / "simd_tpu_torch")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB_NAME = "libveles_simd_torch.so"

_lib = None
_lib_lock = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found ($CUDA_HOME/bin or $PATH): the "
                       "CUDA kernels are built on first use")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    """Compile every source in parallel, link one shared library."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objs, procs = [], []
    for name in _SOURCES:
        obj = out_dir / f"{name}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-c", str(_CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for name, proc in zip(_SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(f"== {name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = out_dir / f"{_LIB_NAME}.{tag}"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                           f"{link.stderr}")
    for obj in objs:
        obj.unlink()
    (out_dir / "build.log").write_text(log)
    lib = out_dir / _LIB_NAME
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
    return lib


def build_log() -> str:
    """nvcc's output for the current sources (``-Xptxas -v``: each
    kernel's registers, shared memory and spills); builds if needed."""
    load_library()
    return (_build_dir() / "build.log").read_text()


def load_library():
    """The kernels' shared library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        out_dir = _build_dir()
        path = out_dir / _LIB_NAME
        if not path.exists():
            path = _build(out_dir)
        lib = ctypes.CDLL(str(path))
        lib.veles_os_fft_length.argtypes = [_I, _L]
        lib.veles_os_fft_length.restype = _I
        lib.veles_os_smem_bytes.argtypes = [_I]
        lib.veles_os_smem_bytes.restype = _L
        for name in ("veles_fb_tile", "veles_fb_mma_tile",
                     "veles_fb_mma_min_k"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = _I
        lib.veles_fb_variant.argtypes = [_I, _I, _I]
        lib.veles_fb_variant.restype = _I
        lib.veles_fb_smem_bytes.argtypes = [_I, _I, _I, _I, _I]
        lib.veles_fb_smem_bytes.restype = _L
        lib.veles_cuda_error_string.argtypes = [_I]
        lib.veles_cuda_error_string.restype = ctypes.c_char_p
        lib.veles_os_conv_f32.argtypes = [_P, _P, _P, _P, _P, _L, _L, _I,
                                          _P]
        lib.veles_os_conv_f32.restype = _I
        lib.veles_fb_f32.argtypes = [_P, _P, _P, _L, _L, _I, _I, _I, _I,
                                     _L, _L, _I, _I, _P]
        lib.veles_fb_f32.restype = _I
        for name in ("veles_f2d_tile_x", "veles_f2d_tile_y"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = _I
        for name in ("veles_cb_phase_pad", "veles_cb_tile"):
            getattr(lib, name).argtypes = [_I]
            getattr(lib, name).restype = _I
        lib.veles_cb_smem_bytes.argtypes = [_I, _I, _I]
        lib.veles_cb_smem_bytes.restype = _L
        lib.veles_f2d_smem_bytes.argtypes = [_I, _I]
        lib.veles_f2d_smem_bytes.restype = _L
        # blocks a persistent kernel keeps resident on one SM (needs a card)
        for name in ("veles_fb_mma_resident", "veles_f2d_resident"):
            getattr(lib, name).argtypes = [_I, _I]
            getattr(lib, name).restype = _I
        lib.veles_cb_f32.argtypes = [_P, _P, _P, _P, _L, _L, _I, _I, _I,
                                     _L, _I, _P]
        lib.veles_cb_f32.restype = _I
        lib.veles_f2d_f32.argtypes = [_P, _P, _P, _L, _L, _L, _I, _I, _L,
                                      _L, _L, _L, _I, _P]
        lib.veles_f2d_f32.restype = _I
        lib.veles_stft_frames_per_block.argtypes = [_I]
        lib.veles_stft_frames_per_block.restype = _I
        lib.veles_stft_smem_bytes.argtypes = [_I, _I]
        lib.veles_stft_smem_bytes.restype = _L
        lib.veles_stft_f32.argtypes = [_P, _P, _P, _P, _L, _L, _I, _I, _L,
                                       _P]
        lib.veles_stft_f32.restype = _I
        if (any(lib.veles_os_fft_length(k, n) != os_fft_length(k, n)
                or lib.veles_os_smem_bytes(os_fft_length(k, n))
                != os_smem_bytes(os_fft_length(k, n))
                for k, n in ((2, 1), (256, 1000), (256, 1 << 20),
                             (2047, 2050), (2049, 5), (16384, 50000)))
                or (lib.veles_fb_tile(), lib.veles_fb_mma_tile(),
                    lib.veles_fb_mma_min_k())
                != (FB_TILE, FB_MMA_TILE, FB_MMA_MIN_K)
                or any(_VARIANT_CODE[fb_variant(*a[1:])]
                       != lib.veles_fb_variant(*a[1:])
                       or any(lib.veles_fb_smem_bytes(*a, _VARIANT_CODE[v])
                              != fb_smem_bytes(*a, v)
                              for v in ("ffma", "mma"))
                       for a in ((2, 8, 2, 1), (2, 8, 1, 4), (1, 1, 1, 1),
                                 (1, 15, 1, 1), (1, 16, 1, 1),
                                 (1, 129, 1, 1), (3, 256, 1, 1),
                                 (2, 33, 1, 1)))
                or any(lib.veles_cb_phase_pad(ns) != cb_phase_pad(ns)
                       or lib.veles_cb_tile(ns) != cb_tile(ns)
                       for ns in (0, 1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33))
                or any(lib.veles_cb_smem_bytes(*a) != cb_smem_bytes(*a)
                       for a in ((8, 6, 8), (4, 3, 9), (3, 2, 2),
                                 (16, 14, 16), (32, 0, 33), (1, 700, 1),
                                 (33, 1, 1), (8, 2000, 8), (8, 6, 0)))
                or (lib.veles_f2d_tile_y(), lib.veles_f2d_tile_x())
                != F2D_TILE
                or any(lib.veles_f2d_smem_bytes(*a) != f2d_smem_bytes(*a)
                       for a in ((7, 7), (1, 256), (256, 1), (5, 3)))
                or any(lib.veles_stft_frames_per_block(a[0])
                       != stft_frames_per_block(a[0])
                       or lib.veles_stft_smem_bytes(*a) != stft_smem_bytes(*a)
                       for a in ((512, 128), (255, 85), (384, 128),
                                 (16384, 128), (4096, 2048)))):
            raise RuntimeError("csrc/ tile geometry differs from the "
                               "admission constants in cuda_kernels.py")
        _lib = lib
        return lib


# variant names and their codes in veles_fb_f32 (0 picks by FB_MMA_MIN_K)
_VARIANT_CODE = {None: 0, "ffma": 1, "mma": 2}


def _check_err(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.veles_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _check_operands(*tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"float32 operands only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


# ---- K1: overlap-save convolution ------------------------------------------

def overlap_save_plain(x, taps):
    """Plain version of :func:`overlap_save_cuda`: ``y[..., t] =
    sum_j taps[j] * x[..., t - j]``, one multiply-add pass over the
    signal per tap (the direct form; the kernel's FFT agrees within
    1e-5 of max|y|).  Float64 operands accumulate in float64: the
    reference that holds the kernel at long filters."""
    n, k = x.shape[-1], taps.shape[-1]
    y = x.new_zeros(tuple(x.shape[:-1]) + (n + k - 1,))
    for j in range(k):
        y[..., j:j + n].addcmul_(x, taps[j])
    return y


def overlap_save_cuda(x, taps):
    """Full linear convolution ``y[..., n+k-1] = x * taps`` (float32).

    ``taps`` is 1D in CONVOLUTION orientation (callers flip for
    correlation) with at least 2 taps, the contract of the JAX
    package's ``overlap_save_pallas``; leading batch dims of ``x`` ride
    along, each row with zero history.  A CPU tensor takes the plain
    version; a CUDA tensor launches ``csrc/overlap_save.cu`` with
    segments of :func:`os_fft_length` samples: the taps' spectrum, then
    the segments (``LAUNCHES["overlap_save"]`` counts both)."""
    if taps.ndim != 1:
        raise ValueError("taps must be 1D")
    k = int(taps.shape[-1])
    if k < 2:
        raise ValueError("overlap-save needs >= 2 taps (no halo at "
                         "k=1; use the direct path)")
    _check_operands(x, taps)
    if x.device.type == "cpu":
        return overlap_save_plain(x, taps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not fits_smem_os(k):
        raise ValueError(f"overlap-save kernel takes 2..{OS_MAX_FFT // 2} "
                         f"taps, got {k}")
    n = int(x.shape[-1])
    rows = x.numel() // n
    y = torch.empty(tuple(x.shape[:-1]) + (n + k - 1,),
                    dtype=torch.float32, device=x.device)
    if rows == 0:
        return y
    N = os_fft_length(k, n)
    spec = torch.empty(N + 2, dtype=torch.float32, device=x.device)
    tw = _device_twiddles(N, x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.veles_os_conv_f32(x.data_ptr(), taps.data_ptr(),
                                    spec.data_ptr(), tw.data_ptr(),
                                    y.data_ptr(), rows, n, k, stream)
    _check_err(lib, err, "overlap_save kernel")
    LAUNCHES["overlap_save"] += 1 + _launches(rows)
    return y


# ---- K2: shifted-MAC filter bank -------------------------------------------

def filter_bank_plain(x_ext, filters, stride, dilation, n_out,
                      pad_left=0, reverse_taps=False):
    """Plain version of :func:`filter_bank_cuda`: ``F.pad`` and ``flip``
    for the padding and the reversal, then one multiply-add pass per
    (channel, tap) over the strided input slice.  Float64 operands
    accumulate in float64: the reference that holds the mma variant."""
    if pad_left:
        x_ext = torch.nn.functional.pad(x_ext, (pad_left, pad_left))
    if reverse_taps:
        filters = filters.flip(-1)
    outs = []
    span = (n_out - 1) * stride + 1
    for c in range(filters.shape[0]):
        o = x_ext.new_zeros(tuple(x_ext.shape[:-1]) + (n_out,))
        for j in range(filters.shape[1]):
            s = j * dilation
            o.addcmul_(x_ext[..., s:s + span:stride], filters[c, j])
        outs.append(o)
    return tuple(outs)


def filter_bank_cuda(x, filters, stride, dilation, n_out, *, pad_left=0,
                     reverse_taps=False, variant=None):
    """Multi-channel FIR filter bank (float32): returns a tuple of C
    tensors ``[..., n_out]`` with ``out[c][..., i] = sum_j filters[c,
    j] * x_ext[..., i*stride + j*dilation]`` — the contract of the JAX
    package's ``filter_bank_pallas`` — where ``x_ext`` is ``x``
    zero-padded by ``pad_left`` samples on each side (the kernel reads
    the halo as zeros; ``pad_left=0`` passes an extended ``x_ext`` as
    it is) and the taps are read reversed if ``reverse_taps``.  A CPU
    tensor takes the plain version; a CUDA tensor launches
    ``csrc/filter_bank.cu``, whose variant :func:`fb_variant` picks, or
    ``variant`` (``"mma"``, unit stride and dilation only, or
    ``"ffma"``) when the caller measures one against the other."""
    if filters.ndim != 2:
        raise ValueError("filters must be [channels, order]")
    stride, dilation, n_out = int(stride), int(dilation), int(n_out)
    pad_left = int(pad_left)
    if stride < 1 or dilation < 1 or n_out < 1:
        raise ValueError("stride, dilation and n_out must be >= 1")
    if pad_left < 0:
        raise ValueError(f"pad_left must be >= 0, got {pad_left}")
    if variant not in (None, "ffma", "mma"):
        raise ValueError(f"variant must be 'ffma' or 'mma', got "
                         f"{variant!r}")
    unit = stride == 1 and dilation == 1
    if variant == "mma" and not unit:
        raise ValueError("the mma variant takes stride 1, dilation 1")
    channels, order = int(filters.shape[0]), int(filters.shape[1])
    need = (n_out - 1) * stride + (order - 1) * dilation + 1
    if x.shape[-1] + 2 * pad_left < need:
        raise ValueError(
            f"x_ext too short: {x.shape[-1]} + 2 * {pad_left} < {need} "
            f"for n_out={n_out}, stride={stride}, dilation={dilation}")
    _check_operands(x, filters)
    if x.device.type == "cpu":
        return filter_bank_plain(x, filters, stride, dilation, n_out,
                                 pad_left, reverse_taps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    variant = variant or fb_variant(order, stride, dilation)
    if not fits_smem_fb(channels, order, stride, dilation, variant):
        raise ValueError(
            f"filter bank of {channels}x{order} taps at stride {stride}, "
            f"dilation {dilation} needs "
            f"{fb_smem_bytes(channels, order, stride, dilation, variant)} "
            f"bytes of shared memory per block (> {SMEM_MAX_BYTES})")
    n = int(x.shape[-1])
    rows = x.numel() // max(n, 1)
    out = torch.empty((channels, rows, n_out), dtype=torch.float32,
                      device=x.device)
    shape = tuple(x.shape[:-1]) + (n_out,)
    if rows == 0:
        return tuple(o.reshape(shape) for o in out)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.veles_fb_f32(x.data_ptr(), filters.data_ptr(),
                               out.data_ptr(), rows, n, channels, order,
                               stride, dilation, n_out, pad_left,
                               int(bool(reverse_taps)),
                               _VARIANT_CODE[variant], stream)
    _check_err(lib, err, "filter_bank kernel")
    # the mma variant is one persistent grid; ffma splits rows by 65535
    LAUNCHES["filter_bank"] += 1 if variant == "mma" else _launches(rows)
    return tuple(o.reshape(shape) for o in out)


# ---- K3: cascade bank ------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _plan_info(plans, n_split):
    """What a plan tells the kernel, derived once per (plans, n_split):
    ``(plans, need_extra, max_off, index, bits)``.  ``x_ext`` must hold
    ``(n_out - 1) * n_split + need_extra`` samples (the JAX package's
    per-phase slice lengths: ``n_out`` plus the phase's largest offset).
    ``index`` places each slot's tap in the dense table
    ``W[pass, offset, channel of the pass, phase]`` of NSP =
    :func:`cb_phase_pad` channels and phases, and ``bits`` (uint32
    ``[passes, max_off + 1]``) has bit c set where channel c of the
    pass has a slot at that offset: the layout ``veles_cb_f32`` reads.
    Raises the plan errors of the JAX package's
    ``cascade_bank_pallas``."""
    plans = tuple(tuple((int(p), int(o)) for p, o in plan)
                  for plan in plans)
    phase_off = [0] * n_split
    for plan in plans:
        if len(plan) == 0:
            raise ValueError("every plan channel needs >= 1 slot")
        for p, o in plan:
            if not 0 <= p < n_split or o < 0:
                raise ValueError(
                    f"plan slot (phase={p}, offset={o}) outside "
                    f"[0, {n_split}) x [0, inf)")
            phase_off[p] = max(phase_off[p], o)
    need_extra = max(p + o * n_split + 1 for p, o in enumerate(phase_off))
    max_off = max(phase_off)
    # the table of a plan the kernel does not take is never built
    nsp = cb_phase_pad(n_split) or 4
    passes = -(-len(plans) // nsp)
    index = []
    bits = np.zeros((passes, max_off + 1), np.uint32)
    for c, plan in enumerate(plans):
        k, cl = divmod(c, nsp)
        for p, o in plan:
            index.append(((k * (max_off + 1) + o) * nsp + cl) * nsp + p)
            bits[k, o] |= np.uint32(1 << cl)
    return plans, need_extra, max_off, np.asarray(index, np.int64), bits


def _check_plan(taps_list, plans, n_split):
    """The plan checks of ``cascade_bank_pallas``, with its messages;
    returns :func:`_plan_info` of the plan."""
    try:
        info = _plan_info(plans, n_split)
    except TypeError:                 # unhashable: lists, arrays
        info = _plan_info(tuple(tuple((int(p), int(o)) for p, o in plan)
                                for plan in plans), n_split)
    if len(taps_list) != len(info[0]):
        raise ValueError("one tap vector per plan channel")
    for t, plan in zip(taps_list, info[0]):
        if tuple(t.shape if isinstance(t, torch.Tensor)
                 else np.shape(t)) != (len(plan),):
            raise ValueError("tap vector length must equal its plan's "
                             "slot count")
    return info


def _flat_taps(taps_list, device):
    """The per-channel taps as one float32 vector on ``device``."""
    if any(isinstance(t, torch.Tensor) for t in taps_list):
        return torch.cat([torch.as_tensor(t, dtype=torch.float32,
                                          device=device).reshape(-1)
                          for t in taps_list])
    flat = np.concatenate([np.asarray(t, np.float32).reshape(-1)
                           for t in taps_list])
    return torch.as_tensor(flat, device=device)


def cascade_bank_plain(x_ext, taps_list, plans, n_split, n_out):
    """Plain version of :func:`cascade_bank_cuda`: one multiply-add pass
    per plan slot over the stride-``n_split`` input slice.  Float64
    operands accumulate in float64: the reference that holds the
    kernel."""
    taps = _flat_taps(taps_list, x_ext.device).to(x_ext.dtype)
    span = (n_out - 1) * n_split + 1
    outs, s = [], 0
    for plan in plans:
        o = x_ext.new_zeros(tuple(x_ext.shape[:-1]) + (n_out,))
        for p, off in plan:
            start = off * n_split + p
            o.addcmul_(x_ext[..., start:start + span:n_split], taps[s])
            s += 1
        outs.append(o)
    return tuple(outs)


def _periodic_args(x, taps_list, plans, levels):
    """The checks of the periodic form; returns ``(n_split, n_out,
    info)``."""
    levels = int(levels)
    if not 2 <= levels <= 4:
        raise ValueError(f"the periodic cascade bank takes 2..4 levels, "
                         f"got {levels}")
    n_split = 1 << levels
    info = _check_plan(taps_list, plans, n_split)
    if len(info[0]) != n_split:
        raise ValueError(f"the periodic cascade bank takes the cascade's "
                         f"{n_split} channels, got {len(info[0])}")
    n = int(x.shape[-1])
    if n < n_split or n % n_split:
        raise ValueError(f"signal length {n} is no positive multiple of "
                         f"{n_split}")
    return n_split, n // n_split, info


def cascade_bank_periodic_plain(x, taps_list, plans, levels):
    """Plain version of :func:`cascade_bank_periodic_cuda`: the wrap as
    an index gather, :func:`cascade_bank_plain`, then each level's
    phase channels interleaved back to natural order."""
    n_split, n_out, info = _periodic_args(x, taps_list, plans, levels)
    n = int(x.shape[-1])
    need = (n_out - 1) * n_split + info[1]
    idx = torch.arange(need, device=x.device) % n
    outs = cascade_bank_plain(x.index_select(-1, idx), taps_list, info[0],
                              n_split, n_out)
    coeffs, c = [], 0
    for lvl in range(1, int(levels) + 1):
        phases = outs[c:c + (n_split >> lvl)]
        c += n_split >> lvl
        coeffs.append(torch.stack(phases, -1).reshape(
            tuple(x.shape[:-1]) + (n >> lvl,)))
    coeffs.append(outs[-1])
    return tuple(coeffs)


# device copies of the plans' tap tables and bits (the table also per
# tap values when they come from the host), so a repeated call makes no
# host-to-device copy: key -> (table or None, bits, index)
_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 64
_plan_lock = threading.Lock()


def _plan_arrays(taps_list, info, n_split, device):
    """``(table, bits)`` on ``device``: the float32 dense tap table and
    the uint32 slot bits of :func:`_plan_info`; cached per plan (and
    per tap values when they come from the host, else the table is
    scattered from the taps on the device)."""
    plans, _, max_off, index, bits = info
    host_taps = not any(isinstance(t, torch.Tensor) for t in taps_list)
    key = (plans, n_split, str(device))
    if host_taps:
        key += (b"".join(np.asarray(t, np.float32).tobytes()
                         for t in taps_list),)
    with _plan_lock:
        hit = _PLAN_CACHE.get(key)
    if hit is None:
        table = None
        if host_taps:
            flat = np.concatenate([np.asarray(t, np.float32).reshape(-1)
                                   for t in taps_list])
            table = np.zeros(bits.shape[0] * (max_off + 1)
                             * cb_phase_pad(n_split) ** 2, np.float32)
            np.add.at(table, index, flat)
            table = torch.as_tensor(table, device=device)
        hit = (table, torch.as_tensor(bits.view(np.int32), device=device),
               torch.as_tensor(index, device=device))
        with _plan_lock:
            if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
                _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
            _PLAN_CACHE[key] = hit
    table, bits_t, index_t = hit
    if table is None:
        table = torch.zeros(bits.shape[0] * (max_off + 1)
                            * cb_phase_pad(n_split) ** 2,
                            dtype=torch.float32, device=device)
        table.index_add_(0, index_t, _flat_taps(taps_list, device))
    return table, bits_t


def _cb_launch(x, taps_list, info, n_split, n_out, out, rows, periodic):
    """Launch ``veles_cb_f32`` on ``x``'s current stream and count it."""
    max_off, channels = info[2], len(info[0])
    if not fits_smem_cb(n_split, max_off, channels):
        raise ValueError(
            f"cascade bank of {channels} channels at n_split {n_split} "
            f"with offsets up to {max_off} needs "
            f"{cb_smem_bytes(n_split, max_off, channels)} bytes of shared "
            f"memory per block (> {SMEM_MAX_BYTES}; n_split <= "
            f"{CB_MAX_SPLIT})")
    table, bits = _plan_arrays(taps_list, info, n_split, x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.veles_cb_f32(x.data_ptr(), table.data_ptr(),
                               bits.data_ptr(), out.data_ptr(), rows,
                               int(x.shape[-1]), n_split, len(info[0]),
                               max_off, n_out, int(periodic), stream)
    _check_err(lib, err, "cascade_bank kernel")
    LAUNCHES["cascade_bank"] += 1


def cascade_bank_cuda(x_ext, taps_list, plans, n_split, n_out):
    """FIR channels at stride ``n_split`` from one pass over the input
    (float32): channel c returns ``out_c[..., i] = sum_slot
    taps_c[slot] * x_ext[..., (i + off) * n_split + p]`` over its plan
    of ``(p, off)`` slots — the contract of the JAX package's
    ``cascade_bank_pallas``, plan checks and messages included.
    ``taps_list`` holds one tap vector per channel in plan-slot order
    (NumPy arrays or tensors).  A CPU tensor takes the plain version; a
    CUDA tensor launches ``csrc/cascade_bank.cu`` once (``n_split`` up
    to CB_MAX_SPLIT)."""
    n_split, n_out = int(n_split), int(n_out)
    info = _check_plan(taps_list, plans, n_split)
    need = (n_out - 1) * n_split + info[1]
    if x_ext.shape[-1] < need:
        raise ValueError(f"x_ext too short: {x_ext.shape[-1]} < {need}")
    _check_operands(x_ext)
    if x_ext.device.type == "cpu":
        return cascade_bank_plain(x_ext, taps_list, info[0], n_split,
                                  n_out)
    if x_ext.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_ext.device}")
    channels = len(info[0])
    rows = x_ext.numel() // max(int(x_ext.shape[-1]), 1)
    out = torch.empty((channels, rows, n_out), dtype=torch.float32,
                      device=x_ext.device)
    shape = tuple(x_ext.shape[:-1]) + (n_out,)
    if rows and n_out > 0:
        _cb_launch(x_ext, taps_list, info, n_split, n_out, out, rows, False)
    return tuple(o.reshape(shape) for o in out)


def cascade_bank_periodic_cuda(x, taps_list, plans, levels):
    """The PERIODIC DWT cascade of ``levels`` (2..4) levels in one
    launch (float32): ``plans``/``taps_list`` are the cascade's 2^L
    channels in the order of ``wavelet._cascade_plan`` (the 2^(L-l)
    output phases of level l for l = 1..L, then the lowpass), over the
    UNEXTENDED signal ``x[..., n]`` (n a multiple of 2^L) read
    periodically: the same sums as :func:`cascade_bank_cuda` on ``x``
    extended by its own head, written in natural order.  Returns
    ``(hi_1, ..., hi_L, lo_L)``, ``hi_l`` of ``n / 2^l`` samples and
    ``lo_L`` of ``n / 2^L``, contiguous.  A CPU tensor takes the plain
    version; a CUDA tensor launches ``csrc/cascade_bank.cu`` once and
    runs nothing else."""
    n_split, n_out, info = _periodic_args(x, taps_list, plans, levels)
    _check_operands(x)
    if x.device.type == "cpu":
        return cascade_bank_periodic_plain(x, taps_list, info[0], levels)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n = int(x.shape[-1])
    rows = x.numel() // n
    out = torch.empty(rows * n, dtype=torch.float32, device=x.device)
    if rows:
        _cb_launch(x, taps_list, info, n_split, n_out, out, rows, True)
    coeffs, start = [], 0
    for width in [n >> lvl for lvl in range(1, int(levels) + 1)] + [n_out]:
        coeffs.append(out[start:start + rows * width].view(
            tuple(x.shape[:-1]) + (width,)))
        start += rows * width
    return tuple(coeffs)


# ---- K5: 2D shifted-MAC ----------------------------------------------------

def filter_2d_plain(x_ext, kernel2d, n_out0, n_out1, pad=(0, 0),
                    reverse_taps=False):
    """Plain version of :func:`filter_2d_cuda`: ``F.pad`` and ``flip``
    for the padding and the flip, then one multiply-add pass per tap
    over the shifted input window, in the kernel's tap order (row-major:
    kernel row, then kernel column).  Float64 operands accumulate in
    float64."""
    p0, p1 = int(pad[0]), int(pad[1])
    if p0 or p1:
        x_ext = torch.nn.functional.pad(x_ext, (p1, p1, p0, p0))
    if reverse_taps:
        kernel2d = kernel2d.flip((0, 1))
    k0, k1 = kernel2d.shape
    o = x_ext.new_zeros(tuple(x_ext.shape[:-2]) + (n_out0, n_out1))
    for p in range(k0):
        for q in range(k1):
            o.addcmul_(x_ext[..., p:p + n_out0, q:q + n_out1],
                       kernel2d[p, q])
    return o


def filter_2d_cuda(x, kernel2d, n_out0, n_out1, *, pad=(0, 0),
                   reverse_taps=False):
    """2D FIR correlation (float32): ``out[..., i, j] = sum_{p, q}
    kernel2d[p, q] * x_ext[..., i + p, j + q]`` — the contract of the
    JAX package's ``filter_2d_pallas``, argument checks included — where
    ``x_ext`` is ``x`` zero-padded by ``pad = (rows, columns)`` on each
    side (the kernel reads the halo as zeros) and the taps are read
    flipped on both axes if ``reverse_taps``; leading batch dims of
    ``x`` ride along.  A CPU tensor takes the plain version; a CUDA
    tensor launches ``csrc/filter_2d.cu`` (one launch)."""
    if kernel2d.ndim != 2:
        raise ValueError("kernel2d must be [k0, k1]")
    k0, k1 = int(kernel2d.shape[0]), int(kernel2d.shape[1])
    if x.ndim < 2:
        raise ValueError("x_ext must be [..., n0_ext, n1_ext]")
    p0, p1 = int(pad[0]), int(pad[1])
    if p0 < 0 or p1 < 0:
        raise ValueError(f"pad must be >= 0, got {(p0, p1)}")
    n_out0, n_out1 = int(n_out0), int(n_out1)
    ext = (x.shape[-2] + 2 * p0, x.shape[-1] + 2 * p1)
    if ext[0] < n_out0 + k0 - 1 or ext[1] < n_out1 + k1 - 1:
        raise ValueError(
            f"x_ext too short: {ext} < "
            f"{(n_out0 + k0 - 1, n_out1 + k1 - 1)}")
    _check_operands(x, kernel2d)
    if x.device.type == "cpu":
        return filter_2d_plain(x, kernel2d, n_out0, n_out1, (p0, p1),
                               reverse_taps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not fits_smem_f2d(k0, k1):
        raise ValueError(
            f"2D kernel {k0}x{k1} needs {f2d_smem_bytes(k0, k1)} bytes of "
            f"shared memory per block (> {SMEM_MAX_BYTES})")
    n0, n1 = int(x.shape[-2]), int(x.shape[-1])
    imgs = x.numel() // max(n0 * n1, 1)
    out = torch.empty(tuple(x.shape[:-2]) + (n_out0, n_out1),
                      dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.veles_f2d_f32(x.data_ptr(), kernel2d.data_ptr(),
                                out.data_ptr(), imgs, n0, n1, k0, k1,
                                n_out0, n_out1, p0, p1,
                                int(bool(reverse_taps)), stream)
    _check_err(lib, err, "filter_2d kernel")
    LAUNCHES["filter_2d"] += 1      # one persistent grid for all images
    return out


# ---- K4: fused STFT --------------------------------------------------------

def stft_basis(frame_length: int, window) -> np.ndarray:
    """``[L, 2*bins]`` float32 window-folded real-DFT basis with
    interleaved columns: ``B[n, 2k] = w[n] cos(2 pi n k / L)`` and
    ``B[n, 2k+1] = -w[n] sin(2 pi n k / L)`` (``bins = L // 2 + 1``),
    built in float64.  The values of the JAX package's
    ``_stft_basis_blocks`` without its 128-lane padding columns, so a
    row of ``frames @ B`` is one frame's complex64 spectrum: the plain
    version's operand."""
    L = int(frame_length)
    bins = L // 2 + 1
    k = np.arange(bins)[None, :]
    w = np.asarray(window, np.float64)[:, None]
    out = np.empty((L, bins, 2), np.float32)
    # blocks of rows, so the float64 temporaries stay near 32 MB
    step = max(1, (1 << 22) // bins)
    for s in range(0, L, step):
        n = np.arange(s, min(s + step, L))[:, None]
        ang = 2.0 * np.pi * n * k / L
        out[s:s + step, :, 0] = w[s:s + step] * np.cos(ang)
        out[s:s + step, :, 1] = -w[s:s + step] * np.sin(ang)
    return out.reshape(L, 2 * bins)


def fft_twiddles(n: int) -> np.ndarray:
    """``[n, 2]`` float32 table of ``e^{-2 pi i t / n}``, t < n, as
    (re, im) pairs, built in float64: the twiddles of the block-level
    FFT (csrc/smem_fft.cuh) for a real transform of n samples or a
    complex one of n values."""
    ang = -2.0 * np.pi * np.arange(int(n), dtype=np.float64) / int(n)
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


# device copies of twiddle tables and plain-version bases, so a repeated
# call makes no host-to-device copy; 256 MB at the most (a basis holds
# 4 L^2 bytes: 67 MB at L = 4096, and one of 1.07 GB at L = 16384 is
# built for its call and not kept)
_tables = ConstantCache(32, max_bytes=256 << 20)
obs.register_cache("cuda_kernels_device_lru", _tables.info)


def _device_twiddles(n: int, device):
    """:func:`fft_twiddles` of ``n`` on ``device``, cached per (n,
    device)."""
    return _tables.get(("twiddles", int(n), str(device)),
                       lambda: torch.as_tensor(fft_twiddles(n),
                                               device=device))


def _check_stft(x, window, frame_length, hop):
    """The contract of ``stft_pallas``, with its messages (its 128-lane
    hop term belongs to the route gate here); returns the frame
    count."""
    L, s = int(frame_length), int(hop)
    if L < 1 or s < 1:
        raise ValueError(f"frame_length and hop must be positive, got "
                         f"{L} and {s}")
    if L % s != 0:
        raise ValueError(
            f"fused STFT needs hop | frame_length, got {s}, {L} "
            "(use the rdft_matmul route for non-dividing hops)")
    if L // s < 2:
        raise ValueError("fused STFT needs frame_length > hop (no "
                         "overlap to carry; use the rdft_matmul route)")
    n = int(x.shape[-1])
    if n < L:
        raise ValueError(f"signal length {n} < frame_length {L}")
    if tuple(window.shape) != (L,):
        raise ValueError(f"window shape {tuple(window.shape)} != {(L,)}")
    return 1 + (n - L) // s


def _as_spectrum(out, lead):
    """``[rows, frames, 2*bins]`` float32 -> complex64 ``[*lead,
    frames, bins]``, a view."""
    return torch.view_as_complex(
        out.view(*lead, out.shape[-2], out.shape[-1] // 2, 2))


def stft_plain(x, window, frame_length, hop):
    """Plain version of :func:`stft_cuda`: the ``unfold`` frames, then
    one multiply-add pass per sample index n against the window-folded
    basis of :func:`stft_basis` (built here, its device copy cached),
    the DFT form of the same function (the kernel's FFT agrees within
    1e-5 of max|X|).  ``window`` is a tensor or, so that no call copies
    it from the card, a NumPy array.  A float64 ``x`` accumulates in
    float64 (a complex128 result): the reference that holds the kernel
    at long frames, where a float32 sum of L terms drifts by about
    sqrt(L) roundings."""
    L = int(frame_length)
    if isinstance(window, torch.Tensor):
        window = window.detach().cpu().numpy()
    window = np.asarray(window, np.float32)
    basis = _tables.get(
        ("stft_basis", L, window.tobytes(), str(x.device)),
        lambda: torch.as_tensor(stft_basis(L, window), device=x.device))
    basis = basis.to(x.dtype)
    frames = x.unfold(-1, L, int(hop))
    out = x.new_zeros(tuple(frames.shape[:-1]) + (basis.shape[1],))
    for j in range(L):
        out.addcmul_(frames[..., j:j + 1], basis[j])
    return _as_spectrum(out, tuple(x.shape[:-1]))


def stft_cuda(x, window, frame_length, hop):
    """Short-time Fourier transform ``x[..., n] -> complex64 [...,
    frames, L // 2 + 1]`` with ``frames = 1 + (n - L) // hop`` of the
    frames windowed by ``window`` ([L] float32), sign ``e^{-2 pi i n k
    / L}`` — the contract of the JAX package's ``stft_pallas`` (hop
    divides L, L > hop, n >= L; its 128-lane hop term is the route's,
    not the kernel's).  Leading batch dims ride along.  A CPU tensor
    takes the plain version; a CUDA tensor launches ``csrc/stft.cu``,
    or raises for a geometry :func:`fits_smem_stft` refuses."""
    frames = _check_stft(x, window, frame_length, hop)
    _check_operands(x, window)
    if x.device.type == "cpu":
        return stft_plain(x, window, frame_length, hop)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    L, hop = int(frame_length), int(hop)
    if not fits_smem_stft(L, hop):
        raise ValueError(
            f"STFT kernel refuses frame_length {L}, hop {hop}: "
            f"{stft_smem_bytes(L, hop)} bytes of shared memory per block "
            f"(> {SMEM_MAX_BYTES}) or more than "
            f"{_FFT_THREADS * _FFT_VPT_MAX} FFT values a block")
    n = int(x.shape[-1])
    rows = x.numel() // n
    out = torch.empty((rows, frames, 2 * (L // 2 + 1)),
                      dtype=torch.float32, device=x.device)
    lead = tuple(x.shape[:-1])
    if rows == 0:
        return _as_spectrum(out, lead)
    tw = _device_twiddles(L, x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.veles_stft_f32(x.data_ptr(), window.data_ptr(),
                                 tw.data_ptr(), out.data_ptr(), rows, n, L,
                                 hop, frames, stream)
    _check_err(lib, err, "stft kernel")
    LAUNCHES["stft"] += _launches(rows)
    return _as_spectrum(out, lead)
