"""Hand-written CUDA kernels for Hopper, their wrappers and plain
versions (the port's counterpart of ``veles.simd_tpu.ops.
pallas_kernels``).

All five of the JAX package's Pallas kernels are ported here:

* :func:`overlap_save_cuda` (``csrc/overlap_save.cu``) replaces
  ``overlap_save_pallas``: the full linear convolution of every batch
  row with one filter, the overlap-save route of the convolve handles.
* :func:`filter_bank_cuda` (``csrc/filter_bank.cu``) replaces
  ``filter_bank_pallas``: the multi-channel shifted-MAC FIR bank
  (``out[c][b, i] = sum_j f[c, j] x_ext[b, i*stride + j*dilation]``),
  the direct route of the convolve and correlate entry points and the
  ``cuda`` route of the DWT and SWT.
* :func:`cascade_bank_cuda` (``csrc/cascade_bank.cu``) replaces
  ``cascade_bank_pallas``: FIR channels at stride ``n_split`` over a
  runtime plan of (phase, offset) slots, the fused PERIODIC DWT
  cascade.
* :func:`filter_2d_cuda` (``csrc/filter_2d.cu``) replaces
  ``filter_2d_pallas``: the 2D shifted-MAC correlation, the direct
  route of ``convolve2d`` and ``cross_correlate2d``.
* :func:`stft_cuda` (``csrc/stft.cu``) replaces ``stft_pallas``: the
  windowed real-DFT STFT as an implicit GEMM against the window-folded
  basis (:func:`stft_basis`), the ``cuda_fused`` route of
  ``spectral.stft`` and ``batched.batched_stft``.

Each source note says what bounds its kernel on the H100 and what the
design does about it.

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

__all__ = [
    "overlap_save_cuda", "overlap_save_plain",
    "filter_bank_cuda", "filter_bank_plain",
    "cascade_bank_cuda", "cascade_bank_plain",
    "filter_2d_cuda", "filter_2d_plain",
    "stft_cuda", "stft_plain", "stft_basis",
    "fb_smem_bytes", "fits_smem_fb", "fits_smem_os",
    "cb_smem_bytes", "fits_smem_cb", "f2d_smem_bytes", "fits_smem_f2d",
    "stft_smem_bytes", "fits_smem_stft",
    "should_route", "on_card",
    "LAUNCHES", "reset_launches", "load_library", "build_log",
    "OS_MIN_H", "DIRECT_MAX_H", "MIN_ROWS", "MAX_AREA_2D", "OS_TILE",
    "FB_TILE", "CB_TILE", "F2D_TILE", "STFT_TILE", "STFT_MIN_FRAMES",
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
# against the built library (veles_*_tile, veles_*_smem_bytes), so the
# admission arithmetic below cannot drift from csrc/.
_R = 13
OS_TILE = 128 * _R
_OS_KC = 20 * _R
FB_TILE = 128 * _R
CB_TILE = 128 * 4
_F2D_RY = 4
F2D_TILE = (8 * _F2D_RY, 32 * 2)      # (rows, columns) of outputs
STFT_TILE = (64, 64)                  # (frames, basis columns)
_STFT_KC = 32
# shared memory a block may use on Hopper (227 KB, opt-in above 48 KB)
SMEM_MAX_BYTES = 232448
_SMEM_STATIC_MAX = 48 * 1024


def _os_smem_bytes() -> int:
    """Static shared memory of the overlap-save kernel: one tap chunk
    and its input window, whatever the filter length."""
    return 4 * (_OS_KC + OS_TILE + _OS_KC - 1)


def fits_smem_os(h_length: int) -> bool:
    """Shared-memory admission of the overlap-save kernel: its
    footprint is fixed (about 8.7 KB) and under the 48 KB static limit
    for every filter length, so every ``h_length >= 1`` is admitted."""
    return int(h_length) >= 1 and _os_smem_bytes() <= _SMEM_STATIC_MAX


def fb_smem_bytes(channels: int, order: int, stride: int,
                  dilation: int) -> int:
    """Dynamic shared memory of one filter-bank block: the input span
    of FB_TILE outputs, the [channels, order] taps (padded to a
    multiple of 13 on the unit-stride path) and the output tile
    (``smem_bytes`` in csrc/filter_bank.cu)."""
    channels, order = int(channels), int(order)
    stride, dilation = int(stride), int(dilation)
    if stride == 1 and dilation == 1:
        order_pad = -(-order // _R) * _R
        span = FB_TILE + order_pad - 1
    else:
        order_pad = order
        span = (FB_TILE - 1) * stride + (order - 1) * dilation + 1
    return 4 * (span + channels * order_pad + FB_TILE)


def fits_smem_fb(channels: int, order: int, stride: int,
                 dilation: int) -> bool:
    """Shared-memory admission of the filter-bank kernel."""
    return fb_smem_bytes(channels, order, stride,
                         dilation) <= SMEM_MAX_BYTES


def _cb_pitch(n_split: int, max_off: int) -> int:
    """Row pitch of the cascade bank's staged phases (``pitch_of`` in
    csrc/cascade_bank.cu)."""
    length = CB_TILE + max_off
    if n_split > 32 or 32 % n_split:
        return length
    return length + ((32 // n_split) % 32 - length) % 32


def cb_smem_bytes(n_split: int, max_off: int, n_slots: int,
                  channels: int) -> int:
    """Dynamic shared memory of one cascade-bank block: the slot table
    (tap and staged offset, 8 bytes a slot), the channel starts and the
    ``[n_split, pitch]`` staged input span (``smem_bytes`` in
    csrc/cascade_bank.cu)."""
    n_split, max_off = int(n_split), int(max_off)
    return (8 * int(n_slots) + 4 * (int(channels) + 1)
            + 4 * n_split * _cb_pitch(n_split, max_off))


def fits_smem_cb(n_split: int, max_off: int, n_slots: int,
                 channels: int) -> bool:
    """Shared-memory admission of the cascade-bank kernel."""
    return cb_smem_bytes(n_split, max_off, n_slots,
                         channels) <= SMEM_MAX_BYTES


def f2d_smem_bytes(k0: int, k1: int) -> int:
    """Dynamic shared memory of one 2D block: the staged input tile with
    its halo (kernel rows padded to a multiple of 4) and the taps
    (``smem_bytes`` in csrc/filter_2d.cu)."""
    k0, k1 = int(k0), int(k1)
    rows = F2D_TILE[0] + -(-k0 // _F2D_RY) * _F2D_RY - 1
    cols = F2D_TILE[1] + k1 - 1
    return 4 * (rows * cols + k0 * k1)


def fits_smem_f2d(k0: int, k1: int) -> bool:
    """Shared-memory admission of the 2D kernel (every kernel of area
    <= MAX_AREA_2D fits: 256 x 1 needs the most, 74,496 bytes)."""
    return f2d_smem_bytes(k0, k1) <= SMEM_MAX_BYTES


def stft_smem_bytes() -> int:
    """Static shared memory of one STFT block: a chunk of the frames'
    samples at a pitch of 68 floats and a chunk of basis rows
    (``veles_stft_smem_bytes`` in csrc/stft.cu)."""
    return 4 * _STFT_KC * (STFT_TILE[0] + 4 + STFT_TILE[1])


def fits_smem_stft(frame_length: int, hop: int) -> bool:
    """Shared-memory admission of the STFT kernel: its footprint is
    fixed (16.5 KB) and under the 48 KB static limit whatever the frame
    length and hop, so every geometry is admitted."""
    return (int(frame_length) >= 1 and int(hop) >= 1
            and stft_smem_bytes() <= _SMEM_STATIC_MAX)


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
    for name in _SOURCES:
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
        lib.veles_os_tile.argtypes = []
        lib.veles_os_tile.restype = _I
        lib.veles_fb_tile.argtypes = []
        lib.veles_fb_tile.restype = _I
        lib.veles_fb_smem_bytes.argtypes = [_I, _I, _I, _I]
        lib.veles_fb_smem_bytes.restype = _L
        lib.veles_cuda_error_string.argtypes = [_I]
        lib.veles_cuda_error_string.restype = ctypes.c_char_p
        lib.veles_os_conv_f32.argtypes = [_P, _P, _P, _L, _L, _I, _P]
        lib.veles_os_conv_f32.restype = _I
        lib.veles_fb_f32.argtypes = [_P, _P, _P, _L, _L, _I, _I, _I, _I,
                                     _L, _P]
        lib.veles_fb_f32.restype = _I
        for name in ("veles_cb_tile", "veles_f2d_tile_x",
                     "veles_f2d_tile_y"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = _I
        lib.veles_cb_smem_bytes.argtypes = [_I, _I, _I, _I]
        lib.veles_cb_smem_bytes.restype = _L
        lib.veles_f2d_smem_bytes.argtypes = [_I, _I]
        lib.veles_f2d_smem_bytes.restype = _L
        lib.veles_cb_f32.argtypes = [_P, _P, _P, _P, _L, _L, _I, _I, _I,
                                     _I, _L, _P]
        lib.veles_cb_f32.restype = _I
        lib.veles_f2d_f32.argtypes = [_P, _P, _P, _L, _L, _L, _I, _I, _L,
                                      _L, _P]
        lib.veles_f2d_f32.restype = _I
        for name in ("veles_stft_tile_frames", "veles_stft_tile_cols"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = _I
        lib.veles_stft_smem_bytes.argtypes = []
        lib.veles_stft_smem_bytes.restype = _L
        lib.veles_stft_f32.argtypes = [_P, _P, _P, _L, _L, _I, _I, _L, _I,
                                       _P]
        lib.veles_stft_f32.restype = _I
        if (lib.veles_os_tile() != OS_TILE
                or lib.veles_fb_tile() != FB_TILE
                or lib.veles_fb_smem_bytes(2, 8, 2, 1)
                != fb_smem_bytes(2, 8, 2, 1)
                or lib.veles_cb_tile() != CB_TILE
                or any(lib.veles_cb_smem_bytes(*a) != cb_smem_bytes(*a)
                       for a in ((8, 6, 176, 8), (4, 3, 100, 9),
                                 (3, 2, 10, 2)))
                or (lib.veles_f2d_tile_y(), lib.veles_f2d_tile_x())
                != F2D_TILE
                or any(lib.veles_f2d_smem_bytes(*a) != f2d_smem_bytes(*a)
                       for a in ((7, 7), (1, 256), (256, 1), (5, 3)))
                or (lib.veles_stft_tile_frames(), lib.veles_stft_tile_cols())
                != STFT_TILE
                or lib.veles_stft_smem_bytes() != stft_smem_bytes()):
            raise RuntimeError("csrc/ tile geometry differs from the "
                               "admission constants in cuda_kernels.py")
        _lib = lib
        return lib


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
    signal per tap."""
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
    version; a CUDA tensor launches ``csrc/overlap_save.cu``."""
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
    n = int(x.shape[-1])
    rows = x.numel() // n
    y = torch.empty(tuple(x.shape[:-1]) + (n + k - 1,),
                    dtype=torch.float32, device=x.device)
    if rows == 0:
        return y
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.veles_os_conv_f32(x.data_ptr(), taps.data_ptr(),
                                    y.data_ptr(), rows, n, k, stream)
    _check_err(lib, err, "overlap_save kernel")
    LAUNCHES["overlap_save"] += _launches(rows)
    return y


# ---- K2: shifted-MAC filter bank -------------------------------------------

def filter_bank_plain(x_ext, filters, stride, dilation, n_out):
    """Plain version of :func:`filter_bank_cuda`: one multiply-add pass
    per (channel, tap) over the strided input slice."""
    outs = []
    span = (n_out - 1) * stride + 1
    for c in range(filters.shape[0]):
        o = x_ext.new_zeros(tuple(x_ext.shape[:-1]) + (n_out,))
        for j in range(filters.shape[1]):
            s = j * dilation
            o.addcmul_(x_ext[..., s:s + span:stride], filters[c, j])
        outs.append(o)
    return tuple(outs)


def filter_bank_cuda(x_ext, filters, stride, dilation, n_out):
    """Multi-channel FIR filter bank (float32): returns a tuple of C
    tensors ``[..., n_out]`` with ``out[c][..., i] = sum_j filters[c,
    j] * x_ext[..., i*stride + j*dilation]`` — the contract of the JAX
    package's ``filter_bank_pallas``.  ``x_ext`` carries the caller's
    boundary extension.  A CPU tensor takes the plain version; a CUDA
    tensor launches ``csrc/filter_bank.cu``."""
    if filters.ndim != 2:
        raise ValueError("filters must be [channels, order]")
    stride, dilation, n_out = int(stride), int(dilation), int(n_out)
    if stride < 1 or dilation < 1 or n_out < 1:
        raise ValueError("stride, dilation and n_out must be >= 1")
    channels, order = int(filters.shape[0]), int(filters.shape[1])
    need = (n_out - 1) * stride + (order - 1) * dilation + 1
    if x_ext.shape[-1] < need:
        raise ValueError(
            f"x_ext too short: {x_ext.shape[-1]} < {need} for "
            f"n_out={n_out}, stride={stride}, dilation={dilation}")
    _check_operands(x_ext, filters)
    if x_ext.device.type == "cpu":
        return filter_bank_plain(x_ext, filters, stride, dilation, n_out)
    if x_ext.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_ext.device}")
    if not fits_smem_fb(channels, order, stride, dilation):
        raise ValueError(
            f"filter bank of {channels}x{order} taps at stride {stride}, "
            f"dilation {dilation} needs "
            f"{fb_smem_bytes(channels, order, stride, dilation)} bytes "
            f"of shared memory per block (> {SMEM_MAX_BYTES})")
    n_ext = int(x_ext.shape[-1])
    rows = x_ext.numel() // n_ext
    out = torch.empty((channels, rows, n_out), dtype=torch.float32,
                      device=x_ext.device)
    shape = tuple(x_ext.shape[:-1]) + (n_out,)
    if rows == 0:
        return tuple(o.reshape(shape) for o in out)
    lib = load_library()
    with torch.cuda.device(x_ext.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.veles_fb_f32(x_ext.data_ptr(), filters.data_ptr(),
                               out.data_ptr(), rows, n_ext, channels,
                               order, stride, dilation, n_out, stream)
    _check_err(lib, err, "filter_bank kernel")
    LAUNCHES["filter_bank"] += _launches(rows)
    return tuple(o.reshape(shape) for o in out)


# ---- K3: cascade bank ------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _plan_info(plans, n_split):
    """What a plan tells the kernel, derived once per (plans, n_split):
    ``(plans, need_extra, n_slots, max_off, meta)``.  ``x_ext`` must
    hold ``(n_out - 1) * n_split + need_extra`` samples (the JAX
    package's per-phase slice lengths: ``n_out`` plus the phase's
    largest offset); ``meta = [channel starts | phases | offsets]``
    (int32) is the layout ``veles_cb_f32`` reads.  Raises the plan
    errors of the JAX package's ``cascade_bank_pallas``."""
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
    slots = [ps for plan in plans for ps in plan]
    starts = np.cumsum([0] + [len(plan) for plan in plans])
    meta = np.concatenate([starts, [p for p, _ in slots],
                           [o for _, o in slots]]).astype(np.int32)
    return plans, need_extra, len(slots), max(phase_off), meta


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
    per plan slot over the stride-``n_split`` input slice."""
    taps = _flat_taps(taps_list, x_ext.device)
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


# device copies of plans (and of host-side taps), so a repeated call
# makes no host-to-device copy: plan key -> (taps or None, meta)
_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 64
_plan_lock = threading.Lock()


def _plan_arrays(taps_list, plans, meta, device):
    """``(taps, meta)`` on ``device``: float32 taps in slot order and
    the int32 ``meta``; cached per plan (and per tap values when they
    come from the host)."""
    host_taps = not any(isinstance(t, torch.Tensor) for t in taps_list)
    key = (plans, str(device))
    if host_taps:
        key += (b"".join(np.asarray(t, np.float32).tobytes()
                         for t in taps_list),)
    with _plan_lock:
        hit = _PLAN_CACHE.get(key)
    if hit is None:
        hit = (_flat_taps(taps_list, device) if host_taps else None,
               torch.as_tensor(meta, device=device))
        with _plan_lock:
            if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
                _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
            _PLAN_CACHE[key] = hit
    taps, meta = hit
    if taps is None:
        taps = _flat_taps(taps_list, device)
    return taps, meta


def cascade_bank_cuda(x_ext, taps_list, plans, n_split, n_out):
    """FIR channels at stride ``n_split`` from one pass over the input
    (float32): channel c returns ``out_c[..., i] = sum_slot
    taps_c[slot] * x_ext[..., (i + off) * n_split + p]`` over its plan
    of ``(p, off)`` slots — the contract of the JAX package's
    ``cascade_bank_pallas``, plan checks and messages included.
    ``taps_list`` holds one tap vector per channel in plan-slot order
    (NumPy arrays or tensors).  A CPU tensor takes the plain version; a
    CUDA tensor launches ``csrc/cascade_bank.cu``."""
    n_split, n_out = int(n_split), int(n_out)
    plans, need_extra, n_slots, max_off, meta = _check_plan(
        taps_list, plans, n_split)
    need = (n_out - 1) * n_split + need_extra
    if x_ext.shape[-1] < need:
        raise ValueError(f"x_ext too short: {x_ext.shape[-1]} < {need}")
    _check_operands(x_ext)
    if x_ext.device.type == "cpu":
        return cascade_bank_plain(x_ext, taps_list, plans, n_split, n_out)
    if x_ext.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_ext.device}")
    channels = len(plans)
    if not fits_smem_cb(n_split, max_off, n_slots, channels):
        raise ValueError(
            f"cascade bank of {channels} channels, {n_slots} slots at "
            f"n_split {n_split} needs "
            f"{cb_smem_bytes(n_split, max_off, n_slots, channels)} bytes "
            f"of shared memory per block (> {SMEM_MAX_BYTES})")
    n_ext = int(x_ext.shape[-1])
    rows = x_ext.numel() // n_ext
    out = torch.empty((channels, rows, n_out), dtype=torch.float32,
                      device=x_ext.device)
    shape = tuple(x_ext.shape[:-1]) + (n_out,)
    if rows == 0:
        return tuple(o.reshape(shape) for o in out)
    taps, meta = _plan_arrays(taps_list, plans, meta, x_ext.device)
    lib = load_library()
    with torch.cuda.device(x_ext.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.veles_cb_f32(x_ext.data_ptr(), taps.data_ptr(),
                               meta.data_ptr(), out.data_ptr(), rows,
                               n_ext, n_split, channels, n_slots, max_off,
                               n_out, stream)
    _check_err(lib, err, "cascade_bank kernel")
    LAUNCHES["cascade_bank"] += _launches(rows)
    return tuple(o.reshape(shape) for o in out)


# ---- K5: 2D shifted-MAC ----------------------------------------------------

def filter_2d_plain(x_ext, kernel2d, n_out0, n_out1):
    """Plain version of :func:`filter_2d_cuda`: one multiply-add pass
    per tap over the shifted input window, in the kernel's tap order
    (groups of four kernel rows, then kernel columns, then the row
    within the group)."""
    k0, k1 = kernel2d.shape
    o = x_ext.new_zeros(tuple(x_ext.shape[:-2]) + (n_out0, n_out1))
    for g in range(0, k0, _F2D_RY):
        for q in range(k1):
            for p in range(g, min(g + _F2D_RY, k0)):
                o.addcmul_(x_ext[..., p:p + n_out0, q:q + n_out1],
                           kernel2d[p, q])
    return o


def filter_2d_cuda(x_ext, kernel2d, n_out0, n_out1):
    """2D FIR correlation (float32): ``out[..., i, j] = sum_{p, q}
    kernel2d[p, q] * x_ext[..., i + p, j + q]`` — the contract of the
    JAX package's ``filter_2d_pallas``, argument checks included;
    leading batch dims of ``x_ext`` ride along.  A CPU tensor takes the
    plain version; a CUDA tensor launches ``csrc/filter_2d.cu``."""
    if kernel2d.ndim != 2:
        raise ValueError("kernel2d must be [k0, k1]")
    k0, k1 = int(kernel2d.shape[0]), int(kernel2d.shape[1])
    if x_ext.ndim < 2:
        raise ValueError("x_ext must be [..., n0_ext, n1_ext]")
    n_out0, n_out1 = int(n_out0), int(n_out1)
    if (x_ext.shape[-2] < n_out0 + k0 - 1
            or x_ext.shape[-1] < n_out1 + k1 - 1):
        raise ValueError(
            f"x_ext too short: {tuple(x_ext.shape[-2:])} < "
            f"{(n_out0 + k0 - 1, n_out1 + k1 - 1)}")
    _check_operands(x_ext, kernel2d)
    if x_ext.device.type == "cpu":
        return filter_2d_plain(x_ext, kernel2d, n_out0, n_out1)
    if x_ext.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_ext.device}")
    if not fits_smem_f2d(k0, k1):
        raise ValueError(
            f"2D kernel {k0}x{k1} needs {f2d_smem_bytes(k0, k1)} bytes of "
            f"shared memory per block (> {SMEM_MAX_BYTES})")
    n0e, n1e = int(x_ext.shape[-2]), int(x_ext.shape[-1])
    imgs = x_ext.numel() // max(n0e * n1e, 1)
    out = torch.empty(tuple(x_ext.shape[:-2]) + (n_out0, n_out1),
                      dtype=torch.float32, device=x_ext.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x_ext.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.veles_f2d_f32(x_ext.data_ptr(), kernel2d.data_ptr(),
                                out.data_ptr(), imgs, n0e, n1e, k0, k1,
                                n_out0, n_out1, stream)
    _check_err(lib, err, "filter_2d kernel")
    LAUNCHES["filter_2d"] += _launches(imgs)
    return out


# ---- K4: fused STFT --------------------------------------------------------

def stft_basis(frame_length: int, window) -> np.ndarray:
    """``[L, 2*bins]`` float32 window-folded real-DFT basis with
    interleaved columns: ``B[n, 2k] = w[n] cos(2 pi n k / L)`` and
    ``B[n, 2k+1] = -w[n] sin(2 pi n k / L)`` (``bins = L // 2 + 1``),
    built in float64.  The values of the JAX package's
    ``_stft_basis_blocks`` without its 128-lane padding columns, so a
    row of ``frames @ B`` is one frame's complex64 spectrum."""
    L = int(frame_length)
    bins = L // 2 + 1
    n = np.arange(L)[:, None]
    k = np.arange(bins)[None, :]
    ang = 2.0 * np.pi * n * k / L
    w = np.asarray(window, np.float64)[:, None]
    out = np.empty((L, bins, 2), np.float32)
    out[..., 0] = (w * np.cos(ang)).astype(np.float32)
    out[..., 1] = (-w * np.sin(ang)).astype(np.float32)
    return out.reshape(L, 2 * bins)


def _check_stft(x, basis, frame_length, hop):
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
    if tuple(basis.shape) != (L, 2 * (L // 2 + 1)):
        raise ValueError(f"basis shape {tuple(basis.shape)} != "
                         f"{(L, 2 * (L // 2 + 1))}")
    return 1 + (n - L) // s


def _as_spectrum(out, lead):
    """``[rows, frames, 2*bins]`` float32 -> complex64 ``[*lead,
    frames, bins]``, a view."""
    return torch.view_as_complex(
        out.view(*lead, out.shape[-2], out.shape[-1] // 2, 2))


def stft_plain(x, basis, frame_length, hop):
    """Plain version of :func:`stft_cuda`: the ``unfold`` frames, then
    one multiply-add pass per sample index n, in the kernel's order."""
    frames = x.unfold(-1, int(frame_length), int(hop))
    out = x.new_zeros(tuple(frames.shape[:-1]) + (basis.shape[1],))
    for j in range(int(frame_length)):
        out.addcmul_(frames[..., j:j + 1], basis[j])
    return _as_spectrum(out, tuple(x.shape[:-1]))


def stft_cuda(x, basis, frame_length, hop):
    """Short-time Fourier transform ``x[..., n] -> complex64 [...,
    frames, L // 2 + 1]`` with ``frames = 1 + (n - L) // hop``, against
    the interleaved window-folded basis of :func:`stft_basis` — the
    contract of the JAX package's ``stft_pallas`` (hop divides L, L >
    hop, n >= L; its 128-lane hop term is the route's, not the
    kernel's).  Leading batch dims ride along.  A CPU tensor takes the
    plain version; a CUDA tensor launches ``csrc/stft.cu``."""
    frames = _check_stft(x, basis, frame_length, hop)
    _check_operands(x, basis)
    if x.device.type == "cpu":
        return stft_plain(x, basis, frame_length, hop)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n = int(x.shape[-1])
    rows = x.numel() // n
    cols = int(basis.shape[1])
    out = torch.empty((rows, frames, cols), dtype=torch.float32,
                      device=x.device)
    lead = tuple(x.shape[:-1])
    if rows == 0:
        return _as_spectrum(out, lead)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.veles_stft_f32(x.data_ptr(), basis.data_ptr(),
                                 out.data_ptr(), rows, n,
                                 int(frame_length), int(hop), frames, cols,
                                 stream)
    _check_err(lib, err, "stft kernel")
    LAUNCHES["stft"] += _launches(rows)
    return _as_spectrum(out, lead)
