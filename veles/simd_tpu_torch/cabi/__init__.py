"""The port's C ABI: csrc's bridge, built against the port.

``veles_simd.c`` here is ``csrc/veles_simd.c`` importing
:mod:`veles.simd_tpu_torch.cshim` in place of the JAX package's shim;
``veles_simd.h`` declares exactly what csrc's header declares, and
``veles_simd_memory.c`` / ``veles_simd_arithmetic.c`` are csrc's pure-C
helpers.  Nothing is included from ``csrc/``.

:func:`build_library` compiles them with ``gcc`` at first use, with
``python3-config --includes`` and ``--ldflags --embed``, into
``build/simd_tpu_torch/cabi/<hash of sources and flags>/libveles_simd.so``.
The file keeps csrc's name, so a C program linked against csrc's
library runs on the port when its loader path names this directory.
:func:`build_program` compiles a C program (``csrc/test_veles_simd.c``,
``examples/c_matched_filter.c``) against it, and :func:`load` opens it
with ``ctypes`` inside a running interpreter (the bridge's
``PyGILState`` path: the shim runs in that interpreter).  The builds
write under a pid-tagged name and rename, so concurrent builds never
collide, and an unchanged source is found again by any later process.

This module imports neither the shim nor torch and touches no card:
the build needs only a C compiler and Python's headers.  A program
built here finds the package through ``$VELES_SIMD_PYROOT``
(:func:`program_env`), and computes on the card unless
``VELES_SIMD_PLATFORM=cpu``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CabiBuildError", "LIB_NAME", "toolchain", "build_library",
           "build_program", "program_env", "load"]

_HERE = Path(__file__).resolve().parent
_REPO = _HERE.parents[2]
_SOURCES = ("veles_simd.c", "veles_simd_memory.c", "veles_simd_arithmetic.c")
_HEADER = "veles_simd.h"
# csrc/Makefile's CFLAGS
_CFLAGS = ("-O2", "-g", "-Wall", "-Wextra", "-fPIC", "-std=c11")
_BUILD_ROOT = _REPO / "build" / "simd_tpu_torch" / "cabi"
LIB_NAME = "libveles_simd.so"

_lock = threading.Lock()


class CabiBuildError(RuntimeError):
    """The bridge or a program could not be built: no ``gcc``, no
    ``python3-config`` or Python headers, or the compiler failing."""


def _config_flags(*args: str) -> list:
    out = subprocess.run(["python3-config", *args], capture_output=True,
                         text=True, check=True)
    return out.stdout.split()


def toolchain() -> dict | None:
    """``{"cc", "includes", "ldflags"}`` for building the bridge, or
    None when ``gcc``, ``python3-config`` or ``Python.h`` is missing."""
    cc = shutil.which("gcc")
    if cc is None or shutil.which("python3-config") is None:
        return None
    try:
        includes = _config_flags("--includes")
        ldflags = _config_flags("--ldflags", "--embed")
    except (OSError, subprocess.CalledProcessError):
        return None
    if not any(Path(flag[2:], "Python.h").exists() for flag in includes
               if flag.startswith("-I")):
        return None
    return {"cc": cc, "includes": includes, "ldflags": ldflags}


def _require_toolchain() -> dict:
    tc = toolchain()
    if tc is None:
        raise CabiBuildError(
            "the C bridge needs gcc, python3-config and Python's headers "
            "(Python.h)")
    return tc


def _digest(tc: dict, *parts: bytes) -> str:
    h = hashlib.sha256(" ".join([*_CFLAGS, tc["cc"], *tc["includes"],
                                 *tc["ldflags"]]).encode())
    for part in parts:
        h.update(part)
    return h.hexdigest()[:16]


def _tag() -> str:
    return f"{os.getpid()}.{threading.get_ident()}"


def _run(cmd: list, what: str) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise CabiBuildError(f"{what} failed (rc {proc.returncode}):\n"
                             f"{' '.join(cmd)}\n{proc.stdout}"
                             f"{proc.stderr}")


def build_library() -> Path:
    """The port's ``libveles_simd.so``, built on first use under
    ``build/simd_tpu_torch/cabi/`` in a directory named by the hash of
    its sources and flags; returns its path."""
    tc = _require_toolchain()
    sources = [(_HERE / name).read_bytes()
               for name in (*_SOURCES, _HEADER)]
    out_dir = _BUILD_ROOT / _digest(tc, *sources)
    lib = out_dir / LIB_NAME
    with _lock:
        if lib.exists():
            return lib
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = _tag()
        objs, procs = [], []
        for name in _SOURCES:
            obj = out_dir / f"{name}.{tag}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [tc["cc"], *_CFLAGS, f"-I{_HERE}", *tc["includes"], "-c",
                 str(_HERE / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, proc in zip(_SOURCES, procs):
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"== {name} (rc {proc.returncode})\n{log}")
        try:
            if failed:
                raise CabiBuildError("gcc failed:\n" + "\n".join(failed))
            tmp = out_dir / f"{LIB_NAME}.{tag}"
            _run([tc["cc"], "-shared", *map(str, objs), *tc["ldflags"],
                  "-o", str(tmp)], "linking the bridge")
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
    return lib


def build_program(source) -> Path:
    """Compile the C program ``source`` against the port's library
    (csrc/Makefile's rule: its header, ``-lveles_simd``, an
    ``$ORIGIN`` run path, the embed flags and ``-lm``); returns the
    binary, which lives beside the library."""
    tc = _require_toolchain()
    lib = build_library()
    src = Path(source).resolve()
    out = lib.parent / f"{src.stem}-{_digest(tc, src.read_bytes())}"
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{_tag()}")
    _run([tc["cc"], *_CFLAGS, f"-I{_HERE}", str(src), f"-L{lib.parent}",
          "-lveles_simd", "-Wl,-rpath,$ORIGIN", *tc["ldflags"], "-lm",
          "-o", str(tmp)], f"compiling {src.name}")
    os.replace(tmp, out)
    return out


def program_env(platform: str | None = None) -> dict:
    """The environment a program built here runs in: this process's,
    with ``$VELES_SIMD_PYROOT`` naming the checkout that holds the
    package, and ``$VELES_SIMD_PLATFORM`` set to ``platform``
    (``"cpu"`` computes on the CPU) or removed (the card)."""
    out = dict(os.environ)
    out["VELES_SIMD_PYROOT"] = str(_REPO)
    if platform is None:
        out.pop("VELES_SIMD_PLATFORM", None)
    else:
        out["VELES_SIMD_PLATFORM"] = platform
    return out


_P = ctypes.c_void_p
_F = ctypes.POINTER(ctypes.c_float)
_S = ctypes.c_size_t
_I = ctypes.c_int


def load(path=None) -> ctypes.CDLL:
    """The bridge opened with ``ctypes`` in this process (built first
    when ``path`` is None), with ``argtypes``/``restype`` declared for
    the runtime entries and the kernels' entries: ``convolve_initialize``
    / ``convolve`` / ``convolve_finalize``, ``stft``, ``convolve2d`` and
    ``wavelet_apply2d``.  ``ctypes`` releases the GIL around each call
    and the bridge takes it back, so the shim runs in this interpreter,
    on its ``Config`` and its launch counters."""
    lib = ctypes.CDLL(str(path or build_library()))
    lib.veles_simd_init.argtypes = [ctypes.c_char_p]
    lib.veles_simd_init.restype = _I
    for name in ("veles_simd_backend", "veles_simd_last_error"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_char_p
    lib.convolve_initialize.argtypes = [_S, _S, _I]
    lib.convolve_initialize.restype = _P
    lib.convolve.argtypes = [_P, _F, _F, _F]
    lib.convolve.restype = _I
    lib.convolve_finalize.argtypes = [_P]
    lib.convolve_finalize.restype = None
    lib.stft.argtypes = [_I, _F, _S, _S, _S, _F, _F]
    lib.stft.restype = _I
    lib.convolve2d.argtypes = [_I, _F, _S, _S, _F, _S, _S, _F]
    lib.convolve2d.restype = _I
    lib.wavelet_apply2d.argtypes = [_I, _I, _I, _I, _F, _S, _S, _F, _F,
                                    _F, _F]
    lib.wavelet_apply2d.restype = _I
    return lib
