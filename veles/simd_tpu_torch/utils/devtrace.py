"""The card's kernel, copy and memset records, read from CUPTI's activity
API through ``ctypes`` (the port's own; the JAX package reads its
device time from ``jax.profiler``).

:func:`trace` runs a function with CUPTI recording every kernel
(``CONCURRENT_KERNEL``), copy and memset, and returns one
:class:`Record` each, in the order CUPTI delivered them.  A record's
duration is its ``end - start``, two stamps of the same device clock.
Nothing is matched against the host's clock or filtered by a window.
``torch.profiler`` (kineto) lost kernel records on the H100 while it
kept every launch's runtime record: the share it lost grew with the
process's age, to all of a window's kernels within two minutes, with
or without padding, threads or a forced flush
(``tools/time_torch_profiler_sessions.py``).

The library is the ``libcupti`` that the process has mapped already
(torch's), else the first that exists of torch's ``nvidia.cuda_cupti``
wheel's and the CUDA toolkit's.  Records
are read at the byte offsets of ``cupti_activity.h``'s
``CUpti_ActivityKernel*`` (from version 4 on), ``CUpti_ActivityMemcpy*``
and ``CUpti_ActivityMemset*``, whose leading fields every CUDA 12
release keeps; ``tests/test_torch_cuda.py`` holds them against the
toolkit's header on the card.  One trace runs at a time in a process,
and none while a ``torch.profiler`` session is open.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple

__all__ = ["Record", "trace", "parse", "library_path", "OFFSETS"]

# CUpti_ActivityKind
KIND_MEMCPY, KIND_MEMSET, KIND_CONCURRENT_KERNEL = 1, 2, 10
_KINDS = (KIND_CONCURRENT_KERNEL, KIND_MEMCPY, KIND_MEMSET)
# CUptiResult
_SUCCESS = 0
_FLUSH_FORCED = 1
_BUFFER_BYTES = 1 << 20
_ALIGN = 8

# byte offsets of the fields read, by record kind
OFFSETS = {
    "kernel": {"start": 16, "end": 24, "correlationId": 92, "name": 104},
    "memcpy": {"copyKind": 4, "srcKind": 5, "dstKind": 6, "bytes": 8,
               "start": 16, "end": 24},
    "memset": {"bytes": 8, "start": 16, "end": 24},
}
# CUpti_ActivityMemcpyKind and CUpti_ActivityMemoryKind, named as
# torch.profiler names its copies ("Memcpy HtoD (Pageable -> Device)")
_COPY = ("Unknown", "HtoD", "DtoH", "HtoA", "AtoH", "AtoA", "AtoD", "DtoA",
         "DtoD", "HtoH", "PtoP")
_MEMORY = ("Unknown", "Pageable", "Pinned", "Device", "Array", "Managed",
           "Device Static", "Managed Static")


class Record(NamedTuple):
    """One device activity: its name and its device nanoseconds."""

    name: str
    ns: int


def _candidates() -> list[str]:
    found = []
    try:
        import nvidia.cuda_cupti as wheel

        found += [str(Path(p) / "lib" / "libcupti.so.12")
                  for p in wheel.__path__]
    except ImportError:
        pass
    return found + ["/usr/local/cuda/lib64/libcupti.so",
                    "/usr/local/cuda/extras/CUPTI/lib64/libcupti.so"]


def library_path() -> str | None:
    """The ``libcupti`` this process maps, else the first candidate
    that exists, else None."""
    maps = Path("/proc/self/maps")
    if maps.exists():
        for line in maps.read_text().splitlines():
            path = line.split()[-1]
            if "/libcupti.so" in path:
                return path
    return next((c for c in _candidates() if Path(c).exists()), None)


def _demangler():
    try:
        lib = ctypes.CDLL("libstdc++.so.6")
    except OSError:
        return lambda name: name
    fn = lib.__cxa_demangle
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_void_p
    free = ctypes.CDLL(None).free
    free.argtypes, free.restype = [ctypes.c_void_p], None

    def demangle(name: str) -> str:
        if not name.startswith("_Z"):
            return name
        status = ctypes.c_int()
        out = fn(name.encode(), None, None, ctypes.byref(status))
        if status.value != 0 or not out:
            return name
        try:
            return ctypes.string_at(out).decode(errors="replace")
        finally:
            free(out)

    return demangle


_REQUEST = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_void_p),
                            ctypes.POINTER(ctypes.c_size_t),
                            ctypes.POINTER(ctypes.c_size_t))
_COMPLETE = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_uint32,
                             ctypes.c_void_p, ctypes.c_size_t,
                             ctypes.c_size_t)


class _Cupti:
    """The loaded library, its two buffer callbacks, and the records
    and dropped counts of the trace in progress."""

    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        self.path = path
        for name, args in (
                ("cuptiActivityRegisterCallbacks",
                 [_REQUEST, _COMPLETE]),
                ("cuptiActivityEnable", [ctypes.c_int]),
                ("cuptiActivityDisable", [ctypes.c_int]),
                ("cuptiActivityFlushAll", [ctypes.c_uint32]),
                ("cuptiActivityGetNextRecord",
                 [ctypes.c_void_p, ctypes.c_size_t,
                  ctypes.POINTER(ctypes.c_void_p)]),
                ("cuptiActivityGetNumDroppedRecords",
                 [ctypes.c_void_p, ctypes.c_uint32,
                  ctypes.POINTER(ctypes.c_size_t)]),
                ("cuptiGetResultString",
                 [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        self.lib = lib
        self.demangle = _demangler()
        self.lock = threading.Lock()
        self.buffers: dict[int, ctypes.Array] = {}
        self.records: list[Record] = []
        self.dropped = 0
        self.names: dict[int, str] = {}
        # CUPTI calls these from its own thread: keep them alive
        self._request = _REQUEST(self._on_request)
        self._complete = _COMPLETE(self._on_complete)

    def check(self, rc: int, what: str) -> None:
        if rc != _SUCCESS:
            text = ctypes.c_char_p()
            self.lib.cuptiGetResultString(rc, ctypes.byref(text))
            raise RuntimeError(f"{what} failed: CUPTI error {rc} "
                               f"({(text.value or b'?').decode()})")

    def _on_request(self, buf, size, max_records):
        raw = ctypes.create_string_buffer(_BUFFER_BYTES + _ALIGN)
        addr = ctypes.addressof(raw)
        aligned = addr + (-addr) % _ALIGN
        with self.lock:
            self.buffers[aligned] = raw
        buf[0] = aligned
        size[0] = _BUFFER_BYTES
        max_records[0] = 0

    def _on_complete(self, ctx, stream, buf, size, valid):
        got = []
        rec = ctypes.c_void_p()
        while valid and self.lib.cuptiActivityGetNextRecord(
                buf, valid, ctypes.byref(rec)) == _SUCCESS:
            got.append(parse(rec.value, self.names, self.demangle))
        dropped = ctypes.c_size_t()
        if self.lib.cuptiActivityGetNumDroppedRecords(
                ctx, stream, ctypes.byref(dropped)) != _SUCCESS:
            dropped.value = 0
        with self.lock:
            self.records.extend(r for r in got if r is not None)
            self.dropped += dropped.value
            self.buffers.pop(buf, None)


def _label(names, i):
    return names[i] if 0 <= i < len(names) else "Unknown"


def parse(addr: int, names: dict, demangle=lambda name: name
          ) -> Record | None:
    """The :class:`Record` of the CUPTI activity record at ``addr``, or
    None for a kind not traced.  ``names`` caches kernel names by their
    string's address (CUPTI keeps one string a function)."""
    kind = ctypes.c_uint32.from_address(addr).value
    if kind == KIND_CONCURRENT_KERNEL:
        off = OFFSETS["kernel"]
        ptr = ctypes.c_void_p.from_address(addr + off["name"]).value
        name = names.get(ptr)
        if name is None:
            raw = ctypes.string_at(ptr).decode(errors="replace") \
                if ptr else "?"
            name = names.setdefault(ptr, demangle(raw))
    elif kind == KIND_MEMCPY:
        off = OFFSETS["memcpy"]
        copy, src, dst = (ctypes.c_uint8.from_address(addr + off[k]).value
                          for k in ("copyKind", "srcKind", "dstKind"))
        name = (f"Memcpy {_label(_COPY, copy)} ({_label(_MEMORY, src)} -> "
                f"{_label(_MEMORY, dst)})")
    elif kind == KIND_MEMSET:
        off = OFFSETS["memset"]
        name = "Memset"
    else:
        return None
    start = ctypes.c_uint64.from_address(addr + off["start"]).value
    end = ctypes.c_uint64.from_address(addr + off["end"]).value
    return Record(name, max(0, end - start))


_STATE: dict[str, _Cupti] = {}
_TRACE_LOCK = threading.Lock()


def _cupti() -> _Cupti:
    if "cupti" not in _STATE:
        path = library_path()
        if path is None:
            raise RuntimeError("no libcupti found: neither torch's "
                               "nvidia.cuda_cupti wheel nor the CUDA "
                               "toolkit's")
        _STATE["cupti"] = _Cupti(path)
    return _STATE["cupti"]


def trace(fn) -> tuple[list[Record], object]:
    """``(records, result)``: every kernel, copy and memset that the
    card ran while ``fn()`` ran, and ``fn``'s result.  The card is
    synchronized before the trace starts and before it ends.  Raises
    if CUPTI reports a dropped record."""
    import torch

    c = _cupti()
    with _TRACE_LOCK:
        torch.cuda.synchronize()
        with c.lock:
            c.records, c.dropped = [], 0
        # kineto registers its own callbacks when a torch.profiler
        # session starts: register ours again before every trace
        c.check(c.lib.cuptiActivityRegisterCallbacks(c._request,
                                                     c._complete),
                "cuptiActivityRegisterCallbacks")
        enabled = []
        try:
            for kind in _KINDS:
                c.check(c.lib.cuptiActivityEnable(kind),
                        f"cuptiActivityEnable({kind})")
                enabled.append(kind)
            result = fn()
            torch.cuda.synchronize()
            c.check(c.lib.cuptiActivityFlushAll(_FLUSH_FORCED),
                    "cuptiActivityFlushAll")
        finally:
            for kind in enabled:
                c.lib.cuptiActivityDisable(kind)
        with c.lock:
            records, dropped = c.records, c.dropped
            c.records = []
    if dropped:
        raise RuntimeError(f"CUPTI dropped {dropped} activity records")
    return records, result
