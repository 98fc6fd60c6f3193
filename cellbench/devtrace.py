"""The card's kernel, copy and memset records, read from CUPTI's activity
API through ``ctypes``.

Copy of ``veles/simd_tpu_torch/utils/devtrace.py`` at commit
``6aec0c295a27add59d868157438f6a1a29c48632``, frozen here so that a
change to the program cannot move the yardstick, with three changes for
a traced window of many thousand calls:

* a :class:`Record` keeps its kind and both device stamps, so the union
  of busy intervals and the idle gaps can be read;
* a full buffer is only kept while the window runs, and its records are
  parsed once the window has closed, so CUPTI's thread holds the
  interpreter lock for no parsing while the host is being measured;
* :func:`timestamp` reads CUPTI's clock, so that host instants can be
  mapped onto the records' stamps.

``torch.profiler`` (kineto) lost kernel records on the H100 as a
process aged (the program's own finding, recorded in its module), so
the benchmark reads CUPTI itself.  One trace runs at a time in a
process, and no ``torch.profiler`` session beside it.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple

# CUpti_ActivityKind
KIND_MEMCPY, KIND_MEMSET, KIND_CONCURRENT_KERNEL = 1, 2, 10
_KINDS = (KIND_CONCURRENT_KERNEL, KIND_MEMCPY, KIND_MEMSET)
_SUCCESS = 0
_FLUSH_FORCED = 1
_BUFFER_BYTES = 4 << 20
_ALIGN = 8

# byte offsets of the fields read, by record kind (cupti_activity.h:
# CUpti_ActivityKernel4 and later, CUpti_ActivityMemcpy*, Memset*)
OFFSETS = {
    "kernel": {"start": 16, "end": 24, "name": 104},
    "memcpy": {"copyKind": 4, "srcKind": 5, "dstKind": 6,
               "start": 16, "end": 24},
    "memset": {"start": 16, "end": 24},
}
_COPY = ("Unknown", "HtoD", "DtoH", "HtoA", "AtoH", "AtoA", "AtoD", "DtoA",
         "DtoD", "HtoH", "PtoP")
_MEMORY = ("Unknown", "Pageable", "Pinned", "Device", "Array", "Managed",
           "Device Static", "Managed Static")


class Record(NamedTuple):
    """One device activity: ``kind`` is ``kernel``, ``memcpy`` or
    ``memset``; ``start`` and ``end`` are CUPTI nanoseconds."""

    kind: str
    name: str
    start: int
    end: int


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
    """The loaded library, its two buffer callbacks, and the filled
    buffers and dropped counts of the trace in progress."""

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
                ("cuptiGetTimestamp", [ctypes.POINTER(ctypes.c_uint64)]),
                ("cuptiGetResultString",
                 [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        self.lib = lib
        self.demangle = _demangler()
        self.lock = threading.Lock()
        self.buffers: dict[int, ctypes.Array] = {}
        self.filled: list[tuple[ctypes.Array, int, int]] = []
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
        dropped = ctypes.c_size_t()
        if self.lib.cuptiActivityGetNumDroppedRecords(
                ctx, stream, ctypes.byref(dropped)) != _SUCCESS:
            dropped.value = 0
        with self.lock:
            raw = self.buffers.pop(buf, None)
            if raw is not None and valid:
                self.filled.append((raw, buf, valid))
            self.dropped += dropped.value

    def parse_filled(self, filled) -> list[Record]:
        out = []
        for _raw, buf, valid in filled:
            rec = ctypes.c_void_p()     # NULL: the buffer's first record
            while self.lib.cuptiActivityGetNextRecord(
                    buf, valid, ctypes.byref(rec)) == _SUCCESS:
                r = parse(rec.value, self.names, self.demangle)
                if r is not None:
                    out.append(r)
        return out


def _label(names, i):
    return names[i] if 0 <= i < len(names) else "Unknown"


def parse(addr: int, names: dict, demangle=lambda name: name
          ) -> Record | None:
    """The :class:`Record` of the CUPTI activity record at ``addr``, or
    None for a kind not traced.  ``names`` caches kernel names by their
    string's address (CUPTI keeps one string a function)."""
    kind = ctypes.c_uint32.from_address(addr).value
    if kind == KIND_CONCURRENT_KERNEL:
        off, label = OFFSETS["kernel"], "kernel"
        ptr = ctypes.c_void_p.from_address(addr + off["name"]).value
        name = names.get(ptr)
        if name is None:
            raw = ctypes.string_at(ptr).decode(errors="replace") \
                if ptr else "?"
            name = names.setdefault(ptr, demangle(raw))
    elif kind == KIND_MEMCPY:
        off, label = OFFSETS["memcpy"], "memcpy"
        copy, src, dst = (ctypes.c_uint8.from_address(addr + off[k]).value
                          for k in ("copyKind", "srcKind", "dstKind"))
        name = (f"Memcpy {_label(_COPY, copy)} ({_label(_MEMORY, src)} -> "
                f"{_label(_MEMORY, dst)})")
    elif kind == KIND_MEMSET:
        off, label, name = OFFSETS["memset"], "memset", "Memset"
    else:
        return None
    start = ctypes.c_uint64.from_address(addr + off["start"]).value
    end = ctypes.c_uint64.from_address(addr + off["end"]).value
    return Record(label, name, start, max(start, end))


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


def timestamp() -> int:
    """CUPTI's clock now, in the nanoseconds its records carry."""
    c = _cupti()
    ts = ctypes.c_uint64()
    c.check(c.lib.cuptiGetTimestamp(ctypes.byref(ts)), "cuptiGetTimestamp")
    return ts.value


def trace(fn) -> tuple[list[Record], object]:
    """``(records, result)``: every kernel, copy and memset that the
    card ran while ``fn()`` ran, and ``fn``'s result.  The card is
    synchronized before the trace starts and before it ends; the records
    are parsed after that.  Raises if CUPTI reports a dropped record."""
    import torch

    c = _cupti()
    with _TRACE_LOCK:
        torch.cuda.synchronize()
        with c.lock:
            c.filled, c.dropped = [], 0
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
            filled, dropped = c.filled, c.dropped
            c.filled = []
        records = c.parse_filled(filled)
    if dropped:
        raise RuntimeError(f"CUPTI dropped {dropped} activity records")
    return records, result
