"""The port's CUPTI record reader (``utils/devtrace.py``) on the CPU:
records laid out at ``cupti_activity.h``'s offsets parse to their names
and device times, and the library is found or refused.  Reading records
from the card is tested in ``tests/test_torch_cuda.py``."""

import ctypes
import struct

import pytest
import torch

from veles.simd_tpu_torch.utils import devtrace as dt


def _record(kind, fields, size=256):
    buf = ctypes.create_string_buffer(size)
    struct.pack_into("<I", buf, 0, kind)
    for fmt, off, value in fields:
        struct.pack_into(fmt, buf, off, value)
    return buf


def test_kernel_record_parses_and_demangles():
    name = ctypes.create_string_buffer(
        b"_ZN2at6native29vectorized_elementwise_kernelILi4EEEviT_")
    off = dt.OFFSETS["kernel"]
    buf = _record(dt.KIND_CONCURRENT_KERNEL, [
        ("<Q", off["start"], 1_000), ("<Q", off["end"], 3_500),
        ("<Q", off["name"], ctypes.addressof(name))])
    names = {}
    rec = dt.parse(ctypes.addressof(buf), names, dt._demangler())
    assert rec.ns == 2_500
    assert "vectorized_elementwise_kernel" in rec.name
    assert not rec.name.startswith("_Z")
    # the name is read once a string: the cache answers after that
    assert names == {ctypes.addressof(name): rec.name}
    name.value = b"changed"
    assert dt.parse(ctypes.addressof(buf), names).name == rec.name


def test_kernel_record_without_a_demangler_keeps_the_raw_name():
    name = ctypes.create_string_buffer(b"cb_frames")
    off = dt.OFFSETS["kernel"]
    buf = _record(dt.KIND_CONCURRENT_KERNEL, [
        ("<Q", off["start"], 7), ("<Q", off["end"], 5),
        ("<Q", off["name"], ctypes.addressof(name))])
    # an end before the start reads as no time, never a negative one
    assert dt.parse(ctypes.addressof(buf), {}) == dt.Record("cb_frames", 0)


@pytest.mark.parametrize("copy, src, dst, want", [
    (1, 1, 3, "Memcpy HtoD (Pageable -> Device)"),
    (2, 3, 2, "Memcpy DtoH (Device -> Pinned)"),
    (8, 3, 3, "Memcpy DtoD (Device -> Device)"),
    (99, 42, 3, "Memcpy Unknown (Unknown -> Device)")])
def test_memcpy_record_names_its_direction(copy, src, dst, want):
    off = dt.OFFSETS["memcpy"]
    buf = _record(dt.KIND_MEMCPY, [
        ("<B", off["copyKind"], copy), ("<B", off["srcKind"], src),
        ("<B", off["dstKind"], dst), ("<Q", off["bytes"], 64),
        ("<Q", off["start"], 100), ("<Q", off["end"], 160)])
    assert dt.parse(ctypes.addressof(buf), {}) == dt.Record(want, 60)


def test_memset_and_untraced_kinds():
    off = dt.OFFSETS["memset"]
    buf = _record(dt.KIND_MEMSET, [("<Q", off["start"], 10),
                                   ("<Q", off["end"], 30)])
    assert dt.parse(ctypes.addressof(buf), {}) == dt.Record("Memset", 20)
    for kind in (0, 3, 5, 22):
        assert dt.parse(ctypes.addressof(_record(kind, [])), {}) is None


def test_library_path_takes_a_candidate_then_refuses(monkeypatch, tmp_path):
    monkeypatch.setattr(dt, "_STATE", {})
    lib = tmp_path / "libcupti.so.12"
    lib.write_bytes(b"")
    monkeypatch.setattr(dt, "_candidates",
                        lambda: [str(tmp_path / "missing.so"), str(lib)])
    mapped = dt.library_path()
    # a process that maps a libcupti already uses that one
    assert mapped == str(lib) or "/libcupti.so" in mapped
    # no candidate: only a library the process maps remains
    monkeypatch.setattr(dt, "_candidates", lambda: [])
    got = dt.library_path()
    assert got is None or "/libcupti.so" in got
    monkeypatch.setattr(dt, "library_path", lambda: None)
    with pytest.raises(RuntimeError, match="no libcupti"):
        dt.trace(lambda: None)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU's answer")
def test_trace_without_a_card_raises_before_running_anything(monkeypatch):
    monkeypatch.setattr(dt, "_STATE", {})
    ran = []
    # no libcupti here, or a torch built without CUDA: either way the
    # function never runs untraced
    with pytest.raises((RuntimeError, AssertionError)):
        dt.trace(lambda: ran.append(1))
    assert ran == []
