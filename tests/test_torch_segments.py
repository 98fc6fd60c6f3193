"""The port's ragged segment packing against the JAX package's.

``veles.simd_tpu_torch.ops.segments`` on the CPU: the packing plan
equals the JAX package's; ``packed_stft`` and ``packed_convolve`` on the
three mixed-length mixes of each kind of ``tests/test_segments.py``
agree with the JAX package's packed results and with the port's own
unpacked per-segment calls (within 1e-5 of max|y| for convolve, 1e-4
for the STFT: the packed and the lone segment may take different
routes); a poisoned ``segments.segment@i`` degrades segment i alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import segments as jseg
from veles.simd_tpu.runtime import faults as jfaults
from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.ops import convolve as cv
from veles.simd_tpu_torch.ops import cuda_kernels as ck
from veles.simd_tpu_torch.ops import segments as seg
from veles.simd_tpu_torch.ops import spectral as sp
from veles.simd_tpu_torch.runtime import breaker, faults
from veles.simd_tpu_torch.utils import config

torch.set_num_threads(1)

CONV_TOL = 1e-5
STFT_TOL = 1e-4

STFT_MIXES = (
    (128, 131, 200, 256),
    (513, 128, 257, 130, 384),
    (1200, 128, 150, 128, 200, 777),
)
CONV_MIXES = (
    (64, 100, 31),
    (513, 64, 257, 130),
    (1200, 64, 150, 48, 777),
)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    prev = config.get_config()
    config.set_config(device="cpu")
    monkeypatch.setenv("VELES_SIMD_FAULT_BACKOFF", "0")
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    for f in (faults, jfaults):
        f.set_fault_plan(None)
        f.reset_fault_history()
    yield
    for f in (faults, jfaults):
        f.set_fault_plan(None)
        f.reset_fault_history()
    config.set_config(**dataclasses.asdict(prev))


def _segs(lengths, seed=1234):
    r = np.random.RandomState(seed + sum(lengths))
    return [r.randn(n).astype(np.float32) for n in lengths]


def _rel(got, want):
    got = np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# --- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("strides,width", [
    ([200, 100, 700], None), ([600, 600, 400, 400], 1024),
    ([200, 100, 700, 513, 64, 300, 128], None), ([1], None),
    ([5, 5, 5, 5, 5], 10), ([1023, 1, 1024, 2], 2048)])
def test_plan_pack_equals_the_jax_package(strides, width):
    assert seg.plan_pack(strides, width) == jseg.plan_pack(strides, width)


@pytest.mark.parametrize("n,hop,m", [(128, 64, 17), (130, 64, 1),
                                     (1, 64, 129), (2800, 128, 2047)])
def test_strides_equal_the_jax_package(n, hop, m):
    assert seg.stft_stride(n, hop) == jseg.stft_stride(n, hop)
    assert seg.convolve_stride(n, m) == jseg.convolve_stride(n, m)


def test_plan_pack_rejects_bad_strides():
    with pytest.raises(ValueError):
        seg.plan_pack([0, 10])
    with pytest.raises(ValueError):
        seg.plan_pack([10, 2000], width=1024)


def test_all_equals_the_jax_module():
    assert seg.__all__ == jseg.__all__


# --- packed vs the JAX package and vs unpacked ------------------------------

@pytest.mark.parametrize("lengths", STFT_MIXES)
def test_packed_stft_agrees(lengths):
    segs = _segs(lengths)
    outs, degraded = seg.packed_stft(segs, 128, 64, simd=True)
    want, jdegraded = jseg.packed_stft(segs, 128, 64, simd=True)
    assert degraded == jdegraded == [False] * len(segs)
    for out, w, s in zip(outs, want, segs):
        assert isinstance(out, np.ndarray) and out.dtype == np.complex64
        assert _rel(out, w) < STFT_TOL
        assert _rel(out, sp.stft(s, 128, 64)) < STFT_TOL


@pytest.mark.parametrize("lengths", CONV_MIXES)
def test_packed_convolve_agrees(lengths):
    segs = _segs(lengths)
    h = np.random.RandomState(7).randn(17).astype(np.float32)
    outs, degraded = seg.packed_convolve(segs, h, simd=True)
    want, jdegraded = jseg.packed_convolve(segs, h, simd=True)
    assert degraded == jdegraded == [False] * len(segs)
    for out, w, s in zip(outs, want, segs):
        assert isinstance(out, np.ndarray) and out.dtype == np.float32
        assert _rel(out, w) < CONV_TOL
        handle = cv.convolve_initialize(
            s.shape[0], 17, algorithm=cv.ConvolutionAlgorithm.BRUTE_FORCE)
        assert _rel(out, cv.convolve(handle, s, h)) < CONV_TOL


def test_packed_rows_on_the_kernel_route_agree(monkeypatch):
    # the direct gate forced open: the packed rows take the filter
    # bank's plain version, as the card takes K2 from 8 rows
    monkeypatch.setattr(ck, "should_route", lambda *a: True)
    segs = _segs((300,) * 9 + (41,))
    h = np.random.RandomState(8).randn(33).astype(np.float32)
    outs, _ = seg.packed_convolve(segs, h, simd=True)
    for out, s in zip(outs, segs):
        assert _rel(out, cv.convolve_na(s, h)) < CONV_TOL


def test_oracle_twins_match():
    segs = _segs((200, 128, 300))
    device, _ = seg.packed_stft(segs, 128, 64, simd=True)
    oracle, _ = seg.packed_stft(segs, 128, 64, simd=False)
    jor, _ = jseg.packed_stft(segs, 128, 64, simd=False)
    for d, o, j in zip(device, oracle, jor):
        assert np.array_equal(o, j)
        assert _rel(d, o) < STFT_TOL
    h = np.ones(5, np.float32)
    for o, j in zip(seg.packed_convolve(segs, h, simd=False)[0],
                    jseg.packed_convolve(segs, h, simd=False)[0]):
        assert np.array_equal(o, j)


def test_packed_rejects_malformed_segments():
    with pytest.raises(ValueError):
        seg.packed_stft([np.zeros((2, 2), np.float32)], 128, 64)
    with pytest.raises(ValueError):
        seg.packed_convolve([], np.ones(3, np.float32))


# --- fault isolation --------------------------------------------------------

@pytest.mark.parametrize("poisoned", [0, 1, 2])
def test_one_poisoned_segment_degrades_only_its_ticket(poisoned):
    segs = _segs((200, 128, 300))
    faults.set_fault_plan(
        "segments.dispatch@stft:device_lost:3,"
        f"segments.segment@{poisoned}:device_lost:1")
    outs, degraded = seg.packed_stft(segs, 128, 64, simd=True)
    assert degraded == [i == poisoned for i in range(3)]
    for out, s in zip(outs, segs):
        assert _rel(out, sp.stft_na(s, 128, 64)) < STFT_TOL


def test_kernel_route_device_loss_reaches_the_segment_policy():
    # the packed K4 rows run under segments.dispatch alone: a device
    # loss there exhausts the packed retries, and each segment's
    # salvage then lands on its oracle, flagged
    segs = _segs((300, 256, 400))
    faults.set_fault_plan("spectral.stft_cuda:device_lost:9999")
    outs, degraded = seg.packed_stft(segs, 256, 128, simd=True)
    assert degraded == [True, True, True]
    for out, s in zip(outs, segs):
        assert _rel(out, sp.stft_na(s, 256, 128)) < STFT_TOL
    sites = {r["site"] for r in faults.fault_history()}
    assert sites == {"segments.dispatch", "segments.segment"}


def test_fault_free_salvage_flags_nobody():
    segs = _segs((200, 128))
    h = np.random.RandomState(9).randn(9).astype(np.float32)
    faults.set_fault_plan("segments.dispatch@convolve:device_lost:3")
    outs, degraded = seg.packed_convolve(segs, h, simd=True)
    assert degraded == [False, False]
    for out, s in zip(outs, segs):
        assert _rel(out, cv.convolve_na(s, h)) < CONV_TOL


def test_packed_dispatch_site_carries_breaker_key():
    seg.packed_stft(_segs((200, 128)), 128, 64, simd=True,
                    key="r0|stft|ragged")
    assert breaker.lookup("segments.dispatch", "r0|stft|ragged") \
        is not None


def test_packed_dispatch_emits_its_span():
    was_on = obs.enabled()
    obs.enable()
    obs.reset()
    try:
        seg.packed_stft(_segs((200, 128, 300)), 128, 64, simd=True)
        names = {h["name"] for h in obs.snapshot()["histograms"]}
        assert "span.segments.pack.dispatch" in names
    finally:
        if not was_on:
            obs.disable()
        obs.reset()
