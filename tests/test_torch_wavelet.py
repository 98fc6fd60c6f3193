"""The port's wavelet slice against the JAX package.

The same NumPy inputs, made from a seed, go through
``veles.simd_tpu.ops.wavelet`` (on the CPU platform the root conftest
pins) and ``veles.simd_tpu_torch.ops.wavelet`` with ``device="cpu"``.

* Analysis: both sides are float32 with different summation orders, so
  outputs agree to 1e-5 of max|y|.  The JAX side runs its ``xla_conv``
  route and, forced, its ``pallas`` route (``filter_bank_pallas`` in
  interpret mode off the TPU); the port side its auto route (``conv1d``
  on the CPU) and, forced, its ``cuda`` route (the filter-bank
  kernel's plain version on a CPU tensor).
* The fused cascade: both gates opened (``should_route`` monkeypatched
  and ``VELES_SIMD_FORCE_FUSED_CASCADE`` set, as ``tests/test_pallas.py``
  does for the JAX side); the two fused results agree to 1e-5 of
  max|y| and each matches the level loop within that file's 5e-4.
* Synthesis: the JAX package's own tolerances from
  ``tests/test_wavelet_synthesis.py`` (5e-5 between backends, 2e-4 and
  5e-4 for round trips, 5e-3 for the non-periodic SWT).
* ``simd=False`` returns the same NumPy as the JAX ``_na`` twins.
"""

import dataclasses

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import pallas_kernels as jpk
from veles.simd_tpu.ops import wavelet as jw
from veles.simd_tpu_torch.ops import cuda_kernels as tck
from veles.simd_tpu_torch.ops import wavelet as tw
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

REL_TOL = 1e-5          # float32 against float32, relative to max|y|
SYNTH_TOL = 5e-5        # test_xla_vs_oracle_synthesis
TRIP_TOL = 2e-4         # test_dwt_round_trip / test_swt_round_trip
CASCADE_TRIP_TOL = 5e-4  # test_dwt_cascade_round_trip
NONPERIODIC_SWT_TOL = 5e-3  # test_swt_round_trip_nonperiodic
FUSED_TOL = 5e-4        # test_fused_cascade_vs_level_loop

WAVELETS = [("daub", 4), ("daub", 8), ("daub", 16), ("coif", 12),
            ("sym", 8)]
EXTS = [e.value for e in tw.ExtensionType]


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


def _np(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _pair_rel(got, want):
    assert len(got) == len(want)
    return max(_rel(g, w) for g, w in zip(got, want))


def _x(seed, shape=(8, 128)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("ext", EXTS)
@pytest.mark.parametrize("type,order", WAVELETS)
def test_dwt_agrees(type, order, ext):
    x = _x(order + len(ext))
    je, te = jw.ExtensionType(ext), tw.ExtensionType(ext)
    want = jw.wavelet_apply(type, order, je, x, simd=True,
                            route="xla_conv")
    for route in (None, "cuda", "xla_conv"):
        got = tw.wavelet_apply(type, order, te, x, route=route)
        assert all(isinstance(g, torch.Tensor) for g in got)
        assert _pair_rel(got, want) < REL_TOL, route


@pytest.mark.parametrize("ext", EXTS)
@pytest.mark.parametrize("type,order", WAVELETS)
def test_swt_agrees(type, order, ext):
    x = _x(3 * order + len(ext))
    je, te = jw.ExtensionType(ext), tw.ExtensionType(ext)
    for level in (1, 2, 3):
        want = jw.stationary_wavelet_apply(type, order, level, je, x,
                                           simd=True, route="xla_conv")
        for route in (None, "cuda"):
            got = tw.stationary_wavelet_apply(type, order, level, te, x,
                                              route=route)
            assert _pair_rel(got, want) < REL_TOL, (level, route)


@pytest.mark.parametrize("type,order", WAVELETS)
def test_kernel_routes_agree_with_pallas(type, order):
    # the JAX package's Pallas filter bank (interpret mode) against the
    # port's filter-bank route (plain version), one extension each
    ext = EXTS[order % len(EXTS)]
    je, te = jw.ExtensionType(ext), tw.ExtensionType(ext)
    x = _x(order, (9, 96))
    assert _pair_rel(tw.wavelet_apply(type, order, te, x, route="cuda"),
                     jw.wavelet_apply(type, order, je, x, simd=True,
                                      route="pallas")) < REL_TOL
    assert _pair_rel(
        tw.stationary_wavelet_apply(type, order, 2, te, x, route="cuda"),
        jw.stationary_wavelet_apply(type, order, 2, je, x, simd=True,
                                    route="pallas")) < REL_TOL


@pytest.mark.parametrize("ext", EXTS)
def test_multilevel_transforms_agree(ext):
    x = _x(11, (4, 256))
    je, te = jw.ExtensionType(ext), tw.ExtensionType(ext)
    got = tw.wavelet_transform("daub", 8, te, x, 3)
    want = jw.wavelet_transform("daub", 8, je, x, 3, simd=True)
    assert len(got) == len(want) == 4
    assert _pair_rel(got, want) < REL_TOL
    got = tw.stationary_wavelet_transform("sym", 8, te, x, 3)
    want = jw.stationary_wavelet_transform("sym", 8, je, x, 3, simd=True)
    assert _pair_rel(got, want) < REL_TOL


@pytest.mark.parametrize("type,order,levels,n", [
    ("daub", 8, 2, 256), ("daub", 8, 3, 512), ("sym", 8, 2, 256),
    ("daub", 4, 4, 1024), ("coif", 12, 2, 512),
    # the wrap (reach + 2^L samples) exceeds n
    ("daub", 8, 3, 56), ("daub", 2, 2, 4)])
def test_fused_cascade_agrees(monkeypatch, type, order, levels, n):
    monkeypatch.setattr(jpk, "should_route", lambda *a: True)
    monkeypatch.setattr(tck, "should_route", lambda *a: True)
    monkeypatch.setenv("VELES_SIMD_FORCE_FUSED_CASCADE", "1")
    P = tw.ExtensionType.PERIODIC
    x = _x(n + levels, (8, n))
    assert jw._use_fused_cascade(x.shape, order, jw.ExtensionType.PERIODIC,
                                 levels)
    assert tw._use_fused_cascade(x.shape, order, P, levels)
    got = tw.wavelet_transform(type, order, P, x, levels)
    want = jw.wavelet_transform(type, order, jw.ExtensionType.PERIODIC, x,
                                levels, simd=True)
    assert len(got) == levels + 1
    assert _pair_rel(got, want) < REL_TOL
    monkeypatch.delenv("VELES_SIMD_FORCE_FUSED_CASCADE")
    loop = tw.wavelet_transform(type, order, P, x, levels)
    for g, w in zip(got, loop):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= FUSED_TOL * scale


def test_fused_cascade_gate_terms(monkeypatch):
    monkeypatch.setattr(jpk, "should_route", lambda *a: True)
    P, M = tw.ExtensionType.PERIODIC, tw.ExtensionType.MIRROR
    cases = [((8, 256), 8, P, 2), ((8, 256), 8, M, 2), ((8, 256), 8, P, 1),
             ((8, 250), 8, P, 2), ((8, 64), 8, P, 4), ((8, 4096), 16, P, 3),
             ((8, 4096), 16, P, 4), ((8, 1024), 4, P, 4)]
    for force in (False, True):
        if force:
            monkeypatch.setenv("VELES_SIMD_FORCE_FUSED_CASCADE", "1")
        for shape, order, ext, levels in cases:
            want = jw._use_fused_cascade(shape, order,
                                         jw.ExtensionType(ext.value),
                                         levels)
            got = tw._use_fused_cascade(shape, order, ext, levels,
                                        cuda=True)
            assert got == want, (force, shape, order, ext, levels)
            # off the card the fused route never opens
            assert not tw._use_fused_cascade(shape, order, ext, levels)
    # the default is the level loop, as in the JAX package
    monkeypatch.delenv("VELES_SIMD_FORCE_FUSED_CASCADE")
    assert tw._CASCADE_FAMILY.static_select(
        rows=512, n=4096, order=8, ext="periodic", levels=3,
        cuda=True) == "level_loop"


@pytest.mark.parametrize("rows,n,order,level,stride", [
    (8, 4096, 8, 1, 2), (7, 4096, 8, 1, 2), (512, 4096, 8, 1, 2),
    (64, 1024, 16, 3, 1), (8, 4096, 76, 4, 1), (1, 64, 4, 1, 2)])
def test_route_priors_match(monkeypatch, rows, n, order, level, stride):
    monkeypatch.setattr(jpk, "pallas_available", lambda: True)
    dilation = 1 << (level - 1) if stride == 1 else 1
    geom = dict(rows=rows, n=n, order=order, dilation=dilation,
                stride=stride)
    want = jw._WAVELET_FAMILY.static_select(**geom)
    got = tw._WAVELET_FAMILY.static_select(cuda=True, **geom)
    assert got == tw.ROUTE_NAMES.get(want, want)
    assert tw._WAVELET_FAMILY.static_select(**geom) == "xla_conv"


def test_deep_swt_level_stays_on_conv1d():
    # dilation 2^13 at order 16: the block's input span does not fit
    # shared memory, so the kernel route refuses it
    assert not tck.fits_smem_fb(2, 16, 1, 1 << 13)
    assert tw._WAVELET_FAMILY.static_select(
        rows=64, n=1 << 16, order=16, dilation=1 << 13, stride=1,
        cuda=True) == "xla_conv"


@pytest.mark.parametrize("ext", EXTS)
def test_synthesis_agrees(ext):
    je, te = jw.ExtensionType(ext), tw.ExtensionType(ext)
    x = _x(21 + len(ext), (3, 128))
    for type, order in (("daub", 8), ("sym", 8)):
        hi, lo = jw.wavelet_apply_na(type, order, je, x)
        got = tw.wavelet_reconstruct(type, order, hi, lo, ext=te)
        want = jw.wavelet_reconstruct(type, order, hi, lo, simd=True,
                                      ext=je)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=SYNTH_TOL)
        for level in (1, 2):
            hi, lo = jw.stationary_wavelet_apply_na(type, order, level, je,
                                                    x)
            got = tw.stationary_wavelet_reconstruct(type, order, level, hi,
                                                    lo, ext=te)
            want = jw.stationary_wavelet_reconstruct(
                type, order, level, hi, lo, simd=True, ext=je)
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       atol=SYNTH_TOL)
            tol = TRIP_TOL if ext == "periodic" else NONPERIODIC_SWT_TOL
            np.testing.assert_allclose(_np(got), x, atol=tol)


@pytest.mark.parametrize("type,order", WAVELETS)
def test_periodic_round_trips(type, order):
    P = tw.ExtensionType.PERIODIC
    x = _x(5 * order, (2, 256))
    hi, lo = tw.wavelet_apply(type, order, P, x)
    np.testing.assert_allclose(_np(tw.wavelet_reconstruct(type, order, hi,
                                                          lo)), x,
                               atol=TRIP_TOL)
    coeffs = tw.wavelet_transform(type, order, P, x, 3)
    rec = tw.wavelet_inverse_transform(type, order, coeffs)
    np.testing.assert_allclose(_np(rec), x, atol=CASCADE_TRIP_TOL)
    coeffs = tw.stationary_wavelet_transform(type, order, P, x, 2)
    rec = tw.stationary_wavelet_inverse_transform(type, order, coeffs)
    np.testing.assert_allclose(_np(rec), x, atol=CASCADE_TRIP_TOL)
    want = jw.stationary_wavelet_inverse_transform(
        type, order, [_np(c) for c in coeffs], simd=True)
    np.testing.assert_allclose(_np(rec), np.asarray(want), atol=SYNTH_TOL)


def test_nonperiodic_dwt_least_squares_matches_jax():
    # the rank-deficient non-periodic DWT: both packages return the
    # same least-squares reconstruction, and re-analysis reproduces the
    # coefficients
    x = _x(31, (2, 128))
    for ext in ("mirror", "constant", "zero"):
        je, te = jw.ExtensionType(ext), tw.ExtensionType(ext)
        hi, lo = tw.wavelet_apply("daub", 8, te, x)
        rec = tw.wavelet_reconstruct("daub", 8, hi, lo, ext=te)
        want = jw.wavelet_reconstruct("daub", 8, _np(hi), _np(lo),
                                      simd=True, ext=je)
        np.testing.assert_allclose(_np(rec), np.asarray(want),
                                   atol=SYNTH_TOL)
        hi2, lo2 = tw.wavelet_apply("daub", 8, te, rec)
        np.testing.assert_allclose(_np(hi2), _np(hi), atol=2e-4)
        np.testing.assert_allclose(_np(lo2), _np(lo), atol=2e-4)
    # a signal shorter than 4 x the boundary support takes the float64
    # host path on both sides
    xs = _x(32, (2, 48))
    hi, lo = jw.wavelet_apply_na("daub", 8, jw.ExtensionType.MIRROR, xs)
    np.testing.assert_allclose(
        _np(tw.wavelet_reconstruct("daub", 8, hi, lo,
                                   ext=tw.ExtensionType.MIRROR)),
        np.asarray(jw.wavelet_reconstruct("daub", 8, hi, lo, simd=True,
                                          ext=jw.ExtensionType.MIRROR)),
        atol=SYNTH_TOL)


def test_2d_transforms_agree():
    P, JP = tw.ExtensionType.PERIODIC, jw.ExtensionType.PERIODIC
    img = _x(41, (2, 32, 48))
    got = tw.wavelet_apply2d("daub", 4, P, img)
    want = jw.wavelet_apply2d("daub", 4, JP, img, simd=True)
    assert _pair_rel(got, want) < REL_TOL
    rec = tw.wavelet_reconstruct2d("daub", 4, *got)
    np.testing.assert_allclose(_np(rec), img, atol=CASCADE_TRIP_TOL)
    got = tw.stationary_wavelet_apply2d("sym", 4, 2, P, img)
    want = jw.stationary_wavelet_apply2d("sym", 4, 2, JP, img, simd=True)
    assert _pair_rel(got, want) < REL_TOL
    rec = tw.stationary_wavelet_reconstruct2d("sym", 4, 2, *got)
    np.testing.assert_allclose(_np(rec), img, atol=CASCADE_TRIP_TOL)
    pyr = tw.wavelet_transform2d("daub", 4, P, img, 2)
    jpyr = jw.wavelet_transform2d("daub", 4, JP, img, 2, simd=True)
    for g, w in zip(pyr[:-1], jpyr[:-1]):
        assert _pair_rel(g, w) < REL_TOL
    assert _rel(pyr[-1], jpyr[-1]) < REL_TOL
    np.testing.assert_allclose(
        _np(tw.wavelet_inverse_transform2d("daub", 4, pyr)), img,
        atol=1e-3)
    with pytest.raises(ValueError, match="n0, n1"):
        tw.wavelet_apply2d("daub", 4, P, np.ones(8, np.float32))


def test_packets_agree():
    P, JP = tw.ExtensionType.PERIODIC, jw.ExtensionType.PERIODIC
    x = _x(43, (3, 128))
    got = tw.wavelet_packet_transform("daub", 8, P, x, 3)
    want = jw.wavelet_packet_transform("daub", 8, JP, x, 3, simd=True)
    assert len(got) == len(want) == 8
    assert _pair_rel(got, want) < REL_TOL
    np.testing.assert_allclose(
        _np(tw.wavelet_packet_inverse_transform("daub", 8, got)), x,
        atol=TRIP_TOL)
    img = _x(44, (32, 32))
    got = tw.wavelet_packet_transform2d("coif", 6, P, img, 2)
    want = jw.wavelet_packet_transform2d("coif", 6, JP, img, 2, simd=True)
    assert len(got) == 16
    assert _pair_rel(got, want) < REL_TOL
    np.testing.assert_allclose(
        _np(tw.wavelet_packet_inverse_transform2d("coif", 6, got)), img,
        atol=CASCADE_TRIP_TOL)


def test_oracles_identical():
    x = _x(47, (2, 64))
    for ext in EXTS:
        je, te = jw.ExtensionType(ext), tw.ExtensionType(ext)
        for g, w in zip(tw.wavelet_apply("daub", 8, te, x, simd=False),
                        jw.wavelet_apply_na("daub", 8, je, x)):
            assert isinstance(g, np.ndarray)
            np.testing.assert_array_equal(g, w)
        for g, w in zip(tw.stationary_wavelet_apply("coif", 6, 2, te, x,
                                                    simd=False),
                        jw.stationary_wavelet_apply_na("coif", 6, 2, je,
                                                       x)):
            np.testing.assert_array_equal(g, w)
        hi, lo = jw.wavelet_apply_na("daub", 8, je, x)
        np.testing.assert_array_equal(
            tw.wavelet_reconstruct("daub", 8, hi, lo, simd=False, ext=te),
            jw.wavelet_reconstruct_na("daub", 8, hi, lo, ext=je))
        np.testing.assert_array_equal(
            tw.stationary_wavelet_reconstruct("daub", 4, 2, hi, lo,
                                              simd=False, ext=te),
            jw.stationary_wavelet_reconstruct_na("daub", 4, 2, hi, lo,
                                                 ext=je))
    P, JP = tw.ExtensionType.PERIODIC, jw.ExtensionType.PERIODIC
    for g, w in zip(tw.wavelet_transform("sym", 8, P, x, 2, simd=False),
                    jw.wavelet_transform("sym", 8, JP, x, 2, simd=False)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(
            tw.wavelet_packet_transform("daub", 4, P, x, 2, simd=False),
            jw.wavelet_packet_transform("daub", 4, JP, x, 2, simd=False)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("call,match", [
    (lambda m, E, x: m.wavelet_apply("daub", 7, E.PERIODIC, x), "order 7"),
    (lambda m, E, x: m.wavelet_apply("coif", 8, E.PERIODIC, x),
     "coif order 8"),
    (lambda m, E, x: m.wavelet_apply("daub", 8, E.PERIODIC, x[..., :63]),
     "even"),
    (lambda m, E, x: m.stationary_wavelet_apply("daub", 8, 0, E.ZERO, x),
     "level"),
    (lambda m, E, x: m.wavelet_apply("daub", 8, E.PERIODIC, x,
                                     route="nope"), "route must be"),
    (lambda m, E, x: m.wavelet_reconstruct("daub", 8, x, x[..., :32]),
     "band shapes differ"),
    (lambda m, E, x: m.wavelet_reconstruct("daub", 8, x[:, :4],
                                           x[:, :4], ext=E.MIRROR),
     "length >= 16"),
    (lambda m, E, x: m.wavelet_inverse_transform("daub", 8, [x]),
     "L >= 1"),
    (lambda m, E, x: m.wavelet_packet_transform("daub", 8, E.PERIODIC, x,
                                                0), "levels"),
    (lambda m, E, x: m.wavelet_packet_inverse_transform("daub", 8,
                                                        [x, x, x]),
     "2\\^levels"),
])
@pytest.mark.parametrize("side", ["jax", "torch"])
def test_contract_errors_match(call, match, side):
    x = _x(53, (2, 64))
    if side == "jax":
        with pytest.raises(ValueError, match=match):
            call(_SimdJax, jw.ExtensionType, x)
    else:
        with pytest.raises(ValueError, match=match):
            call(tw, tw.ExtensionType, x)


class _SimdJax:
    """The JAX module with ``simd=True`` pinned on its entry points."""

    def __getattr__(self, name):
        fn = getattr(jw, name)
        return lambda *a, **k: fn(*a, simd=True, **k)


_SimdJax = _SimdJax()


def test_shims_match():
    x = _x(59, (16,))
    np.testing.assert_array_equal(tw.wavelet_prepare_array(8, x),
                                  jw.wavelet_prepare_array(8, x))
    np.testing.assert_array_equal(tw.wavelet_allocate_destination(8, 16),
                                  jw.wavelet_allocate_destination(8, 16))
    for g, w in zip(tw.wavelet_recycle_source(8, x),
                    jw.wavelet_recycle_source(8, x)):
        np.testing.assert_array_equal(g, w)
    assert tw.wavelet_recycle_source(8, x[:6]) == (None,) * 4
    assert tw.supported_orders("coif") == jw.supported_orders("coif")
    assert tw.wavelet_validate_order("sym", 76)
    assert not tw.wavelet_validate_order("daub", 78)


def test_cpu_routes_launch_nothing_and_keep_device():
    tck.reset_launches()
    x = torch.from_numpy(_x(61, (16, 256)))
    hi, lo = tw.wavelet_apply("daub", 8, tw.ExtensionType.PERIODIC, x,
                              route="cuda")
    assert hi.device == x.device and hi.dtype == torch.float32
    tw.wavelet_transform("daub", 8, tw.ExtensionType.PERIODIC, x, 3)
    assert all(v == 0 for v in tck.LAUNCHES.values())
    # float64 input computes in float32
    y64 = tw.wavelet_apply("daub", 8, tw.ExtensionType.ZERO,
                           x.double().numpy())
    assert y64[0].dtype == torch.float32
