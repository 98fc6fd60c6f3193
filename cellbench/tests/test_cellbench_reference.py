"""The plain references against NumPy in float64 at small sizes, the
daubechies-8 taps against their defining conditions, and the TF32
rounding of the controls."""

import numpy as np
import pytest
import torch

from cellbench import harness

ROOT = harness.ROOT
conv = harness.load_module(ROOT / "cellbench" / "reference" / "conv1d_1m.py")
dwt = harness.load_module(ROOT / "cellbench" / "reference" / "dwt_daub8.py")
DWT = {"family": "daub", "order": 8, "ext": "periodic", "levels": 3}


def _x(rows, n, seed):
    return torch.randn(rows, n, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("rows,n,k", [(3, 1000, 129), (2, 4096, 2047),
                                      (9, 300, 2), (1, 20, 20)])
def test_conv_reference_is_numpy_convolve(rows, n, k):
    x = _x(rows, n, n + k)
    h = torch.randn(k, generator=torch.Generator().manual_seed(k))
    (y,) = conv.expected({}, x, {"h": h})
    want = np.stack([np.convolve(r, h.double().numpy())
                     for r in x.double().numpy()])
    assert y.dtype == torch.float64 and y.shape == want.shape
    assert np.abs(y.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def _dwt_numpy(x, levels):
    lo = np.array(dwt.DAUB8)
    hi = np.array([lo[7 - j] if (7 - j) % 2 else -lo[7 - j]
                   for j in range(8)])
    bands, cur = [], x
    for _ in range(levels):
        n = cur.shape[-1]
        idx = (2 * np.arange(n // 2)[:, None] + np.arange(8)[None, :]) % n
        win = cur[..., idx]
        bands.append(win @ hi)
        cur = win @ lo
    return bands + [cur]


@pytest.mark.parametrize("rows,n", [(5, 64), (2, 1024), (16, 256)])
def test_dwt_reference_is_a_numpy_filter_bank(rows, n):
    x = _x(rows, n, rows * n)
    got = dwt.expected(DWT, x, {})
    want = _dwt_numpy(x.double().numpy(), 3)
    assert [g.shape[-1] for g in got] == [n // 2, n // 4, n // 8, n // 8]
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - w).max() <= 1e-12 * np.abs(w).max()


def test_dwt_reference_matches_the_library_semantics_of_the_program():
    """At float64 the reference and the program's NumPy oracle (its
    ``wavelet_apply_na``, float32) agree to float32 rounding."""
    from veles.simd_tpu_torch.ops import wavelet

    x = _x(4, 512, 11)
    got = dwt.expected(DWT, x, {})
    cur = x.numpy()
    for lvl in range(3):
        hi, cur = wavelet.wavelet_apply_na("daub", 8, "periodic", cur)
        assert np.abs(got[lvl].numpy() - hi).max() <= 1e-5
    assert np.abs(got[3].numpy() - cur).max() <= 1e-5


def test_daub8_taps_are_daubechies():
    c = np.array(dwt.DAUB8)
    assert abs(c.sum() - np.sqrt(2)) < 1e-14
    assert abs((c * c).sum() - 1) < 1e-11
    for shift in (1, 2, 3):
        assert abs(np.dot(c[2 * shift:], c[:8 - 2 * shift])) < 1e-11
    g, lo = (np.array(f) for f in dwt.filters())
    assert abs(g.sum()) < 1e-14                 # the highpass kills DC
    for p in range(4):                          # four vanishing moments
        assert abs(np.dot(g, np.arange(8.0) ** p)) < 1e-9


@pytest.mark.parametrize("tf32", [conv.tf32, dwt.tf32])
def test_tf32_keeps_ten_mantissa_bits_rounded_to_nearest(tf32):
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11 + 2 ** -20,
                      1 + 2 ** -12, -3.0 - 2 ** -9, 1e-30])
    got = tf32(x)
    assert got.tolist()[:5] == [1.0, 1 + 2 ** -10, 1 + 2 ** -10, 1.0,
                                -3.0 - 2 ** -9]
    r = torch.randn(10000)
    rel = ((tf32(r) - r).abs() / r.abs()).max()
    assert 2 ** -13 < rel <= 2 ** -11


def test_the_control_is_the_reference_one_precision_lower():
    x = _x(4, 2048, 3)
    h = torch.randn(300)
    exact = conv.expected({}, x, {"h": h})[0]
    low = conv.expected({}, x, {"h": h}, control=True)[0]
    err = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-5 < err < 3e-3
    bands = dwt.expected(DWT, x, {})
    low = dwt.expected(DWT, x, {}, control=True)
    for b, c in zip(bands, low):
        assert 1e-5 < float((c - b).abs().max() / b.abs().max()) < 3e-3


def test_the_dwt_reference_refuses_another_wavelet():
    with pytest.raises(ValueError):
        dwt.expected({**DWT, "order": 4}, _x(1, 64, 0), {})
