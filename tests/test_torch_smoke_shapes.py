"""The resample smoke's geometries in the port's smoke
(``tools/tpu_smoke_torch.py``): the three cases of
``tests/test_smoke_shapes.py``, against the port.

The smoke pins an explicit short filter for the 160/147 case (the
default design is 3201 taps); its filters must stay smoke-sized, each
geometry it dispatches must run through the port's polyphase core and
agree with the JAX package's (within 1e-5 of max|y|, float32 sums in
another order), and the whole stage must pass on the CPU.  A fourth
case holds the NumPy views the smoke's spectral family passes
(``x[::-1]``, a negative stride) to the JAX package's answer.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import tpu_smoke, tpu_smoke_torch  # noqa: E402

from veles.simd_tpu.ops import resample as jrs  # noqa: E402
from veles.simd_tpu.ops import spectral as jsp  # noqa: E402
from veles.simd_tpu_torch.ops import resample as rs  # noqa: E402
from veles.simd_tpu_torch.ops import spectral as sp  # noqa: E402
from veles.simd_tpu_torch.utils import config  # noqa: E402

SMOKE_TAPS_BUDGET = 1024


@pytest.fixture(autouse=True)
def _cpu():
    prev = config.get_config()
    config.set_config(device="cpu")
    yield
    config.set_config(device=prev.device)


def _smoke_geometries():
    rows, n = tpu_smoke_torch.RESAMPLE_SMOKE_SHAPE
    for up, down in tpu_smoke_torch.RESAMPLE_SMOKE_RATES:
        taps = tpu_smoke_torch._resample_smoke_taps(rs, up, down)
        up_r, down_r, taps_r = rs._normalize_resample_args(
            n, up, down, taps)
        out_len = rs.resample_length(n, up_r, down_r)
        yield rows, n, up_r, down_r, taps_r, out_len


def test_smoke_filter_stays_inside_budget():
    assert (tpu_smoke_torch.RESAMPLE_SMOKE_RATES,
            tpu_smoke_torch.RESAMPLE_SMOKE_SHAPE,
            tpu_smoke_torch.RESAMPLE_SMOKE_NTAPS) == (
        tpu_smoke.RESAMPLE_SMOKE_RATES, tpu_smoke.RESAMPLE_SMOKE_SHAPE,
        tpu_smoke.RESAMPLE_SMOKE_NTAPS)
    for rows, n, up, down, taps, out_len in _smoke_geometries():
        assert len(taps) <= SMOKE_TAPS_BUDGET, (up, down, len(taps))


def test_smoke_shapes_run_through_the_polyphase_core():
    """Each geometry the stage dispatches, through the port's core and
    the JAX package's, on the same input and taps."""
    rng = np.random.RandomState(7)
    for rows, n, up, down, taps, out_len in _smoke_geometries():
        x = rng.randn(rows, n).astype(np.float32)
        got = rs._resample_conv(torch.as_tensor(x), taps, up, down,
                                out_len).numpy()
        want = np.asarray(jrs._resample_conv(
            x, np.asarray(taps, np.float32), up, down, out_len))
        assert got.shape == want.shape == (rows, out_len), (up, down)
        scale = float(np.max(np.abs(want)))
        assert float(np.max(np.abs(got - want))) <= 1e-5 * scale, \
            (up, down)


def test_resample_smoke_stage_passes_on_cpu():
    err, tol = tpu_smoke_torch._check_resample(np.random.RandomState(7))
    assert err <= tol


def test_reversed_views_are_taken_as_the_jax_package_takes_them():
    # the spectral family's csd(x, x[::-1]): a NumPy view with a
    # negative stride, which torch cannot share
    x = np.random.RandomState(3).randn(4, 2048).astype(np.float32)
    f, got = sp.csd(x, x[::-1], nperseg=256, simd=True)
    jf, want = jsp.csd(x, x[::-1], nperseg=256, simd=True)
    want = np.asarray(want)
    assert np.allclose(np.asarray(f), np.asarray(jf))
    assert np.max(np.abs(got.numpy() - want)) <= \
        1e-5 * np.max(np.abs(want))
