"""The resource axis of the spectral families, held to the JAX
package's.

Every spectral route core of the JAX package is an
``obs.instrumented_jit`` labelled with its ``op``/``route``, so after
an ``stft``, ``istft``, ``hilbert`` or ``morlet_cwt`` call its
``obs.resources()`` has a row for the route that ran.  The port's
route cores carry the same labels: the same seeded NumPy inputs, sent
through both packages (JAX on the CPU, the port with
``set_config(device="cpu")``), leave the same set of ``(op, route)``
keys, on the auto-selected routes and on every forced route but the
fused kernel's, and the outputs agree within 1e-4 of max|y|.  Each
port row carries the function's least work (``work=``).

An istft is compared on its interior, the samples past the first and
before the last ``frame_length - hop``: there the overlap envelope
falls to the square of the Hann window's end taps (2.3e-8 at 256
samples), whose reciprocal magnifies either package's float32
round-off up to 4e7 times (``spectral.istft``'s docstring).
"""

import numpy as np
import pytest

from veles.simd_tpu import obs as jobs
from veles.simd_tpu.ops import batched as jbt
from veles.simd_tpu.ops import spectral as jsp
from veles.simd_tpu_torch import obs as tobs
from veles.simd_tpu_torch.ops import batched as tbt
from veles.simd_tpu_torch.ops import spectral as tsp
from veles.simd_tpu_torch.utils import benchmark as bm
from veles.simd_tpu_torch.utils import config

TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu_and_telemetry():
    prev = config.get_config().device
    config.set_config(device="cpu")
    try:
        yield
    finally:
        for o in (jobs, tobs):
            o.disable()
            o.reset()
        config.set_config(device=prev)


def _rng(seed):
    return np.random.RandomState(seed)


def _inputs(family, n, rows, seed):
    x = _rng(seed).randn(rows, n).astype(np.float32)
    if family == "istft":
        return jsp.stft_na(x, 256, 64).astype(np.complex64)
    return x


def _call(pkg, family, operand, n, route):
    sp = jsp if pkg == "jax" else tsp
    kw = {} if route is None else {"route": route}
    if family == "stft":
        return sp.stft(operand, 256, 64, **kw)
    if family == "istft":
        return sp.istft(operand, n, 256, 64, **kw)
    if family == "hilbert":
        return sp.hilbert(operand, **kw)
    if family == "morlet_cwt":
        return sp.morlet_cwt(operand, [2.0, 4.0, 8.0], **kw)
    bt = jbt if pkg == "jax" else tbt
    return bt.batched_stft(operand, 256, 64)


def _run(pkg, family, operand, n, route):
    o = jobs if pkg == "jax" else tobs
    o.reset()
    o.enable()
    try:
        out = _call(pkg, family, operand, n, route)
        rows = [r for r in o.resources()]
    finally:
        o.disable()
    return np.asarray(out), rows


# (family, n, rows, route): the auto pick at two lengths (each family's
# dense route below its bound, its FFT or factored route above it) and
# every forced route of the four tables but the fused kernel's
CASES = [
    ("stft", 2048, 3, None),
    ("stft", 2048, 1, "xla_fft"),
    ("stft", 2048, 2, "rdft_matmul"),
    ("stft", 2048, 2, "rdft_matmul_bf16_comp"),
    ("istft", 2048, 3, None),
    ("istft", 2048, 2, "xla_fft"),
    ("istft", 2048, 2, "rdft_matmul"),
    ("istft", 2048, 1, "rdft_matmul_bf16_comp"),
    ("hilbert", 512, 3, None),
    ("hilbert", 2048, 2, None),
    ("hilbert", 512, 2, "xla_fft"),
    ("hilbert", 512, 2, "matmul_dft"),
    ("hilbert", 512, 1, "matmul_dft_bf16_comp"),
    ("morlet_cwt", 512, 2, None),
    ("morlet_cwt", 2048, 1, None),
    ("morlet_cwt", 512, 1, "xla_fft"),
    ("morlet_cwt", 512, 2, "matmul_dft"),
    ("morlet_cwt", 512, 1, "matmul_dft_bf16_comp"),
    ("morlet_cwt", 2048, 2, "ct_matmul"),
    ("batched_stft", 2048, 4, None),
]


@pytest.mark.parametrize("family,n,rows,route", CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}-{c[3] or 'auto'}"
                              for c in CASES])
def test_resource_keys_equal_the_jax_packages(family, n, rows, route):
    operand = _inputs(family, n, rows, seed=len(family) * 100 + n + rows)
    jy, jrows = _run("jax", family, operand, n, route)
    ty, trows = _run("torch", family, operand, n, route)
    jkeys = {(r["op"], r["route"]) for r in jrows}
    tkeys = {(r["op"], r["route"]) for r in trows}
    assert tkeys == jkeys, (tkeys, jkeys)
    assert len(tkeys) == 1
    if route is not None and family != "batched_stft":
        assert tkeys == {(family, route)}
    assert ty.shape == jy.shape
    if family == "istft":
        edge = 256 - 64
        ty, jy = ty[..., edge:n - edge], jy[..., edge:n - edge]
    scale = float(np.max(np.abs(jy)))
    assert float(np.max(np.abs(ty - jy))) <= TOL * scale


def _work(family, operand, n):
    rows = int(np.prod(operand.shape[:-1]))
    if family in ("stft", "batched_stft"):
        return bm.stft_work(rows, n, 256, 64)
    if family == "istft":
        rows = int(np.prod(operand.shape[:-2]))
        frames = operand.shape[-2]
        flops = rows * (frames * (bm.rfft_flops(256) + 512) + n)
        return flops, (8.0 * rows * frames * 129
                       + 4.0 * (256 + n + rows * n))
    if family == "hilbert":
        return (rows * (3 * bm.rfft_flops(n) + 2 * n),
                4.0 * (rows * n + n) + 8.0 * rows * n)
    s = 3
    return (rows * (bm.rfft_flops(n) + s * (2 * n + 2 * bm.rfft_flops(n))),
            4.0 * (rows * n + s * n) + 8.0 * rows * s * n)


@pytest.mark.parametrize("family,n,rows,route", [
    ("stft", 2048, 2, None), ("stft", 2048, 2, "xla_fft"),
    ("istft", 2048, 2, "xla_fft"), ("istft", 2048, 2, "rdft_matmul"),
    ("hilbert", 512, 2, "matmul_dft"), ("hilbert", 512, 2, "xla_fft"),
    ("morlet_cwt", 512, 2, "matmul_dft"),
    ("morlet_cwt", 2048, 2, "ct_matmul"),
    ("morlet_cwt", 512, 2, "xla_fft"), ("batched_stft", 2048, 2, None)])
def test_rows_carry_the_functions_least_work(family, n, rows, route):
    operand = _inputs(family, n, rows, seed=7)
    _y, trows = _run("torch", family, operand, n, route)
    (row,) = trows
    flops, nbytes = _work(family, operand, n)
    assert row["flops"] == pytest.approx(flops)
    assert row["bytes_accessed"] == pytest.approx(nbytes)
    pct = row["attainable_pct_of_roofline"]
    assert pct is not None and 0.0 < pct <= 100.0


def test_a_route_core_records_once_per_geometry_and_nests_silently():
    x = _inputs("stft", 2048, 2, seed=3)
    tobs.reset()
    tobs.enable()
    tsp.stft(x, 256, 64)
    tsp.stft(x, 256, 64)
    tsp.stft(x[:1], 256, 64)
    # one row a key, its analyses the geometries seen
    (row,) = [r for r in tobs.resources() if r["op"] == "stft"]
    assert row["analyses"] == 2
    # batched_stft's handle holds the core: one row, the handle's
    tobs.reset()
    tbt.batched_stft(x, 256, 64)
    assert {(r["op"], r["route"]) for r in tobs.resources()} == {
        ("batched_stft", "rdft_matmul")}


def test_telemetry_off_records_nothing():
    x = _inputs("hilbert", 512, 2, seed=5)
    tobs.reset()
    tobs.disable()
    tsp.hilbert(x)
    assert tobs.resources() == []
